"""K1's fused entry (``frames_to_screens_from_words``: AM demod taken inside
the resampler), the step's routing to it, and the port's device default.

On the CPU the fused wrapper runs "plain demod, then plain K1", so it must
equal ``frames_to_screens(am_envelope_from_iq(words))`` to the bit; against
the JAX package (``am_envelope_from_iq`` → ``frames_to_screens_pallas`` in
interpret mode) it is held to the fixed-point bound of the K1 parity test:
1e-5 of the largest output on a smooth envelope.

The JAX package is imported inside the parity tests, so that this module
also loads where JAX is not installed: on the GPU machine the CUDA cases run
with ``python -m pytest --noconftest tests/test_torch_fused_demod.py -m cuda``."""

import dataclasses

import numpy as np
import pytest
import torch

from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops import resample_kernel
from tempest_tpu_torch.ops.demod import am_envelope_from_iq
from tempest_tpu_torch.ops.resample import _screen_geometry
from tempest_tpu_torch.ops.resample_kernel import (
    frames_to_screens,
    frames_to_screens_from_words,
    tile_plan,
    tile_run_cap,
)
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime, state_from_jax
from tempest_tpu_torch.utils.device import resolve_device
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 2e6
SHAPE = (48, 64)
FRAME_LEN = int(np.floor(FS / MODE.refresh))
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


def _words(n_samples: int, dtype, seed: int, odd: bool = False) -> np.ndarray:
    """Interleaved I/Q words of a synthetic capture: int16 as an SDR
    delivers them, or the float32 view of the complex samples."""
    cap = generate_iq(MODE, FS, n_samples, snr_db=18.0, seed=seed)
    words = cap.iq.view(np.float32)
    if dtype == np.int16:
        words = np.clip(np.round(words * 8192.0), -32768, 32767).astype(np.int16)
    if odd:
        words = np.concatenate([words, words[:1]])
    return np.ascontiguousarray(words)


def _starts_past_block_end(n_samples: int) -> np.ndarray:
    """Three frame starts, the last so late that its bottom rows read past
    the block end while its line spans still start inside the block."""
    start, frac, _, cols, _ = _screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE)
    line_start = np.maximum(start, 0)
    last = n_samples - int(line_start.max()) - 20
    starts = np.array([0, FRAME_LEN // 3, last], np.int32)
    reach = np.floor(np.maximum(cols[-1] + frac + (start - line_start), 0.0)).astype(np.int64) + 1
    assert int(starts.max()) + int((line_start + reach).max()) > n_samples - 1
    return starts


@pytest.mark.parametrize("odd", [False, True], ids=["even", "odd_trailing_word"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_fused_equals_demod_then_k1_to_the_bit(dtype, odd):
    n = 3 * FRAME_LEN + 1
    words = torch.from_numpy(_words(n, dtype, seed=5, odd=odd))
    starts = torch.from_numpy(_starts_past_block_end(n))
    with count_launches() as seen:
        got = frames_to_screens_from_words(words, starts, FRAME_LEN, MODE.height, MODE.width,
                                           SHAPE)
    assert not seen  # a CPU tensor launches nothing
    ref = frames_to_screens(am_envelope_from_iq(words), starts, FRAME_LEN,
                            MODE.height, MODE.width, SHAPE)
    assert got.shape == (3, *SHAPE) and got.dtype == torch.float32
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_fused_matches_jax_demod_then_pallas(dtype):
    """Smooth I/Q (slow sinusoids) so that the envelope is smooth and the
    Pallas kernel's 16.16 fixed point stays within 1e-5 of the largest
    output, the bar of the K1 parity test; the last frame reads past the
    block end."""
    jdemod = pytest.importorskip("tempest_tpu.ops.demod")
    pallas = pytest.importorskip("tempest_tpu.ops.pallas_resample")
    jnp = pytest.importorskip("jax.numpy")
    n = 3 * FRAME_LEN + 1
    t = np.arange(n)
    i = 1.5 + np.sin(2 * np.pi * t / 797.0)
    q = 0.7 + 0.3 * np.cos(2 * np.pi * t / 91.0)
    words = np.stack([i, q], axis=1).reshape(-1).astype(np.float32)
    if dtype == np.int16:
        words = np.round(words * 8192.0).astype(np.int16)
    starts = _starts_past_block_end(n)
    env = jdemod.am_envelope_from_iq(jnp.asarray(words))
    ref = np.asarray(pallas.frames_to_screens_pallas(
        env, jnp.asarray(starts), FRAME_LEN, MODE.height, MODE.width, SHAPE, interpret=True))
    got = frames_to_screens_from_words(torch.from_numpy(words), torch.from_numpy(starts),
                                       FRAME_LEN, MODE.height, MODE.width, SHAPE).numpy()
    assert got.shape == ref.shape == (3, *SHAPE)
    assert np.abs(got - ref).max() / np.abs(ref).max() < REL


def test_fused_wrapper_rejects_what_it_does_not_take():
    starts = torch.zeros(1, dtype=torch.int32)
    words = torch.zeros(2 * 40000, dtype=torch.int16)
    with pytest.raises(ValueError, match="1-D"):
        frames_to_screens_from_words(words[None], starts, FRAME_LEN, MODE.height, MODE.width, SHAPE)
    # The kernel's own argument checks, reached without a card: a CPU tensor
    # is refused by the launcher, which never falls back.
    with pytest.raises(ValueError, match="CUDA"):
        resample_kernel._launch(words, 40000, (1, 4), starts, FRAME_LEN,
                                MODE.height, MODE.width, SHAPE)


@pytest.mark.parametrize("rows", [1, 4, 8, 16])
def test_tile_run_cap_covers_every_tile(rows):
    """The stage buffer holds every tile's run with its alignment slack, at
    the slice's geometry and at the small one."""
    for frame_len, mode, shape in ((FRAME_LEN, MODE, SHAPE),
                                   (333333, ALL_VIDEO_MODES["1920x1080 @ 60Hz"], (600, 800))):
        cap = tile_run_cap(frame_len, mode.height, mode.width, shape, rows)
        start, _, _, cols, _ = _screen_geometry(frame_len, mode.height, mode.width, shape)
        line_start = np.maximum(start, 0)
        span = int(np.ceil(cols[-1] + 1)) + 2
        assert cap % 4 == 0
        for r0 in range(0, shape[0], rows):
            r1 = min(r0 + rows, shape[0]) - 1
            tile = line_start[r0:r1 + 1]
            assert tile.min() == line_start[r0, 0] and tile.max() == line_start[r1, 1]
            assert line_start[r1, 1] + span - line_start[r0, 0] + 6 <= cap


@pytest.mark.parametrize("sample_bytes", [4, 8])
@pytest.mark.parametrize("shape, fewer", [((600, 800), False), ((300, 2048), False),
                                          ((48, 99), True), ((2, 8), True)],
                         ids=["600x800", "300x2048", "48x99", "2x8"])
def test_tile_plan_fits_shared_memory(shape, fewer, sample_bytes):
    """The wrapper's tile: the default rows where two stage buffers (and the
    envelope buffer of 8-byte pairs) fit a block's shared memory, fewer rows
    on a screen of far fewer rows than the raster has lines."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    rows, cap = tile_plan(333333, mode.height, mode.width, shape, sample_bytes)
    default = resample_kernel.ROWS_PER_TILE[sample_bytes]
    assert (1 <= rows < default) if fewer else rows == default
    assert cap == tile_run_cap(333333, mode.height, mode.width, shape, rows)
    per_sample = 2 * sample_bytes + (4 if sample_bytes == 8 else 0)
    assert cap * per_sample <= resample_kernel.MAX_SHARED_BYTES
    if fewer:
        assert (tile_run_cap(333333, mode.height, mode.width, shape, 2 * rows) * per_sample
                > resample_kernel.MAX_SHARED_BYTES)


# ------------------------------------------------------- the step's routing
def _config(**kw):
    common = dict(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE,
                  input_format="iq_interleaved", carry_phase=True, align_subpixel=True)
    common.update(kw)
    return poff.ReconstructionConfig(**common)


def _spy(monkeypatch):
    """Count the calls of the step's two K1 entries."""
    calls = {"words": 0, "envelope": 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(poff, "frames_to_screens_from_words",
                        count("words", poff.frames_to_screens_from_words))
    monkeypatch.setattr(poff, "frames_to_screens", count("envelope", poff.frames_to_screens))
    return calls


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_step_on_words_takes_fused_entry_and_equals_unfused(monkeypatch, dtype):
    """The step's outputs on interleaved words are those of demod → K1 →
    sync → align → EMA, to the bit."""
    cfg = _config()
    n = cfg.block_samples
    words = _words(n, dtype, seed=7)
    calls = _spy(monkeypatch)
    step = poff.make_reconstruct_fn(cfg, device="cpu")
    ema0 = np.zeros(SHAPE, np.float32)
    ema, frames, sync, score = step(words, ema0, 0.5, 12.25)
    assert calls == {"words": 1, "envelope": 0}

    env = poff.demodulate(torch.from_numpy(words), cfg)
    starts = torch.from_numpy(poff.carry_phase_starts(12.25, cfg.samples_per_frame, 3))
    ref_frames, ref_sync, ref_score = poff.process_frames(env, starts, cfg, FRAME_LEN)
    ref_ema = poff.ema_fold(torch.from_numpy(ema0), ref_frames, 0.5)
    assert calls == {"words": 1, "envelope": 1}
    assert torch.equal(frames, ref_frames) and torch.equal(ema, ref_ema)
    assert torch.equal(sync, ref_sync) and torch.equal(score, ref_score)


@pytest.mark.parametrize("case", ["invert"])
def test_step_takes_fused_route_under_invert(monkeypatch, case):
    """``invert`` on float32 words: the block maximum and the inversion in
    K1's words entry, the same outputs as the inverted envelope through the
    envelope entry, to the bit."""
    calls = _spy(monkeypatch)
    cfg = _config(invert=True)
    iq = _words(cfg.block_samples, np.float32, seed=3)
    step = poff.make_reconstruct_fn(cfg, device="cpu")
    got = step(iq, np.zeros(SHAPE, np.float32), 0.5, 0.0)
    assert calls == {"words": 1, "envelope": 0}
    env = poff.demodulate(torch.from_numpy(iq), cfg)
    ref = poff.make_reconstruct_fn(dataclasses.replace(cfg, input_format="envelope", invert=False),
                                   device="cpu")(env, np.zeros(SHAPE, np.float32), 0.5, 0.0)
    assert calls == {"words": 1, "envelope": 1}
    assert got[1].shape == (3, *SHAPE) and bool(torch.isfinite(got[1]).all())
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["complex64", "float64_words"])
def test_step_takes_unfused_route(monkeypatch, case):
    calls = _spy(monkeypatch)
    if case == "complex64":
        cfg = _config(input_format="complex64")
        iq = generate_iq(MODE, FS, cfg.block_samples, snr_db=18.0, seed=3).iq
    else:
        cfg = _config()
        iq = _words(cfg.block_samples, np.float32, seed=3).astype(np.float64)
    step = poff.make_reconstruct_fn(cfg, device="cpu")
    _, frames, _, _ = step(iq, np.zeros(SHAPE, np.float32), 0.5, 0.0)
    assert calls == {"words": 0, "envelope": 1}
    assert frames.shape == (3, *SHAPE) and bool(torch.isfinite(frames).all())


def test_runtime_blocks_go_through_fused_entry(monkeypatch):
    """The streaming runtime's default chain hands its words to the fused
    entry: one call a block, none of the envelope entry."""
    calls = _spy(monkeypatch)
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=2)
    rt = StreamingRuntime(src, MODE, alpha=0.5, config_overrides={"render_size": SHAPE},
                          device="cpu")
    buf = np.empty(block, np.complex64)
    for _ in range(2):
        src.read(buf)
        rt.ring.put(buf)
    rt.process_blocks(2)
    assert calls == {"words": 2, "envelope": 0}


# ------------------------------------------------------- the device default
def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "make_reconstruct_fn": lambda: poff.make_reconstruct_fn(_config()),
    "reconstruct_frames": lambda: poff.reconstruct_frames(
        np.zeros(2 * 200000, np.float32), _config(carry_phase=False)),
    "StreamingRuntime": lambda: StreamingRuntime(
        SyntheticSource(MODE, FS, int(FS * 0.1)), MODE, config_overrides={"render_size": SHAPE}),
    "state_from_jax": lambda: state_from_jax(np.zeros(SHAPE, np.float32), 0),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_without_device_asks_for_the_card(monkeypatch, entry):
    """With no ``device`` argument an entry point uses the CUDA card; where
    there is none it raises and does not carry on on the CPU."""
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ENTRY_POINTS[entry]()


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


# ------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_fused_cuda_matches_plain(cuda_device, dtype):
    """The fused kernel against plain demod → plain K1 on the card, at the
    slice's shapes, with the last frame reading past the block end.
    Tolerance 1e-6 relative: both do the same f32 operations in the same
    order (the kernel forbids FMA contraction)."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    fs, shape = 20e6, (600, 800)
    spf = fs / mode.refresh
    frame_len = int(np.floor(spf))
    n = int(np.ceil(36 * spf)) + 1
    rng = np.random.default_rng(0)
    words = rng.integers(-20000, 20000, size=2 * n + 1).astype(np.int16)
    words = torch.from_numpy(words.astype(dtype)).to(cuda_device)
    starts = np.floor(np.float32(1000.25) + np.float32(spf) * np.arange(36, dtype=np.float32)
                      + np.float32(0.5)).astype(np.int32)
    starts = torch.from_numpy(starts).to(cuda_device)
    with count_launches() as seen:
        got = frames_to_screens_from_words(words, starts, frame_len, mode.height, mode.width,
                                           shape)
    assert seen["k1", 2, False, "am", False] == 1 == seen["k1"]
    geom = resample_kernel.screen_geometry(frame_len, mode.height, mode.width, shape, words.device)
    ref = resample_kernel.frames_to_screens_plain(am_envelope_from_iq(words), starts, geom)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6
