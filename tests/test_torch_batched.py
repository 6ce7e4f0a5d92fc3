"""``make_batched_reconstruct_fn`` of the port: B streams in one step, all
B·F frames through one K1 launch, against the JAX package's batched step and
against B single-stream steps of the port.

Shapes: 640x480 @ 60 Hz (800x525) at 4 Msps, 3 streams of 3 frames, screens
of 300x100.  Tolerances:

* against B single-stream steps of the port, on the CPU: frames, sync and
  score to the bit (the same plain-PyTorch operations on the same values; the
  streams' blocks are laid end to end with their edge samples repeated where
  a single stream's reads are clamped).  The EMA to the bit too: K3's fold
  (its plain version here) takes each stream's F products in frame order, as
  the single step does.
* against the JAX batched step: frames to 2e-5 of the largest output for the
  quantised and gather reads (float32 against float64 positions, as in
  ``tests/test_torch_resamplers.py``), the last two rows left out for the
  per-frame formulations; the EMA to the same bound; integer sync equal on a
  capture with a clear blanking peak.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.pipeline import offline as poff

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6
SHAPE = (300, 100)
N_FRAMES = 3
N_STREAMS = 3
ALPHA = 0.5
POSITION = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


def _config(module, mode=MODE, **kw):
    kw.setdefault("render_size", SHAPE)
    return module.ReconstructionConfig(
        sample_rate=FS, mode=module.VideoMode(mode.width, mode.height, mode.refresh),
        n_frames=N_FRAMES, **kw)


def _streams(n_samples: int, seeds=(1, 2, 3)) -> np.ndarray:
    """B captures of the same screen with different noise: complex64 [B, n]."""
    return np.stack([tp.generate_iq(MODE, FS, n_samples, snr_db=25.0, seed=s).iq
                     for s in seeds])


def _words(iq: np.ndarray, dtype) -> np.ndarray:
    w = np.ascontiguousarray(iq).view(np.float32)
    if dtype == np.int16:
        return np.clip(np.round(w * 8192.0), -32768, 32767).astype(np.int16)
    return w


CASES = {
    "static": dict(),
    "static, 4 taps": dict(interp_taps=4),
    "static, sub-pixel align": dict(align_subpixel=True),
    "carry_phase": dict(carry_phase=True),
    "carry_phase, exact cuts": dict(carry_phase=True, subsample_align=True, do_align=False),
    "exact cuts, 4 taps": dict(subsample_align=True, interp_taps=4, do_align=False),
    "mxu3": dict(resampler="mxu3", num_phases=16),
    "gather, exact cuts": dict(resampler="gather", subsample_align=True, carry_phase=True),
    "fft": dict(resampler="fft"),
    "invert": dict(invert=True),
}
PHASES = [0.0, 100.25, 40000.75]


@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_batched_step_equals_single_stream_steps(case, dtype):
    cfg = _config(poff, input_format="iq_interleaved", **CASES[case])
    words = _words(_streams(cfg.block_samples), dtype)
    rng = np.random.default_rng(0)
    ema = rng.random((N_STREAMS, *SHAPE), dtype=np.float32)
    phases = (PHASES,) if cfg.carry_phase else ()
    with count_launches() as seen:
        out = poff.make_batched_reconstruct_fn(cfg, device="cpu")(words, ema, ALPHA, *phases)
    # The count is of kernel launches: on the CPU the plain version runs.
    assert not seen
    assert out[0].shape == (N_STREAMS, *SHAPE) and out[1].shape == (N_STREAMS, N_FRAMES, *SHAPE)
    assert out[2].shape == (N_STREAMS, N_FRAMES, 2) and out[3].shape == (N_STREAMS, N_FRAMES)
    single = poff.make_reconstruct_fn(cfg, "cpu")
    for b in range(N_STREAMS):
        phase = (PHASES[b],) if cfg.carry_phase else ()
        ema_s, frames, sync, score = single(words[b], ema[b], ALPHA, *phase)
        assert torch.equal(out[1][b], frames), f"stream {b}: frames"
        assert torch.equal(out[2][b], sync) and torch.equal(out[3][b], score)
        assert torch.equal(out[0][b], ema_s), f"stream {b}: EMA"


def test_streams_are_laid_out_so_that_no_read_crosses_into_a_neighbour():
    """Static cuts leave one sample of slack after the last frame, and K1's
    last line reads a few samples further: alone it clamps to the block's
    last sample; in a batch the neighbour's first samples lie there.  With
    neighbours of very different level a crossing read would show."""
    cfg = _config(poff, input_format="envelope", do_align=False, interp_taps=4)
    n = cfg.block_samples
    lead, tail = poff._stream_margins(cfg, int(cfg.samples_per_frame), False)
    starts = np.round(np.arange(N_FRAMES) * cfg.samples_per_frame)
    assert lead == 1 and starts[-1] + tail > n, "this geometry reads past its block"
    rng = np.random.default_rng(1)
    env = rng.random((2, n), dtype=np.float32)
    env[0] += 1000.0
    ema = np.zeros((2, *SHAPE), np.float32)
    out = poff.make_batched_reconstruct_fn(cfg, device="cpu")(env, ema, ALPHA)
    single = poff.make_reconstruct_fn(cfg, "cpu")
    for b in range(2):
        assert torch.equal(out[1][b], single(env[b], ema[b], ALPHA)[1])
    assert float(out[1][1].max()) < 2.0 and float(out[1][0].min()) > 999.0


def test_batched_step_checks_its_arguments():
    cfg = _config(poff, input_format="envelope", carry_phase=True)
    step = poff.make_batched_reconstruct_fn(cfg, device="cpu")
    env = np.zeros((2, cfg.block_samples), np.float32)
    with pytest.raises(ValueError, match="one of each per stream"):
        step(env, np.zeros((2, *SHAPE), np.float32), ALPHA, [0.0])
    with pytest.raises(ValueError, match="one of each per stream"):
        step(env, np.zeros((3, *SHAPE), np.float32), ALPHA, [0.0, 1.0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            poff.make_batched_reconstruct_fn(cfg)   # no device named: the card, or nothing


def test_int32_frame_starts_are_checked_not_wrapped(monkeypatch):
    """K1 indexes the buffer with int32 starts: B·(samples per block) beyond
    2³¹ − 1 raises.  The limit is lowered here instead of allocating 8 GB."""
    cfg = _config(poff, input_format="envelope")
    n = cfg.block_samples
    env = np.zeros((2, n), np.float32)
    real = np.iinfo

    class Small:
        max = 2 * n - 1

    monkeypatch.setattr(poff.np, "iinfo", lambda t: Small if t is np.int32 else real(t))
    with pytest.raises(ValueError, match="int32 frame"):
        poff.make_batched_reconstruct_fn(cfg, device="cpu")(
            env, np.zeros((2, *SHAPE), np.float32), ALPHA)


@pytest.mark.parametrize("fuse", [None, True])
def test_batched_step_matches_jax(fuse):
    """Static cuts, the ``mxu`` read (float32 in both packages), integer sync
    on three clean captures; ``fuse=True`` is the same function in both."""
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    jnp = pytest.importorskip("jax.numpy")
    kw = dict(resampler="mxu", num_phases=16, input_format="iq_interleaved")
    jcfg = joff.ReconstructionConfig(
        sample_rate=FS, mode=jmodes.VideoMode(MODE.width, MODE.height, MODE.refresh),
        n_frames=N_FRAMES, render_size=SHAPE, **kw)
    pcfg = _config(poff, **kw)
    words = _words(_streams(pcfg.block_samples), np.float32)
    ema = np.random.default_rng(0).random((N_STREAMS, *SHAPE), dtype=np.float32)
    ref = joff.make_batched_reconstruct_fn(jcfg, fuse=fuse)(
        jnp.asarray(words), jnp.asarray(ema), jnp.float32(ALPHA))
    got = poff.make_batched_reconstruct_fn(pcfg, fuse=fuse, device="cpu")(words, ema, ALPHA)
    ref_sync = np.asarray(ref[2])
    assert np.array_equal(got[2].numpy(), ref_sync), "integer sync on a clear blanking peak"
    top = float(np.abs(np.asarray(ref[1])).max())
    # Aligned frames are circular shifts of the screens: undo the (equal)
    # shifts is not needed, the last two ROWS of a screen land at sync-shifted
    # places, so compare all but the worst 2·w pixels of each frame.
    diff = np.abs(got[1].numpy() - np.asarray(ref[1])).reshape(N_STREAMS, N_FRAMES, -1)
    inner = np.sort(diff, axis=-1)[..., : -2 * SHAPE[1]]
    assert inner.max() < POSITION * top
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-4)
    # The EMA folds the frames' last rows in too: α-weighted, within the
    # frames' own difference there (the frame-end read), so hold its inner
    # pixels to the position bound.
    ema_diff = np.sort(np.abs(got[0].numpy() - np.asarray(ref[0])).reshape(N_STREAMS, -1),
                       axis=-1)[..., : -2 * SHAPE[1] * N_FRAMES]
    assert ema_diff.max() < POSITION * top


def test_batched_carry_phase_step_matches_jax():
    """``carry_phase`` with exact cuts through the gather read, one phase per
    stream.  The frame period is a multiple of 1/8 sample, where the JAX
    step's float32 positions are exact (``tests/test_torch_exact_cuts.py``)."""
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    jnp = pytest.importorskip("jax.numpy")
    refresh = FS / 66666.625
    mode = tp.VideoMode(MODE.width, MODE.height, refresh)
    kw = dict(resampler="gather", carry_phase=True, subsample_align=True, do_align=False,
              input_format="iq_interleaved")
    jcfg = joff.ReconstructionConfig(
        sample_rate=FS, mode=jmodes.VideoMode(mode.width, mode.height, refresh),
        n_frames=N_FRAMES, render_size=SHAPE, **kw)
    pcfg = _config(poff, mode, **kw)
    assert pcfg.block_samples == jcfg.block_samples
    words = _words(_streams(pcfg.block_samples), np.float32)
    ema = np.random.default_rng(0).random((N_STREAMS, *SHAPE), dtype=np.float32)
    phases = np.array([0.0, 100.25, 40000.75], np.float32)
    ref = joff.make_batched_reconstruct_fn(jcfg)(
        jnp.asarray(words), jnp.asarray(ema), jnp.float32(ALPHA), jnp.asarray(phases))
    got = poff.make_batched_reconstruct_fn(pcfg, device="cpu")(words, ema, ALPHA, phases)
    top = float(np.abs(np.asarray(ref[1])).max())
    assert np.abs(got[1].numpy() - np.asarray(ref[1])).max() < POSITION * top
    assert np.abs(got[0].numpy() - np.asarray(ref[0])).max() < POSITION * top
    assert not got[2].any() and not np.asarray(ref[2]).any()


@pytest.mark.parametrize("bad", [
    dict(carry_phase=True), dict(subsample_align=True, resampler="gather"),
    dict(frame_loop="scan"), dict(resampler="pallas"), dict(resampler="mxu_batched"),
    dict(resampler="aligned"), dict(resampler="fft")])
def test_fuse_true_keeps_the_jax_value_error(bad):
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    kw = dict(resampler="mxu")
    kw.update(bad)
    jcfg = joff.ReconstructionConfig(
        sample_rate=FS, mode=jmodes.VideoMode(MODE.width, MODE.height, MODE.refresh),
        n_frames=N_FRAMES, render_size=SHAPE, **kw)
    with pytest.raises(ValueError, match="fuse=True needs static cuts"):
        joff.make_batched_reconstruct_fn(jcfg, fuse=True)
    with pytest.raises(ValueError, match="fuse=True needs static cuts"):
        poff.make_batched_reconstruct_fn(_config(poff, **kw), fuse=True, device="cpu")
    # Without fuse the same config builds.
    poff.make_batched_reconstruct_fn(_config(poff, **kw), device="cpu")


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["static", "static, 4 taps", "carry_phase, exact cuts", "mxu3"])
def test_batched_step_on_the_card_is_one_launch_and_equals_single_streams(cuda_device, case):
    """On the card: one K1 launch a step for all B·F frames, each stream's
    frames, sync and EMA equal to the single-stream step's to the bit (the
    same kernels on the same values; K2's sums depend on the frame alone)."""
    cfg = _config(poff, input_format="iq_interleaved", **CASES[case])
    words = _words(_streams(cfg.block_samples), np.int16)
    ema = np.zeros((N_STREAMS, *SHAPE), np.float32)
    phases = (PHASES,) if cfg.carry_phase else ()
    with count_launches() as seen:
        out = poff.make_batched_reconstruct_fn(cfg, device=cuda_device)(words, ema, ALPHA,
                                                                         *phases)
    torch.cuda.synchronize()
    assert seen["k1"] == 1
    single = poff.make_reconstruct_fn(cfg, cuda_device)
    for b in range(N_STREAMS):
        phase = (PHASES[b],) if cfg.carry_phase else ()
        ema_s, frames, sync, _ = single(words[b], ema[b], ALPHA, *phase)
        assert torch.equal(out[1][b], frames)
        assert torch.equal(out[2][b], sync) and torch.equal(out[0][b], ema_s)
