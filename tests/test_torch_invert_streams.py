"""K1's words load on the last two routes that demodulated as a pass: the
inversion ``1 - env / max(env)`` (the config's ``invert``), its maximum the
block maximum's own launch (``words_maxima``, ``csrc/resample.cu``
``words_max_kernel``), and several streams laid end to end in one launch
(``streams=``: the batched step), each stream demodulated, inverted and
clamped as if it were alone.

On the CPU each wrapper runs its plain version, so the words entry must
equal the pass route (``words_envelope_plain``: the demod, ``invert_envelope``,
the rounding; then ``frames_to_screens_plain``) to the bit, and a batched
step must equal its single steps to the bit.  Against the JAX package on
the CPU (``demodulate(invert=True)``; 2 taps through ``frames_to_screens_pallas``
in interpret mode, 4 taps through its Catmull-Rom phase tables,
``frame_to_screen_mxu(interp_taps=4)``): the demodulated samples of the two
packages differ by a float32 ulp (their ``sqrt`` and ``atan2``), which the
inversion keeps at a few ulps of 1; the 2-tap screens are held to the
Pallas kernel's 16.16 fixed point bound, 1e-5 of the largest output, and the
4-tap ones to the tables' position quantisation, half a phase step times the
inverted envelope's largest slope, on the pixels both read inside the frame
(``tests/test_torch_exact_cuts.py`` says why the others differ by design).
The batched FM step is held against the JAX package's batched step as
``tests/test_torch_batched.py`` holds the AM one.

The ``cuda`` cases run the block maximum and K1's new instantiations on the
card against their plain versions on the same card, to the bit: every
product, sum, division and subtraction rounded on its own as torch's passes
round them.  The JAX package is imported inside the tests that use it, so
that the ``cuda`` cases load where JAX is not installed."""

import dataclasses

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.ops import resample_kernel as rk
from tempest_tpu_torch.ops.demod import invert_envelope
from tempest_tpu_torch.ops.resample import _screen_geometry
from tempest_tpu_torch.parallel import sharded
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 2e6
SHAPE = (48, 64)
FRAME_LEN = int(np.floor(FS / MODE.refresh))
REL = 1e-5
# What the words load makes of the words: (demod, bf16).
LOADS = {"am": ("am", False), "am_bf16": ("am", True), "fm": ("fm", False),
         "fm_bf16": ("fm", True)}
# The screens that take the kernel's other work splits (chip_smoke.OTHER_SHAPES).
OTHER_SHAPES = ((600, 99), (601, 402), (300, 2048), (48, 99))


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
        pytest.skip("needs a CUDA card: K1 and the block maximum have no CPU mode")
    return torch.device("cuda", 0)


def _words(n_samples: int, dtype, seed: int, modulation: str = "am") -> np.ndarray:
    """Interleaved I/Q words of a synthetic capture: int16 as an SDR
    delivers them, or the float32 view of the complex samples."""
    cap = tp.generate_iq(MODE, FS, n_samples, snr_db=18.0, seed=seed, modulation=modulation)
    words = cap.iq.view(np.float32)
    if dtype == np.int16:
        words = np.clip(np.round(words * 8192.0), -32768, 32767).astype(np.int16)
    return np.ascontiguousarray(words)


def _inverted_words(n_samples: int, dtype, seed: int, demod: str) -> np.ndarray:
    """Words to invert: a capture under AM; under FM random words, whose
    discriminator takes both signs (a synthetic capture's lies below 0, so
    its maximum is the first sample's 0 and the inversion gives only
    infinities and NaN, in both routes alike)."""
    if demod == "am":
        return _words(n_samples, dtype, seed)
    rng = np.random.default_rng(seed)
    return rng.integers(-20000, 20000, 2 * n_samples).astype(np.int16).astype(dtype)


def _same(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Equal NaN positions, equal bits elsewhere."""
    nan = torch.isnan(ref)
    return bool(torch.equal(torch.isnan(got), nan)) and bool(torch.equal(got[~nan], ref[~nan]))


def _smooth_words(n: int, dtype) -> np.ndarray:
    """Slow sinusoids as I/Q: a smooth envelope and discriminator."""
    t = np.arange(n)
    i = 1.5 + np.sin(2 * np.pi * t / 797.0)
    q = 0.7 + 0.3 * np.cos(2 * np.pi * t / 91.0)
    words = np.stack([i, q], axis=1).reshape(-1).astype(np.float32)
    return np.round(words * 8192.0).astype(np.int16) if dtype == np.int16 else words


def _edge_starts(n_samples: int, shape=SHAPE, frame_len: int = FRAME_LEN, mode=MODE) -> np.ndarray:
    """Three frame starts: the first at sample 0 (FM's 0 and the 4 taps'
    clamp), the last so late that its bottom rows read past the block end."""
    start, _, _, _, _ = _screen_geometry(frame_len, mode.height, mode.width, shape)
    last = n_samples - int(np.maximum(start, 0).max()) - 20
    return np.array([0, frame_len // 3, last], np.int32)


def _config(**kw):
    common = dict(sample_rate=FS, mode=MODE, n_frames=3, render_size=SHAPE,
                  input_format="iq_interleaved", align_subpixel=True)
    common.update(kw)
    return poff.ReconstructionConfig(**common)


def _spy(monkeypatch):
    """Record (positional arguments, keyword options) of each call of the
    step's two K1 entries."""
    calls = {"words": [], "envelope": []}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(poff, "frames_to_screens_from_words",
                        count("words", poff.frames_to_screens_from_words))
    monkeypatch.setattr(poff, "frames_to_screens", count("envelope", poff.frames_to_screens))
    return calls


# ------------------------------------------------------------ the block maximum
@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("demod", ["am", "fm"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_block_maximum_is_torch_max_of_each_stream(dtype, demod, streams):
    """On the CPU ``words_maxima`` is its plain version: ``torch.max`` of
    each stream's demodulated words, each stream on its own (FM's 0 on its
    first pair); an odd trailing word is dropped; the maximum is that of the
    unrounded, uninverted samples.  A capture's discriminator lies below 0:
    its maximum is the +0 of the first pair, and the inversion there gives
    NaN and infinities, the same in both routes."""
    n = 4 * 1001
    words = torch.from_numpy(_words(n, dtype, seed=streams, modulation=demod))
    words = torch.cat([words, words[:1]])          # an odd trailing word
    with count_launches() as seen:
        got = rk.words_maxima(words, demod, streams)
    assert not seen    # a CPU tensor launches nothing
    length = n // streams
    ref = [torch.max(rk.words_envelope_plain(words[2 * length * b: 2 * length * (b + 1)], demod))
           for b in range(streams)]
    assert got.dtype == torch.float32 and torch.equal(got, torch.stack(ref))
    assert torch.equal(rk.words_maxima_plain(words, demod, streams), got)
    inverted = rk.words_envelope_plain(words, demod, invert=True, streams=streams)
    for b in range(streams):
        env = rk.words_envelope_plain(words[2 * length * b: 2 * length * (b + 1)], demod)
        assert _same(inverted[length * b: length * (b + 1)], 1.0 - env / got[b])
    if demod == "fm":
        assert all(int(m.view(torch.int32)) == 0 for m in got)


def test_block_maximum_rejects_what_it_cannot_split():
    words = torch.zeros(2 * 3 * FRAME_LEN, dtype=torch.int16)
    with pytest.raises(ValueError, match="equal streams"):
        rk.words_maxima(words[: 2 * 10], "am", 3)
    with pytest.raises(ValueError, match="demod"):
        rk.words_maxima(words, "pm")
    with pytest.raises(ValueError, match="equal streams"):   # 3 frames on 2 streams
        rk.frames_to_screens_from_words(words, torch.zeros(3, dtype=torch.int32), FRAME_LEN,
                                        MODE.height, MODE.width, SHAPE, streams=2)


def test_launch_cost_counts_the_inversion_and_the_maximum():
    """The inversion adds a division and a subtraction a sample and the
    maxima's bytes; the maximum's own launch reads the words once."""
    raster = (333333, 1125, 2200, (600, 800))
    args = (12_333_335, 4, 36, *raster)
    plain = rk.word_code(torch.int16, "am")[0]
    inverted = rk.word_code(torch.int16, "am", invert=True)[0]
    nbytes, ops, _ = rk.launch_cost(*args, plain)
    nbytes_i, ops_i, samples = rk.launch_cost(*args, inverted)
    assert nbytes_i == nbytes + 4 and ops_i - ops == 2 * samples
    assert (rk.launch_instructions(*args, inverted) - rk.launch_instructions(*args, plain)
            == pytest.approx(samples * rk.INVERT_INSTRUCTIONS))
    assert rk.launch_cost(*args, inverted, streams=4)[0] == nbytes + 16
    for dtype, sample_bytes in ((torch.int16, 4), (torch.float32, 8)):
        code = rk.word_code(dtype, "fm")[0]
        mbytes, mops, mtr = rk.max_launch_cost(12_333_335, sample_bytes, code)
        assert mbytes == 12_333_335 * sample_bytes + 4 and mtr == 12_333_335
        assert mops == 12_333_335 * 8
    # The slice's int16 words: 49.3 MB, 0.0147 ms at 3.35 TB/s; the
    # instructions stay below that even under FM.
    mbytes = rk.max_launch_cost(12_333_335, 4, plain)[0]
    assert mbytes / 3.35e12 * 1e3 == pytest.approx(0.01473, abs=1e-5)
    from tempest_tpu_torch.ops.sync_kernel import H100_ISSUE_PER_S
    fm_code = rk.word_code(torch.int16, "fm")[0]
    assert rk.max_launch_instructions(12_333_335, 4, fm_code) / H100_ISSUE_PER_S < mbytes / 3.35e12


# ------------------------------------------------------------ the words entry
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_inverted_words_entry_equals_the_pass_route_to_the_bit(dtype, load, taps):
    """The demod, ``invert_envelope`` (``1 - env / torch.max(env)``), the
    rounding, then K1's plain version: the same bits, residuals given, the
    first frame at sample 0 and the last cut by the block end."""
    demod, bf16 = LOADS[load]
    n = 3 * FRAME_LEN + 1
    words = torch.from_numpy(_inverted_words(n, dtype, 5, demod))
    starts = torch.from_numpy(_edge_starts(n))
    fracs = torch.from_numpy(np.random.default_rng(3).random(3).astype(np.float32))
    got = rk.frames_to_screens_from_words(words, starts, FRAME_LEN, MODE.height, MODE.width,
                                          SHAPE, fracs, taps, demod=demod, bf16=bf16, invert=True)
    env = rk.words_envelope_plain(words, demod)
    env = invert_envelope(env)
    if bf16:
        env = env.to(torch.bfloat16).to(torch.float32)
    geom = rk.screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE, torch.device("cpu"))
    ref = rk.frames_to_screens_plain(env, starts, geom, fracs, taps)
    assert got.shape == (3, *SHAPE) and torch.equal(got, ref)
    assert bool(torch.isfinite(ref).all())


@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("demod", ["am", "fm"])
def test_inverted_words_entry_matches_jax(demod, taps):
    """Smooth I/Q words (int16), the JAX package's ``demodulate`` with
    ``invert=True``: the samples within a few float32 ulps of 1, the screens
    within the bound of the JAX read (module docstring)."""
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    jnp = pytest.importorskip("jax.numpy")
    n = 3 * FRAME_LEN + 1
    words = _smooth_words(n, np.int16)
    jcfg = joff.ReconstructionConfig(
        sample_rate=FS, mode=jmodes.VideoMode(MODE.width, MODE.height, MODE.refresh), n_frames=3,
        render_size=SHAPE, input_format="iq_interleaved", demod=demod, invert=True)
    jenv = np.asarray(joff.demodulate(jnp.asarray(words), jcfg))
    tw = torch.from_numpy(words)
    penv = rk.words_envelope_plain(tw, demod, invert=True).numpy()
    assert np.abs(penv - jenv).max() <= 8 * np.spacing(np.float32(1.0))
    starts = _edge_starts(n)[1:]
    got = rk.frames_to_screens_from_words(tw, torch.from_numpy(starts), FRAME_LEN, MODE.height,
                                          MODE.width, SHAPE, None, taps, demod=demod,
                                          invert=True).numpy()
    if taps == 2:
        pallas = pytest.importorskip("tempest_tpu.ops.pallas_resample")
        ref = np.asarray(pallas.frames_to_screens_pallas(
            jnp.asarray(jenv), jnp.asarray(starts), FRAME_LEN, MODE.height, MODE.width, SHAPE,
            interpret=True))
        assert np.abs(got - ref).max() <= REL * np.abs(ref).max()
        return
    jres = pytest.importorskip("tempest_tpu.ops.resample")
    phases = 256
    # The first frame, which lies inside the block: the pixels whose lines
    # read inside it, one sample after each line start on (the tables
    # replicate a span's border where K1 reads the sample before the line),
    # row 0 left out (the tables clip its negative fraction to 0).
    ref = np.asarray(jres.frame_to_screen_mxu(
        jnp.asarray(jenv[starts[0]: starts[0] + FRAME_LEN]), MODE.height, MODE.width, SHAPE,
        num_phases=phases, interp_taps=4))
    start, frac, _, cols, _ = _screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE)
    pos = (start + frac.astype(np.float64))[:, :, None] + cols[None, None, :]
    inside = (pos >= 0) & (pos - np.floor(pos[:, :, :1]) >= 1) & (pos + 1.0 < FRAME_LEN - 3)
    mask = inside.all(axis=1)
    mask[0] = False
    assert mask.mean() > 0.8
    # Half a phase step times the slope of the cubic through the samples,
    # at most 1.5 times the samples' own.
    frame = jenv[starts[0]: starts[0] + FRAME_LEN]
    bound = 1.5 * np.abs(np.diff(frame)).max() / (2 * phases) + 1e-6
    assert np.abs(got[0] - ref)[mask].max() <= bound


# ------------------------------------------------------------ the stream clamp
def _padded_streams(env: np.ndarray, starts: np.ndarray, lead: int, tail: int):
    """Each stream's envelope with its first sample repeated ``lead`` times
    before it and its last ``tail`` times after it, and the starts moved on:
    a layout whose reads never need the clamp."""
    padded = np.stack([np.pad(e, (lead, tail), mode="edge") for e in env])
    return padded, starts + lead


@pytest.mark.parametrize("taps", [2, 4])
def test_each_stream_is_clamped_into_its_own_block(taps):
    """Two streams of very different level, 4 frames each: the first frame
    of each at its stream's sample 0 (with 4 taps, tap -1 of its first lines
    reads before the stream) and the last so late that its bottom rows read
    past the stream's end.  Reckoned plainly: each stream laid out with its
    edge samples repeated, read with no clamp at all; and each stream alone.
    All three the same bits, and no pixel of one stream sees the other's
    level."""
    rng = np.random.default_rng(1)
    length = 4 * FRAME_LEN + 7
    env = rng.random((2, length), dtype=np.float32)
    env[0] += 1000.0
    per = np.array([0, FRAME_LEN, 2 * FRAME_LEN + 5, length - FRAME_LEN // 2], np.int64)
    start, _, _, _, span = rk._line_tables(FRAME_LEN, MODE.height, MODE.width, SHAPE)
    lead, tail = rk.line_reach(taps, True)[0], int(start[-1, 1]) + span + 2
    assert per[-1] + tail > length and (taps == 2 or per[0] - lead < 0)
    geom = rk.screen_geometry(FRAME_LEN, MODE.height, MODE.width, SHAPE, torch.device("cpu"))
    fracs = torch.from_numpy(rng.random(8).astype(np.float32))
    starts = torch.from_numpy(np.concatenate([per, per + length]).astype(np.int32))
    got = rk.frames_to_screens_plain(torch.from_numpy(env.reshape(-1)), starts, geom, fracs,
                                     taps, streams=2)
    padded, moved = _padded_streams(env, per, lead, tail)
    for b in range(2):
        part = slice(4 * b, 4 * b + 4)
        alone = rk.frames_to_screens_plain(torch.from_numpy(env[b]),
                                           torch.from_numpy(per.astype(np.int32)), geom,
                                           fracs[part], taps)
        reckoned = rk.frames_to_screens_plain(torch.from_numpy(padded[b]),
                                              torch.from_numpy(moved.astype(np.int32)), geom,
                                              fracs[part], taps)
        assert torch.equal(got[part], alone) and torch.equal(got[part], reckoned)
    assert float(got[4:].max()) < 2.0 and float(got[:4].min()) > 999.0


@pytest.mark.parametrize("load", ["am", "fm_bf16"])
def test_words_entry_with_streams_equals_each_stream_alone(load):
    """The words entry over three streams of int16 words, inverted: each
    stream's screens those of the stream alone, to the bit."""
    demod, bf16 = LOADS[load]
    n = 3 * FRAME_LEN + 1
    words = np.concatenate([_inverted_words(n, np.int16, s, demod) for s in (1, 2, 3)])
    per = _edge_starts(n)
    starts = np.concatenate([per + b * n for b in range(3)]).astype(np.int32)
    raster = (FRAME_LEN, MODE.height, MODE.width, SHAPE)
    got = rk.frames_to_screens_from_words(torch.from_numpy(words), torch.from_numpy(starts),
                                          *raster, None, 4, demod=demod, bf16=bf16, invert=True,
                                          streams=3)
    for b in range(3):
        alone = rk.frames_to_screens_from_words(
            torch.from_numpy(words[2 * n * b: 2 * n * (b + 1)]), torch.from_numpy(per), *raster,
            None, 4, demod=demod, bf16=bf16, invert=True)
        assert torch.equal(got[3 * b: 3 * b + 3], alone)


# ------------------------------------------------------------ the routes
@pytest.mark.parametrize("case", ["am", "fm", "invert", "invert_fm_exact_cuts"])
def test_batched_step_hands_k1_the_words_as_they_lie(monkeypatch, case):
    """The batched step at B = 3 hands the caller's words to the words entry
    (the same storage: no layout copy), with the stream count and, under
    ``invert``, the inversion; every stream equals its single step to the
    bit.  Static cuts leave the last frame reading past its block."""
    options = {"am": {}, "fm": {"demod": "fm"}, "invert": {"invert": True, "interp_taps": 4},
               "invert_fm_exact_cuts": {"invert": True, "demod": "fm", "carry_phase": True,
                                        "subsample_align": True}}[case]
    cfg = _config(**options)
    words = torch.from_numpy(np.stack([_inverted_words(cfg.block_samples, np.int16, s, cfg.demod)
                                       for s in (1, 2, 3)]))
    ema0 = np.zeros((3, *SHAPE), np.float32)
    phases = ([0.0, 100.25, 20000.75],) if cfg.carry_phase else ()
    calls = _spy(monkeypatch)
    out = poff.make_batched_reconstruct_fn(cfg, device="cpu")(words, ema0, 0.5, *phases)
    assert calls["envelope"] == [] and len(calls["words"]) == 1
    args, kwargs = calls["words"][0]
    assert args[0].data_ptr() == words.data_ptr() and kwargs["streams"] == 3
    assert kwargs.get("invert", False) == cfg.invert
    single = poff.make_reconstruct_fn(cfg, device="cpu")
    for b in range(3):
        ema_s, frames, sync, score = single(words[b], ema0[b], 0.5, *[p[b] for p in phases])
        assert torch.equal(out[1][b], frames) and torch.equal(out[0][b], ema_s)
        assert torch.equal(out[2][b], sync) and torch.equal(out[3][b], score)


def test_batched_fm_step_matches_jax():
    """Two FM streams against the JAX package's batched step: static cuts,
    the ``mxu`` read (float32 in both packages), integer sync on clean
    captures; the bounds of ``tests/test_torch_batched.py``
    (``test_batched_step_matches_jax``): frames and EMA to 2e-5 of the
    largest output but the last two rows' worth of pixels a frame (the
    frame-end read), sync equal, score to 1e-4."""
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    jnp = pytest.importorskip("jax.numpy")
    fs, shape, n_frames, position = 4e6, (300, 100), 3, 2e-5
    kw = dict(resampler="mxu", num_phases=16, input_format="iq_interleaved", demod="fm")
    jcfg = joff.ReconstructionConfig(
        sample_rate=fs, mode=jmodes.VideoMode(MODE.width, MODE.height, MODE.refresh),
        n_frames=n_frames, render_size=shape, **kw)
    pcfg = poff.ReconstructionConfig(sample_rate=fs, mode=MODE, n_frames=n_frames,
                                     render_size=shape, **kw)
    words = np.stack([tp.generate_iq(MODE, fs, pcfg.block_samples, snr_db=25.0, seed=s,
                                     modulation="fm").iq.view(np.float32) for s in (1, 2)])
    ema = np.random.default_rng(0).random((2, *shape), dtype=np.float32)
    ref = joff.make_batched_reconstruct_fn(jcfg)(jnp.asarray(words), jnp.asarray(ema),
                                                 jnp.float32(0.5))
    got = poff.make_batched_reconstruct_fn(pcfg, device="cpu")(words, ema, 0.5)
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))
    top = float(np.abs(np.asarray(ref[1])).max())
    diff = np.abs(got[1].numpy() - np.asarray(ref[1])).reshape(2, n_frames, -1)
    assert np.sort(diff, axis=-1)[..., : -2 * shape[1]].max() < position * top
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-4)
    ema_diff = np.sort(np.abs(got[0].numpy() - np.asarray(ref[0])).reshape(2, -1),
                       axis=-1)[..., : -2 * shape[1] * n_frames]
    assert ema_diff.max() < position * top


def test_inverted_shard_window_takes_the_words_entry_and_equals_the_pass(monkeypatch):
    """A time shard's window under ``invert`` and FM: the maximum is the
    window's, as ``demodulate(ext)`` takes it, and the 0 lands on the
    window's first sample: the same bits as the pass route."""
    cfg = _config(demod="fm", invert=True)
    words = _inverted_words(cfg.block_samples + 5000, np.int16, 9, "fm")
    ext = torch.from_numpy(words[2 * 777: 2 * (777 + cfg.block_samples)].copy())
    starts = poff.carry_phase_starts(321.5, cfg.samples_per_frame, cfg.n_frames)
    calls = _spy(monkeypatch)
    got = sharded._span_frames(cfg, ext, starts, 0.5)
    assert len(calls["words"]) == 1 and calls["words"][0][1]["invert"] and calls["envelope"] == []
    ref = poff._process_and_fold(poff.demodulate(ext, cfg), torch.from_numpy(starts),
                                 dataclasses.replace(cfg, invert=False), FRAME_LEN,
                                 torch.zeros(SHAPE), 0.5)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_inverted_runtime_blocks_go_through_the_words_entry(monkeypatch):
    """The streaming runtime with ``invert=True`` hands each block's words
    to the words entry with the inversion: one call a block, none of the
    envelope entry."""
    calls = _spy(monkeypatch)
    block = int(FS * 0.1)
    src = SyntheticSource(MODE, FS, block, snr_db=25.0, seed=2)
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu", invert=True,
                          config_overrides={"render_size": SHAPE})
    buf = np.empty(block, np.complex64)
    for _ in range(2):
        src.read(buf)
        rt.ring.put(buf)
    rt.process_blocks(2)
    assert [kw for _, kw in calls["words"]] == [{"invert": True}] * 2 and calls["envelope"] == []


# ------------------------------------------------------------- on the card
def _random_words(device, n_samples: int, dtype, seed: int) -> torch.Tensor:
    """Random words over the int16 range (as float32 values for float32
    words), the ends of the range among them."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-20000, 20000, size=2 * n_samples).astype(np.int16)
    words[rng.integers(0, words.size, 2000)] = -32768
    words[rng.integers(0, words.size, 2000)] = 32767
    return torch.from_numpy(words.astype(dtype)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 2, 4])
@pytest.mark.parametrize("demod", ["am", "fm"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_block_maximum_on_the_card_equals_torch_max(cuda_device, dtype, demod, streams):
    """Streams of 1,000,003 samples (not a multiple of a 16-byte word), the
    int16 range's ends among the words, the last stream all zero where there
    are several (its maximum +0, as torch's), also from an unaligned source:
    the maxima equal ``torch.max`` of the plain envelope to the bit; one
    launch a call."""
    length = 1_000_003
    words = _random_words(cuda_device, streams * length, dtype, seed=streams)
    if streams > 1:
        words[2 * (streams - 1) * length:] = 0
    with count_launches() as seen:
        got = rk.words_maxima(words, demod, streams)
    assert seen == {"words_max": 1}
    ref = rk.words_maxima_plain(words, demod, streams)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (got, ref)
    if streams > 1:
        assert int(got[-1].view(torch.int32)) == 0
    # From a source off 16-byte alignment (one pair on), and all zero alone.
    cut = words[2: 2 + 2 * (streams * (length - 1))]
    assert torch.equal(rk.words_maxima(cut, demod, streams).view(torch.int32),
                       rk.words_maxima_plain(cut, demod, streams).view(torch.int32))
    zero = torch.zeros_like(words[: 2 * 4099])
    assert int(rk.words_maxima(zero, demod).view(torch.int32)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("demod", ["am", "fm"])
def test_block_maximum_on_the_card_with_nan_and_infinities(cuda_device, demod, streams):
    """Float32 words with NaN and ±inf in the first stream: its maximum NaN
    where torch's is NaN (torch.max propagates it), +inf where torch's is;
    the other stream's its own."""
    length = 300_001
    words = _random_words(cuda_device, streams * length, np.float32, seed=7).clone()
    rng = np.random.default_rng(8)
    specials = {"nan": float("nan"), "inf": float("inf"), "-inf": -float("inf")}
    for name, value in specials.items():
        w = words.clone()
        idx = torch.from_numpy(rng.integers(0, 2 * length, 50)).to(cuda_device)
        w[idx] = value
        got, ref = rk.words_maxima(w, demod, streams), rk.words_maxima_plain(w, demod, streams)
        torch.cuda.synchronize()
        assert _same(got, ref), (name, got, ref)
        assert name != "nan" or bool(torch.isnan(ref[0]))


def _slice_block(device, dtype, demod, streams: int = 1):
    """36 frames a stream of 1080p60 at 20 Msps, random words, carried-phase
    exact cuts, B streams end to end."""
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    spf = 20e6 / mode.refresh
    n = int(np.ceil(36 * spf)) + 1
    words = _random_words(device, streams * n, dtype, seed=1 if demod == "fm" else 0)
    starts, fracs = poff.exact_cut_starts(1000.25, spf, 36)
    starts = np.concatenate([starts.astype(np.int64) + b * n for b in range(streams)])
    fracs = np.tile(fracs, streams)
    return (mode, int(np.floor(spf)), n, words,
            torch.from_numpy(starts.astype(np.int32)).to(device), torch.from_numpy(fracs).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True], ids=["rounded", "residuals"])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("load", list(LOADS))
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_inverted_words_load_on_the_card_equals_plain(cuda_device, dtype, load, taps, exact):
    """Each inverted instantiation of K1 at the slice's shapes (1080p60, 20
    Msps, 36 frames, 600x800), then at the block's edges, from an unaligned
    source and at the other work splits' screens: equal to its plain version
    to the bit, one K1 launch and one block maximum a call."""
    demod, bf16 = LOADS[load]
    mode, frame_len, n, words, starts, fracs = _slice_block(cuda_device, dtype, demod)
    fracs = fracs if exact else None
    raster = (frame_len, mode.height, mode.width, (600, 800))
    geom = rk.screen_geometry(*raster, cuda_device)
    with count_launches() as seen:
        got = rk.frames_to_screens_from_words(words, starts, *raster, fracs, taps, demod=demod,
                                              bf16=bf16, invert=True)
    assert seen == {"k1": 1, ("k1", taps, exact, demod, bf16, "invert"): 1, "words_max": 1}
    env = rk.words_envelope_plain(words, demod, bf16, invert=True)
    ref = rk.frames_to_screens_plain(env, starts, geom, fracs, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    short = int(starts[-1]) + frame_len - 4000
    edge = torch.tensor([0, frame_len + 3, int(starts[-1])], dtype=torch.int32,
                        device=cuda_device)
    edge_fracs = None if fracs is None else fracs[:3].contiguous()
    for lo in (0, 2):
        cut = words[lo: 2 * short]
        cut_env = rk.words_envelope_plain(cut, demod, bf16, invert=True)
        for shape in ((600, 800),) + OTHER_SHAPES:
            other = (frame_len, mode.height, mode.width, shape)
            got = rk.frames_to_screens_from_words(cut, edge, *other, edge_fracs, taps,
                                                  demod=demod, bf16=bf16, invert=True)
            ref = rk.frames_to_screens_plain(cut_env, edge, rk.screen_geometry(*other, cuda_device),
                                             edge_fracs, taps)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (lo, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("demod", ["am", "fm"])
def test_inverted_words_load_at_640x480_on_the_card_equals_plain(cuda_device, demod, taps):
    """11 frames of 640x480 at 32 Msps onto 600x800 (what auto_reconstruct
    launches there), int16 words, inverted: equal to plain to the bit."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    spf = 32e6 / mode.refresh
    n = int(32e6 * 0.2)
    words = _random_words(cuda_device, n, np.int16, seed=3)
    starts = torch.from_numpy(np.round(np.arange(11) * spf).astype(np.int32)).to(cuda_device)
    raster = (int(np.floor(spf)), mode.height, mode.width, (600, 800))
    got = rk.frames_to_screens_from_words(words, starts, *raster, None, taps, demod=demod,
                                          invert=True)
    ref = rk.frames_to_screens_plain(rk.words_envelope_plain(words, demod, invert=True), starts,
                                     rk.screen_geometry(*raster, cuda_device), None, taps)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("invert", [False, True], ids=["plain", "inverted"])
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("load", ["am", "fm", "fm_bf16"])
@pytest.mark.parametrize("dtype", [np.int16, np.float32], ids=["int16", "float32"])
def test_streams_on_the_card_equal_plain(cuda_device, dtype, load, taps, invert):
    """Four streams of the slice's blocks end to end, each with its first
    frame at its sample 0 (4 taps: tap -1 before the stream) and its last
    reading past its block, residuals given: K1 with ``streams=4`` equal to
    its plain version to the bit and to each stream alone; then one frame a
    stream at 2 rows a tile, a launch of fewer tiles than the card holds
    blocks."""
    demod, bf16 = LOADS[load]
    mode, frame_len, n, words, starts, fracs = _slice_block(cuda_device, dtype, demod, 4)
    raster = (frame_len, mode.height, mode.width, (600, 800))
    geom = rk.screen_geometry(*raster, cuda_device)
    per = starts[:36].clone()
    per[0] = 0
    per[-1] = n - 2000
    starts = torch.cat([per + b * n for b in range(4)])
    opts = dict(demod=demod, bf16=bf16, invert=invert)
    got = rk.frames_to_screens_from_words(words, starts, *raster, fracs, taps, streams=4, **opts)
    ref = rk.frames_to_screens_plain(rk.words_envelope_plain(words, demod, bf16, invert, 4),
                                     starts, geom, fracs, taps, streams=4)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    for b in (0, 3):
        alone = rk.frames_to_screens_from_words(words[2 * n * b: 2 * n * (b + 1)], per, *raster,
                                                fracs[36 * b: 36 * (b + 1)], taps, **opts)
        torch.cuda.synchronize()
        assert torch.equal(got[36 * b: 36 * (b + 1)], alone), b
    one = torch.stack([per[-1] + b * n for b in range(4)]).to(torch.int32)
    got = rk.frames_to_screens_from_words(words, one, *raster, None, taps, streams=4, **opts)
    ref = rk.frames_to_screens_plain(rk.words_envelope_plain(words, demod, bf16, invert, 4), one,
                                     geom, None, taps, streams=4)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["am", "fm", "invert", "invert_fm_4_taps_exact_cuts"])
def test_batched_step_on_the_card_takes_the_words_load(cuda_device, case):
    """The batched step at B = 4 of the slice on the card: one K1 words
    launch (and under ``invert`` one block maximum for the four streams),
    no envelope launch, and each stream's frames, EMA, sync and score equal
    to its single step's to the bit."""
    options = {"am": {}, "fm": {"demod": "fm"}, "invert": {"invert": True},
               "invert_fm_4_taps_exact_cuts": {"invert": True, "demod": "fm", "interp_taps": 4,
                                               "carry_phase": True, "subsample_align": True}}[case]
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    cfg = poff.ReconstructionConfig(sample_rate=20e6, mode=mode, n_frames=36,
                                    render_size=(600, 800), input_format="iq_interleaved",
                                    align_subpixel=True, **options)
    words = _random_words(cuda_device, 4 * cfg.block_samples, np.int16, seed=5).view(4, -1)
    ema0 = torch.zeros((4, 600, 800), device=cuda_device)
    phases = ([0.0, 1234.56, 98765.4321, 222222.125],) if cfg.carry_phase else ()
    with count_launches() as seen:
        out = poff.make_batched_reconstruct_fn(cfg, device=cuda_device)(words, ema0, 0.5,
                                                                         *phases)
    torch.cuda.synchronize()
    # One K1 launch, of the words entry (its variant goes on with the demod).
    (variant,) = [key for key in seen if key[0] == "k1" and key != "k1"]
    assert seen["k1"] == 1 and variant[3] == cfg.demod
    assert seen["words_max"] == (1 if cfg.invert else 0)
    single = poff.make_reconstruct_fn(cfg, cuda_device)
    for b in range(4):
        ema_s, frames, sync, score = single(words[b], ema0[b], 0.5, *[p[b] for p in phases])
        torch.cuda.synchronize()
        assert torch.equal(out[1][b], frames) and torch.equal(out[0][b], ema_s), b
        assert torch.equal(out[2][b], sync) and torch.equal(out[3][b], score), b


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["invert_mxu3", "invert_fm_4_taps"])
def test_inverted_step_on_the_card_equals_the_pass_route(cuda_device, case):
    """The slice's step under ``invert`` on the card against the pass route
    (``demodulate`` with its reduction, then the envelope entry): the same
    frames, sync, score and EMA to the bit; one block maximum and one K1
    words launch a step."""
    options = {"invert_mxu3": {"resampler": "mxu3"},
               "invert_fm_4_taps": {"demod": "fm", "interp_taps": 4}}[case]
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    cfg = poff.ReconstructionConfig(sample_rate=20e6, mode=mode, n_frames=36,
                                    render_size=(600, 800), input_format="iq_interleaved",
                                    align_subpixel=True, invert=True, **options)
    words = _random_words(cuda_device, cfg.block_samples, np.int16, seed=2)
    ema0 = torch.zeros((600, 800), device=cuda_device)
    with count_launches() as seen:
        got = poff.make_reconstruct_fn(cfg, cuda_device)(words, ema0, 0.5)
    (variant,) = [key for key in seen if key[0] == "k1" and key != "k1"]
    assert seen["k1"] == 1 == seen["words_max"] and variant[3] == cfg.demod
    env = poff.demodulate(words, cfg)
    ref = poff.make_reconstruct_fn(
        dataclasses.replace(cfg, input_format="envelope", invert=False), cuda_device)(
        env, ema0, 0.5)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
