"""Every ``resampler=`` name of the JAX package in the port, and the rest of
``ops/resample.py``, against their JAX counterparts on the CPU.

The port keeps each name's VALUES and not its TPU formulation: the ``mxu``
names are K1 (here its plain version, the tensors being on the CPU) with the
line fractions quantised on the host; ``aligned`` is K1 as it is; ``rows`` is
the gather evaluation; ``fft`` is ``torch.fft``.  Tolerances, each relative
to the largest output and stated where it is used:

* ``POSITION`` 2e-5: both sides read the same quantised positions, the JAX
  tables from float64 host arithmetic, K1 as ``frac + c·delta`` in float32
  (error about one ulp of a position near 127, 1e-5 sample, times a gradient
  of at most the signal's range per sample).  Measured 2.4e-6 to 3.0e-6.
* ``BF16_WEIGHTS``: ``einsum_bf16`` and ``compute_dtype=bfloat16`` round the
  JAX interpolation weights to bfloat16 (relative error at most 2⁻⁸ each);
  K1 keeps float32 weights, so the outputs differ by at most 2⁻⁸·Σ|w|·max:
  2⁻⁸ for 2 taps, 1.25·2⁻⁸ for Catmull-Rom.  Measured 1.9e-3 and 3.0e-3.
  The bfloat16 rounding of the ENVELOPE is reproduced exactly and needs no
  tolerance.
* With 4 taps the JAX tables replicate the border of each line's span where
  K1 reads the real sample before the line: column 0 is left out.
* The per-frame JAX formulations pad each frame with its last sample; K1
  reads on into the following samples: through ``process_frames`` the last
  two rows of each screen are left out.

Shapes: 640x480 @ 60 Hz (800x525) at 4 Msps, 3 frames, screens of 300x100
(the JAX ``mxu3`` tables need a screen whose last row reaches the raster's
last lines).
"""

import dataclasses

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.ops import resample as presample
from tempest_tpu_torch.ops import resample_kernel
from tempest_tpu_torch.pipeline import offline as poff

MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6
SHAPE = (300, 100)
SPF = FS / MODE.refresh
FRAME_LEN = int(SPF)
N_FRAMES = 3
POSITION = 2e-5
BF16 = 2.0 ** -8


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


@pytest.fixture(scope="module")
def envelope():
    cap = tp.generate_iq(MODE, FS, int(N_FRAMES * SPF) + 400, snr_db=18.0, seed=4)
    return np.abs(cap.iq).astype(np.float32)


@pytest.fixture(scope="module")
def jres():
    return pytest.importorskip("tempest_tpu.ops.resample")


@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


def _rel(got, ref, where=np.s_[...]):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref)[where].max() / np.abs(ref).max())


STARTS = np.round(np.arange(N_FRAMES) * SPF).astype(np.int32)
GEOM = (MODE.height, MODE.width, SHAPE)


# ------------------------------------------------------ one frame, by name
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("num_phases", [16, 64])
@pytest.mark.parametrize("name", ["mxu", "mxu2", "mxu3", "mxu4"])
def test_frame_to_screen_by_name_matches_jax(name, num_phases, taps, envelope, jres, jnp):
    sig = envelope[:FRAME_LEN]
    jfn = {"mxu": lambda s: jres.frame_to_screen_mxu(s, *GEOM, num_phases, "gather", taps),
           "mxu2": lambda s: jres.frame_to_screen_mxu(s, *GEOM, num_phases, "einsum", taps),
           "mxu3": lambda s: jres.frame_to_screen_mxu3(s, *GEOM, num_phases, False, taps),
           "mxu4": lambda s: jres.frame_to_screen_mxu4(s, *GEOM, num_phases, taps)}[name]
    pfn = {"mxu": lambda s: presample.frame_to_screen_mxu(s, *GEOM, num_phases, "gather", taps),
           "mxu2": lambda s: presample.frame_to_screen_mxu(s, *GEOM, num_phases, "einsum", taps),
           "mxu3": lambda s: presample.frame_to_screen_mxu3(s, *GEOM, num_phases, False, taps),
           "mxu4": lambda s: presample.frame_to_screen_mxu4(s, *GEOM, num_phases, taps)}[name]
    ref = np.asarray(jfn(jnp.asarray(sig)))
    got = pfn(torch.from_numpy(sig)).numpy()
    assert got.shape == ref.shape == SHAPE
    where = np.s_[:, 1:] if taps == 4 else np.s_[...]
    assert _rel(got, ref, where) < POSITION


@pytest.mark.parametrize("taps", [2, 4])
def test_einsum_bf16_differs_by_the_weights_rounding_only(taps, envelope, jres, jnp):
    sig = envelope[:FRAME_LEN]
    ref = np.asarray(jres.frame_to_screen_mxu3(jnp.asarray(sig), *GEOM, 64, True, taps))
    got = presample.frame_to_screen_mxu3(torch.from_numpy(sig), *GEOM, 64, True, taps).numpy()
    plain = presample.frame_to_screen_mxu3(torch.from_numpy(sig), *GEOM, 64, False, taps).numpy()
    assert np.array_equal(got, plain), "einsum_bf16 changes no value in the port"
    where = np.s_[:, 1:] if taps == 4 else np.s_[...]
    bound = BF16 * (1.0 if taps == 2 else 1.25)
    diff = _rel(got, ref, where)
    assert POSITION < diff < bound, diff   # the rounding is there, and within its bound


def test_mxu3_rounds_the_envelope_to_bfloat16_and_mxu_does_not(envelope):
    sig = torch.from_numpy(envelope[:FRAME_LEN])
    rounded = presample.round_to_bfloat16(sig)
    assert 1e-4 < float((rounded - sig).abs().max() / sig.abs().max()) < 2.0 ** -8
    a = presample.frame_to_screen_mxu3(sig, *GEOM, 64)
    b = presample.frame_to_screen_mxu(rounded, *GEOM, 64)
    assert torch.equal(a, b)
    assert not torch.equal(a, presample.frame_to_screen_mxu(sig, *GEOM, 64))


# --------------------------------------------------- block-level functions
@pytest.mark.parametrize("num_phases", [16, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_frames_to_screens_mxu_matches_jax(num_phases, dtype, envelope, jres, jnp):
    ref = np.asarray(jres.frames_to_screens_mxu(
        jnp.asarray(envelope), STARTS, FRAME_LEN, *GEOM, num_phases, getattr(jnp, dtype)))
    got = presample.frames_to_screens_mxu(
        torch.from_numpy(envelope), torch.from_numpy(STARTS), FRAME_LEN, *GEOM, num_phases,
        getattr(torch, dtype)).numpy()
    assert got.shape == ref.shape == (N_FRAMES, *SHAPE)
    assert _rel(got, ref) < (BF16 if dtype == "bfloat16" else POSITION)


def test_segments_change_no_value_here_and_stay_within_the_quantisation_in_jax(
        envelope, jres, jnp):
    """The JAX ``segments`` quantise each column block's fraction on its
    own, so both sides are within 1/(2P) sample of the exact position and
    within 1/P of each other: at most (1/P)·max|env[i+1] − env[i]|."""
    args = (torch.from_numpy(envelope), torch.from_numpy(STARTS), FRAME_LEN, *GEOM, 16)
    one = presample.frames_to_screens_mxu(*args, torch.float32, 1)
    four = presample.frames_to_screens_mxu(*args, torch.float32, 4)
    assert torch.equal(one, four)
    with pytest.raises(ValueError, match="must divide"):
        presample.frames_to_screens_mxu(*args, torch.float32, 3)
    ref = np.asarray(jres.frames_to_screens_mxu(
        jnp.asarray(envelope), STARTS, FRAME_LEN, *GEOM, 16, jnp.float32, 4))
    bound = np.abs(np.diff(envelope)).max() / 16
    assert np.abs(four.numpy() - ref).max() < bound


def test_frames_to_screens_aligned_matches_jax(envelope, jres, jnp):
    """The JAX side adds the chunk offset (up to 127), the fraction and
    ``c·delta`` in float32: an ulp near 250 is 1.5e-5 sample, so 1e-4 of the
    largest output.  Measured 7.5e-6."""
    ref = np.asarray(jres.frames_to_screens_aligned(
        jnp.asarray(envelope), STARTS, FRAME_LEN, *GEOM))
    got = presample.frames_to_screens_aligned(
        torch.from_numpy(envelope), torch.from_numpy(STARTS), FRAME_LEN, *GEOM).numpy()
    assert _rel(got, ref) < 1e-4
    k1 = resample_kernel.frames_to_screens(
        torch.from_numpy(envelope), torch.from_numpy(STARTS), FRAME_LEN, *GEOM)
    assert np.array_equal(got, k1.numpy()), "aligned is K1"


def test_frames_to_screens_fft_matches_jax(envelope, jres, jnp):
    """Two float32 FFTs of 66,666 and 67,200 points whose libraries add in
    another order (errors of a few 1e-7 of the signal), one matmul of 2
    non-zero weights a column: 1e-5 of the largest output.  Measured 7e-7."""
    ref = np.asarray(jres.frames_to_screens_fft(
        jnp.asarray(envelope), STARTS, FRAME_LEN, *GEOM))
    got = presample.frames_to_screens_fft(
        torch.from_numpy(envelope), torch.from_numpy(STARTS), FRAME_LEN, *GEOM).numpy()
    assert got.shape == ref.shape == (N_FRAMES, *SHAPE)
    assert _rel(got, ref) < 1e-5


def test_frame_to_screen_rows_matches_jax(envelope, jres, jnp):
    """Both sides build their positions in float64 on the host and blend in
    float32, the JAX side from per-line spans: 1e-6.  Measured 1.1e-7."""
    sig = envelope[:FRAME_LEN]
    ref = np.asarray(jres.frame_to_screen_rows(jnp.asarray(sig), *GEOM))
    got = presample.frame_to_screen_rows(torch.from_numpy(sig), *GEOM).numpy()
    assert _rel(got, ref) < 1e-6


@pytest.mark.parametrize("mode_name", ["640x480 @ 60Hz", "800x600 @ 72Hz"])
def test_frame_to_screen_dynamic_matches_jax(mode_name, envelope, jres, jnp):
    """Geometry as data: every position in float32, operation by operation
    as the JAX function states them.  A position near 66,666 has an ulp of
    0.0078 sample, and XLA may contract a multiply-add where PyTorch rounds
    twice, which moves a position by one ulp: 0.0078·max|env[i+1] − env[i]|
    absolute.  Measured 0.0 on the first geometry."""
    mode = tp.ALL_VIDEO_MODES[mode_name]
    sig = envelope[:FRAME_LEN]
    ref = np.asarray(jres.frame_to_screen_dynamic(
        jnp.asarray(sig), float(mode.height), float(mode.width), SHAPE))
    got = presample.frame_to_screen_dynamic(
        torch.from_numpy(sig), torch.tensor(float(mode.height)), float(mode.width), SHAPE).numpy()
    assert got.shape == SHAPE
    assert np.abs(got - ref).max() <= 0.0078 * np.abs(np.diff(sig)).max()
    # The same function as the static gather path, to float32 positions.
    static = presample.frame_to_screen(torch.from_numpy(sig), mode.height, mode.width, SHAPE)
    assert np.abs(got - static.numpy()).max() <= 2 * 0.0078 * np.abs(np.diff(sig)).max()


# ----------------------------------------------------- the 1-D resamplers
@pytest.mark.parametrize("frac", [0.0, 0.3, 0.999])
def test_fractional_shift_matches_jax(frac, envelope, jres, jnp):
    """The same bank (host numpy, equal to the bit), the same phase index,
    eight multiply-adds in the same order: 1e-6.  Measured 0.0."""
    sig = envelope[:8192]
    ref = np.asarray(jres.fractional_shift(jnp.asarray(sig), frac))
    got = presample.fractional_shift(torch.from_numpy(sig), frac).numpy()
    assert _rel(got, ref) < 1e-6
    if frac == 0.0:
        assert np.abs(got - sig).max() < 1e-6 * sig.max()


def test_upsamplers_and_host_tables_match_jax(envelope, jres, jnp):
    """``naive_upsample`` and the host tables are equal to the bit;
    ``upsample_fft`` is two complex64 FFTs of 16,384 points: 1e-5.  Measured
    4.5e-7."""
    sig = envelope[:4096]
    assert np.array_equal(presample.naive_upsample(torch.from_numpy(sig), 3).numpy(),
                          np.asarray(jres.naive_upsample(jnp.asarray(sig), 3)))
    assert np.array_equal(presample.polyphase_filter_bank(32, 8, 0.7),
                          jres.polyphase_filter_bank(32, 8, 0.7))
    assert np.array_equal(presample.make_fft_upsampler_filter(256, 4),
                          jres.make_fft_upsampler_filter(256, 4))
    ref = np.asarray(jres.upsample_fft(jnp.asarray(sig), 4))
    got = presample.upsample_fft(torch.from_numpy(sig), 4).numpy()
    assert got.shape == (4 * 4096,) and _rel(got, ref) < 1e-5


@pytest.mark.parametrize("ratio", [0.37, 1.0, 2.5])
def test_polyphase_resample_matches_jax(ratio, envelope, jres, jnp):
    """Float32 positions ``i·ratio`` (one product each, the same on both
    sides), the same bank, an 8-term sum whose order may differ: 1e-6.
    Measured 1.7e-7."""
    sig = envelope[:FRAME_LEN]
    ref = np.asarray(jres.polyphase_resample(jnp.asarray(sig), 5000, ratio))
    got = presample.polyphase_resample(torch.from_numpy(sig), 5000, ratio).numpy()
    assert got.shape == (5000,) and _rel(got, ref) < 1e-6


def test_polyphase_resample_with_a_tensor_ratio(envelope, jres, jnp):
    sig = envelope[:FRAME_LEN]
    ref = np.asarray(jres.polyphase_resample(jnp.asarray(sig), 5000, jnp.asarray(1.7),
                                             cutoff=0.5))
    got = presample.polyphase_resample(torch.from_numpy(sig), 5000, torch.tensor(1.7),
                                       cutoff=0.5).numpy()
    assert _rel(got, ref) < 1e-6
    with pytest.raises(ValueError, match="cutoff"):
        presample.polyphase_resample(torch.from_numpy(sig), 5000, torch.tensor(1.7))


# ------------------------------------------------- the quantised line table
@pytest.mark.parametrize("num_phases", [1, 16, 64])
def test_quantised_table_keeps_starts_and_stays_within_half_a_level(num_phases):
    plain = resample_kernel.screen_geometry(FRAME_LEN, *GEOM, torch.device("cpu"))
    quant = resample_kernel.screen_geometry(FRAME_LEN, *GEOM, torch.device("cpu"), num_phases)
    assert torch.equal(plain.line_start, quant.line_start)   # so tile_run_cap's order holds
    assert torch.equal(plain.wr, quant.wr) and plain.span == quant.span
    assert plain.delta == quant.delta
    diff = (quant.line_frac - plain.line_frac).abs().max()
    assert float(diff) <= 0.5 / num_phases + 1e-7
    levels = (quant.line_frac.double() * num_phases - 0.5)
    assert torch.allclose(levels, levels.round(), atol=1e-5)
    # K1's staging plan reads the starts only: the same tiles for both tables.
    for sample_bytes in (4, 8):
        resample_kernel.tile_plan(FRAME_LEN, *GEOM, sample_bytes)
    with pytest.raises(ValueError, match="num_phases"):
        resample_kernel.quantise_line_frac(np.zeros(3, np.float32), 0)


def test_quantised_table_takes_the_negative_phases_of_the_jax_plan(jres):
    """A raster with less than one sample per output column starts row 0
    before sample 0: the start is clamped and the fraction is negative.  The
    port quantises it as ``frames_to_screens_mxu``'s plan does (phases in
    [-P, P)), so K1's clamp of the position at 0 applies to both."""
    shape = (600, 640)   # delta = 800/640 · 66666/420000 = 0.198 sample a column
    start, frac, _, _, _ = presample._screen_geometry(FRAME_LEN, MODE.height, MODE.width, shape)
    assert start[0, 0] < 0
    line_start, line_frac, _, _, _ = resample_kernel._line_tables(
        FRAME_LEN, MODE.height, MODE.width, shape)
    assert line_frac[0, 0] < 0 and line_start[0, 0] == 0
    q = resample_kernel.quantise_line_frac(line_frac, 16)
    assert q[0, 0] < 0 and abs(q[0, 0] - line_frac[0, 0]) <= 0.5 / 16
    raw = start.reshape(-1)
    lf = np.clip(frac.reshape(-1) + (raw - np.maximum(raw, 0)), -1.0, 1.0 - 1e-6).astype(np.float64)
    phase = np.clip(np.floor((lf + 1.0) * 16).astype(np.int64) - 16, -16, 15)
    assert np.allclose(q.reshape(-1), (phase + 0.5) / 16, atol=1e-7)


# ------------------------------------------- through process_frames, by name
NAMES = ["gather", "rows", "mxu", "mxu2", "mxu3", "mxu4", "mxu_batched", "aligned", "fft"]


def _config(module, name, **kw):
    mode = module.VideoMode(MODE.width, MODE.height, MODE.refresh)
    return module.ReconstructionConfig(
        sample_rate=FS, mode=mode, n_frames=N_FRAMES, render_size=SHAPE, do_align=False,
        resampler=name, input_format="envelope", **kw)


@pytest.mark.parametrize("name", NAMES)
def test_process_frames_by_name_matches_jax(name, envelope, jnp):
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jmodes = pytest.importorskip("tempest_tpu.video.modes")
    jcfg = joff.ReconstructionConfig(
        sample_rate=FS, mode=jmodes.VideoMode(MODE.width, MODE.height, MODE.refresh),
        n_frames=N_FRAMES, render_size=SHAPE, do_align=False, resampler=name, num_phases=16)
    pcfg = dataclasses.replace(_config(poff, name), num_phases=16)
    ref, _, _ = joff.process_frames(jnp.asarray(envelope), STARTS, jcfg, FRAME_LEN)
    got, sync, score = poff.process_frames(
        torch.from_numpy(envelope), torch.from_numpy(STARTS), pcfg, FRAME_LEN)
    assert got.shape == (N_FRAMES, *SHAPE) and not sync.any() and not score.any()
    # mxu_batched computes in bfloat16 in JAX (weights too); aligned adds its
    # chunk offsets in float32; the last two rows read past the frame end.
    tol = {"mxu_batched": BF16, "aligned": 1e-4}.get(name, POSITION)
    assert _rel(got.numpy(), np.asarray(ref), np.s_[:, :-2]) < tol


@pytest.mark.parametrize("name", ["pallas"] + NAMES)
def test_every_resampler_name_runs_a_block(name, envelope):
    """``ReconstructionConfig(resampler=name)`` runs for every name the JAX
    package accepts, with ``frame_loop="scan"`` giving the ``"vmap"`` values,
    and lands within the quantisation (1/(2P) sample) and the bfloat16
    rounding of the envelope (2⁻⁹ of a sample's value) of K1's exact read:
    (1/(2·64) · max gradient + 2⁻⁸ · max) for the K1 names."""
    env = torch.from_numpy(envelope)
    cfg = _config(poff, name, num_phases=64)
    n = cfg.block_samples
    ema0 = np.zeros(SHAPE, np.float32)
    out = poff.make_reconstruct_fn(cfg, "cpu")(env[:n], ema0, 0.5)
    scan = poff.make_reconstruct_fn(dataclasses.replace(cfg, frame_loop="scan"), "cpu")(
        env[:n], ema0, 0.5)
    for a, b in zip(out, scan):
        assert torch.equal(a, b)
    assert out[1].shape == (N_FRAMES, *SHAPE) and bool(torch.isfinite(out[0]).all())
    exact = poff.make_reconstruct_fn(_config(poff, "pallas"), "cpu")(env[:n], ema0, 0.5)[1]
    diff = float((out[1] - exact)[:, :-2].abs().max())
    if poff.RESAMPLERS[name].route == "k1":
        bound = np.abs(np.diff(envelope)).max() / 128 + BF16 * envelope.max()
        assert diff <= bound
    else:
        assert diff < 0.25 * envelope.max()   # another interpolation of the same screen
    rec = poff.reconstruct_frames(envelope, cfg, alpha=0.5, device="cpu")
    assert np.array_equal(rec.frames, out[1].numpy())


def test_unknown_names_and_loops_raise():
    step = poff.make_reconstruct_fn
    with pytest.raises(ValueError, match="unknown resampler"):
        step(_config(poff, "mxu5"), "cpu")
    with pytest.raises(ValueError, match="frame_loop"):
        step(_config(poff, "mxu", frame_loop="while"), "cpu")
    for name in ("rows", "aligned", "mxu", "mxu2", "mxu4", "mxu_batched", "fft"):
        with pytest.raises(ValueError, match="subsample_align"):
            step(_config(poff, name, subsample_align=True), "cpu")


def test_mxu3_exact_cuts_stay_within_the_quantisation_of_the_jax_tables(envelope, jres, jnp):
    """``mxu3`` with ``subsample_align``: the JAX package folds each frame's
    residual into quantised tables (``frames_to_screens_mxu3_exact``), the
    port hands K1 the residual unquantised.  Both round the envelope to
    bfloat16 alike, so they differ by the quantisation alone: at most
    1/(2P) sample, times the largest step of the rounded envelope."""
    starts, fracs = poff.exact_cut_starts(0.0, SPF, N_FRAMES)
    assert fracs[1] > 0.1
    ref = np.asarray(jres.frames_to_screens_mxu3_exact(
        jnp.asarray(envelope), starts, fracs, FRAME_LEN, *GEOM, num_phases=64))
    cfg = _config(poff, "mxu3", subsample_align=True, num_phases=64)
    got, _, _ = poff.process_frames(
        torch.from_numpy(envelope), torch.from_numpy(starts), cfg, FRAME_LEN,
        frac_offsets=torch.from_numpy(fracs))
    rounded = presample.round_to_bfloat16(torch.from_numpy(envelope)).numpy()
    bound = np.abs(np.diff(rounded)).max() / 128
    assert np.abs(got.numpy() - ref)[:, :-2].max() <= bound * 1.001
    # Unquantised: the values of K1 on the rounded envelope with residuals.
    k1 = resample_kernel.frames_to_screens(
        torch.from_numpy(rounded), torch.from_numpy(starts), FRAME_LEN, *GEOM,
        torch.from_numpy(fracs))
    assert torch.equal(got, k1)


def test_fused_demod_is_taken_where_the_envelope_is_not_rounded():
    """Every K1 name fuses the demod; since K1's words load takes the
    bfloat16 rounding, so do the names that round the envelope.  The plain
    formulations demodulate as a pass."""
    words = torch.zeros(8, dtype=torch.int16)
    for name, fused in (("pallas", True), ("aligned", True), ("mxu", True), ("mxu2", True),
                        ("mxu3", True), ("mxu4", True), ("mxu_batched", True),
                        ("gather", False), ("rows", False), ("fft", False)):
        cfg = dataclasses.replace(_config(poff, name), input_format="iq_interleaved")
        assert poff.fuses_demod(cfg, words) is fused, name


@pytest.mark.parametrize("name", ["mxu", "aligned"])
def test_words_entry_with_a_quantised_table_equals_demod_then_resample(name, envelope):
    rng = np.random.default_rng(8)
    n = dataclasses.replace(_config(poff, name), input_format="iq_interleaved").block_samples
    words = torch.from_numpy((rng.standard_normal(2 * n) * 3000).astype(np.int16))
    cfg = dataclasses.replace(_config(poff, name), input_format="iq_interleaved", num_phases=16)
    ema0 = np.zeros(SHAPE, np.float32)
    fused = poff.make_reconstruct_fn(cfg, "cpu")(words, ema0, 0.5)[1]
    env = tp.am_envelope_from_iq(words)
    unfused = poff.make_reconstruct_fn(
        dataclasses.replace(cfg, input_format="envelope"), "cpu")(env, ema0, 0.5)[1]
    assert torch.equal(fused, unfused)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("num_phases", [16, 64])
def test_k1_cuda_with_a_quantised_table_matches_plain(cuda_device, num_phases, taps):
    """K1 on the card with the quantised line table against its plain
    version: the same float32 operations, 1e-6 of the largest output."""
    mode = tp.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    spf = 20e6 / mode.refresh
    frame_len = int(spf)
    starts = np.round(np.arange(3) * spf).astype(np.int32)
    n = int(starts[-1]) + frame_len + 1
    env = torch.from_numpy(np.random.default_rng(0).random(n, dtype=np.float32)).to(cuda_device)
    st = torch.from_numpy(starts).to(cuda_device)
    for shape in ((600, 800), (150, 200)):
        geom = resample_kernel.screen_geometry(frame_len, mode.height, mode.width, shape,
                                               cuda_device, num_phases)
        got = resample_kernel.frames_to_screens(env, st, frame_len, mode.height, mode.width,
                                                shape, None, taps, num_phases)
        ref = resample_kernel.frames_to_screens_plain(env, st, geom, None, taps)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
