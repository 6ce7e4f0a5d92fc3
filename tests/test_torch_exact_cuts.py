"""Sub-sample-exact frame cuts and 4-tap interpolation in the port: K1 with
per-frame residuals and 2 or 4 taps, the gather resampler, and the step's
exact-cut routes, against the JAX package on the CPU.

Small config: 640x480 @ 60 Hz (800x525 total) at 4 Msps onto 48x99 screens.
On the CPU the K1 wrappers run K1's plain PyTorch version.

What K1 and the JAX gather path do differently by design, and what the
comparisons leave out for it:

* The gather path clips every read position into the frame and caps the
  first tap at ``n_in - 3``; K1 reads on into the following samples.  Rows
  whose reads reach the last three samples of the frame are left out.
* The gather path clips the position at 0 BEFORE it adds the residual; K1
  adds the residual first.  They differ where ``a + c·delta < 0``: column 0
  of row 0's upper line.  That pixel is left out.
* There is no exact-offset JAX oracle for 4 taps.  4 taps with residuals are
  held against a float64 numpy evaluation of K1's formula; 4 taps without
  them against ``frame_to_screen_mxu(interp_taps=4)`` within its 1/num_phases
  position quantisation, and ``frame_to_screen_mxu3`` within that plus its
  bf16 selection.  The JAX weight tables replicate the border of a line's
  span, K1 reads the real sample before the line: columns whose tap -1 falls
  before the line start are left out, and row 0, whose negative fraction the
  tables clip to 0.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempest_tpu.ops.resample as jres
import tempest_tpu.pipeline.offline as joff
from tempest_tpu_torch._build import count_launches
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops import resample as pres
from tempest_tpu_torch.ops import resample_kernel
from tempest_tpu_torch.ops.demod import am_envelope_from_iq
from tempest_tpu_torch.ops.resample_kernel import (
    frame_to_screen,
    frames_to_screens,
    frames_to_screens_from_words,
    frames_to_screens_plain,
    line_reach,
    screen_geometry,
    tile_plan,
    tile_run_cap,
)
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES, VideoMode

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 4e6
SHAPE = (48, 99)
FRAME_LEN = int(np.floor(FS / MODE.refresh))
ALPHA = 0.5
VARIANTS = [(2, True), (4, False), (4, True)]
VARIANT_IDS = ["2taps_residuals", "4taps", "4taps_residuals"]


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


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _smooth(n):
    t = np.arange(n)
    return (1.5 + np.sin(2 * np.pi * t / 797.0) + 0.3 * np.cos(2 * np.pi * t / 91.0)).astype(
        np.float32)


def _envelope(n, seed):
    return np.abs(generate_iq(MODE, FS, n, snr_db=18.0, seed=seed).iq).astype(np.float32)


def _positions(frame_len, mode, shape):
    """K1's read positions of one frame in float64, relative to the frame
    start and without a residual: [h, 2, w]."""
    start, frac, _, cols, _ = pres._screen_geometry(frame_len, mode.height, mode.width, shape)
    return (start + frac.astype(np.float64))[:, :, None] + cols[None, None, :]


def _comparable(frame_len, mode, shape, lead=0):
    """[h, w] mask of the pixels where K1 and a formulation that stays
    inside the frame (and ``lead`` samples after each line start) agree by
    design: both of the pixel's scan lines read inside the frame."""
    pos = _positions(frame_len, mode, shape)
    start = np.floor(pos[:, :, :1])
    inside = (pos >= 0) & (pos - start >= lead) & (pos + 1.0 < frame_len - 3)
    return inside.all(axis=1)


# ------------------------------------------------------ the gather resampler
@pytest.mark.parametrize("offset", [None, 0.0, 0.37, 0.999], ids=str)
@pytest.mark.parametrize("signal", ["smooth", "capture"])
def test_gather_frame_to_screen_matches_jax(offset, signal):
    """The port's ``resampler="gather"`` building block: the same host
    geometry in float64 and the same float32 weights, 1e-6 relative."""
    sig = _smooth(FRAME_LEN) if signal == "smooth" else _envelope(FRAME_LEN, seed=2)
    ref = np.asarray(jres.frame_to_screen(jnp.asarray(sig), MODE.height, MODE.width, SHAPE,
                                          offset=offset))
    got = pres.frame_to_screen(torch.from_numpy(sig), MODE.height, MODE.width, SHAPE,
                               offset=offset).numpy()
    assert got.shape == SHAPE and got.dtype == np.float32
    assert _rel(got, ref) < 1e-6


def test_catmull_rom_weights_match_jax_and_k1():
    t = np.linspace(0.0, 1.0, 33, endpoint=False)
    for mine, theirs in zip(pres._catmull_rom(t), jres._catmull_rom(t)):
        np.testing.assert_array_equal(mine, theirs)
    k1 = resample_kernel.catmull_rom_weights(torch.from_numpy(t.astype(np.float32)))
    for mine, ref in zip(k1, pres._catmull_rom(t)):
        np.testing.assert_allclose(mine.numpy(), ref, atol=2e-7)
    np.testing.assert_allclose(sum(k1).numpy(), 1.0, atol=3e-7)


# ------------------------------------------- K1 with residuals, against JAX
@pytest.mark.parametrize("signal, tol", [("smooth", 1e-5), ("capture", 1e-4)])
def test_k1_residuals_match_jax_gather(signal, tol):
    """K1 with a residual per frame against the JAX gather path with that
    ``offset``, frame by frame.  K1 forms the position as ``c·delta +
    (frac + residual)`` in float32, the gather path splits a float64
    position: on a smooth signal within 1e-5 of the largest output, on the
    capture's noisy envelope (neighbouring samples differ by its whole
    range) within 1e-4."""
    n = 4 * FRAME_LEN
    env = _smooth(n) if signal == "smooth" else _envelope(n, seed=3)
    starts = np.array([0, FRAME_LEN // 3, 2 * FRAME_LEN + 7], np.int32)
    fracs = np.array([0.25, 0.0, 0.875], np.float32)
    got = frames_to_screens(torch.from_numpy(env), torch.from_numpy(starts), FRAME_LEN,
                            MODE.height, MODE.width, SHAPE,
                            frac_offsets=torch.from_numpy(fracs)).numpy()
    mask = _comparable(FRAME_LEN, MODE, SHAPE)
    assert mask.mean() > 0.95
    for f, (s, e) in enumerate(zip(starts, fracs)):
        ref = np.asarray(jres.frame_to_screen(
            jnp.asarray(env[s:s + FRAME_LEN]), MODE.height, MODE.width, SHAPE, offset=float(e)))
        assert np.abs(got[f] - ref)[mask].max() / np.abs(ref).max() < tol
    # The residual is what moved the image: without it the frames differ.
    rounded = frames_to_screens(torch.from_numpy(env), torch.from_numpy(starts), FRAME_LEN,
                                MODE.height, MODE.width, SHAPE).numpy()
    assert _rel(rounded[0], got[0]) > 10 * tol
    np.testing.assert_array_equal(rounded[1], got[1])   # a zero residual changes nothing


def test_frame_to_screen_with_offset_matches_frames_to_screens():
    sig = torch.from_numpy(_envelope(FRAME_LEN, seed=4))
    starts = torch.zeros(1, dtype=torch.int32)
    for taps in (2, 4):
        one = frame_to_screen(sig, MODE.height, MODE.width, SHAPE, offset=0.6, interp_taps=taps)
        ref = frames_to_screens(sig, starts, FRAME_LEN, MODE.height, MODE.width, SHAPE,
                                frac_offsets=torch.tensor([0.6]), interp_taps=taps)[0]
        assert torch.equal(one, ref)


def _k1_float64(env, starts, fracs, frame_len, mode, shape, taps):
    """K1's formula in float64 numpy: positions, index clamp into the block,
    linear or Catmull-Rom along the scan, linear blend of the two lines."""
    start, frac, wr, cols, _ = pres._screen_geometry(frame_len, mode.height, mode.width, shape)
    line_start = np.maximum(start, 0)
    line_frac = frac.astype(np.float64) + (start - line_start)
    env64 = env.astype(np.float64)
    n = env.shape[0]
    out = np.empty((len(starts), *shape))
    for f, (s, e) in enumerate(zip(starts, fracs)):
        pos = np.maximum(cols[None, None, :] + line_frac[:, :, None] + float(e), 0.0)
        i0 = np.floor(pos).astype(np.int64)
        t = pos - i0
        base = int(s) + line_start[:, :, None] + i0

        def tap(off):
            return env64[np.clip(base + off, 0, n - 1)]

        if taps == 2:
            lines = tap(0) * (1.0 - t) + tap(1) * t
        else:
            w = pres._catmull_rom(t)
            lines = sum(tap(off) * wk for off, wk in zip((-1, 0, 1, 2), w))
        wb = wr.astype(np.float64)
        out[f] = (1.0 - wb) * lines[:, 0] + wb * lines[:, 1]
    return out


@pytest.mark.parametrize("taps, exact", [(2, False)] + VARIANTS,
                         ids=["2taps"] + VARIANT_IDS)
@pytest.mark.parametrize("signal, tol", [("smooth", 1e-5), ("capture", 1e-4)])
def test_k1_matches_its_formula_in_float64(taps, exact, signal, tol):
    """Every variant of K1 against a float64 evaluation of the same formula,
    all pixels, the last frame cut by the block end and the first starting
    at sample 0 (tap -1 clamps onto sample 0).  The float32 position
    ``c·delta + frac`` is good to ~2e-5 sample: 1e-5 of the largest output
    on a smooth signal, 1e-4 on the capture's envelope."""
    n = 3 * FRAME_LEN - 500
    env = _smooth(n) if signal == "smooth" else _envelope(n, seed=5)
    starts = np.array([0, FRAME_LEN + 11, 2 * FRAME_LEN - 3], np.int32)
    fracs = np.array([0.5, 0.03125, 0.96875], np.float32) if exact else np.zeros(3, np.float32)
    got = frames_to_screens(
        torch.from_numpy(env), torch.from_numpy(starts), FRAME_LEN, MODE.height, MODE.width,
        SHAPE, frac_offsets=torch.from_numpy(fracs) if exact else None, interp_taps=taps).numpy()
    ref = _k1_float64(env, starts, fracs, FRAME_LEN, MODE, SHAPE, taps)
    assert got.shape == ref.shape == (3, *SHAPE)
    assert _rel(got, ref) < tol


@pytest.mark.parametrize("variant, num_phases, tol", [("mxu", 64, 1e-4), ("mxu", 256, 3e-5),
                                                      ("mxu3", 256, 8e-3)],
                         ids=["mxu_64", "mxu_256", "mxu3_256"])
def test_k1_four_taps_match_jax_phase_tables(variant, num_phases, tol):
    """4 taps without residuals against the JAX package's Catmull-Rom weight
    tables on a smooth signal.  Their positions are quantised to
    1/num_phases of a sample (an error of at most half a step times the
    signal's slope, here 0.03 per sample: 2.3e-4 at 64 phases, 6e-5 at 256,
    against a largest output of 2.8), and ``mxu3`` selects in bf16 (2⁻⁹
    relative).  The rule that picks 4 taps
    asks for at least one sample per raster pixel; the frame here has 1.07."""
    mode = VideoMode(160, 100, 60.0)
    frame_len = 17100
    sig = _smooth(frame_len)
    fn = jres.frame_to_screen_mxu if variant == "mxu" else jres.frame_to_screen_mxu3
    ref = np.asarray(fn(jnp.asarray(sig), mode.height, mode.width, SHAPE,
                        num_phases=num_phases, interp_taps=4))
    got = frame_to_screen(torch.from_numpy(sig), mode.height, mode.width, SHAPE,
                          interp_taps=4).numpy()
    mask = _comparable(frame_len, mode, SHAPE, lead=1)
    mask[0] = False
    assert mask.mean() > 0.9
    assert np.abs(got - ref)[mask].max() / np.abs(ref).max() < tol
    # And 4 taps are not 2 taps: the cubic moves the image by more than that.
    linear = frame_to_screen(torch.from_numpy(sig), mode.height, mode.width, SHAPE).numpy()
    assert np.abs(got - linear).max() / np.abs(ref).max() > 1e-4


def test_k1_wrapper_rejects_bad_residuals_and_taps():
    env = torch.zeros(2 * FRAME_LEN)
    starts = torch.zeros(2, dtype=torch.int32)
    args = (FRAME_LEN, MODE.height, MODE.width, SHAPE)
    with pytest.raises(ValueError, match="taps"):
        frames_to_screens(env, starts, *args, interp_taps=3)
    with pytest.raises(ValueError, match="one residual per frame"):
        frames_to_screens(env, starts, *args, frac_offsets=torch.zeros(3))
    with pytest.raises(ValueError, match="taps"):
        frames_to_screens_from_words(env, starts, *args, interp_taps=8)
    with count_launches() as seen:
        frames_to_screens(env, starts, *args, frac_offsets=torch.zeros(2), interp_taps=4)
    assert not seen   # CPU: no launch counted


# ----------------------------------------------- the kernel's staged run
@pytest.mark.parametrize("taps, exact", [(2, False)] + VARIANTS, ids=["2taps"] + VARIANT_IDS)
@pytest.mark.parametrize("rows", [1, 4, 8])
def test_tile_run_covers_residuals_and_taps(taps, exact, rows):
    """Walk every tile of the 1080p60 geometry (and of the small one): with
    the largest residual below 1, in the kernel's float32 arithmetic, every
    tap of every row lies inside the span the launcher hands the kernel and
    inside the tile's staged run, alignment slack included."""
    lead, extra = line_reach(taps, exact)
    after = 2 if taps == 4 else 1
    res = np.nextafter(np.float32(1.0), np.float32(0.0)) if exact else np.float32(0.0)
    for frame_len, mode, shape in ((FRAME_LEN, MODE, SHAPE),
                                   (333333, ALL_VIDEO_MODES["1920x1080 @ 60Hz"], (600, 800))):
        line_start, line_frac, _, delta, span = resample_kernel._line_tables(
            frame_len, mode.height, mode.width, shape)
        cap = tile_run_cap(frame_len, mode.height, mode.width, shape, rows, lead + extra)
        assert cap % 4 == 0
        cp = (np.arange(shape[1], dtype=np.float32) * np.float32(delta)).astype(np.float32)
        pos = np.maximum(cp[None, None, :] + (line_frac + res)[:, :, None], np.float32(0.0))
        last_read = np.floor(pos).astype(np.int64).max(axis=2) + after      # [h, 2]
        assert (last_read < span + extra).all()
        for r0 in range(0, shape[0], rows):
            r1 = min(r0 + rows, shape[0]) - 1
            lo = line_start[r0, 0] - lead                   # the kernel's run: [lo, hi)
            hi = line_start[r1, 1] + span + extra
            tile = line_start[r0:r1 + 1]
            assert (tile - lead >= lo).all()
            assert (tile + last_read[r0:r1 + 1] < hi).all()
            assert hi - lo + 6 <= cap
    # The plan the launcher takes is sized with the same reach.
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    rows_used, cap = tile_plan(333333, mode.height, mode.width, (600, 800), 4, lead + extra)
    assert cap == tile_run_cap(333333, mode.height, mode.width, (600, 800), rows_used,
                               lead + extra)
    assert cap >= tile_plan(333333, mode.height, mode.width, (600, 800), 4)[1]


# ------------------------------------------------------------ frame positions
def test_float32_positions_lose_the_residuals_at_full_size():
    """36 frames of 333,333.3 samples: beyond 2²³ samples float32 has no
    fraction left, so the traced JAX arithmetic gives the late frames a
    residual of 0 and may cut them a sample off; the float64 track that the
    K1 routes use keeps both."""
    spf = 20e6 / 60.0
    phase = 123456.7
    starts64, fracs64 = poff.exact_cut_starts(phase, spf, 36)
    starts32, fracs32 = poff._carry_phase_exact_f32(phase, spf, 36)
    exact = phase + spf * np.arange(36)
    np.testing.assert_array_equal(starts64, np.floor(exact).astype(np.int32))
    np.testing.assert_allclose(fracs64, exact - np.floor(exact), atol=1e-7)
    assert fracs64.dtype == np.float32 and (fracs64 < 1.0).all() and (fracs64 >= 0.0).all()
    late = exact > 2.0 ** 23
    assert late.sum() >= 10
    assert (fracs32[late] == 0.0).all()
    assert np.abs(fracs32 - fracs64)[late].max() > 0.3
    # Early frames, below 2¹⁹ samples, still agree to the float32 spacing there.
    early = exact < 2.0 ** 19
    assert np.abs(fracs32 - fracs64)[early].max() < 0.04
    np.testing.assert_array_equal(starts32[early], starts64[early])
    # A residual that float32 would round up to 1 stays below it.
    _, edge = poff.exact_cut_starts(1.0 - 1e-9, 1000.0, 2)
    assert (edge < 1.0).all() and edge[0] > 0.999999


# ------------------------------------------------------------- the step
# A refresh whose frame period is a multiple of 1/8 sample: phase + spf·k is
# then exact in float32 at this size, so the traced JAX chain and the port's
# float64 track cut at the same positions.
DYADIC_SPF = 66666.625
DYADIC_MODE = VideoMode(MODE.width, MODE.height, FS / DYADIC_SPF)


def _configs(jax_resampler, port_resampler, **kw):
    common = dict(sample_rate=FS, mode=DYADIC_MODE, n_frames=3, render_size=SHAPE,
                  input_format="iq_interleaved", subsample_align=True, do_align=False)
    common.update(kw)
    return (joff.ReconstructionConfig(resampler=jax_resampler, **common),
            poff.ReconstructionConfig(resampler=port_resampler, **common))


@pytest.fixture(scope="module")
def capture():
    jcfg, _ = _configs("gather", "gather", carry_phase=True)
    n = jcfg.block_samples
    return generate_iq(DYADIC_MODE, FS, 2 * n, snr_db=18.0, seed=6), n


@pytest.mark.parametrize("resampler", ["gather", "pallas"])
@pytest.mark.parametrize("carry", [False, True], ids=["static", "carry_phase"])
def test_exact_cut_step_matches_jax_gather_chain(capture, resampler, carry):
    """The exact-cut step over two blocks against the JAX ``gather`` chain,
    sync off.  The port's gather route is the same arithmetic: 1e-5 of the
    largest output everywhere.  The K1 route within 1e-4 (the capture's
    noisy envelope) on the pixels both read inside the frame."""
    jcfg, pcfg = _configs("gather", resampler, carry_phase=carry)
    cap, n = capture
    assert jcfg.samples_per_frame == pytest.approx(DYADIC_SPF, abs=1e-9)
    jstep = joff.make_reconstruct_fn(jcfg)
    pstep = poff.make_reconstruct_fn(pcfg, device="cpu")
    frame_len = int(np.floor(DYADIC_SPF))
    mask = np.ones(SHAPE, bool) if resampler == "gather" else _comparable(
        frame_len, DYADIC_MODE, SHAPE)
    tol = 1e-5 if resampler == "gather" else 1e-4
    ej, ep = jnp.zeros(SHAPE, jnp.float32), torch.zeros(SHAPE)
    for b in range(2):
        words = np.ascontiguousarray(cap.iq[b * n:(b + 1) * n]).view(np.float32)
        extra = ((-(b * n)) % DYADIC_SPF,) if carry else ()
        ej, fj, sj, _ = jstep(jnp.asarray(words[: 2 * jcfg.block_samples]), ej,
                              jnp.float32(ALPHA), *extra)
        ep, fp, sp, scp = pstep(words[: 2 * pcfg.block_samples], ep, ALPHA, *extra)
        assert fp.shape == (3, *SHAPE) and not sp.any() and not scp.any()
        fj, fp = np.asarray(fj), fp.numpy()
        assert np.abs(fp - fj)[:, mask].max() / np.abs(fj).max() < tol
        assert np.abs(ep.numpy() - np.asarray(ej))[mask].max() / np.abs(fj).max() < tol


def test_exact_cuts_differ_from_rounded_cuts(capture):
    """The residuals reach the image: the exact-cut frames are not the
    rounded-cut frames, and ``phase_bins`` (the JAX plan's quantisation)
    changes no value in the port."""
    cap, n = capture
    words = np.ascontiguousarray(cap.iq[:n]).view(np.float32)
    _, exact_cfg = _configs("gather", "pallas", carry_phase=True)
    _, binned_cfg = _configs("gather", "pallas", carry_phase=True, phase_bins=64)
    _, rounded_cfg = _configs("gather", "pallas", carry_phase=True, subsample_align=False)
    phase = 1234.3
    out = {}
    for name, cfg in (("exact", exact_cfg), ("binned", binned_cfg), ("rounded", rounded_cfg)):
        step = poff.make_reconstruct_fn(cfg, device="cpu")
        out[name] = step(words, torch.zeros(SHAPE), ALPHA, phase)[1]
    assert torch.equal(out["exact"], out["binned"])
    assert _rel(out["rounded"], out["exact"]) > 1e-3


@pytest.mark.parametrize("taps", [2, 4])
@pytest.mark.parametrize("words_dtype", [np.float32, np.int16, None],
                         ids=["float32_words", "int16_words", "complex"])
def test_exact_cut_step_hands_k1_the_residuals(monkeypatch, capture, taps, words_dtype):
    """The K1 routes of the step: interleaved words go to the fused entry,
    complex input to the envelope entry, each with the float64 track's
    starts and residuals and the config's taps — and neither the gather
    resampler nor a pass of PyTorch over the positions."""
    cap, n = capture
    calls = []

    def spy(name, fn):
        def wrapped(data, starts, *args):
            calls.append((name, starts.clone(), args))
            return fn(data, starts, *args)
        return wrapped

    monkeypatch.setattr(poff, "frames_to_screens", spy("envelope", poff.frames_to_screens))
    monkeypatch.setattr(poff, "frames_to_screens_from_words",
                        spy("words", poff.frames_to_screens_from_words))
    monkeypatch.setattr(poff, "frames_to_screens_gather",
                        lambda *a, **k: pytest.fail("the K1 route ran the gather resampler"))
    fmt = "complex64" if words_dtype is None else "iq_interleaved"
    _, cfg = _configs("gather", "pallas", carry_phase=True, interp_taps=taps, input_format=fmt)
    block = cap.iq[:n]
    if words_dtype is not None:
        block = block.view(np.float32)
        block = block if words_dtype == np.float32 else np.round(block * 4096).astype(np.int16)
    phase = 777.25
    step = poff.make_reconstruct_fn(cfg, device="cpu")
    step(torch.from_numpy(np.ascontiguousarray(block)), torch.zeros(SHAPE), ALPHA, phase)
    (name, starts, args), = calls
    assert name == ("envelope" if words_dtype is None else "words")
    want_starts, want_fracs = poff.exact_cut_starts(phase, DYADIC_SPF, 3)
    np.testing.assert_array_equal(starts.numpy(), want_starts)
    *_, frac_offsets, interp_taps = args
    np.testing.assert_array_equal(frac_offsets.numpy(), want_fracs)
    assert frac_offsets.dtype == torch.float32 and interp_taps == taps


@pytest.mark.parametrize("fmt", ["iq_planar", "complex64", "iq_interleaved"])
@pytest.mark.parametrize("demod", ["am", "fm"])
def test_reconstruct_frames_formats_and_fm_match_jax(fmt, demod):
    """``reconstruct_frames`` for every input format and both demodulators
    against the JAX package (Pallas kernel in interpret mode), sync off:
    1e-5 of the largest output for AM; for FM the discriminator's last-bit
    differences (2e-6 rad of ±π) pass through the same interpolation."""
    common = dict(sample_rate=FS, mode=MODE, n_frames=2, render_size=SHAPE, do_align=False,
                  input_format=fmt, demod=demod)
    jcfg = joff.ReconstructionConfig(resampler="pallas", **common)
    pcfg = poff.ReconstructionConfig(**common)
    cap = generate_iq(MODE, FS, jcfg.block_samples + 50, snr_db=18.0, seed=7,
                      modulation="fm" if demod == "fm" else "am")
    data = cap.iq if fmt != "iq_interleaved" else cap.iq.view(np.float32)
    ref = joff.reconstruct_frames(data, jcfg, alpha=ALPHA)
    got = poff.reconstruct_frames(data, pcfg, alpha=ALPHA, device="cpu")
    assert got.frames.shape == (2, *SHAPE) and got.image_raw is None
    assert _rel(got.frames, ref.frames) < 1e-5
    assert _rel(got.image, ref.image) < 1e-5
    assert got.blanking_is_dark == ref.blanking_is_dark


# ------------------------------------------------------------- on the card
def _full_size_block(device, seed=0):
    mode = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    spf = 20e6 / mode.refresh
    n = int(np.ceil(36 * spf)) + 1 + int(np.ceil(spf))
    rng = np.random.default_rng(seed)
    words = torch.from_numpy(rng.integers(-20000, 20000, 2 * n).astype(np.int16)).to(device)
    starts, fracs = poff.exact_cut_starts(1000.25, spf, 36)
    return (mode, int(np.floor(spf)), words,
            torch.from_numpy(starts).to(device), torch.from_numpy(fracs).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("taps, exact", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("entry", ["envelope", "int16_words", "float32_words"])
def test_k1_cuda_variants_equal_plain(cuda_device, entry, taps, exact):
    """Every new variant of K1 on the card, at the slice's shapes (1080p60,
    20 Msps, 36 frames, 600x800), equals its plain version to the bit: both
    do the same float32 operations in the same association, and the kernel
    forbids FMA contraction.  One launch counted, under its variant."""
    mode, frame_len, words, starts, fracs = _full_size_block(cuda_device)
    env = am_envelope_from_iq(words)
    fn, data = {"envelope": (frames_to_screens, env),
                "int16_words": (frames_to_screens_from_words, words),
                "float32_words": (frames_to_screens_from_words, words.to(torch.float32))}[entry]
    residuals = fracs if exact else None
    # The words entry counts its load too: plain AM.
    variant = (taps, exact) + (() if entry == "envelope" else ("am", False))
    with count_launches() as seen:
        got = fn(data, starts, frame_len, mode.height, mode.width, (600, 800), residuals, taps)
    assert seen["k1", *variant] == 1 == seen["k1"]
    geom = screen_geometry(frame_len, mode.height, mode.width, (600, 800), env.device)
    ref = frames_to_screens_plain(env, starts, geom, residuals, taps)
    torch.cuda.synchronize()
    assert got.shape == (36, 600, 800) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("taps, exact", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("shape", [(600, 800), (601, 402), (48, 99)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_k1_cuda_variants_at_the_block_edges(cuda_device, shape, taps, exact):
    """The first frame starts at sample 0 (tap -1 clamps onto it), the last
    reads past the block end, and the source is off 16-byte alignment: the
    tiles that take the clamped path, at widths of each work split."""
    mode, frame_len, words, _, fracs = _full_size_block(cuda_device, seed=1)
    env = am_envelope_from_iq(words)[1: 3 * frame_len - 4000]
    starts = torch.tensor([0, frame_len + 3, 2 * frame_len + 1], dtype=torch.int32,
                          device=cuda_device)
    residuals = fracs[:3].contiguous() if exact else None
    got = frames_to_screens(env, starts, frame_len, mode.height, mode.width, shape,
                            residuals, taps)
    geom = screen_geometry(frame_len, mode.height, mode.width, shape, env.device)
    ref = frames_to_screens_plain(env, starts, geom, residuals, taps)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) == 0.0
