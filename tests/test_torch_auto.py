"""The slice as a whole against the JAX package, on the CPU:
``auto_reconstruct`` (capture in, detected mode and restored screen out) and
the streaming runtime's fidelity chain and ``correlate``.

Captures are 640x480 @ 60 Hz at 4 Msps, 0.3 s (17 frames), from
``generate_iq`` with a seed.  ``auto_reconstruct`` renders 600x800 screens
in both packages (the entry has no size option).

The two packages take different resamplers by default (the JAX package its
``mxu3`` tables, quantised to 1/64 sample with a bf16 selection, the port
K1), so images are compared by PSNR, each normalised to its own range: the
raw EMA within 40 dB of the JAX package's (a 1% RMS difference), the
restored image within 35 dB (the Wiener gain amplifies the difference); with
the JAX package on its exact ``gather`` resampler the raw EMA is held to
1e-3 of its range on 99.9% of the pixels and to 60 dB overall (the gather
path clamps at the frame end where K1 reads on, and the alignment rolls
those few pixels into the image), the sub-pixel sync fractions moving by
~1e-5 px between the libraries' reductions."""

import numpy as np
import pytest
import torch

import tempest_tpu.pipeline.offline as joff
from tempest_tpu.runtime.stream import StreamingRuntime as JaxRuntime
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops import resample_kernel
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.render.screen import psnr
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES, VideoMode

NAME = "640x480 @ 60Hz"
MODE = ALL_VIDEO_MODES[NAME]
FS = 4e6
SHAPE = (48, 99)
ALPHA = 0.5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same_timing(got, ref):
    assert got.mode_name == ref.mode_name == NAME
    assert abs(got.refresh_hz - ref.refresh_hz) < 1e-3
    assert abs(got.line_count - ref.line_count) < 0.01


def _image_psnr(got, ref):
    return psnr(np.asarray(ref), np.asarray(got))


# ------------------------------------------------------------ auto_reconstruct
@pytest.fixture(scope="module")
def am_capture():
    return generate_iq(MODE, FS, int(FS * 0.3), snr_db=18.0, seed=11)


@pytest.fixture(scope="module")
def am_pair(am_capture):
    """(JAX result, port result) of the default call on the AM capture."""
    return (joff.auto_reconstruct(am_capture.iq, FS, alpha=0.6),
            poff.auto_reconstruct(am_capture.iq, FS, alpha=0.6, device="cpu"))


def test_auto_reconstruct_matches_jax(am_pair):
    (ref_t, ref), (got_t, got) = am_pair
    _same_timing(got_t, ref_t)
    assert got.image.shape == got.image_raw.shape == (600, 800)
    assert got.frames.shape == ref.frames.shape and got.sync.shape == ref.sync.shape
    assert _image_psnr(got.image_raw, ref.image_raw) > 40.0
    assert _image_psnr(got.image, ref.image) > 35.0
    assert got.blanking_is_dark == ref.blanking_is_dark
    # Restoration ran on the raw EMA and changed it.
    assert np.abs(got.image - got.image_raw).max() > 1e-3 * np.ptp(got.image_raw)
    # Equal detected refresh means an equal frame grid: the syncs agree.
    if got_t.refresh_hz == ref_t.refresh_hz:
        d = np.abs(got.sync - ref.sync)
        d = np.minimum(d, np.array([600, 800]) - d)
        assert d.max() < 0.25


def test_auto_reconstruct_raw_image_matches_jax_gather_chain(am_capture, am_pair):
    """Stage 2 alone on the port's detected timing, against the JAX package
    with its exact resampler under the same config."""
    _, (timing, got) = am_pair
    n_frames = got.frames.shape[0]
    jcfg = joff.ReconstructionConfig(sample_rate=FS, mode=timing.mode, n_frames=n_frames,
                                     align_subpixel=True, resampler="gather")
    ref = joff.reconstruct_frames(am_capture.iq, jcfg, alpha=0.6)
    span = float(np.ptp(ref.image))
    assert np.quantile(np.abs(got.image_raw - ref.image), 0.999) < 1e-3 * span
    assert _image_psnr(got.image_raw, ref.image) > 60.0
    # At 600x800 the profiles' float32 prefix sums move the parabola's
    # fraction by a few 1e-3 px between the libraries.
    assert np.abs(got.sync - ref.sync).max() < 1e-2


@pytest.mark.parametrize("option", [dict(alpha="auto"), dict(pick_line_peak=0),
                                    dict(restore=False), dict(align_subpixel=False),
                                    dict(invert=True, n_frames=6)],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_auto_reconstruct_options_match_jax(am_capture, option):
    kw = dict(alpha=0.6)
    kw.update(option)
    ref_t, ref = joff.auto_reconstruct(am_capture.iq, FS, **kw)
    got_t, got = poff.auto_reconstruct(am_capture.iq, FS, device="cpu", **kw)
    _same_timing(got_t, ref_t)
    assert got.frames.shape == ref.frames.shape
    assert (got.image_raw is None) == (ref.image_raw is None) == (not kw.get("restore", True))
    raw = got.image if got.image_raw is None else got.image_raw
    ref_raw = ref.image if ref.image_raw is None else ref.image_raw
    assert _image_psnr(raw, ref_raw) > 40.0
    if option == dict(alpha="auto"):
        assert got_t.suggested_alpha == pytest.approx(ref_t.suggested_alpha, abs=1e-4)


def test_auto_reconstruct_interleaved_words_and_tensor_input(am_capture, am_pair):
    """Real input is interleaved I/Q words; a tensor is taken as it lies.
    A complex tensor goes through ``|z|`` and K1's envelope entry where the
    words go through the fused one: an ulp in the envelope, which the
    sub-pixel sync fraction and the Wiener gain carry to 1e-3 of the range."""
    _, (timing, recon) = am_pair
    words = am_capture.iq.view(np.float32)
    for data in (words, torch.from_numpy(words), torch.from_numpy(am_capture.iq)):
        t, r = poff.auto_reconstruct(data, FS, alpha=0.6, device="cpu")
        assert t.mode_name == NAME and t.refresh_hz == timing.refresh_hz
        assert np.abs(r.image - recon.image).max() < 1e-3 * np.ptp(recon.image)


def test_auto_reconstruct_fm_matches_jax():
    """An FM capture has a flat envelope: the AM statistic cannot find its
    refresh, the discriminator chain does, in both packages."""
    cap = generate_iq(MODE, FS, int(FS * 0.3), snr_db=18.0, seed=12, modulation="fm")
    ref_t, ref = joff.auto_reconstruct(cap.iq, FS, alpha=0.6, demod="fm")
    got_t, got = poff.auto_reconstruct(cap.iq, FS, alpha=0.6, demod="fm", device="cpu")
    _same_timing(got_t, ref_t)
    assert _image_psnr(got.image_raw, ref.image_raw) > 40.0
    assert _image_psnr(got.image, ref.image) > 35.0


def test_auto_reconstruct_picks_four_taps_when_oversampled(monkeypatch):
    """The taps rule: at least one sample per raster pixel (here 26 Msps
    over 800x525x60 pixels a second, 1.03) selects Catmull-Rom, and the
    step hands K1's fused entry ``interp_taps=4``; at 4 Msps it stays 2."""
    seen = []
    fused = poff.frames_to_screens_from_words

    def spy(*args):
        seen.append(args[-1])
        return fused(*args)

    monkeypatch.setattr(poff, "frames_to_screens_from_words", spy)
    fs = 26e6
    cap = generate_iq(MODE, fs, int(fs * 0.11), snr_db=18.0, seed=13)
    timing, recon = poff.auto_reconstruct(cap.iq, fs, alpha=0.6, device="cpu")
    assert timing.mode_name == NAME and recon.frames.shape[0] == 6
    assert seen == [4]
    cfg = poff.ReconstructionConfig(sample_rate=fs, mode=timing.mode, n_frames=6,
                                    align_subpixel=True, interp_taps=4)
    np.testing.assert_array_equal(
        poff.reconstruct_frames(cap.iq, cfg, alpha=0.6, device="cpu").image, recon.image_raw)
    linear = poff.reconstruct_frames(
        cap.iq, poff.ReconstructionConfig(sample_rate=fs, mode=timing.mode, n_frames=6,
                                          align_subpixel=True), alpha=0.6, device="cpu")
    assert seen == [4, 4, 2]
    assert np.abs(linear.image - recon.image_raw).max() > 1e-4 * np.ptp(linear.image)


# -------------------------------------------------------- the fidelity runtime
# A frame period that is a multiple of 1/8 sample: the JAX runtime's traced
# float32 frame positions are then exact at this size, as the port's float64
# track is (see tests/test_torch_exact_cuts.py).
DYADIC_SPF = 66666.625
DYADIC_MODE = VideoMode(MODE.width, MODE.height, FS / DYADIC_SPF)
BLOCK = int(FS * 0.1)


def _blocks(n_blocks, seed):
    src = SyntheticSource(DYADIC_MODE, FS, BLOCK, snr_db=25.0, seed=seed)
    out = np.empty((n_blocks, BLOCK), np.complex64)
    for b in range(n_blocks):
        src.read(out[b])
    return out


def _runtimes(**kw):
    """(JAX fidelity runtime on its exact traced-offset gather chain, the
    port's fidelity runtime on K1) with nothing produced yet."""
    over = {"render_size": SHAPE}
    jrt = JaxRuntime(SyntheticSource(DYADIC_MODE, FS, BLOCK), DYADIC_MODE, alpha=ALPHA,
                     fidelity=True, fidelity_bins=0, config_overrides=over)
    prt = StreamingRuntime(SyntheticSource(DYADIC_MODE, FS, BLOCK), DYADIC_MODE, alpha=ALPHA,
                           config_overrides=over, device="cpu", **kw)
    return jrt, prt


def _close(got, ref, tol=1e-4):
    """Within ``tol`` of the largest value outside the last row, whose reads
    reach the frame end where the gather path clamps and K1 reads on."""
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref)[:-1].max() / np.abs(ref).max() < tol


def test_fidelity_runtime_matches_jax_runtime():
    jrt, prt = _runtimes(fidelity=True, fidelity_bins=0)
    cfg = prt.config
    assert cfg.subsample_align and not cfg.do_align and not cfg.align_subpixel
    assert cfg.resampler == "pallas" and cfg.n_frames == jrt.config.n_frames
    blocks = _blocks(3, seed=4)
    syncs = []
    for rt in (jrt, prt):
        for b in blocks:
            rt.ring.put(b)
    jrt.process_blocks(3)
    prt.process_blocks(3, sink=lambda img, info: syncs.append(info["sync"]))
    assert _close(prt.ema.numpy(), jrt._ema)
    assert prt.abs_pos == jrt._abs_pos == 3 * BLOCK
    assert not np.concatenate(syncs).any()          # the sync stage is skipped


def test_fidelity_bins_change_no_value():
    blocks = _blocks(2, seed=5)
    emas = []
    for bins in (0, 64):
        _, prt = _runtimes(fidelity=True, fidelity_bins=bins)
        assert prt.config.phase_bins == bins
        for b in blocks:
            prt.ring.put(b)
        emas.append(prt.process_blocks(2))
    np.testing.assert_array_equal(emas[0], emas[1])


def test_jax_fidelity_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint of the JAX fidelity runtime loads in a port runtime that
    was built for the default chain, switches it to the fidelity chain, and
    the next block gives the EMA the JAX runtime gives when it continues.
    The port's own checkpoint carries the fidelity state back."""
    blocks = _blocks(3, seed=6)
    jrt, prt = _runtimes()
    assert not prt.fidelity and prt.config.do_align
    for b in blocks[:2]:
        jrt.ring.put(b)
    jrt.process_blocks(2)
    path = str(tmp_path / "jax_fidelity.npz")
    jrt.save_checkpoint(path)

    prt.load_checkpoint(path)
    assert prt.fidelity and prt.fidelity_bins == 0
    assert prt.config.subsample_align and not prt.config.do_align
    assert prt.abs_pos == 2 * BLOCK and prt.frames_out == jrt.frames_out
    np.testing.assert_array_equal(prt.ema.numpy(), jrt._ema)
    for rt in (jrt, prt):
        rt.ring.put(blocks[2])
        rt.process_blocks(1)
    assert _close(prt.ema.numpy(), jrt._ema)

    mine = str(tmp_path / "port_fidelity.npz")
    prt.save_checkpoint(mine)
    jrt2, prt2 = _runtimes()
    for rt in (jrt2, prt2):
        rt.load_checkpoint(mine)
    assert prt2.fidelity and jrt2.fidelity and jrt2.fidelity_bins == 0
    assert jrt2._abs_pos == prt2.abs_pos == 3 * BLOCK
    np.testing.assert_array_equal(prt2.ema.numpy(), prt.ema.numpy())


def test_set_fidelity_swaps_the_chain():
    _, prt = _runtimes()
    blocks = _blocks(2, seed=7)
    prt.ring.put(blocks[0])
    prt.process_blocks(1)
    assert prt.config.do_align and not prt.config.subsample_align
    prt.set_fidelity(True)
    assert prt.fidelity and prt.config.subsample_align and not prt.config.do_align
    syncs = []
    prt.ring.put(blocks[1])
    prt.process_blocks(1, sink=lambda img, info: syncs.append(info["sync"]))
    assert prt.abs_pos == 2 * BLOCK and not syncs[0].any()
    prt.set_fidelity(False)
    assert prt.config.do_align and prt.config.align_subpixel


def test_fidelity_runtime_passes_overrides_to_k1(monkeypatch):
    """``interp_taps`` reaches K1 through ``config_overrides``, and
    ``resampler="gather"`` selects the traced-offset formulation instead."""
    seen = []
    fused = poff.frames_to_screens_from_words

    def spy(*args):
        seen.append((args[-2] is not None, args[-1]))
        return fused(*args)

    monkeypatch.setattr(poff, "frames_to_screens_from_words", spy)
    block = _blocks(1, seed=8)[0]
    emas = {}
    for name, extra in (("k1_4taps", {"interp_taps": 4}), ("k1", {}),
                        ("gather", {"resampler": "gather"})):
        prt = StreamingRuntime(SyntheticSource(DYADIC_MODE, FS, BLOCK), DYADIC_MODE, alpha=ALPHA,
                               fidelity=True, config_overrides={"render_size": SHAPE, **extra},
                               device="cpu")
        prt.ring.put(block)
        emas[name] = prt.process_blocks(1)
    assert seen == [(True, 4), (True, 2)]
    assert _close(emas["k1"], emas["gather"])
    assert not _close(emas["k1_4taps"], emas["k1"])


# ------------------------------------------------------------------ correlate
def test_runtime_correlate_matches_jax_and_hotswaps_the_mode():
    """``correlate`` on a window of the live stream is ``timing_evidence``
    (or ``estimate_timing``) on it: fed the same blocks, both runtimes find
    the same mode and adopt it."""
    wrong = ALL_VIDEO_MODES["800x600 @ 60Hz"]
    src = SyntheticSource(MODE, FS, BLOCK, snr_db=25.0, seed=9)
    blocks = np.empty((4, BLOCK), np.complex64)
    for b in range(4):
        src.read(blocks[b])
    over = {"render_size": SHAPE}
    jrt = JaxRuntime(SyntheticSource(MODE, FS, BLOCK), wrong, alpha=ALPHA, config_overrides=over)
    prt = StreamingRuntime(SyntheticSource(MODE, FS, BLOCK), wrong, alpha=ALPHA,
                           config_overrides=over, device="cpu")
    for rt in (jrt, prt):
        for b in blocks:
            rt.ring.put(b)
    ref = jrt.correlate(seconds=0.1, keep_evidence=True)
    got = prt.correlate(seconds=0.1, keep_evidence=True)
    _same_timing(got, ref)
    assert prt.mode == got.mode and prt.config.mode == got.mode
    assert prt.last_correlate_gaps == jrt.last_correlate_gaps == 0
    assert prt.last_evidence.line_peaks.shape == jrt.last_evidence.line_peaks.shape
    # The hot swap rebuilds the step, in both runtimes; the position
    # re-anchors on the ring's sequence with the next block.
    assert prt.abs_pos == jrt._abs_pos
    again = prt.correlate(seconds=0.1)
    assert again.mode_name == NAME and prt.last_evidence is not None
    prt.ring.put(blocks[0])
    prt.process_blocks(1)
    assert prt.abs_pos == 5 * BLOCK


def test_gather_window_restarts_at_a_ring_gap():
    """A block dropped between two takes of one window (the producer
    overran the ring) restarts the contiguous run: the window holds the two
    blocks after the gap, not one from either side of it."""
    src = SyntheticSource(MODE, FS, BLOCK, snr_db=25.0, seed=10)
    prt = StreamingRuntime(SyntheticSource(MODE, FS, BLOCK), MODE, ring_depth=2, device="cpu",
                           config_overrides={"render_size": SHAPE})
    produced = []

    def produce(n):
        for _ in range(n):
            block = np.empty(BLOCK, np.complex64)
            src.read(block)
            prt.ring.put(block)
            produced.append(block)

    produce(2)                                  # seq 0, 1
    take, takes = prt.ring.take, []

    def overrun_after_first_take(buf):
        if len(takes) == 1:
            produce(2)                          # seq 2, 3 into a ring of 2: seq 1 is lost
        takes.append(1)
        return take(buf)

    prt.ring.take = overrun_after_first_take
    window = prt._gather_window(0.15)           # wants two contiguous blocks
    assert prt.last_correlate_gaps == 1 and len(takes) == 3
    np.testing.assert_array_equal(window, np.concatenate(produced[2:4]))
    assert prt.abs_pos == 4 * BLOCK
