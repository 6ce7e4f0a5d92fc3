"""The rest of ``tempest_tpu_torch.runtime.stream`` against the JAX runtime:
live multi-harmonic combining, its checkpoints, ``scan``, ``record``, drift
feedback, the operator overrides, ``health``, the console and the native
ring.

Streaming comparisons feed both rings by hand (``ring.put``), with no
producer thread, so both runtimes average exactly the same blocks whatever
the host's load.  Tolerances: the combine front's weights come from means
over float32 FFT outputs (1e-4); the default chain's EMA is held to 1e-4 of
its peak (K1's float32 positions against the Pallas kernel's fixed point, as
in ``test_torch_pipeline.py``); the fidelity chain's to a PSNR of 35 dB
between the images, because the JAX fidelity chain resamples through its
gather formulation with float32 frame positions (ROADMAP Queue 3) where K1
takes float64 starts.
"""

import io

import numpy as np
import pytest
import torch

import tempest_tpu as tt
from tempest_tpu.runtime.stream import StreamingRuntime as JaxRuntime
from tempest_tpu_torch import ALL_VIDEO_MODES, VideoMode
from tempest_tpu_torch.io.dat import read_complex_binary
from tempest_tpu_torch.io.synthetic import generate_iq, generate_iq_harmonics, render_frame
from tempest_tpu_torch.native import native_available
from tempest_tpu_torch.ops.resample import downgrade_image
from tempest_tpu_torch.render.screen import aligned_psnr, psnr
from tempest_tpu_torch.runtime.console import HELP, OperatorConsole
from tempest_tpu_torch.runtime.sources import SyntheticSource
from tempest_tpu_torch.runtime.stream import StreamingRuntime

MODE = ALL_VIDEO_MODES["640x480 @ 60Hz"]
JMODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 8e6
BW = 2e6
CARRIERS = [-2.4e6, 1.8e6]
BLOCK = int(FS * 0.25)
SHAPE = (120, 160)
OVER = {"render_size": SHAPE}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stream():
    """Four 0.25 s blocks of two equal harmonics at 0 dB SNR and the screen
    they show."""
    cap = generate_iq_harmonics(MODE, FS, 4 * BLOCK, CARRIERS, amplitudes=[1.0, 1.0],
                                snr_db=0.0, seed=4)
    truth = downgrade_image(torch.from_numpy(render_frame(MODE)), SHAPE).numpy()
    return cap.iq.reshape(4, BLOCK), truth


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max())


def _port(mode=MODE, block=BLOCK, fs=FS, **kw):
    kw.setdefault("config_overrides", OVER)
    return StreamingRuntime(SyntheticSource(mode, fs, block), mode, device="cpu", **kw)


def _jax(**kw):
    over = dict(OVER)
    if not kw.get("fidelity"):
        over["resampler"] = "pallas"
    return JaxRuntime(SyntheticSource(JMODE, FS, BLOCK), JMODE, config_overrides=over, **kw)


def _feed(rt, blocks):
    for b in blocks:
        rt.ring.put(b)
    return rt.process_blocks(len(blocks))


# ---------------------------------------------------------- live combining
def test_streaming_combine_matches_jax_runtime(stream):
    """Same frame grid at the channel rate, same weights, the EMA within
    tolerance, and the fusion beats the single-carrier run on the same
    blocks."""
    blocks, truth = stream
    jrt = _jax(alpha=0.7, combine=CARRIERS, combine_bw=BW)
    prt = _port(alpha=0.7, combine=CARRIERS, combine_bw=BW)
    assert prt.config.input_format == "envelope"
    assert prt.config.sample_rate == jrt.config.sample_rate == 2e6
    assert prt.config.n_frames == jrt.config.n_frames
    assert prt.config.block_samples == jrt.config.block_samples
    assert (prt._phase_scale, prt._upload_samples) == (jrt._phase_scale, jrt._upload_samples)
    assert prt._upload_samples == 1 << 20      # only the FFT window goes up
    ema_j, ema_p = _feed(jrt, blocks), _feed(prt, blocks)
    assert prt.abs_pos == jrt._abs_pos == 4 * BLOCK and prt.frames_out == jrt.frames_out
    assert _rel(ema_p, ema_j) < 1e-4
    for got, ref in zip(prt.combine_weights, jrt.combine_weights):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    h_p, h_j = prt.health()["combine"], jrt.health()["combine"]
    assert h_p == h_j and min(h_p["weights"]) > 0.3 and h_p["centers_hz"] == CARRIERS
    single = _feed(_port(alpha=0.7, combine=[CARRIERS[0]], combine_bw=BW), blocks)
    p1, p2 = aligned_psnr(truth, single)[0], aligned_psnr(truth, ema_p)[0]
    assert p2 > p1 + 0.4, (p1, p2)


@pytest.mark.parametrize("kw", [dict(combine_demod="fm"), dict(combine_excise_db=0.0)],
                         ids=["fm", "excise"])
def test_streaming_combine_front_options_match_jax(stream, kw):
    """The FM front on a capture that leaks in frequency (2e-3: ``atan2`` of
    near-zero pairs amplifies the channels' roundings); excision on the AM
    stream."""
    blocks, _ = stream
    if "combine_demod" in kw:
        blocks = generate_iq_harmonics(MODE, FS, 2 * BLOCK, CARRIERS, snr_db=10.0, seed=6,
                                       modulation="fm").iq.reshape(2, BLOCK)
    jrt, prt = _jax(alpha=0.7, combine=CARRIERS, combine_bw=BW, **kw), \
        _port(alpha=0.7, combine=CARRIERS, combine_bw=BW, **kw)
    ema_j, ema_p = _feed(jrt, blocks[:2]), _feed(prt, blocks[:2])
    np.testing.assert_allclose(prt.combine_weights[0].numpy(), np.asarray(jrt.combine_weights[0]),
                               rtol=0, atol=1e-4)
    assert _rel(ema_p, ema_j) < (2e-3 if "combine_demod" in kw else 1e-4)
    assert prt.health()["combine"] == jrt.health()["combine"]
    assert min(prt.health()["combine"]["weights"]) > 0.2


def test_streaming_combine_composes_with_fidelity(stream):
    """Combine + exact cuts: the phase is scaled to channel samples before
    the float64 frame starts are taken from it."""
    blocks, truth = stream
    jrt = _jax(alpha=0.6, combine=CARRIERS, combine_bw=BW, fidelity=True, fidelity_bins=0)
    prt = _port(alpha=0.6, combine=CARRIERS, combine_bw=BW, fidelity=True, fidelity_bins=16)
    assert prt.config.input_format == "envelope"
    assert prt.config.subsample_align and prt.config.phase_bins == 16 and not prt.config.do_align
    ema_j, ema_p = _feed(jrt, blocks), _feed(prt, blocks)
    assert psnr(ema_j, ema_p) > 35.0
    assert aligned_psnr(truth, ema_p)[0] > aligned_psnr(truth, ema_j)[0] - 0.1


def test_set_combine_mid_stream(stream):
    """Combining switched on, re-tuned and off between blocks follows the
    JAX runtime's chain each time."""
    blocks, _ = stream
    jrt, prt = _jax(alpha=0.5), _port(alpha=0.5)
    for rt in (jrt, prt):
        _feed(rt, blocks[:1])
        rt.set_combine(CARRIERS, chan_bw=BW)
    assert prt.config.input_format == jrt.config.input_format == "envelope"
    assert prt.combine_weights is None
    # set_combine rebuilds the step, which restarts the position count, as in JAX
    assert prt.abs_pos == jrt._abs_pos == 0
    ema_j, ema_p = _feed(jrt, blocks[1:3]), _feed(prt, blocks[1:3])
    assert _rel(ema_p, ema_j) < 1e-4
    for rt in (jrt, prt):
        rt.set_combine(rt._combine_centers, demod="fm", excise_db=None)
    assert prt._combine_demod == "fm" and prt.health()["combine"] == jrt.health()["combine"]
    with pytest.raises(ValueError, match="excise_db with demod='fm'"):
        prt.set_combine(CARRIERS, excise_db=0.0)
    for rt in (jrt, prt):
        rt.set_combine(None, excise_db=None)
    assert prt.config.input_format == jrt.config.input_format == "iq_interleaved"
    assert prt.health()["combine"] is None
    ema_j, ema_p = _feed(jrt, blocks[3:]), _feed(prt, blocks[3:])
    assert _rel(ema_p, ema_j) < 2e-4       # one EMA carried through three chains


def test_combine_auto_reanchors_wrong_refresh(stream):
    """combine_auto discovers the carriers from the ring and re-anchors a
    mode that is 8 Hz off at the discovered screen's refresh; the weights
    then equal those of the run that started at the right refresh, and the
    JAX runtime's."""
    blocks, _ = stream

    def run(rt, pos):
        for b in blocks[:3]:
            rt.ring.put(b)
        found = rt.combine_auto(seconds=0.3)
        rt.process_blocks(1)
        return found, np.asarray(rt.combine_weights[0]), getattr(rt, pos)

    wrong = VideoMode(MODE.width, MODE.height, MODE.refresh + 8.0)
    prt = _port(mode=wrong, alpha=0.5, combine_bw=BW)
    found, w_wrong, _ = run(prt, "abs_pos")
    assert len(found) == 2
    for c in CARRIERS:
        assert min(abs(f - c) for f in found) <= BW / 2
    assert abs(prt.mode.refresh - MODE.refresh) < 0.1 and prt.config.input_format == "envelope"
    found_r, w_right, _ = run(_port(alpha=0.5, combine_bw=BW), "abs_pos")
    assert found_r == found
    np.testing.assert_allclose(w_wrong, w_right, atol=0.02)
    jrt = JaxRuntime(SyntheticSource(JMODE, FS, BLOCK),
                     tt.VideoMode(JMODE.width, JMODE.height, JMODE.refresh + 8.0), alpha=0.5,
                     combine_bw=BW, config_overrides={**OVER, "resampler": "pallas"})
    found_j, w_j, _ = run(jrt, "_abs_pos")
    assert found_j == found
    np.testing.assert_allclose(w_wrong, w_j, atol=1e-3)
    # Nothing found: combining goes off.
    quiet = _port(alpha=0.5, combine=CARRIERS, combine_bw=BW)
    rng = np.random.default_rng(0)
    for _ in range(2):
        quiet.ring.put((rng.standard_normal(BLOCK) + 1j * rng.standard_normal(BLOCK)
                        ).astype(np.complex64))
    assert quiet.combine_auto(seconds=0.3) == [] and quiet.config.input_format == "iq_interleaved"


@pytest.mark.parametrize("fidelity", [False, True], ids=["default", "fidelity"])
def test_combine_checkpoints_resume_across_packages(stream, tmp_path, fidelity):
    """A combine checkpoint written by the JAX runtime resumes in the port,
    and the port's in the JAX runtime, without being told of the carriers:
    the next block gives the EMA of the writer's uninterrupted run."""
    blocks, _ = stream
    kw = dict(alpha=0.6, combine=CARRIERS, combine_bw=BW, combine_excise_db=0.0,
              fidelity=fidelity)
    jkw = dict(kw, fidelity_bins=0) if fidelity else kw
    same = (lambda a, b: psnr(a, b) > 35.0) if fidelity else (lambda a, b: _rel(a, b) < 1e-4)

    jrt = _jax(**jkw)
    _feed(jrt, blocks[:2])
    path_j = str(tmp_path / "jax.npz")
    jrt.save_checkpoint(path_j)
    prt = _port(alpha=0.1)                                  # no combine arguments
    prt.load_checkpoint(path_j)
    assert prt._combine_centers == CARRIERS and prt._combine_bw == BW
    assert prt._combine_excise == 0.0 and prt.fidelity == fidelity
    assert prt.config.input_format == "envelope" and prt.alpha == pytest.approx(0.6)
    assert prt.frames_out == jrt.frames_out and prt.abs_pos == 2 * BLOCK
    assert same(_feed(prt, blocks[2:3]), _feed(jrt, blocks[2:3]))

    prt = _port(**kw)
    _feed(prt, blocks[:2])
    path_p = str(tmp_path / "port.npz")
    prt.save_checkpoint(path_p)
    jrt2 = _jax(alpha=0.1, fidelity=fidelity, **({"fidelity_bins": 0} if fidelity else {}))
    jrt2.load_checkpoint(path_p)
    assert jrt2._combine_centers == CARRIERS and jrt2.config.input_format == "envelope"
    if fidelity:
        # The checkpoint carries the port's fidelity_bins; take the JAX
        # runtime back to its traced gather chain for the comparison.
        jrt2.fidelity_bins = 0
        jrt2._rebuild()
        jrt2._abs_pos = 2 * BLOCK
    assert same(_feed(prt, blocks[2:3]), _feed(jrt2, blocks[2:3]))
    # ... and in a second port runtime, to the bit.
    prt2 = _port(alpha=0.1)
    prt2.load_checkpoint(path_p)
    np.testing.assert_array_equal(_feed(prt2, blocks[2:3]), prt.ema.numpy())


# --------------------------------------------------------------------- scan
FS_BASE = 2e6
F_EMIT = 3e6


class _RetunableSource:
    """A tunable receiver in small: delivers the emission when tuned at
    F_EMIT and noise elsewhere."""

    def __init__(self, emission: np.ndarray, block_size: int):
        self.sample_rate = FS_BASE
        self.block_size = block_size
        self.carrier_freq = 0.0
        self.gain = None
        self._sig = emission
        self._pos = 0
        self._rng = np.random.default_rng(11)

    def set_carrier(self, freq: float) -> None:
        self.carrier_freq = float(freq)

    def set_gain(self, gain: float) -> None:
        self.gain = float(gain)

    def read(self, out: np.ndarray) -> None:
        n = self.block_size
        if abs(self.carrier_freq - F_EMIT) < 0.4e6:
            out[:] = np.take(self._sig, np.arange(self._pos, self._pos + n), mode="wrap")
            self._pos += n
        else:
            out[:] = (0.2 * (self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n))
                      ).astype(np.complex64)

    def close(self) -> None:
        pass


@pytest.fixture(scope="module")
def emission():
    return generate_iq(MODE, FS_BASE, int(FS_BASE * 0.5), snr_db=25.0, seed=5).iq


@pytest.mark.parametrize("blk_s", [0.08, 0.3])
def test_runtime_scan_retunes_to_best_with_a_calibrated_floor(emission, blk_s):
    """The live scan on a retunable source: input order kept, one floor per
    scan, the emission's dwell clears it by the detection margin and the
    noise dwells do not, and the source is left tuned to the winner.  The
    JAX runtime on a source of the same kind agrees on the emission's
    prominence (0.05 dB) and refresh."""
    src = _RetunableSource(emission, int(FS_BASE * blk_s))
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu", config_overrides=OVER)
    rt.start()
    try:
        res = rt.scan([1e6, F_EMIT, 5e6], dwell_seconds=blk_s)
    finally:
        rt.stop()
    assert [f for f, _, _, _ in res] == [1e6, F_EMIT, 5e6]
    assert src.carrier_freq == F_EMIT
    by_f = {f: (p, fl, fv) for f, p, fl, fv in res}
    p_emit, floor, fv = by_f[F_EMIT]
    assert p_emit >= floor + 5.0 and abs(fv - MODE.refresh) < 0.2
    for f in (1e6, 5e6):
        assert by_f[f][1] == floor and by_f[f][0] < floor + 5.0, res
    jsrc = _RetunableSource(emission, int(FS_BASE * blk_s))
    jrt = JaxRuntime(jsrc, JMODE, alpha=0.5)
    jrt.start()
    try:
        res_j = jrt.scan([F_EMIT], dwell_seconds=blk_s, retune_to_best=False)
    finally:
        jrt.stop()
    # Both score whole blocks of the same looping emission and keep the
    # best, but not the same blocks: agreement to a dB, and on the refresh.
    assert abs(res_j[0][1] - p_emit) < 1.5 and abs(res_j[0][3] - fv) < 0.05
    assert abs(res_j[0][2] - floor) < 3.0       # another draw of the same null


def test_scan_floor_tracks_the_dwell_geometry(emission):
    floors = []
    for blk_s in (0.08, 0.3):
        src = _RetunableSource(emission, int(FS_BASE * blk_s))
        rt = StreamingRuntime(src, MODE, device="cpu", config_overrides=OVER)
        rt.start()
        try:
            floors.append(rt.scan([1e6], dwell_seconds=blk_s, retune_to_best=False)[0][2])
        finally:
            rt.stop()
    assert floors[0] > floors[1] + 1.0, floors


def test_scan_refuses_what_it_cannot_score(emission):
    rt = _port(block=int(FS * 0.05))
    with pytest.raises(RuntimeError, match="retun"):
        rt.scan([1e6])
    short = StreamingRuntime(_RetunableSource(emission, int(FS_BASE * 0.05)), MODE,
                             device="cpu", config_overrides=OVER)
    with pytest.raises(ValueError, match="block too short"):
        short.scan([1e6])
    for call in (lambda: rt.set_carrier(1e6), lambda: rt.set_gain(3.0),
                 lambda: rt.set_sample_rate(4e6)):
        with pytest.raises(AttributeError, match="does not support"):
            call()


# ------------------------------------------------------------------- record
def test_record_rotates_files_and_writes_what_the_ring_delivered(stream, tmp_path, monkeypatch):
    blocks, _ = stream
    monkeypatch.chdir(tmp_path)
    rt = _port()
    for b in blocks:
        rt.ring.put(b)
    assert rt.record(None, n_blocks=1) == BLOCK and rt.last_record_path == "dumpIQ_0.dat"
    (tmp_path / "dumpIQ_1.dat").write_bytes(b"taken")
    assert rt.record(None, n_blocks=2) == 2 * BLOCK and rt.last_record_path == "dumpIQ_2.dat"
    np.testing.assert_array_equal(read_complex_binary("dumpIQ_0.dat"), blocks[0])
    np.testing.assert_array_equal(read_complex_binary("dumpIQ_2.dat"), blocks[1:3].ravel())
    assert rt.abs_pos == 3 * BLOCK             # the frame grid moved with the takes
    rt.ring.close()
    named = str(tmp_path / "tail.dat")
    assert rt.record(named, n_blocks=5) == BLOCK   # the ring ends: what was there
    np.testing.assert_array_equal(read_complex_binary(named), blocks[3])


# ----------------------------------------------------------- drift feedback
def test_refine_refresh_from_drift_equals_jax_on_a_shared_history():
    rng = np.random.default_rng(2)
    n = 48
    hist = np.stack([(5.0 + 0.031 * np.arange(n) + 0.01 * rng.standard_normal(n)) % 600,
                     (790.0 + 1.7 * np.arange(n) + 0.05 * rng.standard_normal(n)) % 800], axis=1)
    for mode_j, mode_p in ((JMODE, MODE),
                           (tt.VideoMode(JMODE.width, JMODE.height, 60.02),
                            VideoMode(MODE.width, MODE.height, 60.02))):
        jrt = JaxRuntime(SyntheticSource(mode_j, FS, BLOCK), mode_j)
        prt = StreamingRuntime(SyntheticSource(mode_p, FS, BLOCK), mode_p, device="cpu")
        fv_j, fv_p = jrt.refine_refresh_from_drift(hist), prt.refine_refresh_from_drift(hist)
        assert fv_p == fv_j and prt.mode.refresh == fv_p
    assert StreamingRuntime._median_circular_step(np.array([598.0, 599.5, 1.0, 2.5]), 600) == 1.5
    assert StreamingRuntime._median_circular_step(np.array([3.0]), 600) == 0.0


def test_refresh_drift_feedback_locks():
    """Start with a deliberately wrong refresh; the sync-drift feedback must
    recover the true rate."""
    fs = 2e6
    block = int(fs * 0.2)
    src = SyntheticSource(MODE, fs, block, snr_db=25.0, seed=12)      # true 60 Hz
    blocks = np.empty((3, block), np.complex64)
    for b in blocks:
        src.read(b)
    wrong = VideoMode(MODE.width, MODE.height, 60.02)                 # 20 mHz off
    rt = StreamingRuntime(SyntheticSource(MODE, fs, block), wrong, alpha=0.5, device="cpu")
    syncs = []
    for b in blocks:
        rt.ring.put(b)
    rt.process_blocks(3, sink=lambda img, info: syncs.append(info["sync"]))
    fv = rt.refine_refresh_from_drift(np.concatenate(syncs))
    assert abs(fv - 60.0) < abs(60.02 - 60.0) / 4, f"refined fv {fv}"


# ---------------------------------------------------------------- overrides
def test_operator_overrides_follow_the_jax_runtime(stream):
    blocks, _ = stream
    jrt, prt = _jax(alpha=0.5), _port(alpha=0.5)
    for rt in (jrt, prt):
        rt.set_refresh(59.94)
    assert prt.mode == MODE.__class__(MODE.width, MODE.height, 59.94)
    for rt in (jrt, prt):
        rt.set_line_count(520)
        assert rt.nudge_lines(3) == 523 and rt.nudge_lines(-1) == 522
    assert prt.snap_to_mode() == jrt.snap_to_mode() == "640x480 @ 60Hz"
    assert (prt.mode.width, prt.mode.height, prt.mode.refresh) == \
        (jrt.mode.width, jrt.mode.height, jrt.mode.refresh) == (800, 525, 59.94)
    assert prt.config.n_frames == jrt.config.n_frames
    with pytest.raises(RuntimeError, match="no correlation evidence"):
        prt.pick_line_peak(0)
    assert "0 frames reconstructed" in prt.summary()
    h = prt.health()
    # The port adds its tracer's summary, None while the tracer is off.
    assert set(h) == set(jrt.health()) | {"trace"}
    assert h["producer_alive"] is False and h["combine"] is None and h["frames_out"] == 0
    assert h["trace"] is None


def test_correlate_keeps_evidence_a_sparkline_and_ranked_peaks(stream):
    """``correlate(keep_evidence=True)``: the sparkline string of the JAX
    runtime's form, passed to the sink, and ``pick_line_peak`` on it."""
    blocks, _ = stream
    fs = 2e6
    block = int(fs * 0.1)
    src = SyntheticSource(MODE, fs, block, snr_db=25.0, seed=3)
    sig = np.empty((4, block), np.complex64)
    for b in sig:
        src.read(b)
    jrt = JaxRuntime(SyntheticSource(JMODE, fs, block), JMODE,
                     config_overrides={**OVER, "resampler": "pallas"})
    prt = _port(block=block, fs=fs)
    for rt in (jrt, prt):
        for b in sig[:3]:
            rt.ring.put(b)
        timing = rt.correlate(seconds=0.15, keep_evidence=True)
        assert timing.mode_name == "640x480 @ 60Hz"
    assert prt.corr_spark.startswith("corr[50-90Hz] ") and "|" in prt.corr_spark
    assert prt.corr_spark.endswith(f"peak {prt.last_evidence.refresh_hz:.2f} Hz")
    # Same cells up to a glyph step where the two correlations differ in rounding.
    a, b = prt.corr_spark.split()[1], jrt.corr_spark.split()[1]
    assert len(a) == len(b) and a.index("|") == b.index("|")
    assert sum(x != y for x, y in zip(a, b)) <= 3
    infos = []
    prt.ring.put(sig[3])
    prt.process_blocks(1, sink=lambda img, info: infos.append(info))
    assert infos[0]["spark"] == prt.corr_spark
    name = prt.pick_line_peak(0)
    assert name == "640x480 @ 60Hz" and prt.mode.height == 525
    with pytest.raises(IndexError):
        prt.pick_line_peak(99)


# ------------------------------------------------------------------ console
def test_console_drives_every_command(stream, emission, tmp_path, monkeypatch):
    blocks, _ = stream
    monkeypatch.chdir(tmp_path)
    rt = _port(alpha=0.5, combine_bw=BW)
    out = io.StringIO()
    frames = []
    con = OperatorConsole(rt, sink=lambda img, info: frames.append(img), out=out, crosshair=True)
    for b in blocks[:3]:
        rt.ring.put(b)
    for line in ("help", "status", "health", "peaks", "correlate 0.2", "peaks", "pick 0",
                 "fv 59.95", "lines 524", "+", "- 2", "+ 2", "snap", "alpha 0.3",
                 "fidelity on", "drift", "fidelity off", "crosshair off", "crosshair",
                 f"combine {CARRIERS[0]},{CARRIERS[1]}", "combine status", "combine fm",
                 "combine am", "combine excise 0", "combine excise off", "combine off",
                 "combine", "gain 3", "carrier 1e6", "rate 1e6", "scan", "bogus", "pause", "start",
                 "", "record 1"):
        con.dispatch(line)
    text = out.getvalue()
    for expect in (HELP.splitlines()[0], "mode 800x525", "producer_alive", "no evidence",
                   "correlate: 640x480 @ 60Hz", "corr[50-90Hz]", "#0: lag", "picked peak 0",
                   "fv = 59.9500 Hz", "lines = 524", "lines = 525", "lines = 523",
                   "snapped to 640x480 @ 60Hz", "alpha = 0.3", "fidelity = True",
                   "fidelity mode skips the sync stage", "fidelity = False", "crosshair = False",
                   "crosshair = True", "combining -2.40 MHz, +1.80 MHz", "'demod': 'am'",
                   "combine demod = fm", "combine excise = 0 dB", "combine excise = off",
                   "combine off", "combine: off", "does not support gain control",
                   "does not support carrier retuning", "does not support rate changes",
                   "usage: scan", "unknown command: bogus", "paused", "resumed",
                   "recorded"):
        assert expect in text, expect
    assert rt.alpha == 0.3 and rt.mode.refresh == 59.95 and not rt.fidelity
    assert rt.config.input_format == "iq_interleaved"
    # A scripted session: one command per block cycle, frames to the sink
    # with the crosshair drawn, drift feedback on the collected syncs.
    rt = _port(alpha=0.5)
    for b in blocks:
        rt.ring.put(b)
    out = io.StringIO()
    con = OperatorConsole(rt, sink=lambda img, info: frames.append(img.copy()), out=out,
                          commands=["status", "crosshair on", "drift", "quit"])
    img = con.run()
    assert con.blocks_done == 3 and img.shape == SHAPE and len(frames) == 3
    assert "drift lock: fv ->" in out.getvalue()
    # The scan and combine-auto commands on a tunable source.
    src = _RetunableSource(emission, int(FS_BASE * 0.1))
    rt = StreamingRuntime(src, MODE, alpha=0.5, device="cpu", config_overrides=OVER)
    out = io.StringIO()
    con = OperatorConsole(rt, commands=[f"scan 1e6 {F_EMIT} 5e6", "gain 7", "carrier 3.1e6",
                                        "quit"], out=out)
    rt.start()
    try:
        con.run()
    finally:
        rt.stop()
    text = out.getvalue()
    assert "screen-ness" in text and "EMISSION" in text and "tuned to best" in text
    assert src.gain == 7.0 and src.carrier_freq == 3.1e6


def test_console_combine_auto(stream):
    blocks, _ = stream
    rt = _port(alpha=0.5, combine_bw=BW)
    for b in blocks[:3]:
        rt.ring.put(b)
    out = io.StringIO()
    con = OperatorConsole(rt, None, out=out)
    con.dispatch("combine auto 0.3")
    assert "combining -2.00 MHz, +2.00 MHz" in out.getvalue()
    assert rt.config.input_format == "envelope"
    con.dispatch("carrier 1e6")        # no tuner: an error line, the stream goes on
    rt.process_blocks(1)
    assert rt.combine_weights is not None and "error" in out.getvalue()


# -------------------------------------------------------------- native ring
def test_native_ring_delivers_the_python_rings_ema(stream):
    if not native_available():
        pytest.skip("no g++: the native ring cannot be built")
    blocks, _ = stream
    emas = {}
    for impl in ("python", "native"):
        rt = _port(alpha=0.5, combine=CARRIERS, combine_bw=BW, ring_impl=impl)
        emas[impl] = _feed(rt, blocks[:2])
        assert rt.abs_pos == 2 * BLOCK and rt.ring.last_seq == 1
        assert ("NativeRing" in rt.summary()) == (impl == "native")
        h = rt.health()
        assert h["ring_overflows"] == 0 and h["frames_out"] == rt.frames_out
    np.testing.assert_array_equal(emas["native"], emas["python"])
    from tempest_tpu_torch import native

    assert native._LIB.endswith("tempest_tpu_torch/_build/libhost_core.so")
