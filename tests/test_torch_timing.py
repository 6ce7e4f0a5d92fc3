"""Parity of the port's stage 1 (``estimate_timing``, ``timing_evidence``,
``pick_line_peak``) with the JAX package's, on the CPU.

Captures are small: 640x480 @ 60 Hz and 800x600 @ 60 Hz at 4 Msps, 0.15 s,
from ``generate_iq`` with a seed.  Both packages must name the same mode;
refresh within 1e-3 Hz and line count within 0.01 (the estimators choose on
a 1/8-sample lag grid, so they agree to float32 rounding or differ by one
grid step); the SNR proxy within 1e-3 dB; the evidence windows within 1e-3
dB where the correlation is not vanishing (two FFT libraries)."""

import numpy as np
import pytest
import torch

import tempest_tpu.pipeline.offline as joff
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops.demod import fm_demod
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

FS = 4e6
SECONDS = 0.15
REFRESH_TOL = 1e-3
LINES_TOL = 0.01


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _capture(name, seed=11, **kw):
    return generate_iq(ALL_VIDEO_MODES[name], FS, int(FS * SECONDS), snr_db=18.0, seed=seed, **kw)


def _same_timing(got, ref):
    assert got.mode_name == ref.mode_name
    assert (got.mode.width, got.mode.height) == (ref.mode.width, ref.mode.height)
    assert abs(got.refresh_hz - ref.refresh_hz) < REFRESH_TOL
    assert got.mode.refresh == got.refresh_hz
    assert abs(got.line_count - ref.line_count) < LINES_TOL
    assert abs(got.snr_db - ref.snr_db) < 1e-3
    assert got.suggested_alpha == pytest.approx(ref.suggested_alpha, abs=1e-4)


@pytest.mark.parametrize("name", ["640x480 @ 60Hz", "800x600 @ 60Hz"])
@pytest.mark.parametrize("form", ["complex", "float32_words", "int16_words", "complex_tensor"])
def test_estimate_timing_matches_jax(name, form):
    """Every input form the entry takes: host complex (viewed as words),
    interleaved float32 and int16 words, and a complex tensor."""
    cap = _capture(name)
    words = cap.iq.view(np.float32)
    data = {"complex": cap.iq, "float32_words": words, "complex_tensor": cap.iq,
            "int16_words": np.round(words * 64.0).astype(np.int16)}[form]
    ref = joff.estimate_timing(data, FS)
    if form == "complex_tensor":
        data = torch.from_numpy(data)
    got = poff.estimate_timing(data, FS, device="cpu")
    _same_timing(got, ref)
    assert got.mode_name == name


def test_full_scale_int16_words_stay_in_float32_range():
    """Raw int16 words at an SDR's scale (|word| up to 2¹⁴ here): the JAX
    package squares a correlation of ~1e21 and its ``gamma`` overflows
    float32, so its estimate is meaningless; the port takes the log of the
    magnitude and exponentiates relative to the peak, and finds what it
    finds on the float capture."""
    import jax.numpy as jnp
    from tempest_tpu.ops.autocorr import autocorrelation as jax_autocorrelation
    from tempest_tpu.ops.demod import am_power_from_iq as jax_power

    cap = _capture("640x480 @ 60Hz")
    words = np.round(cap.iq.view(np.float32) * 8192.0).astype(np.int16)
    ref_gamma, _ = jax_autocorrelation(jax_power(jnp.asarray(words)), FS, 0.0, 0.1)
    assert not np.isfinite(np.asarray(ref_gamma)).all()
    got = poff.estimate_timing(words, FS, device="cpu")
    floats = poff.estimate_timing(cap.iq, FS, device="cpu")
    assert got.mode_name == floats.mode_name == "640x480 @ 60Hz"
    assert abs(got.refresh_hz - floats.refresh_hz) < REFRESH_TOL
    assert abs(got.line_count - floats.line_count) < LINES_TOL


def test_estimate_timing_on_an_envelope_matches_jax():
    """``envelope=True``: an already-demodulated real signal, here the FM
    discriminator output of an FM capture, whose AM envelope is flat."""
    cap = _capture("640x480 @ 60Hz", modulation="fm")
    disc = fm_demod(torch.from_numpy(cap.iq)).numpy()
    ref = joff.estimate_timing(disc, FS, envelope=True)
    got = poff.estimate_timing(disc, FS, envelope=True, device="cpu")
    _same_timing(got, ref)
    assert got.mode_name == "640x480 @ 60Hz"


def test_estimate_timing_wide_band_matches_jax():
    cap = _capture("640x480 @ 60Hz", seed=12)
    ref = joff.estimate_timing(cap.iq, FS, rate_min=20.0, rate_max=130.0)
    got = poff.estimate_timing(cap.iq, FS, rate_min=20.0, rate_max=130.0, device="cpu")
    _same_timing(got, ref)


@pytest.fixture(scope="module")
def evidences():
    cap = _capture("640x480 @ 60Hz", seed=13)
    return joff.timing_evidence(cap.iq, FS), poff.timing_evidence(cap.iq, FS, device="cpu")


def test_timing_evidence_matches_jax(evidences):
    (ref_t, ref), (got_t, got) = evidences
    _same_timing(got_t, ref_t)
    assert got.refresh_hz == got_t.refresh_hz and got.line_count == got_t.line_count
    np.testing.assert_allclose(got.rates_hz, ref.rates_hz, rtol=1e-6)
    np.testing.assert_array_equal(got.line_lags, ref.line_lags)
    for mine, theirs in ((got.gamma_rates, ref.gamma_rates), (got.gamma_lines, ref.gamma_lines)):
        assert mine.shape == theirs.shape
        strong = theirs > theirs.max() - 60.0
        assert np.abs(mine - theirs)[strong].max() < 1e-3
    assert abs(got.line_lag - ref.line_lag) < 1e-3
    assert got.rate_mark() == pytest.approx(ref.rate_mark(), abs=1e-3)
    assert got.line_mark() == pytest.approx(ref.line_mark(), abs=1e-3)
    assert got.line_peaks.shape == ref.line_peaks.shape
    np.testing.assert_allclose(got.line_peaks[:, :2], ref.line_peaks[:, :2], atol=0.01)


def test_pick_line_peak_matches_jax(evidences):
    (ref_t, ref), (got_t, got) = evidences
    for n in range(len(got.line_peaks)):
        mine = poff.pick_line_peak(got_t, got, n)
        theirs = joff.pick_line_peak(ref_t, ref, n)
        assert mine.mode_name == theirs.mode_name
        assert abs(mine.line_count - theirs.line_count) < LINES_TOL
        assert mine.refresh_hz == got_t.refresh_hz
    assert poff.pick_line_peak(got_t, got, 0).mode_name == "640x480 @ 60Hz"
    with pytest.raises(IndexError):
        poff.pick_line_peak(got_t, got, len(got.line_peaks))
    empty = poff.TimingEvidence(got.rates_hz, got.gamma_rates, got.refresh_hz, got.line_lags,
                                got.gamma_lines, got.line_lag, got.line_count, None)
    with pytest.raises(ValueError):
        poff.pick_line_peak(got_t, empty, 0)


def test_stage1_without_device_asks_for_the_card(monkeypatch):
    """A numpy capture with no device named goes to the card, and raises
    where there is none; a tensor is estimated where it lies."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cap = _capture("640x480 @ 60Hz")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        poff.estimate_timing(cap.iq, FS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        poff.timing_evidence(cap.iq, FS)
    assert poff.estimate_timing(torch.from_numpy(cap.iq), FS).mode_name == "640x480 @ 60Hz"
