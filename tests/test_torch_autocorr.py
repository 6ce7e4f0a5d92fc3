"""Parity of the port's autocorrelation and timing estimators
(``tempest_tpu_torch.ops.autocorr``) with the JAX package's, on the CPU.

Inputs are envelopes of small synthetic captures (640x480 @ 60 Hz at 4 Msps,
0.15 s) made from a seed with numpy.  Tolerances: the two FFT libraries
differ in the last bits, so ``gamma`` (dB of squared correlation) is held to
1e-3 dB where the correlation is not vanishing; the estimators pick their
answer on a 1/8-sample lag grid, so refresh and line count either agree to
float32 rounding or differ by one grid step — they are held to 1e-3 Hz and
0.01 lines, the acceptance bounds of the slice."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempest_tpu.ops.autocorr as jac
from tempest_tpu_torch.io.synthetic import generate_iq
from tempest_tpu_torch.ops import autocorr as pac
from tempest_tpu_torch.video.modes import ALL_VIDEO_MODES

FS = 4e6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def power():
    """|z|² of a 0.15 s capture of 640x480 @ 60 Hz at 4 Msps, 18 dB SNR."""
    cap = generate_iq(ALL_VIDEO_MODES["640x480 @ 60Hz"], FS, int(FS * 0.15), snr_db=18.0, seed=21)
    return (cap.iq.real ** 2 + cap.iq.imag ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def gammas(power):
    """(JAX gamma, port gamma) of the same envelope over 0.1 s of lags."""
    ref, _ = jac.autocorrelation(jnp.asarray(power), FS, 0.0, 0.1)
    got, _ = pac.autocorrelation(torch.from_numpy(power), FS, 0.0, 0.1)
    return np.asarray(ref), got


@pytest.mark.parametrize("scale", ["log", "linear"])
@pytest.mark.parametrize("span", [(0.0, 0.1), (0.001, 0.02), (0.0, 0.01)],
                         ids=["full", "offset_window", "short"])
def test_autocorrelation_matches_jax(power, scale, span):
    """Same FFT length (the JAX package's power of two), same lag window.
    Linear power within 2e-5 of the zero-lag-scale peak in the window; log
    within 1e-3 dB wherever the correlation is above 1e-6 of its peak."""
    ref, ref_lags = jac.autocorrelation(jnp.asarray(power), FS, *span, scale=scale)
    got, lags = pac.autocorrelation(torch.from_numpy(power), FS, *span, scale=scale)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(lags.numpy(), np.asarray(ref_lags), rtol=1e-6)
    if scale == "linear":
        assert np.abs(got - ref).max() < 2e-5 * np.abs(ref).max()
    else:
        strong = ref > ref.max() - 60.0
        assert strong.sum() > 0.5 * ref.size
        assert np.abs(got - ref)[strong].max() < 1e-3


def test_autocorrelation_short_signal_and_complex_input():
    """A signal shorter than twice the lag bound takes the largest power of
    two it can supply and returns no mirrored lags; complex input goes
    through the complex FFT pair."""
    rng = np.random.default_rng(3)
    x = rng.random(3000, dtype=np.float32)
    ref, _ = jac.autocorrelation(jnp.asarray(x), 1e4, 0.0, 0.5)
    got, lags = pac.autocorrelation(torch.from_numpy(x), 1e4, 0.0, 0.5)
    assert got.shape == np.asarray(ref).shape == (1024,) and lags.shape == (1024,)
    z = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    ref, _ = jac.autocorrelation(jnp.asarray(z), 1e4, 0.0, 0.1, scale="linear")
    got, _ = pac.autocorrelation(torch.from_numpy(z), 1e4, 0.0, 0.1, scale="linear")
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 2e-5 * np.asarray(ref).max()


def test_zoom_autocorr_matches_jax(gammas):
    ref_gamma, gamma = gammas
    ref_rates, ref_slice = jac.zoom_autocorr(jnp.asarray(ref_gamma), FS, 50.0, 90.0)
    rates, window = pac.zoom_autocorr(gamma, FS, 50.0, 90.0)
    np.testing.assert_allclose(rates.numpy(), np.asarray(ref_rates), rtol=1e-6)
    assert window.shape == np.asarray(ref_slice).shape
    assert rates[0] > rates[-1]


@pytest.mark.parametrize("idx", [0, 1, 57, 198, 199])
def test_parabolic_peak_matches_jax(idx):
    """Interior peaks refine to the parabola's vertex, edge indices come
    back unchanged; 1e-6 absolute (the same float32 formula)."""
    y = np.cos((np.arange(200) - 57.3) / 9.0).astype(np.float32)
    ref = float(jac.parabolic_peak(jnp.asarray(y), jnp.asarray(idx)))
    got = float(pac.parabolic_peak(torch.from_numpy(y), torch.tensor(idx)))
    assert abs(got - ref) < 1e-6 * max(abs(ref), 1.0)
    flat = np.ones(16, np.float32)
    assert float(pac.parabolic_peak(torch.from_numpy(flat), torch.tensor(5))) == 5.0


def test_lerp_clamps_its_upper_read_and_median_averages():
    """Where the port departs from a literal translation.  ``_lerp`` at the
    last position: the float32 position clip is a no-op for a long array, the
    JAX gather clamps silently, and the port clamps the index itself.
    ``_median`` averages the two middle values, as ``jnp.median`` does."""
    n = 5_000_000
    values = torch.arange(n, dtype=torch.float32)
    pos = torch.tensor([0.0, 1.5, float(n - 1), float(n + 5)])
    got = pac._lerp(values, pos).numpy()
    ref = np.asarray(jac._lerp(jnp.arange(n, dtype=jnp.float32), jnp.asarray(pos.numpy())))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert got[-1] == n - 1
    x = np.random.default_rng(0).random(10).astype(np.float32)
    assert float(pac._median(torch.from_numpy(x))) == pytest.approx(float(jnp.median(jnp.asarray(x))))
    assert float(pac._median(torch.from_numpy(x[:9]))) == float(np.median(x[:9]))


def test_widen_peaks_and_refine_period_match_jax(gammas):
    ref_gamma, gamma = gammas
    lin = 10.0 ** (ref_gamma / 10.0)
    wide = pac._widen_peaks(torch.from_numpy(lin)).numpy()
    np.testing.assert_allclose(wide, np.asarray(jac._widen_peaks(jnp.asarray(lin))), rtol=1e-6)
    assert wide[-1] == pytest.approx(2 * lin[-1] + lin[-2], rel=1e-6)  # no wrap-around
    lag0 = int(round(FS / 60.0)) + 2
    ref = float(jac.refine_period(jnp.asarray(lin), jnp.asarray(lag0), 8))
    got = float(pac.refine_period(torch.from_numpy(lin), torch.tensor(lag0), 8))
    assert abs(got - ref) <= 0.125 + 1e-6   # one step of the candidate grid at most
    assert abs(got - FS / 60.0) < 0.5


@pytest.mark.parametrize("band", [(50.0, 90.0), (20.0, 130.0)], ids=["default", "wide"])
def test_estimate_refresh_matches_jax(gammas, band):
    """Both find 60 Hz, in the default band and in a wide one where the
    octave descent must reject 30 Hz; within 1e-3 Hz of each other."""
    ref_gamma, gamma = gammas
    ref = float(jac.estimate_refresh(jnp.asarray(ref_gamma), FS, *band))
    got = float(pac.estimate_refresh(gamma, FS, *band))
    assert abs(got - ref) < 1e-3
    assert abs(got - 60.0) < 0.01


def test_estimate_line_count_matches_jax(gammas):
    ref_gamma, gamma = gammas
    fv = 60.0
    ref = float(jac.estimate_line_count(jnp.asarray(ref_gamma), FS, fv))
    got = float(pac.estimate_line_count(gamma, FS, torch.tensor(fv)))
    assert abs(got - ref) < 0.01
    assert abs(got - 525.0) < 1.0
    lin_ref = float(jac.estimate_line_count(jnp.asarray(10.0 ** (ref_gamma / 10.0)), FS, fv,
                                            scale="linear"))
    lin_got = float(pac.estimate_line_count(10.0 ** (gamma / 10.0), FS, fv, scale="linear"))
    assert abs(lin_got - lin_ref) < 0.01


def test_top_line_period_peaks_matches_jax(gammas):
    """Host numpy in float64 in both packages: on the same gamma the ranked
    candidates are equal; on each package's own gamma the best one agrees."""
    ref_gamma, gamma = gammas
    ref = jac.top_line_period_peaks(ref_gamma, FS, 60.0)
    same = pac.top_line_period_peaks(ref_gamma, FS, 60.0)
    np.testing.assert_array_equal(same, ref)
    own = pac.top_line_period_peaks(gamma.numpy(), FS, 60.0)
    assert own.shape[1] == 3 and 1 <= len(own) <= 5
    assert abs(own[0, 1] - ref[0, 1]) < 0.01
    assert abs(own[0, 1] - 525.0) < 1.0


@pytest.mark.parametrize("snr_db", [5.0, 18.0, 30.0])
def test_estimate_snr_and_suggest_alpha_match_jax(snr_db):
    """The SNR proxy is two means of products: 1e-3 dB between the
    libraries' float32 reductions.  ``suggest_alpha`` is a clipped ramp."""
    cap = generate_iq(ALL_VIDEO_MODES["640x480 @ 60Hz"], FS, 100_000, snr_db=snr_db, seed=4)
    env = np.abs(cap.iq).astype(np.float32)
    ref = float(jac.estimate_snr(jnp.asarray(env)))
    got = float(pac.estimate_snr(torch.from_numpy(env)))
    assert abs(got - ref) < 1e-3
    for value in (got, -20.0, 2.0, 10.0):
        assert float(pac.suggest_alpha(value)) == pytest.approx(
            float(jac.suggest_alpha(value)), abs=1e-6)
    assert 0.1 <= float(pac.suggest_alpha(got)) <= 0.9
