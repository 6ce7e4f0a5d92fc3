"""``tempest_tpu_torch.ops.scan`` against ``tempest_tpu.ops.scan`` on the same
numpy inputs (JAX on the CPU, as ``tests/test_scan.py`` runs it).

Tolerances.  Channels, envelopes and autocorrelations come out of float32
FFTs whose summation order differs between PyTorch's CPU FFT and XLA's, so
complex channels are held to 1e-5 of the peak, and dB statistics (comb mass,
prominence, floor: logs of sums over those FFT outputs, about 100 dB large)
to 0.05 dB; observed differences are a few 1e-3 dB.  The refresh estimate is
a point of a 1/8-sample lag grid: the two packages pick the same grid point,
and ``fs / lag`` then differs by float32 rounding only (1e-4 Hz).  Host-side
code (``ScanResult``, geometry, centres) and which spectrum bins excision
nulls are compared exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tempest_tpu as tt
from tempest_tpu.ops import scan as jscan
from tempest_tpu.ops.autocorr import autocorrelation as jax_autocorrelation
from tempest_tpu_torch.ops import scan as pscan

MODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 8e6
BW = 2e6
CARRIERS = [-2.4e6, 1.8e6]
DB_TOL = 0.05
HZ_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes on one host: keep torch's
    CPU thread pool small so these tests do not starve the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture():
    """Two harmonics of one 640x480 screen in an 8 Msps capture of 0.3 s,
    the weaker one with inverted modulation."""
    return tt.generate_iq_harmonics(MODE, FS, int(FS * 0.3), CARRIERS,
                                    amplitudes=[1.0, 0.7], depths=[0.8, -0.8],
                                    snr_db=6.0, seed=4).iq


@pytest.fixture(scope="module")
def centers():
    return jscan.scan_centers(FS, BW / 2, BW / 2)


# ---------------------------------------------------------------- host code
@pytest.mark.parametrize("n,fs,bw", [
    (2_400_000, 8e6, 2e6), (17_600_000, 32e6, 4e6), (12_333_335, 20e6, 4e6),
    (1 << 18, 16e6, 4e6), (1000, 1e6, 2e6), (5, 1e6, 1.0),
])
def test_channel_geometry_matches_jax(n, fs, bw):
    assert pscan._channel_geometry(n, fs, bw) == jscan._channel_geometry(n, fs, bw)
    assert pscan._fft_pow2_len(n) == jscan._fft_pow2_len(n)


def test_channel_geometry_of_the_full_size_configurations():
    assert pscan._channel_geometry(17_600_000, 32e6, 4e6) == (1 << 24, 1 << 21, 4e6)
    assert pscan._channel_geometry(12_333_335, 20e6, 4e6) == (1 << 23, 1 << 21, 5e6)


@pytest.mark.parametrize("fs,step,guard", [(32e6, 2e6, 2e6), (16e6, 1e6, 2e6), (8e6, 3e6, 0.0)])
def test_scan_centers_match_jax(fs, step, guard):
    np.testing.assert_array_equal(pscan.scan_centers(fs, step, guard),
                                  jscan.scan_centers(fs, step, guard))


def _results(cls):
    """One ScanResult of each package with the same numbers: two emissions
    of two and one channels and a noise channel between them."""
    kw = dict(
        centers_hz=np.array([3e6, -3e6, -2e6, 0.0, 1e6, 2e6]),
        scores_db=np.array([80.0, 95.0, 99.0, 40.0, 41.0, 85.0]),
        prominence_db=np.array([16.0, 17.0, 19.0, 8.0, 7.0, 15.5]),
        refresh_hz=np.array([60.0, 60.001, 60.002, 71.0, 55.0, 60.003]),
        fs_channel=2e6,
    )
    return cls(floor_db=np.full(6, 7.5), **kw), cls(**kw)


def test_scan_result_host_methods_equal_jax():
    for r_j, r_p in zip(_results(jscan.ScanResult), _results(pscan.ScanResult)):
        np.testing.assert_array_equal(r_p.ranking(), r_j.ranking())
        assert r_p.best() == r_j.best()
        for kw in ({}, {"min_margin_db": 9.0}, {"min_prominence_db": 16.5}):
            e_j, e_p = r_j.emissions(**kw), r_p.emissions(**kw)
            assert len(e_j) == len(e_p)
            for a, b in zip(e_j, e_p):
                np.testing.assert_equal(b, a)    # treats NaN floors as equal
    with_floor = _results(pscan.ScanResult)[0]
    assert [e["n_channels"] for e in with_floor.emissions()] == [2, 2]


def test_excise_with_fm_is_refused():
    with pytest.raises(ValueError, match="excise_db with demod='fm'"):
        pscan.check_excise_demod("fm", 0.0)
    pscan.check_excise_demod("am", 0.0)
    pscan.check_excise_demod("fm", None)
    with pytest.raises(ValueError, match="excise_db with demod='fm'"):
        pscan.scan_band(np.zeros(64, np.complex64), 1e6, [0.0], demod="fm", excise_db=0.0,
                        device="cpu")


# -------------------------------------------------------------- channeliser
def test_channelize_tone_mapping():
    """A pure tone lands at the right baseband offset with full power in the
    covering channel and is rejected by a non-covering one; the rows are
    interleaved float32, as the JAX version returns them."""
    fs = 16e6
    n = 1 << 18
    f0 = 3.25e6
    x = np.exp(2j * np.pi * f0 * np.arange(n) / fs).astype(np.complex64)
    words, fs_chan = pscan.channelize(x, fs, np.array([3e6, -5e6]), 4e6, device="cpu")
    assert words.dtype == torch.float32 and words.shape == (2, 2 * (1 << 16))
    chans = np.ascontiguousarray(words.numpy()).view(np.complex64)
    assert fs_chan == 4e6
    spec = np.abs(np.fft.fft(chans[0])) ** 2 / chans.shape[1] ** 2
    b = int(np.argmax(spec))
    fb = b / chans.shape[1] * fs_chan
    if fb > fs_chan / 2:
        fb -= fs_chan
    assert abs(fb - (f0 - 3e6)) < fs_chan / chans.shape[1] * 2
    assert spec[b] > 0.98                       # amplitude preserved
    assert np.abs(chans[1]).max() < 1e-3        # the other channel holds no tone


def test_channelize_matches_jax_with_bands_that_wrap_both_edges(capture):
    """Centres at ±3.6 MHz of an 8 Msps capture put a 2 MHz band across the
    upper and the lower end of the spectrum: the circular slice continues at
    the other end.  Interleaved words and host complex input give the same
    rows."""
    cs = np.array([3.6e6, -3.6e6, -2.4e6, 0.0])
    w_j, fs_j = jscan.channelize(capture, FS, cs, BW)
    w_p, fs_p = pscan.channelize(capture, FS, cs, BW, device="cpu")
    w_j = np.asarray(w_j)
    assert fs_p == fs_j and w_p.shape == w_j.shape
    assert np.abs(w_p.numpy() - w_j).max() <= 1e-5 * np.abs(w_j).max()
    w_t, _ = pscan.channelize(torch.from_numpy(capture.view(np.float32)), FS, cs, BW)
    torch.testing.assert_close(w_t, w_p, rtol=0, atol=0)
    # The wrapped band really holds both ends of the spectrum: a tone just
    # inside each end lands in the +3.6 MHz channel.
    n = 1 << 16
    t = np.arange(n) / FS
    for f0 in (3.9e6, -3.9e6):
        x = np.exp(2j * np.pi * f0 * t).astype(np.complex64)
        w, _ = pscan.channelize(x, FS, np.array([3.6e6, 0.0]), BW, device="cpu")
        ch = np.ascontiguousarray(w.numpy()).view(np.complex64)
        # (the tone sits between bins: its leakage skirt reaches the other channel)
        assert np.mean(np.abs(ch[0]) ** 2) > 0.95 and np.mean(np.abs(ch[1]) ** 2) < 1e-3


def _spike_bands():
    rng = np.random.default_rng(0)
    m = 4096
    bands = (0.01 * (rng.normal(size=(3, m)) + 1j * rng.normal(size=(3, m)))).astype(np.complex64)
    bands[:, 0] = 10.0                       # carrier lines
    bands[0, 100] = 300.0                    # CW within dilate_bins of DC
    bands[1, 2000] = 40.0                    # CW mid-band
    bands[1, 4090] = 25.0                    # CW whose dilation wraps past the end
    bands[2, 1] = 50.0                       # a loud GUARD bin raises the reference
    bands[2, 700] = 30.0                     # ... so this spike is not a hit
    return bands


@pytest.mark.parametrize("margin_db", [0.0, 6.0])
def test_excise_spikes_nulls_the_same_bins(margin_db):
    bands = _spike_bands()
    out_j = np.asarray(jscan._excise_spikes(jnp.asarray(bands), margin_db))
    out_p = pscan._excise_spikes(torch.from_numpy(bands), margin_db).numpy()
    np.testing.assert_array_equal(out_p, out_j)
    assert (out_p == 0).sum() > 2 * 256


def test_excision_never_nulls_carrier_near_dc():
    """A CW interferer within ``dilate_bins`` of the carrier bin must not
    null the channel's own carrier line or its guard bins."""
    spec = _spike_bands()[0]
    out = pscan._excise_spikes(torch.from_numpy(spec)[None, :], 0.0).numpy()[0]
    assert out[100] == 0.0, "interferer must be nulled"
    assert out[0] == spec[0], "carrier line must survive the dilation"
    assert out[1] == spec[1] and out[-1] == spec[-1], "guard bins must survive"


# ------------------------------------------------------------------ scoring
def _close_scores(got, ref):
    for g, r, tol in zip(got, ref, (DB_TOL, DB_TOL, HZ_TOL)):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(r, np.float64),
                                   rtol=0, atol=tol)


def test_selection_prominence_on_a_shared_autocorrelation(capture):
    """One linear autocorrelation (JAX's, of two channels' power envelopes)
    through both selections: a row at a time and batched in the port."""
    chans, fs_chan = jscan._channelize_complex(jnp.asarray(capture.view(np.float32)), FS,
                                               np.array([-2.4e6, 0.0]), BW)
    env = jnp.abs(chans) ** 2
    env0 = env - jnp.mean(env, axis=1, keepdims=True)
    lin = jnp.stack([jax_autocorrelation(e, fs_chan, 0.0, 0.1, scale="linear")[0] for e in env0])
    ref = [jscan._selection_prominence(l, fs_chan, 50.0, 90.0, 5) for l in lin]
    lin_t = torch.from_numpy(np.array(lin))
    batched = pscan._selection_prominence(lin_t, fs_chan, 50.0, 90.0, 5)
    for k in range(2):
        one = pscan._selection_prominence(lin_t[k], fs_chan, 50.0, 90.0, 5)
        _close_scores([float(v) for v in one], [float(v) for v in ref[k]])
        _close_scores([float(v[k]) for v in batched], [float(v) for v in ref[k]])
    assert float(batched[1][0]) > float(batched[1][1]) + 5.0   # emission against empty


@pytest.mark.parametrize("demod", ["am", "fm"])
def test_noise_floor_on_the_jax_draws(demod):
    """The JAX floor's own surrogate normals, fed through ``draws=``."""
    n_env, fs_chan = 1 << 17, 2e6
    z = np.array(jax.random.normal(jax.random.PRNGKey(7), (4, 2, n_env), jnp.float32))
    ref = float(jscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0, demod=demod))
    got = float(pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0,
                                   draws=torch.from_numpy(z), demod=demod))
    assert abs(got - ref) < DB_TOL, (got, ref)


def test_noise_floor_of_the_ports_own_draws():
    """Another sample of the same null: a maximum over four noise draws, so
    the two floors agree loosely (the JAX package documents 6-12 dB for the
    statistic).  The port's floor is deterministic and tracks the window
    geometry as the JAX floor does."""
    n_env, fs_chan = 1 << 17, 2e6
    ref = float(jscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0))
    got = float(pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0, device="cpu"))
    assert abs(got - ref) < 3.0 and 4.0 < got < 14.0, (got, ref)
    pscan._measured_floor.cache_clear()  # measure it again, not the memo
    assert got == float(pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0, device="cpu"))
    short = float(pscan._noise_floor(fs_chan, 1 << 15, 0.008, 50.0, 90.0, device="cpu"))
    assert short > got + 1.0, (short, got)
    draws = pscan.noise_floor_draws(64)
    assert draws.shape == (4, 2, 64) and draws.device.type == "cpu"
    torch.testing.assert_close(draws, pscan.noise_floor_draws(64), rtol=0, atol=0)


def test_noise_floor_is_measured_once_per_geometry(monkeypatch):
    """A count of draws is drawn and scored on the first call of a geometry
    alone; later calls return that floor, which is the floor of the same
    draws scored afresh.  Another geometry or demodulation draws anew."""
    n_env, fs_chan = 1 << 15, 2e6
    original, drawn = pscan.noise_floor_draws, []

    def counted(n, draws=4):
        drawn.append(n)
        return original(n, draws)

    pscan._measured_floor.cache_clear()
    monkeypatch.setattr(pscan, "noise_floor_draws", counted)
    first = pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0, device="cpu")
    again = pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0, device=torch.device("cpu"))
    assert drawn == [n_env] and float(again) == float(first)
    fresh = pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0,
                               draws=original(n_env))
    assert float(fresh) == float(first)
    pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0, demod="fm", device="cpu")
    pscan._noise_floor(fs_chan, n_env // 2, 0.05, 50.0, 90.0, device="cpu")
    assert drawn == [n_env, n_env, n_env // 2]
    pscan._measured_floor.cache_clear()
    assert float(pscan._noise_floor(fs_chan, n_env, 0.05, 50.0, 90.0)) == float(first)
    assert drawn == [n_env, n_env, n_env // 2, n_env]


@pytest.mark.parametrize("form", ["words", "complex"])
def test_the_channel_part_is_all_the_scan_reads(capture, centers, form):
    """``_channel_part`` keeps the first N complex samples (N the capture's
    FFT length), and the band scan of that part is the scan of the whole."""
    iq = np.asarray(capture, np.complex64)[: 2_345_678]
    n_fft = pscan._fft_pow2_len(len(iq))
    whole = iq.view(np.float32) if form == "words" else iq
    part = pscan._channel_part(whole)
    assert part.shape[0] == (2 * n_fft if form == "words" else n_fft)
    assert np.shares_memory(part, whole)
    assert pscan._channel_part(torch.from_numpy(whole)).shape == part.shape
    a = pscan.scan_band(whole, FS, centers, chan_bw=BW, corr_seconds=0.05, device="cpu")
    b = pscan.scan_band(part, FS, centers, chan_bw=BW, corr_seconds=0.05, device="cpu")
    for field in ("scores_db", "prominence_db", "refresh_hz", "floor_db"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.fs_channel == b.fs_channel


def test_carrier_score_matches_jax(capture):
    base = tt.generate_iq(MODE, 2e6, int(2e6 * 0.25), snr_db=20.0, seed=5).iq
    rng = np.random.default_rng(3)
    noise = (rng.standard_normal(len(base)) + 1j * rng.standard_normal(len(base))
             ).astype(np.complex64)
    for sig in (base, noise):
        s_j, fv_j = jscan.carrier_score(sig, 2e6)
        s_p, fv_p = pscan.carrier_score(sig, 2e6, device="cpu")
        assert abs(s_p - s_j) < DB_TOL and abs(fv_p - fv_j) < HZ_TOL
    s_sig, fv = pscan.carrier_score(torch.from_numpy(base), 2e6)   # a complex tensor
    s_noise, _ = pscan.carrier_score(noise, 2e6, device="cpu")
    assert s_sig > s_noise + 8.0 and abs(fv - MODE.refresh) < 0.2


@pytest.mark.parametrize("kw", [dict(), dict(demod="fm"), dict(excise_db=0.0)],
                         ids=["am", "fm", "excise"])
def test_scan_band_matches_jax(capture, centers, kw):
    """Same ranking, same emissions (grouping judged on each package's own
    floor, as the detection tests of the JAX package do), dB values and
    refresh within tolerance."""
    r_j = jscan.scan_band(capture, FS, centers, chan_bw=BW, **kw)
    r_p = pscan.scan_band(capture, FS, centers, chan_bw=BW, device="cpu", **kw)
    assert r_p.fs_channel == r_j.fs_channel == 2e6
    np.testing.assert_array_equal(r_p.centers_hz, r_j.centers_hz)
    _close_scores((r_p.scores_db, r_p.prominence_db, r_p.refresh_hz),
                  (r_j.scores_db, r_j.prominence_db, r_j.refresh_hz))
    np.testing.assert_array_equal(r_p.ranking(), r_j.ranking())
    assert r_p.floor_db.shape == r_j.floor_db.shape
    assert abs(r_p.floor_db[0] - r_j.floor_db[0]) < 3.0
    e_j, e_p = r_j.emissions(), r_p.emissions()
    assert len(e_p) == len(e_j)
    for a, b in zip(e_j, e_p):
        assert b["span_hz"] == a["span_hz"] and b["n_channels"] == a["n_channels"]
        assert b["best_channel_hz"] == a["best_channel_hz"]
        assert abs(b["center_hz"] - a["center_hz"]) < 1e3
        assert abs(b["refresh_hz"] - a["refresh_hz"]) < HZ_TOL
    if not kw:
        # Two AM emissions, each within a channel step of its carrier, each
        # clearing the port's own floor by the detection margin.
        assert len(e_p) == 2
        for e in e_p:
            assert min(abs(e["best_channel_hz"] - c) for c in CARRIERS) <= BW / 2
            assert e["prominence_db"] - e["floor_db"] >= 5.0


def test_scan_band_takes_words_on_their_device_and_finds_nothing_in_noise(centers):
    rng = np.random.default_rng(42)
    n = int(FS * 0.1)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    res = pscan.scan_band(torch.from_numpy(noise.view(np.float32)), FS, centers, chan_bw=BW,
                          corr_seconds=0.05)
    assert res.emissions() == []
    assert (res.prominence_db - res.floor_db).max() < 4.0


def test_int16_scale_words_stay_in_float32_range(capture, centers):
    """The linear autocorrelation of a mean-removed power envelope goes with
    the fourth power of the words' scale: on int16-scale words it passes the
    float32 range and the JAX scan's scores are not finite.  The port scales
    each envelope by a power of two first: its prominence and refresh are
    those of the float-scale capture, its mass higher by the scale in dB."""
    scale = 2.0 ** 13
    big = (capture * scale).astype(np.complex64)
    assert np.abs(big.view(np.float32)).max() < 2 ** 15
    r_j = jscan.scan_band(big, FS, centers, chan_bw=BW)
    assert not np.all(np.isfinite(r_j.scores_db) & np.isfinite(r_j.prominence_db))
    r_p = pscan.scan_band(big, FS, centers, chan_bw=BW, device="cpu")
    r_0 = pscan.scan_band(capture, FS, centers, chan_bw=BW, device="cpu")
    assert np.all(np.isfinite(r_p.scores_db)) and np.all(np.isfinite(r_p.prominence_db))
    np.testing.assert_allclose(r_p.prominence_db, r_0.prominence_db, rtol=0, atol=1e-3)
    np.testing.assert_allclose(r_p.refresh_hz, r_0.refresh_hz, rtol=0, atol=HZ_TOL)
    np.testing.assert_allclose(r_p.scores_db - r_0.scores_db, 80.0 * np.log10(scale),
                               rtol=0, atol=1e-2)
    assert [e["best_channel_hz"] for e in r_p.emissions()] == \
        [e["best_channel_hz"] for e in r_0.emissions()]


def test_empty_channel_scores_the_floor_values():
    """An all-zero channel: mass at the −300 dB floor and prominence 0 in
    both packages (no NaN from the scale normalisation)."""
    zeros = np.zeros((1, 1 << 15), np.float32)
    m_j, p_j, _ = jscan._comb_contrast(jnp.asarray(zeros[0]), 2e6, 0.005, 50.0, 90.0)
    m_p, p_p, fv_p = pscan._comb_contrast(torch.from_numpy(zeros), 2e6, 0.005, 50.0, 90.0)
    assert float(m_p[0]) == float(m_j) == -300.0
    assert float(p_p[0]) == float(p_j) == 0.0
    assert torch.isfinite(fv_p).all()


def test_host_capture_without_device_needs_the_card(capture, centers):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for call in (lambda: pscan.scan_band(capture, FS, centers, chan_bw=BW),
                 lambda: pscan.channelize(capture, FS, centers, BW),
                 lambda: pscan.carrier_score(capture, FS)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
