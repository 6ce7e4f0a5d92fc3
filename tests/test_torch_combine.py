"""``tempest_tpu_torch.ops.combine`` and the multi-harmonic entries of
``tempest_tpu_torch.pipeline.offline`` against the JAX package on the same
numpy captures (JAX on the CPU, as ``tests/test_combine.py`` runs it).

Tolerances.  Weights are ratios of means over float32 channel envelopes that
come out of FFTs with another summation order in each package: held to 1e-4
(observed 1e-7).  Polarity, and which channels a gate zeroes, are compared
exactly.  The fused envelope is held to 1e-4 of its peak (AM; observed 5e-7)
and 1e-3 for the FM discriminator, whose ``atan2`` of near-zero pairs
amplifies the channels' roundings.  Comb masses and refresh as in
``test_torch_scan.py`` (0.05 dB, 1e-4 Hz).  Whole reconstructions are not
compared pixel by pixel: the JAX entries resample with their table-driven
default and the port with K1's formula, so the images are held to a PSNR of
30 dB against each other, and each package's gain over the best single
carrier to 0.2 dB of the other's (two carriers at 1 / 0.7 in an 8 Msps
capture gain about 0.25 dB; the JAX package's own test of three carriers at
32 Msps asks 0.4 dB, which is the size the card's smoke test runs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tempest_tpu as tt
import tempest_tpu_torch as ptt
from tempest_tpu.ops import combine as jcomb
from tempest_tpu.ops import scan as jscan
from tempest_tpu.pipeline import offline as joff
from tempest_tpu_torch.ops import combine as pcomb
from tempest_tpu_torch.ops import scan as pscan
from tempest_tpu_torch.ops.resample import downgrade_image
from tempest_tpu_torch.pipeline import offline as poff
from tempest_tpu_torch.render.screen import aligned_psnr, psnr

MODE = tt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 8e6
BW = 2e6
CARRIERS = [-2.4e6, 1.8e6]
PMODE = ptt.ALL_VIDEO_MODES["640x480 @ 60Hz"]
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
    """Two harmonics of one 640x480 screen at amplitudes 1 / 0.7, the weaker
    one inverted, 6 dB SNR, 0.5 s at 8 Msps (the envelope of a 25 MHz pixel
    clock fills the 8 MHz band: more carriers would merge into one emission
    in the scan)."""
    return tt.generate_iq_harmonics(MODE, FS, int(FS * 0.5), CARRIERS,
                                    amplitudes=[1.0, 0.7], depths=[0.8, -0.8],
                                    snr_db=6.0, seed=5)


def _truth(cap):
    return downgrade_image(torch.from_numpy(cap.frame)).numpy()


def _close_fusion(got, ref, env_tol=1e-4):
    env_g, w_g, pol_g, mass_g, fv_g = [np.asarray(v, np.float64) for v in got]
    env_r, w_r, pol_r, mass_r, fv_r = [np.asarray(v, np.float64) for v in ref]
    np.testing.assert_array_equal(pol_g, pol_r)
    np.testing.assert_array_equal(w_g == 0.0, w_r == 0.0)
    np.testing.assert_allclose(w_g, w_r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(mass_g, mass_r, rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(fv_g, fv_r, rtol=0, atol=HZ_TOL)
    assert env_g.shape == env_r.shape
    assert np.abs(env_g - env_r).max() <= env_tol * np.abs(env_r).max()


CORE_CASES = {
    "lag1": dict(weighting="mrc", refresh_hz=None),
    "periodic": dict(weighting="mrc", refresh_hz=60.0),
    "equal": dict(weighting="equal", refresh_hz=None),
    "equal_known_refresh": dict(weighting="equal", refresh_hz=60.0),
    "fm": dict(weighting="mrc", refresh_hz=60.0, demod="fm"),
    "fm_search": dict(weighting="mrc", refresh_hz=None, demod="fm"),
    "excise": dict(weighting="mrc", refresh_hz=60.0, excise_db=0.0),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_combine_core_matches_jax(capture, case):
    """All three weightings (lag-1 MRC, frame-periodic MRC, equal), the
    refresh known or searched, both demodulators and excision, with a third
    centre between the carriers that catches only their sidebands."""
    kw = CORE_CASES[case]
    words = np.ascontiguousarray(capture.iq[: int(FS * 0.3)]).view(np.float32)
    centers = tuple(CARRIERS + [-0.3e6])
    _, _, fs_chan = jscan._channel_geometry(len(words) // 2, FS, BW)
    args = (FS, centers, BW, fs_chan, 0.1, 50.0, 90.0)
    ref = jcomb._combine_kernel(jnp.asarray(words), *args, **kw)
    got = pcomb.combine_core(torch.from_numpy(words), *args, **kw)
    _close_fusion(got, ref, env_tol=1e-3 if kw.get("demod") == "fm" else 1e-4)
    if case == "periodic":
        w = got[1].numpy()
        assert w[0] > w[1] > w[2] > 0.0 and abs(w.sum() - 1.0) < 1e-6
        np.testing.assert_array_equal(got[2].numpy()[:2], [1.0, -1.0])


def _rows(seed=0, m=1 << 16, period=4000):
    """Demodulated channels made by hand: two rows carry the same
    frame-periodic, sample-correlated content (one inverted) in white noise,
    the third only white noise, the fourth only sample-correlated noise that
    is not periodic in the frame."""
    rng = np.random.default_rng(seed)
    smooth = np.ones(8) / np.sqrt(8.0)
    v = np.tile(np.convolve(rng.standard_normal(period + 7), smooth, "valid"),
                m // period + 1)[:m]
    n = rng.standard_normal((4, m))
    hum = 2.0 * np.convolve(rng.standard_normal(m + 7), smooth, "valid")
    rows = np.stack([2.0 + 1.0 * v + n[0], 2.0 - 0.7 * v + n[1], 2.0 + n[2],
                     2.0 + hum + n[3]])
    return torch.from_numpy(rows.astype(np.float32))


@pytest.mark.parametrize("refresh", [500.0, None], ids=["periodic", "lag1"])
def test_channels_without_screen_content_get_zero_weight(refresh):
    """The gates of both MRC estimators on rows with known content (period
    4000 samples at 2 Msps = 500 Hz): the noise row is zeroed exactly by
    both; the correlated-noise row only by the frame-periodic estimator —
    the lag-1 split reads its sample-correlated power as signal, which is
    why the public wrappers run the periodic one."""
    env, w, pol, mass, fv = pcomb._fuse(_rows(), 2e6, 0.02, 400.0, 600.0, "mrc", refresh)
    w = w.numpy()
    assert w[2] == 0.0 and w[0] > w[1] > 0.2
    np.testing.assert_array_equal(pol.numpy()[:2], [1.0, -1.0])
    assert abs(w.sum() - 1.0) < 1e-6
    if refresh is not None:
        assert w[3] == 0.0
    else:
        assert w[3] > 0.1 and abs(float(fv[0]) - 500.0) < 0.5
    assert env.shape == (1 << 16,) and abs(float(env.mean()) - 2.0) < 0.05


@pytest.mark.parametrize("kw", [dict(), dict(refresh_hz=None), dict(refresh_hz=59.99),
                                dict(weighting="equal"), dict(demod="fm")],
                         ids=["auto", "lag1", "given_refresh", "equal", "fm"])
def test_combine_harmonics_matches_jax(capture, kw):
    """The public wrapper, with the two-pass ``"auto"`` and its integer
    frame-period quantisation of the anchor's refresh; polarity re-based to
    the first carrier."""
    c_j = jcomb.combine_harmonics(capture.iq, FS, CARRIERS, chan_bw=BW, **kw)
    c_p = pcomb.combine_harmonics(capture.iq, FS, CARRIERS, chan_bw=BW, device="cpu", **kw)
    assert c_p.fs_channel == c_j.fs_channel == 2e6
    np.testing.assert_array_equal(c_p.centers_hz, c_j.centers_hz)
    assert isinstance(c_p.envelope, np.ndarray) and c_p.envelope.dtype == np.float32
    _close_fusion((c_p.envelope, c_p.weights, c_p.polarity, c_p.mass_db, c_p.refresh_hz),
                  (c_j.envelope, c_j.weights, c_j.polarity, c_j.mass_db, c_j.refresh_hz),
                  env_tol=1e-3 if kw.get("demod") == "fm" else 1e-4)
    assert c_p.best_channel() == c_j.best_channel()
    assert abs(c_p.weights.sum() - 1.0) < 1e-6
    if kw.get("demod") != "fm":
        assert c_p.best_channel() == 0
        np.testing.assert_array_equal(c_p.polarity, [1.0, -1.0])


def test_polarity_is_rebased_to_the_first_carrier(capture):
    """Listing the inverted carrier first flips the fused envelope's sense:
    the contract is centers_hz[0]'s modulation sense, in both packages."""
    order = [CARRIERS[1], CARRIERS[0]]
    c_j = jcomb.combine_harmonics(capture.iq, FS, order, chan_bw=BW)
    c_p = pcomb.combine_harmonics(capture.iq, FS, order, chan_bw=BW, device="cpu")
    np.testing.assert_array_equal(c_p.polarity, [1.0, -1.0])
    np.testing.assert_array_equal(c_p.polarity, c_j.polarity)
    straight = pcomb.combine_harmonics(capture.iq, FS, CARRIERS, chan_bw=BW, device="cpu")
    a = c_p.envelope - c_p.envelope.mean()
    b = straight.envelope - straight.envelope.mean()
    assert np.corrcoef(a, b)[0, 1] < -0.9


def test_combine_single_carrier_is_channel_envelope():
    """K=1 identity: with one carrier the fusion reduces exactly to that
    channel's amplitude envelope (weight 1, polarity +, DC re-added)."""
    cap = tt.generate_iq_harmonics(MODE, FS, int(FS * 0.12), [CARRIERS[0]], snr_db=10.0, seed=7)
    comb = pcomb.combine_harmonics(cap.iq, FS, [CARRIERS[0]], chan_bw=BW, device="cpu")
    ch, fs_chan = pscan.channelize(cap.iq, FS, [CARRIERS[0]], BW, device="cpu")
    env = np.abs(np.ascontiguousarray(ch.numpy()).view(np.complex64)[0])
    assert comb.fs_channel == fs_chan
    np.testing.assert_allclose(comb.envelope, env, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(comb.weights, [1.0])
    np.testing.assert_array_equal(comb.polarity, [1.0])


def test_interferer_hit_channel_downweighted_and_recovered(capture):
    """A CW 9 dB above the weaker channel's emission: the frame-periodic
    MRC crushes that channel's weight, excision recovers it, and a clean
    capture passes through excision with the same weights — as in the JAX
    package, to its numbers."""
    n = len(capture.iq)
    cw = (3.0 * np.exp(2j * np.pi * 2.1e6 / FS * np.arange(n))).astype(np.complex64)
    dirty = (capture.iq + cw).astype(np.complex64)
    clean = pcomb.combine_harmonics(capture.iq, FS, CARRIERS, chan_bw=BW, device="cpu")
    for kw in (dict(), dict(excise_db=0.0)):
        c_j = jcomb.combine_harmonics(dirty, FS, CARRIERS, chan_bw=BW, **kw)
        c_p = pcomb.combine_harmonics(dirty, FS, CARRIERS, chan_bw=BW, device="cpu", **kw)
        np.testing.assert_allclose(c_p.weights, c_j.weights, rtol=0, atol=1e-4)
        if kw:
            np.testing.assert_allclose(c_p.weights, clean.weights, atol=0.05)
        else:
            assert c_p.weights[1] < 0.5 * clean.weights[1], (c_p.weights, clean.weights)
    clean_exc = pcomb.combine_harmonics(capture.iq, FS, CARRIERS, chan_bw=BW, excise_db=0.0,
                                        device="cpu")
    np.testing.assert_allclose(clean_exc.weights, clean.weights, atol=1e-6)


# ------------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def single_carrier(capture):
    """Each package's reconstruction from the strongest carrier alone."""
    _, r_j, _ = joff.combined_reconstruct(capture.iq, FS, [CARRIERS[0]], chan_bw=BW, alpha=0.7)
    _, r_p, _ = poff.combined_reconstruct(capture.iq, FS, [CARRIERS[0]], chan_bw=BW, alpha=0.7,
                                          device="cpu")
    truth = _truth(capture)
    return aligned_psnr(truth, r_j.image)[0], aligned_psnr(truth, r_p.image)[0]


@pytest.mark.parametrize("discover", [False, True], ids=["given_centres", "discovery"])
def test_combined_reconstruct_matches_jax(capture, single_carrier, discover):
    """Same mode name and refresh, same carriers (given or discovered), the
    fusion's evidence within tolerance, the images close to each other, and
    the same gain over the strongest single carrier in both packages."""
    centres = None if discover else CARRIERS
    t_j, r_j, c_j = joff.combined_reconstruct(capture.iq, FS, centres, chan_bw=BW, alpha=0.7)
    t_p, r_p, c_p = poff.combined_reconstruct(capture.iq, FS, centres, chan_bw=BW, alpha=0.7,
                                              device="cpu")
    assert t_p.mode_name == t_j.mode_name == "640x480 @ 60Hz"
    assert abs(t_p.refresh_hz - t_j.refresh_hz) < HZ_TOL
    np.testing.assert_array_equal(c_p.centers_hz, c_j.centers_hz)
    assert len(c_p.centers_hz) == 2
    for c in c_p.centers_hz:
        assert min(abs(c - t) for t in CARRIERS) <= BW / 2
    np.testing.assert_array_equal(c_p.polarity, c_j.polarity)
    np.testing.assert_allclose(c_p.weights, c_j.weights, rtol=0, atol=1e-4)
    assert c_p.weights[0] > c_p.weights[1] > 0.1
    assert abs(c_p.weights.sum() - 1.0) < 1e-6
    assert isinstance(c_p.envelope, np.ndarray) and r_p.image_raw is not None
    assert r_p.image.shape == r_j.image.shape == (600, 800)
    assert psnr(r_j.image, r_p.image) > 30.0
    truth = _truth(capture)
    p_j, p_p = aligned_psnr(truth, r_j.image)[0], aligned_psnr(truth, r_p.image)[0]
    gain_j, gain_p = p_j - single_carrier[0], p_p - single_carrier[1]
    assert gain_p > 0.15, (p_p, single_carrier)
    assert abs(gain_p - gain_j) < 0.2, (gain_p, gain_j)


def test_combined_reconstruct_of_int16_words_is_that_of_their_float32(capture):
    """A recording's host int16 words (as an SDR writes them) give the
    carriers, polarity, weights, mode and images that the same words as
    float32 give: the scan and the fusion cast the words they read to
    float32 on the device, so the two runs differ at most by float32
    rounding."""
    words = np.ascontiguousarray(capture.iq).view(np.float32) * 4096.0
    assert np.abs(words).max() < 32767
    w16 = np.round(words).astype(np.int16)
    t16, r16, c16 = poff.combined_reconstruct(w16, FS, None, chan_bw=BW, alpha=0.7,
                                              device="cpu")
    t32, r32, c32 = poff.combined_reconstruct(w16.astype(np.float32), FS, None, chan_bw=BW,
                                              alpha=0.7, device="cpu")
    assert t16.mode_name == t32.mode_name == "640x480 @ 60Hz"
    assert t16.refresh_hz == t32.refresh_hz
    np.testing.assert_array_equal(c16.centers_hz, c32.centers_hz)
    assert len(c16.centers_hz) == 2
    np.testing.assert_array_equal(c16.polarity, c32.polarity)
    np.testing.assert_allclose(c16.weights, c32.weights, rtol=1e-6, atol=0)
    np.testing.assert_allclose(c16.envelope, c32.envelope, rtol=0,
                               atol=1e-6 * np.abs(c32.envelope).max())
    for a, b in ((r16.image, r32.image), (r16.image_raw, r32.image_raw)):
        assert a.shape == b.shape == (600, 800)
        assert np.abs(a - b).max() <= 1e-6 * (b.max() - b.min())


def test_combine_manual_mode_override_and_no_emission(capture):
    """An explicit ``mode`` replaces the detected one and keeps the fusion;
    discovery on noise raises as the JAX entry does."""
    iq = capture.iq[: int(FS * 0.2)]
    t, r, c = poff.combined_reconstruct(iq, FS, CARRIERS, chan_bw=BW, alpha=0.7, mode=PMODE,
                                        restore=False, device="cpu")
    assert t.mode_name == "640x480 @ 60Hz" and t.mode is PMODE
    assert r.image.shape == (600, 800) and r.image_raw is None
    rng = np.random.default_rng(1)
    noise = (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq))).astype(np.complex64)
    for entry, kw in ((joff.combined_reconstruct, {}), (poff.combined_reconstruct,
                                                       {"device": "cpu"})):
        with pytest.raises(ValueError, match="no emissions detected"):
            entry(noise, FS, None, chan_bw=BW, **kw)
    assert poff.reconstruct_all_emissions(noise, FS, chan_bw=BW, device="cpu") == []


def test_reconstruct_all_emissions_two_screens():
    """Two monitors in one capture (distinct refresh rates): the same two
    screens in both packages, each image closer to its own truth."""
    mode2 = tt.ALL_VIDEO_MODES["800x600 @ 72Hz"]
    n = int(FS * 0.4)
    cap_a = tt.generate_iq(MODE, FS, n, snr_db=12.0, seed=2, carrier_offset_hz=-2.2e6)
    cap_b = tt.generate_iq(mode2, FS, n, snr_db=12.0, seed=3, carrier_offset_hz=2.0e6)
    iq = (cap_a.iq + cap_b.iq).astype(np.complex64)
    res_j = joff.reconstruct_all_emissions(iq, FS, chan_bw=BW, alpha=0.7)
    res_p = poff.reconstruct_all_emissions(iq, FS, chan_bw=BW, alpha=0.7, device="cpu")
    assert len(res_p) == len(res_j) == 2
    assert [t.mode_name for t, _, _ in res_p] == [t.mode_name for t, _, _ in res_j]
    assert {t.mode_name for t, _, _ in res_p} == {"640x480 @ 60Hz", "800x600 @ 72Hz"}
    for (t_j, r_j, c_j), (t_p, r_p, c_p) in zip(res_j, res_p):
        np.testing.assert_array_equal(c_p.centers_hz, c_j.centers_hz)
        assert abs(t_p.refresh_hz - t_j.refresh_hz) < HZ_TOL
        assert psnr(r_j.image, r_p.image) > 30.0
        cap = cap_a if t_p.mode_name == "640x480 @ 60Hz" else cap_b
        other = cap_b if cap is cap_a else cap_a
        # At 8 Msps each screen's emission fills the whole band, so the
        # other screen leaks into every channel: a small margin, the same in
        # both packages.
        p_own, _ = aligned_psnr(_truth(cap), r_p.image)
        p_other, _ = aligned_psnr(_truth(other), r_p.image)
        assert p_own > p_other + 0.3, (t_p.mode_name, p_own, p_other)
        assert abs(p_own - aligned_psnr(_truth(cap), r_j.image)[0]) < 0.3
    one = poff.reconstruct_all_emissions(iq, FS, chan_bw=BW, alpha=0.7, max_screens=1,
                                         restore=False, device="cpu")
    assert len(one) == 1 and one[0][0].mode_name == res_p[0][0].mode_name


def test_discover_screens_groups_an_existing_sweep(capture):
    centers = pscan.scan_centers(FS, BW / 2, BW / 2)
    sweep = pscan.scan_band(capture.iq, FS, centers, chan_bw=BW, device="cpu")
    screens = poff.discover_screens(None, FS, BW, scan_result=sweep)
    assert len(screens) == 1 and len(screens[0]) == 2
    scores = [e["score_db"] for e in screens[0]]
    assert scores == sorted(scores, reverse=True)
    # A tight grouping tolerance of 0 splits every emission into its own screen.
    assert len(poff.discover_screens(None, FS, BW, scan_result=sweep,
                                     refresh_group_hz=0.0)) == 2


def test_host_capture_without_device_needs_the_card(capture):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for call in (lambda: pcomb.combine_harmonics(capture.iq, FS, CARRIERS, chan_bw=BW),
                 lambda: poff.combined_reconstruct(capture.iq, FS, CARRIERS, chan_bw=BW),
                 lambda: poff.reconstruct_all_emissions(capture.iq, FS, chan_bw=BW),
                 lambda: poff.discover_screens(capture.iq.view(np.float32), FS, BW)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
