"""The wideband cell's own cases (``wideband640-combine``): the input is a
function of the seed; the port's band scan and fusion agree with the plain
reference (``reference/combine.py``) stage by stage; each fault of the
fusion or the discovery comes out not correct; the reference loads nothing
of the port.  The cell's generic cases (correct, the control, the faults of
the timed chain, the result line, the spans) are the parametrised tests of
``test_portbench_cells.py`` and ``test_portbench_spans.py``.

All at the cell's small size (``small/wideband640-combine.json``): 0.2625 s
at 32 Msps, so a 2^23-point FFT and 15 channels of 2^20 samples at 4 Msps,
which the scores read whole, as they read 2^20 samples of each channel at
the full size.

    python -m pytest portbench/tests/test_portbench_wideband.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.tests.test_portbench_cells import SEED, run
from portbench.tests.test_portbench_files import FORBIDDEN, _modules_after

NAME = "wideband640-combine"


def _config() -> dict:
    return registry.load().cell(NAME, registry.small(NAME)).config


@pytest.fixture(autouse=True, scope="module")
def _four_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    """(config, words) of the cell at its small size."""
    from portbench.capture_wide import WideSpec, capture_words

    cfg = _config()
    n = int(round(float(cfg["sample_rate"]) * float(cfg["seconds"])))
    return cfg, capture_words(WideSpec.from_config(cfg), n, SEED + 30, "cpu")


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_wide_inputs_are_the_seeds(seed):
    from portbench.capture_wide import WideSpec, capture_words

    spec = WideSpec.from_config(_config())
    a = capture_words(spec, 40000, seed, "cpu")
    b = capture_words(spec, 40000, seed, "cpu")
    c = capture_words(spec, 40000, seed + 1, "cpu")
    assert a.dtype == torch.int16 and a.shape == (80000,)
    assert bool((a == b).all()) and not bool((a == c).all())


def test_the_small_words_do_not_clip(small):
    _, words = small
    assert int(words.to(torch.int32).abs().max()) < 32767


def test_sync_is_compared_around_the_screen():
    """Blanking centres a whole screen apart are one circular shift; a
    different count of frames is no match."""
    entry = registry.load().cell(NAME).entry
    want = torch.tensor([[0.25, 799.996], [599.9, 400.0]], dtype=torch.float64)
    got = torch.tensor([[0.25, -0.004], [-0.1, 400.01]], dtype=torch.float64)
    assert entry._circular_gap(got, want, (600, 800)) == pytest.approx(0.01, abs=1e-9)
    assert entry._circular_gap(got[:1], want, (600, 800)) == float("inf")


def test_scan_agrees_with_the_reference(small):
    """The band scan's masses, prominences, refreshes and floor, and the
    emissions they give, against the reference on the same words."""
    from portbench.reference import combine as ref
    from tempest_tpu_torch.ops import scan as pscan

    cfg, words = small
    a = cfg["assumed"]
    fs, bw, corr = float(cfg["sample_rate"]), float(a["chan_bw"]), float(a["corr_seconds"])
    centers = pscan.scan_centers(fs, bw / 2, bw / 2)
    got = pscan.scan_band(words, fs, centers, chan_bw=bw, corr_seconds=corr, device="cpu")
    want = ref.scan(words, fs, bw, corr)
    np.testing.assert_array_equal(got.centers_hz, want["centers_hz"])
    assert got.fs_channel == want["fs_channel"]
    # dB of sums over 2^20 lags taken in another order: 1e-3 dB (observed
    # under 1e-4); refresh to the estimator's 1/8-sample grid's 1e-4 Hz.
    np.testing.assert_allclose(got.scores_db, want["mass_db"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.prominence_db, want["prominence_db"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.refresh_hz, want["refresh_hz"], rtol=0, atol=1e-4)
    assert abs(got.floor_db[0] - want["floor_db"]) < 1e-3
    margin = float(a["min_margin_db"])
    mine = [(e["best_channel_hz"], e["score_db"]) for e in got.emissions(min_margin_db=margin)]
    theirs = [(e["best_channel_hz"], e["score_db"]) for e in ref.emissions(want, margin)]
    assert [c for c, _ in mine] == [c for c, _ in theirs]
    assert len(mine) == 3
    np.testing.assert_allclose([s for _, s in mine], [s for _, s in theirs], rtol=0, atol=1e-3)


def test_fusion_agrees_with_the_reference(small):
    """The two-pass fusion of the three carriers: polarities exact, weights,
    pass 1's masses and refreshes, and the fused envelope."""
    from portbench.reference import combine as ref
    from tempest_tpu_torch.ops import combine as pcomb

    cfg, words = small
    a = cfg["assumed"]
    fs, bw, corr = float(cfg["sample_rate"]), float(a["chan_bw"]), float(a["corr_seconds"])
    centers = np.array([-8e6, 12e6, 2e6])
    env, fields = pcomb._combine_on_device(words, fs, centers, bw, corr, 50.0, 90.0, "mrc",
                                           "auto", "am", None, "cpu")
    n_fft, m, fs_chan = ref.geometry(words.shape[0] // 2, fs, bw)
    spec = ref.spectrum(words, n_fft)
    amp = torch.stack([torch.abs(ref.channel(spec, fc, fs, m)) for fc in centers])
    r_env, r_w, r_pol, r_mass, r_fv = ref.fuse(amp, fs_chan, corr)
    np.testing.assert_array_equal(fields["polarity"], r_pol.numpy())
    np.testing.assert_array_equal(fields["polarity"], [1.0, 1.0, -1.0])
    np.testing.assert_allclose(fields["weights"], r_w.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fields["mass_db"], r_mass.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(fields["refresh_hz"], r_fv.numpy(), rtol=0, atol=1e-4)
    span = float(r_env.max() - r_env.min())
    assert float((env - r_env).abs().max()) < 1e-5 * span


def _fuse_plus_one(orig):
    def fuse(amp, *args):
        env, w, pol, mass, fv = orig(amp, *args)
        mean = torch.mean(amp, dim=1, keepdim=True)
        env = torch.mv((amp - mean).T, w) + torch.sum(w * mean[:, 0])
        return env, w, torch.ones_like(pol), mass, fv
    return fuse


FAULTS = ["polarity_plus_one", "equal_weights", "weakest_dropped", "best_alone"]


@pytest.mark.parametrize("fault", FAULTS)
def test_wideband_fault_comes_out_not_correct(fault, monkeypatch):
    """Every polarity +1; equal weights in place of MRC; the weakest
    discovered carrier dropped; the strongest carrier alone in place of the
    fusion."""
    from tempest_tpu_torch.ops import combine as pcomb
    from tempest_tpu_torch.pipeline import offline

    if fault == "polarity_plus_one":
        monkeypatch.setattr(pcomb, "_fuse", _fuse_plus_one(pcomb._fuse))
    elif fault == "weakest_dropped":
        discover = offline.discover_screens
        monkeypatch.setattr(offline, "discover_screens",
                            lambda *a, **k: [s[:-1] for s in discover(*a, **k)])
    else:
        combine = offline._combine_on_device

        def broken(iq, fs, centers, *rest):
            if fault == "best_alone":
                return combine(iq, fs, list(centers)[:1], *rest)
            return combine(iq, fs, centers, *rest[:4], "equal", *rest[5:])

        monkeypatch.setattr(offline, "_combine_on_device", broken)
    res, _ = run(NAME, SEED + 40)
    assert not res["correct"], res["checks"]


def test_the_reference_loads_nothing_of_the_port():
    """``reference/combine.py`` on a short capture in a fresh process: no
    module of the port, of the JAX package or of JAX."""
    loaded = _modules_after(
        "import numpy as np, torch\n"
        "from portbench.reference import combine\n"
        "from portbench.capture_wide import WideSpec, capture_words\n"
        "from portbench import registry\n"
        "cfg = registry.load_json(registry.HERE / 'configs' / 'wideband-640x480-32msps.json')\n"
        "w = capture_words(WideSpec.from_config(cfg), 1 << 21, 3, 'cpu')\n"
        "sweep = combine.scan(w, 32e6, 4e6, 0.01)\n"
        "combine.screens(combine.emissions(sweep, 8.0))\n"
        "n, m, fs_c = combine.geometry(1 << 21, 32e6, 4e6)\n"
        "spec = combine.spectrum(w, n)\n"
        "amp = torch.stack([combine.channel(spec, f, 32e6, m).abs() for f in (-8e6, 2e6)])\n"
        "env = combine.fuse(amp, fs_c, 0.01)[0]\n"
        "combine.envelope_timing(env, fs_c, 0.01)\n")
    assert not loaded & (FORBIDDEN | {"tempest_tpu_torch"})
