"""Carrier shards of ``parallel.sharded`` on meshes of CPU shards: the band
scan, the multi-harmonic fusion, the fused reconstruction and the live
combine front, held against the port's own single-device ``scan_band``,
``combine_harmonics`` and ``combine_core`` (which ``tests/test_torch_scan.py``
and ``tests/test_torch_combine.py`` hold against the JAX package), with one
direct comparison with the JAX package's ``sharded_combine_harmonics`` on its
8-device CPU mesh, and one run of the front on two gloo ranks.

Capture: two harmonics of one 640x480 screen in 0.3 s at 8 Msps, the weaker
one inverted, 2 MHz channels; a third carrier off the screen's emissions.

Tolerances, and why.  Each shard channelises and scores its own rows, and
torch's CPU FFT of a batch of rows is not bit-stable in the batch size: the
autocorrelations of a channel differ at float32 rounding between a batch of
3 rows and one of 1 (measured 5e-7 relative).  So: polarity and the carrier
order exact; comb masses and prominences to 1e-3 dB (measured 8e-6 dB;
the single-device parity tests allow 0.05); refresh estimates to 1e-4 Hz
(the same point of the lag grid); MRC weights to 1e-5 relative (measured
3e-7; 1e-4 in the single-device tests); the fused envelope to 1e-5 of its
peak (measured 4.6e-7: the weighted sum is a sum over shards of sums over
their rows, where the single device sums over all rows at once).  Against
the JAX package: the single-device parity tolerances (0.05 dB, weights to
1e-4, the envelope to 1e-5 of its peak).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.ops.combine import combine_core
from tempest_tpu_torch.ops.scan import _channel_geometry
from tempest_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
MODE = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
FS = 8e6
BW = 2e6
CARRIERS = [-2.4e6, 1.8e6, 0.3e6]
DB_TOL = 1e-3
HZ_TOL = 1e-4
W_REL = 1e-5
ENV_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture():
    return tp.generate_iq_harmonics(MODE, FS, int(FS * 0.3), CARRIERS[:2],
                                    amplitudes=[1.0, 0.7], depths=[0.8, -0.8],
                                    snr_db=6.0, seed=4).iq


def _cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _assert_combine_close(got, ref, w_rel=W_REL, db=DB_TOL, env_rel=ENV_REL):
    np.testing.assert_array_equal(got.polarity, ref.polarity)
    np.testing.assert_array_equal(got.centers_hz, ref.centers_hz)
    assert got.fs_channel == ref.fs_channel
    np.testing.assert_allclose(got.weights, ref.weights, rtol=w_rel, atol=1e-9)
    np.testing.assert_allclose(got.mass_db, ref.mass_db, atol=db)
    np.testing.assert_allclose(got.refresh_hz, ref.refresh_hz, atol=HZ_TOL)
    scale = np.abs(ref.envelope).max()
    np.testing.assert_allclose(got.envelope, ref.envelope, atol=env_rel * scale)


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("kw", [{}, {"demod": "fm"}, {"excise_db": 0.0}],
                         ids=["am", "fm", "excise"])
def test_sharded_scan_band_equals_scan_band(capture, kw):
    """``tests/test_scan.py:282`` and ``:300``: 7 channels over 4 shards (one
    pad), every knob of the sweep, the same measured noise floor."""
    centers = tp.scan_centers(FS, 1e6, guard_hz=1e6)
    assert len(centers) == 7
    got = tp.sharded_scan_band(capture, FS, centers, _cpu_mesh(4), chan_bw=BW, **kw)
    ref = tp.scan_band(capture, FS, centers, chan_bw=BW, device="cpu", **kw)
    assert got.fs_channel == ref.fs_channel
    np.testing.assert_array_equal(got.centers_hz, ref.centers_hz)
    np.testing.assert_allclose(got.scores_db, ref.scores_db, atol=DB_TOL)
    np.testing.assert_allclose(got.prominence_db, ref.prominence_db, atol=DB_TOL)
    np.testing.assert_allclose(got.refresh_hz, ref.refresh_hz, atol=HZ_TOL)
    np.testing.assert_array_equal(got.floor_db, ref.floor_db)
    assert got.best()[0] == ref.best()[0]
    with pytest.raises(ValueError, match="excise_db with demod='fm'"):
        tp.sharded_scan_band(capture, FS, centers, _cpu_mesh(4), demod="fm", excise_db=0.0)


# ---------------------------------------------------------------- the fusion
@pytest.mark.parametrize("kw", [
    {}, {"refresh_hz": 60.0}, {"refresh_hz": None}, {"weighting": "equal"},
    {"demod": "fm"}, {"excise_db": 0.0},
], ids=["auto", "known_refresh", "lag1", "equal", "fm", "excise"])
def test_sharded_combine_equals_combine_harmonics(capture, kw):
    """Three carriers over 2 shards (one pad): the anchor from the gathered
    masses, the polarity against the summed anchor envelope, the gates and
    the re-basing to the first gated carrier give the single-device
    decisions; the envelope is the single-device one up to the order of its
    sum."""
    got = tp.sharded_combine_harmonics(capture, FS, CARRIERS, _cpu_mesh(2), chan_bw=BW, **kw)
    ref = tp.combine_harmonics(capture, FS, CARRIERS, chan_bw=BW, device="cpu", **kw)
    _assert_combine_close(got, ref)
    if kw.get("weighting") != "equal" and kw.get("demod") != "fm":
        np.testing.assert_array_equal(got.polarity, [1.0, -1.0, 1.0])
        assert got.weights[0] > got.weights[1] > got.weights[2]


def test_no_gated_carrier_keeps_carrier_zero_s_sense():
    """When every weight is gated to zero, the output polarity is re-based to
    carrier 0, as ``combine_core`` does."""
    rng = np.random.default_rng(1)
    noise = ((rng.standard_normal(1 << 20) + 1j * rng.standard_normal(1 << 20)) * 0.1
             ).astype(np.complex64)
    got = tp.sharded_combine_harmonics(noise, FS, CARRIERS, _cpu_mesh(2), chan_bw=BW,
                                       refresh_hz=60.0)
    ref = tp.combine_harmonics(noise, FS, CARRIERS, chan_bw=BW, refresh_hz=60.0, device="cpu")
    np.testing.assert_array_equal(got.polarity, ref.polarity)
    np.testing.assert_array_equal(got.weights, ref.weights)


def test_sharded_combine_matches_jax(capture):
    """The one direct comparison with the JAX package's carrier-sharded
    fusion (``tests/test_combine.py:567``), 8 shards each side."""
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    ref = jsharded.sharded_combine_harmonics(capture, FS, CARRIERS, jmesh.make_mesh(8),
                                             chan_bw=BW)
    got = tp.sharded_combine_harmonics(capture, FS, CARRIERS, _cpu_mesh(8), chan_bw=BW)
    _assert_combine_close(got, ref, w_rel=1e-4, db=0.05)


# ------------------------------------------ the fused reconstruction, the front
def test_sharded_combined_reconstruct_composition(capture):
    """``tests/test_combine.py:590``: carrier-sharded front → time-sharded
    chain in one step, against ``combine_core`` at the same quantised refresh
    feeding ``sharded_reconstruct_fn``.  Weights to 1e-5; the image to 5e-3
    of its peak, the JAX test's bound: the sub-pixel sync turns the fused
    envelope's summation-order differences into sub-pixel shifts."""
    n_c = 1 << 21
    iq = tp.generate_iq_harmonics(MODE, FS, n_c, CARRIERS[:2], amplitudes=[1.0, 0.8],
                                  snr_db=8.0, seed=4).iq
    _, M, fs_chan = _channel_geometry(n_c, FS, BW)
    cfg = tp.ReconstructionConfig(sample_rate=fs_chan, mode=MODE, n_frames=1,
                                  render_size=(150, 200), input_format="envelope",
                                  align_subpixel=True)
    mesh = _cpu_mesh(8)
    step = tp.sharded_combined_reconstruct_fn(cfg, mesh, FS, n_c, CARRIERS[:2], 60.0,
                                              chan_bw=BW)
    assert step.n_shards == 8 and step.shard_samples == M // 8 and step.fs_channel == fs_chan
    words = iq.view(np.float32)
    ema, frames, sync, score, w, pol = step(words, np.zeros((150, 200), np.float32), 0.5)
    assert frames.shape == (8, 150, 200)
    fvq = fs_chan / round(fs_chan / 60.0)
    env, w1, pol1, _, _ = combine_core(torch.from_numpy(words), FS, CARRIERS[:2], BW, fs_chan,
                                       0.1, max(fvq - 5.0, 20.0), fvq + 5.0, "mrc",
                                       refresh_hz=fvq)
    np.testing.assert_allclose(w.numpy(), w1.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(pol.numpy(), pol1.numpy())
    S = step.shard_samples
    ema_ref, *_ = tp.sharded_reconstruct_fn(cfg, mesh)(env[: 8 * S].reshape(8, S),
                                                       np.zeros((150, 200), np.float32), 0.5)
    assert (ema - ema_ref).abs().max() < 5e-3 * ema_ref.abs().max()
    with pytest.raises(ValueError, match="channel rate"):
        tp.sharded_combined_reconstruct_fn(cfg, mesh, FS, n_c, CARRIERS[:2], 60.0,
                                           chan_bw=2 * BW)
    with pytest.raises(ValueError, match="per-shard envelope span"):
        tp.sharded_combined_reconstruct_fn(cfg, mesh, FS, n_c // 2, CARRIERS[:2], 60.0,
                                           chan_bw=BW)


def test_streaming_combine_front_equals_combine_core(capture):
    """The live front of the mesh runtime: the known-refresh fusion of
    ``combine_core`` at the refresh quantised to a whole channel frame."""
    n = 1 << 21
    iq = np.resize(capture, n).astype(np.complex64)
    front = tp.sharded_streaming_combine_front(FS, n, CARRIERS, 60.0, _cpu_mesh(2), chan_bw=BW)
    N, M, fs_chan = _channel_geometry(n, FS, BW)
    assert (front.n_fft, front.m_chan, front.fs_channel) == (N, M, fs_chan)
    words = torch.from_numpy(iq.view(np.float32))
    env, w, pol, mass = front(words)
    fvq = fs_chan / round(fs_chan / 60.0)
    env1, w1, pol1, mass1, _ = combine_core(words, FS, CARRIERS, BW, fs_chan, 0.1,
                                            max(fvq - 5.0, 20.0), fvq + 5.0, "mrc",
                                            refresh_hz=fvq)
    assert env.shape == (M,) and w.shape == (3,)
    np.testing.assert_allclose(w.numpy(), w1.numpy(), rtol=W_REL, atol=1e-9)
    np.testing.assert_array_equal(pol.numpy(), pol1.numpy())
    np.testing.assert_allclose(mass.numpy(), mass1.numpy(), atol=DB_TOL)
    assert (env - env1).abs().max() < ENV_REL * env1.abs().max()


_RANK_MAIN = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import tempest_tpu_torch as tp
from tempest_tpu_torch.parallel import distributed

distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
mesh = distributed.global_mesh()
iq = np.load(os.path.join(out, "words.npy"))
front = tp.sharded_streaming_combine_front(8e6, iq.size // 2, [-2.4e6, 1.8e6, 0.3e6], 60.0,
                                           mesh, chan_bw=2e6)
env, w, pol, mass = front(torch.from_numpy(iq))
np.savez(os.path.join(out, f"rank{rank}.npz"), env=env.numpy(), w=w.numpy(), pol=pol.numpy(),
         mass=mass.numpy(), calls=np.array(json.dumps(dict(mesh.comm.calls))))
torch.distributed.destroy_process_group()
"""


def test_combine_front_on_two_gloo_ranks(capture, tmp_path):
    """The live front on two processes, one gloo rank and one torch thread
    each, every rank with the whole block: each gets the one-process 2-shard
    mesh's envelope, weights, polarity and masses, to the bit (a sum of two
    parts has one order)."""
    import socket

    n = 1 << 21
    words = np.resize(capture, n).astype(np.complex64).view(np.float32)
    np.save(tmp_path / "words.npy", words)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_MAIN, str(r), "2", port,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    front = tp.sharded_streaming_combine_front(FS, n, CARRIERS, 60.0, _cpu_mesh(2), chan_bw=BW)
    want = [t.numpy() for t in front(torch.from_numpy(words))]
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for key, ref in zip(("env", "w", "pol", "mass"), want):
            np.testing.assert_array_equal(got[key], ref, err_msg=key)
        calls = json.loads(str(got["calls"]))
        assert calls["all_gather"] >= 1 and calls["all_reduce_min"] == 1
        assert calls["all_reduce_sum"] == 5
