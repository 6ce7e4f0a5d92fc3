"""The port's counterpart of the repo's ``__graft_entry__.py``
(``tempest_tpu_torch.bench.graft_entry``) on the CPU: ``entry()``'s step
against the JAX package's, and ``dryrun_multichip`` on meshes of CPU shards,
its time-sharded step against the JAX package's ``sharded_reconstruct_fn``
on 4 of the 8 virtual CPU devices.

Both configurations name no resampler, so the JAX package takes ``mxu3``;
the port's counterparts name it (K1 on the bfloat16-rounded envelope with
the line fractions on a 64-phase grid).  Where the two formulations differ
by design (ROADMAP, Queue 3, "Edges"): the JAX per-frame tables pad each
frame with its last sample and treat row 0's negative fraction otherwise,
so raw rows h-2, h-1, 0 and 1 of each frame differ; after the alignment
they lie on the rows ``seam_rows`` names, which the comparisons leave out.
Elsewhere, tolerances:

* the positions: 2e-5 of the largest output (``POSITION`` of
  ``tests/test_torch_resamplers.py``: float32 against float64 positions);
* the time shards' integer sync on a capture with a clear blanking peak:
  syncs equal, so the frames and EMA to ``POSITION``; the sync scores to
  ``SCORE_EDGE`` relative, since the edge rows enter the profiles that the
  scores are formed from (2.3e-4 measured);
* ``entry()``'s sub-pixel sync on its noise words (``default_rng(0)``, as
  ``__graft_entry__``): the edge rows enter the profiles that the sync
  reads, so the centres agree to 2e-3 px (1.3e-3 measured; 1e-3 on a
  capture, ``tests/test_torch_pipeline.py``) and the scores to 1e-2
  relative (noise frames have no blanking to dominate the contrast), and the
  images to ``POSITION`` plus the shift's part, the syncs' largest
  difference times the largest step between neighbouring pixels (noise
  frames change by up to their range from one pixel to the next).
"""

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.bench import graft_entry

POSITION = 2e-5
SYNC_NOISE_PX = 2e-3
SCORE_EDGE = 1e-3
PROGRAMS = {"reconstruct", "batched", "mode_search", "mode_search_static", "scan_band",
            "combine", "combined_reconstruct", "streaming", "welch"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seam_rows(sync_rows, h: int) -> np.ndarray:
    """Rows of the aligned frames (and of their EMA) that raw rows h-2, h-1,
    0 and 1 land on: aligned row a reads raw rows around a + s for a frame
    synced at row s."""
    rows = set()
    for s in np.asarray(sync_rows, np.float64):
        for r in (-2, -1, 0, 1):
            b = int(np.floor(r - s))
            rows |= {(b + k) % h for k in (-1, 0, 1)}
    return np.setdiff1d(np.arange(h), sorted(rows))


def test_entry_step_matches_jax_entry():
    jg = pytest.importorskip("__graft_entry__")
    jstep, jargs = jg.entry()
    ema_j, frames_j, sync_j, score_j = (np.asarray(x) for x in jstep(*jargs))
    step, args = graft_entry.entry("cpu")
    assert np.array_equal(args[0].numpy(), np.asarray(jargs[0]))
    ema, frames, sync, score = (x.numpy() for x in step(*args))
    assert frames.shape == frames_j.shape == (2, 600, 800) and ema.shape == (600, 800)
    np.testing.assert_array_equal(np.floor(sync), np.floor(sync_j))
    ds = float(np.abs(sync - sync_j).max())
    assert ds < SYNC_NOISE_PX
    keep = seam_rows(sync[:, 0], 600)
    assert keep.size >= 580
    largest = float(np.abs(frames_j).max())
    step_max = float(np.abs(np.diff(frames, axis=1)).max() + np.abs(np.diff(frames, axis=2)).max())
    bound = POSITION * largest + ds * step_max
    assert float(np.abs(frames - frames_j)[:, keep].max()) <= bound
    assert float(np.abs(ema - ema_j)[keep].max()) <= bound
    np.testing.assert_allclose(score, score_j, rtol=1e-2)


@pytest.fixture(scope="module")
def capture_rows():
    """Four shards of a 640x480 @ 60 Hz capture at 1 Msps, the dry run's
    geometry: one shard of ``block_samples`` a device."""
    mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
    S = tp.ReconstructionConfig(sample_rate=1e6, mode=mode, n_frames=1).block_samples
    cap = tp.generate_iq(mode, 1e6, 4 * S, snr_db=18.0, seed=5)
    return cap.iq[: 4 * S].reshape(4, S).astype(np.complex64)


def test_dryrun_time_shards_match_jax(capture_rows):
    jsharded = pytest.importorskip("tempest_tpu.parallel.sharded")
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    joff = pytest.importorskip("tempest_tpu.pipeline.offline")
    jnp = pytest.importorskip("jax.numpy")

    mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
    jcfg = joff.ReconstructionConfig(sample_rate=1e6, mode=mode, n_frames=1)
    assert jcfg.resampler == graft_entry.JAX_DEFAULT_RESAMPLER
    jstep = jsharded.sharded_reconstruct_fn(jcfg, jmesh.make_mesh(4))
    ema_j, frames_j, sync_j, score_j = (np.asarray(x) for x in jstep(
        jnp.asarray(capture_rows), jnp.zeros(jcfg.render_size, jnp.float32), jnp.float32(0.5)))
    out = graft_entry.dryrun_multichip(4, ["cpu"] * 4, iq=capture_rows)
    assert set(out) == PROGRAMS | {"mode_search_2d"}
    ema, frames, sync, score = (x.numpy() for x in out["reconstruct"])
    np.testing.assert_array_equal(sync, sync_j)
    keep = seam_rows(sync[:, 0], 600)
    assert keep.size >= 588
    largest = float(np.abs(frames_j).max())
    assert float(np.abs(frames - frames_j)[:, keep].max()) <= POSITION * largest
    assert float(np.abs(ema - ema_j)[keep].max()) <= POSITION * largest
    np.testing.assert_allclose(score, score_j, rtol=SCORE_EDGE)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_dryrun_multichip_runs_every_sharded_program(n):
    """The JAX dry run's noise timeline on n CPU shards: every sharded
    program once, with its shapes (the 2-D search where n is even and at
    least 4)."""
    out = graft_entry.dryrun_multichip(n, ["cpu"] * n)
    assert set(out) == PROGRAMS | ({"mode_search_2d"} if n == 4 else set())
    ema, frames, sync, score = out["reconstruct"]
    assert frames.shape == (n, 600, 800) and sync.shape == (n, 2) and score.shape == (n,)
    assert bool(torch.isfinite(ema).all()) and ema.device.type == "cpu"
    assert out["streaming"][1].shape == (n, 600, 800)
    assert len(out["combine"].weights) == n and out["welch"][1].shape == (256,)


def test_dryrun_takes_only_its_own_geometry():
    with pytest.raises(ValueError, match="iq must be"):
        graft_entry.dryrun_multichip(2, ["cpu"] * 2, iq=np.zeros((2, 10), np.complex64))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        graft_entry.entry()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        graft_entry.dryrun_multichip(2)


def test_main_runs_on_the_cpu(capsys):
    graft_entry.main(["--device", "cpu", "--devices", "2"])
    out = capsys.readouterr().out
    assert "entry: EMA (600, 800), frames (2, 600, 800) on cpu, finite True" in out
    assert "dryrun_multichip(2): reconstruct, batched" in out
