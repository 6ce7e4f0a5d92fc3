"""The port's device meshes (``parallel.mesh``, ``parallel.distributed``):
the five collectives against numpy, the refusals, the sharded Welch
estimator against the JAX package's on its 8-device CPU mesh, and one run of
two gloo ranks that hold the process-group backend against the one-process
mesh.

Tolerances: the collectives move and add float32 values in shard order, so
they equal numpy's float32 arithmetic in the same order, to the bit; the
mean divides that sum.  The sharded Welch estimate sums the same per-segment
spectra in another order than the single-device one, and pocketfft's and
XLA's FFTs differ by float32 rounding: 1e-3 dB, the JAX test's own bound
(``tests/test_pipeline.py::test_sharded_welch_matches_single``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tempest_tpu_torch as tp
from tempest_tpu_torch.parallel import distributed
from tempest_tpu_torch.parallel.mesh import block_sharding, make_mesh, replicated

ROOT = Path(__file__).resolve().parents[1]
SHAPE_2D = {"blocks": 2, "modes": 4}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _parts(n, seed=0, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _expected(op, grid, axis_pos, coords):
    """numpy's answer for the shard at ``coords`` of ``grid`` (mesh axes
    first, then the part's own axes), along mesh axis ``axis_pos``."""
    line = []
    for t in range(grid.shape[axis_pos]):
        c = list(coords)
        c[axis_pos] = t
        line.append(grid[tuple(c)])
    if op == "from_next":
        return line[(coords[axis_pos] + 1) % len(line)]
    if op == "all_gather":
        return np.stack(line)
    acc = line[0].copy()
    for x in line[1:]:
        acc = np.minimum(acc, x) if op == "all_reduce_min" else acc + x
    return acc / np.float32(len(line)) if op == "mean" else acc


@pytest.mark.parametrize("axis", list(SHAPE_2D))
@pytest.mark.parametrize("op", ["from_next", "all_gather", "all_reduce_sum", "all_reduce_min",
                                "mean"])
def test_collectives_match_numpy_along_each_axis_of_a_2d_mesh(op, axis):
    mesh = make_mesh(SHAPE_2D, devices=["cpu"] * 8)
    parts = _parts(8, seed=3)
    got = getattr(mesh.comm, op)([torch.from_numpy(p) for p in parts], axis)
    grid = np.stack(parts).reshape(2, 4, 3, 5)
    for k in range(8):
        assert got[k].device.type == "cpu"
        want = _expected(op, grid, list(SHAPE_2D).index(axis), np.unravel_index(k, (2, 4)))
        np.testing.assert_array_equal(got[k].numpy(), want)


def test_traffic_counts_what_each_shard_receives():
    mesh = make_mesh(4, devices=["cpu"] * 4)
    parts = [torch.ones(10) for _ in range(4)]
    mesh.comm.from_next(parts, "blocks")
    mesh.comm.all_gather(parts, "blocks")
    mesh.comm.all_reduce_sum(parts, "blocks")
    mesh.gather(parts, "blocks")
    assert mesh.comm.calls == {"from_next": 1, "all_gather": 2, "all_reduce_sum": 1}
    # 4 shards of 40 bytes: one neighbour each, three peers each; the gather
    # onto the first shard's device brings the other three.
    assert mesh.comm.nbytes == {"from_next": 160, "all_gather": 480 + 120, "all_reduce_sum": 480}
    mesh.comm.reset()
    assert not mesh.comm.calls and not mesh.comm.nbytes


def test_mesh_shape_coordinates_and_gather():
    mesh = make_mesh(SHAPE_2D, devices=["cpu"] * 8)
    assert mesh.shape == SHAPE_2D and mesh.size == 8 and mesh.axis_names == ("blocks", "modes")
    assert [mesh.coord(k, "blocks") for k in range(8)] == [0] * 4 + [1] * 4
    assert [mesh.coord(k, "modes") for k in range(8)] == [0, 1, 2, 3] * 2
    parts = [torch.full((2,), float(k)) for k in range(8)]
    # Split along "modes", replicated along "blocks": the first row of shards.
    np.testing.assert_array_equal(mesh.gather(parts, "modes").numpy(), np.repeat([0, 1, 2, 3], 2))
    np.testing.assert_array_equal(mesh.gather(parts, "blocks").numpy(), [0, 0, 4, 4])
    assert "one process" in repr(mesh)


def test_block_sharding_and_replicated_lay_a_host_array_onto_the_shards():
    mesh = make_mesh(SHAPE_2D, devices=["cpu"] * 8)
    x = np.arange(2 * 3, dtype=np.float32).reshape(2, 3)
    rows = block_sharding(mesh, "blocks").place(x)
    assert len(rows) == 8
    for k, row in enumerate(rows):
        np.testing.assert_array_equal(row.numpy(), x[mesh.coord(k, "blocks")])
    for copy in replicated(mesh).place(torch.from_numpy(x)):
        np.testing.assert_array_equal(copy.numpy(), x)


def test_make_mesh_takes_named_devices_and_refuses_what_is_not_there(monkeypatch):
    mesh = make_mesh(3, devices=["cpu"] * 5)
    assert mesh.shape == {"blocks": 3} and len(mesh.devices) == 3
    assert make_mesh(devices=["cpu", "cpu"], axis_name="modes").shape == {"modes": 2}
    with pytest.raises(ValueError, match="4 shards asked for, 2 devices"):
        make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, devices=["cpu"])
    # Without a card, and with fewer cards than shards: no quiet fallback.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 CUDA card"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="sees 0"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 CUDA card.*sees 1"):
        make_mesh(4)
    assert make_mesh(1).devices == [torch.device("cuda", 0)]


def test_initialize_refuses_without_a_card_or_an_address(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="found none.*device='cpu'"):
        distributed.initialize("localhost:1", 1, 0)
    with pytest.raises(ValueError, match="no coordinator address"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        distributed.initialize("localhost:1", device="cpu")
    assert not dist.is_initialized() and not distributed.is_distributed()
    # Without a process group, global_mesh is the one-process mesh of cards.
    with pytest.raises(RuntimeError, match="CUDA card"):
        distributed.global_mesh()


def test_sharded_welch_matches_jax_and_the_single_device_welch():
    jspec = pytest.importorskip("tempest_tpu.ops.spectrum")
    jmesh = pytest.importorskip("tempest_tpu.parallel.mesh")
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    sig = (rng.standard_normal(32768) + 1j * rng.standard_normal(32768)).astype(np.complex64)
    mesh = make_mesh(8, devices=["cpu"] * 8)
    f, p = tp.get_welch_sharded(1e6, sig, mesh, fft_size=1024)
    f1, p1 = tp.get_welch(1e6, sig, fft_size=1024, device="cpu")
    fj, pj = jspec.get_welch_sharded(1e6, jnp.asarray(sig), jmesh.make_mesh(8), fft_size=1024)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-3)
    np.testing.assert_allclose(p.numpy(), p1.numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="too short"):
        tp.get_welch_sharded(1e6, sig[:1000], mesh, fft_size=1024)


# ----------------------------------------------- two ranks of a process group
_RANK_MAIN = r"""
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world),
                  RANK=str(rank))
import tempest_tpu_torch as tp
from tempest_tpu_torch.parallel import distributed

distributed.initialize(device="cpu")
mesh = distributed.global_mesh()
assert distributed.is_distributed() and mesh.local == [rank]
rng = np.random.default_rng(3)
parts = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(world)]
mine = [torch.from_numpy(parts[rank])]
res = {op: getattr(mesh.comm, op)(mine, "blocks")[0].numpy()
       for op in ("from_next", "all_gather", "all_reduce_sum", "all_reduce_min", "mean")}
res["gather"] = mesh.gather(mine, "blocks").numpy()
mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
cfg = tp.ReconstructionConfig(sample_rate=4e6, mode=mode, n_frames=1, render_size=(30, 40),
                              carry_phase=True, input_format="iq_interleaved",
                              align_subpixel=True)
S = 200_000
iq = tp.generate_iq(mode, 4e6, world * S + 10, snr_db=20.0, seed=4).iq
rows = iq[: world * S].view(np.float32).reshape(world, 2 * S)
tail = np.ascontiguousarray(iq[world * S: world * S + 1]).view(np.float32)
step = tp.sharded_streaming_reconstruct_fn(cfg, mesh, S)
ema, frames, sync, score = step(rows, tail, np.zeros((30, 40), np.float32), 0.5,
                                [(-(d * S)) % cfg.samples_per_frame for d in range(world)])
res.update(ema=ema.numpy(), frames=frames.numpy(), sync=sync.numpy())
res["traffic"] = np.array(json.dumps(dict(mesh.comm.nbytes)))
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
torch.distributed.destroy_process_group()
""".replace("import os, sys", "import json, os, sys")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_give_the_one_process_mesh_s_results(tmp_path):
    """Two processes, one gloo rank and one torch thread each, started as
    torchrun would (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``): every rank gets the replicated results of the collectives and
    of the streaming step, equal to the one-process mesh's to the bit (a sum
    of two parts has one order)."""
    world, port = 2, str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_MAIN, str(r), str(world), port,
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]

    mesh = make_mesh(world, devices=["cpu"] * world)
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
             for _ in range(world)]
    for op in ("from_next", "all_gather", "all_reduce_sum", "all_reduce_min", "mean"):
        want = getattr(mesh.comm, op)(parts, "blocks")
        for r in range(world):
            np.testing.assert_array_equal(got[r][op], want[r].numpy(), err_msg=op)
    for r in range(world):
        np.testing.assert_array_equal(got[r]["gather"], mesh.gather(parts, "blocks").numpy())

    mode = tp.ALL_VIDEO_MODES["640x480 @ 60Hz"]
    cfg = tp.ReconstructionConfig(sample_rate=4e6, mode=mode, n_frames=1, render_size=(30, 40),
                                  carry_phase=True, input_format="iq_interleaved",
                                  align_subpixel=True)
    S = 200_000
    iq = tp.generate_iq(mode, 4e6, world * S + 10, snr_db=20.0, seed=4).iq
    step = tp.sharded_streaming_reconstruct_fn(cfg, mesh, S)
    ema, frames, sync, _ = step(
        iq[: world * S].view(np.float32).reshape(world, 2 * S),
        np.ascontiguousarray(iq[world * S: world * S + 1]).view(np.float32),
        np.zeros((30, 40), np.float32), 0.5,
        [(-(d * S)) % cfg.samples_per_frame for d in range(world)])
    for r in range(world):
        np.testing.assert_array_equal(got[r]["ema"], ema.numpy())
        np.testing.assert_array_equal(got[r]["frames"], frames.numpy())
        np.testing.assert_array_equal(got[r]["sync"], sync.numpy())
        # Each rank received its neighbour's (3, 5) part and then its 1-sample
        # halo (two float32 words), and in the step the other rank's B image
        # and its frames, sync and score.
        traffic = json.loads(str(got[r]["traffic"]))
        assert traffic["from_next"] == 60 + 8
        assert traffic["all_gather"] == 60 + 60 + 4 * 30 * 40 * (1 + frames.shape[0] // 2) + 8 + 4
