"""Every cell of BENCHMARK.json, driven at a small size on the CPU against the
plain reference: the program's run comes out correct, the control (the
reference in bfloat16 in the program's place) and each fault of the timed
path come out not correct, and the result line holds the keys it must.

    python -m pytest portbench/tests
"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import registry
from portbench.run import run_cell

SEED = 2**33 + 12345
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}
# Traffic keys that the harness reads itself (``run.py``), in any cell.
HARNESS_TRAFFIC = {"torch_threads"}


def cells() -> list[str]:
    """Every cell of BENCHMARK.json; a cell of several cards runs here over
    as many CPU shards."""
    return [w["name"] for w in registry.load().spec["workloads"]]


def run(name: str, seed: int, trace: bool = False, **kw):
    """One run of ``name`` on the CPU at its small size and window
    (``small/<cell>.json``)."""
    s = registry.small(name)
    return run_cell(name, seed, s["seconds"], trace, device="cpu", overrides=s, **kw)


@pytest.mark.parametrize("name", cells())
def test_every_cell_has_a_small_size_here(name):
    """``small/<cell>.json`` is there, and each key it overrides is a key of
    the cell's configuration or traffic file (or one the harness reads): a
    misspelt key would otherwise leave the full size in place unseen."""
    s = registry.small(name)
    assert set(s) == {"config", "traffic", "seconds"}, sorted(s)
    cell = registry.load().cell(name)
    assert set(s["config"]) <= set(cell.config), set(s["config"]) - set(cell.config)
    traffic = set(cell.traffic) | HARNESS_TRAFFIC
    assert set(s["traffic"]) <= traffic, set(s["traffic"]) - traffic
    assert s["seconds"] > 0


@pytest.mark.parametrize("name", cells())
def test_cell_runs_correct_against_the_reference(name):
    res, checks = run(name, SEED)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = registry.load().cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", cells())
def test_result_line_keys(name):
    res, _ = run(name, SEED + 1)
    res.pop("_loaded")
    line = json.loads(json.dumps(res))
    assert set(line) == KEYS
    assert list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["limit"] is not None


@pytest.mark.parametrize("name", cells())
def test_traced_run_reports_per_layer_metrics_only(name):
    res, _ = run(name, SEED + 2, True)
    assert res["correct"], res["checks"]
    cell = registry.load().cell(name)
    # On the CPU the device metrics read nothing; the host spans do.
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert not set(res["metrics"]) & {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name", cells())
def test_control_comes_out_not_correct(name):
    res, _ = run(name, SEED + 3, control=True)
    assert not res["correct"], res["checks"]


def _broken(fault: str):
    """A ``make_reconstruct_fn`` whose steps carry one fault."""
    from tempest_tpu_torch.pipeline import offline

    make = offline.make_reconstruct_fn

    def broken_make(config, device=None):
        step = make(config, device)

        def broken(iq, ema, alpha, *phase):
            ema_out, frames, sync, score = step(iq, ema, alpha, *phase)
            ema_in = torch.as_tensor(ema).to(ema_out.device, torch.float32)
            if fault == "state_unchanged":
                return ema_in.clone(), frames, sync, score
            if fault == "half_the_frames":
                half = frames.shape[0] // 2
                return offline.ema_fold(ema_in, frames[:half], alpha), frames, sync, score
            frames = frames.clone()
            h, w = frames.shape[1:]
            frames[-1, : h // 8, : w // 8] += 1.0 + frames.abs().max()
            return ema_out, frames, sync, score

        return broken

    return broken_make


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_frames", "answer_altered"])
@pytest.mark.parametrize("name", cells())
def test_fault_in_the_timed_path_comes_out_not_correct(name, fault, monkeypatch):
    from tempest_tpu_torch.parallel import sharded
    from tempest_tpu_torch.pipeline import offline
    from tempest_tpu_torch.runtime import stream

    broken = _broken(fault)
    for module in (offline, stream, sharded):
        monkeypatch.setattr(module, "make_reconstruct_fn", broken)
    res, _ = run(name, SEED + 4)
    assert not res["correct"], res["checks"]


def test_mesh_without_its_exchange_comes_out_not_correct(monkeypatch):
    """The EMA's gather between the cards left out: each shard sees only its
    own span's fold."""
    from tempest_tpu_torch.parallel.mesh import LocalCollectives

    def own_parts(self, parts, axis):
        return [torch.stack([p] * len(parts)) for p in parts]

    monkeypatch.setattr(LocalCollectives, "all_gather", own_parts)
    name = "live1080-mesh4"
    res, _ = run(name, SEED + 6)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", cells())
def test_cell_on_the_card(name):
    chips = registry.load().cell(name).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA card(s)")
    res, _ = run_cell(name, SEED + 5, 2.0, False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
