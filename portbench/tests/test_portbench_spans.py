"""The per-layer metrics read from the program's own spans and counters
(``tempest_tpu_torch.utils.profiling``): a traced run of each cell on the
CPU reports them when the tracer is on (``profiling.enable()``; on the card
the traced run's profiler turns it on) and leaves them out when it is off.

    python -m pytest portbench/tests
"""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.run import run_cell
from portbench.tests.test_portbench_cells import SECONDS, SEED, cells, small

SPAN_METRICS = {
    "capture640-auto": {"stage1_ms.capture", "readback_ms.capture", "readback_gbps.capture"},
    "live1080-resident": {"upload_cuts_ms.resident", "launch_ms.resident"},
    "live1080-mesh4": {"take_wait_ms.mesh4", "take_copy_ms.mesh4", "place_ms.mesh4"},
}


@pytest.fixture
def tracer():
    from tempest_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _traced(name: str, seed: int) -> dict:
    res, _ = run_cell(name, seed, SECONDS.get(name, 0.5), True, device="cpu",
                      overrides=small(name))
    assert res["correct"], res["checks"]
    return res


def test_every_span_metric_is_a_per_layer_metric_of_its_cell():
    for name in cells():
        per_layer = {m["name"] for m in registry.load().cell(name).per_layer}
        assert SPAN_METRICS[name] <= per_layer
        assert {m["name"] for m in registry.load().spec["per_layer"]
                if m["source"] == "program_span" and name in m["workloads"]} == SPAN_METRICS[name]


@pytest.mark.parametrize("name", cells())
def test_traced_run_with_the_tracer_on_reports_the_span_metrics(name, tracer):
    tracer.enable()
    res = _traced(name, SEED + 20)
    got = {k: v["value"] for k, v in res["metrics"].items() if k in SPAN_METRICS[name]}
    assert set(got) == SPAN_METRICS[name]
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("name", cells())
def test_traced_run_with_the_tracer_off_leaves_them_out(name, tracer):
    res = _traced(name, SEED + 21)
    assert not set(res["metrics"]) & SPAN_METRICS[name]
