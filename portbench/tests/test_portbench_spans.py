"""The per-layer metrics read from the program's own spans and counters
(``tempest_tpu_torch.utils.profiling``): a traced run of each cell on the
CPU reports them when the tracer is on (``profiling.enable()``; on the card
the traced run's profiler turns it on) and leaves them out when it is off.

    python -m pytest portbench/tests
"""

from __future__ import annotations

import pytest

from portbench import registry
from portbench.tests.test_portbench_cells import SEED, cells, run


def span_metrics(name: str) -> set[str]:
    """The per-layer metrics of ``BENCHMARK.json`` read from the program's
    spans (``source`` ``program_span``) whose ``workloads`` list ``name``."""
    return {m["name"] for m in registry.load().spec["per_layer"]
            if m["source"] == "program_span" and name in m.get("workloads", ())}


@pytest.fixture
def tracer():
    from tempest_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def _traced(name: str, seed: int) -> dict:
    res, _ = run(name, seed, True)
    assert res["correct"], res["checks"]
    return res


def test_every_span_metric_is_a_per_layer_metric_of_its_cell():
    """Each ``program_span`` metric lists the cells it is read in, each an
    existing cell that reports its ``moves``, and has its reader."""
    bench = registry.load()
    workloads = set(cells())
    for m in bench.spec["per_layer"]:
        if m["source"] != "program_span":
            continue
        assert m.get("workloads"), m["name"]
        assert set(m["workloads"]) <= workloads, (m["name"], set(m["workloads"]) - workloads)
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        for name in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.cell(name).end_to_end}, (m["name"], name)
    for name in workloads:
        assert span_metrics(name) <= {m["name"] for m in bench.cell(name).per_layer}


@pytest.mark.parametrize("name", cells())
def test_traced_run_with_the_tracer_on_reports_the_span_metrics(name, tracer):
    tracer.enable()
    want = span_metrics(name)
    res = _traced(name, SEED + 20)
    got = {k: v["value"] for k, v in res["metrics"].items() if k in want}
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("name", cells())
def test_traced_run_with_the_tracer_off_leaves_them_out(name, tracer):
    res = _traced(name, SEED + 21)
    assert not set(res["metrics"]) & span_metrics(name)
