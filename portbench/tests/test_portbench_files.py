"""The benchmark's files: BENCHMARK.json's entries each find their file by
name, every name and unit is of the allowed characters, a run loads no JAX
and no JAX package, and the reference loads nothing of the port.

    python -m pytest portbench/tests
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from portbench import registry

ROOT = registry.HERE.parent
SPEC = registry.load().spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tempest_tpu"}


def _modules_after(code: str) -> set[str]:
    """Top-level names in sys.modules after ``code`` runs in a fresh process."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_units_and_files():
    spec = SPEC
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in spec["workloads"]] + [
        c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert registry.load_json(ROOT / c["file"])["name"] == c["name"]
    configs = {c["name"] for c in SPEC["configs"]}
    for w in spec["workloads"]:
        assert w["config"] in configs
        traffic = registry.load_json(registry.HERE / "traffic" / f"{w['traffic']}.json")
        assert (registry.HERE / "entries" / f"{traffic['entry']}.py").is_file()
        assert (registry.HERE / "limits" / f"{w['name']}.json").is_file()
        assert (registry.HERE / "small" / f"{w['name']}.json").is_file()


def test_every_cell_reports_setup_and_another_metric_and_a_layer_metric():
    for w in SPEC["workloads"]:
        cell = registry.load().cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _modules_after(
        "from portbench import registry\n"
        "from portbench.run import run_cell\n"
        "run_cell('live1080-resident', 7, 0.3, False, device='cpu', "
        "overrides=registry.small('live1080-resident'))")
    assert "tempest_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules_after(
        "import torch\n"
        "from portbench.reference import chain, restore, timing\n"
        "from portbench.capture import CaptureSpec, capture_words\n"
        "spec = CaptureSpec(800, 525, 60.0, 2e6)\n"
        "w = capture_words(spec, 200000, 3, 'cpu')\n"
        "timing.estimate_timing(w, 2e6)\n"
        "g = chain.geometry(33333, 525, 800, (60, 80))\n"
        "env = chain.envelope(w)\n"
        "chain.chain(env, chain.static_starts(2e6 / 60, 3), None, g, "
        "torch.zeros(60, 80), 0.1)\n")
    assert not loaded & (FORBIDDEN | {"tempest_tpu_torch"})


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_inputs_are_the_seeds(seed):
    from portbench.capture import CaptureSpec, capture_words

    spec = CaptureSpec(800, 525, 60.0, 2e6)
    a = capture_words(spec, 50000, seed, "cpu")
    b = capture_words(spec, 50000, seed, "cpu")
    c = capture_words(spec, 50000, seed + 1, "cpu")
    assert a.dtype.is_floating_point is False and a.shape == (100000,)
    assert bool((a == b).all()) and not bool((a == c).all())
