"""Finds what a run needs by the names in ``BENCHMARK.json``.

Every piece sits in a file of its own under ``portbench/``, so that a new
cell, configuration, entry or metric is a new file and no edit:

* ``configs/<config>.json``: a deployment (its source, sizes, ``assumed``,
  ``reduced``);
* ``traffic/<traffic>.json``: a traffic mix, the parameters its ``entry``
  reads;
* ``entries/<entry>.py``: one entry point of the port, driven
  (``prepare``, ``measure``, ``collect``, ``verify``);
* ``metrics/<metric>.py``: one metric's reader, ``read(run) -> float | None``;
* ``limits/<cell>.json``: the limit of each number a cell's check compares;
* ``small/<cell>.json``: the cell's size and window for the CPU tests;
* ``layers.json``: which device operations belong to which layer, and which
  functions of the port a traced run wraps in spans.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "Cell", "Benchmark", "load", "load_json", "load_module", "small"]

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, prefix: str):
    """Import the file ``path`` as a module of its own."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = f"portbench_{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    entry: object


def _for_cell(metrics: list, cell: str, end_to_end: list | None = None) -> list:
    """The metrics a cell reports: those that list it, or list no cells (a
    per-layer metric without a list goes where its ``moves`` is reported)."""
    names = {m["name"] for m in end_to_end} if end_to_end is not None else None
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif names is None or m.get("moves") in names:
            out.append(m)
    return out


@dataclasses.dataclass
class Benchmark:
    root: Path
    spec: dict       # BENCHMARK.json

    def cell(self, name: str, overrides: dict | None = None) -> Cell:
        """The cell ``name`` of ``BENCHMARK.json``; ``overrides`` ({"config": {...}, "traffic": {...}}) replace entries
        of its files (the CPU tests' small sizes)."""
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
        w = work[name]
        overrides = overrides or {}
        config = {**load_json(HERE / "configs" / f"{w['config']}.json"),
                  **overrides.get("config", {})}
        traffic = {**load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                   **overrides.get("traffic", {})}
        limits_path = HERE / "limits" / f"{name}.json"
        limits = load_json(limits_path)["limits"] if limits_path.is_file() else {}
        end_to_end = _for_cell(self.spec["end_to_end"], name)
        per_layer = _for_cell(self.spec["per_layer"], name, end_to_end)
        entry = load_module(HERE / "entries" / f"{traffic['entry']}.py", "entry")
        return Cell(name, int(w["chips"]), config, traffic, limits, end_to_end, per_layer,
                    entry)


def load(root: Path | None = None) -> Benchmark:
    """``BENCHMARK.json`` at the checkout's root (the parent of this
    package's folder)."""
    root = Path(root) if root is not None else HERE.parent
    return Benchmark(root, load_json(root / "BENCHMARK.json"))


def small(name: str) -> dict:
    """The CPU tests' small size of cell ``name``: ``{"config": {...},
    "traffic": {...}, "seconds": s}``, overrides of its configuration's and
    traffic's entries (``Benchmark.cell``'s ``overrides``) and the window."""
    path = HERE / "small" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no small size of cell {name!r}: no file {path}")
    return load_json(path)


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", "metric")


def layers() -> dict:
    return load_json(HERE / "layers.json")
