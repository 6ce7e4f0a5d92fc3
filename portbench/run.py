"""One run of one cell, as the check calls it:

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's inputs from the seed, builds and warms the port's entry
point (set-up, ``setup_s``), measures for ``--seconds`` (``--trace 0``) or
profiles a short steady window (``--trace 1``), reads the peak device memory,
frees the program's state, and holds a seeded sample of what the window
produced against the plain reference.  It prints each compared number beside
its limit as the last lines of standard error, and one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``.

It exits with another code than 0 and prints no result where there is no
CUDA card, fewer cards than the cell asks for, or where JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

__all__ = ["run_cell", "main"]


def _power_limit_w(index: int) -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _device_fields(device, chips: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": chips,
            "memory_peak_bytes": peak, "power_limit_w": _power_limit_w(index)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             t_start: float | None = None, overrides: dict | None = None,
             control: bool = False) -> tuple[dict, list]:
    """One run of cell ``name``: (result line, checks).  ``device`` defaults
    to the card; the CPU tests pass ``"cpu"`` and small ``overrides``.
    ``control=True`` puts the reference, in the next precision below the
    configuration's, in the program's place for the check (the control's
    readings; the benchmark's own runs never do); ``control="both"`` checks
    the program and adds the control's readings on the same sample under
    ``control_checks``."""
    import torch

    from . import registry
    from .harness import Context, forbidden_modules
    from .readings import Run
    from .tracing import Profile, Spans, breakdown, busy_seconds

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device if device is not None else "cuda")
    cell = registry.load().cell(name, overrides)
    layers = registry.layers()
    spans = Spans(device, trace)
    if trace:
        spans.wrap_functions(layers["spans"])
    ctx = Context(device, int(seed), cell.config, cell.traffic, spans)
    entry = cell.entry
    # A host-paced cell may ask for one intra-op thread: no idle pool
    # beside the thread that issues the steps.
    threads = torch.get_num_threads()
    try:
        if cell.traffic.get("torch_threads"):
            torch.set_num_threads(int(cell.traffic["torch_threads"]))
        state = entry.prepare(ctx)
        ctx.fence()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        profile = Profile(device, trace)
        with profile.window():
            rec = entry.measure(ctx, state, None if trace else float(seconds))
        peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        loaded = forbidden_modules()
        answers = entry.collect(ctx, state)
    finally:
        spans.unwrap()
        torch.set_num_threads(threads)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    control_readings = (entry.verify(ctx, entry.control(ctx, answers))
                        if control == "both" else None)
    if control is True:
        answers = entry.control(ctx, answers)
    readings = entry.verify(ctx, answers)

    checks = [{"name": k, "value": v, "limit": cell.limits.get(k)} for k, v in readings.items()]
    correct = bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                   for c in checks)
    window_us = profile.window_us
    if window_us is None and profile.device_ops:
        window_us = (min(op[1] for op in profile.device_ops),
                     max(op[2] for op in profile.device_ops))
    run = Run(window_s=rec["window_s"], items=rec["items"], spans=dict(spans.seconds),
              layers=layers, work=rec.get("work", {}), traced=trace,
              device_ops=profile.device_ops, window_us=window_us, setup_s=setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = registry.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = _device_fields(device, cell.chips, peak)
    result = {"correct": correct, "attempted": int(rec["attempted"]),
              "failed": int(rec["attempted"]) - run.count, "metrics": metrics, "device": dev}
    if trace:
        if window_us is not None:
            dev["busy_s"] = busy_seconds(profile.device_ops, window_us)
            dev["window_s"] = (window_us[1] - window_us[0]) * 1e-6
        bd = breakdown(profile)
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    if control_readings is not None:
        result["control_checks"] = control_readings
    result["_loaded"] = loaded
    return result, checks


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from . import registry

    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 3
    chips = registry.load().cell(args.workload).chips
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    from .harness import forbidden_modules

    loaded = sorted(set(result.pop("_loaded")) | set(forbidden_modules()))
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for c in checks:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
