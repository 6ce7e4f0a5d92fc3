"""The readings the limits are set from: the program's and the control's, on
many seeds of one cell, in one process (the set-up's imports and kernel loads
paid once).

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --first <seed> \\
        --seconds 2 [--trace-every 4]

One JSON line a seed: ``seed``, ``correct``, ``checks`` (the program's
numbers), ``control`` (the reference in bfloat16 in the program's place, on
the same sampled answers), ``metrics``.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from .run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace-every", type=int, default=0,
                    help="every Nth seed runs traced (0: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    for k in range(args.seeds):
        seed = args.first + 7919 * k
        trace = bool(args.trace_every) and k % args.trace_every == 0
        t0 = time.perf_counter()
        res, _ = run_cell(args.workload, seed, args.seconds, trace, control="both")
        line = {"seed": seed, "trace": trace, "wall_s": time.perf_counter() - t0,
                "correct": res["correct"],
                "checks": {n: c["value"] for n, c in res["checks"].items()},
                "control": res["control_checks"], "metrics": res["metrics"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "loaded": res["_loaded"]}
        for key in ("busy_s", "window_s"):
            if key in res["device"]:
                line[key] = res["device"][key]
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
