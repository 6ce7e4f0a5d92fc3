#!/usr/bin/env python3
"""The upload of a whole recording to the card: one pageable copy against
the staged copy of ``utils/device.py`` (chunks through a few reused pinned
blocks, filled by ``Tensor.copy_`` on the intra-op threads while the card
reads the previous chunk), on one card.

On 1.024 GB of random int16 words (512,000,000, the 8 s capture at 32 Msps),
each setting timed to the end of its copies (``torch.cuda.synchronize()``):

* ``current``: ``torch.from_numpy(x).to(device)``;
* ``staged``: every chunk size of ``CHUNKS_MB`` x blocks of ``BLOCKS`` x
  intra-op threads of ``THREADS`` (``0``: all the process has);
* the parts alone: the host's fill of one reused pinned block (no copy to
  the card), and one 1 GB pinned block to the card;
* ``cudaHostRegister`` of the caller's array for one call (register, the
  copy, unregister), for the record;
* the device time of the host-to-device copies of ``current`` and of the
  staged setting in use (``torch.profiler``);
* by size (4 MB to 512 MB), ``current`` against staged copies of chunks of
  ``SWEEP_CHUNKS_MB`` through the blocks in use, in turns, at all threads and
  at one: the size at which staging wins.  Each copy of the sweep reads
  another part of the 1 GB array than the one before it, so that its source
  is not left in the host's caches by the copy before (a recording handed
  over is read once).

Each staged result is held to the bit against ``current``'s.  Needs a CUDA
card:

    python3 exp/upload_staged.py [--out upload_staged.json] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tempest_tpu_torch.utils import device as dev_utils  # noqa: E402

WORDS = 512_000_000
CHUNKS_MB = (4, 8, 12, 16, 24, 32, 64)
BLOCKS = (2, 3, 4)
THREADS = (1, 2, 4, 0)
SIZES_MB = (4, 16, 32, 48, 64, 96, 128, 192, 256, 512)
SWEEP_CHUNKS_MB = (8, 12, 16, 32)
MB = 1 << 20


def _timed(fn, reps):
    """Seconds of each of ``reps`` calls of ``fn`` to the end of its device
    work, after one call not counted."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def _row(times, nbytes):
    med = statistics.median(times)
    return {"median_s": med, "min_s": min(times), "max_s": max(times),
            "gbps": nbytes / med / 1e9, "times_s": times}


def _staged(src, dst, chunk, blocks):
    plan = dev_utils.chunk_plan(src.numel(), chunk)
    return lambda: dev_utils._copy_chunks(src, dst, plan, blocks)


def _parts(total, n):
    """Offsets of ``n``-byte parts of ``total`` bytes, one after another,
    round and round."""
    k = max(total // n, 1)
    i = 0
    while True:
        yield (i % k) * n
        i += 1


def _rotating(src, dst, n, chunk, blocks, parts):
    """A staged copy of ``n`` bytes from the next part of ``src``."""
    plan = dev_utils.chunk_plan(n, chunk)

    def run():
        a = next(parts)
        dev_utils._copy_chunks(src[a:a + n], dst[:n], plan, blocks)

    return run


def _h2d_device_s(fn):
    """Device seconds of the host-to-device copies of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.events():
        if "Memcpy HtoD" in e.name:  # the harness's pattern (portbench/layers.json)
            total += e.time_range.elapsed_us()
    return total / 1e6


def _host_register(x, dev, reps):
    """Register the array, copy it, unregister it: the seconds of each."""
    cudart = torch.cuda.cudart()
    if not hasattr(cudart, "cudaHostRegister"):
        return {"error": "torch.cuda.cudart() has no cudaHostRegister"}
    src = torch.from_numpy(x)
    dst = torch.empty_like(src, device=dev)
    rows = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        rc = int(cudart.cudaHostRegister(src.data_ptr(), x.nbytes, 0))
        t1 = time.perf_counter()
        if rc != 0:
            return {"error": f"cudaHostRegister returned {rc}"}
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cudart.cudaHostUnregister(src.data_ptr())
        t3 = time.perf_counter()
        rows.append((t1 - t0, t2 - t1, t3 - t2))
    rows = rows[1:]
    reg, copy, unreg = ([r[i] for r in rows] for i in range(3))
    ok = bool(torch.equal(dst, src.to(dev)))
    total = [a + b + c for a, b, c in rows]
    return {"register": _row(reg, x.nbytes), "copy": _row(copy, x.nbytes),
            "unregister": _row(unreg, x.nbytes), "total": _row(total, x.nbytes), "equal": ok}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="upload_staged.json")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    all_threads = torch.get_num_threads()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cpu = next((ln.split(":", 1)[1].strip() for ln in open("/proc/cpuinfo")
                if ln.startswith("model name")), "?")
    caches = {}
    for d in sorted(Path("/sys/devices/system/cpu/cpu0/cache").glob("index*")):
        try:
            caches[f"L{(d / 'level').read_text().strip()} {(d / 'type').read_text().strip()}"] = (
                (d / "size").read_text().strip())
        except OSError:
            pass
    res = {"card": smi, "torch": torch.__version__, "cpu": cpu, "caches": caches,
           "cpus": os.cpu_count(),
           "intra_op_threads": all_threads, "bytes": 2 * WORDS,
           "in_use": {"chunk_mb": dev_utils.STAGED_CHUNK_BYTES / MB,
                      "blocks": dev_utils.STAGED_BLOCKS,
                      "min_mb": dev_utils.STAGED_MIN_BYTES / MB}}
    print(json.dumps({k: res[k] for k in ("card", "torch", "cpu", "caches", "cpus",
                                           "intra_op_threads")}))

    x = np.random.default_rng(7).integers(-20000, 20000, WORDS, dtype=np.int16)
    src = torch.from_numpy(x.view(np.uint8))
    ref = torch.from_numpy(x).to(dev)
    dst = torch.empty_like(ref)
    dst_b = dst.view(torch.uint8)

    def current():
        return torch.from_numpy(x).to(dev)

    res["current_first"] = _row(_timed(current, args.reps), x.nbytes)
    print("current", json.dumps({k: round(v, 4) for k, v in res["current_first"].items()
                                 if k != "times_s"}))

    grid = []
    for threads in THREADS:
        torch.set_num_threads(threads or all_threads)
        for chunk_mb in CHUNKS_MB:
            for blocks in BLOCKS:
                dst.zero_()
                row = _row(_timed(_staged(src, dst_b, chunk_mb * MB, blocks), args.reps), x.nbytes)
                row.update(threads=threads or all_threads, chunk_mb=chunk_mb, blocks=blocks,
                           equal=bool(torch.equal(dst, ref)))
                grid.append(row)
                print(f"staged threads={row['threads']} chunk={chunk_mb}MB blocks={blocks} "
                      f"{row['gbps']:.2f} GB/s median {row['median_s']:.4f} s equal {row['equal']}")
        block = torch.empty(16 * MB, dtype=torch.uint8, pin_memory=True)

        def fill():
            for a in range(0, src.numel(), block.numel()):
                b = min(a + block.numel(), src.numel())
                block[: b - a].copy_(src[a:b])

        row = _row(_timed(fill, args.reps), x.nbytes)
        row["threads"] = threads or all_threads
        res.setdefault("fill_only_16mb", []).append(row)
        print(f"fill only threads={row['threads']} {row['gbps']:.2f} GB/s")
    torch.set_num_threads(all_threads)
    res["staged_grid"] = grid

    pinned = torch.empty(x.nbytes, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(src)
    res["pinned_to_card"] = _row(_timed(lambda: dst_b.copy_(pinned, non_blocking=True),
                                        args.reps), x.nbytes)
    del pinned
    print(f"pinned 1 GB to the card {res['pinned_to_card']['gbps']:.2f} GB/s")

    res["host_register"] = _host_register(x, dev, 3)
    print("cudaHostRegister", json.dumps(res["host_register"], default=str)[:600])

    in_use = _staged(src, dst_b, dev_utils.STAGED_CHUNK_BYTES, dev_utils.STAGED_BLOCKS)
    try:
        res["h2d_device_s"] = {"current": _h2d_device_s(current), "staged": _h2d_device_s(in_use)}
    except Exception as e:  # a profiler that records no device time: say so, keep the rest
        res["h2d_device_s"] = {"error": repr(e)}
    print("h2d device s", res["h2d_device_s"])

    sweep = []
    for threads in (0, 1):
        torch.set_num_threads(threads or all_threads)
        for size_mb in SIZES_MB:
            n = size_mb * MB
            parts = _parts(x.nbytes, n)

            def pageable(n=n, parts=parts):
                a = next(parts)
                return torch.from_numpy(x.view(np.uint8)[a:a + n]).to(dev)

            sides = {"current": pageable}
            for c in SWEEP_CHUNKS_MB:
                sides[f"staged_{c}mb"] = _rotating(src, dst_b, n, min(c * MB, n),
                                                   dev_utils.STAGED_BLOCKS, parts)
            order = list(sides) + list(sides)[::-1]
            times = {k: [] for k in sides}
            for side in sides.values():
                _timed(side, 1)
            for _ in range(args.reps):
                for k in order:
                    times[k] += _timed(sides[k], 1)
            row = {"threads": threads or all_threads, "mb": size_mb,
                   **{k: _row(v, n) for k, v in times.items()}}
            print(f"size threads={row['threads']} {size_mb} MB: " + ", ".join(
                f"{k} {row[k]['gbps']:.2f}" for k in sides) + " GB/s")
            sweep.append(row)
    torch.set_num_threads(all_threads)
    res["by_size"] = sweep
    res["current_last"] = _row(_timed(current, args.reps), x.nbytes)
    print(f"current again {res['current_last']['gbps']:.2f} GB/s")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print("wrote", out)
    return 0 if all(r["equal"] for r in grid) else 2


if __name__ == "__main__":
    sys.exit(main())
