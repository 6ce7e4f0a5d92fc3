#!/usr/bin/env python3
"""K1 of this checkout against another checkout's (the parent commit's), in
one process on one card: the same bits, and the time of each variant in
turns (parent, this, this, parent); the mode search through K1 over the
candidate set against the parent's launch per candidate.

The inputs: random int16 I/Q words (the bits do not depend on a capture)
onto 600x800 screens at two geometries: one 36-frame block of 1920x1080 @
60 Hz at 20 Msps (the slice's), with rounded cuts and with exact cuts
(per-frame residuals), 2 and 4 taps; and 11 frames of 640x480 @ 60 Hz at
32 Msps with rounded cuts and 4 taps (what ``auto_reconstruct`` launches on
the smoke's 0.2 s capture there, where its taps rule picks Catmull-Rom),
and 36 frames of it; each on the envelope, int16 and float32 words.  At 11
frames of 640x480 a launch is short enough that back to back measures the
wrapper's host time: its device time is the kernel's.  2 frames of 1080p60 at 20
Msps for the search over the 26 modes within 0.5 Hz of 60 Hz.  The other
checkout's package is loaded under another name from its own directory and
builds its kernels there.  Needs a CUDA card:

    git archive <parent> tempest_tpu_torch | tar -x -C _checkout/parent
    python3 exp/k1_vs_parent.py --parent _checkout/parent [--out k1_vs_parent.json]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tempest_tpu_torch as tp  # noqa: E402
from tempest_tpu_torch.ops import resample_kernel as rk  # noqa: E402
from tempest_tpu_torch.pipeline import offline as poff  # noqa: E402

CALLS = 10          # calls a profiler window
BACK_TO_BACK = 50   # launches between two events
KERNELS = ("tiles_kernel",)   # K1's kernels, both designs
# (mode, sample rate, frames, the (taps, residuals) variants timed there).
GEOMETRIES = {
    "1080p60, 20 Msps, 36 frames": ("1920x1080 @ 60Hz", 20e6, 36,
                                    ((2, False), (2, True), (4, False), (4, True))),
    "640x480, 32 Msps, 11 frames": ("640x480 @ 60Hz", 32e6, 11, ((4, False),)),
    "640x480, 32 Msps, 36 frames": ("640x480 @ 60Hz", 32e6, 36, ((4, False),)),
}


def load_other(root: Path, name: str = "tt_parent"):
    pkg = root / "tempest_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def device_ms(fn, names=KERNELS) -> float:
    """Device milliseconds of the named kernels a call of ``fn`` takes
    (torch.profiler over CALLS calls, the mean a recorded launch times the
    launches a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count and any(n in e.key for n in names)]
        count = sum(e.count for e in seen)
        if count:
            per_call = max(1, round(count / CALLS))
            return sum(e.self_device_time_total for e in seen) / 1e3 / count * per_call
    return float("nan")


def back_to_back_ms(fn, launches: int = BACK_TO_BACK) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def wall_ms(fn, calls: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    old = load_other(args.parent.resolve())
    ork = importlib.import_module(f"{old.__name__}.ops.resample_kernel")
    osharded = importlib.import_module(f"{old.__name__}.parallel.sharded")

    report = {"card": card, "bits": {}, "device_ms": {}, "back_to_back_ms": {}, "search": {}}
    mods = {"parent": ork, "this": rk}
    rng = np.random.default_rng(0)
    for where, (mode_name, fs, n_frames, variants) in GEOMETRIES.items():
        mode = tp.ALL_VIDEO_MODES[mode_name]
        spf = fs / mode.refresh
        frame_len = int(np.floor(spf))
        n = int(np.ceil(n_frames * spf)) + 1 + int(np.ceil(spf))
        words = torch.from_numpy(rng.integers(-20000, 20000, 2 * n).astype(np.int16)).to(dev)
        data = {"envelope": tp.am_envelope_from_iq(words), "int16 words": words,
                "float32 words": words.to(torch.float32)}
        rounded = torch.from_numpy(poff.carry_phase_starts(0.0, spf, n_frames)).to(dev)
        exact_starts, fracs = (torch.from_numpy(a).to(dev)
                               for a in poff.exact_cut_starts(1234.56, spf, n_frames))
        raster = (frame_len, mode.height, mode.width, (600, 800))
        geom = rk.screen_geometry(*raster, dev)

        def call(mod, word, taps, exact):
            fn = mod.frames_to_screens if word == "envelope" else mod.frames_to_screens_from_words
            if exact:
                return fn(data[word], exact_starts, *raster, fracs, taps)
            return fn(data[word], rounded, *raster, None, taps)

        for taps, exact in variants:
            for word in data:
                label = f"{where}: {word}, {taps} taps" + (", residuals" if exact else "")
                a = call(ork, word, taps, exact)
                b = call(rk, word, taps, exact)
                ref = rk.frames_to_screens_plain(
                    data["envelope"], exact_starts if exact else rounded, geom,
                    fracs if exact else None, taps)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b)) and bool(torch.equal(b, ref))
                report["bits"][label] = same
                del a, b, ref
                dev_ms = {"parent": [], "this": []}
                b2b = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent"):
                    dev_ms[who].append(device_ms(lambda: call(mods[who], word, taps, exact)))
                    b2b[who].append(back_to_back_ms(lambda: call(mods[who], word, taps, exact)))
                report["device_ms"][label] = dev_ms
                report["back_to_back_ms"][label] = b2b
                print(f"[K1 vs parent] {label}: parent, this and plain equal: {same}; device "
                      f"ms parent {dev_ms['parent'][0]:.4f} {dev_ms['parent'][1]:.4f}, this "
                      f"{dev_ms['this'][0]:.4f} {dev_ms['this'][1]:.4f}; back to back parent "
                      f"{b2b['parent'][0]:.4f} {b2b['parent'][1]:.4f}, this "
                      f"{b2b['this'][0]:.4f} {b2b['this'][1]:.4f} (turns parent, this, this, "
                      f"parent), on {card}")

    # The mode search: parent (a launch per candidate) against this (one).
    cands = tp.candidate_modes(60.0, tol_hz=0.5)
    spf = 20e6 / 60.0
    need = int(np.round(spf)) + int(np.floor(spf)) + 1
    words = torch.from_numpy(rng.integers(-20000, 20000, 2 * need).astype(np.int16)).to(dev)
    z = torch.view_as_complex(words[: 2 * need].to(torch.float32).reshape(-1, 2))
    searches = {"parent": osharded.mode_search_static, "this": tp.mode_search_static}
    res = {who: fn(z, 20e6, 60.0, cands) for who, fn in searches.items()}
    same = bool(np.array_equal(res["parent"].scores, res["this"].scores))
    ms = {"parent": [], "this": []}
    k1 = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        ms[who].append(wall_ms(lambda: searches[who](z, 20e6, 60.0, cands)))
        k1[who].append(device_ms(lambda: searches[who](z, 20e6, 60.0, cands)))
    report["search"] = {"scores_equal": same, "wall_ms": ms, "k1_device_ms": k1,
                        "winner": [res[w].names[res[w].best_index] for w in res]}
    print(f"[search vs parent] 26 candidates, 2 frames at 150x200: scores equal: {same}, "
          f"winners {report['search']['winner']}; wall ms parent {ms['parent']}, this "
          f"{ms['this']}; K1 device ms a search parent {k1['parent']}, this {k1['this']}, "
          f"on {card}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    ok = all(report["bits"].values()) and same
    print(f"[K1 vs parent] every bit the same: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
