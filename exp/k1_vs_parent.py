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
and 36 frames of it; each on the envelope, and on int16 and float32 words
under every load of K1's words entry (``LOADS``: AM, FM, each with and
without the bfloat16 rounding, and each inverted by the block maximum; with
residuals AM and FM).  The block maximum (``words_maxima``) alone on each
geometry's words, int16 and float32, AM and FM.  At 11 frames of
640x480 a launch is short enough that back to back measures the wrapper's
host time: its device time is the kernel's.  2 frames of 1080p60 at 20
Msps for the search over the 26 modes within 0.5 Hz of 60 Hz.  Last, the
SASS of every K1 instantiation of the two libraries, function by function:
the ones whose code did not change are listed as the same.  The other
checkout's package is loaded under another name from its own directory and
builds its kernels there.  Needs a CUDA card:

    git archive <parent> tempest_tpu_torch | tar -x -C _checkout/parent
    python3 exp/k1_vs_parent.py --parent _checkout/parent [--out k1_vs_parent.json]
                                [--only-int16-fm] [--match TEXT] [--rounds N]

``--match TEXT`` times only the rows whose label holds TEXT (``--match FM``:
the FM loads and the FM block maxima), ``--rounds`` sets the turns a row.
Each row's turns run ``ROUNDS`` times (one side's turns spread by up to 1-2%,
as much as the 2% a row is held to); the ratios printed are of the medians,
and the last line names the rows more than 2% slower than the parent's in
both device and back-to-back time.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import json
import re
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
ROUNDS = 3          # turns of parent, this, this, parent a row
KERNELS = ("tiles_kernel",)   # K1's kernels, both designs
# (demod, bfloat16 rounding, inversion) of each load of the words entry
# timed, with rounded cuts and, with residuals, the loads neither rounded
# nor inverted.  An inverted launch is the block maximum's and K1's: the
# device time is K1's, back to back both.
LOADS = (("am", False, False), ("am", True, False), ("fm", False, False), ("fm", True, False),
         ("am", False, True), ("fm", False, True))
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


def sass_functions(path: str) -> dict[str, list[str]]:
    """Each function of a library's SASS (cuobjdump), its instructions
    without their addresses and encodings."""
    from tempest_tpu_torch import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    listing = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True, text=True,
                             check=True).stdout
    out, name = {}, None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # The anonymous namespace's name carries a hash of the source.
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "(anonymous)", m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            out[name].append(m.group(1))
    return out


def parent_name(name: str, old: dict) -> str:
    """The parent's instantiation that ``name`` stands for: itself, or where
    the parent's kernels lack the last template flag and argument (``kStreams``
    and ``Streams``, the thirteenth slice) and the flag is false, the name
    without them."""
    if name in old:
        return name
    return name.replace("ELb0EEEvPKvPfNS_8GeometryENS_7StreamsE", "EEEvPKvPfNS_8GeometryE")


def sass_compare(parent_path: str, this_path: str) -> dict[str, str]:
    """For each K1 instantiation of this library: "same" where its SASS is the
    parent's instruction for instruction, else how many instructions each has."""
    old, new = sass_functions(parent_path), sass_functions(this_path)
    out = {}
    for k, v in new.items():
        was = old.get(parent_name(k, old))
        out[k] = ("same" if was == v else
                  f"{len(was) if was is not None else 'none'} -> {len(v)} instructions")
    return out


def listed(xs) -> str:
    return " ".join(f"{x:.4f}" for x in xs)


def ratio(times: dict) -> float:
    """This checkout's median over the parent's, less 1 (a profiler window
    that recorded no launch, NaN, left out)."""
    return float(np.nanmedian(times["this"]) / np.nanmedian(times["parent"]) - 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--only-int16-fm", action="store_true",
                    help="time the int16 FM loads alone (the SASS comparison still covers all)")
    ap.add_argument("--match", default=None,
                    help="time only the rows whose label holds this text")
    ap.add_argument("--rounds", type=int, default=ROUNDS, help="turns a row")
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

        def call(mod, word, taps, exact, load):
            starts, res = (exact_starts, fracs) if exact else (rounded, None)
            if word == "envelope":
                return mod.frames_to_screens(data[word], starts, *raster, res, taps)
            return mod.frames_to_screens_from_words(data[word], starts, *raster, res, taps,
                                                    demod=load[0], bf16=load[1], invert=load[2])

        for taps, exact in variants:
            for word, load in [("envelope", ("am", False, False))] + [
                    (w, ld) for w in ("int16 words", "float32 words") for ld in LOADS
                    if not (exact and (ld[1] or ld[2]))]:
                if args.only_int16_fm and (word, load[0]) != ("int16 words", "fm"):
                    continue
                label = (f"{where}: {word}"
                         + (f", {load[0].upper()}{' bf16' * load[1]}{' inverted' * load[2]}"
                            if word != "envelope" else "")
                         + f", {taps} taps" + (", residuals" if exact else ""))
                if args.match is not None and args.match not in label:
                    continue
                a = call(ork, word, taps, exact, load)
                b = call(rk, word, taps, exact, load)
                env = (data["envelope"] if word == "envelope"
                       else rk.words_envelope_plain(data[word], *load))
                ref = rk.frames_to_screens_plain(
                    env, exact_starts if exact else rounded, geom, fracs if exact else None, taps)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b)) and bool(torch.equal(b, ref))
                report["bits"][label] = same
                del a, b, ref, env
                dev_ms = {"parent": [], "this": []}
                b2b = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent") * args.rounds:
                    fn = functools.partial(call, mods[who], word, taps, exact, load)
                    dev_ms[who].append(device_ms(fn))
                    b2b[who].append(back_to_back_ms(fn))
                report["device_ms"][label] = dev_ms
                report["back_to_back_ms"][label] = b2b

                print(f"[K1 vs parent] {label}: parent, this and plain equal: {same}; device "
                      f"ms parent {listed(dev_ms['parent'])}, this {listed(dev_ms['this'])} "
                      f"({ratio(dev_ms):+.3f}); back to back parent {listed(b2b['parent'])}, "
                      f"this {listed(b2b['this'])} ({ratio(b2b):+.3f}) (turns parent, this, "
                      f"this, parent, {args.rounds} a row; medians), on {card}")

        # The block maximum alone on this geometry's words (one stream).
        for word in ("int16 words", "float32 words"):
            for demod in ("am", "fm"):
                if args.only_int16_fm and (word, demod) != ("int16 words", "fm"):
                    continue
                label = f"{where}: block maximum, {word}, {demod.upper()}"
                if args.match is not None and args.match not in label:
                    continue
                a = ork.words_maxima(data[word], demod)
                b = rk.words_maxima(data[word], demod)
                ref = rk.words_maxima_plain(data[word], demod)
                torch.cuda.synchronize()
                same = bool(torch.equal(a, b)) and bool(torch.equal(b, ref))
                report["bits"][label] = same
                dev_ms = {"parent": [], "this": []}
                b2b = {"parent": [], "this": []}
                for who in ("parent", "this", "this", "parent") * args.rounds:
                    fn = functools.partial(mods[who].words_maxima, data[word], demod)
                    dev_ms[who].append(device_ms(fn, ("words_max_kernel",)))
                    b2b[who].append(back_to_back_ms(fn))
                report["device_ms"][label] = dev_ms
                report["back_to_back_ms"][label] = b2b
                print(f"[K1 vs parent] {label}: parent, this and plain equal: {same}; device "
                      f"ms parent {listed(dev_ms['parent'])}, this {listed(dev_ms['this'])} "
                      f"({ratio(dev_ms):+.3f}); back to back parent {listed(b2b['parent'])}, "
                      f"this {listed(b2b['this'])} ({ratio(b2b):+.3f}) (turns parent, this, "
                      f"this, parent, {args.rounds} a row; medians), on {card}")

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
    report["sass"] = sass_compare(
        importlib.import_module(f"{old.__name__}._build").load_library("resample").path,
        importlib.import_module("tempest_tpu_torch._build").load_library("resample").path)
    changed = [k for k, v in report["sass"].items() if v != "same"]
    print(f"[K1 vs parent] SASS: {len(report['sass']) - len(changed)} of "
          f"{len(report['sass'])} instantiations the same as the parent's; changed or new: "
          f"{changed}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    ok = all(report["bits"].values()) and same
    slower = {label: (round(ratio(report["device_ms"][label]), 4),
                      round(ratio(report["back_to_back_ms"][label]), 4))
              for label in report["device_ms"]
              if min(ratio(report["device_ms"][label]),
                     ratio(report["back_to_back_ms"][label])) > 0.02}
    print(f"[K1 vs parent] every bit the same: {ok}; rows more than 2% slower than the parent "
          f"in both device and back-to-back time (medians): {slower or 'none'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
