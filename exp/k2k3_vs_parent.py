#!/usr/bin/env python3
"""K2 and K3 of this checkout against another checkout's (the parent
commit's), in one process on one card: the same bits, and the device time of
each, in turns (parent, this, this, parent).

The inputs are the smoke's: a 1920x1080 @ 60 Hz capture at 20 Msps (seed 33,
18 dB, int16 words) cut by K1 into 36 screens of 600x800 (one block), 144
(four blocks cut 2/3 of a block apart, the batched step's count) and the
mode search's 52 screens of 150x200 (26 candidates x 2 frames, captured from
``mode_search_static``).  The other checkout's package is loaded under
another name from its own directory and builds its kernels there.  Needs a
CUDA card:

    git archive <parent> | tar -x -C _checkout/parent
    python3 exp/k2k3_vs_parent.py --parent _checkout/parent [--out chiprun_out/vs_parent.json]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tempest_tpu_torch as tp  # noqa: E402
from tempest_tpu_torch.ops.resample_kernel import frames_to_screens_from_words  # noqa: E402
from tempest_tpu_torch.parallel import sharded  # noqa: E402
from tempest_tpu_torch.pipeline import offline as poff  # noqa: E402

ALPHA = 0.1
CALLS = 10          # calls a profiler window
BACK_TO_BACK = 50   # launches between two events


def load_other(root: Path, name: str = "tt_parent"):
    pkg = root / "tempest_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def device_ms(fn, names) -> float:
    """Device milliseconds a call of the named kernels takes (torch.profiler
    over CALLS calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and any(n in e.key for n in names)) / 1e3 / CALLS


def back_to_back_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(BACK_TO_BACK):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / BACK_TO_BACK)
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

    mode = tp.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    cfg = tp.ReconstructionConfig(sample_rate=20e6, mode=mode, n_frames=36, carry_phase=True,
                                  align_subpixel=True)
    spf, block = cfg.samples_per_frame, cfg.block_samples
    cut = int(round(block * 2 / 3))
    n = 3 * cut + block + int(np.ceil(spf)) + 1
    cap = tp.generate_iq(mode, 20e6, n, snr_db=18.0, seed=33)
    words = np.clip(np.round(cap.iq.view(np.float32) * 8192.0), -32768, 32767).astype(np.int16)
    words = torch.from_numpy(words).to(dev)
    starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, 36)).to(dev)
    raster = (int(np.floor(spf)), mode.height, mode.width, cfg.render_size)
    blocks = [frames_to_screens_from_words(words[2 * k * cut: 2 * (k * cut + block)], starts,
                                           *raster) for k in range(4)]
    screens = {36: blocks[0], 144: torch.cat(blocks).contiguous()}

    captured = []
    real = sharded.frame_sync

    def capture(s, *a, **k):
        captured.append(s.clone())
        return real(s, *a, **k)

    sharded.frame_sync = capture
    try:
        need = int(np.round(spf)) + int(np.floor(spf)) + 1
        z = torch.view_as_complex(words[: 2 * need].to(torch.float32).reshape(-1, 2))
        tp.mode_search_static(z, 20e6, 60.0, tp.candidate_modes(60.0, tol_hz=0.5), device=dev)
    finally:
        sharded.frame_sync = real
    screens[52] = captured[0]
    torch.cuda.synchronize()

    report = {"card": card, "k2_bits": {}, "k3_bits": {}, "device_ms": {}, "back_to_back_ms": {}}
    mods = {who: (importlib.import_module(f"{pkg}.ops.sync_kernel"),
                  importlib.import_module(f"{pkg}.ops.align_kernel"))
            for who, pkg in (("parent", old.__name__), ("this", "tempest_tpu_torch"))}
    k2 = {who: m[0].blanking_sync for who, m in mods.items()}
    k3 = {who: m[1].align_fold for who, m in mods.items()}
    for count, frames in screens.items():
        for subpixel in (False, True):
            a = k2["parent"](frames, subpixel=subpixel)
            b = k2["this"](frames, subpixel=subpixel)
            torch.cuda.synchronize()
            same = [bool(torch.equal(bits(x), bits(y))) for x, y in zip(a, b)]
            agree = sum(all(torch.equal(bits(x[i:i + 1]), bits(y[i:i + 1])) for x, y in zip(a, b))
                        for i in range(count))
            kind = "sub-pixel" if subpixel else "integer"
            key = f"{count} frames {tuple(frames.shape[1:])}, {kind}"
            report["k2_bits"][key] = {"s_y": same[0], "s_x": same[1], "score": same[2],
                                      "frames_equal": agree, "frames": count}
            print(f"[K2 vs parent] {key}: s_y {same[0]}, s_x {same[1]}, score {same[2]} "
                  f"(frames with all three equal: {agree} of {count})")
    frames36 = screens[36]
    s_sub = k2["this"](frames36, subpixel=True)
    s_int = k2["this"](frames36, subpixel=False)
    ema = frames36.mean(dim=0).contiguous()
    for align in ("integer", "linear", "cubic", None):
        s_y, s_x, _ = s_int if align == "integer" else s_sub
        a = k3["parent"](frames36, s_y, s_x, ema, ALPHA, align)
        b = k3["this"](frames36, s_y, s_x, ema, ALPHA, align)
        torch.cuda.synchronize()
        same = bool(torch.equal(a[0], b[0])) and bool(torch.equal(a[1], b[1]))
        report["k3_bits"][str(align)] = same
        print(f"[K3 vs parent] {align or 'fold only'}: aligned frames and EMA equal: {same}")

    cases = {
        "K2 sub-pixel, 36 frames": (k2, lambda f: f(frames36, subpixel=True),
                                    ("profiles_kernel", "search_kernel")),
        "K2b sub-pixel, 36 frames": (k2, lambda f: f(frames36, subpixel=True), ("search_kernel",)),
        "K2a, 36 frames": (k2, lambda f: f(frames36, subpixel=True), ("profiles_kernel",)),
        "K2 sub-pixel, 144 frames": (k2, lambda f: f(screens[144], subpixel=True),
                                     ("profiles_kernel", "search_kernel")),
        "K2 integer, 52 search frames": (k2, lambda f: f(screens[52], subpixel=False),
                                         ("profiles_kernel", "search_kernel")),
        "K3 linear + fold, 36 frames": (
            k3, lambda f: f(frames36, s_sub[0], s_sub[1], ema, ALPHA, "linear"),
            ("align_fold_kernel",)),
        "K3 fold only, 36 frames": (k3, lambda f: f(frames36, ema=ema, alpha=ALPHA, align=None),
                                    ("align_fold_kernel",)),
        "K3 linear + fold, 144 frames of 4 streams": (
            k3, lambda f: f(screens[144], *k2["this"](
                screens[144], subpixel=True)[:2], torch.stack([ema] * 4), ALPHA, "linear", 4),
            ("align_fold_kernel",)),
    }
    for label, (fns, call, names) in cases.items():
        dev_ms = {"parent": [], "this": []}
        b2b = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            dev_ms[who].append(device_ms(lambda: call(fns[who]), names))
            b2b[who].append(back_to_back_ms(lambda: call(fns[who])))
        report["device_ms"][label] = dev_ms
        report["back_to_back_ms"][label] = b2b
        print(f"[vs parent] {label}: device ms parent {dev_ms['parent'][0]:.4f} "
              f"{dev_ms['parent'][1]:.4f}, this {dev_ms['this'][0]:.4f} {dev_ms['this'][1]:.4f}; "
              f"back to back parent {b2b['parent'][0]:.4f} {b2b['parent'][1]:.4f}, this "
              f"{b2b['this'][0]:.4f} {b2b['this'][1]:.4f} (turns parent, this, this, parent), "
              f"on {card}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    ok = (all(all(v[k] for k in ("s_y", "s_x", "score")) for v in report["k2_bits"].values())
          and all(report["k3_bits"].values()))
    print(f"[vs parent] every bit the same: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
