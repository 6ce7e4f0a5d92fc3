#!/usr/bin/env python3
"""Where K2b's time goes: ``clock64()`` stamps taken inside the sync kernel
(``tempest_tpu_torch/csrc/sync.cu``) on the smoke's block, 36 screens of
600x800 cut from a 1920x1080 @ 60 Hz capture at 20 Msps (seed 33, 18 dB,
int16 words, as ``chip_smoke.py`` makes it), and on the mode search's 52
screens of 150x200.

For each stamp the kernel names (``sync_kernel.clock_stamps``) it prints the
median over the frames of the cycles since the stamp before, per axis, and
that many cycles in microseconds at the SM clock ``nvidia-smi`` reads right
after the run (each frame's two axis leaders stamp), and the global timer's
spread of the leaders' starts and ends; the cluster size the wrapper picks
and how many clusters of each size the card holds at once; and K2b's device
time under every cluster size from 2 to 8 (the bits the same under each).
Needs a CUDA card:

    python3 exp/k2_clocks.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tempest_tpu_torch as tp  # noqa: E402
from tempest_tpu_torch.ops.resample_kernel import frames_to_screens_from_words  # noqa: E402
from tempest_tpu_torch.ops import sync_kernel  # noqa: E402
from tempest_tpu_torch.ops.sync_kernel import clock_stamps  # noqa: E402
from tempest_tpu_torch.pipeline import offline as poff  # noqa: E402


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def report(label: str, screens: torch.Tensor, subpixel: bool, split: int | None = None) -> None:
    clock_stamps(screens, subpixel, split)  # warm: the build, the shared-memory cap
    torch.cuda.synchronize()
    n, h, w = screens.shape
    smem = sync_kernel.shared_bytes(h, w)[1]
    resident = {size: sync_kernel._max_clusters(0, smem, size) for size in range(2, 9)}
    print(f"[K2b split] {label}: blocks a cluster "
          f"{split or sync_kernel._split(n, h, w, 0.01, 0.05, 0)} "
          f"({'forced' if split else 'the wrapper picks'}), {smem} bytes of shared memory a "
          f"block; clusters the card holds at once, by size 2-8: {resident}")
    runs = []
    for _ in range(5):
        labels, stamps = clock_stamps(screens, subpixel, split)
        torch.cuda.synchronize()
        runs.append(stamps.cpu().numpy())
    mhz = float(smi("clocks.sm").split()[0])
    stamps = np.concatenate(runs)                     # [runs * F, units, 10]
    n = len(labels)
    print(f"[K2b clocks] {label}, {'sub-pixel' if subpixel else 'integer'}: median cycles over "
          f"{stamps.shape[0]} frame runs, at {mhz:g} MHz (clocks.sm after the run)")
    start, end = stamps[:, :, 8], stamps[:, :, 9]     # ns, one clock for every SM
    first = start.reshape(len(runs), -1).min(axis=1, keepdims=True)
    rel_start = (start.reshape(len(runs), -1) - first) / 1e3
    rel_end = (end.reshape(len(runs), -1) - first) / 1e3
    print(f"  global timer, us from the first leader's start, median over runs: start "
          f"{np.median(rel_start.min(1)):.2f}-{np.median(rel_start.max(1)):.2f} (median "
          f"{np.median(rel_start):.2f}), end {np.median(rel_end.min(1)):.2f}-"
          f"{np.median(rel_end.max(1)):.2f} (median {np.median(rel_end):.2f})")
    for unit, axis in enumerate(("rows", "columns")):
        s = stamps[:, unit, :n]
        d = np.diff(s, axis=1)
        total = s[:, n - 1] - s[:, 0]
        parts = ", ".join(f"{labels[k + 1]} {np.median(d[:, k]):.0f} "
                          f"({np.median(d[:, k]) / mhz:.2f} us)" for k in range(n - 1))
        print(f"  {axis}: {parts}; start to end {np.median(total):.0f} "
              f"({np.median(total) / mhz:.2f} us)")


def sweep(label: str, screens: torch.Tensor, subpixel: bool) -> None:
    """K2b's device time under every cluster size, the same bits each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ref = sync_kernel._launch(screens, 0.01, 0.05, 0, subpixel, False, split=2)
    times = {}
    for size in range(2, 9):
        got = sync_kernel._launch(screens, 0.01, 0.05, 0, subpixel, False, split=size)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) if a.is_floating_point()
                   else torch.equal(a, b) for a, b in zip(got, ref))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                sync_kernel._launch(screens, 0.01, 0.05, 0, subpixel, False, split=size)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "search_kernel" in e.key]
        times[size] = (sum(e.self_device_time_total for e in evts) / 1e3
                       / max(1, sum(e.count for e in evts)), same)
    parts = ", ".join(f"{size}: {ms:.4f} ms{'' if same else ' (OTHER BITS)'}"
                      for size, (ms, same) in times.items())
    print(f"[K2b sweep] {label}: device ms a launch by cluster size (profiler, 10 launches): "
          f"{parts}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"))
    from tempest_tpu_torch import _build

    log = _build.load_library("sync").build_log.splitlines()
    print("\n".join(line for line in log if "registers" in line or "Compiling entry" in line
                     or "spill" in line))
    mode = tp.ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
    cfg = tp.ReconstructionConfig(sample_rate=20e6, mode=mode, n_frames=36, carry_phase=True,
                                  align_subpixel=True)
    spf = cfg.samples_per_frame
    n = cfg.block_samples + int(np.ceil(spf)) + 1
    cap = tp.generate_iq(mode, 20e6, n, snr_db=18.0, seed=33)
    words = np.clip(np.round(cap.iq.view(np.float32) * 8192.0), -32768, 32767).astype(np.int16)
    words = torch.from_numpy(words[: 2 * cfg.block_samples]).to(dev)
    starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, 36)).to(dev)
    raster = (int(np.floor(spf)), mode.height, mode.width, cfg.render_size)
    screens = frames_to_screens_from_words(words, starts, *raster)
    report("36 screens of 600x800", screens, True)
    report("36 screens of 600x800", screens, False)
    for size in (3, 8):
        report("36 screens of 600x800", screens, True, size)
    sweep("36 screens of 600x800, sub-pixel", screens, True)
    sweep("144 screens of 600x800, sub-pixel", screens.repeat(4, 1, 1).contiguous(), True)
    small = (int(np.floor(spf)), mode.height, mode.width, (150, 200))
    starts52 = torch.from_numpy(poff.carry_phase_starts(0.0, spf, 2)).to(dev)
    search = frames_to_screens_from_words(words, starts52, *small).repeat(26, 1, 1)
    report("52 screens of 150x200 (the mode search's count)", search.contiguous(), False)
    sweep("52 screens of 150x200, integer", search.contiguous(), False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
