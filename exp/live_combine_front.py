#!/usr/bin/env python3
"""The live combine front at the benchmark's size (cell ``live1080-combine3``:
1920x1080 @ 60 Hz at 20 Msps, blocks of 2^23 samples, carriers at -6, +1.5
and +7 MHz in 4 MHz channels), on one card:

* the aligned PSNR of the EMA after ``--blocks`` blocks fused from the three
  carriers, and of the same blocks through the front with the first carrier
  alone, against the screen the capture was made from (as the smoke's live
  combine phase measures it);
* whether a block's front, and its step, synchronise the host: each run
  under ``torch.cuda.set_sync_debug_mode("warn")``, the warnings it gave
  counted and their first lines kept, beside a read of one value to the
  host, which has to warn;
* the front's host time a block and the block's (front and step) issue time,
  unfenced, the mean of ``--reps`` blocks, with the card's name and power
  limit.

The capture is the benchmark's (``portbench/capture_wide.py``) from
``--seed``, taken to float32 words on the card; each block goes through
``StreamingRuntime.step_words`` at its phase on the frame grid.  Prints one
JSON object:

    python3 exp/live_combine_front.py [--seed 3124000001] [--blocks 8] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.capture import screen  # noqa: E402
from portbench.capture_wide import WideSpec, capture_words  # noqa: E402
from portbench.entries.livecombine import HeldSource  # noqa: E402

CONFIG = ROOT / "portbench" / "configs" / "live-1080p60-20msps-combine3.json"


def _card() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": out.stdout.strip()}


def _runtime(cfg: dict, carriers, dev):
    from tempest_tpu_torch.runtime.stream import StreamingRuntime
    from tempest_tpu_torch.video.modes import VideoMode

    mode = VideoMode(int(cfg["width_total"]), int(cfg["height_total"]), float(cfg["refresh_hz"]))
    return StreamingRuntime(HeldSource(cfg["sample_rate"], cfg["block_samples"]), mode,
                            alpha=float(cfg["alpha"]), ring_depth=2, combine=list(carriers),
                            combine_bw=float(cfg["assumed"]["chan_bw"]), device=dev)


def _under_sync_warnings(fn) -> dict:
    """Run ``fn`` once under the sync debug mode "warn": the warnings."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # The mode's first use says once that it is a prototype; that notice is
    # no synchronisation.
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "prototype feature" not in str(w.message)]
    return {"warnings": len(syncs), "first": syncs[:5]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=3124000001)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from tempest_tpu_torch.ops.resample import downgrade_image
    from tempest_tpu_torch.render.screen import aligned_psnr

    dev = torch.device("cuda", 0)
    cfg = json.loads(CONFIG.read_text())
    n = int(cfg["block_samples"])
    spec = WideSpec.from_config(cfg)
    words = capture_words(spec, n * args.blocks, args.seed, dev).to(torch.float32)
    blocks = [words[2 * b * n: 2 * (b + 1) * n] for b in range(args.blocks)]
    spf = float(cfg["sample_rate"]) / float(cfg["refresh_hz"])
    phases = [(-b * n) % spf for b in range(args.blocks)]
    truth = downgrade_image(screen(spec.base, args.seed, dev), tuple(cfg["render_size"]))
    truth = truth.cpu().numpy()
    carriers = [float(c) for c in cfg["assumed"]["carriers_hz"]]
    out = {**_card(), "seed": args.seed, "blocks": args.blocks}

    for name, cs in (("fused3", carriers), ("carrier0", carriers[:1])):
        rt = _runtime(cfg, cs, dev)
        for b in range(args.blocks):
            rt.step_words(blocks[b], phases[b])
        psnr, shift = aligned_psnr(truth, rt.ema.cpu().numpy())
        w, pol, mass = (t.cpu().tolist() for t in rt.combine_weights)
        out[name] = {"psnr_db": psnr, "shift": shift, "weights": w, "polarity": pol,
                     "mass_db": mass, "n_frames": rt.config.n_frames}

    rt = _runtime(cfg, carriers, dev)
    for b in range(4):
        rt.step_words(blocks[b % args.blocks], phases[b % args.blocks])
    out["sync_front"] = _under_sync_warnings(lambda: rt._combine_front(blocks[0]))
    out["sync_block"] = _under_sync_warnings(lambda: rt.step_words(blocks[1], phases[1]))
    # A read of one value to the host, which the mode has to report.
    out["sync_control"] = _under_sync_warnings(lambda: float(blocks[0][0]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.reps):
        rt._combine_front(blocks[i % args.blocks])
    out["front_issue_ms"] = 1e3 * (time.perf_counter() - t0) / args.reps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(args.reps):
        rt.step_words(blocks[i % args.blocks], phases[i % args.blocks])
    out["block_issue_ms"] = 1e3 * (time.perf_counter() - t0) / args.reps
    torch.cuda.synchronize()
    out["blocks_fenced_ms"] = 1e3 * (time.perf_counter() - t0) / args.reps
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
