"""A complete live operator session, scripted, on the PyTorch/CUDA port — the
walk of ``examples/live_operator_session.py`` through ``tempest_tpu_torch``
(the analogue of the reference's interactive GUI workflow, ``GUI.jl``): watch
the stream, correlate, inspect the ranked line peaks, pick one, lock the
refresh from observed drift, switch to fidelity mode, record raw IQ.

Usage:
    python examples/torch_live_operator_session.py [--device cpu]

Runs entirely on a synthetic 1024x768@60 source (the repo ships no recorded
IQ), on the CUDA card unless ``--device cpu`` is given.  For a real
interactive session over ssh, use:

    python -m tempest_tpu_torch.app.cli stream --source replay --file cap.dat \
        --fs 20e6 --console --render terminal --crosshair
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")  # run from the repo root

import tempest_tpu_torch as tp  # noqa: E402
from tempest_tpu_torch.render.screen import write_png  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default the CUDA card; 'cpu' for the CPU")
    ap.add_argument("--out", default="live_session.png")
    args = ap.parse_args(argv)

    mode = tp.ALL_VIDEO_MODES["1024x768 @ 60Hz"]
    fs = 16e6
    src = tp.SyntheticSource(mode, fs, block_size=int(fs * 0.15), snr_db=20.0, seed=7)
    # Start deliberately mis-configured — the operator fixes it live.
    wrong = tp.VideoMode(mode.width, mode.height + 3, 60.02)
    rt = tp.StreamingRuntime(src, wrong, alpha=0.4, device=args.device)
    rt.start()

    session = [
        "status",
        "correlate 0.1",   # task 1: live re-estimate (fixes mode + fv)
        "peaks",           # ranked line-period alternatives
        "pick 0",          # adopt the top peak (the reference's click)
        "alpha 0.6",
        "status",
        "drift",           # close the refresh loop on observed sync drift
        "fidelity on",     # sub-sample-exact cuts now that fv is locked
        "record 1",        # task 3: dump one raw block to dumpIQ_N.dat
        "status",
        "quit",
    ]
    console = tp.OperatorConsole(rt, commands=session)
    try:
        img = console.run()
    finally:
        rt.stop()

    if img is not None:
        write_png(img, args.out)
        print(f"final mode: {rt.mode.width}x{rt.mode.height} "
              f"@ {rt.mode.refresh:.4f} Hz | fidelity={rt.fidelity} | "
              f"{rt.frames_out} frames -> {args.out}")
    if rt.last_record_path:
        print(f"raw IQ recorded to {rt.last_record_path} "
              f"({np.round(src.sample_rate / 1e6, 1)} Msps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
