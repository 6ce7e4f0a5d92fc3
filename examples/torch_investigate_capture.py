"""Step-by-step offline analysis of an IQ capture with the PyTorch/CUDA port —
the walk of ``examples/investigate_capture.py`` through ``tempest_tpu_torch``
(the analogue of the reference's canonical walkthrough script,
``production/investigate_data.jl``), fully automated.

Usage:
    python examples/torch_investigate_capture.py [capture.dat] [--fs 20e6] [--device cpu]

Without a capture it synthesises one (the repo ships no recorded IQ).  Each
stage prints what the reference script inspects manually: spectrum summary,
autocorrelation peaks, refresh estimate, line-count estimate, chosen mode,
frame cut, sync offsets, and writes the reconstructed screen to PNG.  It
runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")  # run from the repo root

import torch  # noqa: E402

import tempest_tpu_torch as tp  # noqa: E402
from tempest_tpu_torch.ops.autocorr import autocorrelation, zoom_autocorr  # noqa: E402
from tempest_tpu_torch.render.screen import write_png  # noqa: E402
from tempest_tpu_torch.utils.device import as_tensor, resolve_device  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("capture", nargs="?", default=None)
    ap.add_argument("--fs", type=float, default=16e6)
    ap.add_argument("--format", default="single")
    ap.add_argument("--out", default="investigate_out.png")
    ap.add_argument("--device", default=None, help="default the CUDA card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.capture:
        iq = tp.read_complex_binary(args.capture, args.format)
        print(f"[1] loaded {len(iq)} samples from {args.capture}")
    else:
        mode = tp.ALL_VIDEO_MODES["1024x768 @ 60Hz"]
        cap = tp.generate_iq(mode, args.fs, int(args.fs * 0.5), snr_db=18.0)
        iq = cap.iq
        print(f"[1] synthesised {len(iq)} samples of {mode} @ {args.fs/1e6:.1f} MHz")

    # [2] envelope + spectrum (investigate_data.jl:37-46).  The capture goes
    # to the device once, as interleaved float32 words (a zero-copy view of
    # the complex samples), and stays there for every stage below.
    words = as_tensor(np.ascontiguousarray(iq, np.complex64).view(np.float32), device)
    z = torch.view_as_complex(words.reshape(-1, 2))
    env = tp.am_envelope_from_iq(words)
    freq, psd = tp.get_welch(args.fs, z[: 1 << 18])
    peak_f = float(freq[int(torch.argmax(psd))])
    print(f"[2] AM envelope: mean {float(env.mean()):.3f}; Welch PSD peak at "
          f"{peak_f/1e3:.1f} kHz offset")

    # [3] autocorrelation + refresh zoom (investigate_data.jl:52-63)
    gamma, lags = autocorrelation(env ** 2, args.fs, 0.0, 0.1)
    rates, gz = zoom_autocorr(gamma, args.fs, rate_min=50, rate_max=90)
    top = int(torch.argmax(gz))
    print(f"[3] autocorr over {gamma.shape[0]} lags; refresh-band "
          f"argmax at {float(rates[top]):.3f} Hz")

    # [4]-[7] the automated pipeline: timing -> mode -> frames -> sync -> EMA
    timing, recon = tp.auto_reconstruct(words, args.fs, alpha=0.5, device=device)
    print(f"[4] refresh estimate : {timing.refresh_hz:.4f} Hz")
    print(f"[5] line count est   : {timing.line_count:.1f} -> mode "
          f"{timing.mode_name} ({timing.mode.width}x{timing.mode.height})")
    print(f"[6] frames averaged  : {recon.frames.shape[0]}; sync offsets "
          f"first/last {recon.sync[0].tolist()}/{recon.sync[-1].tolist()}")
    write_png(recon.image, args.out)
    print(f"[7] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
