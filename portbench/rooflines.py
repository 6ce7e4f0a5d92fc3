"""The least time the card could take for a kernel layer's work, from the
cell's shapes alone: the larger of its bytes over the peak bandwidth and its
operations over the peak float32 rate.  Each input byte is counted read once
and each output byte written once, whatever a kernel reads again.

Peaks: one NVIDIA H100 SXM at its full 700 W (NVIDIA's H100 data sheet, dense
rates): 67 TFLOP/s float32 outside the tensor cores (the chain's arithmetic
is float32 and uses no tensor core), 3.35 TB/s HBM3 — ``H100_PEAKS`` of
``tempest_tpu_torch/utils/roofline.py`` at commit 535d04e, copied.  Every
share a run reports is against these, with the card's power limit beside it
in the result's ``device``.

The counts (one step of F frames of an (h, w) screen):

* K1, the resample from interleaved I/Q words: reads the words of every
  sample some output pixel's taps address (the union of each frame's line
  spans, clamped into the block) and the line tables (h rows of two starts,
  two fractions and a weight), writes F·h·w float32.  Operations a pixel: the
  position (1), two lines of ``taps`` taps (linear: 3 each; Catmull-Rom: the
  weights 11 and the taps 7, each), the blend (3); a sample: the envelope
  ``sqrt(I² + Q²)`` (4), and the bfloat16 rounding where the chain rounds (1).
* K2 + K3, sync, alignment and fold: read the F screens once and the EMA,
  write the F aligned screens, the EMA and the [F, 2] sync and [F] score.
  Operations: the profiles (one add a pixel), and a pixel's alignment (two
  axes of two taps: 6) and fold (2); the window search, whose count per
  frame is the windows of both axes times 12.
"""

from __future__ import annotations

import numpy as np

__all__ = ["H100_PEAKS", "bound_seconds", "k1_work", "k2k3_work", "addressed_samples"]

H100_PEAKS = {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}


def bound_seconds(work: tuple[float, float]) -> float:
    """max(bytes / bandwidth, flops / float32 rate)."""
    nbytes, flops = work
    return max(nbytes / H100_PEAKS["bytes_per_s"], flops / H100_PEAKS["flops_per_s"])


def addressed_samples(starts, line_start: np.ndarray, span: int, n_block: int) -> int:
    """Samples of the block that some line of some frame reads: the union of
    ``[start + line_start, + span)`` over frames and lines, clamped into the
    block."""
    lo = (np.asarray(starts, np.int64)[:, None] + line_start.reshape(1, -1)).ravel()
    lo = np.clip(np.sort(lo), 0, n_block)
    hi = np.clip(lo + span, 0, n_block)
    total, cur_lo, cur_hi = 0, None, None
    for a, b in zip(lo, hi):
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return int(total)


def k1_work(n_frames: int, h: int, w: int, samples_read: int, sample_bytes: int, taps: int,
            bf16: bool) -> tuple[float, float]:
    """(bytes, flops) of one K1 launch on words."""
    nbytes = samples_read * sample_bytes + h * 5 * 4 + n_frames * h * w * 4
    per_line = 3 * 2 if taps == 2 else 11 + 7 * 4
    flops = n_frames * h * w * (1 + 2 * per_line + 3) + samples_read * (4 + (1 if bf16 else 0))
    return float(nbytes), float(flops)


def _windows(n: int, min_frac: float) -> int:
    w_min, w_max = int(np.ceil(min_frac * n)), int(np.floor(n / 4))
    return (w_max - w_min + 1) * n


def k2k3_work(n_frames: int, h: int, w: int) -> tuple[float, float]:
    """(bytes, flops) of K2's two launches and K3's one a step."""
    pix = n_frames * h * w
    nbytes = 4 * pix + 4 * pix + 2 * 4 * h * w + n_frames * 3 * 4
    windows = _windows(h, 0.01) + _windows(w, 0.05)
    flops = pix * (1 + 6 + 2) + n_frames * windows * 12
    return float(nbytes), float(flops)
