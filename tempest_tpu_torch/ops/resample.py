"""Signal→image mapping in PyTorch — the subset of ``tempest_tpu/ops/resample.py``
that the streaming chain and its tests need.

* ``_interp_positions`` and ``_screen_geometry`` are host numpy, kept
  identical to the JAX package so both derive the same line geometry.
* ``linear_resample``, ``sig_to_image`` and ``downgrade_image`` render the
  ground truth of a synthetic capture at the screen size.

The resampler of the chain itself lives in ``ops/resample_kernel.py``.  The
TPU-only resampler formulations of the JAX package (``mxu``, ``mxu3``,
``rows``, ``aligned``, ``fft``, ``StreamingExactPlan``, ...) exist to avoid
gathers on the TPU and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["linear_resample", "sig_to_image", "downgrade_image", "RENDER_SIZE"]

RENDER_SIZE = (600, 800)  # reference RENDERING_SIZE (GUI.jl:10)


def _interp_positions(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Half-pixel-centred source positions for resizing n_in → n_out."""
    pos = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    pos = np.clip(pos, 0.0, n_in - 1.0)
    i0 = np.floor(pos).astype(np.int32)
    i0 = np.minimum(i0, n_in - 2) if n_in > 1 else i0
    frac = (pos - i0).astype(np.float32)
    return i0, frac


def linear_resample(sig: torch.Tensor, n_out: int) -> torch.Tensor:
    """1-D linear interpolation of ``sig`` to ``n_out`` points (the
    ``imresize``-equivalent of the reference's live path), on ``sig``'s
    device."""
    i0, frac = _interp_positions(sig.shape[0], n_out)
    i0 = torch.from_numpy(i0.astype(np.int64)).to(sig.device)
    frac = torch.from_numpy(frac).to(sig.device)
    return sig[i0] * (1.0 - frac) + sig[i0 + 1] * frac


def sig_to_image(sig: torch.Tensor, y_t: int, x_t: int) -> torch.Tensor:
    """One frame's envelope → full-resolution (y_t, x_t) image."""
    return linear_resample(sig, y_t * x_t).reshape(y_t, x_t)


def downgrade_image(
    image: torch.Tensor, out_shape: tuple[int, int] = RENDER_SIZE
) -> torch.Tensor:
    """Bilinear shrink to the rendering size, on ``image``'s device."""
    h_in, w_in = image.shape
    h_out, w_out = out_shape
    r0, rf = _interp_positions(h_in, h_out)
    c0, cf = _interp_positions(w_in, w_out)
    dev = image.device
    r0 = torch.from_numpy(r0.astype(np.int64)).to(dev)
    c0 = torch.from_numpy(c0.astype(np.int64)).to(dev)
    rf = torch.from_numpy(rf).to(dev)[:, None]
    cf = torch.from_numpy(cf).to(dev)[None, :]
    top = image[r0][:, c0] * (1 - cf) + image[r0][:, c0 + 1] * cf
    bot = image[r0 + 1][:, c0] * (1 - cf) + image[r0 + 1][:, c0 + 1] * cf
    return top * (1 - rf) + bot * rf


def _screen_geometry(
    n_in: int, y_t: int, x_t: int, out_shape: tuple[int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Host-side geometry shared by the fast frame_to_screen variants.

    For output row r and vertical tap t∈{0,1}, the source positions along the
    scan are ``A[r,t] + c*delta`` (c = output column): an affine family whose
    slope is constant — only the per-(row,tap) offset differs.  Returns
    (line_start[600,2], line_frac[600,2], wr[600,1], col_offsets[800], delta)
    with positions split as start (int) + frac∈[0,1) + c*delta.
    """
    h_out, w_out = out_shape
    ratio = n_in / (y_t * x_t)  # signal samples per raster pixel
    ry = np.clip((np.arange(h_out) + 0.5) * (y_t / h_out) - 0.5, 0.0, y_t - 1.0)
    r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
    wr = (ry - r0).astype(np.float32)[:, None]
    lines = np.stack([r0, np.minimum(r0 + 1, y_t - 1)], axis=1)  # (h,2)
    # Column positions must stay a UNIFORM grid (the affine-family variants
    # encode them as start + c*delta): do NOT clip cx — clipping the edge
    # columns (which engages whenever w_out > x_t) used to corrupt delta and
    # silently mis-render every wide output grid.  The sub-pixel overhang at
    # the edges (< 1 raster px) reads the neighbouring sample instead of
    # clamping — boundary-only, and within the padded span.
    cx0 = 0.5 * (x_t / w_out) - 0.5
    delta = (x_t / w_out) * ratio if w_out > 1 else 0.0
    # pos(r,t,c) = (lines*x_t + cx0 + 0.5)*ratio - 0.5 + c*delta
    a = (lines * x_t + cx0 + 0.5) * ratio - 0.5            # (h,2) offset at c=0
    start = np.floor(a).astype(np.int64)
    frac = (a - start).astype(np.float32)
    cols = (np.arange(w_out) * delta).astype(np.float64)    # c*delta
    return start, frac, wr, cols, float(ratio)
