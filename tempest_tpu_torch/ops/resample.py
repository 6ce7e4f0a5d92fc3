"""Signal→image mapping in PyTorch — the subset of ``tempest_tpu/ops/resample.py``
that the streaming chain and its tests need.

* ``_interp_positions`` and ``_screen_geometry`` are host numpy, kept
  identical to the JAX package so both derive the same line geometry.
* ``linear_resample``, ``sig_to_image`` and ``downgrade_image`` render the
  ground truth of a synthetic capture at the screen size.
* ``frame_to_screen`` / ``frames_to_screens_gather`` are the JAX package's
  ``resampler="gather"``: one fused gather per frame, with the optional
  sub-sample ``offset`` read as 3 taps with computed weights.  Positions are
  clipped INTO the frame (K1 reads on into the following samples), so it is
  the oracle's counterpart and the chain's resampler only when asked for.

The resampler of the chain itself lives in ``ops/resample_kernel.py``.  The
TPU-only resampler formulations of the JAX package (``mxu``, ``mxu3``,
``rows``, ``aligned``, ``fft``, ``StreamingExactPlan``, ...) exist to avoid
gathers on the TPU and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "linear_resample",
    "sig_to_image",
    "downgrade_image",
    "frame_to_screen",
    "frames_to_screens_gather",
    "RENDER_SIZE",
]

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


def _catmull_rom(t: np.ndarray) -> tuple[np.ndarray, ...]:
    """Catmull-Rom (cubic, C¹) weights for taps at offsets (-1, 0, 1, 2)
    around the integer part of the read position, fraction ``t``."""
    t2, t3 = t * t, t * t * t
    return (
        0.5 * (-t3 + 2.0 * t2 - t),
        0.5 * (3.0 * t3 - 5.0 * t2 + 2.0),
        0.5 * (-3.0 * t3 + 4.0 * t2 + t),
        0.5 * (t3 - t2),
    )


def _gather_geometry(
    n_in: int, y_t: int, x_t: int, out_shape: tuple[int, int], with_offset: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tables of the gather resampler, as the JAX package derives them:
    (i0 [h,2,w] int64, frac [h,2,w] float32, wr [h,1] float32).  Positions
    are clipped into the frame; with an offset ``i0`` is capped at
    ``n_in - 3`` so that the third tap stays inside it."""
    h_out, w_out = out_shape
    ratio = n_in / (y_t * x_t)  # signal samples per raster pixel
    ry = np.clip((np.arange(h_out, dtype=np.float64) + 0.5) * (y_t / h_out) - 0.5,
                 0.0, y_t - 1.0)
    cx = np.clip((np.arange(w_out, dtype=np.float64) + 0.5) * (x_t / w_out) - 0.5,
                 0.0, x_t - 1.0)
    r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
    wr = (ry - r0).astype(np.float32)[:, None]
    max_i0 = max(n_in - 3, 0) if with_offset else max(n_in - 2, 0)
    lines = np.stack([r0, np.minimum(r0 + 1, y_t - 1)], axis=1)          # (h,2)
    flat = lines[:, :, None] * x_t + cx[None, None, :]
    pos = np.clip((flat + 0.5) * ratio - 0.5, 0.0, n_in - 1.0)
    i0 = np.minimum(np.floor(pos).astype(np.int64), max_i0)
    return i0, (pos - i0).astype(np.float32), wr


def frames_to_screens_gather(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    frac_offsets: torch.Tensor | None = None,
) -> torch.Tensor:
    """The gather resampler over all frames of a block: frame f is the
    ``frame_len`` samples from ``frame_starts[f]`` on, each read as
    :func:`frame_to_screen` reads it, with ``frac_offsets[f]`` as its
    offset.  Plain PyTorch on ``env``'s device; → (n_frames, h, w)."""
    i0, frac, wr = _gather_geometry(frame_len, y_t, x_t, tuple(out_shape),
                                    frac_offsets is not None)
    dev = env.device
    i0 = torch.from_numpy(i0).to(dev)
    frac = torch.from_numpy(frac).to(dev)
    wr = torch.from_numpy(wr).to(dev)
    idx = frame_starts.to(torch.int64)[:, None, None, None] + i0[None]   # [F,h,2,w]
    if frac_offsets is None:
        lines = env[idx] * (1.0 - frac) + env[idx + 1] * frac
    else:
        u = frac[None] + frac_offsets.to(torch.float32)[:, None, None, None]  # in [0, 2)
        w0 = torch.clamp(1.0 - u, min=0.0)
        w2 = torch.clamp(u - 1.0, min=0.0)
        lines = env[idx] * w0 + env[idx + 1] * (1.0 - w0 - w2) + env[idx + 2] * w2
    return lines[:, :, 0] * (1.0 - wr) + lines[:, :, 1] * wr


def frame_to_screen(
    sig: torch.Tensor,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    offset: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """One frame's envelope straight to the (h, w) screen with a single
    gather: bilinear across scan lines and along the scan.

    ``offset`` (in [0, 1) signal samples) shifts every read position by the
    frame boundary's sub-sample residual — a 3-tap read with computed
    weights: the same linear interpolation as the 2-tap path."""
    starts = torch.zeros(1, dtype=torch.int64, device=sig.device)
    frac = None
    if offset is not None:
        frac = torch.as_tensor(offset, dtype=torch.float32, device=sig.device).reshape(1)
    return frames_to_screens_gather(sig, starts, sig.shape[0], y_t, x_t, out_shape, frac)[0]
