"""Signal→image mapping in PyTorch — the counterpart of
``tempest_tpu/ops/resample.py``.

* ``_interp_positions`` and ``_screen_geometry`` are host numpy, kept
  identical to the JAX package so both derive the same line geometry.
* ``linear_resample``, ``sig_to_image`` and ``downgrade_image`` render the
  ground truth of a synthetic capture at the screen size.
* ``frame_to_screen`` / ``frames_to_screens_gather`` are the JAX package's
  ``resampler="gather"``: one fused gather per frame, with the optional
  sub-sample ``offset`` read as 3 taps with computed weights.  Positions are
  clipped INTO the frame (K1 reads on into the following samples), so it is
  the oracle's counterpart and the chain's resampler only when asked for.
  ``frame_to_screen_rows`` is the same evaluation under its JAX name.
* The JAX package's other resampler names are formulations of ONE function
  chosen to avoid gathers on the TPU.  Here each name keeps its VALUES and
  goes through K1 (``ops/resample_kernel.py``), not through one-hot matmuls:
  ``frames_to_screens_aligned`` is K1 as it is; ``frame_to_screen_mxu``,
  ``_mxu3``, ``_mxu4`` and ``frames_to_screens_mxu`` are K1 with each line's
  fraction quantised to ``num_phases`` levels on the host
  (``resample_kernel.quantise_line_frac``), and with the envelope rounded to
  bfloat16 and back where the JAX formulation rounds it (``mxu3`` and
  ``mxu4`` always, ``frames_to_screens_mxu`` under its default
  ``compute_dtype``).  K1 forms its interpolation weights in float32 in
  registers, so the bfloat16 rounding of the WEIGHTS that ``einsum_bf16`` and
  ``compute_dtype=bfloat16`` add in JAX is not reproduced: it moves a weight
  by at most 2⁻⁸ of itself.  ``segments`` and ``perm`` are accepted and
  change no value.
* ``frames_to_screens_mxu3_exact`` and ``StreamingExactPlan`` (exact cuts
  with the residual folded into quantised tables, ``phase_bins``) are NOT
  copied: K1 takes each frame's residual as it is, unquantised
  (``frames_to_screens(..., frac_offsets=...)``).
* ``frames_to_screens_fft`` is the band-limited resampler in plain torch
  (``torch.fft`` and one ``matmul``, as the JAX package leaves both to XLA).
* ``frame_to_screen_dynamic`` (geometry as data), ``fractional_shift``,
  ``naive_upsample``, ``upsample_fft`` and ``polyphase_resample`` are plain
  torch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "linear_resample",
    "sig_to_image",
    "downgrade_image",
    "frame_to_screen",
    "frames_to_screens_gather",
    "frame_to_screen_rows",
    "frame_to_screen_mxu",
    "frame_to_screen_mxu3",
    "frame_to_screen_mxu4",
    "frames_to_screens_mxu",
    "frames_to_screens_aligned",
    "frames_to_screens_fft",
    "frame_to_screen_dynamic",
    "fractional_shift",
    "naive_upsample",
    "make_fft_upsampler_filter",
    "upsample_fft",
    "polyphase_filter_bank",
    "polyphase_resample",
    "round_to_bfloat16",
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


@functools.lru_cache(maxsize=8)
def _gather_geometry(
    n_in: int, y_t: int, x_t: int, out_shape: tuple[int, int], with_offset: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host tables of the gather resampler, as the JAX package derives them:
    (i0 [h,2,w] int64, frac [h,2,w] float32, wr [h,1] float32).  Positions
    are clipped into the frame; with an offset ``i0`` is capped at
    ``n_in - 3`` so that the third tap stays inside it.  Kept per geometry
    (a dozen float64 passes over h·2·w positions otherwise repeat every
    block); callers only read them."""
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


def frame_to_screen_rows(
    sig: torch.Tensor,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> torch.Tensor:
    """The JAX package's ``resampler="rows"``: the function of
    :func:`frame_to_screen`, which that package evaluates scan line by scan
    line to spare the TPU a flat gather.  Here it IS that evaluation."""
    return frame_to_screen(sig, y_t, x_t, out_shape)


def round_to_bfloat16(env: torch.Tensor) -> torch.Tensor:
    """``env`` rounded to bfloat16 and back to float32, in one elementwise
    pass: the rounding that the JAX package's ``mxu3``, ``mxu4`` and
    ``mxu_batched`` formulations apply to the envelope (about 0.4% of a
    sample) before they interpolate in float32."""
    return env.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def _one_frame_quantised(
    sig: torch.Tensor, y_t: int, x_t: int, out_shape: tuple[int, int], num_phases: int,
    interp_taps: int, bf16: bool,
) -> torch.Tensor:
    """One frame through K1 with the quantised line table."""
    from .resample_kernel import frames_to_screens

    starts = torch.zeros(1, dtype=torch.int32, device=sig.device)
    env = round_to_bfloat16(sig) if bf16 else sig.to(torch.float32)
    return frames_to_screens(env, starts, sig.shape[0], y_t, x_t, out_shape, None,
                             interp_taps, num_phases)[0]


def frame_to_screen_mxu(
    sig: torch.Tensor,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    perm: str = "gather",
    interp_taps: int = 2,
) -> torch.Tensor:
    """The JAX package's ``resampler="mxu"`` (and ``"mxu2"``, ``perm=
    "einsum"``): the read of K1 with each line's fraction quantised to
    ``num_phases`` levels, at most ``1/(2·num_phases)`` sample off, in
    float32.  ``perm`` names how the TPU sorts lines by phase and changes
    no value."""
    if perm not in ("gather", "einsum"):
        raise ValueError(f"perm must be 'gather' or 'einsum', got {perm!r}")
    return _one_frame_quantised(sig, y_t, x_t, out_shape, num_phases, interp_taps, False)


def frame_to_screen_mxu3(
    sig: torch.Tensor,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    einsum_bf16: bool = False,
    interp_taps: int = 2,
) -> torch.Tensor:
    """The JAX package's ``resampler="mxu3"``: as :func:`frame_to_screen_mxu`
    on the envelope rounded to bfloat16 (its one-hot selects run in
    bfloat16).  ``einsum_bf16`` there also rounds the interpolation weights
    to bfloat16; K1 keeps them in float32, which differs by at most 2⁻⁸ of
    each weight."""
    del einsum_bf16
    return _one_frame_quantised(sig, y_t, x_t, out_shape, num_phases, interp_taps, True)


def frame_to_screen_mxu4(
    sig: torch.Tensor,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    interp_taps: int = 2,
) -> torch.Tensor:
    """The JAX package's ``resampler="mxu4"``: the values of ``mxu3``."""
    return _one_frame_quantised(sig, y_t, x_t, out_shape, num_phases, interp_taps, True)


def frames_to_screens_mxu(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int = 64,
    compute_dtype: torch.dtype = torch.bfloat16,
    segments: int = 1,
) -> torch.Tensor:
    """The JAX package's ``resampler="mxu_batched"``: every frame of a block
    through one K1 launch with the quantised line table, 2 taps.  Under the
    default ``compute_dtype`` the envelope is rounded to bfloat16 first, as
    there (the weights are not: see the module docstring).  ``segments``
    splits the TPU's scan lines into column blocks, each quantised on its
    own; here it must divide the width and changes no value."""
    from .resample_kernel import frames_to_screens

    if out_shape[1] % segments:
        raise ValueError(f"segments={segments} must divide w_out={out_shape[1]}")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype}")
    env = round_to_bfloat16(env) if compute_dtype == torch.bfloat16 else env.to(torch.float32)
    starts = frame_starts.to(torch.int32)
    return frames_to_screens(env, starts, frame_len, y_t, x_t, out_shape, None, 2, num_phases)


def frames_to_screens_aligned(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> torch.Tensor:
    """The JAX package's ``resampler="aligned"``: frame starts on a block,
    line starts clamped at 0 with the remainder folded into the fraction,
    reads past the frame end taking the following samples.  That is K1's
    function, and this is K1."""
    from .resample_kernel import frames_to_screens

    return frames_to_screens(env.to(torch.float32), frame_starts.to(torch.int32), frame_len,
                             y_t, x_t, out_shape)


def frames_to_screens_fft(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    l_pad: int | None = None,
) -> torch.Tensor:
    """Resampler via spectral line rectification (``resampler="fft"``).

    Bandlimited-resample each frame's envelope from ``frame_len`` samples to
    exactly ``y_t * l_pad`` samples (rfft → zero-pad/truncate spectrum →
    irfft): scan line ``l`` then occupies out[l*l_pad : (l+1)*l_pad]
    exactly, so a reshape puts every line at an integer stride.  Columns
    interpolate through ONE shared (l_pad × w_out) weight matrix (the
    within-line position map is line-invariant), and the vertical blend
    selects whole rows.

    Compared to the linear-interpolation variants this is *sinc*
    interpolation: exact for band-limited content, with circular (not
    clamped) frame-edge semantics.  All frames go through one batched FFT.
    """
    h_out, w_out = out_shape
    if l_pad is None:
        l_pad = -(-(int(np.ceil(frame_len / y_t)) + 2) // 128) * 128
    m_out = y_t * l_pad
    n_bins = min(frame_len // 2 + 1, m_out // 2 + 1)
    scale = m_out / frame_len

    # Shared column weights: raster px c maps within any line to
    # q(c) = (cx_c + 0.5) * l_pad / x_t - 0.5 * m_out / frame_len.  The first
    # columns of a line read slightly *before* its boundary (into the previous
    # line's tail) and the last slightly after; each reshaped line is extended
    # by its neighbours' edge samples (rolls) so no position is ever clamped.
    cx = np.clip((np.arange(w_out) + 0.5) * (x_t / w_out) - 0.5, 0.0, x_t - 1.0)
    q = (cx + 0.5) * (l_pad / x_t) - 0.5 * scale
    ext_lo = max(0, -int(np.floor(q.min())))          # previous-line tail
    ext_hi = max(0, int(np.floor(q.max())) + 2 - l_pad)  # next-line head
    q = q + ext_lo
    i0 = q.astype(np.int64)
    fr = (q - i0).astype(np.float32)
    width = ext_lo + l_pad + ext_hi
    w_col = np.zeros((width, w_out), np.float32)
    w_col[i0, np.arange(w_out)] = 1.0 - fr
    w_col[i0 + 1, np.arange(w_out)] += fr

    # Vertical geometry (same half-pixel convention as frame_to_screen).
    ry = np.clip((np.arange(h_out) + 0.5) * (y_t / h_out) - 0.5, 0.0, y_t - 1.0)
    r0 = np.minimum(np.floor(ry).astype(np.int64), max(y_t - 2, 0))
    dev = env.device
    wr = torch.from_numpy((ry - r0).astype(np.float32)[:, None]).to(dev)
    r0 = torch.from_numpy(r0).to(dev)
    w_col = torch.from_numpy(w_col).to(dev)

    idx = (frame_starts.to(torch.int64)[:, None]
           + torch.arange(frame_len, dtype=torch.int64, device=dev)[None])
    spec = torch.fft.rfft(env.to(torch.float32)[idx], dim=1)[:, :n_bins]
    if frame_len % 2 == 0 and m_out > frame_len:
        # The even-length Nyquist bin represents both +/-fs/2; keep only
        # half its weight when embedding into the larger spectrum.
        spec = spec.clone()
        spec[:, n_bins - 1] *= 0.5
    spec_m = torch.zeros((spec.shape[0], m_out // 2 + 1), dtype=spec.dtype, device=dev)
    spec_m[:, :n_bins] = spec
    lines = (torch.fft.irfft(spec_m, n=m_out, dim=1) * scale).reshape(-1, y_t, l_pad)
    parts = []
    if ext_lo:
        parts.append(torch.roll(lines, 1, dims=1)[:, :, -ext_lo:])
    parts.append(lines)
    if ext_hi:
        parts.append(torch.roll(lines, -1, dims=1)[:, :, :ext_hi])
    ext = torch.cat(parts, dim=2) if len(parts) > 1 else lines
    blended = ext[:, r0] * (1.0 - wr) + ext[:, r0 + 1] * wr       # (F, h, width)
    return torch.matmul(blended, w_col)


def frame_to_screen_dynamic(
    sig: torch.Tensor,
    y_t: torch.Tensor | float,
    x_t: torch.Tensor | float,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> torch.Tensor:
    """``frame_to_screen`` with the raster geometry as DATA: ``y_t`` and
    ``x_t`` are values (tensors or numbers), and every position is computed
    on ``sig``'s device in float32, operation by operation as the JAX
    package's traced version states it, so that any candidate video mode
    goes through the same code."""
    n_in = sig.shape[0]
    h_out, w_out = out_shape
    dev = sig.device
    y_t = torch.as_tensor(y_t, dtype=torch.float32, device=dev)
    x_t = torch.as_tensor(x_t, dtype=torch.float32, device=dev)
    ratio = n_in / (y_t * x_t)
    ry = torch.clamp(
        (torch.arange(h_out, dtype=torch.float32, device=dev) + 0.5) * (y_t / h_out) - 0.5,
        min=0.0).minimum(y_t - 1.0)
    cx = torch.clamp(
        (torch.arange(w_out, dtype=torch.float32, device=dev) + 0.5) * (x_t / w_out) - 0.5,
        min=0.0).minimum(x_t - 1.0)
    r0 = torch.minimum(torch.floor(ry), torch.clamp(y_t - 2.0, min=0.0))
    wr = (ry - r0)[:, None]

    def line_sample(line_idx: torch.Tensor) -> torch.Tensor:
        flat = line_idx[:, None] * x_t + cx[None, :]
        pos = torch.clamp((flat + 0.5) * ratio - 0.5, 0.0, n_in - 1.0)
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), max=max(n_in - 2, 0))
        frac = pos - i0.to(torch.float32)
        return sig[i0] * (1.0 - frac) + sig[i0 + 1] * frac

    top = line_sample(r0)
    bot = line_sample(torch.minimum(r0 + 1.0, y_t - 1.0))
    return top * (1.0 - wr) + bot * wr


def polyphase_filter_bank(
    num_phases: int = 64, taps_per_phase: int = 8, cutoff: float = 1.0
) -> np.ndarray:
    """Windowed-sinc polyphase bank: (num_phases, taps_per_phase) float32.

    Phase ``p`` holds the interpolation filter for fractional offset
    ``p / num_phases``; ``cutoff`` ≤ 1 scales the passband (set to
    ``min(1, out_rate/in_rate)`` when decimating, for anti-aliasing).
    """
    half = taps_per_phase // 2
    taps = np.empty((num_phases, taps_per_phase), np.float64)
    for p in range(num_phases):
        frac = p / num_phases
        t = np.arange(-half + 1, half + 1) - frac  # offsets of contributing samples
        x = cutoff * t
        s = cutoff * np.sinc(x)
        # Blackman window over the tap support.
        w = np.blackman(2 * taps_per_phase + 1)
        win = np.interp(t, np.linspace(-half, half, 2 * taps_per_phase + 1), w)
        taps[p] = s * win
        total = taps[p].sum()
        if abs(total) > 1e-9:
            taps[p] /= total  # unity DC gain per phase
    return taps.astype(np.float32)


def _edge_pad(sig: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``sig`` with its first and last sample repeated ``left`` and
    ``right`` times (numpy's ``mode="edge"``)."""
    return torch.cat([sig[:1].expand(left), sig, sig[-1:].expand(right)])


def fractional_shift(
    sig: torch.Tensor,
    frac: torch.Tensor | float,
    num_phases: int = 128,
    taps: int = 8,
) -> torch.Tensor:
    """Windowed-sinc sub-sample advance: ``out[i] ≈ sig(i + frac)`` for a
    ``frac`` in [0, 1), through the polyphase bank's nearest lower phase."""
    bank = torch.from_numpy(polyphase_filter_bank(num_phases, taps, 1.0)).to(sig.device)
    phase = torch.clamp(
        (torch.as_tensor(frac, dtype=torch.float32, device=sig.device) * num_phases)
        .to(torch.int64), 0, num_phases - 1)
    h = bank[phase]                       # (taps,)
    half = taps // 2
    pad = _edge_pad(sig, half - 1, half)
    n = sig.shape[0]
    out = torch.zeros_like(sig)
    for j in range(taps):
        out = out + h[j] * pad[j: j + n]
    return out


def naive_upsample(sig: torch.Tensor, up: int) -> torch.Tensor:
    """Sample-repeat upsampling (reference ``naiveResampler``,
    ``Resampler.jl:103-110``)."""
    return torch.repeat_interleave(sig, up)


def make_fft_upsampler_filter(n_fft: int, up: int) -> np.ndarray:
    """Frequency response of a linear-phase Blackman-apodised low-pass with
    cutoff π/up, synthesised by frequency sampling — the same *method* as the
    reference's ``initLPF`` (``Resampler.jl:83-99``), built host-side once per
    (n_fft, up)."""
    # Ideal brick wall over the positive-frequency bins only (the reference
    # keeps one side and recovers with 2*Re(.) afterwards; we do the same).
    bound = int(round(n_fft / up / 2))
    mag = np.zeros(n_fft)
    mag[:bound] = 1.0
    # Linear phase (group delay (N-1)/2) centres the impulse response under
    # the Blackman window...
    k = np.arange(n_fft)
    h = np.fft.ifft(mag * np.exp(-1j * np.pi * (n_fft - 1) * k / n_fft))
    h = h * np.blackman(n_fft)
    # ...and the (-1)^k on the *frequency* response circularly shifts the
    # windowed filter back by N/2, undoing that delay (``Resampler.jl:97``).
    return (np.fft.fft(h) * (-1.0) ** k).astype(np.complex64)


def upsample_fft(sig: torch.Tensor, up: int) -> torch.Tensor:
    """Integer upsampling by zero-stuffing + frequency-domain low-pass
    (reference ``init_resampler`` closure, ``Resampler.jl:42-60``): output is
    ``2 * up * Re(ifft(fft(stuffed) * H))``."""
    n_fft = sig.shape[0] * up
    stuffed = torch.zeros(n_fft, dtype=sig.dtype, device=sig.device)
    stuffed[::up] = sig
    h = torch.from_numpy(make_fft_upsampler_filter(n_fft, up)).to(sig.device)
    out = torch.fft.ifft(torch.fft.fft(stuffed) * h)
    return 2.0 * up * out.real


def polyphase_resample(
    sig: torch.Tensor,
    n_out: int,
    ratio: torch.Tensor | float,
    num_phases: int = 64,
    taps_per_phase: int = 8,
    cutoff: float | None = None,
) -> torch.Tensor:
    """Fractional resampling: output sample ``i`` interpolates the input at
    position ``i * ratio`` through a windowed-sinc polyphase bank.

    ``ratio`` (input samples per output sample) may be a tensor on the
    device, so the pipeline can lock the resampling ratio to the *estimated*
    pixel clock without a host round trip; the anti-aliasing ``cutoff`` is a
    host number and must then be given (1.0 for upsampling, at most
    ``1/max_ratio`` when decimating)."""
    if cutoff is None:
        if isinstance(ratio, torch.Tensor):
            raise ValueError(
                "polyphase_resample: with a tensor ratio the anti-aliasing "
                "cutoff is not derived from it — pass cutoff explicitly (1.0 for "
                "upsampling, <= 1/max_ratio when decimating)"
            )
        r = float(ratio)
        cutoff = 1.0 if r <= 1.0 else 1.0 / r
    dev = sig.device
    bank = torch.from_numpy(polyphase_filter_bank(num_phases, taps_per_phase, cutoff)).to(dev)
    half = taps_per_phase // 2
    # Tap j of phase p weights input sample base - (half-1) + j (the bank's
    # sinc argument grid is arange(-half+1, half+1) - frac).
    pad = _edge_pad(sig, half - 1, half + 1)
    pos = (torch.arange(n_out, dtype=torch.float32, device=dev)
           * torch.as_tensor(ratio, dtype=torch.float32, device=dev))
    base = torch.floor(pos).to(torch.int64)
    frac = pos - base.to(torch.float32)
    phase = torch.clamp((frac * num_phases).to(torch.int64), 0, num_phases - 1)
    offs = torch.arange(taps_per_phase, dtype=torch.int64, device=dev)[None, :]
    windows = pad[base[:, None] + offs]
    return torch.sum(windows * bank[phase], dim=-1)
