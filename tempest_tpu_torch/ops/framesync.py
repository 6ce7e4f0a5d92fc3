"""Frame synchronisation in PyTorch — the counterpart of
``tempest_tpu/ops/framesync.py``.

Project each frame onto its row and column axes, smooth the profiles with a
small circular Gaussian, and score every circular blanking window
``[c-w, c+w]`` by the contrast between its mean and the mean outside it.  The
argmax over (w, c) is the blanking centre, i.e. the frame offset; the
sub-pixel variant refines it with a 3-point parabola re-read from an f32
prefix sum.  Alignment rolls the blanking to the image border, by integer
or fractional (linear / Catmull-Rom) circular shifts.

Every function takes a leading frame axis written out ([F, n] profiles,
[F, h, w] frames) instead of vmap.  Prefix sums stay float32: bf16 rounding
of the large-magnitude prefix corrupted the argmax in the JAX package.  The
registration is the roll form of the JAX package (``align_frame_subpixel``);
its circulant-matmul form (``shift_matrix``, ``align_frame_subpixel_matmul``)
is here too, in plain torch with the same taps: the same math up to f32
reassociation, two matrix products a frame, which no step of the port calls.

On the CPU every function here is plain torch.  On a CUDA tensor
``frame_sync`` and ``frame_sync_subpixel`` launch K2 (``ops.sync_kernel``),
and ``align_frame`` and ``align_frame_subpixel`` launch K3
(``ops.align_kernel``) without its EMA: every caller on the card goes through
the kernels.  The plain versions of the four are the ones below on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SyncSpec",
    "sync_spec_for_axis",
    "gaussian_kernel",
    "smooth_profile",
    "blank_scores",
    "contrast_scores",
    "find_blank",
    "find_blank_subpixel",
    "frame_sync",
    "frame_sync_subpixel",
    "align_frame",
    "align_frame_subpixel",
    "align_frame_subpixel_matmul",
    "shift_matrix",
]


@dataclasses.dataclass(frozen=True)
class SyncSpec:
    """Search bounds for one axis (reference ``Sync``,
    ``FrameSynchronisation.jl:19-23``)."""

    w_min: int  # minimum blanking half-width
    w_max: int  # maximum blanking half-width
    n: int      # profile length (lines or columns)


def sync_spec_for_axis(n: int, min_fraction: float) -> SyncSpec:
    """Reference bounds: w in [ceil(min_fraction * n), floor(n / 4)]; 1% of
    the lines for the row (y) axis and 5% of the columns for the x axis."""
    return SyncSpec(int(np.ceil(min_fraction * n)), int(np.floor(n / 4)), n)


def gaussian_kernel(n: int = 5) -> np.ndarray:
    """Normalised Gaussian FIR ``exp(-2 k^2 / n^2)``, k in [-(n-1)/2, (n-1)/2]."""
    if n % 2 != 1:
        raise ValueError("Gaussian kernel length must be odd")
    k = np.arange(n) - (n - 1) // 2
    h = np.exp(-2.0 * k**2 / n**2)
    return (h / h.sum()).astype(np.float32)


def smooth_profile(profile: torch.Tensor, kernel_len: int = 5) -> torch.Tensor:
    """Zero-phase circular Gaussian smoothing of [..., n] profiles, as
    ``kernel_len`` shifted multiply-adds in f32."""
    h = gaussian_kernel(kernel_len)
    half = kernel_len // 2
    n = profile.shape[-1]
    padded = torch.cat([profile[..., n - half:], profile, profile[..., :half]], dim=-1)
    out = float(h[0]) * padded[..., 0:n]
    for k in range(1, kernel_len):
        out = out + float(h[k]) * padded[..., k:k + n]
    return out


def _circular_prefix(profile: torch.Tensor, w_max: int) -> torch.Tensor:
    """Prefix sums (leading zero) of the wrap-padded [F, n] profiles:
    ``P[:, k] = sum(ext[:, :k])`` with ``ext = [tail w_max | profile | head w_max]``."""
    n = profile.shape[-1]
    ext = torch.cat([profile[..., n - w_max:], profile, profile[..., :w_max]], dim=-1)
    zero = torch.zeros(ext.shape[:-1] + (1,), dtype=ext.dtype, device=ext.device)
    return torch.cat([zero, torch.cumsum(ext, dim=-1)], dim=-1)


def _window_sums(profile: torch.Tensor, spec: SyncSpec) -> torch.Tensor:
    """Circular window sums ``W[f, w, c] = sum(profile[f, c-w : c+w+1])`` for
    w in [w_min, w_max]: differences of two prefix entries, [F, W, n]."""
    n, w_max = spec.n, spec.w_max
    prefix = _circular_prefix(profile, w_max)
    dev = profile.device
    ws = torch.arange(spec.w_min, w_max + 1, device=dev)[:, None]
    c = torch.arange(n, device=dev)[None, :]
    return prefix[..., w_max + ws + 1 + c] - prefix[..., w_max - ws + c]


def _blank_score(window, total, w, n):
    """Reference ``fill_β!`` score from a window sum."""
    beta = (total - 2.0 * window) / (2.0 * (n - w)) + window / w
    return beta * beta


def _contrast_score(window, total, w, n):
    """Polarity-symmetric score ``(mean inside − mean outside)^2``."""
    size = 2.0 * w + 1.0
    d = window / size - (total - window) / (n - size)
    return d * d


def _widths(spec: SyncSpec, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(spec.w_min, spec.w_max + 1, device=like.device).to(like.dtype)[:, None]


def blank_scores(profile: torch.Tensor, spec: SyncSpec) -> torch.Tensor:
    """Reference-formula score matrices [F, W, n] of [F, n] profiles."""
    total = profile.sum(dim=-1)[..., None, None]
    return _blank_score(_window_sums(profile, spec), total, _widths(spec, profile), spec.n)


def contrast_scores(profile: torch.Tensor, spec: SyncSpec) -> torch.Tensor:
    """Polarity-symmetric score matrices [F, W, n] of [F, n] profiles: the
    squared difference of the mean inside and outside every window."""
    total = profile.sum(dim=-1)[..., None, None]
    return _contrast_score(_window_sums(profile, spec), total, _widths(spec, profile), spec.n)


def _scores(method: str):
    if method not in ("contrast", "reference"):
        raise ValueError(f"unknown sync method {method!r}")
    return (contrast_scores, _contrast_score) if method == "contrast" else (blank_scores, _blank_score)


def find_blank(
    profile: torch.Tensor, spec: SyncSpec, method: str = "contrast"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best blanking centre of each [F, n] profile: (centre int64 [F],
    score [F]).  Ties go to the first maximum, as in the JAX package."""
    scores, _ = _scores(method)
    beta = scores(profile, spec).flatten(-2)
    flat = torch.argmax(beta, dim=-1)
    return flat % spec.n, torch.gather(beta, -1, flat[..., None])[..., 0]


def find_blank_subpixel(
    profile: torch.Tensor, spec: SyncSpec, method: str = "contrast"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best blanking centre with parabolic sub-pixel refinement along the
    centre axis at the winning width: (centre float32 [F], score [F]).  The
    three scores around the argmax are re-read exactly from the f32 prefix."""
    scores, score = _scores(method)
    n, w_max = spec.n, spec.w_max
    beta = scores(profile, spec).flatten(-2)
    flat = torch.argmax(beta, dim=-1)
    row, c = flat // n, flat % n
    w = (spec.w_min + row).to(profile.dtype)
    prefix = _circular_prefix(profile, w_max)
    total = profile.sum(dim=-1)
    hi = row + spec.w_min + w_max + 1  # prefix index offsets for width w
    lo = w_max - spec.w_min - row

    def score_at(ci):
        ci = ci % n
        win = (torch.gather(prefix, -1, (ci + hi)[..., None])
               - torch.gather(prefix, -1, (ci + lo)[..., None]))[..., 0]
        return score(win, total, w, n)

    b0, b1, b2 = score_at(c - 1), score_at(c), score_at(c + 1)
    denom = b0 - 2.0 * b1 + b2
    frac = torch.where(
        torch.abs(denom) > 1e-12 * (torch.abs(b1) + 1e-30),
        0.5 * (b0 - b2) / denom,
        torch.zeros_like(denom),
    )
    frac = torch.clamp(frac, -0.5, 0.5)
    return c.to(torch.float32) + frac, b1


def _profiles(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if frames.dim() != 3:
        raise ValueError(f"frames must be [F, h, w], got shape {tuple(frames.shape)}")
    return smooth_profile(frames.sum(dim=2)), smooth_profile(frames.sum(dim=1))


def frame_sync(
    frames: torch.Tensor,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integer (row, column) blanking position of each frame of [F, h, w]:
    ``(s_y, s_x, score)``, each [F]; score sums both axes' best contrasts."""
    from .sync_kernel import blanking_sync

    return blanking_sync(frames, y_min_frac, x_min_frac, method, subpixel=False)


def frame_sync_subpixel(
    frames: torch.Tensor,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`frame_sync` with parabolic sub-pixel refinement on both axes:
    float32 ``(s_y, s_x, score)``, each [F]."""
    from .sync_kernel import blanking_sync

    return blanking_sync(frames, y_min_frac, x_min_frac, method, subpixel=True)


def _take_rows(frames: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``out[f, i, :] = frames[f, (i + k[f]) % h, :]`` (a roll by ``-k[f]``)."""
    f, h, w = frames.shape
    idx = (torch.arange(h, device=frames.device)[None, :] + k[:, None]) % h
    return torch.gather(frames, 1, idx[:, :, None].expand(f, h, w))


def _take_cols(frames: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``out[f, :, j] = frames[f, :, (j + k[f]) % w]`` (a roll by ``-k[f]``)."""
    f, h, w = frames.shape
    idx = (torch.arange(w, device=frames.device)[None, :] + k[:, None]) % w
    return torch.gather(frames, 2, idx[:, None, :].expand(f, h, w))


def _align_frame_plain(frames: torch.Tensor, s_y: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    return _take_cols(_take_rows(frames, s_y.to(torch.int64)), s_x.to(torch.int64))


def align_frame(frames: torch.Tensor, s_y: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Roll each frame's blanking position to the image border
    (``circshift(image, (-s_y, -s_x))``) for integer [F] offsets."""
    if frames.device.type == "cpu":
        return _align_frame_plain(frames, s_y, s_x)
    from .align_kernel import align_fold

    return align_fold(frames, s_y, s_x, align="integer")[0]


def _interp_weights(f: torch.Tensor, interp: str):
    """(tap offsets, tap weights) of a fractional shift ``f`` ∈ [0, 1):
    2-tap linear or 4-tap Catmull-Rom."""
    if interp == "linear":
        return (0, 1), (1.0 - f, f)
    if interp != "cubic":
        raise ValueError(f"align interp must be 'linear' or 'cubic', got {interp!r}")
    f2, f3 = f * f, f * f * f
    w0 = 0.5 * (-f3 + 2.0 * f2 - f)
    w1 = 0.5 * (3.0 * f3 - 5.0 * f2 + 2.0)
    w2 = 0.5 * (-3.0 * f3 + 4.0 * f2 + f)
    w3 = 0.5 * (f3 - f2)
    return (-1, 0, 1, 2), (w0, w1, w2, w3)


def _roll_frac(frames: torch.Tensor, s: torch.Tensor, axis: int, interp: str) -> torch.Tensor:
    """Circular shift of each frame by a fractional ``-s[f]`` along ``axis``
    (1 = rows, 2 = columns): integer rolls by ``-(floor(s) + off)`` blended
    with the interpolation weights of ``s - floor(s)``."""
    k = torch.floor(s).to(torch.int64)
    f = (s - k.to(s.dtype)).to(frames.dtype)
    offs, ws = _interp_weights(f, interp)
    take = _take_rows if axis == 1 else _take_cols
    out = None
    for off, w in zip(offs, ws):
        term = w[:, None, None] * take(frames, k + off)
        out = term if out is None else out + term
    return out


def _align_frame_subpixel_plain(frames: torch.Tensor, s_y: torch.Tensor, s_x: torch.Tensor,
                                interp: str) -> torch.Tensor:
    return _roll_frac(_roll_frac(frames, s_y, 1, interp), s_x, 2, interp)


def align_frame_subpixel(
    frames: torch.Tensor,
    s_y: torch.Tensor,
    s_x: torch.Tensor,
    interp: str = "linear",
) -> torch.Tensor:
    """:func:`align_frame` for fractional [F] offsets: separable circular
    shift with linear or cubic interpolation, rows first."""
    if interp not in ("linear", "cubic"):
        raise ValueError(f"align interp must be 'linear' or 'cubic', got {interp!r}")
    if frames.device.type == "cpu":
        return _align_frame_subpixel_plain(frames, s_y, s_x, interp)
    from .align_kernel import align_fold

    return align_fold(frames, s_y, s_x, align=interp)[0]


def shift_matrix(n: int, s: torch.Tensor | float, interp: str = "linear",
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (n, n) circulant fractional-shift operator of shift ``s``, built on
    ``s``'s device: ``S @ v`` equals the roll form's shift of ``v`` by ``-s``
    along a length-``n`` axis.  A [F] tensor of shifts gives [F, n, n].  Each
    tap adds its weight where ``col == (row + floor(s) + off) % n``, in tap
    order from a zero matrix, as the JAX package builds it."""
    s = torch.as_tensor(s)
    if not s.is_floating_point():
        s = s.to(torch.float32)
    k = torch.floor(s).to(torch.int64)
    f = (s - k.to(s.dtype)).to(dtype)
    rows = torch.arange(n, device=s.device)[:, None]
    cols = torch.arange(n, device=s.device)[None, :]
    k, f = k[..., None, None], f[..., None, None]
    offs, ws = _interp_weights(f, interp)
    out = torch.zeros((*s.shape, n, n), dtype=dtype, device=s.device)
    for off, w in zip(offs, ws):
        out = out + w * (cols == (rows + k + off) % n).to(dtype)
    return out


def align_frame_subpixel_matmul(
    image: torch.Tensor,
    s_y: torch.Tensor | float,
    s_x: torch.Tensor | float,
    interp: str = "linear",
) -> torch.Tensor:
    """:func:`align_frame_subpixel` as two shift-operator products,
    ``S_y @ image @ S_x^T``: the same separable interpolation, equal up to
    f32 reassociation.  ``image`` is (h, w) with scalar shifts, or [F, h, w]
    with [F] shifts."""
    h, w = image.shape[-2:]
    s_y = torch.as_tensor(s_y, device=image.device)
    s_x = torch.as_tensor(s_x, device=image.device)
    sy = shift_matrix(h, s_y, interp, image.dtype)
    sx = shift_matrix(w, s_x, interp, image.dtype)
    return torch.matmul(torch.matmul(sy, image), sx.transpose(-1, -2))
