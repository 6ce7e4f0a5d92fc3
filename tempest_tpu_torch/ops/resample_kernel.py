"""K1, the fused multi-frame resampler — the counterpart of
``tempest_tpu/ops/pallas_resample.py``.

``frames_to_screens`` maps every frame of one envelope block to its
(h, w) screen: for output row r it reads two scan lines (vertical taps) at
affine positions ``frac + c·delta`` along the scan, interpolates each
linearly, and blends them by ``wr[r]``.  It follows the Pallas kernel's
boundary semantics, not the gather path's:

* line starts are clamped at 0 and the negative remainder is folded into
  the fraction, and positions are lower-clipped at 0;
* reads past the frame end take the real following samples;
* reads past the block end see the last envelope value (the read index is
  clamped at ``N-1`` instead of copying the envelope into a padded buffer).

The Pallas kernel carries fractions and ``wr`` in 16.16 fixed point (a
scalar-prefetch constraint); here they stay float32, so the two differ by
at most 2⁻¹⁷ sample in position.

For a tensor on the CPU the wrapper runs the plain PyTorch version below.
For a CUDA tensor it launches the hand-written kernel
(``csrc/resample.cu``) or raises; it never falls back.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .resample import RENDER_SIZE, _screen_geometry

__all__ = [
    "ScreenGeometry",
    "screen_geometry",
    "frames_to_screens",
    "frames_to_screens_plain",
    "frame_to_screen",
]


@dataclasses.dataclass(frozen=True)
class ScreenGeometry:
    """Per-config line tables of the resampler, resident on one device."""

    line_start: torch.Tensor  # int32 [h, 2], clamped at 0
    line_frac: torch.Tensor   # float32 [h, 2], may be negative on row 0
    wr: torch.Tensor          # float32 [h], vertical blend weight
    delta: float              # samples per output column (a float32 value)
    span: int                 # samples one scan line reads
    out_shape: tuple[int, int]


@functools.lru_cache(maxsize=16)
def screen_geometry(
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int],
    device: torch.device,
) -> ScreenGeometry:
    """Build the line tables once per (geometry, device) from the shared
    host ``_screen_geometry`` and keep them on ``device``."""
    h, w = out_shape
    start, frac, wr, cols, _ = _screen_geometry(frame_len, y_t, x_t, out_shape)
    delta = float(np.float32(cols[1])) if w > 1 else 0.0
    line_start = np.maximum(start, 0)
    line_frac = (frac + (start - line_start)).astype(np.float32)
    # floor(pos) + 1 must stay inside the span: pos < (w-1)·delta + 1.
    span = int(np.ceil(cols[-1] + 1)) + 2
    dev = torch.device(device)
    return ScreenGeometry(
        line_start=torch.from_numpy(line_start.astype(np.int32)).to(dev),
        line_frac=torch.from_numpy(line_frac).to(dev),
        wr=torch.from_numpy(np.ascontiguousarray(wr[:, 0])).to(dev),
        delta=delta,
        span=span,
        out_shape=(h, w),
    )


def frames_to_screens_plain(
    env: torch.Tensor, frame_starts: torch.Tensor, geom: ScreenGeometry
) -> torch.Tensor:
    """The plain PyTorch version of K1, on any device: index arithmetic,
    ``clamp`` and ``gather``, in the same arithmetic order as the kernel."""
    h, w = geom.out_shape
    n = env.shape[0]
    dev = env.device
    cp = torch.arange(w, dtype=torch.float32, device=dev) * torch.tensor(
        geom.delta, dtype=torch.float32, device=dev)
    pos = torch.clamp(cp[None, None, :] + geom.line_frac[:, :, None], min=0.0)  # [h,2,w]
    i0f = torch.floor(pos)
    fr = pos - i0f
    base = (frame_starts.to(torch.int64)[:, None, None]
            + geom.line_start.to(torch.int64)[None])                        # [F,h,2]
    idx0 = base[..., None] + i0f.to(torch.int64)[None]                      # [F,h,2,w]
    a = env[torch.clamp(idx0, 0, n - 1)]
    b = env[torch.clamp(idx0 + 1, 0, n - 1)]
    lines = a * (1.0 - fr) + b * fr                                         # [F,h,2,w]
    wb = geom.wr[None, :, None]
    return (1.0 - wb) * lines[:, :, 0] + wb * lines[:, :, 1]


def frames_to_screens(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> torch.Tensor:
    """All frames of a block → (n_frames, h, w) float32 screens.

    ``env`` is the float32 envelope of the block (N,), ``frame_starts`` the
    integer sample offsets of the frames (n_frames,) on the same device, and
    ``frame_len`` the samples per frame that set the raster↔signal ratio."""
    if env.dim() != 1 or frame_starts.dim() != 1:
        raise ValueError("env and frame_starts must be 1-D")
    if env.device != frame_starts.device:
        raise ValueError(f"env on {env.device} but frame_starts on {frame_starts.device}")
    geom = screen_geometry(int(frame_len), int(y_t), int(x_t), tuple(out_shape), env.device)
    if env.device.type == "cpu":
        return frames_to_screens_plain(env, frame_starts, geom)
    if env.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {env.device.type}")
    if env.dtype != torch.float32 or frame_starts.dtype != torch.int32:
        raise TypeError(f"K1 takes float32 env and int32 starts, got {env.dtype}, {frame_starts.dtype}")
    if not (env.is_contiguous() and frame_starts.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    n_frames = frame_starts.shape[0]
    if n_frames == 0 or n_frames > 65535:
        raise ValueError(f"K1 takes 1..65535 frames, got {n_frames}")
    if 2 * geom.span * 4 > 227 * 1024:
        raise ValueError(f"scan-line span {geom.span} exceeds the shared memory of one block")
    from .. import _build

    lib = _build.load_library("resample")
    h, w = geom.out_shape
    out = torch.empty((n_frames, h, w), dtype=torch.float32, device=env.device)
    with torch.cuda.device(env.device):
        stream = torch.cuda.current_stream(env.device).cuda_stream
        rc = lib.tt_resample_frames(
            env.data_ptr(), env.shape[0], frame_starts.data_ptr(), n_frames,
            geom.line_start.data_ptr(), geom.line_frac.data_ptr(), geom.wr.data_ptr(),
            out.data_ptr(), h, w, geom.delta, geom.span, stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed with cudaError_t {rc}")
    frames_to_screens.launches += 1
    return out


frames_to_screens.launches = 0  # K1 launches since the last reset


def frame_to_screen(
    sig: torch.Tensor, y_t: int, x_t: int, out_shape: tuple[int, int] = RENDER_SIZE
) -> torch.Tensor:
    """One frame's envelope → (h, w) screen, through the same resampler."""
    starts = torch.zeros(1, dtype=torch.int32, device=sig.device)
    return frames_to_screens(sig, starts, sig.shape[0], y_t, x_t, out_shape)[0]
