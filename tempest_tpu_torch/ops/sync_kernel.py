"""K2, the blanking sync on the card — the port's own kernel for stage 4,
``frame_sync`` and ``frame_sync_subpixel`` of ``tempest_tpu/ops/framesync.py``
(XLA there, not Pallas).

``blanking_sync(frames, ...)`` returns ``(s_y, s_x, score)``, each [F], of
[F, h, w] screens: int32 centres, or float32 with the parabola's sub-pixel
fraction; ``score`` is the row axis's best score plus the column axis's.  Its
plain version (:func:`blanking_sync_plain`) is the port's sync as it stood
before the kernel: the row and column profiles by ``torch.sum``, the smoothing,
prefix, score matrices, argmax and parabola of ``ops.framesync``.

The kernel (``csrc/sync.cu``) is bound by memory: it reads the screens once
and writes three numbers a frame.  K2a forms both profiles of every frame in
one pass (blocks of 32 rows of one frame, column partials in shared memory);
K2b takes one block a frame, half of it a row axis and half the column axis,
and smooths, sums, scores every (half-width, centre) window and takes the
argmax in shared memory, never writing the [F, W, n] score matrix.  Its
operations are the plain version's, in its order, one rounding each; its
SUMS are taken in an order fixed by the frame's own shape (lanes over
columns, warps over rows, chunks of 32 rows, and one thread along the
prefix), where ``torch.sum`` and ``torch.cumsum`` choose theirs by the
shape of the whole batch.  So a frame's sync is the same bits in a batch of
1, 36 or 144, and not the plain version's bits: the profiles differ by f32
reassociation (about 1e-7 relative), which the parabola amplifies on prefix
sums of 7e5 and more (``chip_smoke.py`` and ``tests/test_torch_sync_kernel.py``
state the tolerances).

``launch_cost`` counts a call's bytes and operations, for the bound that
``chip_smoke.py`` prints and what a roofline count of a step
(``utils.roofline``) is told.  For a tensor on the CPU the wrapper runs the
plain version; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..utils.roofline import report_launch
from .framesync import (
    _profiles,
    find_blank,
    find_blank_subpixel,
    gaussian_kernel,
    sync_spec_for_axis,
)

__all__ = ["blanking_sync", "blanking_sync_plain", "launch_cost", "CHUNK_ROWS"]

# Rows of one K2a block (``kChunkRows`` in csrc/sync.cu): the column profile is
# summed in chunks of this many rows, then over the chunks in order.
CHUNK_ROWS = 32
_METHODS = {"contrast": 0, "reference": 1}
_PROFILE_WARPS = 8
_BLOCK_SHARED = 227 * 1024
_SEARCH_SHARED = _BLOCK_SHARED - 1024
_MAX_FRAMES = 65535


def _specs(h: int, w: int, y_min_frac: float, x_min_frac: float):
    y_spec, x_spec = sync_spec_for_axis(h, y_min_frac), sync_spec_for_axis(w, x_min_frac)
    for name, spec in (("row", y_spec), ("column", x_spec)):
        if spec.w_min > spec.w_max:
            raise ValueError(
                f"the {name} axis of {spec.n} has no blanking width to search "
                f"(w_min {spec.w_min} > w_max {spec.w_max})")
    return y_spec, x_spec


def _check_method(method: str) -> int:
    if method not in _METHODS:
        raise ValueError(f"unknown sync method {method!r}")
    return _METHODS[method]


def blanking_sync_plain(
    frames: torch.Tensor,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
    subpixel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K2, on any device."""
    _check_method(method)
    _, h, w = frames.shape
    row_p, col_p = _profiles(frames)
    find = find_blank_subpixel if subpixel else find_blank
    s_y, score_y = find(row_p, sync_spec_for_axis(h, y_min_frac), method)
    s_x, score_x = find(col_p, sync_spec_for_axis(w, x_min_frac), method)
    if not subpixel:
        s_y, s_x = s_y.to(torch.int32), s_x.to(torch.int32)
    return s_y, s_x, score_y + score_x


def launch_cost(n_frames: int, h: int, w: int, y_min_frac: float = 0.01,
                x_min_frac: float = 0.05, subpixel: bool = False) -> tuple[int, int]:
    """(bytes, float32 operations) of one K2 call: what its bound on the card
    and a roofline count are computed from.

    Bytes: the screens read once, the three [F] outputs written once; the
    profiles K2a hands to K2b are the kernel's own traffic and no part of the
    bound.  Operations: two adds a pixel (its row's and its column's sum);
    per profile entry nine for the smoothing, one for the total and one for
    the prefix (and one per padding entry); per window score the window's
    difference, the score (six for the contrast: two quotients, three
    differences and the square; the reference's seven) and the argmax's
    comparison, counted at eight; per frame and axis some 40 for the
    parabola and the widths.  The scores are the bulk of the operations and
    a small fraction of the bytes' time."""
    y_spec, x_spec = _specs(int(h), int(w), y_min_frac, x_min_frac)
    nbytes = 4 * n_frames * h * w + 3 * 4 * n_frames
    per_frame = 2 * h * w
    for spec in (y_spec, x_spec):
        windows = (spec.w_max - spec.w_min + 1) * spec.n
        per_frame += 11 * spec.n + 2 * spec.w_max + 8 * windows + (40 if subpixel else 0)
    return nbytes, n_frames * per_frame


def _launch(frames: torch.Tensor, y_min_frac: float, x_min_frac: float, method: int,
            subpixel: bool):
    if frames.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 screens, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("K2 takes contiguous screens")
    n_frames, h, w = (int(d) for d in frames.shape)
    if not 1 <= n_frames <= _MAX_FRAMES:
        raise ValueError(f"K2 takes 1 to {_MAX_FRAMES} frames a call, got {n_frames}")
    if h < 4 or w < 4:
        raise ValueError(f"K2 takes screens of 4x4 or more, got {h}x{w}")
    y_spec, x_spec = _specs(h, w, y_min_frac, x_min_frac)
    profile_bytes = 4 * _PROFILE_WARPS * w
    search_bytes = 4 * (3 * h + 2 * y_spec.w_max + 1 + 3 * w + 2 * x_spec.w_max + 1)
    if profile_bytes > _BLOCK_SHARED or search_bytes > _SEARCH_SHARED:
        raise ValueError(f"screens of {h}x{w} need more shared memory than a block of K2 has")
    from .. import _build

    lib = _build.load_library("sync")
    dev = frames.device
    chunks = -(-h // CHUNK_ROWS)
    row_sums = torch.empty((n_frames, h), dtype=torch.float32, device=dev)
    col_parts = torch.empty((n_frames, chunks, w), dtype=torch.float32, device=dev)
    s_dtype = torch.float32 if subpixel else torch.int32
    s_y = torch.empty(n_frames, dtype=s_dtype, device=dev)
    s_x = torch.empty(n_frames, dtype=s_dtype, device=dev)
    score = torch.empty(n_frames, dtype=torch.float32, device=dev)
    g = [float(v) for v in gaussian_kernel(5)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tt_blanking_sync(
            frames.data_ptr(), row_sums.data_ptr(), col_parts.data_ptr(), n_frames, h, w,
            y_spec.w_min, y_spec.w_max, x_spec.w_min, x_spec.w_max, *g, method, int(subpixel),
            s_y.data_ptr(), s_x.data_ptr(), score.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed with cudaError_t {rc}")
    # One report a kernel: K2a reads the screens and adds every pixel twice,
    # K2b does the rest of launch_cost's count.
    nbytes, flops = launch_cost(n_frames, h, w, y_min_frac, x_min_frac, subpixel)
    screen_bytes, pixel_adds = 4 * n_frames * h * w, 2 * n_frames * h * w
    report_launch(screen_bytes, pixel_adds)
    report_launch(nbytes - screen_bytes, flops - pixel_adds)
    return s_y, s_x, score


def blanking_sync(
    frames: torch.Tensor,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
    subpixel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blanking position of each of the [F, h, w] screens: ``(s_y, s_x,
    score)``, each [F], int32 centres or with ``subpixel`` float32 ones.
    ``y_min_frac`` and ``x_min_frac`` bound the half-widths searched
    (``sync_spec_for_axis``); ``method`` is ``"contrast"`` or
    ``"reference"``."""
    if frames.dim() != 3:
        raise ValueError(f"frames must be [F, h, w], got shape {tuple(frames.shape)}")
    code = _check_method(method)
    if frames.device.type == "cpu":
        return blanking_sync_plain(frames, y_min_frac, x_min_frac, method, subpixel)
    if frames.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {frames.device.type}")
    out = _launch(frames, y_min_frac, x_min_frac, code, subpixel)
    blanking_sync.launches += 2  # K2a and K2b
    return out


# K2's kernel launches since the last reset: two a call, K2a and K2b.
blanking_sync.launches = 0
