"""K2, the blanking sync on the card — the port's own kernel for stage 4,
``frame_sync`` and ``frame_sync_subpixel`` of ``tempest_tpu/ops/framesync.py``
(XLA there, not Pallas).

``blanking_sync(frames, ...)`` returns ``(s_y, s_x, score)``, each [F], of
[F, h, w] screens: int32 centres, or float32 with the parabola's sub-pixel
fraction; ``score`` is the row axis's best score plus the column axis's.  With
``pairs=True`` it also returns the [F, 2] ``(s_y, s_x)`` rows a step returns
as its sync, written by the kernel itself.  Its plain version
(:func:`blanking_sync_plain`) is the port's sync as it stood before the
kernel: the row and column profiles by ``torch.sum``, the smoothing, prefix,
score matrices, argmax and parabola of ``ops.framesync``.

The kernel (``csrc/sync.cu``) is two launches.  K2a forms both profiles of
every frame in one pass over the screens (blocks of 32 rows of one frame,
column partials in shared memory), bound by their bytes.  K2b searches every
(half-width, centre) window of both axes, bound by the instructions of its
scores (two IEEE divisions each): a thread-block cluster a frame, sized by
:func:`search_split` from F and how many clusters the card holds at once.
Every block of the cluster sums a slice of the column profile into the
column leader's shared memory; the two axis leaders smooth
their profiles and form the total and the prefix (two register chains on
two threads); then every block copies the prefixes through distributed
shared memory and scores an equal, contiguous slice of all the frame's
windows.  Each block's best window of each axis meets the others' in that
axis's leader in the argmax's strict total order, so the result does not
depend on the split.  Its operations are the plain version's, in its order,
one rounding each; its SUMS are taken in an order fixed by the frame's own
shape (lanes over columns, warps over rows, chunks of 32 rows, and one
thread along the prefix), where ``torch.sum`` and ``torch.cumsum`` choose
theirs by the shape of the whole batch.  So a frame's sync is the same bits
in a batch of 1, 36 or 144, under any cluster size, and not the plain
version's bits: the profiles differ by f32 reassociation (about 1e-7
relative), which the parabola amplifies on prefix sums of 7e5 and more
(``chip_smoke.py`` and ``tests/test_torch_sync_kernel.py`` state the
tolerances).

``launch_cost`` counts a call's bytes and operations, for the bound that
``chip_smoke.py`` prints and what a roofline count of a step
(``utils.roofline``) is told; ``search_cost`` K2b's own bytes and
instructions.  For a tensor on the CPU the wrapper runs the plain version; for
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .framesync import (
    _profiles,
    find_blank,
    find_blank_subpixel,
    gaussian_kernel,
    sync_spec_for_axis,
)

__all__ = [
    "blanking_sync",
    "blanking_sync_plain",
    "launch_cost",
    "profiles_cost",
    "search_cost",
    "search_split",
    "slice_bounds",
    "shared_bytes",
    "clock_stamps",
    "CHUNK_ROWS",
    "H100_ISSUE_PER_S",
]

# Rows of one K2a block (``kChunkRows`` in csrc/sync.cu): the column profile is
# summed in chunks of this many rows, then over the chunks in order.
CHUNK_ROWS = 32
_METHODS = {"contrast": 0, "reference": 1}
_GAUSSIAN_TAPS = tuple(float(v) for v in gaussian_kernel(5))
_PROFILE_WARPS = 8
_BLOCK_SHARED = 227 * 1024
_SEARCH_SHARED = _BLOCK_SHARED - 1024
_MAX_FRAMES = 65535
_MAX_CLUSTER = 8          # a frame's cluster, both axes (portable cluster size)
# The card's instruction issue rate: one warp instruction per cycle on each of
# an SM's 4 schedulers, 132 SMs at the H100 SXM's 1,980 MHz boost clock (half
# the 67 TFLOP/s float32 rate, which counts an FMA as two operations).
H100_ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# The least SASS instructions one contrast window needs, with every term that
# depends only on the half-width (2w + 1, n - (2w + 1) and their reciprocals)
# hoisted out of the loop over centres: the two prefix loads; the window's
# difference and total - window; each correctly rounded quotient from its
# hoisted reciprocal as a product and two FMAs (q = a·r, e = a - b·q,
# q + e·r), the range check a division also makes left out; the difference
# of the means, its square, and the argmax's comparison.  K2b's bound counts
# these at the card's issue rate; what the kernel issues beyond them (index
# arithmetic, the divisions' full sequences, the loop) is its gap to it.
SCORE_INSTRUCTIONS = 2 + 2 + 2 * 3 + 2 + 1


def _specs(h: int, w: int, y_min_frac: float, x_min_frac: float):
    y_spec, x_spec = sync_spec_for_axis(h, y_min_frac), sync_spec_for_axis(w, x_min_frac)
    for name, spec in (("row", y_spec), ("column", x_spec)):
        if spec.w_min > spec.w_max:
            raise ValueError(
                f"the {name} axis of {spec.n} has no blanking width to search "
                f"(w_min {spec.w_min} > w_max {spec.w_max})")
    return y_spec, x_spec


def _windows(spec) -> int:
    return (spec.w_max - spec.w_min + 1) * spec.n


def _check_method(method: str) -> int:
    if method not in _METHODS:
        raise ValueError(f"unknown sync method {method!r}")
    return _METHODS[method]


def search_split(n_frames: int, max_clusters) -> int:
    """The blocks of a frame's K2b cluster, each scoring an equal slice of
    the frame's windows (both axes): 6 while the card holds the F clusters of
    6 at once (``max_clusters(6)``, one wave), else 3.  The rule of a sweep of
    every size from 2 to 8 on an NVIDIA H100 80GB HBM3 at 700 W
    (``exp/k2_clocks.py``): 6 was the fastest at 36 frames of 600x800, 3 at
    144, and 3 within 1.4 us of the fastest (2) at the mode search's 52 of
    150x200."""
    return 6 if n_frames <= max_clusters(6) else 3


def slice_bounds(count: int, parts: int) -> list[int]:
    """The kernel's slices of ``count`` flat (w - w_min)·n + c indices over
    ``parts`` blocks: slice k is [bounds[k], bounds[k + 1])."""
    return [count * k // parts for k in range(parts + 1)]


def _quad_up(n: int) -> int:
    return -(-n // 4) * 4


def shared_bytes(h: int, w: int, y_min_frac: float = 0.01,
                 x_min_frac: float = 0.05) -> tuple[int, int]:
    """(K2a, K2b) dynamic shared memory of a block: 8 warps' column partials;
    both axes' prefixes (each 3 floats in) and an axis leader's padded
    profile, smoothed profile and raw profile, as long as the longer axis
    needs, each from a 16-byte boundary (``layout`` in csrc/sync.cu)."""
    y_spec, x_spec = _specs(h, w, y_min_frac, x_min_frac)
    p_x = _quad_up(3 + y_spec.n + 2 * y_spec.w_max + 1) + 3
    ext = _quad_up(p_x + x_spec.n + 2 * x_spec.w_max + 1)
    n = max(y_spec.n, x_spec.n)
    total = ext + _quad_up(_chain(y_spec, x_spec)) + _quad_up(n) + n
    return 4 * _PROFILE_WARPS * w, 4 * total


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
        per_frame += 11 * spec.n + 2 * spec.w_max + 8 * _windows(spec) + (40 if subpixel else 0)
    return nbytes, n_frames * per_frame


def profiles_cost(n_frames: int, h: int, w: int) -> tuple[int, int]:
    """(bytes, float32 operations) of K2a alone: the screens read once and
    the profiles K2b reads (the row sums and the 32-row column partials)
    written once; two adds a pixel."""
    chunks = -(-h // CHUNK_ROWS)
    return 4 * n_frames * h * w + 4 * n_frames * (h + chunks * w), 2 * n_frames * h * w


def search_cost(n_frames: int, h: int, w: int, y_min_frac: float = 0.01,
                x_min_frac: float = 0.05) -> tuple[int, int]:
    """(bytes, instructions) of K2b alone: the profiles K2a left (the row
    sums and the 32-row column partials) read once and the three [F] outputs
    written once; ``SCORE_INSTRUCTIONS`` a window, the least a contrast
    score and its comparison need.
    Its bound is the larger of the bytes at the memory rate
    (``utils.roofline.H100_PEAKS``) and the instructions at the card's issue
    rate (``H100_ISSUE_PER_S``)."""
    y_spec, x_spec = _specs(int(h), int(w), y_min_frac, x_min_frac)
    chunks = -(-h // CHUNK_ROWS)
    nbytes = 4 * n_frames * (h + chunks * w) + 3 * 4 * n_frames
    return nbytes, n_frames * SCORE_INSTRUCTIONS * (_windows(y_spec) + _windows(x_spec))


def _chain(y_spec, x_spec) -> int:
    return max(spec.n + 2 * spec.w_max for spec in (y_spec, x_spec))


def _split(n_frames: int, h: int, w: int, y_min_frac: float, x_min_frac: float,
           index: int) -> int:
    """:func:`search_split` on card ``index``, by its own cluster occupancy."""
    smem = shared_bytes(h, w, y_min_frac, x_min_frac)[1]
    return search_split(n_frames, functools.partial(_max_clusters, index, smem))


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, smem: int, size: int) -> int:
    """The card's count of resident K2b clusters of ``size`` blocks
    (``cudaOccupancyMaxActiveClusters``), kept per shared-memory size: a
    stream's step asks the same every block."""
    import ctypes

    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _build.load_library("sync").tt_sync_max_clusters(size, smem, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"K2's cluster occupancy query failed with cudaError_t {rc}")
    return out.value


def _prepare(n_frames: int, h: int, w: int, y_min_frac: float, x_min_frac: float, method: int,
             subpixel: bool, device: torch.device, timed: bool = False,
             split: int | None = None):
    """What one K2 call on [n_frames, h, w] screens needs besides its
    tensors, worked out once: ``(scratch, issue)``.  ``scratch`` is the
    float32 elements of the row sums and of the column partials;
    ``issue(frames, row_sums, col_parts, s_y, s_x, score, sync, after=())``
    takes their addresses (``sync`` None without pairs) and launches both
    kernels through ``_build.launch``."""
    if not 1 <= n_frames <= _MAX_FRAMES:
        raise ValueError(f"K2 takes 1 to {_MAX_FRAMES} frames a call, got {n_frames}")
    if h < 4 or w < 4:
        raise ValueError(f"K2 takes screens of 4x4 or more, got {h}x{w}")
    y_spec, x_spec = _specs(h, w, y_min_frac, x_min_frac)
    profile_bytes, search_bytes = shared_bytes(h, w, y_min_frac, x_min_frac)
    if profile_bytes > _BLOCK_SHARED or search_bytes > _SEARCH_SHARED:
        raise ValueError(f"screens of {h}x{w} need more shared memory than a block of K2 has")
    lib = _build.load_library("sync")
    cluster = split or _split(n_frames, h, w, y_min_frac, x_min_frac, device.index)
    # Two kernels: K2a reads the screens and adds every pixel twice, K2b does
    # the rest of launch_cost's count.
    nbytes, flops = launch_cost(n_frames, h, w, y_min_frac, x_min_frac, subpixel)
    screen_bytes, pixel_adds = 4 * n_frames * h * w, 2 * n_frames * h * w
    costs = ((screen_bytes, pixel_adds), (nbytes - screen_bytes, flops - pixel_adds))
    launcher = lib.tt_blanking_sync_timed if timed else lib.tt_blanking_sync
    widths = (y_spec.w_min, y_spec.w_max, x_spec.w_min, x_spec.w_max)

    def issue(frames, row_sums, col_parts, s_y, s_x, score, sync, after=()) -> None:
        _build.launch("k2", launcher, device, costs, None,
                      frames, row_sums, col_parts, n_frames, h, w, *widths, *_GAUSSIAN_TAPS,
                      method, int(subpixel), cluster, s_y, s_x, score, sync, after=after)

    return (n_frames * h, n_frames * -(-h // CHUNK_ROWS) * w), issue


def _launch(frames: torch.Tensor, y_min_frac: float, x_min_frac: float, method: int,
            subpixel: bool, pairs: bool, clocks: torch.Tensor | None = None,
            split: int | None = None):
    if frames.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 screens, got {frames.dtype}")
    if not frames.is_contiguous():
        raise ValueError("K2 takes contiguous screens")
    n_frames, h, w = (int(d) for d in frames.shape)
    dev = frames.device
    (n_rows, n_cols), issue = _prepare(n_frames, h, w, y_min_frac, x_min_frac, method, subpixel,
                                       dev, clocks is not None, split)
    row_sums = torch.empty(n_rows, dtype=torch.float32, device=dev)
    col_parts = torch.empty(n_cols, dtype=torch.float32, device=dev)
    s_dtype = torch.float32 if subpixel else torch.int32
    s_y = torch.empty(n_frames, dtype=s_dtype, device=dev)
    s_x = torch.empty(n_frames, dtype=s_dtype, device=dev)
    score = torch.empty(n_frames, dtype=torch.float32, device=dev)
    sync = torch.empty((n_frames, 2), dtype=s_dtype, device=dev) if pairs else None
    issue(frames.data_ptr(), row_sums.data_ptr(), col_parts.data_ptr(), s_y.data_ptr(),
          s_x.data_ptr(), score.data_ptr(), None if sync is None else sync.data_ptr(),
          after=() if clocks is None else (clocks.data_ptr(),))
    return (s_y, s_x, score) + ((sync,) if pairs else ())


def blanking_sync(
    frames: torch.Tensor,
    y_min_frac: float = 0.01,
    x_min_frac: float = 0.05,
    method: str = "contrast",
    subpixel: bool = False,
    pairs: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Blanking position of each of the [F, h, w] screens: ``(s_y, s_x,
    score)``, each [F], int32 centres or with ``subpixel`` float32 ones.
    ``y_min_frac`` and ``x_min_frac`` bound the half-widths searched
    (``sync_spec_for_axis``); ``method`` is ``"contrast"`` or
    ``"reference"``.  With ``pairs`` a fourth tensor, [F, 2] of the centres'
    type, holds ``(s_y, s_x)`` a row (on the card written by the kernel, on
    the CPU stacked)."""
    if frames.dim() != 3:
        raise ValueError(f"frames must be [F, h, w], got shape {tuple(frames.shape)}")
    code = _check_method(method)
    if frames.device.type == "cpu":
        out = blanking_sync_plain(frames, y_min_frac, x_min_frac, method, subpixel)
        return out + ((torch.stack(out[:2], dim=1),) if pairs else ())
    if frames.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {frames.device.type}")
    return _launch(frames, y_min_frac, x_min_frac, code, subpixel, pairs)


def clock_stamps(frames: torch.Tensor, subpixel: bool = True,
                 split: int | None = None) -> tuple[list[str], torch.Tensor]:
    """One K2 call on CUDA ``frames`` with K2b's stamps on: ``(labels,
    stamps)``, ``stamps`` int64 [F, 2, 10] on the card, taken by thread 0 of
    the block that leads frame f's row axis (1: its column axis): stamp k <
    8 the ``clock64()`` count when the phase that ``labels[k]`` names has
    ended (0 is the block's start), 8 and 9 the global timer's nanoseconds
    at the block's start and end; ``split`` a cluster size to force.  A
    measurement aid (``exp/k2_clocks.py``), recorded as K2's two launches as
    any call is."""
    clocks = torch.zeros((frames.shape[0], 2, 10), dtype=torch.int64, device=frames.device)
    _launch(frames.contiguous(), 0.01, 0.05, 0, subpixel, False, clocks, split)
    labels = _build.load_library("sync").tt_sync_clock_labels().decode().split(",")
    return labels, clocks
