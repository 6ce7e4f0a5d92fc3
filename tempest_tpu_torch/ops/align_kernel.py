"""K3, sub-pixel alignment fused with the EMA fold — the port's own kernel for
stages 5 and 6: ``align_frame``, ``align_frame_subpixel`` of
``tempest_tpu/ops/framesync.py`` and ``ema_fold`` of
``tempest_tpu/pipeline/offline.py`` (XLA there, not Pallas).

``align_fold(frames, s_y, s_x, ema, alpha, align, n_streams)`` takes the
[B·F, h, w] screens of B streams (stream-major) and returns ``(aligned,
ema')``:

* ``aligned``: each frame circularly shifted by ``(-s_y, -s_x)``, rows first
  (``align``: ``"integer"``, ``"linear"`` or ``"cubic"``), or the screens
  themselves with ``align=None``;
* ``ema'``: each stream's fold of its F aligned frames into its [h, w] image,
  ``α^F·ema + Σ_n (1−α)·α^(F−1−n)·aligned_n`` in the order the kernel takes
  it: ``S`` summed over the frames in frame order from the first product,
  then ``α^F·ema + S``; ``None`` when no ``ema`` is given.

The plain version (:func:`align_fold_plain`) is the port's alignment
(``ops.framesync``, the JAX package's roll form) followed by that fold, with
the fold weights computed by :func:`fold_weights`.  The kernel decodes each
frame's shifts itself, as :func:`shift_taps` states in torch: the integer
parts and the tap weights (``_interp_weights``) of the fractions, one
rounding per torch operation in torch's order.  Every product and sum of the
kernel is one of the plain version's, in its order, with no FMA, so on the
card the two agree to the bit, aligned frames and EMA.  The fold's order
makes a batched step's EMA the single steps' to the bit, and the fold from a
zero image the ``B`` that a mesh composes as ``A·e + B`` (``A = α^F``, the
same float32 power).  The JAX package, and this package before K3, summed the
frames with one ``einsum``/``tensordot``, whose order is the library's: the
fold agrees with that to f32 reassociation (``tests/test_torch_align_ema.py``
states the tolerance).

The kernel (``csrc/align_ema.cu``) is bound by memory: each screen is read
once and written once aligned, each stream's EMA read and written once.  A
block owns one output row of one stream and walks over the stream's frames in
order, its threads owning fixed columns (four at a time when w % 4 == 0) and
the fold's sums in registers; warp 0 decodes 32 frames' shifts at a time,
loaded a chunk ahead, and the taps' source rows go through a ring of 3-4
stages of ``cp.async`` copies, so that the rows of the next frames are in
flight while a frame is computed.  For float32 and int32 shifts (what the
sync returns; also int64, float64 and the 16-bit floats) the wrapper launches
the kernel and no torch operation: the fold's weights are kept per (alpha, F,
device), the outputs are allocated empty.

For tensors on the CPU the wrapper runs the plain version; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .framesync import _align_frame_plain, _align_frame_subpixel_plain, _interp_weights

__all__ = [
    "ALIGN_MODES",
    "align_fold",
    "align_fold_plain",
    "fold_weights",
    "shift_taps",
    "launch_cost",
]

# align= -> the kernel's taps (0: no shift, the fold alone).
ALIGN_MODES = {None: 0, "integer": 1, "linear": 2, "cubic": 4}
_BLOCK_SHARED = 227 * 1024
_MAX_STREAMS = 65535


def _fold_weights(alpha, n_frames: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    k = torch.arange(n_frames - 1, -1, -1, dtype=torch.float32, device=device)
    return (1.0 - a) * a ** k, a ** n_frames


_cached_fold_weights = functools.lru_cache(maxsize=16)(_fold_weights)


def fold_weights(alpha, n_frames: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(w [F], A): the fold's frame weights ``(1−α)·α^(F−1−n)`` and ``α^F``,
    float32 on ``device``, as ``ema_fold`` has always computed them.  For a
    Python number ``alpha`` they are computed once per (alpha, F, device) and
    kept (a stream's step folds with the same weights block after block):
    read them, do not write them."""
    if isinstance(alpha, (int, float)) and not isinstance(alpha, bool):
        return _cached_fold_weights(float(alpha), int(n_frames), torch.device(device))
    return _fold_weights(alpha, n_frames, device)


def shift_taps(s_y: torch.Tensor, s_x: torch.Tensor,
               align: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(k, weights) of the row and column shifts [N], both axes at once: the
    integer parts (int64 [2, N], rows then columns; the kernel reduces them
    mod h and mod w) and, for ``"linear"`` and ``"cubic"``, the float32 tap
    weights [2, N, taps] of the fractions — the integer parts and weights
    that ``_roll_frac`` takes, element by element.  K3 computes the same in
    the kernel, operation for operation; this is its statement in torch."""
    s = torch.stack([s_y, s_x])
    if align == "integer":
        return s.to(torch.int64), None
    k = torch.floor(s).to(torch.int64)
    f = (s - k.to(s.dtype)).to(torch.float32)
    _, ws = _interp_weights(f, align)
    return k, torch.stack(ws, dim=-1)


def _fold_plain(frames: torch.Tensor, ema: torch.Tensor, alpha, n_streams: int) -> torch.Tensor:
    """The fold in the kernel's order: ``S = w_0·x_0``, ``S = S + w_n·x_n``
    for n = 1..F−1, then ``A·ema + S``; each stream on its own."""
    n_frames = frames.shape[0] // n_streams
    w, big_a = fold_weights(alpha, n_frames, frames.device)
    x = frames.reshape(n_streams, n_frames, *frames.shape[1:])
    s = w[0] * x[:, 0]
    for n in range(1, n_frames):
        s = s + w[n] * x[:, n]
    return (big_a * ema.reshape(s.shape) + s).reshape(ema.shape)


def align_fold_plain(
    frames: torch.Tensor,
    s_y: torch.Tensor | None = None,
    s_x: torch.Tensor | None = None,
    ema: torch.Tensor | None = None,
    alpha=None,
    align: str | None = "linear",
    n_streams: int = 1,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The plain PyTorch version of K3, on any device."""
    if align is None:
        aligned = frames
    elif align == "integer":
        aligned = _align_frame_plain(frames, s_y, s_x)
    else:
        aligned = _align_frame_subpixel_plain(frames, s_y, s_x, align)
    if ema is None:
        return aligned, None
    return aligned, _fold_plain(aligned, ema, alpha, n_streams)


def launch_cost(n_frames: int, h: int, w: int, n_streams: int = 1, align: str | None = "linear",
                write_aligned: bool = True, fold: bool = True) -> tuple[int, int]:
    """(bytes, float32 operations) of one K3 launch over ``n_frames`` screens
    in all (B·F) of ``n_streams`` streams.

    Bytes: the screens read once, the aligned screens written once (when
    they are), each stream's EMA read and written once, the per-frame shifts
    (two int64) and weights and the fold's weights read once.  Operations per pixel: a
    product per tap and an add per tap after the first, for the row pass and
    again for the column pass (an integer shift does none); with the fold a
    product and an add; per EMA pixel a product and an add."""
    taps = ALIGN_MODES[align]
    pixels = n_frames * h * w
    nbytes = 4 * pixels * (2 if write_aligned else 1)
    if taps:
        nbytes += 16 * n_frames + (8 * taps * n_frames if taps > 1 else 0)
    flops = 2 * pixels * (2 * taps - 1) if taps > 1 else 0
    if fold:
        frames_per_stream = n_frames // n_streams
        nbytes += 8 * n_streams * h * w + 4 * frames_per_stream + 4
        flops += 2 * pixels + 2 * n_streams * h * w
    return nbytes, flops


def _check(frames, s_y, s_x, ema, align, n_streams):
    if align not in ALIGN_MODES:
        raise ValueError(f"align must be None, 'integer', 'linear' or 'cubic', got {align!r}")
    if frames.dim() != 3:
        raise ValueError(f"frames must be [N, h, w], got shape {tuple(frames.shape)}")
    n = frames.shape[0]
    if n == 0 or n_streams < 1 or n % n_streams:
        raise ValueError(f"{n} frames do not split into {n_streams} streams")
    if align is not None:
        for name, s in (("s_y", s_y), ("s_x", s_x)):
            if s is None or s.shape != (n,) or s.device != frames.device:
                raise ValueError(f"{name} must be one shift per frame on {frames.device}")
    if ema is None:
        if align is None:
            raise ValueError("align_fold with align=None folds: it needs an EMA image")
        return
    h, w = frames.shape[1:]
    shapes = [(n_streams, h, w)] + ([(h, w)] if n_streams == 1 else [])
    if ema.device != frames.device or tuple(ema.shape) not in shapes:
        raise ValueError(
            f"ema must be [{n_streams}, {h}, {w}] (or [{h}, {w}] for one stream) on "
            f"{frames.device}, got {tuple(ema.shape)} on {ema.device}")


# Shift dtypes K3 decodes itself (csrc/align_ema.cu's ShiftType); other
# integer dtypes go in as int64, which is what the plain version makes of them.
_SHIFT_TYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3,
                torch.float16: 4, torch.bfloat16: 5}
_MAX_THREADS = 1024
_MAX_UNITS = 2
_FRAME_SLOTS_BYTES = 64 * 44   # the kernel's static ring of decoded frames


def launch_shape(w: int, taps: int, vec: bool) -> tuple[int, int, int]:
    """(threads, units, dynamic shared bytes) of a K3 block for rows of
    ``w``: each thread owns ``units`` (at most 2) columns, or quads of
    columns when ``vec``; the ring holds 4 stages of the taps' source rows (3
    for cubic) and, with a row pass, one shared row.  Raises for rows wider
    than a block covers or than its shared memory holds."""
    cover = w // 4 if vec else w
    units = 1 if cover <= _MAX_THREADS else _MAX_UNITS
    per_unit = -(-cover // units)
    threads = 32 * -(-per_unit // 32)
    rows = (3 if taps == 4 else 4) * max(taps, 1) + (1 if taps > 1 else 0)
    smem = 4 * w * rows
    if threads > _MAX_THREADS or smem + _FRAME_SLOTS_BYTES > _BLOCK_SHARED:
        raise ValueError(f"screens {w} wide need more than a block of K3 holds "
                         f"({cover} {'quads' if vec else 'columns'}, {smem} bytes of rows)")
    return threads, units, smem


def _kernel_shifts(s: torch.Tensor) -> torch.Tensor:
    """The shifts as the kernel reads them: as they are for the dtypes it
    decodes (no torch operation when contiguous), other integers as int64."""
    if s.dtype not in _SHIFT_TYPES:
        if s.dtype.is_floating_point or s.dtype.is_complex or s.dtype == torch.bool:
            raise TypeError(f"K3 takes integer or real floating shifts, got {s.dtype}")
        s = s.to(torch.int64)
    return s.contiguous()


def _prepare(n: int, h: int, w: int, n_streams: int, align: str | None, fold: bool,
             types: tuple[int, int], vec: bool, device: torch.device):
    """What one K3 launch over [n, h, w] screens needs besides its tensors,
    worked out once: ``issue(frames, aligned, ema, ema_out, s_y, s_x,
    fold_w, big_a)`` takes their addresses (None for a tensor not given)
    and launches through ``_build.launch``.  ``types``: the shifts' codes
    (``_SHIFT_TYPES``); ``vec``: every row of the screens, the aligned
    screens and the EMAs starts on 16 bytes and ``w % 4 == 0``."""
    if n_streams > _MAX_STREAMS:
        raise ValueError(f"K3 takes at most {_MAX_STREAMS} streams a launch, got {n_streams}")
    taps = ALIGN_MODES[align]
    threads, units, _ = launch_shape(w, taps, vec)
    launcher = _build.load_library("align_ema").tt_align_fold
    costs, variant = (launch_cost(n, h, w, n_streams, align, taps > 0, fold),), (align, fold)
    shape = (h, w, n // n_streams, n_streams, taps, int(vec), threads, units)

    def issue(frames, aligned, ema, ema_out, s_y, s_x, fold_w, big_a) -> None:
        _build.launch("k3", launcher, device, costs, variant,
                      frames, aligned, ema, ema_out, s_y, s_x, *types, fold_w, big_a, *shape)

    return issue


def _launch(frames, s_y, s_x, ema, alpha, align, n_streams):
    for name, t in (("frames", frames), ("ema", ema)):
        if t is not None and (t.dtype != torch.float32 or not t.is_contiguous()):
            raise TypeError(f"K3 takes contiguous float32 {name}, got {t.dtype}")
    n, h, w = (int(d) for d in frames.shape)
    taps = ALIGN_MODES[align]
    fold = ema is not None
    dev = frames.device
    types = (0, 0)
    if taps:
        s_y, s_x = (_kernel_shifts(s) for s in (s_y, s_x))
        types = (_SHIFT_TYPES[s_y.dtype], _SHIFT_TYPES[s_x.dtype])
    else:
        s_y = s_x = None
    aligned = torch.empty_like(frames) if taps else None
    fold_w = big_a = ema_out = None
    if fold:
        fold_w, big_a = fold_weights(alpha, n // n_streams, dev)
        ema_out = torch.empty_like(ema)
    rows = [t for t in (frames, aligned, ema, ema_out) if t is not None]
    vec = w % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _prepare(n, h, w, n_streams, align, fold, types, vec, dev)(
        frames.data_ptr(), ptr(aligned), ptr(ema), ptr(ema_out), ptr(s_y), ptr(s_x),
        ptr(fold_w), ptr(big_a))
    return (frames if aligned is None else aligned), ema_out


def align_fold(
    frames: torch.Tensor,
    s_y: torch.Tensor | None = None,
    s_x: torch.Tensor | None = None,
    ema: torch.Tensor | None = None,
    alpha=None,
    align: str | None = "linear",
    n_streams: int = 1,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Align the [B·F, h, w] ``frames`` of ``n_streams`` streams by ``(-s_y,
    -s_x)`` and fold each stream's aligned frames into its EMA image: returns
    ``(aligned [B·F, h, w], ema' or None)``.

    ``s_y``, ``s_x``: one shift per frame on the frames' device (int for
    ``align="integer"``, float for ``"linear"`` and ``"cubic"``; unread with
    ``align=None``, where the frames are folded as they are and returned as
    ``aligned``).  ``ema``: [B, h, w] (or [h, w] for one stream), or None for
    the alignment alone; ``alpha`` the EMA's coefficient, a float or a
    0-dim tensor."""
    _check(frames, s_y, s_x, ema, align, n_streams)
    if frames.device.type == "cpu":
        return align_fold_plain(frames, s_y, s_x, ema, alpha, align, n_streams)
    if frames.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {frames.device.type}")
    return _launch(frames, s_y, s_x, ema, alpha, align, n_streams)
