"""K1, the fused multi-frame resampler — the counterpart of
``tempest_tpu/ops/pallas_resample.py``.

``frames_to_screens`` maps every frame of one envelope block to its
(h, w) screen: for output row r it reads two scan lines (vertical taps) at
affine positions ``frac + c·delta`` along the scan, interpolates each
linearly, and blends them by ``wr[r]``.  ``frames_to_screens_from_words``
does the same from the raw interleaved I/Q words of the block (int16 or
float32), taking the AM envelope ``sqrt(I² + Q²)`` on the way, so that the
envelope is never written to device memory.  Both follow the Pallas kernel's
boundary semantics, not the gather path's:

* line starts are clamped at 0 and the negative remainder is folded into
  the fraction, and positions are lower-clipped at 0;
* reads past the frame end take the real following samples;
* reads past the block end see the last envelope value (the read index is
  clamped at ``N-1`` instead of copying the envelope into a padded buffer).

The Pallas kernel carries fractions and ``wr`` in 16.16 fixed point (a
scalar-prefetch constraint); here they stay float32, so the two differ by
at most 2⁻¹⁷ sample in position.

The kernel (``csrc/resample.cu``) is bound by memory: a block's input is
read once and its screens are written once, with nothing to reuse but the
scan line two neighbouring rows share.  Its design moves those bytes once
and wide: a tile of a few output rows (``ROWS_PER_TILE``) reads one contiguous run
of the block, staged with 16-byte asynchronous copies into one of two
shared-memory buffers while the previous tile is computed (``tile_plan``
sizes them); I/Q pairs become
envelope samples in shared memory; every thread writes four adjacent pixels
as one 16-byte store.  Tiles that touch the block end are staged sample by
sample through the index clamp.

For a tensor on the CPU each wrapper runs the plain PyTorch version below.
For a CUDA tensor it launches the hand-written kernel or raises; it never
falls back.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .demod import am_envelope_from_iq
from .resample import RENDER_SIZE, _screen_geometry

__all__ = [
    "ScreenGeometry",
    "screen_geometry",
    "frames_to_screens",
    "frames_to_screens_from_words",
    "frames_to_screens_plain",
    "frame_to_screen",
]

# Output rows of one tile (at most 32), by the bytes of a staged sample: a
# tile of 8 rows of 4-byte samples and one of 4 rows of 8-byte samples stage
# about as much (36 and 48 KB at 1080p60, 20 Msps), so that several blocks
# share an SM.
ROWS_PER_TILE = {4: 8, 8: 4}
# Dynamic shared memory one block may ask for: the card's 227 KB less the
# 768 bytes of the kernel's static row table.
MAX_SHARED_BYTES = 227 * 1024 - 768
# What the kernel stages: code and bytes per sample, by the tensor's dtype.
_ENVELOPE = (0, 4)
_WORDS = {torch.int16: (1, 4), torch.float32: (2, 8)}


@dataclasses.dataclass(frozen=True)
class ScreenGeometry:
    """Per-config line tables of the resampler, resident on one device."""

    line_start: torch.Tensor  # int32 [h, 2], clamped at 0
    line_frac: torch.Tensor   # float32 [h, 2], may be negative on row 0
    wr: torch.Tensor          # float32 [h], vertical blend weight
    delta: float              # samples per output column (a float32 value)
    span: int                 # samples one scan line reads
    out_shape: tuple[int, int]


def _line_tables(frame_len: int, y_t: int, x_t: int, out_shape: tuple[int, int]):
    """Host tables of the resampler from the shared ``_screen_geometry``:
    (line_start [h,2] clamped at 0, line_frac [h,2] with the negative
    remainder folded in, wr [h], delta, span)."""
    start, frac, wr, cols, _ = _screen_geometry(frame_len, y_t, x_t, out_shape)
    delta = float(np.float32(cols[1])) if out_shape[1] > 1 else 0.0
    line_start = np.maximum(start, 0)
    line_frac = (frac + (start - line_start)).astype(np.float32)
    # floor(pos) + 1 must stay inside the span: pos < (w-1)·delta + 1.
    span = int(np.ceil(cols[-1] + 1)) + 2
    return line_start, line_frac, np.ascontiguousarray(wr[:, 0]), delta, span


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
    line_start, line_frac, wr, delta, span = _line_tables(frame_len, y_t, x_t, out_shape)
    dev = torch.device(device)
    return ScreenGeometry(
        line_start=torch.from_numpy(line_start.astype(np.int32)).to(dev),
        line_frac=torch.from_numpy(line_frac).to(dev),
        wr=torch.from_numpy(wr).to(dev),
        delta=delta,
        span=span,
        out_shape=(int(out_shape[0]), int(out_shape[1])),
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


@functools.lru_cache(maxsize=64)
def tile_run_cap(
    frame_len: int, y_t: int, x_t: int, out_shape: tuple[int, int], rows_per_tile: int
) -> int:
    """Samples one stage buffer of the kernel must hold: the longest
    contiguous run that a tile of ``rows_per_tile`` output rows reads (first
    row's upper line start to last row's lower line start plus the span),
    plus 3 samples of 16-byte alignment slack at each end, as a multiple of
    4.  The kernel takes a tile's run from its first and last row, so the
    line starts must not decrease along the rows."""
    h = out_shape[0]
    line_start, _, _, _, span = _line_tables(frame_len, y_t, x_t, out_shape)
    if (np.diff(line_start, axis=0) < 0).any() or (line_start[:, 1] < line_start[:, 0]).any():
        raise ValueError("K1 takes line starts that do not decrease along the rows")
    first = np.arange(0, h, rows_per_tile)
    last = np.minimum(first + rows_per_tile, h) - 1
    run = int((line_start[last, 1] + span - line_start[first, 0]).max())
    return (run + 6 + 3) // 4 * 4


def tile_plan(
    frame_len: int, y_t: int, x_t: int, out_shape: tuple[int, int], sample_bytes: int
) -> tuple[int, int]:
    """(rows of a tile, samples of a stage buffer) for staged samples of
    ``sample_bytes``: ``ROWS_PER_TILE`` rows where a block's shared memory
    holds them.  A block has two stage buffers of the run and, for 8-byte
    pairs, a buffer for the envelope they become.  A screen of far fewer
    rows than the raster has scan lines spreads a tile's rows over a long
    run, so the rows are halved, down to one, until the buffers fit."""
    per_sample = 2 * sample_bytes + (4 if sample_bytes == 8 else 0)
    rows = ROWS_PER_TILE[sample_bytes]
    while rows > 1 and tile_run_cap(frame_len, y_t, x_t, out_shape, rows) * per_sample > MAX_SHARED_BYTES:
        rows //= 2
    run_cap = tile_run_cap(frame_len, y_t, x_t, out_shape, rows)
    if run_cap * per_sample > MAX_SHARED_BYTES:
        raise ValueError(
            f"a tile of {rows} rows stages {run_cap * per_sample} bytes, more than the "
            f"{MAX_SHARED_BYTES} bytes of shared memory of one block")
    return rows, run_cap


def _launch(
    src: torch.Tensor,
    n_samples: int,
    staged: tuple[int, int],
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int],
) -> torch.Tensor:
    """Check the arguments and launch the kernel on ``src``'s device, on the
    current stream.  ``staged`` is (what ``src`` holds, bytes per sample)."""
    if src.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {src.device.type}")
    if frame_starts.dtype != torch.int32:
        raise TypeError(f"K1 takes int32 frame starts, got {frame_starts.dtype}")
    if not (src.is_contiguous() and frame_starts.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    n_frames = frame_starts.shape[0]
    if n_frames == 0 or n_samples == 0:
        raise ValueError(f"K1 takes at least one frame and one sample, got {n_frames}, {n_samples}")
    word, sample_bytes = staged
    out_shape = (int(out_shape[0]), int(out_shape[1]))
    raster = (int(frame_len), int(y_t), int(x_t), out_shape)
    geom = screen_geometry(*raster, src.device)
    rows, run_cap = tile_plan(*raster, sample_bytes)
    from .. import _build

    lib = _build.load_library("resample")
    h, w = out_shape
    out = torch.empty((n_frames, h, w), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.tt_resample_frames(
            src.data_ptr(), n_samples, word, frame_starts.data_ptr(), n_frames,
            geom.line_start.data_ptr(), geom.line_frac.data_ptr(), geom.wr.data_ptr(),
            out.data_ptr(), h, w, geom.delta, geom.span, rows, run_cap, stream,
        )
    if rc != 0:
        raise RuntimeError(f"K1 launch failed with cudaError_t {rc}")
    return out


def _check_block(block: torch.Tensor, frame_starts: torch.Tensor, what: str) -> None:
    if block.dim() != 1 or frame_starts.dim() != 1:
        raise ValueError(f"{what} and frame_starts must be 1-D")
    if block.device != frame_starts.device:
        raise ValueError(f"{what} on {block.device} but frame_starts on {frame_starts.device}")


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
    _check_block(env, frame_starts, "env")
    if env.device.type == "cpu":
        geom = screen_geometry(int(frame_len), int(y_t), int(x_t), tuple(out_shape), env.device)
        return frames_to_screens_plain(env, frame_starts, geom)
    if env.dtype != torch.float32:
        raise TypeError(f"K1 takes a float32 envelope, got {env.dtype}")
    out = _launch(env, env.shape[0], _ENVELOPE, frame_starts, frame_len, y_t, x_t, out_shape)
    frames_to_screens.launches += 1
    return out


frames_to_screens.launches = 0  # K1 launches on an envelope since the last reset


def frames_to_screens_from_words(
    words: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
) -> torch.Tensor:
    """All frames of a block of raw I/Q → (n_frames, h, w) float32 screens,
    equal to ``frames_to_screens(am_envelope_from_iq(words), ...)``.

    ``words`` holds the block's interleaved I/Q words (2N,), int16 or
    float32.  An odd trailing word is dropped, on either device, as the
    demod does.  On a CUDA tensor the words must be contiguous and of one
    of those two types: the kernel reads them as they lie, where the demod
    would first convert and copy them."""
    _check_block(words, frame_starts, "words")
    if words.device.type == "cpu":
        geom = screen_geometry(int(frame_len), int(y_t), int(x_t), tuple(out_shape), words.device)
        return frames_to_screens_plain(am_envelope_from_iq(words), frame_starts, geom)
    if words.dtype not in _WORDS:
        raise TypeError(f"K1 takes int16 or float32 I/Q words, got {words.dtype}")
    out = _launch(words, words.shape[0] // 2, _WORDS[words.dtype], frame_starts,
                  frame_len, y_t, x_t, out_shape)
    frames_to_screens_from_words.launches += 1
    return out


frames_to_screens_from_words.launches = 0  # K1 launches on I/Q words since the last reset


def frame_to_screen(
    sig: torch.Tensor, y_t: int, x_t: int, out_shape: tuple[int, int] = RENDER_SIZE
) -> torch.Tensor:
    """One frame's envelope → (h, w) screen, through the same resampler."""
    starts = torch.zeros(1, dtype=torch.int32, device=sig.device)
    return frames_to_screens(sig, starts, sig.shape[0], y_t, x_t, out_shape)[0]
