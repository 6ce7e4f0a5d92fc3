"""K1, the fused multi-frame resampler — the counterpart of
``tempest_tpu/ops/pallas_resample.py``.

``frames_to_screens`` maps every frame of one envelope block to its
(h, w) screen: for output row r it reads two scan lines (vertical taps) at
affine positions ``frac + c·delta`` along the scan, interpolates each with 2
taps (linear) or 4 (Catmull-Rom, ``interp_taps``), and blends them by
``wr[r]``.  With ``frac_offsets`` every position of frame f moves on by that
frame's fractional residual in [0, 1): frame cuts exact to the sub-sample,
where ``frame_starts`` alone cuts at whole samples.
``frames_to_screens_from_words``
does the same from the raw interleaved I/Q words of the block (int16 or
float32), taking the AM envelope ``sqrt(I² + Q²)`` or the FM discriminator
on the way (``demod=``), inverted as ``1 - env / max(env)`` where asked
(``invert=``: the config's ``invert``; the maximum is ``words_maxima``, one
launch of its own before K1), rounded to bfloat16 where asked (``bf16=``: the
``mxu3``, ``mxu4`` and ``mxu_batched`` chains), so that the envelope is never
written to device memory.  With ``streams=B`` the words are B streams of
equal length laid end to end, each with an equal share of the frames (the
batched step): each stream is demodulated, inverted and clamped as if it
were launched alone.  Both entries follow the Pallas kernel's boundary
semantics, not the gather path's:

* line starts are clamped at 0 and the negative remainder is folded into
  the fraction, and positions are lower-clipped at 0;
* reads past the frame end take the real following samples;
* reads past the block end see the last envelope value (the read index is
  clamped at ``N-1`` instead of copying the envelope into a padded buffer;
  with streams, into the frame's own stream);
* the 4 taps sit at offsets -1, 0, 1, 2 around the floor of the position and
  obey the same clamp into the block: tap -1 of a line reads the real sample
  before the line start, and sample 0 where the line starts at sample 0 of
  the block.  (The JAX package's 4-tap weight tables replicate the border of
  each line's span instead, which differs in the first output columns.)

The Pallas kernel carries fractions and ``wr`` in 16.16 fixed point (a
scalar-prefetch constraint); here they stay float32, so the two differ by
at most 2⁻¹⁷ sample in position.

With ``num_phases`` the line fractions are quantised on the host before they
go to the card (``quantise_line_frac``): the read of the JAX package's
``mxu`` resamplers, through the same kernel and the same plain version.  The
line starts, and so the staging plan, do not change.

``frames_to_screens_candidates`` renders the same frames under each raster of
a candidate set (the mode search) in ONE launch: every candidate's line
tables and tile plan are stacked into one int32 table on the card
(``candidate_table``, cached per set as ``screen_geometry`` is per raster),
the kernel's tiles run over (candidate, frame, tile), and each pixel is the
same expression as in ``frames_to_screens`` of that candidate alone: the
[C, F, h, w] screens equal C launches to the bit.

``launch_cost`` counts a launch's bytes and operations; the bound that
``chip_smoke.py`` prints and what a roofline count of a step
(``utils.roofline``) is told of each launch are that one computation.
``launch_instructions`` counts the least instructions the launch issues: with
4 taps that bound is about as long as the bytes' (longer on int16 words at
1080p60, 20 Msps).

The 2-tap kernel (``csrc/resample.cu``) is bound by memory: a block's input
is read once and its screens are written once, with nothing to reuse but the
scan line two neighbouring rows share.  Its design moves those bytes once
and wide: a tile of a few output rows (``ROWS_PER_TILE``) reads one contiguous run
of the block, staged with 16-byte asynchronous copies into one of two
shared-memory buffers while the previous tile is computed (``tile_plan``
sizes them); I/Q pairs become
envelope samples in shared memory; every thread writes four adjacent pixels
as one 16-byte store.  Tiles that touch the block end are staged sample by
sample through the index clamp.  The 4-tap read needs about as many issue
slots as it needs bytes (``launch_instructions``), and has a kernel of its
own: the same tiles and buffers with one barrier a tile (the next tile's
run started right after it, as one bulk copy), the columns' positions from
a table where it costs no block, and fewer instructions a pixel for the
same roundings.

For a tensor on the CPU each wrapper runs the plain PyTorch version below.
For a CUDA tensor it launches the hand-written kernel or raises; it never
falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from .demod import am_envelope_from_iq, fm_demod_from_iq, invert_envelope
from .resample import RENDER_SIZE, _screen_geometry, round_to_bfloat16

__all__ = [
    "ScreenGeometry",
    "screen_geometry",
    "frames_to_screens",
    "frames_to_screens_from_words",
    "frames_to_screens_plain",
    "words_envelope_plain",
    "words_maxima",
    "words_maxima_plain",
    "max_launch_cost",
    "max_launch_instructions",
    "fm_int16_words",
    "fm_float32_words",
    "balanced_walk",
    "walk_tiles",
    "frames_to_screens_candidates",
    "frames_to_screens_candidates_plain",
    "CandidateTable",
    "candidate_table",
    "candidates_launch_cost",
    "frame_to_screen",
    "catmull_rom_weights",
    "line_reach",
    "launch_cost",
    "launch_instructions",
    "LaunchPlan",
    "launch_plan",
    "sm_count",
    "line_loads",
    "frame_samples_read",
    "quantise_line_frac",
]

# Output rows of one tile (at most 32), by the bytes of a staged sample: a
# tile of 8 rows of 4-byte samples and one of 4 rows of 8-byte samples stage
# about as much (36 and 48 KB at 1080p60, 20 Msps), so that several blocks
# share an SM.
ROWS_PER_TILE = {4: 8, 8: 4}
# Rows of a tile on the balanced walk (:func:`balanced_walk`, the FM loads),
# by the bytes of a staged sample.  int16: 7 was the fastest of 5 to 8 at the
# slice, 2 and 4 taps, and within the spread at 11 frames of 640x480 at 32
# Msps, 4 taps (``chip_smoke.py`` phases 23 and 5; PERF.md, section 6).
# float32: 5, where the SM still holds FM_MIN_BLOCKS blocks of the plan's
# shared memory, else fewer rows down to ROWS_PER_TILE's 4: at the slice 5
# and 6 rows (three blocks an SM) were the fastest of 4 to 7, 2 and 4 taps,
# 2-3% ahead of 4 (four blocks); at 11 frames of 640x480 at 32 Msps 4 rows
# (two blocks) 20-30% ahead of 5 (one block) (``exp/k1_vs_parent.py``,
# PERF.md, section 6).
ROWS_PER_TILE_FM = {4: 7, 8: 5}
FM_MIN_BLOCKS = 3
# Shared memory of one SM (228 KB) and what each block of a launch reserves
# besides its own (1 KB): how many blocks of a plan an SM holds.
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
# A launch of fewer tiles than FILL_TILES_PER_SM for each of the card's SMs
# (one frame of 600 rows is 75 tiles of 8 rows on 132 SMs) takes tiles of
# fewer rows, halved down to one, until it has that many: every SM takes
# part.  Such a launch also gives every block one tile, and the kernel then
# drops the second stage buffer (``csrc/resample.cu`` ``launch``).  Two an SM
# (2 rows a tile at 600 rows) was the fastest of 0, 1, 2 and 4 at every
# shape ``chip_smoke.py`` times (PERF.md, section 6).
FILL_TILES_PER_SM = 2
# Dynamic shared memory one block may ask for: the card's 227 KB less the
# kernel's static row table, 768 bytes (4 taps: two of them and two 8-byte
# mbarriers).
MAX_SHARED_BYTES = 227 * 1024 - 768
MAX_SHARED_BYTES_4 = 227 * 1024 - 2 * 768 - 2 * 8
# Frame starts and sample indices are int32 on the card.
_INT32_MAX = int(np.iinfo(np.int32).max)
# What the kernel stages: code and bytes per sample, by the tensor's dtype.
_ENVELOPE = (0, 4)
_WORDS = {torch.int16: (1, 4), torch.float32: (2, 8)}
# Flags of an I/Q word code (``csrc/resample.cu`` kFm, kBf16, kInvert): the
# FM discriminator in place of the AM envelope, each demodulated sample
# rounded to bfloat16 and back, and each made ``1 - v / max`` first.
_FM, _BF16, _INVERT = 4, 8, 16
_DEMODS = ("am", "fm")
# 16-byte words of the source one block of the maximum's launch reads
# (``csrc/resample.cu`` kThreads · kMaxWordsPerThread).
MAX_WORDS_PER_BLOCK = 256 * 4


@dataclasses.dataclass(frozen=True)
class ScreenGeometry:
    """Per-config line tables of the resampler, resident on one device."""

    line_start: torch.Tensor  # int32 [h, 2], clamped at 0
    line_frac: torch.Tensor   # float32 [h, 2], may be negative on row 0
    wr: torch.Tensor          # float32 [h], vertical blend weight
    delta: float              # samples per output column (a float32 value)
    span: int                 # samples one scan line reads: 2 taps, no residual
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


def _check_taps(interp_taps: int) -> int:
    if interp_taps not in (2, 4):
        raise ValueError(f"interp taps must be 2 or 4, got {interp_taps}")
    return int(interp_taps)


def line_reach(interp_taps: int, exact: bool) -> tuple[int, int]:
    """(lead, extra): the samples a scan line reads before its start, and
    beyond ``ScreenGeometry.span`` after it.  A residual in [0, 1) moves
    ``floor(pos) + 1`` one sample on; 4 taps read one sample before the
    floor and two after it."""
    lead = 1 if _check_taps(interp_taps) == 4 else 0
    return lead, lead + (1 if exact else 0)


def quantise_line_frac(line_frac: np.ndarray, num_phases: int) -> np.ndarray:
    """Each line's fraction on the grid of the JAX package's phase-quantised
    resamplers (``mxu`` and its kin): ``frac -> (p + 0.5) / P`` with
    ``p = floor(frac · P)``, at most ``1 / (2P)`` sample from where it was.
    A negative fraction (row 0 of a raster with less than one sample per
    output column) takes the negative phases of ``frames_to_screens_mxu``."""
    p = int(num_phases)
    if p < 1:
        raise ValueError(f"num_phases must be at least 1, got {num_phases}")
    phase = np.clip(np.floor(line_frac.astype(np.float64) * p), -p, p - 1)
    return ((phase + 0.5) / p).astype(np.float32)


@functools.lru_cache(maxsize=64)
def screen_geometry(
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int],
    device: torch.device,
    num_phases: int | None = None,
) -> ScreenGeometry:
    """Build the line tables once per (geometry, device) from the shared
    host ``_screen_geometry`` and keep them on ``device``.  With
    ``num_phases`` the lines' fractions are quantised on the host
    (:func:`quantise_line_frac`); the line starts stay as they are."""
    line_start, line_frac, wr, delta, span = _line_tables(frame_len, y_t, x_t, out_shape)
    if num_phases is not None:
        line_frac = quantise_line_frac(line_frac, num_phases)
    dev = torch.device(device)
    return ScreenGeometry(
        line_start=torch.from_numpy(line_start.astype(np.int32)).to(dev),
        line_frac=torch.from_numpy(line_frac).to(dev),
        wr=torch.from_numpy(wr).to(dev),
        delta=delta,
        span=span,
        out_shape=(int(out_shape[0]), int(out_shape[1])),
    )


def catmull_rom_weights(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Catmull-Rom weights of the taps at offsets (-1, 0, 1, 2) for the
    fraction ``t``, one rounding per operation in the association the kernel
    uses (``t³ = t²·t``)."""
    t2 = t * t
    t3 = t2 * t
    return (
        0.5 * ((2.0 * t2 - t3) - t),
        0.5 * ((3.0 * t3 - 5.0 * t2) + 2.0),
        0.5 * ((4.0 * t2 - 3.0 * t3) + t),
        0.5 * (t3 - t2),
    )


def _check_streams(n_samples: int, streams: int, n_frames: int | None = None) -> int:
    """The samples a stream holds, where ``n_samples`` (and ``n_frames``)
    split into ``streams`` equal shares."""
    if streams < 1 or n_samples % streams or (n_frames is not None and n_frames % streams):
        raise ValueError(f"{n_samples} samples and {n_frames} frames do not split into "
                         f"{streams} equal streams")
    return n_samples // streams


def frames_to_screens_plain(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    geom: ScreenGeometry,
    frac_offsets: torch.Tensor | None = None,
    interp_taps: int = 2,
    streams: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of K1, on any device: index arithmetic,
    ``clamp`` and ``gather``, in the same arithmetic order as the kernel.
    With ``streams`` each frame's reads are clamped into its own stream's
    samples (stream s: samples ``[s·L, s·L + L)``, frames ``[s·F, s·F +
    F)``)."""
    _check_taps(interp_taps)
    h, w = geom.out_shape
    n = env.shape[0]
    dev = env.device
    lo, hi = 0, n - 1
    if streams != 1:
        n_frames = frame_starts.shape[0]
        length = _check_streams(n, streams, n_frames)
        first = (torch.arange(n_frames, device=dev) // (n_frames // streams)) * length
        lo, hi = first[:, None, None, None], first[:, None, None, None] + (length - 1)
    cp = torch.arange(w, dtype=torch.float32, device=dev) * torch.tensor(
        geom.delta, dtype=torch.float32, device=dev)
    frac = geom.line_frac[None]                                             # [1,h,2]
    if frac_offsets is not None:
        frac = frac + frac_offsets.to(torch.float32)[:, None, None]         # [F,h,2]
    pos = torch.clamp(cp + frac[..., None], min=0.0)                        # [1|F,h,2,w]
    i0f = torch.floor(pos)
    t = pos - i0f
    base = (frame_starts.to(torch.int64)[:, None, None]
            + geom.line_start.to(torch.int64)[None])                        # [F,h,2]
    idx0 = base[..., None] + i0f.to(torch.int64)                            # [F,h,2,w]

    def tap(off: int) -> torch.Tensor:
        return env[torch.clamp(idx0 + off, lo, hi)]

    if interp_taps == 2:
        lines = tap(0) * (1.0 - t) + tap(1) * t                             # [F,h,2,w]
    else:
        w0, w1, w2, w3 = catmull_rom_weights(t)
        lines = ((tap(-1) * w0 + tap(0) * w1) + tap(1) * w2) + tap(2) * w3
    wb = geom.wr[None, :, None]
    return (1.0 - wb) * lines[:, :, 0] + wb * lines[:, :, 1]


@functools.lru_cache(maxsize=64)
def tile_run_cap(
    frame_len: int, y_t: int, x_t: int, out_shape: tuple[int, int], rows_per_tile: int,
    reach: int = 0, any_start: bool = False,
) -> int:
    """Samples one stage buffer of the kernel must hold: the longest
    contiguous run that a tile of ``rows_per_tile`` output rows reads (first
    row's upper line start to last row's lower line start plus the span,
    and ``reach`` samples more: ``sum(line_reach(...))``),
    plus 3 samples of 16-byte alignment slack at each end, as a multiple of
    4.  The tiles start at multiples of ``rows_per_tile``, or with
    ``any_start`` at any row (the balanced walk, :func:`balanced_walk`).
    The kernel takes a tile's run from its first and last row, so the line
    starts must not decrease along the rows."""
    h = out_shape[0]
    line_start, _, _, _, span = _line_tables(frame_len, y_t, x_t, out_shape)
    if (np.diff(line_start, axis=0) < 0).any() or (line_start[:, 1] < line_start[:, 0]).any():
        raise ValueError("K1 takes line starts that do not decrease along the rows")
    first = np.arange(0, h, 1 if any_start else rows_per_tile)
    last = np.minimum(first + rows_per_tile, h) - 1
    run = int((line_start[last, 1] + span - line_start[first, 0]).max()) + reach
    return (run + 6 + 3) // 4 * 4


def tile_plan(
    frame_len: int, y_t: int, x_t: int, out_shape: tuple[int, int], sample_bytes: int,
    reach: int = 0, taps: int = 2, n_frames: int | None = None, sms: int = 0,
    balanced: bool = False,
) -> tuple[int, int]:
    """(rows of a tile, samples of a stage buffer) for staged samples of
    ``sample_bytes``: ``ROWS_PER_TILE`` rows (``ROWS_PER_TILE_FM`` with
    ``balanced``), by ``sample_bytes``, where a block's shared memory holds
    them; on the balanced walk float32 words take fewer rows, down to
    ``ROWS_PER_TILE[8]``, until an SM holds ``FM_MIN_BLOCKS`` blocks.  A block has two
    stage buffers of the run and, for 8-byte pairs, a buffer for the
    envelope they become (the 4-tap kernel adds a table of the columns'
    positions where the SM holds as many blocks with it as without).  A
    screen of far fewer rows than the raster has scan lines spreads a tile's
    rows over a long run, so the rows are halved, down to one, until the
    buffers fit.  Given the launch's ``n_frames`` and the card's ``sms``, a
    launch of fewer tiles than
    ``FILL_TILES_PER_SM · sms`` halves its rows further, down to one, until
    it has that many.  ``balanced``: the kernel's balanced walk
    (:func:`balanced_walk`, the FM loads), whose tiles start at any row
    and whose blocks share out the launch's rows whatever their count: the
    buffer holds the run from any row, and the rows are not halved to fill
    the card."""
    per_sample = 2 * sample_bytes + (4 if sample_bytes == 8 else 0)
    budget = MAX_SHARED_BYTES_4 if _check_taps(taps) == 4 else MAX_SHARED_BYTES
    rows = (ROWS_PER_TILE_FM if balanced else ROWS_PER_TILE)[sample_bytes]
    while (rows > 1 and tile_run_cap(frame_len, y_t, x_t, out_shape, rows, reach, balanced)
           * per_sample > budget):
        rows //= 2
    if n_frames is not None and not balanced:
        while rows > 1 and n_frames * -(-int(out_shape[0]) // rows) < FILL_TILES_PER_SM * sms:
            rows //= 2
    if balanced and sample_bytes == 8:
        static = 227 * 1024 - budget   # the kernel's static shared memory
        while rows > ROWS_PER_TILE[8] and SM_SHARED_BYTES // (
                tile_run_cap(frame_len, y_t, x_t, out_shape, rows, reach, True) * per_sample
                + static + BLOCK_RESERVED_BYTES) < FM_MIN_BLOCKS:
            rows -= 1
    run_cap = tile_run_cap(frame_len, y_t, x_t, out_shape, rows, reach, balanced)
    if run_cap * per_sample > budget:
        raise ValueError(
            f"a tile of {rows} rows stages {run_cap * per_sample} bytes, more than the "
            f"{budget} bytes of shared memory of one block")
    return rows, run_cap


@functools.lru_cache(maxsize=64)
def frame_samples_read(
    frame_len: int, y_t: int, x_t: int, out_shape: tuple[int, int], reach: int = 0,
) -> int:
    """Samples of the block that the line tables address for one frame: the
    union over the rows' two scan lines of ``[line_start, line_start + span +
    reach)``, with ``reach = sum(line_reach(...))``.  A screen with as many
    rows as half the raster's lines or more reads the whole frame; a 150-row
    screen of a 1125-line raster reads 300 lines of it."""
    line_start, _, _, _, span = _line_tables(frame_len, y_t, x_t, out_shape)
    length = span + reach
    starts = np.sort(line_start.reshape(-1).astype(np.int64))
    return int(length + np.minimum(np.diff(starts), length).sum())


def launch_cost(n_samples: int, sample_bytes: int, n_frames: int, frame_len: int, y_t: int,
                x_t: int, out_shape: tuple[int, int], word: int, taps: int = 2,
                exact: bool = False, streams: int = 1) -> tuple[int, int, int]:
    """(bytes, float32 operations, transcendentals) of one K1 launch: what
    its bound on the card and a roofline count are computed from.

    Bytes: the samples of the block that the frames' line tables address
    (:func:`frame_samples_read` per frame, the whole block at most) read once,
    the frame starts and line tables read once, the screens written once;
    residuals are 4 bytes a frame more.  What a tile stages beyond the lines
    it reads is the kernel's own cost and no part of the bound.
    Operations per pixel: one product for ``c·delta``; per vertical tap add,
    max, floor, two subtractions, two products, add; three for the blend.
    With 4 taps a vertical tap takes add, max, floor, subtraction, 19 for the
    Catmull-Rom weights and 7 for the four-term sum.  ``word`` is the word
    code K1 stages (:func:`word_code`; 0 an envelope, and a bool reads as
    an envelope or AM words).  The demod adds, per sample read, two
    products, an add and a square root (AM), or under ``_FM`` four
    products, two sums and an arc tangent (the FM discriminator); the square
    root or the arc tangent is also the sample's transcendental.  ``_BF16``
    adds the rounding, one operation a sample; ``_INVERT`` the division and
    the subtraction, two, and the ``streams`` maxima's 4 bytes each."""
    h, w = int(out_shape[0]), int(out_shape[1])
    pixels = n_frames * h * w
    per_frame = frame_samples_read(int(frame_len), int(y_t), int(x_t), (h, w),
                                   sum(line_reach(taps, exact)))
    samples = min(int(n_samples), n_frames * per_frame)
    nbytes = (samples * sample_bytes + (8 if exact else 4) * n_frames + h * (8 + 8 + 4)
              + 4 * pixels + (4 * streams if word & _INVERT else 0))
    per_tap = 8 if taps == 2 else 4 + 19 + 7
    per_sample = ((7 if word & _FM else 4) + (1 if word & _BF16 else 0)
                  + (2 if word & _INVERT else 0)) if word else 0
    flops = pixels * (1 + 2 * per_tap + 3) + per_sample * samples
    return nbytes, flops, (samples if word else 0)


def _check_launch(src: torch.Tensor, n_samples: int, frame_starts: torch.Tensor) -> int:
    """The checks every K1 launch makes of its source and frame starts;
    returns the frame count."""
    if src.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {src.device.type}")
    if frame_starts.dtype != torch.int32:
        raise TypeError(f"K1 takes int32 frame starts, got {frame_starts.dtype}")
    if not (src.is_contiguous() and frame_starts.is_contiguous()):
        raise ValueError("K1 takes contiguous tensors")
    n_frames = frame_starts.shape[0]
    if n_frames == 0 or n_samples == 0:
        raise ValueError(f"K1 takes at least one frame and one sample, got {n_frames}, {n_samples}")
    # Frame starts index the block as int32: a block whose sample count does
    # not fit would wrap them.
    if n_samples > _INT32_MAX:
        raise ValueError(
            f"K1 takes int32 frame starts: a block of {n_samples} samples does not fit")
    return n_frames


# The least SASS instructions K1's function needs, whatever its loops issue
# (``launch_instructions``).  A scan line read: its position (add, max),
# floor and fraction (a round-down add of 2^23, two differences), the tap
# address, and the taps' weighted sum: 2 taps ``1 - t``, two products and an
# add; 4 taps the Catmull-Rom weights (15 operations with the exact products
# fused), four products and three adds.  Its loads are counted apart
# (``line_loads``).
LINE_INSTRUCTIONS = {2: 2 + 3 + 1 + 4, 4: 2 + 3 + 1 + 15 + 7}
# A pixel besides its two lines: its column's ``c·delta``, the blend (two
# products and an add), a quarter of a 16-byte store.
PIXEL_INSTRUCTIONS = 1 + 3 + 0.25
# A sample's demod: two products, an add and a correctly rounded square root
# (an approximation and three fix-ups); int16 words two conversions more.
DEMOD_INSTRUCTIONS = {4: 2 + 2 + 1 + 4, 8: 2 + 1 + 4}
# The least an arc tangent of a quotient takes: the smaller magnitude over
# the larger (a minimum, a maximum, an approximate reciprocal, the product),
# an odd polynomial of degree 15 in it (a square, 7 fused multiply-adds, the
# product with the quotient), the octant's fix-ups (two selections, the sign).
# What computes the bits K1 must give takes more: atan2f runs 43 SASS
# instructions on a finite, non-zero input for sm_90a (a correctly rounded
# division, a rational approximation whose reciprocal is a second one, the
# tests for zeros and infinities), 49 with the convergence barriers its
# branches take in K1's loop.  Both FM loads run atan2f's operations without
# its branches (``csrc/resample.cu`` ``atan2_fast``, 27 instructions): the
# int16 load always, the float32 load (and the block maximum's) where every
# lane of a warp has operands inside the domain where those branches are
# not taken, a test of both operands and a vote a 16-byte word more, and
# atan2f itself where one has not (exp/k1_clocks.py).  The bound keeps this
# count.
ATAN2_INSTRUCTIONS = 2 + 2 + 9 + 3
# A sample's FM discriminator: four products and two sums with the sample
# before, the arc tangent; int16 words two conversions more.
FM_INSTRUCTIONS = {4: 2 + 4 + 2 + ATAN2_INSTRUCTIONS, 8: 4 + 2 + ATAN2_INSTRUCTIONS}
# The bfloat16 rounding of a sample: a conversion to bfloat16, one back.
BF16_INSTRUCTIONS = 2
# The inversion of a sample, 1 - v / m: a correctly rounded division (an
# approximate reciprocal, four fused multiply-adds for the quotient and its
# correction) and the subtraction.
INVERT_INSTRUCTIONS = 1 + 4 + 1


def line_loads(taps: int, delta: float, group: int) -> float:
    """Shared-memory loads one pixel's read of one scan line needs: the
    distinct samples that the taps of a work item of ``group`` adjacent
    columns cover, ``(group - 1)·delta + taps`` on average over the
    positions' fractions, shared by its ``group`` columns, and no more than
    ``taps``."""
    return min(float(taps), ((group - 1) * float(delta) + taps) / group)


def launch_instructions(n_samples: int, sample_bytes: int, n_frames: int, frame_len: int,
                        y_t: int, x_t: int, out_shape: tuple[int, int], word: int,
                        taps: int = 2, exact: bool = False) -> float:
    """The least instructions one K1 launch issues, over all lanes: what its
    instruction bound is computed from, beside :func:`launch_cost`'s bytes.
    Each pixel's two line reads and the rest of the pixel
    (``LINE_INSTRUCTIONS``, ``PIXEL_INSTRUCTIONS``), the reads' loads as
    :func:`line_loads` counts them for the kernel's work item (four columns
    when the width is a multiple of 4, else one); each sample the line
    tables address copied in 16-byte requests, and demodulated when the
    word code ``word`` is I/Q (``DEMOD_INSTRUCTIONS``, under ``_FM``
    ``FM_INSTRUCTIONS``, and ``BF16_INSTRUCTIONS`` more under ``_BF16``,
    ``INVERT_INSTRUCTIONS`` under ``_INVERT``).  The card issues one instruction
    a cycle on each of its schedulers (``ops.sync_kernel.H100_ISSUE_PER_S``
    lanes a second)."""
    h, w = int(out_shape[0]), int(out_shape[1])
    taps = _check_taps(taps)
    delta = _line_tables(int(frame_len), int(y_t), int(x_t), (h, w))[3]
    per_frame = frame_samples_read(int(frame_len), int(y_t), int(x_t), (h, w),
                                   sum(line_reach(taps, exact)))
    samples = min(int(n_samples), n_frames * per_frame)
    per_sample = sample_bytes / 16
    if word:
        per_sample += ((FM_INSTRUCTIONS if word & _FM else DEMOD_INSTRUCTIONS)[sample_bytes]
                       + (BF16_INSTRUCTIONS if word & _BF16 else 0)
                       + (INVERT_INSTRUCTIONS if word & _INVERT else 0))
    per_line = LINE_INSTRUCTIONS[taps] + line_loads(taps, delta, 4 if w % 4 == 0 else 1)
    return n_frames * h * w * (2 * per_line + PIXEL_INSTRUCTIONS) + samples * per_sample


def max_launch_cost(n_samples: int, sample_bytes: int, word: int, streams: int = 1
                    ) -> tuple[int, int, int]:
    """(bytes, float32 operations, transcendentals) of one launch of the
    block maximum (:func:`words_maxima`) over ``n_samples`` samples of
    interleaved words: the words read once and the ``streams`` maxima
    written once; a sample's demod (as :func:`launch_cost` counts it, ``word``
    its code; the rounding and the inversion are not the maximum's) and one
    comparison.  The partials its blocks fold are the kernel's own cost."""
    per_sample = (7 if word & _FM else 4) + 1
    return n_samples * sample_bytes + 4 * streams, per_sample * n_samples, n_samples


def max_launch_instructions(n_samples: int, sample_bytes: int, word: int) -> float:
    """The least instructions one launch of the block maximum issues, over
    all lanes: a sample's share of a 16-byte load, its demod
    (``DEMOD_INSTRUCTIONS`` or ``FM_INSTRUCTIONS``) and one maximum."""
    demod = (FM_INSTRUCTIONS if word & _FM else DEMOD_INSTRUCTIONS)[sample_bytes]
    return n_samples * (sample_bytes / 16 + demod + 1)


def balanced_walk(word: int) -> bool:
    """Whether K1's blocks take the balanced walk on the word code ``word``
    (``csrc/resample.cu`` ``kBalanced``): on FM words, int16 and float32
    (the FM flag rides only on I/Q words).  There the
    launch's rows, frame after frame, are cut into as many ranges as it has
    blocks, ranges that differ by one row at most, and each block renders
    its range in tiles of at most the plan's rows that end at a frame's end
    (:func:`walk_tiles`); elsewhere block b takes tiles b, b + B, ...  of
    the plan's rows."""
    return bool(word & _FM)


def walk_tiles(n_frames: int, h: int, rows_per_tile: int, blocks: int, block: int
               ) -> list[tuple[int, int, int]]:
    """The tiles (frame, first row, rows) that block ``block`` of ``blocks``
    renders on the balanced walk, in its order: the kernel's ``walk_start``,
    ``walk_tile`` and ``walk_next``."""
    total = n_frames * h
    pos, end = total * block // blocks, total * (block + 1) // blocks
    tiles = []
    while pos < end:
        f, r0 = divmod(pos, h)
        rows = min(rows_per_tile, h - r0, end - pos)
        tiles.append((f, r0, rows))
        pos += rows
    return tiles


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """What one K1 launch on a raster needs besides its tensors, made once
    per (raster, device, launch shape): the line tables on the device, the
    tile plan, the span a scan line reads, and the launch's cost."""

    geom: ScreenGeometry
    rows: int
    run_cap: int
    span: int
    cost: tuple[int, int, int]


@functools.lru_cache(maxsize=256)
def launch_plan(
    n_samples: int, n_frames: int, frame_len: int, y_t: int, x_t: int,
    out_shape: tuple[int, int], device: torch.device, num_phases: int | None,
    sample_bytes: int, word: int, taps: int, exact: bool,
    rows_per_tile: int, fill: int, streams: int = 1,
) -> LaunchPlan:
    """The :class:`LaunchPlan` of a launch of the word code ``word`` (0 an
    envelope); ``rows_per_tile`` and ``fill`` are
    ``ROWS_PER_TILE[sample_bytes]`` (``ROWS_PER_TILE_FM[sample_bytes]`` on the
    balanced walk) and ``FILL_TILES_PER_SM`` as the caller reads them, so that a plan
    is made again where they change."""
    del rows_per_tile, fill  # read by tile_plan; part of the cache's key
    raster = (frame_len, y_t, x_t, out_shape)
    lead, extra = line_reach(taps, exact)
    sms = sm_count(device) if device.type == "cuda" else 0
    rows, run_cap = tile_plan(*raster, sample_bytes, lead + extra, taps, n_frames, sms,
                              balanced_walk(word))
    geom = screen_geometry(*raster, device, num_phases)
    cost = launch_cost(n_samples, sample_bytes, n_frames, *raster, word, taps, exact, streams)
    return LaunchPlan(geom, rows, run_cap, geom.span + extra, cost)


def _plan(n_samples: int, n_frames: int, sample_bytes: int, frame_len: int, y_t: int, x_t: int,
          out_shape, device: torch.device, num_phases: int | None, word: int, taps: int,
          exact: bool, streams: int = 1) -> LaunchPlan:
    rows = (ROWS_PER_TILE_FM if balanced_walk(word) else ROWS_PER_TILE)[sample_bytes]
    return launch_plan(int(n_samples), int(n_frames), int(frame_len), int(y_t), int(x_t),
                       (int(out_shape[0]), int(out_shape[1])), device, num_phases, sample_bytes,
                       word, taps, exact, rows, FILL_TILES_PER_SM, streams)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _prepare(
    n_samples: int,
    staged: tuple[int, int],
    n_frames: int,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int],
    exact: bool,
    interp_taps: int,
    num_phases: int | None,
    streams: int,
    load: tuple,
    device: torch.device,
):
    """What one K1 launch needs besides its tensors, worked out once:
    ``(out shape, issue)``, where ``issue(src, frame_starts, frac_offsets,
    maxima, out)`` takes their addresses (None for a tensor not given) and
    launches through ``_build.launch``.  ``exact``: residuals are given."""
    stream_len = _check_streams(n_samples, streams, n_frames)
    word, sample_bytes = staged
    plan = _plan(n_samples, n_frames, sample_bytes, frame_len, y_t, x_t, out_shape, device,
                 num_phases, word, interp_taps, exact, streams)
    geom = plan.geom
    h, w = geom.out_shape
    launcher = _build.load_library("resample").tt_resample_frames
    costs, variant = (plan.cost,), (interp_taps, exact, *load)
    tables = (geom.line_start.data_ptr(), geom.line_frac.data_ptr(), geom.wr.data_ptr())
    per_stream = n_frames // streams

    def issue(src, frame_starts, frac_offsets, maxima, out) -> None:
        _build.launch("k1", launcher, device, costs, variant,
                      src, n_samples, word, frame_starts, frac_offsets, n_frames, interp_taps,
                      *tables, out, h, w, geom.delta, plan.span, plan.rows, plan.run_cap,
                      maxima, stream_len, per_stream)

    return (n_frames, h, w), issue


def _launch(
    src: torch.Tensor,
    n_samples: int,
    staged: tuple[int, int],
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int],
    frac_offsets: torch.Tensor | None = None,
    interp_taps: int = 2,
    num_phases: int | None = None,
    maxima: torch.Tensor | None = None,
    streams: int = 1,
    load: tuple = (),
) -> torch.Tensor:
    """Check the arguments and launch the kernel on ``src``'s device, on the
    current stream.  ``staged`` is (what ``src`` holds: the word code with
    its flags, bytes per sample); ``maxima`` the streams' maxima under
    ``_INVERT``; ``load`` ends the launch's variant (taps, residuals given,
    *load)."""
    n_frames = _check_launch(src, n_samples, frame_starts)
    _check_streams(n_samples, streams, n_frames)
    if frac_offsets is not None:
        if frac_offsets.dtype != torch.float32 or not frac_offsets.is_contiguous():
            raise TypeError("K1 takes contiguous float32 frac_offsets")
    shape, issue = _prepare(n_samples, staged, n_frames, frame_len, y_t, x_t, out_shape,
                            frac_offsets is not None, interp_taps, num_phases, streams, load,
                            src.device)
    out = torch.empty(shape, dtype=torch.float32, device=src.device)
    issue(src.data_ptr(), frame_starts.data_ptr(), _ptr(frac_offsets), _ptr(maxima),
          out.data_ptr())
    return out


def _check_block(
    block: torch.Tensor, frame_starts: torch.Tensor, frac_offsets: torch.Tensor | None,
    interp_taps: int, what: str,
) -> None:
    _check_taps(interp_taps)
    if block.dim() != 1 or frame_starts.dim() != 1:
        raise ValueError(f"{what} and frame_starts must be 1-D")
    if block.device != frame_starts.device:
        raise ValueError(f"{what} on {block.device} but frame_starts on {frame_starts.device}")
    if frac_offsets is not None and (frac_offsets.shape != frame_starts.shape
                                     or frac_offsets.device != block.device):
        raise ValueError(
            f"frac_offsets must be one residual per frame on {block.device}, got shape "
            f"{tuple(frac_offsets.shape)} on {frac_offsets.device}")


def frames_to_screens(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    frac_offsets: torch.Tensor | None = None,
    interp_taps: int = 2,
    num_phases: int | None = None,
) -> torch.Tensor:
    """All frames of a block → (n_frames, h, w) float32 screens.

    ``env`` is the float32 envelope of the block (N,), ``frame_starts`` the
    integer sample offsets of the frames (n_frames,) on the same device, and
    ``frame_len`` the samples per frame that set the raster↔signal ratio.
    ``frac_offsets`` (float32 (n_frames,), each in [0, 1)) are the frames'
    fractional residuals: frame f is read ``frame_starts[f] +
    frac_offsets[f]`` samples into the block.  ``interp_taps`` is 2 (linear)
    or 4 (Catmull-Rom) along the scan.  ``num_phases`` quantises each line's
    fraction on the host (:func:`quantise_line_frac`): the read of the JAX
    package's ``mxu`` resamplers, through the same kernel."""
    _check_block(env, frame_starts, frac_offsets, interp_taps, "env")
    if env.device.type == "cpu":
        geom = screen_geometry(int(frame_len), int(y_t), int(x_t), tuple(out_shape), env.device,
                               num_phases)
        return frames_to_screens_plain(env, frame_starts, geom, frac_offsets, interp_taps)
    if env.dtype != torch.float32:
        raise TypeError(f"K1 takes a float32 envelope, got {env.dtype}")
    return _launch(env, env.shape[0], _ENVELOPE, frame_starts, frame_len, y_t, x_t, out_shape,
                   frac_offsets, interp_taps, num_phases)


def word_code(dtype: torch.dtype, demod: str = "am", bf16: bool = False, invert: bool = False
              ) -> tuple[int, int]:
    """(word code, bytes per sample) that K1 stages for I/Q words of
    ``dtype``: its type's code with the ``_FM``, ``_BF16`` and ``_INVERT``
    flags."""
    if dtype not in _WORDS:
        raise TypeError(f"K1 takes int16 or float32 I/Q words, got {dtype}")
    code, sample_bytes = _WORDS[dtype]
    return (code | (_FM if demod == "fm" else 0) | (_BF16 if bf16 else 0)
            | (_INVERT if invert else 0)), sample_bytes


def _check_demod(demod: str) -> None:
    if demod not in _DEMODS:
        raise ValueError(f"demod must be one of {_DEMODS}, got {demod!r}")


def _stream_words(words: torch.Tensor, streams: int) -> list[torch.Tensor]:
    """The interleaved words of each of ``streams`` equal streams laid end
    to end (an odd trailing word dropped)."""
    if streams == 1:
        return [words]
    length = _check_streams(words.shape[0] // 2, streams)
    return [words[2 * length * b: 2 * length * (b + 1)] for b in range(streams)]


def words_envelope_plain(words: torch.Tensor, demod: str = "am", bf16: bool = False,
                         invert: bool = False, streams: int = 1) -> torch.Tensor:
    """The plain PyTorch version of what K1's words load computes, on any
    device: the AM envelope (``am_envelope_from_iq``) or the FM
    discriminator (``fm_demod_from_iq``, 0 at the first pair of ``words``) of
    interleaved I/Q words, inverted with ``invert`` (``invert_envelope``:
    ``1 - env / torch.max(env)``), then rounded to bfloat16 and back with
    ``bf16`` (``round_to_bfloat16``); with ``streams``, each of that many
    equal streams laid end to end on its own, as if it were alone."""
    _check_demod(demod)
    envs = []
    for part in _stream_words(words, streams):
        env = fm_demod_from_iq(part) if demod == "fm" else am_envelope_from_iq(part)
        if invert:
            env = invert_envelope(env)
        envs.append(round_to_bfloat16(env) if bf16 else env)
    return envs[0] if streams == 1 else torch.cat(envs)


def words_maxima_plain(words: torch.Tensor, demod: str = "am", streams: int = 1) -> torch.Tensor:
    """The plain PyTorch version of :func:`words_maxima`, on any device:
    ``torch.max`` of each stream's :func:`words_envelope_plain`, float32
    [streams]."""
    _check_demod(demod)
    return torch.stack([torch.max(words_envelope_plain(part, demod))
                        for part in _stream_words(words, streams)])


@functools.lru_cache(maxsize=None)
def _max_count(device: torch.device, stream: int) -> torch.Tensor:
    """The maximum's block count on ``device`` for launches on one CUDA
    stream: a device 0 that each launch leaves at 0 again."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def words_maxima(words: torch.Tensor, demod: str = "am", streams: int = 1) -> torch.Tensor:
    """The maximum of each stream's demodulated samples, float32
    [streams]: what the inversion divides by, ``torch.max`` of
    :func:`words_envelope_plain` (AM or FM, neither rounded nor inverted) of
    each of ``streams`` equal streams of interleaved int16 or float32 I/Q
    words laid end to end.  A NaN sample makes its stream's maximum NaN;
    where the maximum is a zero it is +0 if the stream has a +0 sample
    (``csrc/resample.cu`` ``words_max_kernel``; ``torch.max`` gives either
    zero there, as its reduction order falls).

    On a CUDA tensor ONE launch of ``tt_words_max``, the words read once, the
    maxima left on the card; on the CPU the plain version."""
    _check_demod(demod)
    if words.dim() != 1:
        raise ValueError(f"words must be 1-D, got shape {tuple(words.shape)}")
    if words.device.type == "cpu":
        return words_maxima_plain(words, demod, streams)
    if words.device.type != "cuda" or not words.is_contiguous():
        raise ValueError("words_maxima takes contiguous CUDA or CPU words")
    n_partials, issue = _prepare_maxima(words.shape[0] // 2, words.dtype, demod, streams,
                                        words.device)
    partials = torch.empty(n_partials, dtype=torch.int32, device=words.device)
    out = torch.empty(streams, dtype=torch.float32, device=words.device)
    issue(words.data_ptr(), partials.data_ptr(), out.data_ptr())
    return out


def _prepare_maxima(n: int, dtype: torch.dtype, demod: str, streams: int, device: torch.device):
    """What one launch of the block maximum on ``n`` samples of words of
    ``dtype`` needs besides its tensors: ``(int32 partials it takes,
    issue)``, where ``issue(words, partials, out)`` takes their addresses
    and launches through ``_build.launch`` on the current stream."""
    code, sample_bytes = word_code(dtype, demod)
    length = _check_streams(n, streams)
    if length == 0:
        raise ValueError("words_maxima takes at least one sample a stream")
    chunks = -(-(length // (16 // sample_bytes) + 2) // MAX_WORDS_PER_BLOCK)
    launcher = _build.load_library("resample").tt_words_max
    costs = (max_launch_cost(n, sample_bytes, code, streams),)

    def issue(words, partials, out) -> None:
        _build.launch("words_max", launcher, device, costs, None,
                      words, length, streams, code, chunks, partials,
                      _max_count(device, _build.current_stream(device)).data_ptr(), out)

    return streams * chunks, issue


def frames_to_screens_from_words(
    words: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    frac_offsets: torch.Tensor | None = None,
    interp_taps: int = 2,
    num_phases: int | None = None,
    *,
    demod: str = "am",
    bf16: bool = False,
    invert: bool = False,
    streams: int = 1,
) -> torch.Tensor:
    """All frames of a block of raw I/Q → (n_frames, h, w) float32 screens,
    equal to ``frames_to_screens_plain(words_envelope_plain(words, demod,
    bf16, invert, streams), ..., streams)``: the AM envelope, or with
    ``demod="fm"`` the FM discriminator (0 at the first pair of each
    stream), with ``invert`` made ``1 - env / max(env)`` by its stream's
    maximum, rounded to bfloat16 with ``bf16``.

    ``words`` holds the block's interleaved I/Q words (2N,), int16 or
    float32.  An odd trailing word is dropped, on either device, as the
    demod does.  With ``streams=B`` they are B streams of N / B samples laid
    end to end, and the frames B groups of n_frames / B, group s read from
    stream s only: each stream's reads are clamped into its own samples, as
    a launch of that stream alone clamps into its block.  On a CUDA tensor
    the words must be contiguous and of one of those two types: the kernel
    reads them as they lie, where the demod would first convert and copy
    them, and demodulates, inverts and rounds each sample where it stages
    it; ``invert`` first launches :func:`words_maxima` (one float a stream,
    left on the card), so that the call is two launches.  ``frac_offsets``,
    ``interp_taps`` and ``num_phases`` as in :func:`frames_to_screens`."""
    _check_block(words, frame_starts, frac_offsets, interp_taps, "words")
    _check_demod(demod)
    if words.device.type == "cpu":
        geom = screen_geometry(int(frame_len), int(y_t), int(x_t), tuple(out_shape), words.device,
                               num_phases)
        return frames_to_screens_plain(words_envelope_plain(words, demod, bf16, invert, streams),
                                       frame_starts, geom, frac_offsets, interp_taps, streams)
    n = words.shape[0] // 2
    _check_streams(n, streams, frame_starts.shape[0])
    staged, load = _words_load(words.dtype, demod, bf16, invert)
    maxima = words_maxima(words, demod, streams) if invert else None
    return _launch(words, n, staged, frame_starts, frame_len, y_t, x_t, out_shape, frac_offsets,
                   interp_taps, num_phases, maxima, streams, load)


def _words_load(dtype: torch.dtype, demod: str, bf16: bool, invert: bool) -> tuple[tuple, tuple]:
    """(staged, load) of a launch of K1's words entry: the word code with its
    flags and the bytes per sample (:func:`word_code`), and what ends the
    launch's variant: (demod, bfloat16 rounding[, "invert"])."""
    return (word_code(dtype, demod, bf16, invert),
            (demod, bool(bf16), *(("invert",) if invert else ())))


def fm_int16_words(words: torch.Tensor) -> torch.Tensor:
    """The FM discriminator of interleaved int16 I/Q words sample by sample,
    as K1's int16 FM load computes it (its arc tangent without the
    division's slow path, ``csrc/resample.cu`` ``atan2_int16``): equal to
    ``words_envelope_plain(words, "fm")`` to the bit.  On a CUDA tensor one
    launch of ``tt_fm_int16``; on the CPU the plain version.  No path of the
    port calls it: the card's tests and ``chip_smoke.py`` hold it against
    the plain version on every sample of a block, where K1 shows only the
    samples its pixels read."""
    if words.dtype != torch.int16 or words.dim() != 1:
        raise TypeError(
            f"fm_int16_words takes 1-D int16 words, got {words.dtype} {words.dim()}-D")
    if words.device.type == "cpu":
        return words_envelope_plain(words, "fm")
    if words.device.type != "cuda" or not words.is_contiguous():
        raise ValueError("fm_int16_words takes contiguous CUDA or CPU words")
    n = words.shape[0] // 2
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    _build.launch("fm_check", _build.load_library("resample").tt_fm_int16, words.device,
                  (_fm_check_cost(n, 4),), ("int16",), words.data_ptr(), n, out.data_ptr())
    return out


def _fm_check_cost(n_samples: int, sample_bytes: int) -> tuple[int, int, int]:
    """(bytes, float32 operations, transcendentals) of an FM check's launch:
    the words read once, the discriminator written once, and each sample's
    FM demod as :func:`launch_cost` counts it."""
    return n_samples * (sample_bytes + 4), 7 * n_samples, n_samples


def fm_float32_words(words: torch.Tensor) -> torch.Tensor:
    """The FM discriminator of interleaved float32 I/Q words sample by
    sample, as K1's float32 FM load computes it (a lane a 16-byte word of
    two pairs, the warp's vote between ``atan2f``'s operations without its
    branches and ``atan2f`` itself, ``csrc/resample.cu`` ``fm_f32_word``):
    equal to ``words_envelope_plain(words, "fm")`` to the bit.  On a CUDA
    tensor one launch of ``tt_fm_float32``; on the CPU the plain version.
    No path of the port calls it: the card's tests, ``chip_smoke.py`` and
    ``exp/k1_atan2_f32.py`` hold it against the plain version on every
    sample of a block, where K1 shows only the samples its pixels read."""
    if words.dtype != torch.float32 or words.dim() != 1:
        raise TypeError(
            f"fm_float32_words takes 1-D float32 words, got {words.dtype} {words.dim()}-D")
    if words.device.type == "cpu":
        return words_envelope_plain(words, "fm")
    if words.device.type != "cuda" or not words.is_contiguous() or words.data_ptr() % 8:
        raise ValueError("fm_float32_words takes contiguous CUDA or CPU words, on CUDA "
                         "8-byte aligned")
    n = words.shape[0] // 2
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    if n == 0:
        return out
    _build.launch("fm_check", _build.load_library("resample").tt_fm_float32, words.device,
                  (_fm_check_cost(n, 8),), ("float32",), words.data_ptr(), n, out.data_ptr())
    return out


@functools.lru_cache(maxsize=None)
def _zero_start(device: torch.device) -> torch.Tensor:
    """A device int32 0: the start of the one frame of a single-frame launch."""
    return torch.zeros(1, dtype=torch.int32, device=device)


class _FrameArgs(ctypes.Structure):
    """``csrc/resample.cu`` ``FramePlan``: what a single-frame launch on one
    raster passes besides its tensors, packed once per raster."""

    _fields_ = [("zero", ctypes.c_void_p), ("line_start", ctypes.c_void_p),
                ("line_frac", ctypes.c_void_p), ("wr", ctypes.c_void_p), ("taps", ctypes.c_int),
                ("h", ctypes.c_int), ("w", ctypes.c_int), ("delta", ctypes.c_float),
                ("span", ctypes.c_int), ("rows_per_tile", ctypes.c_int), ("run_cap", ctypes.c_int)]


@functools.lru_cache(maxsize=64)
def _frame_plan(n: int, y_t: int, x_t: int, out_shape: tuple[int, int], device: torch.device,
                taps: int, exact: bool, rows_per_tile: int, fill: int):
    """(plan, packed arguments, their address, the launcher) of a single-frame
    launch: made once per raster and launch shape, as :func:`launch_plan`."""
    plan = launch_plan(n, 1, n, y_t, x_t, out_shape, device, None, 4, 0, taps, exact,
                       rows_per_tile, fill)
    g = plan.geom
    packed = _FrameArgs(_zero_start(device).data_ptr(), g.line_start.data_ptr(),
                        g.line_frac.data_ptr(), g.wr.data_ptr(), taps, *g.out_shape, g.delta,
                        plan.span, plan.rows, plan.run_cap)
    lib = _build.load_library("resample")
    return plan, packed, ctypes.addressof(packed), lib.tt_resample_frame


def frame_to_screen(
    sig: torch.Tensor,
    y_t: int,
    x_t: int,
    out_shape: tuple[int, int] = RENDER_SIZE,
    offset: torch.Tensor | float | None = None,
    interp_taps: int = 2,
) -> torch.Tensor:
    """One frame's envelope → (h, w) screen, through the same resampler.
    ``offset`` in [0, 1) is the frame's fractional residual.

    On a CUDA tensor this is ONE launch and one allocation, the screen: the
    frame's start is a cached device 0, ``offset`` goes to the kernel as a
    scalar (a tensor on the card is read back for it); the plan (line
    tables, tile plan, cost) and the launch's arguments are made once per
    raster and passed as one packed pointer.  A frame is a few tens of tiles
    of ``ROWS_PER_TILE`` rows, so the plan takes tiles of fewer rows until
    the card has ``FILL_TILES_PER_SM`` of them for each SM, each block one
    tile with one stage buffer."""
    if sig.device.type == "cpu":
        starts = torch.zeros(1, dtype=torch.int32)
        frac = None
        if offset is not None:
            frac = torch.as_tensor(offset, dtype=torch.float32).reshape(1)
        return frames_to_screens(sig, starts, sig.shape[0], y_t, x_t, out_shape, frac,
                                 interp_taps)[0]
    dev = sig.device
    n = sig.shape[0]
    if (sig.dim() != 1 or sig.dtype != torch.float32 or not sig.is_contiguous()
            or not 0 < n <= _INT32_MAX or dev.type != "cuda"):
        raise TypeError(f"K1 takes a contiguous 1-D float32 envelope of 1 to {_INT32_MAX} "
                        f"samples on CUDA, got {sig.dtype} of shape {tuple(sig.shape)} on {dev}")
    exact = offset is not None
    plan, _, address, launcher = _frame_plan(n, int(y_t), int(x_t),
                                           (int(out_shape[0]), int(out_shape[1])), dev,
                                           interp_taps, exact, ROWS_PER_TILE[4], FILL_TILES_PER_SM)
    # A residual on the card is read back here: the kernel takes it as a scalar.
    res = 0.0 if offset is None else float(offset)
    out = torch.empty(plan.geom.out_shape, dtype=torch.float32, device=dev)
    _build.launch("k1", launcher, dev, (plan.cost,), (interp_taps, exact, "frame"),
                  address, sig.data_ptr(), n, res, out.data_ptr())
    return out


# Int32 words of a candidate's header in the stacked table, and their order
# (``csrc/resample.cu`` CandField): delta's float bits, the span, rows a
# tile, tiles a frame, the tiles a frame of the candidates before it take.
_CAND_WORDS = 5


@dataclasses.dataclass(frozen=True)
class CandidateTable:
    """The line tables and tile plans of a candidate set, stacked into one
    int32 tensor on one device: a header of ``_CAND_WORDS`` words a
    candidate, then line_start [C, h, 2], line_frac [C, h, 2] and wr [C, h]
    (the floats as their bits).  ``geometries`` are each candidate's
    :class:`ScreenGeometry` as views of that tensor."""

    table: torch.Tensor
    geometries: tuple[ScreenGeometry, ...]
    tiles_per_frame: int                   # every candidate's tiles of one frame
    run_cap: int                           # the largest stage buffer, in samples
    samples_per_frame: int                 # samples of a frame any candidate addresses


def _union_length(starts: np.ndarray, lengths: np.ndarray) -> int:
    """Length of the union of the intervals ``[starts, starts + lengths)``."""
    order = np.argsort(starts, kind="stable")
    total, reach = 0, None
    for s, e in zip(starts[order].tolist(), (starts + lengths)[order].tolist()):
        if reach is None or s >= reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return int(total)


@functools.lru_cache(maxsize=64)
def candidate_table(
    frame_len: int,
    rasters: tuple[tuple[int, int], ...],
    out_shape: tuple[int, int],
    device: torch.device,
    num_phases: int | None = None,
) -> CandidateTable:
    """Build the stacked table of the candidate rasters once per (set,
    device) and keep it on ``device``: each candidate's line tables as
    :func:`screen_geometry` builds them, its span, and the tile plan
    :func:`tile_plan` gives it for a float32 envelope (2 taps, no
    residuals).  One upload; a search over the same set rebuilds nothing."""
    if not rasters:
        raise ValueError("empty candidate set")
    h = int(out_shape[0])
    out_shape = (h, int(out_shape[1]))
    heads, starts, fracs, wrs, spans = [], [], [], [], []
    before, run_cap = 0, 4
    for y_t, x_t in rasters:
        line_start, line_frac, wr, delta, span = _line_tables(frame_len, y_t, x_t, out_shape)
        if num_phases is not None:
            line_frac = quantise_line_frac(line_frac, num_phases)
        rows, cap = tile_plan(frame_len, y_t, x_t, out_shape, 4)
        tiles = -(-h // rows)
        heads.append([int(np.float32(delta).view(np.int32)), span, rows, tiles, before])
        before += tiles
        run_cap = max(run_cap, cap)
        starts.append(line_start.astype(np.int32))
        fracs.append(line_frac.astype(np.float32))
        wrs.append(np.asarray(wr, np.float32))
        spans.append((delta, span))
    n = len(rasters)
    words = np.concatenate([
        np.asarray(heads, np.int32).reshape(-1), np.stack(starts).reshape(-1),
        np.stack(fracs).view(np.int32).reshape(-1), np.stack(wrs).view(np.int32).reshape(-1)])
    table = torch.from_numpy(words).to(torch.device(device))
    base = _CAND_WORDS * n
    geoms = tuple(
        ScreenGeometry(
            line_start=table[base + 2 * h * c: base + 2 * h * (c + 1)].view(h, 2),
            line_frac=table[base + 2 * h * (n + c): base + 2 * h * (n + c + 1)]
            .view(torch.float32).view(h, 2),
            wr=table[base + 4 * h * n + h * c: base + 4 * h * n + h * (c + 1)].view(torch.float32),
            delta=delta, span=span, out_shape=out_shape)
        for c, (delta, span) in enumerate(spans))
    reads = np.stack(starts).reshape(-1).astype(np.int64)
    lengths = np.repeat(np.array([span for _, span in spans], np.int64), 2 * h)
    return CandidateTable(table=table, geometries=geoms, tiles_per_frame=before, run_cap=run_cap,
                          samples_per_frame=_union_length(reads, lengths))


def candidates_launch_cost(n_samples: int, n_frames: int, table: CandidateTable) -> tuple[int, int]:
    """(bytes, float32 operations) of one launch over a candidate set: the
    samples of the block that any candidate's line tables address, read
    once; the frame starts and the stacked table read once; every
    candidate's screens written once.  Operations: each pixel's 2-tap read,
    as :func:`launch_cost` counts it."""
    h, w = table.geometries[0].out_shape
    pixels = len(table.geometries) * n_frames * h * w
    samples = min(int(n_samples), n_frames * table.samples_per_frame)
    nbytes = samples * 4 + 4 * n_frames + 4 * table.table.numel() + 4 * pixels
    return nbytes, pixels * (1 + 2 * 8 + 3)


def frames_to_screens_candidates_plain(
    env: torch.Tensor, frame_starts: torch.Tensor, table: CandidateTable,
) -> torch.Tensor:
    """The plain PyTorch version of the candidate launch, on any device:
    :func:`frames_to_screens_plain` of each candidate's geometry (views of
    the stacked table), stacked to [C, F, h, w]."""
    return torch.stack([frames_to_screens_plain(env, frame_starts, geom)
                        for geom in table.geometries])


def frames_to_screens_candidates(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    frame_len: int,
    rasters,
    out_shape: tuple[int, int] = RENDER_SIZE,
    num_phases: int | None = None,
) -> torch.Tensor:
    """The frames of a block under every candidate raster → (C, F, h, w)
    float32 screens, ``[c]`` equal to ``frames_to_screens(env, frame_starts,
    frame_len, *rasters[c], out_shape, None, 2, num_phases)`` to the bit.

    ``rasters`` are the candidates' (y_t, x_t): raster lines and raster
    width.  On a CUDA tensor this is ONE K1 launch whatever the number of
    candidates, its tiles over (candidate, frame, tile), the screens written
    in place; the stacked table is built and uploaded once per set."""
    rasters = tuple((int(y), int(x)) for y, x in rasters)
    _check_block(env, frame_starts, None, 2, "env")
    table = candidate_table(int(frame_len), rasters, tuple(out_shape), env.device, num_phases)
    if env.device.type == "cpu":
        return frames_to_screens_candidates_plain(env, frame_starts, table)
    if env.dtype != torch.float32:
        raise TypeError(f"K1 takes a float32 envelope, got {env.dtype}")
    n_frames = _check_launch(env, env.shape[0], frame_starts)
    h, w = table.geometries[0].out_shape
    out = torch.empty((len(rasters), n_frames, h, w), dtype=torch.float32, device=env.device)
    _build.launch("k1", _build.load_library("resample").tt_resample_candidates, env.device,
                  (candidates_launch_cost(env.shape[0], n_frames, table),), (2, False, "candidates"),
                  env.data_ptr(), env.shape[0], frame_starts.data_ptr(), n_frames,
                  table.table.data_ptr(), len(rasters), n_frames * table.tiles_per_frame,
                  out.data_ptr(), h, w, table.run_cap)
    return out
