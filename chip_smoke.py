#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths — the streaming reconstruction chain of
``tempest_tpu_torch``, its fidelity chain, ``auto_reconstruct``, and the
wideband path (band scan, multi-harmonic combining offline and live, the
runtime's tasks) — at full size: 1920x1080 @ 60 Hz (2576x1125 total) sampled
at 20 Msps, 36 frames (12,333,335 samples) per block, 600x800 screens.
Phases, each of which fails the run if it fails:

1. build K1 (``tempest_tpu_torch/csrc/resample.cu``), K2 (``csrc/sync.cu``)
   and K3 (``csrc/align_ema.cu``) with nvcc for sm_90a, one nvcc a source,
   all started together, and print what ptxas reports of each kernel;
2. hold both entries of K1 against their plain PyTorch versions on the
   card, at the slice's shapes: the envelope entry (``frames_to_screens``)
   and the fused entry (``frames_to_screens_from_words``, AM demod taken
   inside the kernel) on int16 and on float32 words, also on a block cut
   short so that the last frame reads past its end, and from a source that
   is not 16-byte aligned; time each, single call and back to back, beside
   its bound; hold them at screen widths that take the kernel's other work
   splits (one column a work item, more work items a row than threads);
   time each entry at 4, 8 and 16 rows a tile; hold K1's single-frame launch
   (``frame_to_screen``, one launch a call) to the bit at every shape, with
   and without a residual, 2 and 4 taps, time it at each of its tile plans
   beside its bound, and profile its wrapper's host time (with ``--parent
   DIR``, the same against that checkout's ``frame_to_screen``, in turns);
3. run three blocks of a synthetic capture through
   ``StreamingRuntime.process_blocks`` on the card, check that the fused
   entry carried them with no separate demod pass, K2 twice a block at most
   and K3 once a block (aligning and folding), that the outputs stayed
   on the card, that the final EMA matches the port's CPU run of the same
   blocks, and that its PSNR against the capture's ground truth clears the
   bar; time the step;
4. run two blocks through the runtime with ``invert=True``: each block one
   launch of the block maximum (``words_maxima``) and one of K1's words
   entry with the inversion, no demod pass, on the card and on the CPU;
5. hold K1 with per-frame residuals, with 4 taps (its own kernel, the
   Catmull-Rom read redesigned) and with both against its plain version to
   the bit, on the envelope entry and on both word entries, also with the
   first frame at sample 0, on a block cut short and from an unaligned
   source, and at the shapes of 640x480 @ 60 Hz at 32 Msps; time each beside
   the 2-tap rounded-cut times and beside both its bounds, bytes and
   instructions; hold and time the 4-tap envelope entry and the int16 words
   under the AM and the FM load also at the 640x480 shapes that phase 8
   launches (11 frames), with their device time; time the int16 FM load
   there at 5 to 8 rows a tile and, with ``--parent DIR``, against that
   checkout's in turns;
6. run three blocks through ``StreamingRuntime(fidelity=True)`` (exact cuts
   through K1's residuals, sync skipped, K3's fold alone once a block), and
   one with 4 taps: PSNR against its bar, card against CPU;
7. ``auto_reconstruct`` on the first 0.62 s of the capture as int16 words:
   the mode's name, the refresh, the line count against the port's CPU run,
   PSNR of the restored and of the raw image, the two stages' times;
8. ``auto_reconstruct`` on 640x480 @ 60 Hz at 32 Msps, where the taps rule
   picks 4, AM and FM (``demod="fm"``): the mode found, K1's 4-tap words
   entry launched, with the AM or the FM load;
9. offline, wideband: three carriers of one 640x480 screen in 0.55 s at
   32 Msps (17.6 M samples; 4 MHz channels of 2²¹ samples): ``scan_band``
   finds the three emissions at one refresh, ``combined_reconstruct`` with
   discovery names the mode, flips the inverted carrier, weights the
   carriers in strength order, beats the strongest single carrier, launches
   K1's envelope entry once a reconstruction and agrees with the port's CPU
   run; the stages' times;
10. live, wideband: two equal carriers of the 1080p60 screen at 20 Msps,
    three blocks through ``StreamingRuntime(combine=[...])``, default chain
    and ``fidelity=True``: the fused EMA's PSNR above the single-carrier
    run's, both weights above 0.3, K1's envelope entry once a block, a
    checkpoint resumed mid-run giving the uninterrupted run's EMA;
11. the runtime's tasks: ``scan`` over three frequencies of a small tunable
    source, ``refine_refresh_from_drift`` from 0.01 Hz off, ``record``, and
    the native ring against the Python ring;
12. batched serving: ``make_batched_reconstruct_fn`` on 4 streams of the
    slice's int16 words, static cuts and ``carry_phase`` with exact cuts: one
    K1 launch a step for the 144 frames (the caller's words as they lie,
    each stream clamped into its own block: no layout copy), equal to its
    plain version to the bit, each stream's EMA, frames, sync and score
    equal to the single-stream step's to the bit with the sync NOT pinned
    (and once more pinned), K2 giving each frame the same bits among 144
    and among its stream's 36; the step's time beside four single-stream
    steps, its device events (no demod, no layout copy); then the same step
    under FM and under ``invert`` (one block maximum for the four streams):
    one K1 words launch, each stream equal to its single step to the bit, 5
    and 6 device events, and with ``--parent DIR`` timed in turns with that
    checkout's step (its demod passes);
13. the mode search: ``mode_search_static`` over the video modes near 60 Hz,
    one K1 launch over the candidate set at a 150x200 score grid
    (``frames_to_screens_candidates``), held to the bit against its plain
    version and against one launch per candidate, and timed beside that
    route; the winner the capture's mode; K1 also at coarser grids where the
    plan halves a tile's rows; then ``auto_reconstruct(refine_with_search=
    True)``, one K1 launch for its search;
14. every ``resampler=`` name through ``reconstruct_frames`` on the 36-frame
    capture: PSNR beside K1's, the difference from K1 beside the bound the
    quantisation gives, the names that round to bfloat16 through K1's words
    load with no pass, K1 with the quantised table against its plain version
    (launched on the envelope by ``mxu3`` on complex input);
15. the command line in process (``synth``, ``analyze``, ``reconstruct``,
    ``scan``, ``survey``, ``stream``, ``search``, ``warmup``, and ``stream
    --mesh 4`` and ``search --dynamic --devices 4`` on four shards of the
    card; one K1 launch a search, one a shard) and the web view on an
    ephemeral port;
16. ``roofline()`` of one default step: the kernels' bytes equal K1's, K2's
    and K3's ``launch_cost``;
17. (m) the mesh on one card: ``MeshStreamingRuntime`` over four shards of
    12,333,336 samples (36 frames each) of the capture replayed in a loop,
    two dispatches, default and fidelity chains, held to the bit against
    the single-device runtime on the same stream in blocks of one span; its
    times, the collectives' times and bytes, K1 and K3 once and K2 twice a
    shard a dispatch (K2 not with fidelity); the same stream through a
    process group of one NCCL rank;
18. (n) ``sharded_mode_search`` over the 26 candidates of phase 13 on four
    shards of the card (one K1 launch a shard; its winner the static
    search's), and
    ``sharded_scan_band``, ``sharded_combine_harmonics`` and
    ``sharded_combined_reconstruct_fn`` on the capture of phase 9, held
    against the single-device functions;
19. (o) with 2 or more cards only: the (m) stream over the cards in one
    process and on one NCCL rank a card (ranks this script starts), and the
    live combine front on those ranks, held against the single-device
    results; ``--phase o`` runs the build, the capture, phase 17 (the
    reference) and this phase alone;
20. (run after phase 2) K2 and K3 against their plain versions on the
    slice's 36 screens: K2's integer centres equal, sub-pixel centres and
    scores within their tolerances, a frame's bits the same alone and in the
    block; K3 equal to the bit, integer, linear, cubic and the fold alone,
    its EMA beside one ``torch.tensordot``; each timed beside its bound and
    its plain version;
21. the default step stage by stage with CUDA events (demod and K1, K2, K3),
    and its wall clock, device time and kernel count with the kernels and
    with their plain versions in their place, in turns; then the step's
    plan: 24 steps of ``bench_config()`` issued back to back with nothing
    synchronising after the key's first, equal to the wrappers' steps to
    the bit, and the host's issue of a step planned and through the
    wrappers, in turns;
22. the repo's entry points in the port (``tempest_tpu_torch/bench/``): the
    ``bench`` line (``bench.py``'s keys, a positive rate), every
    ``bench_all`` line in the JAX script's order (the launch counts set to 0
    before it: scenario 3 is K1's single-frame launch), ``entry()``'s step,
    ``dryrun_multichip(1)`` and ``dryrun_multichip(4)`` on four shards of the
    card; ``--phase o`` on four cards also runs ``dryrun_multichip(4)`` over
    them;
23. stage 1 inside K1's words load: every load (AM, AM rounded to bfloat16,
    FM, FM rounded) on int16 and float32 words, 2 and 4 taps, with and
    without residuals, equal to its plain version to the bit (also at the
    block's edges, from an unaligned source, at ``OTHER_SHAPES``), timed
    beside its bound; ``bench_config()``'s ``mxu3`` step and the slice's FM
    step against the same steps with the demod and rounding as passes: the
    same bits, wall clock and device time in turns, 5 device events a step;
    the launches of each new load on its main path (the bench line, the
    slice's FM step on int16 words, the runtime under ``mxu3``, FM and both,
    4 taps with ``invert``, complex input with 4 taps); the int16 FM load's
    arc tangent against ``torch.atan2`` on every sample of 2^26 random
    quadruples of int16 words and of every edge quadruple, to the bit, and
    the float32 FM load's on 2^26 samples at each of three scales (integer
    valued, unit, random exponents) and every edge quadruple (zeros,
    subnormals, infinities, NaN, overflowing products, the bounds of its
    branchless domain); the int16 FM load at 5 to 8 rows a tile and the
    float32 one at 4 to 6; with ``--parent DIR`` each int16 and float32 FM
    row at the slice's shapes and that checkout's bench line in turns with
    this one's;
24. ``invert`` in K1's words load: the block maximum against ``torch.max``
    of the plain envelope to the bit (int16 and float32, AM and FM, 1 and 4
    streams, the int16 range's ends, an all-zero stream, NaN and infinities
    in float32 words), timed beside its bounds (bytes, instructions);
    every inverted load (AM, AM rounded, FM, FM rounded; int16 and float32;
    2 and 4 taps; with and without residuals) equal to its plain version to
    the bit and timed; the
    slice's step under ``invert`` (2 taps, 4 taps, ``mxu3``) against the
    pass route: the same bits, 6 device events (the block maximum, K1, K2a,
    K2b, K3, the upload), wall clock and device time in turns; with
    ``--parent DIR`` the block maximum, each inverted load and the inverted
    step in turns with that checkout's.

Run ``python3 chip_smoke.py`` from the root of a checkout on a machine with
a CUDA card; it ends with torch.profiler tables of three steps, with the
demod fused and as a separate pass.  The last line of standard output is
``{"ok": true, "device": {...}}``; any failure exits non-zero without it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

MODE_NAME = "1920x1080 @ 60Hz"
SAMPLE_RATE = 20e6
N_FRAMES = 36
N_BLOCKS = 3
ALPHA = 0.1
SNR_DB = 18.0
SEED = 33
INT16_SCALE = 8192.0  # capture amplitude ~2.4 at most -> |word| < 20k

# Aligned PSNR of the JAX package's chain (resampler="gather") on the same
# capture and frame grid, 12.9727 dB measured on the CPU, less 0.3 dB — see
# PERF.md, "PSNR bar".
PSNR_BAR_DB = 12.6727
# The same for the fidelity chain (exact cuts, sync skipped): 12.1804 dB from
# exp/torch_psnr_bar.py --chain fidelity on the CPU, less 0.3 dB.
FIDELITY_PSNR_BAR_DB = 11.8804
K1_REL_TOL = 1e-6     # K1 and its plain version do the same f32 operations
# Card vs CPU: the f32 profile sums and prefix sums reassociate, which moves
# the sub-pixel sync fraction (2.7e-3 px measured, PERF.md) and the EMA.
EMA_REL_TOL = 1e-3    # of the EMA's range
SYNC_ABS_TOL = 1e-2   # px
# K2 against its plain version on the card: the same operations, the sums in
# another order (tests/test_torch_sync_kernel.py derives both bounds).
K2_FRAC_TOL = 1e-2    # px, sub-pixel centres
K2_SCORE_REL = 1e-4   # scores, relative
# K3's fold against one torch.tensordot of the same weights and frames: the
# 36 products added in another order, and the EMA's own product and sum, on
# non-negative screens: at most 38 roundings of 2^-24 of the EMA's value.
K3_TENSORDOT_REL = (N_FRAMES + 2) * 2.0 ** -24
TIMED_CALLS = 30
BACK_TO_BACK = 50     # launches between two events
# The kernels' sources, built at once, one nvcc each.
KERNEL_SOURCES = ("resample", "sync", "align_ema")
INVERT_BLOCKS = 2     # depth of the inverted runtime's run of phase 4
# Screens whose width is no multiple of 4 (one column a work item; fewer and
# more work items a row than the block has threads), one of more than
# 4 x 256 columns, and one of so few rows that the wrapper takes fewer rows a
# tile: the work splits the slice's 600x800 does not take.
OTHER_SHAPES = ((600, 99), (601, 402), (300, 2048), (48, 99))
TILE_ROWS = (4, 8, 16)
# The single-frame launch's tile plans: FILL_TILES_PER_SM 0 takes the rows of
# a many-frame launch (8), 1, 2 and 4 at least that many tiles an SM.
FILL_SWEEP = (0, 1, 2, 4)
VARIANT_OFFSET = 0.6          # a single frame's residual
HOST_PROFILE_CALLS = 500
# The repo's bench.py line's keys, and its bench_all.py lines' metrics in
# order (N: the mesh's shards).
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "ms_per_block", "iters", "n_frames",
              "block_samples", "device", "power_limit_w")
BENCH_ALL_METRICS = (
    "AM envelope demod (int16 ingest)", "autocorrelation timing estimation",
    "signal->screen resample (1 frame)", "full chain 1080p60",
    "batched serving x4 streams 1080p60 (aggregate)",
    "streaming fidelity 1080p60 (quantised exact-cut tables)",
    "live-combine front (K=3 channelise + MRC fusion)",
    "sharded mode search (26 candidates, N dev)", "host ring put+take (python)",
    "host ring put+take (C++ native)", "streaming host loop 1080p60 (source->ring->device->EMA)",
    "mesh streaming host loop 1080p60 (N shards)")
# K1's variants beside the 2-tap rounded cut: (taps, per-frame residuals).
VARIANTS = ((2, True), (4, False), (4, True))
VARIANT_PHASE = 1234.56   # first frame boundary of the variants' block
# Where the taps rule of auto_reconstruct picks Catmull-Rom: at least one
# sample per raster pixel (32 Msps over 800x525x60 pixels a second: 1.27).
SMALL_MODE_NAME = "640x480 @ 60Hz"
SMALL_SAMPLE_RATE = 32e6
SMALL_SECONDS = 0.2
REFRESH_TOL_HZ = 0.01
# Card vs CPU line count: both choose the line period on a 1/8-sample grid,
# where one step is 0.47 lines at 1080p60, so 1e-3 means the same choice.
LINES_TOL = 1e-3
RENDER = (600, 800)           # the screens' shape everywhere (the config's default)

# The wideband configurations.  Offline: the size of the JAX package's own
# combining fixture.  Live: the main path's screen and rate with two carriers.
WIDE_SECONDS = 0.55
WIDE_CARRIERS = [-8e6, 2.5e6, 11e6]
WIDE_AMPLITUDES = [1.0, 0.7, 0.5]
WIDE_DEPTHS = [0.8, -0.8, 0.8]
WIDE_SNR_DB = 6.0
WIDE_SEED = 5
WIDE_ALPHA = 0.7
CHAN_BW = 4e6
COMBINE_GAIN_DB = 0.4         # fusion over the strongest single carrier
# Detection margin over the measured noise floor.  At this size the
# emissions' sidebands light every channel to 9-13 dB where the carriers'
# channels read 17-24 dB and the floor 7.3 dB.  The default margin of 5 dB
# cuts through the sidebands: which of them pass, and whether they merge with
# a carrier's group or stand alone, then hangs on the floor's draw (the JAX
# package's draw of the same null reads 5.9 dB at this geometry and merges
# them; the port's 7.3 dB leaves the channel at -2 MHz alone, as a fourth
# emission).  8 dB lies clear of both populations.
WIDE_MARGIN_DB = 8.0
LIVE_CARRIERS = [-5e6, 4e6]
LIVE_SNR_DB = 0.0
LIVE_ALPHA = 0.7
WEIGHT_TOL = 1e-3             # card vs CPU: ratios of means over float32 FFT outputs
# Card vs CPU of a whole combined reconstruction: the sub-pixel sync of noisy
# frames reassociates as in EMA_REL_TOL, through 32 frames at alpha 0.7.
WIDE_IMAGE_TOL = 5e-3         # of the image's range
RESUME_REL_TOL = 1e-6         # a resumed run repeats the same device operations
SCAN_RATE = 2e6               # the tunable source of the tasks phase
SCAN_EMISSION_HZ = 3e6
DRIFT_OFFSET_HZ = 0.01
DRIFT_TOL_HZ = 1e-3

# Batched serving: streams a step, and the phases of the carried streams.
N_STREAMS = 4
STREAM_PHASES = [0.0, 1234.56, 98765.4321, 222222.125]
# A batched step equals the single steps to the bit, sync not pinned: K1 is
# per frame, K2's sums depend on the frame alone, and K3 folds each stream in
# the single step's order.  (Before K2 the plain sync's float32 profile sums
# changed order with the batch and moved the sub-pixel fraction by 2.7e-3
# px between 36 and 144 frames, the EMA by up to 9.6e-4 of its range.)
# The mode search: modes within this of 60 Hz, on the JAX package's defaults.
SEARCH_TOL_HZ = 0.5
SEARCH_SCORE_SIZE = (150, 200)
SEARCH_FRAMES = 2
# Coarser score grids, where a tile's rows no longer fit a block's shared
# memory and the plan halves them (to four and two rows of float32 samples).
COARSE_SCORE_SIZES = ((75, 100), (30, 40))
SEARCH_PHASES = 16
RESAMPLER_PHASES = 64         # the config's default num_phases
BF16_REL = 2.0 ** -8          # bound of a bfloat16 rounding, relative
CLI_SECONDS = 0.35            # the capture the command line phase synthesises

# The mesh: four shards of the smallest span that holds 36 frames (one less
# sample holds 35), two dispatches; the capture replayed in a loop of 111
# frame periods (37 x 3 frames of 1e6/3 samples), so that the frame grid
# runs on across the loop's seam.
MESH_SHARDS = 4
MESH_SPAN = 12_333_336
MESH_DISPATCHES = 2
LOOP_SAMPLES = 37_000_000
# Carrier shards against the single-device functions: the tolerances of the
# single-device parity tests (cuFFT's rows and the fusion's sums come in
# another order when each shard has its own rows).
WIDE_DB_TOL = 0.05
WIDE_WEIGHT_REL = 1e-4
WIDE_ENV_REL = 1e-5


class BlockSource:
    """A finite source that serves the given complex64 blocks in order, then
    reports the capture exhausted (the producer then closes the ring; the
    blocks already in it are still delivered)."""

    def __init__(self, blocks: np.ndarray, sample_rate: float) -> None:
        self.blocks = blocks
        self.sample_rate = float(sample_rate)
        self.block_size = int(blocks.shape[1])
        self._next = 0

    def read(self, out: np.ndarray) -> None:
        if self._next >= len(self.blocks):
            raise EOFError("capture exhausted")
        np.copyto(out, self.blocks[self._next])
        self._next += 1

    def close(self) -> None:
        pass


def slice_config(tp):
    """The slice's step config, as the streaming runtime builds it."""
    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    return tp.ReconstructionConfig(
        sample_rate=SAMPLE_RATE, mode=mode, n_frames=N_FRAMES, carry_phase=True,
        input_format="iq_interleaved", resampler="pallas",
        do_align=True, align_subpixel=True, align_interp="linear")


def fidelity_config(tp, **overrides):
    """The fidelity chain's step config, as the streaming runtime builds it."""
    return dataclasses.replace(slice_config(tp), subsample_align=True, do_align=False,
                               align_subpixel=False, phase_bins=64, **overrides)


def quantise(iq: np.ndarray) -> np.ndarray:
    """Complex samples as the int16 I/Q words an SDR delivers."""
    return np.clip(np.round(iq.view(np.float32) * INT16_SCALE), -32768, 32767).astype(np.int16)


def make_capture(generate_iq, mode, block: int):
    """``N_BLOCKS`` blocks of the synthetic 1080p60 capture, quantised to
    int16 words as an SDR delivers them.  Returns (words int16 [2·n],
    ground-truth raster).  The capture holds one frame period more than the
    blocks, so that a reference may read past the last block."""
    spf = SAMPLE_RATE / mode.refresh
    n = N_BLOCKS * block + int(np.ceil(spf)) + 1
    cap = generate_iq(mode, SAMPLE_RATE, n, snr_db=SNR_DB, seed=SEED)
    return quantise(cap.iq), cap.frame


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_call(torch, fn, calls: int = TIMED_CALLS) -> float:
    """Median milliseconds of ``calls`` calls, each fenced by
    ``torch.cuda.synchronize()`` and timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_back_to_back(torch, fn, launches: int = BACK_TO_BACK) -> float:
    """Milliseconds per call of ``launches`` calls between two CUDA events
    with no fence between them; the median of three such runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def k1_bound_parts(n_samples: int, sample_bytes: int, n_frames: int, raster: tuple,
                   word: int, taps: int = 2, exact: bool = False) -> dict:
    """The three least times of one K1 call on ``raster`` (frame length,
    raster lines, raster width, screen shape), in ms: its bytes over the
    memory rate, its float32 operations over the peak rate (both
    ``resample_kernel.launch_cost``: the samples the line tables address,
    not what the kernel stages; a roofline count of the step takes the
    same), and the least instructions it issues over the card's issue rate
    (``resample_kernel.launch_instructions``; ``sync_kernel.H100_ISSUE_PER_S``),
    against the published peaks of one H100 SXM at its full 700 W
    (``utils.roofline.H100_PEAKS``); and the bytes.  ``word`` is the word
    code K1 stages (``resample_kernel.word_code``; 0 or False an envelope,
    True AM words)."""
    from tempest_tpu_torch.ops.resample_kernel import launch_cost, launch_instructions
    from tempest_tpu_torch.ops.sync_kernel import H100_ISSUE_PER_S
    from tempest_tpu_torch.utils.roofline import H100_PEAKS

    args = (n_samples, sample_bytes, n_frames, *raster, word, taps, exact)
    nbytes, flops, _ = launch_cost(*args)
    return {"bytes": 1e3 * nbytes / H100_PEAKS["bytes_per_s"],
            "flops": 1e3 * flops / H100_PEAKS["flops_per_s"],
            "instructions": 1e3 * launch_instructions(*args) / H100_ISSUE_PER_S,
            "nbytes": nbytes}


def k1_bound(n_samples: int, sample_bytes: int, n_frames: int, raster: tuple,
             word: int, taps: int = 2, exact: bool = False) -> tuple[float, str, int]:
    """The least milliseconds the card could take for one K1 call: the
    largest of :func:`k1_bound_parts`.  Returns (ms, "bytes" or
    "operations", bytes); operations are float32 operations or
    instructions, whichever bound is larger."""
    parts = k1_bound_parts(n_samples, sample_bytes, n_frames, raster, word, taps, exact)
    ops = max(parts["flops"], parts["instructions"])
    return max(parts["bytes"], ops), ("bytes" if parts["bytes"] >= ops else "operations"), \
        parts["nbytes"]


def device_ms(prof) -> float:
    """Total time of the kernels of a torch.profiler run, in milliseconds
    (the table's "Self CUDA time total")."""
    from torch.autograd import DeviceType

    return sum(evt.self_device_time_total for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA) / 1e3


def device_by_kernel(prof, steps: int) -> dict:
    """{kernel or copy name: (device ms a launch, launches a step)} of a
    torch.profiler run over ``steps`` steps, the longest first.  A launch's
    time is its events' mean, and a step's launches their count over the
    steps rounded, at least 1: the profiler drops a step's device events now
    and then, which would bias a sum over the window."""
    from torch.autograd import DeviceType

    rows = {evt.key: (evt.self_device_time_total / 1e3 / evt.count,
                      max(1, round(evt.count / steps)))
            for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA and evt.count}
    return dict(sorted(rows.items(), key=lambda kv: -kv[1][0] * kv[1][1]))


def short_name(key: str) -> str:
    """A kernel's profiler name without its namespace, return type and
    arguments: ``align_fold_kernel<2, true>``."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0] or key


def step_device_ms(by_kernel: dict) -> tuple[float, int]:
    """(device ms, launches) of one step from :func:`device_by_kernel`."""
    return (sum(ms * n for ms, n in by_kernel.values()),
            sum(n for _, n in by_kernel.values()))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def through_wrappers(poff):
    """Steps inside call the kernels' wrappers that ``poff`` names (which a
    phase may replace there), not a step plan's launches: no plan is kept or
    used inside."""
    saved = poff._on_card, poff._PLANS
    poff._on_card, poff._PLANS = (lambda device: False), {}
    try:
        yield
    finally:
        poff._on_card, poff._PLANS = saved


def run_runtime(tp, blocks, mode, device, **runtime_options):
    """Drive ``StreamingRuntime.process_blocks`` over the blocks on
    ``device``; returns (final EMA, per-block syncs, output device types,
    seconds).  ``runtime_options`` go to the runtime (``invert``,
    ``fidelity``, ``config_overrides``)."""
    n_blocks = len(blocks)
    rt = tp.StreamingRuntime(BlockSource(blocks, SAMPLE_RATE), mode,
                             n_frames_per_block=N_FRAMES, alpha=ALPHA,
                             ring_depth=4, device=device, **runtime_options)
    step = rt._step
    out_devices = []

    def traced_step(*args):
        out = step(*args)
        out_devices.extend(t.device.type for t in out)
        return out

    rt._step = traced_step
    syncs = []
    rt.start()
    try:
        t0 = time.perf_counter()
        ema = rt.process_blocks(n_blocks, sink=lambda img, info: syncs.append(info["sync"]))
        seconds = time.perf_counter() - t0
    finally:
        rt.stop()
    check(rt.ring.overflows == 0 and rt.ring.last_seq == n_blocks - 1,
          f"runtime on {device} took blocks 0..{n_blocks - 1} in order "
          f"(overflows {rt.ring.overflows}, last seq {rt.ring.last_seq})")
    check(len(syncs) == n_blocks, f"{n_blocks} blocks processed on {device}")
    return ema, np.concatenate(syncs), out_devices, seconds


def wall_ms(torch, fn, calls: int = 3) -> float:
    """Median wall-clock milliseconds of ``fn()`` followed by a device fence."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


class TunableSource:
    """A tunable receiver in small: delivers a looping emission when tuned
    within 0.4 MHz of ``SCAN_EMISSION_HZ`` and weak noise elsewhere — the
    surface of a hardware source that ``StreamingRuntime.scan`` relies on
    (the file and synthetic sources have no tuner)."""

    def __init__(self, emission: np.ndarray, block_size: int) -> None:
        self.sample_rate = SCAN_RATE
        self.block_size = block_size
        self.carrier_freq = 0.0
        self._sig = emission
        self._pos = 0
        self._rng = np.random.default_rng(11)

    def set_carrier(self, freq: float) -> None:
        self.carrier_freq = float(freq)

    def read(self, out: np.ndarray) -> None:
        n = self.block_size
        if abs(self.carrier_freq - SCAN_EMISSION_HZ) < 0.4e6:
            out[:] = np.take(self._sig, np.arange(self._pos, self._pos + n), mode="wrap")
            self._pos += n
        else:
            out[:] = (0.2 * (self._rng.standard_normal(n) + 1j * self._rng.standard_normal(n))
                      ).astype(np.complex64)

    def close(self) -> None:
        pass


def hold_envelope_entry(tp, torch, env, starts, fracs, raster, label: str) -> None:
    """K1's envelope entry against its plain version on a fused envelope, at
    the shapes a combine path gives it."""
    from tempest_tpu_torch.ops.resample_kernel import (
        frames_to_screens, frames_to_screens_plain, screen_geometry)

    geom = screen_geometry(*raster, env.device)
    got = frames_to_screens(env, starts, *raster, fracs, 2)
    ref = frames_to_screens_plain(env, starts, geom, fracs, 2)
    torch.cuda.synchronize()
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    print(f"[K1 envelope, {label}] {starts.numel()} frames of {raster[0]} samples from a fused "
          f"envelope of {env.numel()}: relative diff vs plain {rel:.3e} "
          f"(tolerance {K1_REL_TOL:g})")
    check(got.shape[0] == starts.numel() and bool(torch.isfinite(got).all())
          and rel < K1_REL_TOL, f"K1's envelope entry, {label}, agrees with its plain version")


def phase_offline_wideband(tp, torch, dev, card: str, seen):
    """Phase 9: wideband capture -> carriers -> fused image, offline, at the
    size of the JAX package's combining fixture.  Returns the launch counts
    of K1's envelope entry over the path, and the capture (fixture (e))."""
    from tempest_tpu_torch.ops import combine as pcomb
    from tempest_tpu_torch.ops import scan as pscan
    from tempest_tpu_torch.pipeline import offline as poff

    mode = tp.ALL_VIDEO_MODES[SMALL_MODE_NAME]
    fs = SMALL_SAMPLE_RATE
    t0 = time.perf_counter()
    cap = tp.generate_iq_harmonics(mode, fs, int(fs * WIDE_SECONDS), WIDE_CARRIERS,
                                   amplitudes=WIDE_AMPLITUDES, depths=WIDE_DEPTHS,
                                   snr_db=WIDE_SNR_DB, seed=WIDE_SEED)
    n_fft, m_chan, fs_chan = pscan._channel_geometry(len(cap.iq), fs, CHAN_BW)
    centers = pscan.scan_centers(fs, CHAN_BW / 2, CHAN_BW / 2)
    print(f"[wideband] {len(cap.iq)} samples of {SMALL_MODE_NAME} at {fs / 1e6:g} Msps, carriers "
          f"{[c / 1e6 for c in WIDE_CARRIERS]} MHz at {WIDE_SNR_DB:g} dB SNR, in "
          f"{time.perf_counter() - t0:.1f} s; FFT window {n_fft}, {len(centers)} channels of "
          f"{m_chan} samples at {fs_chan / 1e6:g} Msps")
    check((n_fft, m_chan, fs_chan) == (1 << 24, 1 << 21, 4e6) and len(centers) == 15,
          "the offline wideband geometry is the fixture's")
    host_words = cap.iq.view(np.float32)
    upload_ms = wall_ms(torch, lambda: torch.from_numpy(host_words).to(dev))
    words = torch.from_numpy(host_words).to(dev)

    # The band scan: what it finds, then its time and the time of its parts.
    torch.cuda.reset_peak_memory_stats()
    res = pscan.scan_band(words, fs, centers, chan_bw=CHAN_BW)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    ems = res.emissions(min_margin_db=WIDE_MARGIN_DB)
    print(f"[scan_band] floor {res.floor_db[0]:.2f} dB; prominence "
          f"{np.round(res.prominence_db, 1).tolist()}; {len(ems)} emissions at a margin of "
          f"{WIDE_MARGIN_DB:g} dB: "
          f"{[(e['best_channel_hz'] / 1e6, round(e['refresh_hz'], 4)) for e in ems]} "
          f"({len(res.emissions())} at the default margin); peak device memory {peak_mb:.0f} MB")
    check(len(ems) == 3, "scan_band finds three emissions")
    for e in ems:
        check(min(abs(e["best_channel_hz"] - c) for c in WIDE_CARRIERS) <= CHAN_BW / 2
              and e["prominence_db"] - e["floor_db"] >= WIDE_MARGIN_DB,
              f"emission at {e['best_channel_hz'] / 1e6:g} MHz lies on a carrier, above the floor")
    screens = poff.discover_screens(None, fs, CHAN_BW, scan_result=res,
                                    min_margin_db=WIDE_MARGIN_DB)
    check(len(screens) == 1 and len(screens[0]) == 3
          and all(abs(e["refresh_hz"] - mode.refresh) < REFRESH_TOL_HZ for e in screens[0]),
          "the three emissions are one screen at one refresh")
    scan_ms = wall_ms(torch, lambda: pscan.scan_band(words, fs, centers, chan_bw=CHAN_BW))
    z = torch.view_as_complex(words[: 2 * n_fft].reshape(n_fft, 2))
    fft_ms = wall_ms(torch, lambda: torch.fft.fft(z))
    chans, _ = pscan._channelize_complex(words, fs, centers, CHAN_BW)
    chan_ms = wall_ms(torch, lambda: pscan._channelize_complex(words, fs, centers, CHAN_BW))
    ifft_ms = wall_ms(torch, lambda: torch.fft.ifft(chans, dim=1))
    envs = pscan._demod_rows(chans, "am")
    score_ms = wall_ms(torch, lambda: pscan._comb_contrast(envs, fs_chan, 0.1, 50.0, 90.0))
    # Measured afresh each time: a repeated geometry's floor is a lookup.
    floor_ms = wall_ms(torch, lambda: (pscan._measured_floor.cache_clear(),
                                       pscan._noise_floor(fs_chan, m_chan, 0.1, 50.0, 90.0,
                                                          device=dev)))
    draws_ms = wall_ms(torch, lambda: pscan.noise_floor_draws(m_chan), calls=1)
    print(f"[scan_band] {scan_ms:.2f} ms for {len(centers)} channels, words on the card "
          f"(upload of {host_words.nbytes / 1e6:.1f} MB: {upload_ms:.2f} ms); its parts: "
          f"channeliser {chan_ms:.2f} ms (the {n_fft}-point FFT alone {fft_ms:.2f}, the batched "
          f"inverse FFT alone {ifft_ms:.2f}), scoring {score_ms:.2f} ms, floor {floor_ms:.2f} ms "
          f"(of which drawing the surrogates on the host {draws_ms:.2f}); wall clock, median "
          f"of 3, on {card}")
    del z, chans, envs

    # The fusion alone: channel envelopes, scoring pass, re-weighting pass.
    amp = pcomb._channel_envelopes(words, fs, WIDE_CARRIERS, CHAN_BW, "am", None)
    amp_ms = wall_ms(torch, lambda: pcomb._channel_envelopes(words, fs, WIDE_CARRIERS, CHAN_BW,
                                                             "am", None))
    fuse_args = (amp, fs_chan, 0.1, 50.0, 90.0, "mrc")
    pass1_ms = wall_ms(torch, lambda: pcomb._fuse(*fuse_args, None))
    pass2_ms = wall_ms(torch, lambda: pcomb._fuse(*fuse_args, mode.refresh))
    comb_ms = wall_ms(torch, lambda: pcomb.combine_harmonics(words, fs, WIDE_CARRIERS, CHAN_BW))
    print(f"[combine_harmonics] {comb_ms:.2f} ms for 3 carriers: channel envelopes {amp_ms:.2f} "
          f"ms, pass 1 (autocorrelation search) {pass1_ms:.2f} ms, pass 2 (frame-periodic MRC) "
          f"{pass2_ms:.2f} ms; wall clock, median of 3, on {card}")
    del amp, fuse_args

    # The main path: discovery, fusion, reconstruction through K1.
    truth = tp.downgrade_image(torch.from_numpy(cap.frame)).numpy()
    seen.clear()
    timing, recon, comb = tp.combined_reconstruct(words, fs, None, chan_bw=CHAN_BW,
                                                  alpha=WIDE_ALPHA, min_margin_db=WIDE_MARGIN_DB)
    launches = seen["k1", 2, False]
    check(launches == 1 and k1_launches(seen, "envelope") == 1
          and k1_launches(seen, "words") == 0,
          f"combined_reconstruct went through K1's envelope entry once ({launches})")
    _, single, _ = tp.combined_reconstruct(words, fs, [WIDE_CARRIERS[0]], chan_bw=CHAN_BW,
                                           alpha=WIDE_ALPHA)
    check(k1_launches(seen, "envelope") == 2, "one more launch for one more reconstruction")
    p3, _ = tp.aligned_psnr(truth, recon.image)
    p1, _ = tp.aligned_psnr(truth, single.image)
    print(f"[combined_reconstruct] {timing.mode_name}, refresh {timing.refresh_hz:.6f} Hz, carriers "
          f"{(comb.centers_hz / 1e6).tolist()} MHz, weights {np.round(comb.weights, 4).tolist()}, "
          f"polarity {comb.polarity.tolist()}, {recon.frames.shape[0]} frames; aligned PSNR fused "
          f"{p3:.3f} dB, strongest carrier alone {p1:.3f} dB (bar +{COMBINE_GAIN_DB} dB)")
    check(timing.mode_name == SMALL_MODE_NAME, "combined_reconstruct names the mode")
    # Discovery lists the carriers by comb mass; the capture lists them by
    # frequency, strongest first.
    by_freq = np.argsort(comb.centers_hz)
    check(comb.polarity[by_freq].tolist() == [1.0, -1.0, 1.0], "the inverted carrier is flipped")
    w = comb.weights[by_freq]
    check(w[0] > w[1] > w[2] > 0.1 and abs(w.sum() - 1.0) < 1e-6,
          "weights in strength order, summing to 1")
    check(recon.image.shape == RENDER and bool(np.isfinite(recon.image).all()),
          "fused image finite, of the screen's shape")
    check(p3 > p1 + COMBINE_GAIN_DB, "the fusion beats the strongest single carrier")

    t0 = time.perf_counter()
    cpu_timing, cpu_recon, cpu_comb = tp.combined_reconstruct(
        cap.iq, fs, comb.centers_hz, chan_bw=CHAN_BW, alpha=WIDE_ALPHA, device="cpu")
    span = float(cpu_recon.image_raw.max() - cpu_recon.image_raw.min())
    img_rel = float(np.abs(recon.image_raw - cpu_recon.image_raw).max()) / span
    w_err = float(np.abs(comb.weights - cpu_comb.weights).max())
    print(f"[combined_reconstruct] CPU run {time.perf_counter() - t0:.1f} s; card vs CPU: weights "
          f"max diff {w_err:.3e} (tolerance {WEIGHT_TOL:g}), raw image max diff {img_rel:.3e} of "
          f"range (tolerance {WIDE_IMAGE_TOL:g}), refresh {timing.refresh_hz:.6f} vs "
          f"{cpu_timing.refresh_hz:.6f} Hz")
    check(cpu_timing.mode_name == timing.mode_name
          and abs(cpu_timing.refresh_hz - timing.refresh_hz) < 1e-3
          and cpu_comb.polarity.tolist() == comb.polarity.tolist(),
          "card and CPU agree on mode, refresh and polarity")
    check(w_err < WEIGHT_TOL, "card weights match the CPU run")
    check(img_rel < WIDE_IMAGE_TOL, "card image matches the CPU run")

    given_ms = wall_ms(torch, lambda: tp.combined_reconstruct(
        words, fs, comb.centers_hz, chan_bw=CHAN_BW, alpha=WIDE_ALPHA))
    disc_ms = wall_ms(torch, lambda: tp.combined_reconstruct(
        words, fs, None, chan_bw=CHAN_BW, alpha=WIDE_ALPHA, min_margin_db=WIDE_MARGIN_DB))
    host_ms = wall_ms(torch, lambda: tp.combined_reconstruct(
        cap.iq, fs, None, chan_bw=CHAN_BW, alpha=WIDE_ALPHA, min_margin_db=WIDE_MARGIN_DB,
        device=dev))
    print(f"[combined_reconstruct] {given_ms:.2f} ms with the carriers given, {disc_ms:.2f} ms "
          f"with discovery (words on the card), {host_ms:.2f} ms with discovery from host "
          f"complex samples ({1e3 * WIDE_SECONDS:.0f} ms of capture); wall clock, median of 3, "
          f"on {card}")

    # K1's envelope entry at this path's shapes, against its plain version.
    spf_c = fs_chan / timing.mode.refresh
    n_frames = recon.frames.shape[0]
    env = torch.from_numpy(comb.envelope).to(dev)
    starts = torch.from_numpy(np.round(np.arange(n_frames) * spf_c).astype(np.int32)).to(dev)
    hold_envelope_entry(tp, torch, env, starts, None,
                        (int(np.floor(spf_c)), mode.height, mode.width, RENDER),
                        "offline combine")
    return {"offline": launches}, cap


def run_combine_runtime(tp, blocks, mode, device, centers, **options):
    """Three wideband blocks through ``StreamingRuntime(combine=centers)``;
    returns (final EMA, the runtime, seconds)."""
    rt = tp.StreamingRuntime(BlockSource(blocks, SAMPLE_RATE), mode, alpha=LIVE_ALPHA,
                             ring_depth=4, combine=centers, combine_bw=CHAN_BW, device=device,
                             **options)
    rt.start()
    try:
        t0 = time.perf_counter()
        ema = rt.process_blocks(len(blocks))
        seconds = time.perf_counter() - t0
    finally:
        rt.stop()
    check(rt.ring.overflows == 0 and rt.ring.last_seq == len(blocks) - 1,
          "the combine runtime took every block in order")
    return ema, rt, seconds


def phase_live_wideband(tp, torch, dev, card: str, seen, profile_activities) -> dict:
    """Phase 10: live multi-harmonic combining at the main path's size.
    Returns the launch counts of K1's envelope entry, default and fidelity."""
    import tempfile

    from torch.profiler import profile

    from tempest_tpu_torch.pipeline import offline as poff

    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    block = slice_config(tp).block_samples
    t0 = time.perf_counter()
    cap = tp.generate_iq_harmonics(mode, SAMPLE_RATE, N_BLOCKS * block, LIVE_CARRIERS,
                                   amplitudes=[1.0, 1.0], snr_db=LIVE_SNR_DB, seed=SEED)
    blocks = cap.iq.reshape(N_BLOCKS, block)
    truth = tp.downgrade_image(torch.from_numpy(cap.frame), RENDER).numpy()
    print(f"[live combine] {N_BLOCKS} blocks of {block} samples of {MODE_NAME} at "
          f"{SAMPLE_RATE / 1e6:g} Msps, carriers {[c / 1e6 for c in LIVE_CARRIERS]} MHz at "
          f"{LIVE_SNR_DB:g} dB SNR, in {time.perf_counter() - t0:.1f} s")
    launches = {}
    emas = {}
    for chain, options, variant in (("default", {}, (2, False)),
                                    ("fidelity", {"fidelity": True}, (2, True))):
        seen.clear()
        ema, rt, seconds = run_combine_runtime(tp, blocks, mode, dev, LIVE_CARRIERS, **options)
        n_fft, m_chan, fs_chan = rt._combine_geometry
        launches[chain] = seen["k1", *variant]
        check((n_fft, m_chan, fs_chan) == (1 << 23, 1 << 21, 5e6)
              and rt.config.input_format == "envelope",
              "the live combine geometry: N = 2^23, M = 2^21, 5 Msps at the channel")
        check(launches[chain] == N_BLOCKS and k1_launches(seen, "envelope") == N_BLOCKS
              and k1_launches(seen, "words") == 0,
              f"K1's envelope entry launched once a block, {chain} chain "
              f"({dict(seen)})")
        weights = rt.health()["combine"]["weights"]
        single, _, _ = run_combine_runtime(tp, blocks, mode, dev, LIVE_CARRIERS[:1], **options)
        p2, _ = tp.aligned_psnr(truth, ema)
        p1, _ = tp.aligned_psnr(truth, single)
        print(f"[live combine, {chain}] {rt.config.n_frames} frames a block at "
              f"{fs_chan / 1e6:g} Msps, {1e3 * seconds / N_BLOCKS:.2f} ms per block incl. ring "
              f"copy and upload of {8 * n_fft / 1e6:.1f} MB; weights {weights}; aligned PSNR "
              f"fused {p2:.3f} dB, one carrier {p1:.3f} dB; K1 envelope launches "
              f"{launches[chain]}")
        check(ema.shape == RENDER and bool(np.isfinite(ema).all()),
              f"fused EMA finite, of the screen's shape ({chain})")
        check(min(weights) > 0.3, f"both carriers weighted above 0.3 ({chain})")
        check(p2 > p1, f"the fused EMA beats the single-carrier run ({chain})")
        emas[chain] = ema

    # A checkpoint saved after two blocks and resumed in a runtime that was
    # told nothing of the carriers gives the uninterrupted run's EMA.
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "combine.npz")
        first = tp.StreamingRuntime(BlockSource(blocks, SAMPLE_RATE), mode, alpha=LIVE_ALPHA,
                                    ring_depth=4, combine=LIVE_CARRIERS, combine_bw=CHAN_BW)
        for b in blocks[:2]:
            first.ring.put(b)
        first.process_blocks(2)
        first.save_checkpoint(path)
        resumed = tp.StreamingRuntime(BlockSource(blocks, SAMPLE_RATE), mode, ring_depth=4)
        resumed.load_checkpoint(path)
    check(resumed._combine_centers == LIVE_CARRIERS and resumed.abs_pos == 2 * block
          and resumed.config.input_format == "envelope",
          "the checkpoint carries the carriers and the position")
    resumed.ring.put(blocks[2])
    ema_resumed = resumed.process_blocks(1)
    span = float(emas["default"].max() - emas["default"].min())
    resume_rel = float(np.abs(ema_resumed - emas["default"]).max()) / span
    print(f"[live combine] checkpoint after 2 blocks, resumed for the third: EMA max diff "
          f"{resume_rel:.3e} of range against the uninterrupted run (tolerance "
          f"{RESUME_REL_TOL:g})")
    check(resume_rel < RESUME_REL_TOL, "the resumed run gives the uninterrupted run's EMA")

    # Times of one combine block on device-resident words, and what runs.
    rt = resumed
    iq = torch.from_numpy(blocks[0][: rt._upload_samples].view(np.float32)).to(dev)
    env, _, _, _ = rt._combine_front(iq)
    phase = 1234.56 * rt._phase_scale
    front_ms = time_call(torch, lambda: rt._combine_front(iq), calls=10)
    step_ms = time_call(torch, lambda: rt._step(env, rt.ema, LIVE_ALPHA, phase), calls=10)
    fid = tp.StreamingRuntime(BlockSource(blocks, SAMPLE_RATE), mode, alpha=LIVE_ALPHA,
                              combine=LIVE_CARRIERS, combine_bw=CHAN_BW, fidelity=True)
    fid_step_ms = time_call(torch, lambda: fid._step(env, fid.ema, LIVE_ALPHA, phase), calls=10)
    with profile(activities=profile_activities) as prof:
        e, _, _, _ = rt._combine_front(iq)
        rt._step(e, rt.ema, LIVE_ALPHA, phase)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    kernels = sum(evt.count for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA)
    print(f"[live combine] per block on device-resident words: combine front {front_ms:.3f} ms, "
          f"fused step {step_ms:.3f} ms (fidelity step {fid_step_ms:.3f} ms), CUDA events, "
          f"median of 10; one block (front + default step): device time {device_ms(prof):.3f} "
          f"ms in {kernels} kernels (profiler), on {card}")

    # K1's envelope entry at this path's shapes, against its plain version.
    spf_c = rt.config.samples_per_frame
    raster = (int(np.floor(spf_c)), mode.height, mode.width, RENDER)
    rounded = torch.from_numpy(poff.carry_phase_starts(phase, spf_c, rt.config.n_frames)).to(dev)
    hold_envelope_entry(tp, torch, env, rounded, None, raster, "live combine")
    ex_starts, ex_fracs = poff.exact_cut_starts(phase, spf_c, rt.config.n_frames)
    hold_envelope_entry(tp, torch, env, torch.from_numpy(ex_starts).to(dev),
                        torch.from_numpy(ex_fracs).to(dev), raster, "live combine, residuals")
    return launches


def phase_tasks(tp, torch, dev, card: str, main_blocks, main_mode) -> None:
    """Phase 11: the runtime's tasks on the card."""
    import tempfile

    small = tp.ALL_VIDEO_MODES[SMALL_MODE_NAME]
    # scan: three dwell frequencies on a tunable source, one with an emission.
    emission = tp.generate_iq(small, SCAN_RATE, int(SCAN_RATE * 0.5), snr_db=25.0, seed=5).iq
    src = TunableSource(emission, int(SCAN_RATE * 0.1))
    rt = tp.StreamingRuntime(src, small, alpha=0.5)
    freqs = [1e6, SCAN_EMISSION_HZ, 5e6]
    rt.start()
    try:
        t0 = time.perf_counter()
        results = rt.scan(freqs, dwell_seconds=0.1)
        scan_s = time.perf_counter() - t0
    finally:
        rt.stop()
    by_f = {f: (p, fl, fv) for f, p, fl, fv in results}
    p_emit, floor, fv = by_f[SCAN_EMISSION_HZ]
    print(f"[tasks] scan over {[f / 1e6 for f in freqs]} MHz in {scan_s:.2f} s: prominence "
          f"{[round(by_f[f][0], 2) for f in freqs]} dB over a floor of {floor:.2f} dB, refresh "
          f"{fv:.4f} Hz, left tuned at {src.carrier_freq / 1e6:g} MHz")
    check([r[0] for r in results] == freqs and src.carrier_freq == SCAN_EMISSION_HZ,
          "scan keeps the input order and retunes to the emission")
    check(p_emit >= floor + 5.0 and abs(fv - small.refresh) < 0.2
          and all(by_f[f][0] < floor + 5.0 for f in (1e6, 5e6)),
          "only the emission's dwell clears the calibrated floor")

    # Drift feedback: a refresh set 0.01 Hz off, pulled back from the syncs.
    wrong = tp.VideoMode(main_mode.width, main_mode.height, main_mode.refresh + DRIFT_OFFSET_HZ)
    rt = tp.StreamingRuntime(BlockSource(main_blocks, SAMPLE_RATE), wrong,
                             n_frames_per_block=N_FRAMES, alpha=ALPHA, ring_depth=4)
    syncs = []
    rt.start()
    try:
        rt.process_blocks(len(main_blocks), sink=lambda img, info: syncs.append(info["sync"]))
    finally:
        rt.stop()
    refined = rt.refine_refresh_from_drift(np.concatenate(syncs))
    print(f"[tasks] refine_refresh_from_drift: {wrong.refresh:.4f} Hz -> {refined:.6f} Hz "
          f"(the capture's {main_mode.refresh:g}; tolerance {DRIFT_TOL_HZ:g} Hz)")
    check(abs(refined - main_mode.refresh) < DRIFT_TOL_HZ and rt.mode.refresh == refined,
          "drift feedback pulls the refresh back")

    # record, then the native ring against the Python ring.
    small_block = int(SCAN_RATE * 0.1)
    stream = emission[: 4 * small_block].reshape(4, small_block)
    with tempfile.TemporaryDirectory() as tmp:
        rt = tp.StreamingRuntime(BlockSource(stream, SCAN_RATE), small)
        for b in stream[:3]:
            rt.ring.put(b)
        path = str(Path(tmp) / "dump.dat")
        wrote = rt.record(path, n_blocks=3)
        back = tp.read_complex_binary(path)
    print(f"[tasks] record wrote {wrote} samples")
    check(wrote == 3 * small_block and np.array_equal(back, stream[:3].ravel())
          and rt.abs_pos == 3 * small_block, "record wrote what the ring delivered")
    emas = {}
    for impl in ("python", "native"):
        rt = tp.StreamingRuntime(BlockSource(stream, SCAN_RATE), small, alpha=0.5, ring_impl=impl)
        for b in stream:
            rt.ring.put(b)
        emas[impl] = rt.process_blocks(4)
        check(rt.ring.last_seq == 3 and rt.frames_out == 4 * rt.config.n_frames,
              f"the {impl} ring delivered four blocks")
    diff = float(np.abs(emas["native"] - emas["python"]).max())
    print(f"[tasks] native ring vs Python ring: EMA max abs diff {diff:.3e}")
    check(diff == 0.0 and bool(np.isfinite(emas["native"]).all()) and emas["native"].std() > 0,
          "the native ring delivers the Python ring's EMA")


def kernel_count(prof) -> int:
    """Kernels launched during a torch.profiler run."""
    from torch.autograd import DeviceType

    return sum(evt.count for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA)


def profiled(torch, fn, activities, tries: int = 3):
    """A torch.profiler run of ``fn()``, fenced.  A run that records no
    kernel at all (the profiler has dropped a whole run's device events
    when two runs followed each other closely) is made again, up to
    ``tries`` times."""
    from torch.profiler import profile

    for _ in range(tries):
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
        if kernel_count(prof):
            break
    return prof


def read_png(path) -> np.ndarray:
    """Decode an 8-bit grayscale PNG as ``render/screen.py`` writes it."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is a PNG")
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    pos, idat = 8, b""
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos: pos + 4]), data[pos + 4: pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8: pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    check((depth, colour) == (8, 0) and not raw[:, 0].any(), f"{path}: 8-bit gray, filter 0")
    return raw[:, 1:]


def phase_batched(tp, torch, dev, card: str, words: np.ndarray, seen,
                  profile_activities, parent_root=None) -> dict:
    """Phase 12: batched serving at full width.  ``words`` is the capture's
    int16 words; stream b is the block that starts 2/3 of a block after
    stream b-1's.  Returns what the kernels line reports of K1 at 144 frames,
    under AM (static and exact cuts), FM and ``invert``."""
    from tempest_tpu_torch.ops.resample_kernel import (
        frames_to_screens_plain, screen_geometry, words_envelope_plain)
    from tempest_tpu_torch.ops.sync_kernel import blanking_sync
    from tempest_tpu_torch.pipeline import offline as poff

    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    base = dict(sample_rate=SAMPLE_RATE, mode=mode, n_frames=N_FRAMES,
                input_format="iq_interleaved", align_subpixel=True)
    chains = {
        "static cuts": tp.ReconstructionConfig(**base),
        "carry_phase, exact cuts": tp.ReconstructionConfig(
            carry_phase=True, subsample_align=True, **base),
    }
    h, w = RENDER
    out = {}
    for label, cfg in chains.items():
        n = cfg.block_samples
        spf = cfg.samples_per_frame
        frame_len = int(np.floor(spf))
        raster = (frame_len, mode.height, mode.width, RENDER)
        stride = 2 * slice_config(tp).block_samples // 3    # samples between streams' starts
        host = np.stack([words[2 * b * stride: 2 * b * stride + 2 * n] for b in range(N_STREAMS)])
        check(host.shape == (N_STREAMS, 2 * n), "four streams cut from the capture")
        iq_b = torch.from_numpy(host).to(dev)
        ema_b = torch.zeros((N_STREAMS, h, w), dtype=torch.float32, device=dev)
        phases = (STREAM_PHASES,) if cfg.carry_phase else ()
        step = tp.make_batched_reconstruct_fn(cfg)
        single = tp.make_reconstruct_fn(cfg)
        # The screens before sync and alignment: the same steps with do_align off.
        raw_cfg = dataclasses.replace(cfg, do_align=False)
        raw_ema, raw_frames, _, _ = tp.make_batched_reconstruct_fn(raw_cfg)(
            iq_b, ema_b, ALPHA, *phases)
        raw_single = tp.make_reconstruct_fn(raw_cfg)
        for b in range(N_STREAMS):
            ph = (STREAM_PHASES[b],) if cfg.carry_phase else ()
            e1, f1, _, _ = raw_single(iq_b[b], ema_b[b], ALPHA, *ph)
            check(bool(torch.equal(raw_frames[b], f1)) and bool(torch.equal(raw_ema[b], e1)),
                  f"batched step, {label}: stream {b}'s screens and their EMA (K3's fold alone) "
                  "equal the single-stream step's to the bit")
        # K2 on the 144 screens and on each stream's 36: the same bits.
        screens = raw_frames.reshape(-1, h, w)
        whole = blanking_sync(screens, subpixel=True)
        for b in range(N_STREAMS):
            part = blanking_sync(raw_frames[b], subpixel=True)
            check(all(bool(torch.equal(x[b * N_FRAMES:(b + 1) * N_FRAMES], y))
                      for x, y in zip(whole, part)),
                  f"batched step, {label}: K2 gives stream {b}'s frames the same bits in a batch "
                  f"of {N_FRAMES} and of {N_STREAMS * N_FRAMES}")
        del raw_frames, raw_ema, screens, whole
        step(iq_b, ema_b, ALPHA, *phases)          # warm: allocator, FFT plans
        seen.clear()
        ema_out, frames, sync, score = step(iq_b, ema_b, ALPHA, *phases)
        torch.cuda.synchronize()
        variant = (2, cfg.subsample_align, "am", False)
        launches = seen["k1", *variant]
        check(launches == 1 and k1_launches(seen, "words") == 1
              and k1_launches(seen, "envelope") == 0,
              f"batched step, {label}: exactly one K1 launch for {N_STREAMS * N_FRAMES} frames "
              f"({dict(seen)})")
        check(frames.shape == (N_STREAMS, N_FRAMES, h, w) and sync.shape == (N_STREAMS, N_FRAMES, 2)
              and score.shape == (N_STREAMS, N_FRAMES) and ema_out.shape == (N_STREAMS, h, w)
              and bool(torch.isfinite(ema_out).all()) and frames.device.type == "cuda",
              f"batched step, {label}: outputs finite, of the stated shapes, on the card")
        sync_err = ema_rel = frames_rel = 0.0
        singles = []
        unpinned_equal = True
        for b in range(N_STREAMS):
            ph = (STREAM_PHASES[b],) if cfg.carry_phase else ()
            e1, f1, s1, c1 = single(iq_b[b], ema_b[b], ALPHA, *ph)
            singles.append((e1, f1, s1, c1))
            unpinned_equal = unpinned_equal and all(
                bool(torch.equal(x, y)) for x, y in
                ((ema_out[b], e1), (frames[b], f1), (sync[b], s1), (score[b], c1)))
            sync_err = max(sync_err, float((sync[b] - s1).abs().max()))
            frames_rel = max(frames_rel, float((frames[b] - f1).abs().max() / f1.abs().max()))
            ema_rel = max(ema_rel, float((ema_out[b] - e1).abs().max() / (e1.max() - e1.min())))
        # The batched alignment and EMA alone: the same step with the single
        # streams' sync values in place of its own, so that the summation
        # order of the sync's profiles plays no part.
        pinned = (torch.cat([s[2][:, 0] for s in singles]), torch.cat([s[2][:, 1] for s in singles]),
                  torch.cat([s[3] for s in singles]))
        pinned = (*pinned, torch.stack(pinned[:2], dim=1))
        real_sync = poff.blanking_sync
        poff.blanking_sync = lambda screens, subpixel, pairs: pinned
        try:
            with through_wrappers(poff):
                ema_p, frames_p, sync_p, _ = step(iq_b, ema_b, ALPHA, *phases)
        finally:
            poff.blanking_sync = real_sync
        pinned_equal = True
        for b, (e1, f1, s1, _) in enumerate(singles):
            check(bool(torch.equal(sync_p[b], s1)), "the pinned sync values reached the step")
            pinned_equal = (pinned_equal and bool(torch.equal(frames_p[b], f1))
                            and bool(torch.equal(ema_p[b], e1)))
        del singles, frames_p, ema_p
        print(f"[batched, {label}] {N_STREAMS} streams of {n} samples as int16 words "
              f"({host.nbytes / 1e6:.1f} MB in, {frames.numel() * 4 / 1e6:.1f} MB of frames out): "
              f"1 K1 launch a step; each stream's screens and their EMA equal the single-stream "
              f"step's to the bit; after sync, alignment and the fold, sync NOT pinned: EMA, "
              f"frames, sync and score equal to the bit: {unpinned_equal} (sync max diff "
              f"{sync_err:.3e} px, aligned frames {frames_rel:.3e} of the largest pixel, EMA "
              f"{ema_rel:.3e} of range); with the single streams' sync values pinned: equal to the "
              f"bit: {pinned_equal}")
        check(unpinned_equal, f"batched step, {label}: EMA, frames, sync and score equal the "
                              "single streams' to the bit, sync not pinned")
        check(pinned_equal,
              f"batched step, {label}: alignment and EMA at the single streams' sync values match")

        # K1 alone on the 144 frames, as the step calls it, against its plain version.
        m = batched_k1(tp, torch, dev, card, cfg, iq_b, raster, label)

        batched_ms = time_call(torch, lambda: step(iq_b, ema_b, ALPHA, *phases), calls=10)

        def four_singles():
            for b in range(N_STREAMS):
                ph = (STREAM_PHASES[b],) if cfg.carry_phase else ()
                single(iq_b[b], ema_b[b], ALPHA, *ph)

        singles_ms = time_call(torch, four_singles, calls=10)
        prof = profiled(torch, lambda: [step(iq_b, ema_b, ALPHA, *phases) for _ in range(3)],
                        profile_activities)
        prof1 = profiled(torch, lambda: [four_singles() for _ in range(3)], profile_activities)
        by_kernel = device_by_kernel(prof, 3)
        dev_b, launches_b = step_device_ms(by_kernel)
        dev_1, launches_1 = step_device_ms(device_by_kernel(prof1, 3))
        print(f"[batched, {label}] {batched_ms:.3f} ms a batched step beside {singles_ms:.3f} ms "
              f"for four single-stream steps (CUDA events, median of 10) = "
              f"{N_STREAMS * n / batched_ms / 1e3:.1f} Msamples/s; device time "
              f"{dev_b:.3f} ms in {launches_b} kernels beside {dev_1:.3f} ms in {launches_1} "
              f"(profiler); by kernel: {step_kernels(by_kernel)}, on {card}")
        check(launches_b == 5 and all(any(e in k for e in STEP_EVENTS) for k in by_kernel),
              f"batched step, {label}: 5 device events, K1, K2a, K2b, K3 and the upload, no "
              f"demod or layout copy ({sorted(by_kernel)})")
        out[label] = dict(m, launches=launches, device_ms=dev_b, events=launches_b)
        del iq_b, frames

    # The routes that demodulated as a pass before: FM, and invert (AM), whose
    # block maximum is one launch for the four streams; static cuts.
    parent = load_other(Path(parent_root)) if parent_root is not None else None
    for label, extra in (("FM", {"demod": "fm"}), ("invert", {"invert": True})):
        cfg = tp.ReconstructionConfig(**base, **extra)
        n = cfg.block_samples
        frame_len = int(np.floor(cfg.samples_per_frame))
        raster = (frame_len, mode.height, mode.width, RENDER)
        stride = 2 * n // 3
        host = np.stack([words[2 * b * stride: 2 * b * stride + 2 * n] for b in range(N_STREAMS)])
        iq_b = torch.from_numpy(host).to(dev)
        ema_b = torch.zeros((N_STREAMS, h, w), dtype=torch.float32, device=dev)
        step = tp.make_batched_reconstruct_fn(cfg)
        single = tp.make_reconstruct_fn(cfg)
        step(iq_b, ema_b, ALPHA)                   # warm
        seen.clear()
        got = step(iq_b, ema_b, ALPHA)
        torch.cuda.synchronize()
        key = (2, False, cfg.demod, False) + (("invert",) if cfg.invert else ())
        launches = seen["k1", *key]
        maxima = seen["words_max"]
        check(launches == 1 == k1_launches(seen, "words")
              and k1_launches(seen, "envelope") == 0 and maxima == (1 if cfg.invert else 0),
              f"batched step, {label}: one K1 words launch for {N_STREAMS * N_FRAMES} frames "
              f"and {maxima} block maximum ({dict(seen)}"
              f", envelope {k1_launches(seen, 'envelope')})")
        for b in range(N_STREAMS):
            one = single(iq_b[b], ema_b[b], ALPHA)
            check(all(bool(torch.equal(x[b], y)) for x, y in zip(got, one)),
                  f"batched step, {label}: stream {b}'s EMA, frames, sync and score equal its "
                  "single step's to the bit")
        del got, one
        m = batched_k1(tp, torch, dev, card, cfg, iq_b, raster, label)
        prof = profiled(torch, lambda: [step(iq_b, ema_b, ALPHA) for _ in range(3)],
                        profile_activities)
        by_kernel = device_by_kernel(prof, 3)
        dev_b, events = step_device_ms(by_kernel)
        allowed = STEP_EVENTS + (("words_max_kernel",) if cfg.invert else ())
        check(events == 5 + cfg.invert and all(any(e in k for e in allowed) for k in by_kernel),
              f"batched step, {label}: {5 + cfg.invert} device events (K1, K2a, K2b, K3, the "
              f"upload{', the block maximum' if cfg.invert else ''}), no demod pass or layout "
              f"copy ({sorted(by_kernel)})")
        routes = {"this": step}
        if parent is not None:
            pcfg = parent.ReconstructionConfig(
                sample_rate=SAMPLE_RATE, mode=parent.ALL_VIDEO_MODES[MODE_NAME], n_frames=N_FRAMES,
                input_format="iq_interleaved", align_subpixel=True, **extra)
            routes["parent"] = parent.make_batched_reconstruct_fn(pcfg)
            a, b_ = step(iq_b, ema_b, ALPHA), routes["parent"](iq_b, ema_b, ALPHA)
            torch.cuda.synchronize()
            check(all(bool(torch.equal(x, y)) for x, y in zip(a, b_)),
                  f"batched step, {label}: the parent's step (its demod passes) gives these bits")
            del a, b_
        turns = {who: {"ms": [], "device": [], "events": []} for who in routes}
        for who in (("parent", "this", "this", "parent") if parent is not None else ("this",)):
            fn = routes[who]
            turns[who]["ms"].append(time_call(torch, lambda: fn(iq_b, ema_b, ALPHA), calls=10))
            bk = device_by_kernel(profiled(torch, lambda: [fn(iq_b, ema_b, ALPHA)
                                                           for _ in range(3)],
                                           profile_activities), 3)
            d, e = step_device_ms(bk)
            turns[who]["device"].append(d)
            turns[who]["events"].append(e)
        for who, t in turns.items():
            print(f"[batched, {label}, {who}] {' '.join(f'{x:.3f}' for x in t['ms'])} ms a step "
                  f"(CUDA events, median of 10), device {' '.join(f'{x:.4f}' for x in t['device'])}"
                  f" ms in {' '.join(str(x) for x in t['events'])} events, turns parent this this "
                  f"parent, on {card}")
        print(f"[batched, {label}] one K1 words launch and {maxima} block maximum a step, each "
              f"stream equal to its single step to the bit; device time {dev_b:.4f} ms in "
              f"{events} events; by kernel: {step_kernels(by_kernel)}, on {card}")
        out[label] = dict(m, launches=launches, max_launches=maxima, device_ms=dev_b,
                          events=events, turns=turns)
        del iq_b
    return out


def step_kernels(by_kernel: dict) -> str:
    return "; ".join(f"{short_name(k)} {ms:.4f} x{n}" for k, (ms, n) in by_kernel.items())


def batched_k1(tp, torch, dev, card: str, cfg, iq_b, raster, label: str) -> dict:
    """K1 alone on the batched step's B·F frames as the step launches it (the
    caller's words, ``streams=B``, the config's load), against its plain
    version to the bit; its times beside its bound."""
    from tempest_tpu_torch.ops import resample_kernel as rk
    from tempest_tpu_torch.pipeline import offline as poff

    n_streams, n = iq_b.shape[0], iq_b.shape[1] // 2
    cuts = [poff._cut_fn(cfg)(*([p] if cfg.carry_phase else [])) for p in STREAM_PHASES]
    starts = torch.from_numpy(np.concatenate(
        [c[0].astype(np.int64) + b * n for b, c in enumerate(cuts)]).astype(np.int32)).to(dev)
    fracs = None
    if cfg.subsample_align:
        fracs = torch.from_numpy(np.concatenate([c[1] for c in cuts])).to(dev)
    flat = iq_b.reshape(-1)
    load = dict(demod=cfg.demod, invert=cfg.invert, streams=n_streams)

    def call():
        return rk.frames_to_screens_from_words(flat, starts, *raster, fracs, 2, **load)

    def plain():
        env = rk.words_envelope_plain(flat, cfg.demod, False, cfg.invert, n_streams)
        return rk.frames_to_screens_plain(env, starts, rk.screen_geometry(*raster, dev), fracs, 2,
                                          n_streams)

    got, ref = call(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(bool(torch.equal(got, ref)),
          f"K1 on {n_streams * N_FRAMES} frames, {label}, equals its plain version to the bit "
          f"(max abs diff {err:.3e})")
    del got, ref
    word = rk.word_code(iq_b.dtype, cfg.demod, False, cfg.invert)[0]
    bound_ms, bound_by, nbytes = k1_bound(n_streams * n, 4, n_streams * N_FRAMES, raster, word,
                                          2, cfg.subsample_align)
    m = dict(err=err, ms=time_call(torch, call), b2b_ms=time_back_to_back(torch, call),
             device_ms=kernels_device_ms(torch, call, ("tiles_kernel",))["tiles_kernel"],
             plain_ms=time_call(torch, plain, calls=3), bound_ms=bound_ms, bound_by=bound_by)
    print(f"[K1 int16 words, {n_streams * N_FRAMES} frames, {label}] {n_streams} streams as they "
          f"lie, each clamped into its own block: equal to plain to the bit; {m['ms']:.4f} ms "
          f"single call, {m['b2b_ms']:.4f} ms back to back{' (with its block maximum)' * cfg.invert},"
          f" K1's device time {m['device_ms']:.4f} ms; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} "
          f"MB, by {bound_by}), share reached {bound_ms / m['device_ms']:.3f} of device time; plain "
          f"{m['plain_ms']:.4f} ms, on {card}")
    return m


def phase_search(tp, torch, dev, card: str, words_f32, seen) -> dict:
    """Phase 13: the static mode search on the slice's capture.  Returns the
    candidate launch's numbers."""
    from tempest_tpu_torch.ops.resample import round_to_bfloat16
    from tempest_tpu_torch.ops.resample_kernel import (
        ROWS_PER_TILE, candidate_table, candidates_launch_cost, frames_to_screens,
        frames_to_screens_candidates, frames_to_screens_candidates_plain,
        frames_to_screens_from_words, frames_to_screens_plain, screen_geometry, tile_plan)
    from tempest_tpu_torch.utils.roofline import H100_PEAKS

    cands = tp.candidate_modes(60.0, tol_hz=SEARCH_TOL_HZ)
    spf = SAMPLE_RATE / 60.0
    frame_len = int(np.floor(spf))
    need = int(np.round((SEARCH_FRAMES - 1) * spf)) + frame_len + 1
    z = torch.view_as_complex(words_f32[: 2 * need].reshape(-1, 2))
    tp.mode_search_static(z, SAMPLE_RATE, 60.0, cands)          # warm
    seen.clear()
    res = tp.mode_search_static(z, SAMPLE_RATE, 60.0, cands)
    launches = k1_launches(seen, "candidates")
    check(launches == 1 and k1_launches(seen, "envelope") == 0
          and k1_launches(seen, "words") == 0,
          f"the search launched K1 once over its {len(cands)} candidates ({launches} candidate "
          f"launches, {k1_launches(seen, 'envelope')} single)")
    order = np.argsort(res.scores)[::-1]
    print(f"[search] {len(cands)} candidate modes within {SEARCH_TOL_HZ} Hz of 60 Hz, "
          f"{SEARCH_FRAMES} frames at {SEARCH_SCORE_SIZE[0]}x{SEARCH_SCORE_SIZE[1]}, "
          f"{SEARCH_PHASES} phases: winner {res.names[res.best_index]} "
          f"(score {res.scores[res.best_index]:.5g}), then "
          f"{[(res.names[i], round(float(res.scores[i]), 1)) for i in order[1:3]]}; K1 launches "
          f"{launches}")
    check(res.names[res.best_index] == MODE_NAME and bool(np.isfinite(res.scores).all()),
          "the search names the capture's mode")
    cpu = tp.mode_search_static(z.cpu(), SAMPLE_RATE, 60.0, cands, device="cpu")
    score_rel = float(np.abs(res.scores - cpu.scores).max() / np.abs(cpu.scores).max())
    print(f"[search] card vs CPU: scores max diff {score_rel:.3e} of the largest "
          f"(tolerance {EMA_REL_TOL:g}), same winner: {cpu.best_index == res.best_index}")
    check(cpu.best_index == res.best_index and score_rel < EMA_REL_TOL,
          "card and CPU searches agree")

    # K1 over the candidate set against its plain version, on the search's
    # envelope, and beside the route it replaced: one launch per candidate
    # and a torch.cat of their screens.
    env = round_to_bfloat16(z.abs().to(torch.float32)).contiguous()
    starts = torch.from_numpy(
        np.round(np.arange(SEARCH_FRAMES) * spf).astype(np.int32)).to(dev)
    rasters = [(m.height, m.width) for _, m in cands]
    table = candidate_table(frame_len, tuple(rasters), SEARCH_SCORE_SIZE, dev, SEARCH_PHASES)

    def one_launch():
        return frames_to_screens_candidates(env, starts, frame_len, rasters, SEARCH_SCORE_SIZE,
                                            SEARCH_PHASES)

    def per_candidate():
        return torch.cat([frames_to_screens(env, starts, frame_len, y, x, SEARCH_SCORE_SIZE,
                                            None, 2, SEARCH_PHASES) for y, x in rasters])

    got = one_launch()
    ref = frames_to_screens_candidates_plain(env, starts, table)
    old = per_candidate()
    torch.cuda.synchronize()
    cand_err = float((got - ref).abs().max())
    check(bool(torch.equal(got, ref)) and bool(torch.equal(got.reshape(old.shape), old)),
          f"K1 over the {len(cands)} candidates equals its plain version and the launches per "
          f"candidate to the bit ({cand_err:.3e})")
    caps = [tile_plan(frame_len, y, x, SEARCH_SCORE_SIZE, 4)[1] for y, x in rasters]
    nbytes, flops = candidates_launch_cost(need, SEARCH_FRAMES, table)
    by_bytes = 1e3 * nbytes / H100_PEAKS["bytes_per_s"]
    by_ops = 1e3 * flops / H100_PEAKS["flops_per_s"]
    cand = dict(err=cand_err, ms=time_call(torch, one_launch),
                b2b_ms=time_back_to_back(torch, one_launch),
                plain_ms=time_call(torch, lambda: frames_to_screens_candidates_plain(
                    env, starts, table), calls=10),
                bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops
                else "operations", launches=launches)
    cand["device_ms"] = kernels_device_ms(torch, one_launch,
                                          ("resample_tiles_kernel",))["resample_tiles_kernel"]
    old_ms = time_call(torch, per_candidate)
    old_b2b = time_back_to_back(torch, per_candidate, launches=10)
    old_dev = kernels_device_ms(torch, per_candidate, ("resample_tiles_kernel",))[
        "resample_tiles_kernel"] * len(rasters)
    check(cand["device_ms"] > 0 and old_dev > 0, "the profiler traced K1's kernel")
    print(f"[K1 candidates, {SEARCH_SCORE_SIZE[0]}x{SEARCH_SCORE_SIZE[1]}] {len(rasters)} "
          f"candidates x {SEARCH_FRAMES} frames in one launch ({table.tiles_per_frame} tiles a "
          f"frame, stage buffers of {min(caps)}-{max(caps)} samples, {table.run_cap} staged): "
          f"equal to plain and to one launch per candidate to the bit; {cand['ms']:.4f} ms "
          f"single call, {cand['b2b_ms']:.4f} ms back to back, {cand['device_ms']:.4f} ms of "
          f"device time; bound {cand['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB, by "
          f"{cand['bound_by']}), share reached {cand['bound_ms'] / cand['device_ms']:.3f} of "
          f"device time; plain {cand['plain_ms']:.4f} ms; one launch per candidate and a "
          f"torch.cat: {old_ms:.4f} ms single call, {old_b2b:.4f} ms back to back, "
          f"{old_dev:.4f} ms of device time in {len(rasters)} launches, on {card}")
    cand.update(per_candidate_ms=old_ms, per_candidate_back_to_back_ms=old_b2b,
                per_candidate_device_ms=old_dev)

    # K1 at the score grid, one candidate a launch, against its plain version.
    timed = {}
    by_name = dict(cands)
    held = [MODE_NAME] + [n for n in (res.names[order[1]], res.names[order[-1]])
                          if n != MODE_NAME]
    for name in held:
        m = by_name[name]
        raster = (frame_len, m.height, m.width, SEARCH_SCORE_SIZE)
        geom = screen_geometry(*raster, dev, SEARCH_PHASES)
        got = frames_to_screens(env, starts, *raster, None, 2, SEARCH_PHASES)
        ref = frames_to_screens_plain(env, starts, geom, None, 2)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rows, run_cap = tile_plan(*raster, 4)
        check(bool(torch.equal(got, ref)),
              f"K1 at the score grid for {name} equals its plain version to the bit ({err:.3e})")
        bound_ms, bound_by, nbytes = k1_bound(need, 4, SEARCH_FRAMES, raster, False)
        ms = time_call(torch, lambda: frames_to_screens(env, starts, *raster, None, 2,
                                                        SEARCH_PHASES))
        b2b_ms = time_back_to_back(torch, lambda: frames_to_screens(
            env, starts, *raster, None, 2, SEARCH_PHASES))
        plain_ms = time_call(torch, lambda: frames_to_screens_plain(env, starts, geom, None, 2),
                             calls=10)
        dev_ms = kernels_device_ms(
            torch, lambda: frames_to_screens(env, starts, *raster, None, 2, SEARCH_PHASES),
            ("resample_tiles_kernel",))["resample_tiles_kernel"]
        check(dev_ms > 0, "the profiler traced K1's kernel")
        dev_ms = dev_ms or float("nan")
        print(f"[K1 envelope, {SEARCH_SCORE_SIZE[0]}x{SEARCH_SCORE_SIZE[1]}, {name}] "
              f"{m.width}x{m.height} raster, {rows} rows a tile ({run_cap} samples staged): equal "
              f"to plain to the bit; {ms:.4f} ms single call, {b2b_ms:.4f} ms back to back, "
              f"{dev_ms:.4f} ms of device time; bound {bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, by "
              f"{bound_by}), share reached {bound_ms / dev_ms:.3f} of device time; plain "
              f"{plain_ms:.4f} ms, on {card}")
        timed[name] = dict(err=err, ms=ms, b2b_ms=b2b_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, device_ms=dev_ms)
    # Score grids so coarse that the plan halves a tile's rows, on both entries.
    m = by_name[MODE_NAME]
    pairs = words_f32[: 2 * need].contiguous()
    pairs_env = tp.am_envelope_from_iq(pairs)
    for shape in COARSE_SCORE_SIZES:
        raster = (frame_len, m.height, m.width, shape)
        geom = screen_geometry(*raster, dev, SEARCH_PHASES)
        for label, kernel, data, plain_env, sample_bytes in (
                ("envelope", frames_to_screens, env, env, 4),
                ("float32 words", frames_to_screens_from_words, pairs, pairs_env, 8)):
            rows, run_cap = tile_plan(*raster, sample_bytes)
            check(rows < ROWS_PER_TILE[sample_bytes],
                  f"a {shape[0]}-row score grid halves the rows of a tile ({rows})")
            got = kernel(data, starts, *raster, None, 2, SEARCH_PHASES)
            ref = frames_to_screens_plain(plain_env, starts, geom, None, 2)
            torch.cuda.synchronize()
            check(bool(torch.equal(got, ref)),
                  f"K1 {label} at {shape}, {rows} rows a tile, equals its plain version to the "
                  f"bit ({float((got - ref).abs().max()):.3e})")
            ms = time_call(torch, lambda: kernel(data, starts, *raster, None, 2, SEARCH_PHASES))
            print(f"[K1 {label}, {shape[0]}x{shape[1]}, {MODE_NAME}] the plan halves a tile to "
                  f"{rows} rows of {ROWS_PER_TILE[sample_bytes]} ({run_cap} samples staged): equal "
                  f"to plain to the bit; {ms:.4f} ms single call, on {card}")
    whole_ms = wall_ms(torch, lambda: tp.mode_search_static(z, SAMPLE_RATE, 60.0, cands))
    print(f"[search] {whole_ms:.2f} ms whole, {whole_ms / len(cands):.3f} ms per candidate "
          f"(wall clock, median of 3, envelope and scoring included), on {card}")
    cand["search_ms"] = whole_ms

    seen.clear()
    auto_words = words_f32[: 2 * slice_config(tp).block_samples]
    timing, recon = tp.auto_reconstruct(auto_words, SAMPLE_RATE, alpha=ALPHA,
                                        refine_with_search=True, search_tol_hz=SEARCH_TOL_HZ)
    check(timing.mode_name == MODE_NAME and recon.image.shape == RENDER
          and bool(np.isfinite(recon.image).all()),
          "auto_reconstruct(refine_with_search=True) names the mode")
    n_cands = len(tp.candidate_modes(timing.refresh_hz, tol_hz=SEARCH_TOL_HZ))
    check(k1_launches(seen, "candidates") == 1 and k1_launches(seen, "envelope") == 0
          and k1_launches(seen, "words") == 1,
          f"refine_with_search: one K1 launch over the {n_cands} candidates "
          f"({k1_launches(seen, 'candidates')}, {k1_launches(seen, 'envelope')} single), one "
          f"for the reconstruction")
    refine_ms = wall_ms(torch, lambda: tp.auto_reconstruct(
        auto_words, SAMPLE_RATE, alpha=ALPHA, refine_with_search=True,
        search_tol_hz=SEARCH_TOL_HZ))
    print(f"[search] auto_reconstruct(refine_with_search=True): {timing.mode_name}, "
          f"{refine_ms:.2f} ms from float32 words on the card (wall clock, median of 3), on {card}")
    cand["refine_ms"] = refine_ms
    cand["single_candidate_ms"] = timed[MODE_NAME]["ms"]
    cand["single_candidate_device_ms"] = timed[MODE_NAME]["device_ms"]
    return cand


def phase_resamplers(tp, torch, dev, card: str, words_i16, truth, seen) -> dict:
    """Phase 14: every ``resampler=`` name on the 36-frame capture."""
    from tempest_tpu_torch.ops.resample_kernel import (
        frames_to_screens, frames_to_screens_plain, screen_geometry)
    from tempest_tpu_torch.pipeline import offline as poff

    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    base = tp.ReconstructionConfig(sample_rate=SAMPLE_RATE, mode=mode, n_frames=N_FRAMES,
                                   input_format="iq_interleaved", align_subpixel=True)
    n = base.block_samples
    block = words_i16[: 2 * n]
    env = tp.am_envelope_from_iq(block)
    grad = float((env[1:] - env[:-1]).abs().max())
    top = float(env.max())
    ema0 = torch.zeros(RENDER, dtype=torch.float32, device=dev)
    screens = {}
    out = {}
    for name in ("pallas", "aligned", "mxu", "mxu2", "mxu3", "mxu4", "mxu_batched", "gather",
                 "rows", "fft"):
        cfg = dataclasses.replace(base, resampler=name)
        raw = tp.make_reconstruct_fn(dataclasses.replace(cfg, do_align=False))
        step = tp.make_reconstruct_fn(cfg)
        seen.clear()
        screens[name] = raw(block, ema0, ALPHA)[1]
        k1 = k1_launches(seen, "envelope") + k1_launches(seen, "words")
        how = poff.RESAMPLERS[name]
        check(k1 == (1 if how.route == "k1" else 0),
              f"resampler={name}: {'one K1 launch a block' if how.route == 'k1' else 'no K1 launch'}")
        if how.bf16_envelope:
            check(load_launches(seen, "am", True) == 1
                  and k1_launches(seen, "envelope") == 0,
                  f"resampler={name}: K1's words load rounds to bfloat16, no demod or rounding "
                  f"pass ({dict(seen)})")
        rec = tp.reconstruct_frames(block, cfg, alpha=ALPHA)
        db, _ = tp.aligned_psnr(truth, rec.image)
        ms = time_call(torch, lambda: step(block, ema0, ALPHA), calls=5)
        diff = float((screens[name] - screens["pallas"])[:, :-2].abs().max())
        if how.route == "k1":
            bound = (grad / (2 * RESAMPLER_PHASES) if how.quantised else 0.0) \
                + (BF16_REL * top if how.bf16_envelope else 0.0)
            note = (f"bound {bound:.4g}: "
                    + (f"1/(2·{RESAMPLER_PHASES}) sample times the largest step {grad:.4g}"
                       if how.quantised else "K1 itself")
                    + (f" plus 2^-8 of the largest sample {top:.4g}" if how.bf16_envelope else ""))
            check(diff <= bound, f"resampler={name} within its bound of K1 ({diff} > {bound})")
        else:
            note = "another interpolation of the same screens, no bound"
        print(f"[resamplers] {name:12s} aligned PSNR {db:.3f} dB; largest difference from pallas "
              f"{diff:.4g} ({note}); {ms:.3f} ms a {N_FRAMES}-frame block (CUDA events, median "
              f"of 5); K1 launches a block {k1_launches}, on {card}")
        check(bool(np.isfinite(rec.image).all()) and rec.image.shape == RENDER,
              f"resampler={name}: image finite, of the screen's shape")
        out[name] = dict(psnr=db, launches=k1_launches)
    check(abs(out["aligned"]["psnr"] - out["pallas"]["psnr"]) < 1e-9, "aligned is K1")
    for name in out:
        # One 36-frame block from an empty EMA, where the bar is the streaming
        # chain's after three; the band-limited read is another interpolation.
        check(name == "fft" or out[name]["psnr"] > PSNR_BAR_DB - 0.5,
              f"resampler={name} reconstructs the screen")

    # The quantised table on the envelope entry: an mxu name on complex input,
    # whose demod (torch.abs) stays a pass.
    seen.clear()
    tp.make_reconstruct_fn(dataclasses.replace(base, resampler="mxu3", input_format="complex64",
                                               do_align=False))(
        block.to(torch.float32).view(torch.complex64), ema0, ALPHA)
    envelope_quantised = k1_launches(seen, "envelope")
    check(envelope_quantised == 1 and k1_launches(seen, "words") == 0,
          f"resampler=mxu3 on complex input: one envelope-entry launch ({envelope_quantised})")

    # K1 with the quantised table, at the slice's shapes, against its plain version.
    spf = base.samples_per_frame
    frame_len = int(np.floor(spf))
    raster = (frame_len, mode.height, mode.width, RENDER)
    starts = torch.from_numpy(np.round(np.arange(N_FRAMES) * spf).astype(np.int32)).to(dev)
    geom = screen_geometry(*raster, dev, RESAMPLER_PHASES)
    for taps in (2, 4):
        got = frames_to_screens(env, starts, *raster, None, taps, RESAMPLER_PHASES)
        ref = frames_to_screens_plain(env, starts, geom, None, taps)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(torch.equal(got, ref)),
              f"K1 with the quantised table, {taps} taps, equals its plain version ({err:.3e})")
        if taps == 2:
            ms = time_call(torch, lambda: frames_to_screens(env, starts, *raster, None, 2,
                                                            RESAMPLER_PHASES))
            b2b_ms = time_back_to_back(torch, lambda: frames_to_screens(
                env, starts, *raster, None, 2, RESAMPLER_PHASES))
            plain_ms = time_call(torch, lambda: frames_to_screens_plain(env, starts, geom, None, 2),
                                 calls=5)
            bound_ms, bound_by, nbytes = k1_bound(n, 4, N_FRAMES, raster, False)
            print(f"[K1 envelope, quantised table] {RESAMPLER_PHASES} phases: equal to plain to "
                  f"the bit (2 and 4 taps); {ms:.4f} ms single call, {b2b_ms:.4f} ms back to "
                  f"back; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, by {bound_by}), share "
                  f"reached {bound_ms / b2b_ms:.3f}; plain {plain_ms:.4f} ms, on {card}")
            out["quantised"] = dict(err=err, ms=ms, b2b_ms=b2b_ms, plain_ms=plain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    launches=envelope_quantised)
        del got, ref
    return out


def phase_cli_and_web(tp, torch, dev, card: str, seen) -> None:
    """Phase 15: the command line, in process, on the card; then the web view."""
    import contextlib
    import io
    import tempfile
    import threading
    import urllib.request

    from tempest_tpu_torch.app.cli import main as cli_main

    fs = f"{SAMPLE_RATE:g}"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cap = str(tmp / "cap.dat")
        commands = [
            ("synth", ["synth", "--mode", MODE_NAME, "--fs", fs, "--seconds", str(CLI_SECONDS),
                       "--snr", str(SNR_DB), "--seed", str(SEED), "--out", cap], []),
            ("analyze", ["analyze", cap, "--fs", fs, "--plots", str(tmp / "ev"), "--peaks", "3"],
             [tmp / "ev_refresh.png", tmp / "ev_lines.png"]),
            ("reconstruct", ["reconstruct", cap, "--fs", fs, "--mode", "auto",
                             "--out", str(tmp / "auto.png")], [tmp / "auto.png"]),
            ("scan", ["scan", cap, "--fs", fs], []),
            ("survey", ["survey", cap, "--fs", fs, "--out", str(tmp / "report")],
             [tmp / "report" / "band.png", tmp / "report" / "screen_1.png"]),
            ("stream", ["stream", "--source", "replay", "--file", cap, "--mode", MODE_NAME,
                        "--fs", fs, "--blocks", "3", "--render", "png",
                        "--out-prefix", str(tmp / "frame")],
             [tmp / f"frame_{i:05d}.png" for i in range(3)]),
            ("search", ["search", cap, "--fs", fs, "--tol", str(SEARCH_TOL_HZ)], []),
            ("warmup", ["warmup", "--fs", fs, "--modes", MODE_NAME, "--frames", "6"], []),
            # The mesh options, four shards on this card.
            ("stream --mesh", ["stream", "--source", "replay", "--file", cap, "--mode", MODE_NAME,
                               "--fs", fs, "--block-seconds", "0.2", "--blocks", "1", "--mesh",
                               str(MESH_SHARDS), "--device", str(dev)], []),
            ("search --dynamic", ["search", cap, "--fs", fs, "--tol", str(SEARCH_TOL_HZ),
                                  "--dynamic", "--devices", str(MESH_SHARDS), "--device",
                                  str(dev)], []),
        ]
        expect = {"analyze": f"closest mode      : {MODE_NAME}",
                  "reconstruct": f"detected mode: {MODE_NAME}",
                  "survey": f"screen 1: {MODE_NAME}",
                  "search": " 1. " + MODE_NAME,
                  "stream": "frames reconstructed",
                  "warmup": "compiled timing estimator",
                  "scan": "best candidate", "synth": "wrote",
                  "stream --mesh": f"'n_shards': {MESH_SHARDS}",
                  "search --dynamic": " 1. " + MODE_NAME}
        for name, argv, pngs in commands:
            seen.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(argv)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            text = buf.getvalue()
            check(rc == 0, f"cli {name} returned {rc}:\n{text}")
            check(expect[name] in text, f"cli {name} printed {expect[name]!r}:\n{text}")
            for png in pngs:
                img = read_png(png)
                # The band plot of a few channels may be one flat line.
                check(img.size > 0 and (png.name == "band.png" or int(img.max()) > int(img.min())),
                      f"{png.name} shows an image")
            k1 = k1_launches(seen, "envelope") + k1_launches(seen, "words")
            k1_cands = k1_launches(seen, "candidates")
            if name.startswith("search"):
                shards = MESH_SHARDS if name == "search --dynamic" else 1
                check(k1_cands == shards and k1 == 0,
                      f"cli {name}: one K1 launch over the candidates a shard ({k1_cands} for "
                      f"{shards}, {k1} single)")
            shown = next(l for l in text.splitlines() if expect[name].strip() in l).strip()
            print(f"[cli] {name}: rc 0 in {ms:.1f} ms wall clock, K1 launches {k1} (over a "
                  f"candidate set {k1_cands}), {len(pngs)} PNGs opened; \"{shown}\", on {card}")
        if torch.cuda.device_count() < MESH_SHARDS:
            # Without --device the mesh takes one card a shard: with fewer
            # cards it refuses, it does not put two shards on one card.
            try:
                cli_main(["stream", "--mesh", str(MESH_SHARDS), "--blocks", "1"])
                refused = False
            except RuntimeError as err:
                refused = f"sees {torch.cuda.device_count()}" in str(err)
            check(refused, f"stream --mesh {MESH_SHARDS} refuses {torch.cuda.device_count()} card")

        # The web view on an ephemeral port, over a runtime on the card.
        mode = tp.ALL_VIDEO_MODES[MODE_NAME]
        src = tp.ReplaySource(cap, SAMPLE_RATE, int(SAMPLE_RATE * 0.1))
        rt = tp.StreamingRuntime(src, mode, alpha=0.5)
        web = tp.WebOperatorView(rt, port=0)
        base = f"http://{web.host}:{web.port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as r:
                return r.read()

        def post(path, body):
            req = urllib.request.Request(base + path, data=body.encode(), method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.read()

        def poll(pred, what):
            t_end = time.monotonic() + 60
            while time.monotonic() < t_end:
                v = pred()
                if v:
                    return v
                time.sleep(0.05)
            raise RuntimeError(f"web view: {what} not reached in 60 s")

        rt.start()
        thread = threading.Thread(target=web.run, daemon=True, name="web-smoke")
        t0 = time.perf_counter()
        thread.start()
        try:
            page = get("/").decode()
            check("operator view" in page and "/frame.png" in page, "the operator page serves")
            png = poll(lambda: (lambda p: p if p.startswith(b"\x89PNG") and len(p) > 2000
                                else None)(get("/frame.png")), "a live frame")
            first_ms = 1e3 * (time.perf_counter() - t0)
            (tmp / "live.png").write_bytes(png)
            check(read_png(tmp / "live.png").shape == RENDER, "the live frame is a screen")
            status = json.loads(get("/status.json"))
            check(status["mode"]["width"] == mode.width and status["running"] is True,
                  "the status JSON names the mode")
            post("/command", "+ 1")
            poll(lambda: rt.mode.height == mode.height + 1, "the +1 line command")
        finally:
            try:
                post("/command", "quit")
            except OSError:
                pass
            thread.join(timeout=60)
            rt.stop()
        check(not thread.is_alive() and not web.console.alive, "quit ends the web session")
        print(f"[web] page, frame PNG ({len(png)} bytes, first after {first_ms:.0f} ms), status "
              f"JSON, one command and quit over http://{web.host}:<ephemeral>, "
              f"{web.console.blocks_done} blocks processed, on {card}")


def phase_roofline(tp, torch, dev, card: str, words_i16) -> None:
    """Phase 16: a roofline count of one default step."""
    from tempest_tpu_torch.ops import align_kernel, sync_kernel
    from tempest_tpu_torch.ops.resample_kernel import launch_cost

    cfg = slice_config(tp)
    step = tp.make_reconstruct_fn(cfg)
    h, w = cfg.render_size
    ema0 = torch.zeros((h, w), dtype=torch.float32, device=dev)
    block = words_i16[: 2 * cfg.block_samples]
    rep = tp.roofline(step, block, ema0, ALPHA, 0.0)
    raster = (int(np.floor(cfg.samples_per_frame)), cfg.mode.height, cfg.mode.width, (h, w))
    costs = [launch_cost(cfg.block_samples, 4, N_FRAMES, *raster, True)[:2],
             sync_kernel.launch_cost(N_FRAMES, h, w, subpixel=True),
             align_kernel.launch_cost(N_FRAMES, h, w, 1, cfg.align_interp, True, True)]
    nbytes, flops = (sum(c[i] for c in costs) for i in range(2))
    check(rep.kernel_launches == 4 and rep.kernel_bytes == nbytes and rep.kernel_flops == flops,
          f"the roofline count holds K1's, K2's and K3's launch_cost ({rep.kernel_launches} "
          f"launches, {rep.kernel_bytes} vs {nbytes} bytes)")
    ms = time_call(torch, lambda: step(block, ema0, ALPHA, 0.0), calls=10)
    print(f"[roofline] one default step, int16 words: {rep.summary(ms / 1e3)}; of that the "
          f"kernels (K1, K2a, K2b, K3) {rep.kernel_bytes / 1e6:.1f} MB and "
          f"{rep.kernel_flops / 1e9:.3f} GFLOP in {rep.kernel_launches} launches (their "
          f"launch_cost: K1 {costs[0][0] / 1e6:.1f}, K2 {costs[1][0] / 1e6:.1f}, K3 "
          f"{costs[2][0] / 1e6:.1f} MB); peaks {tp.H100_PEAKS['flops_per_s'] / 1e12:g} "
          f"TFLOP/s float32 and {tp.H100_PEAKS['bytes_per_s'] / 1e12:g} TB/s, on {card}")
    check(rep.bound() == "memory" and rep.bytes_accessed > nbytes, "the step is memory-bound")


def kernels_device_ms(torch, fn, names, calls: int = 10, tries: int = 3) -> dict:
    """Device milliseconds a launch of each named kernel takes (``fn``
    launches each once), from torch.profiler over ``calls`` calls of ``fn``:
    the kernels alone, without the host's time between launches.  The mean
    over the launches the profiler recorded: it drops a run's device events
    now and then, and a window that recorded none of a kernel is run again,
    up to ``tries`` times.  A kernel never seen (late in a long process the
    profiler may record no device event at all) reads the milliseconds a
    call of ``fn`` takes between two CUDA events over ``calls`` calls, an
    upper bound, and a line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evts = prof.key_averages()
        out = {}
        for name in names:
            seen = [evt for evt in evts if name in evt.key and evt.count]
            count = sum(evt.count for evt in seen)
            out[name] = sum(evt.self_device_time_total for evt in seen) / 1e3 / max(count, 1)
        if min(out.values()) > 0:
            break
    for name in [n for n, ms in out.items() if ms <= 0]:
        out[name] = time_back_to_back(torch, fn, calls)
        print(f"[profiler] no device event of {name} in {tries} windows: its time is a call's "
              f"between two CUDA events, {out[name]:.4f} ms")
    return out


def _circular_err(torch, a, b, n) -> float:
    d = (a - b).abs() % n
    return float(torch.minimum(d, n - d).max())


def phase_sync_align(tp, torch, dev, card: str, words_i16, starts, raster) -> dict:
    """Phase 20: K2 and K3 against their plain versions on the slice's 36
    screens (K1 on the first block's int16 words), each timed, single fenced
    call and back to back, beside its bound and its plain version; K3's EMA
    beside one ``torch.tensordot`` of the same weights.  Returns what the
    kernels line reports of them."""
    from tempest_tpu_torch.ops import align_kernel, sync_kernel
    from tempest_tpu_torch.ops.align_kernel import align_fold, align_fold_plain, fold_weights
    from tempest_tpu_torch.ops.resample_kernel import frames_to_screens_from_words
    from tempest_tpu_torch.ops.sync_kernel import blanking_sync, blanking_sync_plain
    from tempest_tpu_torch.utils.roofline import H100_PEAKS

    def bound(nbytes, flops):
        by_bytes = 1e3 * nbytes / H100_PEAKS["bytes_per_s"]
        by_ops = 1e3 * flops / H100_PEAKS["flops_per_s"]
        return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")

    screens = frames_to_screens_from_words(words_i16, starts, *raster)
    n, h, w = screens.shape
    out = {}
    sync = {}
    for subpixel in (False, True):
        label = "sub-pixel" if subpixel else "integer"
        got = blanking_sync(screens, subpixel=subpixel)
        ref = blanking_sync_plain(screens, subpixel=subpixel)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all()) and t.shape == (n,) for t in got),
              f"K2 ({label}): finite outputs, one a frame")
        score_rel = float(((got[2] - ref[2]).abs() / ref[2].abs()).max())
        if subpixel:
            err = max(_circular_err(torch, got[0], ref[0], h),
                      _circular_err(torch, got[1], ref[1], w))
            check(err < K2_FRAC_TOL,
                  f"K2 sub-pixel centres within {K2_FRAC_TOL} px of plain ({err:.3e})")
        else:
            err = float(max((got[0] - ref[0]).abs().max(), (got[1] - ref[1]).abs().max()))
            check(err == 0, "K2's integer centres equal its plain version's on the capture")
        check(score_rel < K2_SCORE_REL, f"K2 ({label}) scores within {K2_SCORE_REL:g} of plain")
        # A frame alone and in the block: the same bits.
        for k in (0, n - 1):
            alone = blanking_sync(screens[k:k + 1], subpixel=subpixel)
            check(all(bool(torch.equal(a[0], b[k])) for a, b in zip(alone, got)),
                  f"K2 ({label}) gives frame {k} the same bits alone and among {n}")
        print(f"[K2 {label}] {n} screens of {h}x{w}: centres max diff vs plain {err:.3e} px "
              f"(tolerance {K2_FRAC_TOL:g} sub-pixel, 0 integer), scores {score_rel:.3e} "
              f"relative (tolerance {K2_SCORE_REL:g}); frames 0 and {n - 1} alone: the same bits")
        sync[subpixel] = got
        nbytes, flops = sync_kernel.launch_cost(n, h, w, subpixel=subpixel)
        bound_ms, bound_by = bound(nbytes, flops)
        ms = time_call(torch, lambda: blanking_sync(screens, subpixel=subpixel))
        b2b_ms = time_back_to_back(torch, lambda: blanking_sync(screens, subpixel=subpixel))
        plain_ms = time_call(torch, lambda: blanking_sync_plain(screens, subpixel=subpixel),
                             calls=5)
        dev_ms = kernels_device_ms(torch, lambda: blanking_sync(screens, subpixel=subpixel),
                                   ("profiles_kernel", "search_kernel"))
        device = sum(dev_ms.values())
        check(min(dev_ms.values()) > 0, f"the profiler saw K2a and K2b on the card ({dev_ms})")
        k2a_bound, _ = bound(*sync_kernel.profiles_cost(n, h, w))
        search_bytes, search_instr = sync_kernel.search_cost(n, h, w)
        by_bytes = 1e3 * search_bytes / H100_PEAKS["bytes_per_s"]
        by_issue = 1e3 * search_instr / sync_kernel.H100_ISSUE_PER_S
        k2b_bound, k2b_by = max(by_bytes, by_issue), ("bytes" if by_bytes >= by_issue
                                                      else "instructions")
        k2a_ms, k2b_ms = dev_ms["profiles_kernel"], dev_ms["search_kernel"]
        print(f"[K2 {label}] {ms:.4f} ms single call, {b2b_ms:.4f} ms back to back per "
              f"{n}-frame block; device time of the kernels alone {device:.4f} ms (K2a "
              f"{k2a_ms:.4f}, K2b {k2b_ms:.4f}; profiler, 10 calls); bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e6:.1f} M operations, by {bound_by}), share "
              f"reached {bound_ms / b2b_ms:.3f} back to back, {bound_ms / device:.3f} of device "
              f"time; K2a bound {k2a_bound:.4f} ms (bytes), share {k2a_bound / k2a_ms:.3f}; K2b "
              f"bound {k2b_bound:.4f} ms ({search_bytes / 1e6:.2f} MB, {search_instr / 1e6:.1f} M "
              f"instructions at {sync_kernel.H100_ISSUE_PER_S / 1e12:.2f} T a second, by "
              f"{k2b_by}), share {k2b_bound / k2b_ms:.3f}; plain {plain_ms:.4f} ms; on {card}")
        out["K2", subpixel] = dict(err=err, score_rel=score_rel, ms=ms, b2b_ms=b2b_ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   device_ms=device, k2a_device_ms=k2a_ms, k2b_device_ms=k2b_ms,
                                   k2a_bound_ms=k2a_bound, k2b_bound_ms=k2b_bound,
                                   k2b_bound_by=k2b_by)

    ema_in = screens.mean(dim=0).contiguous()
    fold_w, big_a = fold_weights(ALPHA, n, dev)
    for align in ("integer", "linear", "cubic", None):
        s_y, s_x, _ = sync[align != "integer"]
        got = align_fold(screens, s_y, s_x, ema_in, ALPHA, align)
        ref = align_fold_plain(screens, s_y, s_x, ema_in, ALPHA, align)
        torch.cuda.synchronize()
        err = max(float((got[0] - ref[0]).abs().max()), float((got[1] - ref[1]).abs().max()))
        check(bool(torch.equal(got[0], ref[0])) and bool(torch.equal(got[1], ref[1])),
              f"K3 ({align}) equals its plain version to the bit, aligned frames and EMA")
        lib_ref = big_a * ema_in + torch.tensordot(fold_w, ref[0], dims=1)
        lib_rel = float((got[1] - lib_ref).abs().max() / lib_ref.abs().max())
        check(lib_rel < K3_TENSORDOT_REL,
              f"K3's EMA ({align}) within {K3_TENSORDOT_REL:.2e} of one tensordot ({lib_rel:.3e})")
        print(f"[K3 {align or 'fold only'}] {n} screens: aligned frames and EMA equal to plain "
              f"to the bit; EMA vs one torch.tensordot {lib_rel:.3e} of its largest value "
              f"(tolerance {K3_TENSORDOT_REL:.2e})")
        if align in ("linear", None):
            nbytes, flops = align_kernel.launch_cost(n, h, w, 1, align, align is not None, True)
            bound_ms, bound_by = bound(nbytes, flops)
            ms = time_call(torch, lambda: align_fold(screens, s_y, s_x, ema_in, ALPHA, align))
            b2b_ms = time_back_to_back(
                torch, lambda: align_fold(screens, s_y, s_x, ema_in, ALPHA, align))
            plain_ms = time_call(
                torch, lambda: align_fold_plain(screens, s_y, s_x, ema_in, ALPHA, align), calls=5)
            tensordot_ms = time_call(torch, lambda: torch.tensordot(fold_w, ref[0], dims=1))
            device = kernels_device_ms(
                torch, lambda: align_fold(screens, s_y, s_x, ema_in, ALPHA, align),
                ("align_fold_kernel",))["align_fold_kernel"]
            check(device > 0, "the profiler saw K3 on the card")
            print(f"[K3 {align or 'fold only'}] {ms:.4f} ms single call, {b2b_ms:.4f} ms back to "
                  f"back per {n}-frame block; device time of the kernel alone {device:.4f} ms "
                  f"(profiler, 10 calls); bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, by "
                  f"{bound_by}), share reached {bound_ms / b2b_ms:.3f} back to back, "
                  f"{bound_ms / device:.3f} of device time; plain {plain_ms:.4f} ms; one "
                  f"torch.tensordot of the EMA's sum alone {tensordot_ms:.4f} ms; on {card}")
            out["K3", align] = dict(err=err, lib_rel=lib_rel, ms=ms, b2b_ms=b2b_ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                    tensordot_ms=tensordot_ms, device_ms=device)
    return out


def load_other(root: Path, name: str = "tt_parent"):
    """Another checkout's ``tempest_tpu_torch`` (``root`` holds it), loaded
    under ``name`` once; it builds its kernels in its own directory."""
    import importlib.util

    if name in sys.modules:
        return sys.modules[name]
    pkg = root / "tempest_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def host_profile(torch, fn, calls: int = HOST_PROFILE_CALLS, top: int = 8) -> tuple[float, list]:
    """cProfile of ``calls`` calls of ``fn`` back to back: the microseconds a
    call spends on the host, and the ``top`` functions by their own time, in
    microseconds a call.  (cProfile adds its own cost to every function call
    it sees: read the parts against each other, and the whole against the
    back-to-back time.)"""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    total_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    rows = sorted(((tt / calls * 1e6, f"{Path(f).name}:{line}({func})")
                   for (f, line, func), (_, _, tt, _, _) in stats.items()), reverse=True)
    return total_us, rows[:top]


def phase_frame_to_screen(tp, torch, dev, card: str, one, parent_root, seen) -> dict:
    """K1's single-frame launch: one 1080p60 frame at 20 Msps (333,333
    samples of the capture's envelope) onto the screen.  Equal to its plain
    version to the bit at 600x800 and every ``OTHER_SHAPES``, with and without
    a residual, 2 and 4 taps; one launch a call, no other kernel; its single,
    back-to-back and device time beside its bound; the tile plans of
    ``FILL_TILES_PER_SM`` 0 (the rows of a many-frame launch), 1, 2 and 4 at
    every shape; the wrapper's host time under cProfile.  With
    ``parent_root`` the same frame through that checkout's ``frame_to_screen``
    in turns with this one (parent, this, this, parent)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tempest_tpu_torch.ops import resample_kernel as rk

    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    frame_len = one.shape[0]
    h, w = RENDER
    raster = (frame_len, mode.height, mode.width, RENDER)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    shapes = (RENDER, *OTHER_SHAPES)

    def call(shape=RENDER, offset=None, taps=2, f2s=rk.frame_to_screen):
        return f2s(one, mode.height, mode.width, shape, offset, taps)

    seen.clear()
    calls, err = 0, 0.0
    for shape in shapes:
        for offset in (None, VARIANT_OFFSET):
            for taps in (2, 4):
                geom = rk.screen_geometry(frame_len, mode.height, mode.width, shape, dev)
                fracs = None if offset is None else torch.full((1,), offset, device=dev)
                ref = rk.frames_to_screens_plain(one, zero, geom, fracs, taps)[0]
                got = call(shape, offset, taps)
                calls += 1
                torch.cuda.synchronize()
                err = max(err, float((got - ref).abs().max()))
                check(got.shape == shape and bool(torch.equal(got, ref)),
                      f"frame_to_screen at {shape}, offset {offset}, {taps} taps equals its "
                      "plain version to the bit")
    check(k1_launches(seen, "frame") == calls == seen["k1"],
          f"frame_to_screen launched its own kernel once a call ({k1_launches(seen, 'frame')} "
          f"over {calls} calls; K1 in all {seen['k1']})")
    print(f"[K1 frame_to_screen] {len(shapes)} shapes x offset or none x 2 or 4 taps: equal to "
          f"the plain version to the bit, {calls} launches over {calls} calls")

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    on_card = {evt.key: evt.count for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA and evt.count}
    check(0 < sum(on_card.values()) <= 10 and all("tiles_kernel" in k for k in on_card),
          f"10 calls put K1 and nothing else on the card ({on_card})")
    print(f"[K1 frame_to_screen] 10 calls put on the card: {on_card}")

    def timed(fn) -> dict:
        return {"ms": time_call(torch, fn), "b2b_ms": time_back_to_back(torch, fn),
                "device_ms": kernels_device_ms(torch, fn, ("tiles_kernel",))["tiles_kernel"]}

    bound_ms, bound_by, nbytes = k1_bound(frame_len, 4, 1, raster, False)
    plain_ms = time_call(torch, lambda: rk.frames_to_screens_plain(
        one, zero, rk.screen_geometry(*raster, dev))[0], calls=10)
    default_fill = rk.FILL_TILES_PER_SM
    sms = rk.sm_count(dev)

    # Each tile plan at each shape, forwards then backwards.
    sweep = [(shape, fill) for shape in shapes for fill in FILL_SWEEP]
    swept = {v: [] for v in sweep}
    rows_of = {}
    try:
        for shape, fill in sweep + sweep[::-1]:
            rk.FILL_TILES_PER_SM = fill
            rows_of[shape, fill] = rk.tile_plan(frame_len, mode.height, mode.width, shape, 4,
                                                0, 2, 1, sms)[0]
            swept[shape, fill].append(timed(lambda: call(shape)))
    finally:
        rk.FILL_TILES_PER_SM = default_fill
    plans = {}
    for (shape, fill), runs in swept.items():
        rows = rows_of[shape, fill]
        tiles = -(-shape[0] // rows)
        dev_ms = [r["device_ms"] for r in runs]
        b2b = [r["b2b_ms"] for r in runs]
        plans[f"{shape[0]}x{shape[1]}, fill {fill}"] = dict(rows=rows, tiles=tiles,
                                                            device_ms=dev_ms, b2b_ms=b2b)
        used = " (the wrapper's)" if fill == default_fill else ""
        print(f"[K1 frame_to_screen] {shape[0]}x{shape[1]}, FILL_TILES_PER_SM {fill}{used}: "
              f"{rows} rows a tile, {tiles} tiles; device {dev_ms[0]:.5f} {dev_ms[1]:.5f} ms, "
              f"back to back {b2b[0]:.5f} {b2b[1]:.5f} ms, forwards backwards, on {card}")

    m = timed(call)
    host_us, host_top = host_profile(torch, call)
    print(f"[K1 frame_to_screen] {m['ms']:.5f} ms single call, {m['b2b_ms']:.5f} ms back to "
          f"back, {m['device_ms']:.5f} ms of device time for one frame onto {h}x{w}; bound "
          f"{bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, by {bound_by}), share reached "
          f"{bound_ms / m['device_ms']:.3f} of device time; plain {plain_ms:.4f} ms; host "
          f"{host_us:.2f} us a call under cProfile, on {card}")
    for us, where in host_top:
        print(f"[K1 frame_to_screen] host, own time: {us:8.2f} us a call  {where}")
    out = dict(err=err, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               host_us=host_us, plans=plans, **m)

    if parent_root is not None:
        parent = load_other(Path(parent_root)).ops.resample_kernel
        check(bool(torch.equal(call(f2s=parent.frame_to_screen), call())),
              "the parent's frame_to_screen gives the same bits")
        turns = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            f2s = parent.frame_to_screen if who == "parent" else rk.frame_to_screen
            turns[who].append(timed(lambda: call(f2s=f2s)))
        p_host_us, p_top = host_profile(torch, lambda: call(f2s=parent.frame_to_screen))
        for who, runs in turns.items():
            dev_ms, b2b, single = ([f"{r[k]:.5f}" for r in runs]
                                   for k in ("device_ms", "b2b_ms", "ms"))
            print(f"[K1 frame_to_screen, {who}] device {' '.join(dev_ms)} ms, back to back "
                  f"{' '.join(b2b)} ms, single {' '.join(single)} ms, turns parent this this "
                  f"parent, on {card}")
        print(f"[K1 frame_to_screen, parent] host {p_host_us:.2f} us a call under cProfile")
        for us, where in p_top:
            print(f"[K1 frame_to_screen, parent] host, own time: {us:8.2f} us a call  {where}")
        out["parent"] = dict(turns=turns, host_us=p_host_us)
    return out


def phase_entry_points(tp, torch, dev, card: str, seen) -> dict:
    """Phase 22: the port's counterparts of the repo's ``bench.py``,
    ``bench_all.py`` and ``__graft_entry__.py`` on the card: the bench line
    (its keys, a positive rate), every ``bench_all`` line in the JAX script's
    order, ``entry()``'s step once, ``dryrun_multichip(1)`` and
    ``dryrun_multichip(4)`` on four shards of this card.  The launch counts
    are set to 0 just before ``bench_all`` runs and read after: scenario 3
    is K1's single-frame launch."""
    import contextlib
    import io

    from tempest_tpu_torch.bench import bench, bench_all, graft_entry
    from tempest_tpu_torch.native import native_available

    t0 = time.perf_counter()
    line, ema = bench.run(bench.bench_config(), bench.ITERS, dev)
    torch.cuda.synchronize()
    print(f"[bench] {json.dumps(line)}")
    check(set(BENCH_KEYS) <= set(line) and line["value"] > 0 and line["device"] and
          line["power_limit_w"] > 0 and bool(torch.isfinite(ema).all()),
          "the port's bench line has bench.py's keys, the card's, a positive rate and a "
          "finite EMA")
    bench_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    seen.clear()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        results = bench_all.main([])
    f2s_launches = k1_launches(seen, "frame")
    bench_all_s = time.perf_counter() - t0
    lines = [json.loads(text) for text in printed.getvalue().splitlines()]
    for got in lines:
        print(f"[bench_all] {json.dumps(got)}")
    want = [m for m in BENCH_ALL_METRICS if native_available() or "C++" not in m]
    names = [got["metric"] for got in lines]
    check(lines == results and [re.sub(r"\d+ (dev|shards)\)", r"N \1)", n) for n in names]
          == want and all(got["value"] > 0 and got["device"] for got in lines),
          f"bench_all printed the JAX script's lines in its order ({names})")
    check(f2s_launches > 0, f"scenario 3 went through K1's single-frame launch ({f2s_launches})")
    print(f"[bench_all] {len(lines)} lines in {bench_all_s:.1f} s (the bench line {bench_s:.1f} "
          f"s); the C++ ring {'built' if native_available() else 'NOT built'}; K1's "
          f"single-frame launches in scenario 3: {f2s_launches}, on {card}")

    t0 = time.perf_counter()
    step, args = graft_entry.entry(dev)
    ema, frames, sync, score = step(*args)
    torch.cuda.synchronize()
    check(ema.shape == RENDER and frames.shape == (2, *RENDER) and ema.device == dev
          and bool(torch.isfinite(ema).all() and torch.isfinite(frames).all()),
          "entry()'s step gave a finite EMA and 2 frames of the screen's shape on the card")
    ran = {}
    for n, shards in ((1, None), (MESH_SHARDS, [str(dev)] * MESH_SHARDS)):
        t1 = time.perf_counter()
        out = graft_entry.dryrun_multichip(n, shards)
        torch.cuda.synchronize()
        ran[n] = (sorted(out), time.perf_counter() - t1)
        check(out["reconstruct"][1].shape == (n, *RENDER)
              and bool(torch.isfinite(out["reconstruct"][0]).all()),
              f"dryrun_multichip({n}) ran its sharded programs")
    print(f"[graft_entry] entry() step and dryrun_multichip(1): {', '.join(ran[1][0])} in "
          f"{ran[1][1]:.1f} s; dryrun_multichip({MESH_SHARDS}) on {MESH_SHARDS} shards of this "
          f"card: {', '.join(ran[MESH_SHARDS][0])} in {ran[MESH_SHARDS][1]:.1f} s; all in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"bench": line, "bench_all": lines, "frame_to_screen_launches": f2s_launches}


def phase_step_split(tp, torch, dev, card: str, words_i16, activities) -> None:
    """Phase 21: the default step on the card's int16 words, stage by stage
    with CUDA events (demod and K1 in one launch, K2, K3 with its weights),
    and the whole step's device time and kernels with the kernels and with
    their plain versions in their place, in turns."""
    from torch.profiler import profile

    from tempest_tpu_torch.ops.align_kernel import align_fold, align_fold_plain
    from tempest_tpu_torch.ops.resample_kernel import frames_to_screens_from_words
    from tempest_tpu_torch.ops.sync_kernel import blanking_sync, blanking_sync_plain
    from tempest_tpu_torch.pipeline import offline as poff

    cfg = slice_config(tp)
    mode = cfg.mode
    spf = cfg.samples_per_frame
    raster = (int(np.floor(spf)), mode.height, mode.width, cfg.render_size)
    block = words_i16[: 2 * cfg.block_samples]
    starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, N_FRAMES)).to(dev)
    ema0 = torch.zeros(cfg.render_size, dtype=torch.float32, device=dev)
    routes = {
        "kernels": (lambda s: blanking_sync(s, subpixel=True), align_fold),
        "plain": (lambda s: blanking_sync_plain(s, subpixel=True), align_fold_plain),
    }

    def stages(route):
        sync_fn, fold_fn = routes[route]
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        events[0].record()
        screens = frames_to_screens_from_words(block, starts, *raster)
        events[1].record()
        s_y, s_x, _ = sync_fn(screens)
        events[2].record()
        fold_fn(screens, s_y, s_x, ema0, ALPHA, cfg.align_interp)
        events[3].record()
        torch.cuda.synchronize()
        return [events[i].elapsed_time(events[i + 1]) for i in range(3)]

    step = tp.make_reconstruct_fn(cfg, dev)

    def with_route(route, fn):
        if route == "kernels":
            return fn()  # the step as it is: K2 writes its [F, 2] sync itself
        sync_fn, fold_fn = routes[route]
        real = poff.blanking_sync, poff.align_fold

        def blank(screens, subpixel, pairs):
            out = sync_fn(screens)
            return (*out, torch.stack(out[:2], dim=1))

        poff.blanking_sync, poff.align_fold = blank, fold_fn
        try:
            with through_wrappers(poff):
                return fn()
        finally:
            poff.blanking_sync, poff.align_fold = real

    results = {route: {"split": [], "ms": [], "device": [], "kernels": []} for route in routes}
    for route in ("kernels", "plain", "plain", "kernels"):
        r = results[route]
        stages(route)
        r["split"].append(np.median([stages(route) for _ in range(10)], axis=0))
        r["ms"].append(with_route(route, lambda: time_call(
            torch, lambda: step(block, ema0, ALPHA, 0.0), calls=10)))
        with profile(activities=activities) as prof:
            with_route(route, lambda: [step(block, ema0, ALPHA, 0.0) for _ in range(3)])
            torch.cuda.synchronize()
        by_kernel = device_by_kernel(prof, 3)
        ms_step, launches = step_device_ms(by_kernel)
        r["device"].append(ms_step)
        r["kernels"].append(launches)
        if route == "kernels":
            r["by_kernel"] = by_kernel
    kernels_ema = step(block, ema0, ALPHA, 0.0)[0]
    plain_ema = with_route("plain", lambda: step(block, ema0, ALPHA, 0.0)[0])
    torch.cuda.synchronize()
    ema_rel = float((kernels_ema - plain_ema).abs().max() / (plain_ema.max() - plain_ema.min()))
    for route, r in results.items():
        split = " / ".join(f"{a:.4f} {b:.4f}" for a, b in zip(*r["split"]))
        print(f"[step split, {route}] demod+K1 / sync / align+EMA, ms, CUDA events, median of 10, "
              f"two turns: {split}; whole step {r['ms'][0]:.3f} {r['ms'][1]:.3f} ms wall clock "
              f"(median of 10); device time {r['device'][0]:.4f} {r['device'][1]:.4f} ms in "
              f"{r['kernels'][0]:.0f} {r['kernels'][1]:.0f} kernels a step (profiler, 3 steps), "
              f"on {card}")
    by_kernel = results["kernels"]["by_kernel"]
    parts = "; ".join(f"{short_name(name)} {ms:.4f} ms x{n}" for name, (ms, n) in by_kernel.items())
    print(f"[step split, kernels] device time a step by kernel (profiler, 3 steps, last turn; "
          f"ms a launch x launches a step): {parts}; sum {step_device_ms(by_kernel)[0]:.4f} ms, "
          f"on {card}")
    check(max(results["kernels"]["kernels"]) <= 6,
          "the default step launches 6 kernels or fewer (K1, K2a, K2b, K3 and the uploads)")
    print(f"[step split] the step's EMA through the kernels vs through their plain versions: "
          f"{ema_rel:.3e} of its range (the sub-pixel fractions' summation order)")
    check(ema_rel < EMA_REL_TOL, "the step's EMA through the kernels matches the plain route")
    step_plan_check(tp, torch, dev, card)


def step_plan_check(tp, torch, dev, card: str) -> None:
    """Phase 21, the step's plan: ``bench_config()``'s ``mxu3`` step (the
    resident cell's) on 8 blocks of int16 words, 24 steps issued back to
    back, the EMA threaded, with ``torch.cuda.set_sync_debug_mode("error")``
    after the key's first step: nothing synchronises, every cut goes through
    the pinned slots, and each step's (ema, frames, sync, score), kept to the
    end, equals the same steps through the kernels' wrappers to the bit.
    Then the host's issue of a step with nothing listening (the first 3
    steps after a fence, 30 rounds) and the wall clock a step of 48 issued
    back to back, planned and through the wrappers, in turns."""
    from tempest_tpu_torch.bench import bench
    from tempest_tpu_torch.pipeline import offline as poff
    from tempest_tpu_torch.utils import profiling

    cfg = bench.bench_config()
    n, spf = cfg.block_samples, cfg.samples_per_frame
    gen = torch.Generator(device=dev).manual_seed(23)
    words = torch.randint(-16384, 16384, (8, 2 * n), dtype=torch.int16, device=dev,
                          generator=gen)
    phases = [(-b * n) % spf for b in range(8)]
    ema0 = torch.zeros(cfg.render_size, dtype=torch.float32, device=dev)

    def steps(step, count, start=0, ema=ema0):
        outs = []
        for i in range(start, count):
            outs.append(step(words[i % 8], ema, ALPHA, phases[i % 8]))
            ema = outs[-1][0]
        return outs

    profiling.reset()
    profiling.enable()
    step = tp.make_reconstruct_fn(cfg, dev)
    planned = steps(step, 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        planned += steps(step, 24, 1, planned[0][0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counters = profiling.summary()["counters"]
    profiling.disable()
    profiling.reset()
    check(counters.get("step.plan.reuses", 0) >= 23,
          f"the resident steps reuse their plan ({counters.get('step.plan.reuses')})")
    check(counters["step.upload_cuts.pinned.bytes"] == counters["step.upload_cuts.bytes"],
          "every cut goes up through the pinned slots")
    with through_wrappers(poff):
        wrapped = steps(tp.make_reconstruct_fn(cfg, dev), 24)
    torch.cuda.synchronize()
    same = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b)
               for got, ref in zip(planned, wrapped) for a, b in zip(got, ref))
    check(same, "24 planned steps issued back to back equal the wrappers' steps to the bit")
    del planned, wrapped

    def issue_us(step):
        times = []
        for _ in range(30):
            torch.cuda.synchronize()
            ema = ema0
            for i in range(3):
                t0 = time.perf_counter_ns()
                ema = step(words[i], ema, ALPHA, phases[i])[0]
                times.append(time.perf_counter_ns() - t0)
        return float(np.median(times)) / 1e3

    def step_ms(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(step, 48)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / 48

    out = {"planned": [], "wrappers": []}
    for route in ("planned", "wrappers", "wrappers", "planned"):
        ctx = through_wrappers(poff) if route == "wrappers" else contextlib.nullcontext()
        with ctx:
            step = tp.make_reconstruct_fn(cfg, dev)
            steps(step, 4)
            out[route].append((issue_us(step), step_ms(step)))
    for route, runs in out.items():
        print(f"[step plan, {route}] host issue of a step {runs[0][0]:.1f} {runs[1][0]:.1f} us "
              f"(median of 90, nothing listening); {runs[0][1]:.4f} {runs[1][1]:.4f} ms a step "
              f"of 48 back to back, wall clock; turns planned wrappers wrappers planned, on {card}")
    print(f"[step plan] 24 resident steps back to back under sync debug 'error': no sync, "
          f"{counters['step.upload_cuts.pinned.bytes']:.0f} of "
          f"{counters['step.upload_cuts.bytes']:.0f} cut bytes pinned, "
          f"equal to the wrappers' steps to the bit, on {card}")


# What K1's words load makes of I/Q words (demod, bfloat16 rounding): plain AM,
# the rounding of the mxu3, mxu4 and mxu_batched chains, the FM discriminator.
WORD_LOADS = (("am", False), ("am", True), ("fm", False), ("fm", True))
# The kernels a step may put on the card: K1, K2a, K2b, K3 and the upload.
STEP_EVENTS = ("tiles_kernel", "profiles_kernel", "search_kernel", "align_fold_kernel", "Memcpy")


def load_label(demod: str, bf16: bool) -> str:
    return {"am": "AM", "fm": "FM"}[demod] + (" rounded to bfloat16" if bf16 else "")


def load_launches(seen, demod: str, bf16: bool) -> int:
    """Launches of K1's words entry in ``seen`` under one load, whatever
    their taps and residuals."""
    return sum(n for key, n in seen.items()
               if isinstance(key, tuple) and key[0] == "k1" and key[3:] == (demod, bf16))


def k1_launches(seen, entry: str) -> int:
    """K1's launches in ``seen`` (a count of ``_build.count_launches``) from
    one of its entries, told apart by the load that ends the variant:
    "envelope" (``frames_to_screens``), "words"
    (``frames_to_screens_from_words``), "frame" (``frame_to_screen``) or
    "candidates" (``frames_to_screens_candidates``)."""
    def entry_of(load: tuple) -> str:
        return ("envelope" if not load else load[0] if load[0] in ("frame", "candidates")
                else "words")

    return sum(n for key, n in seen.items()
               if isinstance(key, tuple) and key[0] == "k1" and entry_of(key[3:]) == entry)


def fm_vs_parent(torch, card: str, parent_rk, rk, rows: dict, bounds: dict, tag: str,
                 kernel: str = "tiles_kernel") -> dict:
    """Each row of a load (``tag``: "int16 FM", "float32 FM", ...) against
    the parent checkout's kernel at the same shapes, in turns (parent, this,
    this, parent): the same bits (NaN where NaN), device time of ``kernel``
    (torch.profiler) and back-to-back time of each, beside the row's bound.
    ``rows`` maps a label to a function of the ``resample_kernel`` module
    that launches the row."""
    out = {}
    for label, launch in rows.items():
        mods = {"parent": parent_rk, "this": rk}
        a, b = launch(parent_rk), launch(rk)
        torch.cuda.synchronize()
        check(same_bits(torch, b, a), f"{tag}, {label}: this kernel gives the parent's bits")
        del a, b
        dev_ms = {"parent": [], "this": []}
        b2b = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            fn = functools.partial(launch, mods[who])
            dev_ms[who].append(kernels_device_ms(torch, fn, (kernel,))[kernel])
            b2b[who].append(time_back_to_back(torch, fn))
        bound = bounds[label]
        out[label] = {"device_ms": dev_ms, "b2b_ms": b2b, "bound_ms": bound}
        print(f"[{tag} vs parent] {label}: the parent's bits; device ms parent "
              f"{dev_ms['parent'][0]:.4f} {dev_ms['parent'][1]:.4f}, this {dev_ms['this'][0]:.4f} "
              f"{dev_ms['this'][1]:.4f}; back to back parent {b2b['parent'][0]:.4f} "
              f"{b2b['parent'][1]:.4f}, this {b2b['this'][0]:.4f} {b2b['this'][1]:.4f} (turns "
              f"parent, this, this, parent); bound {bound:.4f} ms, share this "
              f"{bound / max(b2b['this']):.3f}-{bound / min(b2b['this']):.3f} back to back, "
              f"{bound / max(dev_ms['this']):.3f}-{bound / min(dev_ms['this']):.3f} of device "
              f"time, the parent {bound / max(dev_ms['parent']):.3f}-"
              f"{bound / min(dev_ms['parent']):.3f}; on {card}")
    return out


# Rows a tile of the FM loads' balanced walk timed around the wrapper's
# (resample_kernel.ROWS_PER_TILE_FM), by the bytes of a staged sample: the
# int16 load's, and the float32 load's from the strided walk's 4 up to the 6
# that still leave the slice's plan three blocks an SM (the plan takes fewer
# rows than it is set to where they would leave fewer: FM_MIN_BLOCKS).
FM_TILE_ROWS = {4: (5, 6, 7, 8), 8: (4, 5, 6)}


def fm_rows_sweep(torch, card: str, rk, label: str, launch, ref, sample_bytes: int = 4) -> dict:
    """An FM load at each of ``FM_TILE_ROWS[sample_bytes]`` rows a tile (it
    sets ``rk.ROWS_PER_TILE_FM[sample_bytes]``; no option does): equal to
    ``ref`` to the bit, its device time forwards then backwards, so that a
    drift of the card's clocks shows between the two passes."""
    what = {4: "int16", 8: "float32"}[sample_bytes]
    default = rk.ROWS_PER_TILE_FM[sample_bytes]
    options = FM_TILE_ROWS[sample_bytes]
    times = {rows: [] for rows in options}
    try:
        for rows in options + options[::-1]:
            rk.ROWS_PER_TILE_FM[sample_bytes] = rows
            if not times[rows]:
                got = launch()
                torch.cuda.synchronize()
                check(same_bits(torch, got, ref),
                      f"the {what} FM load, {label}, at {rows} rows a tile equals its plain "
                      "version")
                del got
            times[rows].append(kernels_device_ms(torch, launch, ("tiles_kernel",))["tiles_kernel"])
    finally:
        rk.ROWS_PER_TILE_FM[sample_bytes] = default
    print(f"[{what} FM rows a tile] {label}: device ms " + "; ".join(
        f"{rows} rows{' (the wrapper' + chr(39) + 's)' if rows == default else ''} "
        f"{a:.4f} {b:.4f}" for rows, (a, b) in times.items())
        + f" (forwards, backwards), on {card}")
    return times


# Values of int16 words at the ends of their range and on the axes: every
# quadruple of two pairs of them is one sample of the FM discriminator on an
# axis, a diagonal, at (0, 0) with either sign of zero, or at the products'
# extremes.
FM_EDGE_VALUES = (0, 1, -1, 2, -2, 3, -3, 100, -100, 181, -181, 16384, -16384, 12345, -23456,
                  32766, -32767, 32767, -32768)
FM_SWEEP_LOG2 = 26   # random int16 quadruples the arc tangent is held on: 2^26


def fm_edge_words() -> np.ndarray:
    """Interleaved int16 words, pair a then pair b for every two pairs of
    ``FM_EDGE_VALUES``."""
    pairs = np.array([(i, q) for i in FM_EDGE_VALUES for q in FM_EDGE_VALUES], np.int16)
    return np.stack([np.repeat(pairs, len(pairs), axis=0), np.tile(pairs, (len(pairs), 1))],
                    axis=1).reshape(-1)


# The float32 FM load's arc tangent: its scales (integer valued within the
# int16 range, as the runtime uploads int16 captures; unit scale, as the
# synthetic generator's; random exponents over the whole float32 range,
# subnormals among them), and values whose every quadruple is an edge of the
# arc tangent or of its domain (csrc/resample.cu atan2_in_domain: products
# at 2^-60 and 2^60 and just beyond them).
F32_SCALES = ("integer valued", "unit scale", "random exponents")
F32_EDGE_VALUES = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1e-40, np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
     1.0, -1.0, 3.0, 2.0 ** -30, -1.5 * 2.0 ** -30, 2.0 ** -30 * (1 - 2.0 ** -24), 2.0 ** 30,
     -1.5 * 2.0 ** 30, 2.0 ** 30 * (1 + 2.0 ** -23), 2.0 ** 31, 1e19, -2.0 ** 64,
     np.finfo(np.float32).max, -np.finfo(np.float32).max, np.inf, -np.inf, np.nan], np.float32)


def f32_scale_words(scale: str, n_pairs: int, rng) -> np.ndarray:
    """Interleaved float32 I/Q words of ``n_pairs`` pairs at ``scale``."""
    if scale == "integer valued":
        return rng.integers(-32768, 32768, 2 * n_pairs).astype(np.float32)
    if scale == "unit scale":
        return rng.uniform(-4.0, 4.0, 2 * n_pairs).astype(np.float32)
    v = rng.integers(0, 1 << 32, 2 * n_pairs, dtype=np.uint64).astype(np.uint32).view(np.float32)
    v[~np.isfinite(v)] = 1.0
    return v


def fm_f32_edge_words() -> np.ndarray:
    """Interleaved float32 words, pair a then pair b for every two pairs of
    ``F32_EDGE_VALUES``."""
    pairs = np.array([(i, q) for i in F32_EDGE_VALUES for q in F32_EDGE_VALUES], np.float32)
    return np.stack([np.repeat(pairs, len(pairs), axis=0), np.tile(pairs, (len(pairs), 1))],
                    axis=1).reshape(-1)


def phase_stage1(tp, torch, dev, card: str, words_i16, blocks, seen, parent_root,
                 activities) -> dict:
    """Phase 23: stage 1 inside K1's words load.  Every load (AM, AM rounded
    to bfloat16, FM, FM rounded) on int16 and float32 words, 2 and 4 taps,
    rounded cuts and residuals, at the slice's shapes: equal to its plain
    version (``words_envelope_plain`` then ``frames_to_screens_plain``) to
    the bit, also with the first frame at sample 0 and the last cut by the
    block end, from an unaligned source, and at ``OTHER_SHAPES``; timed
    single, back to back and on the device beside its bound and its plain
    version.  The int16 FM load's arc tangent on every sample of 2^26
    random and of the edge quadruples (``fm_int16_words``); the float32 FM
    load's (``fm_float32_words``) on 2^26 samples at each of three scales
    (integer valued, unit, random exponents) and every edge quadruple; both
    FM loads at ``FM_TILE_ROWS`` rows a tile.  Then ``bench_config()``'s ``mxu3`` step
    and the slice's FM step, each against the same step with the demod and
    the rounding as passes (the route before): equal to the bit, wall clock
    and device time in turns, and the profiler's events a step (5: K1, K2a,
    K2b, K3, the upload; no demod or rounding kernel).  The launch counts
    are set to 0 before each main path that takes a new load (the bench
    line; the slice's FM step on int16 words; the runtime under ``mxu3``,
    FM, and FM under ``mxu3``; 4 taps with ``invert``) and read after.  With
    ``parent_root`` each int16 and float32 FM row of that checkout
    (``fm_vs_parent``) and its bench line in turns with this one's (parent,
    this, this, parent)."""
    from tempest_tpu_torch.bench import bench
    from tempest_tpu_torch.ops import resample_kernel as rk
    from tempest_tpu_torch.pipeline import offline as poff

    cfg = slice_config(tp)
    mode = cfg.mode
    spf = cfg.samples_per_frame
    frame_len = int(np.floor(spf))
    block = cfg.block_samples
    raster = (frame_len, mode.height, mode.width, RENDER)
    geom = rk.screen_geometry(*raster, dev)
    data = {"int16 words": words_i16[: 2 * block], "float32 words": words_i16[: 2 * block].float()}
    starts, fracs = poff.exact_cut_starts(VARIANT_PHASE, spf, N_FRAMES)
    starts = torch.from_numpy(starts).to(dev)
    fracs = torch.from_numpy(fracs).to(dev)
    short = int(starts[-1]) + frame_len - 4000
    edge = torch.tensor([0, frame_len + 3, int(starts[-1])], dtype=torch.int32, device=dev)
    words_entry = rk.frames_to_screens_from_words
    measured = {}
    for name, wd in data.items():
        sample_bytes = 4 if wd.dtype == torch.int16 else 8
        for demod, bf16 in WORD_LOADS:
            env = rk.words_envelope_plain(wd, demod, bf16)
            for taps in (2, 4):
                for exact in (False, True):
                    res = fracs if exact else None
                    label = (f"{load_label(demod, bf16)}, {name}, {taps} taps"
                             + (", residuals" if exact else ""))

                    def call(wd=wd, res=res, taps=taps, demod=demod, bf16=bf16):
                        return words_entry(wd, starts, *raster, res, taps, demod=demod, bf16=bf16)

                    got, ref = call(), rk.frames_to_screens_plain(env, starts, geom, res, taps)
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    check(bool(torch.equal(got, ref)),
                          f"K1 words load {label} equals its plain version to the bit ({err})")
                    del got, ref
                    edge_res = None if res is None else res[:3].contiguous()
                    for lo in (0, 2):
                        cut = wd[lo: 2 * short]
                        cut_env = rk.words_envelope_plain(cut, demod, bf16)
                        shapes = (RENDER,) + (OTHER_SHAPES if not exact else ())
                        for shape in shapes:
                            other = (frame_len, mode.height, mode.width, shape)
                            got = words_entry(cut, edge, *other, edge_res, taps, demod=demod,
                                              bf16=bf16)
                            ref = rk.frames_to_screens_plain(
                                cut_env, edge, rk.screen_geometry(*other, dev), edge_res, taps)
                            torch.cuda.synchronize()
                            check(bool(torch.equal(got, ref)),
                                  f"K1 words load {label}, block edges{' unaligned' * lo}, "
                                  f"{shape}, equals its plain version to the bit")
                            del got, ref
                    word = rk.word_code(wd.dtype, demod, bf16)[0]
                    bound_ms, bound_by, nbytes = k1_bound(block, sample_bytes, N_FRAMES, raster,
                                                          word, taps, exact)
                    parts = k1_bound_parts(block, sample_bytes, N_FRAMES, raster, word, taps,
                                           exact)
                    m = dict(err=err, ms=time_call(torch, call),
                             b2b_ms=time_back_to_back(torch, call),
                             device_ms=kernels_device_ms(torch, call, ("tiles_kernel",))[
                                 "tiles_kernel"],
                             plain_ms=time_call(torch, lambda: rk.frames_to_screens_plain(
                                 rk.words_envelope_plain(wd, demod, bf16), starts, geom, res,
                                 taps), calls=5),
                             bound_ms=bound_ms, bound_by=bound_by, nbytes=nbytes,
                             bytes_bound_ms=parts["bytes"],
                             instruction_bound_ms=parts["instructions"])
                    measured[name, demod, bf16, taps, exact] = m
                    print(f"[stage 1 in K1] {label}: equal to plain to the bit (edges, unaligned, "
                          f"other shapes); {m['ms']:.4f} ms single, {m['b2b_ms']:.4f} back to "
                          f"back, {m['device_ms']:.4f} device; bound {bound_ms:.4f} ms by "
                          f"{bound_by} ({nbytes / 1e6:.1f} MB), share {bound_ms / m['b2b_ms']:.3f}"
                          f" b2b, {bound_ms / m['device_ms']:.3f} device; plain "
                          f"{m['plain_ms']:.4f} ms, on {card}")
            del env

    # The int16 FM load's arc tangent (no slow path for its division) on every
    # sample: 2^26 random quadruples of int16 words, then every edge quadruple,
    # through the load's check entry against torch.atan2 after the same
    # roundings, bit for bit.
    rng = np.random.default_rng(SEED)
    sweep = {}
    for what, words in (
            ("random", rng.integers(-32768, 32768, 2 * ((1 << FM_SWEEP_LOG2) + 1))
             .astype(np.int16)), ("edges", fm_edge_words())):
        tw = torch.from_numpy(words).to(dev)
        got, ref = rk.fm_int16_words(tw), rk.words_envelope_plain(tw, "fm")
        torch.cuda.synchronize()
        sweep[what] = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        check(sweep[what] == 0 and got.numel() == words.size // 2,
              f"the int16 FM arc tangent equals torch.atan2 on all {got.numel()} samples of the "
              f"{what} quadruples ({sweep[what]} differ)")
        del tw, got, ref
    print(f"[stage 1 in K1] the int16 FM load's arc tangent on every sample: 2^{FM_SWEEP_LOG2} "
          f"random quadruples and {len(FM_EDGE_VALUES) ** 4} edge quadruples, "
          f"{sum(sweep.values())} differ from torch.atan2, on {card}")
    # The float32 FM load's: atan2_fast where a warp's operands all lie in its
    # domain, atan2f where not (exp/k1_atan2_f32.py prints the shares).
    sweep_f32 = {}
    for scale in F32_SCALES + ("edges",):
        words = fm_f32_edge_words() if scale == "edges" else f32_scale_words(
            scale, (1 << FM_SWEEP_LOG2) + 1, rng)
        tw = torch.from_numpy(words).to(dev)
        got, ref = rk.fm_float32_words(tw), rk.words_envelope_plain(tw, "fm")
        torch.cuda.synchronize()
        sweep_f32[scale] = 0 if same_bits(torch, got, ref) else int(
            (got.view(torch.int32) != ref.view(torch.int32)).sum())
        check(sweep_f32[scale] == 0 and got.numel() == words.size // 2,
              f"the float32 FM arc tangent equals torch.atan2 on all {got.numel()} samples at "
              f"{scale} ({sweep_f32[scale]} differ)")
        del tw, got, ref, words
    print(f"[stage 1 in K1] the float32 FM load's arc tangent on every sample: 2^{FM_SWEEP_LOG2} "
          f"samples at each of {', '.join(F32_SCALES)} and {len(F32_EDGE_VALUES) ** 4} edge "
          f"quadruples, {sum(sweep_f32.values())} differ from torch.atan2, on {card}")

    # Each int16 and float32 FM row against the parent's kernel, in turns.
    fm_parent = {}
    if parent_root is not None:
        import importlib

        parent_rk = importlib.import_module(
            f"{load_other(Path(parent_root)).__name__}.ops.resample_kernel")
        for name in ("int16 words", "float32 words"):
            wd = data[name]
            rows, bounds = {}, {}
            for taps, exact, bf16 in ((2, False, False), (2, True, False), (2, False, True),
                                      (4, False, False), (4, False, True)):
                label = (f"the slice, {taps} taps" + (", residuals" if exact else "")
                         + (", rounded to bfloat16" if bf16 else ""))
                rows[label] = functools.partial(
                    lambda mod, taps, res, bf16, wd: mod.frames_to_screens_from_words(
                        wd, starts, *raster, res, taps, demod="fm", bf16=bf16),
                    taps=taps, res=fracs if exact else None, bf16=bf16, wd=wd)
                bounds[label] = measured[name, "fm", bf16, taps, exact]["bound_ms"]
            tag = f"{name.split()[0]} FM"
            fm_parent[tag] = fm_vs_parent(torch, card, parent_rk, rk, rows, bounds, tag)

    # Rows a tile of their balanced walk, at the slice's shapes.
    fm_rows = {}
    for name in ("int16 words", "float32 words"):
        wd = data[name]
        sample_bytes = 4 if wd.dtype == torch.int16 else 8
        fm_env = rk.words_envelope_plain(wd, "fm")
        for taps in (2, 4):
            fm_rows[name, taps] = fm_rows_sweep(
                torch, card, rk, f"the slice, {taps} taps",
                functools.partial(words_entry, wd, starts, *raster, None, taps, demod="fm"),
                rk.frames_to_screens_plain(fm_env, starts, geom, None, taps), sample_bytes)
        del fm_env

    # The two steps, words load against demod and rounding as passes, in turns.
    ema0 = torch.zeros(RENDER, dtype=torch.float32, device=dev)
    steps = {}
    for what, step_cfg, phase in (
            ("mxu3 step of bench_config()", bench.bench_config(), 1234.5),
            ("FM step (the slice, demod='fm')", dataclasses.replace(cfg, demod="fm"), 0.0)):
        check(step_cfg.block_samples == block, f"the {what} takes the slice's block")
        wd = data["int16 words"]
        fused = tp.make_reconstruct_fn(step_cfg, dev)
        env_step = tp.make_reconstruct_fn(dataclasses.replace(step_cfg, input_format="envelope"),
                                          dev)
        routes = {"words load": lambda: fused(wd, ema0, ALPHA, phase),
                  "passes": lambda: env_step(poff.demodulate(wd, step_cfg), ema0, ALPHA, phase)}
        a, b = routes["words load"](), routes["passes"]()
        torch.cuda.synchronize()
        check(all(bool(torch.equal(x, y)) for x, y in zip(a, b)),
              f"the {what} through the words load equals the passes to the bit")
        del a, b
        out = {route: {"ms": [], "device": [], "kernels": []} for route in routes}
        for route in ("words load", "passes", "passes", "words load"):
            r = out[route]
            r["ms"].append(time_call(torch, routes[route], calls=10))
            fn = routes[route]
            by_kernel = device_by_kernel(profiled(torch, lambda: [fn() for _ in range(3)],
                                                  activities), 3)
            ms_step, launches = step_device_ms(by_kernel)
            r["device"].append(ms_step)
            r["kernels"].append(launches)
            r["by_kernel"] = by_kernel
        for route, r in out.items():
            parts = "; ".join(f"{short_name(k)} {ms:.4f} x{n}" for k, (ms, n) in
                              r["by_kernel"].items())
            print(f"[stage 1 in K1] {what}, {route}: {r['ms'][0]:.3f} {r['ms'][1]:.3f} ms wall "
                  f"clock (median of 10), device {r['device'][0]:.4f} {r['device'][1]:.4f} ms in "
                  f"{r['kernels'][0]} {r['kernels'][1]} kernels a step, turns words passes passes "
                  f"words; by kernel: {parts}, on {card}")
        names = out["words load"]["by_kernel"]
        check(out["words load"]["kernels"] == [5, 5]
              and all(any(e in k for e in STEP_EVENTS) for k in names),
              f"the {what} is 5 device events, K1, K2a, K2b, K3 and the upload, with no "
              f"demod or rounding kernel ({sorted(names)})")
        steps[what] = out

    # The main paths that take a new load, each from counts at 0.
    seen.clear()
    line, ema = bench.run(bench.bench_config(), bench.ITERS, dev)
    torch.cuda.synchronize()
    launches = {"bench": load_launches(seen, "am", True)}
    check(launches["bench"] > 0 and k1_launches(seen, "words") == launches["bench"]
          and k1_launches(seen, "envelope") == 0 and bool(torch.isfinite(ema).all()),
          f"the bench chain went through the words load with the rounding "
          f"({dict(seen)}, envelope {k1_launches(seen, 'envelope')})")
    # The slice's FM step on int16 words as an SDR delivers them.
    seen.clear()
    out = tp.make_reconstruct_fn(dataclasses.replace(cfg, demod="fm"), dev)(
        data["int16 words"], ema0, ALPHA, 0.0)
    torch.cuda.synchronize()
    launches["fm step int16"] = load_launches(seen, "fm", False)
    check(launches["fm step int16"] == 1 == k1_launches(seen, "words")
          and k1_launches(seen, "envelope") == 0 and bool(torch.isfinite(out[0]).all()),
          f"the slice's FM step on int16 words is one launch of the int16 FM load "
          f"({dict(seen)})")
    del out
    for key, options in (("runtime mxu3", {"config_overrides": {"resampler": "mxu3"}}),
                         ("runtime fm", {"config_overrides": {"demod": "fm"}}),
                         ("runtime fm mxu3",
                          {"config_overrides": {"demod": "fm", "resampler": "mxu3"}}),
                         ("runtime invert 4 taps",
                          {"invert": True, "config_overrides": {"interp_taps": 4}})):
        seen.clear()
        ema_rt, _, _, _ = run_runtime(tp, blocks[:2], mode, dev, **options)
        load = (options["config_overrides"].get("demod", "am"),
                options["config_overrides"].get("resampler") == "mxu3")
        if "invert" in options:
            # The block maximum, then K1's words load with the inversion.
            launches[key] = seen["k1", 4, False, "am", False, "invert"]
            launches["runtime invert 4 taps, block maximum"] = seen["words_max"]
            ok = launches[key] == 2 == k1_launches(seen, "words") == seen["words_max"]
        else:
            launches[key] = load_launches(seen, *load)
            ok = launches[key] == 2 == k1_launches(seen, "words")
        check(ok and k1_launches(seen, "envelope") == 0 and bool(np.isfinite(ema_rt).all()),
              f"{key}: 2 blocks, one K1 launch a block through the words load "
              f"({dict(seen)})")
    # 4 taps on an envelope: complex input, whose demod (torch.abs) stays a pass.
    seen.clear()
    complex_cfg = dataclasses.replace(cfg, input_format="complex64", interp_taps=4)
    out = tp.make_reconstruct_fn(complex_cfg, dev)(
        data["float32 words"].view(torch.complex64), ema0, ALPHA, 0.0)
    torch.cuda.synchronize()
    launches["complex 4 taps"] = seen["k1", 4, False]
    check(launches["complex 4 taps"] == 1 == k1_launches(seen, "envelope")
          and k1_launches(seen, "words") == 0 and bool(torch.isfinite(out[0]).all()),
          f"complex input with 4 taps: one launch of the envelope entry "
          f"({dict(seen)})")
    del out
    print(f"[stage 1 in K1] launches on the main paths: {launches}")

    turns = {"parent": [], "this": []}
    if parent_root is not None:
        import importlib

        parent_bench = importlib.import_module(f"{load_other(Path(parent_root)).__name__}"
                                               ".bench.bench")
        for who in ("parent", "this", "this", "parent"):
            run = parent_bench.run if who == "parent" else bench.run
            cfg_b = (parent_bench if who == "parent" else bench).bench_config()
            got, _ = run(cfg_b, bench.ITERS, dev)
            turns[who].append(got)
        for who, lines in turns.items():
            ms = " ".join(f"{x['ms_per_block']:.4f}" for x in lines)
            rate = " ".join(f"{x['value']:.2f}" for x in lines)
            print(f"[stage 1 in K1] bench line, {who}: {ms} ms a block = {rate} Msamples/s, "
                  f"turns parent this this parent, on {card}")
    print(f"[stage 1 in K1] bench line: {json.dumps(line)}")
    return {"measured": measured, "steps": steps, "launches": launches, "bench": line,
            "bench_turns": turns, "fm_sweep": sweep, "fm_sweep_f32": sweep_f32,
            "fm_parent": fm_parent, "fm_rows": fm_rows}


def max_bound_parts(n_samples: int, sample_bytes: int, word: int, streams: int = 1) -> dict:
    """The block maximum's bounds apart, in ms: its bytes over the memory
    rate, its float32 operations over their peak, its least instructions
    (``resample_kernel.max_launch_instructions``) at the issue rate."""
    from tempest_tpu_torch.ops.resample_kernel import max_launch_cost, max_launch_instructions
    from tempest_tpu_torch.ops.sync_kernel import H100_ISSUE_PER_S
    from tempest_tpu_torch.utils.roofline import H100_PEAKS

    nbytes, flops, _ = max_launch_cost(n_samples, sample_bytes, word, streams)
    return {"bytes": 1e3 * nbytes / H100_PEAKS["bytes_per_s"],
            "flops": 1e3 * flops / H100_PEAKS["flops_per_s"],
            "instructions": 1e3 * max_launch_instructions(n_samples, sample_bytes, word)
            / H100_ISSUE_PER_S, "nbytes": nbytes}


def max_bound(n_samples: int, sample_bytes: int, word: int, streams: int = 1
              ) -> tuple[float, str, int]:
    """The least milliseconds the card could take for one launch of the
    block maximum: the larger of its bytes over the memory rate and its
    operations (float32 operations or instructions at the issue rate) over
    their peaks (``max_bound_parts``).  Returns (ms, "bytes" or
    "operations", bytes)."""
    parts = max_bound_parts(n_samples, sample_bytes, word, streams)
    ops = max(parts["flops"], parts["instructions"])
    return (max(parts["bytes"], ops), ("bytes" if parts["bytes"] >= ops else "operations"),
            parts["nbytes"])


def same_bits(torch, got, ref) -> bool:
    """Equal NaN positions, equal bits elsewhere."""
    nan = torch.isnan(ref)
    return (bool(torch.equal(torch.isnan(got), nan))
            and bool(torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))))


# The inverted steps of phase 24: (label, config options).
INVERTED_STEPS = (("2 taps", {}), ("4 taps", {"interp_taps": 4}), ("mxu3", {"resampler": "mxu3"}))


def phase_invert(tp, torch, dev, card: str, words_i16, seen, parent_root,
                 activities) -> dict:
    """Phase 24: ``invert`` inside K1's words load.  The block maximum
    (``words_maxima``) against ``torch.max`` of the plain envelope to the
    bit, 1 and 4 streams, the int16 range's ends, an all-zero stream, NaN and
    infinities in float32 words; timed beside its bound.  Every inverted
    load at the slice's shapes against its plain version to the bit (also
    at the block's edges and from an unaligned source), timed.  The slice's
    step under ``invert`` (2 taps, 4 taps, ``mxu3``) against the pass route,
    bits and device events, wall clock and device time in turns; the
    launches of its main paths from counts at 0.  With ``parent_root`` the
    block maximum and each inverted load of 2 and 4 taps (neither rounded
    nor with residuals) against that checkout's, and each inverted step
    against that checkout's step, in turns."""
    from tempest_tpu_torch.ops import resample_kernel as rk
    from tempest_tpu_torch.pipeline import offline as poff

    cfg = slice_config(tp)
    mode = cfg.mode
    frame_len = int(np.floor(cfg.samples_per_frame))
    block = cfg.block_samples
    raster = (frame_len, mode.height, mode.width, RENDER)
    geom = rk.screen_geometry(*raster, dev)
    rng = np.random.default_rng(SEED + 1)
    capture = words_i16[: 2 * block]
    # The capture's FM discriminator lies below 0 (a carrier offset), so its
    # maximum is the first pair's 0 and the inversion gives infinities: the
    # FM loads are held on random words, whose discriminator takes both signs.
    noise = torch.from_numpy(rng.integers(-20000, 20000, 2 * block).astype(np.int16)).to(dev)
    data = {("int16 words", "am"): capture, ("float32 words", "am"): capture.float(),
            ("int16 words", "fm"): noise, ("float32 words", "fm"): noise.float()}
    parent = parent_rk = None
    if parent_root is not None:
        import importlib

        parent = load_other(Path(parent_root))
        parent_rk = importlib.import_module(f"{parent.__name__}.ops.resample_kernel")
    v_starts, v_fracs = (torch.from_numpy(a).to(dev) for a in poff.exact_cut_starts(
        VARIANT_PHASE, cfg.samples_per_frame, N_FRAMES))

    # ---- the block maximum, to the bit
    held = 0
    for (name, demod), wd in data.items():
        for streams in (1, N_STREAMS):
            w = wd[: 2 * streams * (block // streams)]
            cases = {"as captured": w}
            if streams > 1:
                edged = w.clone()
                idx = torch.from_numpy(rng.integers(0, w.numel(), 4000)).to(dev)
                edged[idx[:2000]] = -32768
                edged[idx[2000:]] = 32767
                edged[-2 * (block // streams):] = 0
                cases["int16 ends, last stream all zero"] = edged
                if name == "float32 words":
                    special = w.clone()
                    length = 2 * (block // streams)
                    for b, value in enumerate((float("nan"), float("inf"), -float("inf"))):
                        pos = torch.from_numpy(rng.integers(0, length, 64) + b * length).to(dev)
                        special[pos] = value
                    cases["NaN, +inf, -inf in streams 0-2"] = special
            for what, x in cases.items():
                got, ref = rk.words_maxima(x, demod, streams), rk.words_maxima_plain(x, demod,
                                                                                     streams)
                torch.cuda.synchronize()
                check(same_bits(torch, got, ref),
                      f"the block maximum, {name}, {demod}, {streams} streams, {what}, equals "
                      f"torch.max of the plain envelope to the bit ({got.tolist()}, {ref.tolist()})")
                if what.startswith("int16 ends"):
                    check(int(got[-1].view(torch.int32)) == 0, "an all-zero stream's maximum is +0")
                if what.startswith("NaN"):
                    check(bool(torch.isnan(got[0])), "a NaN makes its stream's maximum NaN")
                held += 1
    zero = torch.zeros(2 * 4099, dtype=torch.int16, device=dev)
    check(all(int(rk.words_maxima(zero, d).view(torch.int32)) == 0 for d in ("am", "fm")),
          "the maximum of an all-zero block is +0")
    print(f"[invert] the block maximum equals torch.max of the plain envelope to the bit in "
          f"{held} cases (int16 and float32 words, AM and FM, 1 and {N_STREAMS} streams, the "
          f"int16 range's ends, an all-zero stream, NaN and infinities), on {card}")

    # ---- the block maximum's time at the slice, one stream
    maxima = {}
    for (name, demod), wd in data.items():
        sample_bytes = 4 if wd.dtype == torch.int16 else 8
        word = rk.word_code(wd.dtype, demod)[0]
        call = functools.partial(rk.words_maxima, wd, demod)
        env = rk.words_envelope_plain(wd, demod)
        bound_ms, bound_by, nbytes = max_bound(block, sample_bytes, word)
        parts = max_bound_parts(block, sample_bytes, word)
        m = dict(err=0.0, ms=time_call(torch, call), b2b_ms=time_back_to_back(torch, call),
                 device_ms=kernels_device_ms(torch, call, ("words_max_kernel",))[
                     "words_max_kernel"],
                 plain_ms=time_call(torch, functools.partial(rk.words_maxima_plain, wd, demod),
                                    calls=10),
                 torch_max_ms=time_call(torch, lambda: torch.max(env), calls=10),
                 bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=parts["bytes"],
                 instruction_bound_ms=parts["instructions"])
        del env
        if parent is not None:
            # The parent's block maximum (the same launch, before this
            # checkout's FM loads), in turns.
            m["turns"] = fm_vs_parent(
                torch, card, parent_rk, rk,
                {f"{name}, {demod.upper()}": lambda mod, wd=wd, demod=demod: mod.words_maxima(
                    wd, demod)}, {f"{name}, {demod.upper()}": bound_ms}, "block maximum",
                "words_max_kernel")
        maxima[name, demod] = m
        print(f"[invert] block maximum, {name}, {demod.upper()}, {block} samples: {m['ms']:.4f} ms "
              f"single, {m['b2b_ms']:.4f} back to back, {m['device_ms']:.4f} device; bound "
              f"{bound_ms:.4f} ms by {bound_by} (bytes {parts['bytes']:.4f} ms for "
              f"{nbytes / 1e6:.1f} MB, instructions {parts['instructions']:.4f} ms), share "
              f"{bound_ms / m['device_ms']:.3f} of device time; plain (demod and torch.max) "
              f"{m['plain_ms']:.4f} ms, torch.max of the envelope alone {m['torch_max_ms']:.4f}, "
              f"on {card}")

    # ---- every inverted load of K1's words entry, to the bit, timed
    measured = {}
    for (name, demod), wd in data.items():
        sample_bytes = 4 if wd.dtype == torch.int16 else 8
        for bf16 in (False, True):
            env = rk.words_envelope_plain(wd, demod, bf16, True)
            for taps in (2, 4):
                for exact in (False, True):
                    res, starts = (v_fracs if exact else None), v_starts
                    label = (f"{load_label(demod, bf16)} inverted, {name}, {taps} taps"
                             + (", residuals" if exact else ""))

                    def launch(mod, wd=wd, res=res, taps=taps, demod=demod, bf16=bf16,
                               starts=starts):
                        return mod.frames_to_screens_from_words(wd, starts, *raster, res, taps,
                                                                demod=demod, bf16=bf16,
                                                                invert=True)

                    call = functools.partial(launch, rk)

                    got, ref = call(), rk.frames_to_screens_plain(env, starts, geom, res, taps)
                    torch.cuda.synchronize()
                    check(bool(torch.equal(got, ref)),
                          f"K1 words load {label} equals its plain version to the bit")
                    err = float((got - ref).abs().max())
                    del got, ref
                    short = int(starts[-1]) + frame_len - 4000
                    edge = torch.tensor([0, frame_len + 3, int(starts[-1])], dtype=torch.int32,
                                        device=dev)
                    edge_res = None if res is None else res[:3].contiguous()
                    for lo in (0, 2):
                        cut = wd[lo: 2 * short]
                        got = rk.frames_to_screens_from_words(cut, edge, *raster, edge_res, taps,
                                                              demod=demod, bf16=bf16, invert=True)
                        ref = rk.frames_to_screens_plain(
                            rk.words_envelope_plain(cut, demod, bf16, True), edge, geom, edge_res,
                            taps)
                        torch.cuda.synchronize()
                        check(bool(torch.equal(got, ref)),
                              f"K1 words load {label}, block edges{' unaligned' * lo}, equals its "
                              "plain version to the bit")
                        del got, ref
                    word = rk.word_code(wd.dtype, demod, bf16, True)[0]
                    bound_ms, bound_by, nbytes = k1_bound(block, sample_bytes, N_FRAMES, raster,
                                                          word, taps, exact)
                    m = dict(err=err, ms=time_call(torch, call),
                             b2b_ms=time_back_to_back(torch, call),
                             device_ms=kernels_device_ms(torch, call, ("tiles_kernel",))[
                                 "tiles_kernel"],
                             plain_ms=time_call(torch, lambda: rk.frames_to_screens_plain(
                                 rk.words_envelope_plain(wd, demod, bf16, True), starts, geom,
                                 res, taps), calls=3),
                             bound_ms=bound_ms, bound_by=bound_by)
                    measured[name, demod, bf16, taps, exact] = m
                    if parent is not None and not (bf16 or exact):
                        # Each inverted load of 2 and 4 taps against the
                        # parent's K1 (its block maximum launched with it).
                        m["turns"] = fm_vs_parent(
                            torch, card, parent_rk, rk,
                            {label: launch},
                            {label: bound_ms}, "inverted load")
                    print(f"[invert] K1 {label}: equal to plain to the bit (edges, unaligned); "
                          f"{m['ms']:.4f} ms single, {m['b2b_ms']:.4f} back to back (with the "
                          f"block maximum), K1 {m['device_ms']:.4f} device; bound {bound_ms:.4f} "
                          f"ms by {bound_by} ({nbytes / 1e6:.1f} MB), share "
                          f"{bound_ms / m['device_ms']:.3f} of device time; plain "
                          f"{m['plain_ms']:.4f} ms, on {card}")
            del env

    # ---- the slice's step under invert against the pass route, in turns
    ema0 = torch.zeros(RENDER, dtype=torch.float32, device=dev)
    allowed = STEP_EVENTS + ("words_max_kernel",)
    steps = {}
    for label, options in INVERTED_STEPS:
        step_cfg = dataclasses.replace(cfg, invert=True, **options)
        fused = tp.make_reconstruct_fn(step_cfg, dev)
        env_step = tp.make_reconstruct_fn(
            dataclasses.replace(step_cfg, input_format="envelope", invert=False), dev)
        routes = {"words load": lambda: fused(capture, ema0, ALPHA, 0.0),
                  "passes": lambda: env_step(poff.demodulate(capture, step_cfg), ema0, ALPHA, 0.0)}
        if parent is not None:
            # The parent's slice_config with the same options.
            pcfg = parent.ReconstructionConfig(**{
                **dict(sample_rate=SAMPLE_RATE, mode=parent.ALL_VIDEO_MODES[MODE_NAME],
                       n_frames=N_FRAMES, carry_phase=True, input_format="iq_interleaved",
                       resampler="pallas", do_align=True, align_subpixel=True,
                       align_interp="linear", invert=True), **options})
            parent_step = parent.make_reconstruct_fn(pcfg, dev)
            routes["parent"] = lambda: parent_step(capture, ema0, ALPHA, 0.0)
        outs = {who: fn() for who, fn in routes.items()}
        torch.cuda.synchronize()
        for who in outs:
            check(all(same_bits(torch, x, y) for x, y in zip(outs["words load"], outs[who])),
                  f"the slice's step under invert, {label}: the words load gives the {who}' bits")
        del outs
        order = ("words load", "passes", "passes", "words load") + (
            ("parent", "words load", "words load", "parent") if parent is not None else ())
        out = {who: {"ms": [], "device": [], "kernels": []} for who in routes}
        for who in order:
            r = out[who]
            r["ms"].append(time_call(torch, routes[who], calls=10))
            by_kernel = device_by_kernel(profiled(torch, lambda: [routes[who]() for _ in range(3)],
                                                  activities), 3)
            ms_step, launches = step_device_ms(by_kernel)
            r["device"].append(ms_step)
            r["kernels"].append(launches)
            r["by_kernel"] = by_kernel
        for who, r in out.items():
            print(f"[invert] the slice's step under invert, {label}, {who}: "
                  f"{' '.join(f'{x:.3f}' for x in r['ms'])} ms wall clock (median of 10), device "
                  f"{' '.join(f'{x:.4f}' for x in r['device'])} ms in "
                  f"{' '.join(str(x) for x in r['kernels'])} kernels a step, turns "
                  f"{' '.join(order)}; by kernel: {step_kernels(r['by_kernel'])}, on {card}")
        names = out["words load"]["by_kernel"]
        check(set(out["words load"]["kernels"]) == {6}
              and all(any(e in k for e in allowed) for k in names),
              f"the slice's step under invert, {label}: 6 device events, the block maximum, K1, "
              f"K2a, K2b, K3 and the upload, no demod, reduction or elementwise kernel "
              f"({sorted(names)})")
        steps[label] = out

    # ---- the main paths that take the inverted load, each from counts at 0
    launches = {}
    for label, options in INVERTED_STEPS[::2]:
        step_cfg = dataclasses.replace(cfg, invert=True, **options)
        seen.clear()
        out = tp.make_reconstruct_fn(step_cfg, dev)(capture, ema0, ALPHA, 0.0)
        torch.cuda.synchronize()
        key = (2, False, "am", step_cfg.resampler == "mxu3", "invert")
        launches[label] = seen["k1", *key]
        launches[label + ", block maximum"] = seen["words_max"]
        check(launches[label] == 1 == k1_launches(seen, "words")
              == seen["words_max"] and k1_launches(seen, "envelope") == 0
              and bool(torch.isfinite(out[0]).all()),
              f"the slice's step under invert, {label}: one block maximum and one inverted K1 "
              f"words launch ({dict(seen)})")
        del out
    print(f"[invert] launches on the main paths: {launches}")
    return {"maxima": maxima, "measured": measured, "steps": steps, "launches": launches}


class LoopSource:
    """A file replay in small: blocks cut from ``samples`` played in a loop,
    ``n_blocks`` of them, then the capture reports itself exhausted."""

    def __init__(self, samples: np.ndarray, block_size: int, n_blocks: int) -> None:
        self.samples = samples
        self.sample_rate = SAMPLE_RATE
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self._pos = 0
        self._served = 0

    def read(self, out: np.ndarray) -> None:
        if self._served >= self.n_blocks:
            raise EOFError("capture exhausted")
        done, n = 0, len(out)
        while done < n:
            k = min(n - done, len(self.samples) - self._pos)
            out[done:done + k] = self.samples[self._pos:self._pos + k]
            done += k
            self._pos = (self._pos + k) % len(self.samples)
        self._served += 1

    def close(self) -> None:
        pass


def run_stream(tp, runtime_cls, source, mode, n_blocks, *args, **options):
    """``n_blocks`` dispatches through ``runtime_cls(source, mode, *args)``
    with its producer thread; returns (final EMA, every frame as the steps
    returned them on the device, every sync, each dispatch's host EMA,
    seconds, the runtime)."""
    rt = runtime_cls(source, mode, *args, alpha=ALPHA, ring_depth=source.n_blocks, **options)
    step = rt._step
    frames = []

    @functools.wraps(step)          # and its geometry attributes
    def traced_step(*step_args):
        out = step(*step_args)
        frames.append(out[1])
        return out

    rt._step = traced_step
    syncs, emas = [], []
    rt.start()
    try:
        t0 = time.perf_counter()
        ema = rt.process_blocks(n_blocks, sink=lambda img, info: (syncs.append(info["sync"]),
                                                                  emas.append(img)))
        seconds = time.perf_counter() - t0
    finally:
        rt.stop()
        rt._step = step
    check(rt.ring.overflows == 0 and len(syncs) == n_blocks,
          f"{type(rt).__name__} took its blocks in order and dispatched {n_blocks} "
          f"(overflows {rt.ring.overflows}, dispatched {len(syncs)})")
    import torch

    return ema, torch.cat(frames), np.concatenate(syncs), emas, seconds, rt


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_mesh_one_card(tp, torch, dev, card: str, seen, loop, truth, activities) -> dict:
    """Phase 17 (m): the mesh runtime, four shards on one card, over two
    dispatches of the slice's capture replayed in a loop, default and
    fidelity chains, held to the bit against the single-device runtime on
    the same stream in blocks of one span; its times, the collectives', K1
    launches; and the same stream through a process group of one NCCL rank.
    Returns the launch counts and the single-device reference."""
    import torch.distributed as dist
    from torch.profiler import profile

    from tempest_tpu_torch.parallel import distributed
    from tempest_tpu_torch.parallel.mesh import ProcessGroupCollectives
    from tempest_tpu_torch.runtime.stream import frames_per_window

    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    spf = SAMPLE_RATE / mode.refresh
    S = MESH_SPAN
    check(frames_per_window(S, spf) == N_FRAMES and frames_per_window(S - 1, spf) == N_FRAMES - 1,
          f"{S} samples is the smallest span of {N_FRAMES} frames")
    block = MESH_SHARDS * S
    n_spans = MESH_SHARDS * MESH_DISPATCHES
    mesh = tp.make_mesh(devices=[dev] * MESH_SHARDS)
    out = {"reference": {}}
    for chain, options, bar in (("default", {}, PSNR_BAR_DB),
                                ("fidelity", {"fidelity": True}, FIDELITY_PSNR_BAR_DB)):
        variant = (2, chain == "fidelity", "am", False)
        seen.clear()
        ema1, frames1, sync1, emas1, s1, srt = run_stream(
            tp, tp.StreamingRuntime, LoopSource(loop, S, n_spans), mode, n_spans, **options)
        single_launches = seen["k1", *variant]
        seen.clear()
        mesh.comm.reset()
        ema, frames, sync, _, seconds, rt = run_stream(
            tp, tp.MeshStreamingRuntime, LoopSource(loop, block, MESH_DISPATCHES + 1), mode,
            MESH_DISPATCHES, mesh, **options)
        launches = seen["k1", *variant]
        k2_k3 = (seen["k2"], seen["k3"])
        traffic = dict(mesh.comm.nbytes)
        check(launches == n_spans and k1_launches(seen, "words") == n_spans
              and k1_launches(seen, "envelope") == 0,
              f"K1's fused entry launched once a shard a dispatch ({launches} for {n_spans})")
        check(k2_k3 == ((0 if chain == "fidelity" else 2 * n_spans), n_spans),
              f"K2 twice and K3 once a shard a dispatch, K2 not with fidelity ({k2_k3})")
        check(rt.config == srt.config and rt._n_frames == N_FRAMES
              and ema.dispatched == MESH_DISPATCHES, "the mesh chain is the single-device chain")
        equal = (bool(np.array_equal(ema, ema1)) and bool(torch.equal(frames, frames1))
                 and bool(np.array_equal(sync, sync1)))
        ema_diff = float(np.abs(ema - ema1).max())
        db, _ = tp.aligned_psnr(truth, ema)
        print(f"[mesh, {chain}] {MESH_SHARDS} shards of {S} samples on one card, "
              f"{MESH_DISPATCHES} dispatches ({MESH_DISPATCHES + 1} ring blocks of {block} "
              f"samples, the capture replayed in a loop of {len(loop)}): {frames.shape[0]} frames, "
              f"EMA, frames and sync equal to the bit to the single-device runtime's on {n_spans} "
              f"blocks of {S}: {equal} (EMA max diff {ema_diff:.3e}); K1 launches {launches} "
              f"(single device: {single_launches}), K2 {k2_k3[0]}, K3 {k2_k3[1]}; through "
              f"process_blocks {1e3 * seconds:.1f} ms, "
              f"{1e3 * seconds / MESH_DISPATCHES:.1f} ms a dispatch incl. ring copy and uploads "
              f"(single device: {1e3 * s1 / n_spans:.1f} ms a block); collectives' bytes a "
              f"run {traffic}; aligned PSNR {db:.3f} dB (bar {bar} dB)")
        check(equal, f"the mesh runtime equals the single-device runtime to the bit ({chain})")
        check(db > bar, f"mesh PSNR clears the bar ({chain})")
        out[chain] = launches
        out["reference"][chain] = emas1

        # The dispatch on device-resident words: time, device time, kernels,
        # and each collective on its own.
        host = np.empty(block, np.complex64)
        LoopSource(loop, block, 1).read(host)
        rows = torch.from_numpy(host.view(np.float32)).to(dev).reshape(MESH_SHARDS, 2 * S)
        tail = rows[0, :2 * rt._step.overlap].clone()
        ema0 = torch.zeros(RENDER, device=dev)
        phases = [(-(d * S)) % spf for d in range(MESH_SHARDS)]
        step = rt._step
        dispatch_ms = time_call(torch, lambda: step(rows, tail, ema0, ALPHA, phases), calls=5)
        single_ms = time_call(torch, lambda: srt._step(rows[0, :2 * srt.config.block_samples],
                                                       ema0, ALPHA, 0.0), calls=5)
        with profile(activities=activities) as prof:
            step(rows, tail, ema0, ALPHA, phases)
            torch.cuda.synchronize()
        kernels = kernel_count(prof)
        b_parts = [torch.zeros(RENDER, device=dev) for _ in range(MESH_SHARDS)]
        f_parts = list(frames[:MESH_SHARDS * N_FRAMES].reshape(MESH_SHARDS, N_FRAMES, *RENDER))
        halo_ms = time_call(torch, lambda: mesh.comm.from_next([r[:2] for r in rows], "blocks"))
        gather_ms = time_call(torch, lambda: mesh.comm.all_gather(b_parts, "blocks"))
        frames_ms = time_call(torch, lambda: mesh.gather(f_parts, "blocks"), calls=5)
        frame_mb = MESH_SHARDS * N_FRAMES * RENDER[0] * RENDER[1] * 4 / 1e6
        print(f"[mesh, {chain}] one dispatch on device-resident words: {dispatch_ms:.3f} ms = "
              f"{block / dispatch_ms / 1e3:.1f} Msamples/s (one single-device step of {S} "
              f"samples: {single_ms:.3f} ms); device time {device_ms(prof):.3f} ms in {kernels} "
              f"kernels (profiler); collectives: halos {halo_ms:.4f} ms, the EMA combine's "
              f"all_gather of {MESH_SHARDS} x {RENDER[0] * RENDER[1] * 4 / 1e6:.2f} MB "
              f"{gather_ms:.4f} ms, the frames' gather ({frame_mb:.1f} MB) {frames_ms:.4f} ms; "
              f"CUDA events, on {card}")
        del frames, frames1, rows, f_parts

    # The same stream through a process group of one NCCL rank: the
    # process-group collectives on the card, one span a dispatch.
    distributed.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        gmesh = distributed.global_mesh()
        check(isinstance(gmesh.comm, ProcessGroupCollectives) and gmesh.devices == [dev]
              and dist.get_backend() == "nccl", "a one-rank NCCL mesh on the card")
        seen.clear()
        ema_g, _, _, _, seconds, _ = run_stream(tp, tp.MeshStreamingRuntime, LoopSource(loop, S, 3),
                                                mode, 2, gmesh)
        launches = seen["k1", 2, False, "am", False]
        equal = bool(np.array_equal(ema_g, out["reference"]["default"][1]))
        print(f"[mesh, NCCL] one rank, {launches} dispatches of one span: EMA equal to the "
              f"single-device runtime's after 2 blocks: {equal}; collectives "
              f"{dict(gmesh.comm.calls)} in {1e3 * seconds:.1f} ms")
        check(equal and launches == 2, "the one-rank NCCL mesh equals the single-device runtime")
    finally:
        dist.destroy_process_group()
    return out


def phase_mesh_candidates_and_carriers(tp, torch, dev, card: str, seen, words_f32,
                                       wide) -> dict:
    """Phase 18 (n): the sharded mode search over the 26 candidates of phase
    13 and the carrier shards on fixture (e), four shards on one card, held
    against the single-device functions.  Returns K1's launch counts."""
    from tempest_tpu_torch.ops.combine import combine_core
    from tempest_tpu_torch.ops.scan import _channel_geometry, scan_centers

    mesh = tp.make_mesh(devices=[dev] * MESH_SHARDS)
    cands = tp.candidate_modes(60.0, tol_hz=SEARCH_TOL_HZ)
    spf = SAMPLE_RATE / 60.0
    need = int(np.round((SEARCH_FRAMES - 1) * spf)) + int(np.floor(spf)) + 1
    z = torch.view_as_complex(words_f32[: 2 * need].reshape(-1, 2))
    static = tp.mode_search_static(z, SAMPLE_RATE, 60.0, cands)
    tp.sharded_mode_search(z, SAMPLE_RATE, 60.0, cands, mesh)            # warm
    seen.clear()
    res = tp.sharded_mode_search(z, SAMPLE_RATE, 60.0, cands, mesh)
    launches = {"search": k1_launches(seen, "candidates")}
    check(launches["search"] == MESH_SHARDS and k1_launches(seen, "envelope") == 0
          and k1_launches(seen, "words") == 0,
          f"one K1 launch a shard over its candidates ({launches['search']} for {MESH_SHARDS} "
          f"shards, {k1_launches(seen, 'envelope')} single)")
    cpu = tp.sharded_mode_search(z.cpu(), SAMPLE_RATE, 60.0, cands,
                                 tp.make_mesh(devices=["cpu"] * MESH_SHARDS))
    score_rel = float(np.abs(res.scores - cpu.scores).max() / np.abs(cpu.scores).max())
    search_ms = wall_ms(torch, lambda: tp.sharded_mode_search(z, SAMPLE_RATE, 60.0, cands, mesh))
    print(f"[mesh search] {len(cands)} candidates over {MESH_SHARDS} shards of one card at "
          f"{RENDER[0]}x{RENDER[1]}, exact line tables: winner {res.names[res.best_index]} (static "
          f"search: {static.names[static.best_index]}); card vs CPU scores max diff "
          f"{score_rel:.3e} of the largest; K1 launches {launches['search']}; {search_ms:.2f} ms "
          f"(wall clock, median of 3), on {card}")
    check(res.best_index == static.best_index and res.names[res.best_index] == MODE_NAME,
          "the sharded search's winner is the static search's")
    check(cpu.best_index == res.best_index and score_rel < EMA_REL_TOL,
          "card and CPU sharded searches agree")

    # Carrier shards on fixture (e).
    fs = SMALL_SAMPLE_RATE
    words = torch.from_numpy(wide.iq.view(np.float32)).to(dev)
    centers = scan_centers(fs, CHAN_BW / 2, CHAN_BW / 2)
    got = tp.sharded_scan_band(words, fs, centers, mesh, chan_bw=CHAN_BW)
    ref = tp.scan_band(words, fs, centers, chan_bw=CHAN_BW)
    scan_db = max(float(np.abs(got.scores_db - ref.scores_db).max()),
                  float(np.abs(got.prominence_db - ref.prominence_db).max()))
    scan_ms = wall_ms(torch, lambda: tp.sharded_scan_band(words, fs, centers, mesh,
                                                          chan_bw=CHAN_BW))
    print(f"[mesh scan_band] {len(centers)} channels over {MESH_SHARDS} shards: masses and "
          f"prominences max diff {scan_db:.3e} dB from scan_band (tolerance {WIDE_DB_TOL} dB), "
          f"floor {got.floor_db[0]:.3f} / {ref.floor_db[0]:.3f} dB; {scan_ms:.2f} ms (wall "
          f"clock, median of 3), on {card}")
    check(scan_db < WIDE_DB_TOL and np.array_equal(got.floor_db, ref.floor_db)
          and np.abs(got.refresh_hz - ref.refresh_hz).max() < 1e-3,
          "the sharded scan gives scan_band's scores")
    sc = tp.sharded_combine_harmonics(words, fs, WIDE_CARRIERS, mesh, chan_bw=CHAN_BW)
    rc = tp.combine_harmonics(words, fs, WIDE_CARRIERS, chan_bw=CHAN_BW)
    w_rel = float(np.abs(sc.weights - rc.weights).max() / rc.weights.max())
    env_rel = float(np.abs(sc.envelope - rc.envelope).max() / np.abs(rc.envelope).max())
    comb_ms = wall_ms(torch, lambda: tp.sharded_combine_harmonics(words, fs, WIDE_CARRIERS, mesh,
                                                                  chan_bw=CHAN_BW))
    print(f"[mesh combine_harmonics] 3 carriers over {MESH_SHARDS} shards: weights "
          f"{np.round(sc.weights, 4).tolist()}, max diff {w_rel:.3e} of the largest, polarity "
          f"{sc.polarity.tolist()}, envelope max diff {env_rel:.3e} of its peak from "
          f"combine_harmonics; {comb_ms:.2f} ms (wall clock, median of 3), on {card}")
    check(np.array_equal(sc.polarity, rc.polarity) and w_rel < WIDE_WEIGHT_REL
          and env_rel < WIDE_ENV_REL and np.abs(sc.mass_db - rc.mass_db).max() < WIDE_DB_TOL,
          "the sharded fusion gives combine_harmonics' result")

    n_c = len(wide.iq)
    small = tp.ALL_VIDEO_MODES[SMALL_MODE_NAME]
    _, m_chan, fs_chan = _channel_geometry(n_c, fs, CHAN_BW)
    n_frames = int((m_chan // MESH_SHARDS) // (fs_chan / small.refresh))
    cfg = tp.ReconstructionConfig(sample_rate=fs_chan, mode=small, n_frames=n_frames,
                                  input_format="envelope", align_subpixel=True)
    seen.clear()
    step = tp.sharded_combined_reconstruct_fn(cfg, mesh, fs, n_c, WIDE_CARRIERS, small.refresh,
                                              chan_bw=CHAN_BW)
    ema0 = torch.zeros(RENDER, device=dev)
    ema, frames, _, _, w, pol = step(words, ema0, WIDE_ALPHA)
    launches["combined"] = k1_launches(seen, "envelope")
    fvq = fs_chan / round(fs_chan / small.refresh)
    env, w1, pol1, _, _ = combine_core(words, fs, WIDE_CARRIERS, CHAN_BW, fs_chan, 0.1,
                                       max(fvq - 5.0, 20.0), fvq + 5.0, "mrc", refresh_hz=fvq)
    S = step.shard_samples
    ema_ref, *_ = tp.sharded_reconstruct_fn(cfg, mesh)(env[: MESH_SHARDS * S].reshape(
        MESH_SHARDS, S), ema0, WIDE_ALPHA)
    img_rel = float((ema - ema_ref).abs().max() / ema_ref.abs().max())
    fused_ms = wall_ms(torch, lambda: step(words, ema0, WIDE_ALPHA))
    print(f"[mesh combined_reconstruct_fn] carriers -> time over {MESH_SHARDS} shards: "
          f"{frames.shape[0]} frames ({n_frames} a shard at {fs_chan / 1e6:g} Msps), weights "
          f"max diff {float((w - w1).abs().max()):.3e} from combine_core, EMA max diff "
          f"{img_rel:.3e} of its peak from the two stages run apart (tolerance 5e-3); K1 "
          f"launches {launches['combined']}; {fused_ms:.2f} ms a step (wall clock, median of "
          f"3), on {card}")
    check(launches["combined"] == MESH_SHARDS and torch.equal(pol, pol1)
          and float((w - w1).abs().max()) < WIDE_WEIGHT_REL and img_rel < 5e-3,
          "the fused mesh step equals its two stages")
    return launches


_RANK_FLAG = "--rank"


def rank_main(argv: list[str]) -> int:
    """One NCCL rank of phase 19 (o), started by the smoke itself: the mesh
    stream and the combine front over one shard a card."""
    import argparse

    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument(_RANK_FLAG, type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--data", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import tempest_tpu_torch as tp
    from tempest_tpu_torch._build import count_launches
    from tempest_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{args.port}", args.world, args.rank)
    data = Path(args.data)
    try:
        mesh = distributed.global_mesh()
        dev = mesh.device
        mode = tp.ALL_VIDEO_MODES[MODE_NAME]
        loop = np.load(data / "loop.npy", mmap_mode="r")
        S, n = MESH_SPAN, args.world
        with count_launches() as seen:
            ema, frames, _, _, seconds, rt = run_stream(
                tp, tp.MeshStreamingRuntime, LoopSource(loop, n * S, MESH_DISPATCHES + 1), mode,
                MESH_DISPATCHES, mesh)
        launches = k1_launches(seen, "words")
        traffic = dict(mesh.comm.nbytes)
        host = np.empty(n * S, np.complex64)
        LoopSource(loop, n * S, 1).read(host)
        rows = torch.from_numpy(host.view(np.float32)).to(dev).reshape(n, 2 * S)
        tail = rows[0, :2 * rt._step.overlap].clone()
        ema0 = torch.zeros(RENDER, device=dev)
        phases = [(-(d * S)) % (SAMPLE_RATE / mode.refresh) for d in range(n)]
        step = rt._step
        dist.barrier()
        dispatch_ms = time_call(torch, lambda: step(rows, tail, ema0, ALPHA, phases), calls=5)
        mine = [rows[args.rank][:2]]
        b_part = [torch.zeros(RENDER, device=dev)]
        f_part = [frames[:N_FRAMES]]
        halo_ms = time_call(torch, lambda: mesh.comm.from_next(mine, "blocks"))
        gather_ms = time_call(torch, lambda: mesh.comm.all_gather(b_part, "blocks"))
        frames_ms = time_call(torch, lambda: mesh.gather(f_part, "blocks"), calls=5)
        wide = np.load(data / "wide.npy")
        front = tp.sharded_streaming_combine_front(SAMPLE_RATE, wide.size // 2, LIVE_CARRIERS,
                                                   mode.refresh, mesh, chan_bw=CHAN_BW)
        words = torch.from_numpy(wide).to(dev)
        env, w, pol, mass = front(words)
        front_ms = time_call(torch, lambda: front(words), calls=5)
        if args.rank == 0:
            np.savez(data / "rank0.npz", ema=np.asarray(ema), env=env.cpu().numpy(),
                     w=w.cpu().numpy(), pol=pol.cpu().numpy(), mass=mass.cpu().numpy(),
                     report=np.array(json.dumps(dict(
                         launches=launches, seconds=seconds, dispatch_ms=dispatch_ms,
                         halo_ms=halo_ms, gather_ms=gather_ms, frames_ms=frames_ms,
                         front_ms=front_ms, traffic=traffic,
                         dispatched=int(ema.dispatched)))))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_several_cards(tp, torch, card: str, seen, loop, reference, activities) -> None:
    """Phase 19 (o): the (m) stream over several cards, in one process
    (``make_mesh``) and on one NCCL rank a card started here, and the combine
    front on those ranks, each held against the single-device result."""
    import tempfile

    from tempest_tpu_torch.ops.combine import combine_core
    from tempest_tpu_torch.ops.scan import _channel_geometry

    n_cards = min(torch.cuda.device_count(), MESH_SHARDS)
    if n_cards < 2:
        print(f"[cards] phase (o) needs 2 or more cards and sees {torch.cuda.device_count()}: "
              "not run here (`--phase o` on a machine of 2-4 cards runs it)")
        return
    mode = tp.ALL_VIDEO_MODES[MODE_NAME]
    S = MESH_SPAN
    n_spans = n_cards * MESH_DISPATCHES
    mesh = tp.make_mesh(n_cards)
    seen.clear()
    ema, _, _, _, seconds, rt = run_stream(
        tp, tp.MeshStreamingRuntime, LoopSource(loop, n_cards * S, MESH_DISPATCHES + 1), mode,
        MESH_DISPATCHES, mesh)
    want = reference["default"][n_spans - 1]
    diff = float(np.abs(ema - want).max())
    launches = k1_launches(seen, "words")
    host = np.empty(n_cards * S, np.complex64)
    LoopSource(loop, n_cards * S, 1).read(host)
    rows = torch.from_numpy(host.view(np.float32)).to(mesh.device).reshape(n_cards, 2 * S)
    tail = rows[0, :2].clone()
    ema0 = torch.zeros(RENDER, device=mesh.device)
    phases = [(-(d * S)) % (SAMPLE_RATE / mode.refresh) for d in range(n_cards)]
    step = rt._step
    dispatch_ms = time_call(torch, lambda: step(rows, tail, ema0, ALPHA, phases), calls=5)
    # The collectives alone, between the cards: the shards' heads and B
    # images on their own cards, one dispatch's frames gathered onto card 0.
    heads = [rows[d, :2].to(dev) for d, dev in enumerate(mesh.devices)]
    b_parts = [torch.zeros(RENDER, device=dev) for dev in mesh.devices]
    f_parts = [torch.zeros((N_FRAMES, *RENDER), device=dev) for dev in mesh.devices]
    halo_ms = time_call(torch, lambda: mesh.comm.from_next(heads, "blocks"))
    gather_ms = time_call(torch, lambda: mesh.comm.all_gather(b_parts, "blocks"))
    frames_ms = time_call(torch, lambda: mesh.gather(f_parts, "blocks"), calls=5)
    collectives = halo_ms + gather_ms + frames_ms
    print(f"[cards, one process] make_mesh({n_cards}): {MESH_DISPATCHES} dispatches, EMA max "
          f"diff {diff:.3e} from the single-device runtime after {n_spans} blocks (equal: "
          f"{diff == 0.0}); K1 launches {launches}; {1e3 * seconds / MESH_DISPATCHES:.1f} ms a "
          f"dispatch through process_blocks; {dispatch_ms:.3f} ms a dispatch on words on the "
          f"first card = {n_cards * S / dispatch_ms / 1e3:.1f} Msamples/s; collectives alone: "
          f"halo {halo_ms:.4f} ms, EMA all_gather {gather_ms:.4f} ms, frames' gather onto card 0 "
          f"{frames_ms:.4f} ms, {collectives:.3f} ms = {collectives / dispatch_ms:.3f} of the "
          f"dispatch; CUDA events, on {card} x {n_cards}")
    check(launches == n_spans and diff <= EMA_REL_TOL * float(np.ptp(want)),
          "the one-process multi-card mesh matches the single-device runtime")
    del rows, heads, b_parts, f_parts, rt, step
    torch.cuda.empty_cache()

    mode_fs = SAMPLE_RATE
    wide = tp.generate_iq_harmonics(mode, mode_fs, 1 << 23, LIVE_CARRIERS, amplitudes=[1.0, 1.0],
                                    snr_db=LIVE_SNR_DB, seed=SEED).iq.view(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / "loop.npy", loop)
        np.save(Path(tmp) / "wide.npy", wide)
        port = str(_free_port())
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), _RANK_FLAG,
                                   str(r), "--world", str(n_cards), "--port", port, "--data", tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(n_cards)]
        try:
            logs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        ranks_s = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(f"[cards, rank {r}] exit {p.returncode}:\n{log[-4000:]}")
        check(all(p.returncode == 0 for p in procs), f"{n_cards} NCCL ranks ran to the end")
        got = np.load(Path(tmp) / "rank0.npz")
        report = json.loads(str(got["report"]))
        diff = float(np.abs(got["ema"] - want).max())
        collectives = report["halo_ms"] + report["gather_ms"] + report["frames_ms"]
        print(f"[cards, NCCL] {n_cards} ranks, one a card: EMA max diff {diff:.3e} from the "
              f"single-device runtime after {n_spans} blocks (equal: {diff == 0.0}); rank 0: K1 "
              f"launches {report['launches']}, {report['dispatched']} dispatches, "
              f"{1e3 * report['seconds'] / MESH_DISPATCHES:.1f} ms a dispatch through "
              f"process_blocks, {report['dispatch_ms']:.3f} ms a dispatch on device-resident "
              f"words = {n_cards * S / report['dispatch_ms'] / 1e3:.1f} Msamples/s; collectives "
              f"alone: halo {report['halo_ms']:.4f} ms, EMA all_gather {report['gather_ms']:.4f} "
              f"ms, frames' gather {report['frames_ms']:.4f} ms, {collectives:.3f} ms = "
              f"{collectives / report['dispatch_ms']:.3f} of the dispatch; bytes a run "
              f"{report['traffic']}; {ranks_s:.1f} s for the ranks from start to exit; CUDA "
              f"events, on {card} x {n_cards}")
        check(report["launches"] == MESH_DISPATCHES and diff <= EMA_REL_TOL * float(np.ptp(want)),
              "the NCCL mesh matches the single-device runtime")
        n_samples = wide.size // 2
        _, _, fs_chan = _channel_geometry(n_samples, mode_fs, CHAN_BW)
        fvq = fs_chan / round(fs_chan / mode.refresh)
        env, w, pol, mass, _ = combine_core(torch.from_numpy(wide).to(mesh.device), mode_fs,
                                            LIVE_CARRIERS, CHAN_BW, fs_chan, 0.1,
                                            max(fvq - 5.0, 20.0), fvq + 5.0, "mrc",
                                            refresh_hz=fvq)
        env_rel = float(np.abs(got["env"] - env.cpu().numpy()).max() / env.abs().max())
        w_rel = float(np.abs(got["w"] - w.cpu().numpy()).max() / w.abs().max())
        print(f"[cards, NCCL] combine front over {n_cards} ranks: weights "
              f"{np.round(got['w'], 4).tolist()}, max diff {w_rel:.3e} of the largest, envelope "
              f"max diff {env_rel:.3e} of its peak from combine_core; {report['front_ms']:.3f} ms "
              f"a block (CUDA events, rank 0), on {card} x {n_cards}")
        check(np.array_equal(got["pol"], pol.cpu().numpy()) and w_rel < WIDE_WEIGHT_REL
              and env_rel < WIDE_ENV_REL, "the NCCL combine front matches combine_core")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if _RANK_FLAG in argv:
        return rank_main(argv)
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on the card.")
    ap.add_argument("--phase", choices=["all", "o"], default="all",
                    help="'o': only phase 19 (several cards), after the build, the capture and "
                         "phase 17, its reference")
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout (the parent commit's tempest_tpu_torch/ under this "
                         "directory): its frame_to_screen and its bench line timed in turns with "
                         "this one's")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "tempest_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import tempest_tpu_torch as tp
    from tempest_tpu_torch import _build
    from tempest_tpu_torch.ops import resample_kernel
    from tempest_tpu_torch.ops.resample_kernel import (
        frames_to_screens, frames_to_screens_from_words, frames_to_screens_plain,
        screen_geometry)
    from tempest_tpu_torch.pipeline import offline as poff

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    check("jax" not in sys.modules, "the port imports no jax")

    # Every kernel launch of the run is counted in ``seen``, which a phase
    # clears just before it drives a main path.
    launch_count = contextlib.ExitStack()
    seen = launch_count.enter_context(_build.count_launches())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # ---- 1. build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = dict(zip(KERNEL_SOURCES, pool.map(_build.load_library, KERNEL_SOURCES)))
    print(f"[build] {', '.join(Path(lib.path).name for lib in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s, one nvcc a source, all started together")
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if "Compiling" in line or "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}")

    cfg = slice_config(tp)
    mode = cfg.mode
    spf = cfg.samples_per_frame
    frame_len = int(np.floor(spf))
    block = cfg.block_samples
    h, w = cfg.render_size
    t0 = time.perf_counter()
    words, truth_raster = make_capture(tp.generate_iq, mode, block)
    print(f"[capture] {words.size // 2} samples of {MODE_NAME} at "
          f"{SAMPLE_RATE / 1e6:g} Msps in {time.perf_counter() - t0:.1f} s")
    blocks = words[: 2 * N_BLOCKS * block].astype(np.float32).view(np.complex64)
    blocks = blocks.reshape(N_BLOCKS, block)
    loop = words[: 2 * LOOP_SAMPLES].astype(np.float32).view(np.complex64)
    truth = tp.downgrade_image(torch.from_numpy(truth_raster), (h, w)).numpy()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.phase == "o":
        mesh_out = phase_mesh_one_card(tp, torch, dev, card, seen, loop, truth,
                                       activities)
        phase_several_cards(tp, torch, card, seen, loop, mesh_out["reference"],
                            activities)
        if torch.cuda.device_count() >= MESH_SHARDS:
            from tempest_tpu_torch.bench.graft_entry import dryrun_multichip

            t0 = time.perf_counter()
            ran = dryrun_multichip(MESH_SHARDS)
            check(ran["reconstruct"][1].shape == (MESH_SHARDS, h, w),
                  f"dryrun_multichip({MESH_SHARDS}) over {MESH_SHARDS} cards")
            print(f"[graft_entry] dryrun_multichip({MESH_SHARDS}) over {MESH_SHARDS} cards: "
                  f"{', '.join(sorted(ran))} in {time.perf_counter() - t0:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. both K1 entries against their plain versions, at the slice's shapes
    words_i16 = torch.from_numpy(words[: 2 * block]).to(dev)
    words_f32 = words_i16.to(torch.float32)
    env = tp.am_envelope_from_iq(words_i16)
    starts = torch.from_numpy(poff.carry_phase_starts(0.0, spf, N_FRAMES)).to(dev)
    geom = screen_geometry(frame_len, mode.height, mode.width, (h, w), dev)
    raster = (frame_len, mode.height, mode.width, (h, w))

    def plain_from_words(wd, st):
        return frames_to_screens_plain(tp.am_envelope_from_iq(wd), st, geom)

    def demod_then_k1(wd, st):
        return frames_to_screens(tp.am_envelope_from_iq(wd), st, *raster)

    entries = {  # name -> (kernel call, its plain version, input, bytes per sample, demod)
        "envelope": (frames_to_screens,
                     lambda e, st: frames_to_screens_plain(e, st, geom), env, 4, False),
        "int16 words": (frames_to_screens_from_words, plain_from_words, words_i16, 4, True),
        "float32 words": (frames_to_screens_from_words, plain_from_words, words_f32, 8, True),
    }
    # A block cut short inside the last frame, so that the last tiles read
    # past its end, and the same block from a source off 16-byte alignment.
    short = int(starts[-1]) + frame_len - 4000
    measured = {}
    for name, (kernel, plain_fn, data, sample_bytes, demod) in entries.items():
        per_sample = data.numel() // block
        got = kernel(data, starts, *raster)
        ref = plain_fn(data, starts)
        torch.cuda.synchronize()
        check(got.shape == (N_FRAMES, h, w) and bool(torch.isfinite(got).all()),
              f"K1 on {name}: output finite, of the slice's shape")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        print(f"[K1 {name}] max abs diff vs plain {err:.3e}, relative {rel:.3e} "
              f"(tolerance {K1_REL_TOL:g})")
        check(rel < K1_REL_TOL, f"K1 on {name} agrees with its plain version")
        del got, ref
        for what, cut in (("block end inside the last frame", data[: short * per_sample]),
                          ("unaligned source", data[2: short * per_sample])):
            got = kernel(cut, starts[-2:], *raster)
            ref = plain_fn(cut, starts[-2:])
            torch.cuda.synchronize()
            edge_rel = float((got - ref).abs().max()) / float(ref.abs().max())
            print(f"[K1 {name}] {what}: relative diff {edge_rel:.3e}")
            check(edge_rel < K1_REL_TOL, f"K1 on {name}, {what}, agrees with its plain version")
            del got, ref
        bound_ms, bound_by, nbytes = k1_bound(block, sample_bytes, N_FRAMES, raster, demod)
        ms = time_call(torch, lambda: kernel(data, starts, *raster))
        b2b_ms = time_back_to_back(torch, lambda: kernel(data, starts, *raster))
        plain_ms = time_call(torch, lambda: plain_fn(data, starts), calls=10)
        measured[name] = dict(err=err, ms=ms, b2b_ms=b2b_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        print(f"[K1 {name}] {ms:.4f} ms single call, {b2b_ms:.4f} ms back to back per "
              f"{N_FRAMES}-frame block; bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, by "
              f"{bound_by}), share reached {bound_ms / ms:.3f} single, "
              f"{bound_ms / b2b_ms:.3f} back to back; plain {plain_ms:.4f} ms, on {card}")
    for shape in OTHER_SHAPES:
        other = (frame_len, mode.height, mode.width, shape)
        other_geom = screen_geometry(*other, dev)
        for name, (kernel, _, data, _, _) in entries.items():
            cut = data[: short * (data.numel() // block)]
            got = kernel(cut, starts[-2:], *other)
            e = cut if name == "envelope" else tp.am_envelope_from_iq(cut)
            ref = frames_to_screens_plain(e, starts[-2:], other_geom)
            torch.cuda.synchronize()
            rel = float((got - ref).abs().max()) / float(ref.abs().max())
            print(f"[K1 {name}] {shape[0]}x{shape[1]} screens: relative diff {rel:.3e}")
            check(got.shape == (2, *shape) and rel < K1_REL_TOL,
                  f"K1 on {name} at {shape} agrees with its plain version")
    # ---- K1's single-frame launch, on an aligned copy of one frame
    one = env[int(starts[1]): int(starts[1]) + frame_len].clone()
    f2s = phase_frame_to_screen(tp, torch, dev, card, one, args.parent, seen)

    # Rows a tile: each entry timed at every size, forwards then backwards, so
    # that a drift of the card's clocks shows between the two passes.
    default_rows = dict(resample_kernel.ROWS_PER_TILE)
    sweep = [(name, rows) for name in entries for rows in TILE_ROWS]
    swept = {v: [] for v in sweep}
    try:
        for name, rows in sweep + sweep[::-1]:
            kernel, plain_fn, data, sample_bytes, _ = entries[name]
            resample_kernel.ROWS_PER_TILE[sample_bytes] = rows
            if not swept[name, rows]:
                ref = plain_fn(data, starts)
                rel = float((kernel(data, starts, *raster) - ref).abs().max() / ref.abs().max())
                check(rel < K1_REL_TOL,
                      f"K1 on {name} at {rows} rows a tile agrees with its plain version")
                del ref
            swept[name, rows].append(
                time_back_to_back(torch, lambda: kernel(data, starts, *raster)))
    finally:
        resample_kernel.ROWS_PER_TILE.update(default_rows)
    for (name, rows), (first, second) in swept.items():
        used = " (the wrapper's)" if default_rows[entries[name][3]] == rows else ""
        print(f"[K1 {name}] {rows} rows a tile{used}: {first:.4f} {second:.4f} ms back to "
              f"back, forwards backwards, on {card}")

    for name, data in (("int16 words", words_i16), ("float32 words", words_f32)):
        ms = time_call(torch, lambda: demod_then_k1(data, starts))
        b2b_ms = time_back_to_back(torch, lambda: demod_then_k1(data, starts))
        demod_ms = time_back_to_back(torch, lambda: tp.am_envelope_from_iq(data))
        print(f"[demod then K1, {name}] {ms:.4f} ms single call, {b2b_ms:.4f} ms back to "
              f"back (the demod alone {demod_ms:.4f}), against the fused entry's "
              f"{measured[name]['b2b_ms']:.4f}, on {card}")

    # ---- 20. K2 and K3 against their plain versions at the slice's shapes
    sync_align = phase_sync_align(tp, torch, dev, card, words_i16, starts, raster)

    # ---- 3. the slice end to end through the streaming runtime
    demod_calls = []
    demodulate = poff.demodulate

    def counted_demodulate(*args):
        demod_calls.append(1)
        return demodulate(*args)

    poff.demodulate = counted_demodulate
    seen.clear()
    ema_gpu, sync_gpu, out_devices, seconds = run_runtime(tp, blocks, mode, dev)
    fused_launches = k1_launches(seen, "words")
    k2_launches, k3_launches = seen["k2"], seen["k3"]
    check(0 < k2_launches <= 2 * fused_launches
          and k3_launches == seen["k3", "linear", True] == fused_launches,
          f"K2 launched twice a block at most ({k2_launches}) and K3 once a block, aligning and "
          f"folding ({dict(seen)}), over {fused_launches} blocks")
    check(fused_launches >= N_BLOCKS,
          f"the fused entry launched for every block ({fused_launches})")
    check(k1_launches(seen, "envelope") == 0 and not demod_calls,
          f"no separate demod pass on the runtime's path (envelope-entry launches "
          f"{k1_launches(seen, 'envelope')}, demodulate calls {len(demod_calls)})")
    check(out_devices and all(d == "cuda" for d in out_devices),
          f"every step output on the card ({sorted(set(out_devices))})")
    check(ema_gpu.shape == (h, w) and bool(np.isfinite(ema_gpu).all()),
          "final EMA finite, of the screen's shape")
    print(f"[runtime] {N_BLOCKS} blocks through process_blocks in {seconds:.3f} s "
          f"({1e3 * seconds / N_BLOCKS:.2f} ms per block incl. ring copy and upload), "
          f"fused K1 launches {fused_launches}, K2 launches {k2_launches}, K3 launches "
          f"{k3_launches}, separate demod passes 0")

    t0 = time.perf_counter()
    ema_cpu, sync_cpu, _, _ = run_runtime(tp, blocks, mode, "cpu")
    span = float(ema_cpu.max() - ema_cpu.min())
    ema_rel = float(np.abs(ema_gpu - ema_cpu).max()) / span
    sync_err = float(np.abs(sync_gpu - sync_cpu).max())
    print(f"[runtime] CPU run {time.perf_counter() - t0:.1f} s; card vs CPU: EMA max diff "
          f"{ema_rel:.3e} of range (tolerance {EMA_REL_TOL:g}), sync max diff "
          f"{sync_err:.3e} px (tolerance {SYNC_ABS_TOL:g})")
    check(ema_rel < EMA_REL_TOL, "card EMA matches the CPU run")
    check(sync_err < SYNC_ABS_TOL, "card sync matches the CPU run")

    db, shift = tp.aligned_psnr(truth, ema_gpu)
    print(f"[runtime] aligned PSNR {db:.3f} dB (bar {PSNR_BAR_DB} dB), shift {shift}")
    check(db > PSNR_BAR_DB, "PSNR clears the bar")

    # ---- 4. the runtime with invert=True: the block maximum, then K1's words load
    seen.clear()
    inv_gpu, inv_sync_gpu, inv_devices, _ = run_runtime(
        tp, blocks[:INVERT_BLOCKS], mode, dev, invert=True)
    invert_launches = seen["k1", 2, False, "am", False, "invert"]
    max_launches = seen["words_max"]
    check(invert_launches == max_launches == INVERT_BLOCKS
          and k1_launches(seen, "words") == INVERT_BLOCKS
          and k1_launches(seen, "envelope") == 0 and not demod_calls,
          f"every inverted block is one block maximum and one inverted K1 words launch, no demod "
          f"pass ({dict(seen)}, maxima {max_launches}, envelope "
          f"{k1_launches(seen, 'envelope')}, demodulate {len(demod_calls)})")
    poff.demodulate = demodulate
    check(inv_devices and all(d == "cuda" for d in inv_devices),
          "every inverted step output on the card")
    check(inv_gpu.shape == (h, w) and bool(np.isfinite(inv_gpu).all()),
          "inverted EMA finite, of the screen's shape")
    inv_cpu, inv_sync_cpu, _, _ = run_runtime(tp, blocks[:INVERT_BLOCKS], mode, "cpu",
                                              invert=True)
    inv_rel = float(np.abs(inv_gpu - inv_cpu).max()) / float(inv_cpu.max() - inv_cpu.min())
    inv_sync_err = float(np.abs(inv_sync_gpu - inv_sync_cpu).max())
    print(f"[runtime, invert] {INVERT_BLOCKS} blocks, block maximum launches {max_launches}, "
          f"inverted K1 words launches {invert_launches}, demod passes 0; card vs CPU: EMA max "
          f"diff {inv_rel:.3e} of range, sync max diff {inv_sync_err:.3e} px")
    check(inv_rel < EMA_REL_TOL, "inverted card EMA matches the CPU run")
    check(inv_sync_err < SYNC_ABS_TOL, "inverted card sync matches the CPU run")


    # ---- 5. K1 with residuals, with 4 taps and with both, against the plain version
    v_starts, v_fracs = poff.exact_cut_starts(VARIANT_PHASE, spf, N_FRAMES)
    v_starts = torch.from_numpy(v_starts).to(dev)
    v_fracs = torch.from_numpy(v_fracs).to(dev)
    edge_starts = torch.tensor([0, frame_len + 3, int(starts[-1])], dtype=torch.int32, device=dev)
    for taps, exact in VARIANTS:
        label = f"{taps} taps" + (", residuals" if exact else "")
        residuals = v_fracs if exact else None
        for name, (kernel, _, data, sample_bytes, demod) in entries.items():
            per_sample = data.numel() // block
            e = data if name == "envelope" else tp.am_envelope_from_iq(data)
            got = kernel(data, v_starts, *raster, residuals, taps)
            ref = frames_to_screens_plain(e, v_starts, geom, residuals, taps)
            torch.cuda.synchronize()
            check(got.shape == (N_FRAMES, h, w) and bool(torch.isfinite(got).all()),
                  f"K1 on {name}, {label}: output finite, of the slice's shape")
            err = float((got - ref).abs().max())
            print(f"[K1 {name}, {label}] max abs diff vs plain {err:.3e} (equal to the bit: "
                  f"{bool(torch.equal(got, ref))})")
            check(bool(torch.equal(got, ref)),
                  f"K1 on {name}, {label}, equals its plain version to the bit")
            del got, ref
            # First frame at sample 0 (tap -1 clamps onto it), last frame cut
            # by the block end; then the same from an unaligned source.
            edge_res = None if residuals is None else residuals[:3].contiguous()
            for what, lo in (("block edges", 0), ("unaligned source", 2)):
                cut = data[lo: short * per_sample]
                got = kernel(cut, edge_starts, *raster, edge_res, taps)
                ref = frames_to_screens_plain(e[lo // per_sample: short], edge_starts, geom,
                                              edge_res, taps)
                torch.cuda.synchronize()
                edge_err = float((got - ref).abs().max())
                print(f"[K1 {name}, {label}] {what}: max abs diff {edge_err:.3e}")
                check(bool(torch.equal(got, ref)),
                      f"K1 on {name}, {label}, {what}, equals its plain version to the bit")
                del got, ref
            bound_ms, bound_by, nbytes = k1_bound(block, sample_bytes, N_FRAMES, raster, demod,
                                                  taps, exact)
            parts = k1_bound_parts(block, sample_bytes, N_FRAMES, raster, demod, taps, exact)
            ms = time_call(torch, lambda: kernel(data, v_starts, *raster, residuals, taps))
            b2b_ms = time_back_to_back(
                torch, lambda: kernel(data, v_starts, *raster, residuals, taps))
            plain_ms = time_call(
                torch, lambda: frames_to_screens_plain(
                    data if name == "envelope" else tp.am_envelope_from_iq(data),
                    v_starts, geom, residuals, taps), calls=5)
            again_ms = time_back_to_back(torch, lambda: kernel(data, starts, *raster))
            measured[name, taps, exact] = dict(err=err, ms=ms, b2b_ms=b2b_ms, plain_ms=plain_ms,
                                               bound_ms=bound_ms, bound_by=bound_by,
                                               bytes_bound_ms=parts["bytes"],
                                               instruction_bound_ms=parts["instructions"])
            print(f"[K1 {name}, {label}] {ms:.4f} ms single call, {b2b_ms:.4f} ms back to back "
                  f"per {N_FRAMES}-frame block (2 taps, rounded cuts, timed right after: "
                  f"{again_ms:.4f}); bound {bound_ms:.4f} ms, by {bound_by} (bytes "
                  f"{parts['bytes']:.4f} ms for {nbytes / 1e6:.1f} MB, instructions "
                  f"{parts['instructions']:.4f} ms), share reached {bound_ms / b2b_ms:.3f} back "
                  f"to back; plain {plain_ms:.4f} ms, on {card}")
        for shape in OTHER_SHAPES[:2] + OTHER_SHAPES[3:]:
            other = (frame_len, mode.height, mode.width, shape)
            got = frames_to_screens(env[: short], edge_starts, *other,
                                    None if residuals is None else residuals[:3].contiguous(), taps)
            ref = frames_to_screens_plain(
                env[: short], edge_starts, screen_geometry(*other, dev),
                None if residuals is None else residuals[:3].contiguous(), taps)
            torch.cuda.synchronize()
            print(f"[K1 envelope, {label}] {shape[0]}x{shape[1]} screens: max abs diff "
                  f"{float((got - ref).abs().max()):.3e}")
            check(bool(torch.equal(got, ref)),
                  f"K1, {label}, at {shape} equals its plain version to the bit")

    # The shapes auto_reconstruct gives K1 on 640x480 @ 60 Hz at 32 Msps.
    small_mode = tp.ALL_VIDEO_MODES[SMALL_MODE_NAME]
    small_spf = SMALL_SAMPLE_RATE / small_mode.refresh
    small_n = int(SMALL_SAMPLE_RATE * SMALL_SECONDS)
    small_frames = int((small_n - 1) / small_spf)
    small_words = {
        kind: quantise(tp.generate_iq(small_mode, SMALL_SAMPLE_RATE, small_n, snr_db=SNR_DB,
                                      seed=SEED, modulation=kind).iq)
        for kind in ("am", "fm")}
    small_raster = (int(np.floor(small_spf)), small_mode.height, small_mode.width, (h, w))
    small_starts = torch.from_numpy(
        np.round(np.arange(small_frames) * small_spf).astype(np.int32)).to(dev)
    small_i16 = {kind: torch.from_numpy(small_words[kind]).to(dev) for kind in ("am", "fm")}
    small_env = tp.am_envelope_from_iq(small_i16["am"])
    small_geom = screen_geometry(*small_raster, dev)
    # The 4-tap rows as auto_reconstruct launches them there (phase 8): the
    # int16 words under the AM and the FM load, their kernels-line numbers
    # with the slice's as secondary; and the envelope entry on the AM capture.
    measured_small = {}
    for name, fn, data, demod in (
            ("envelope", frames_to_screens, small_env, None),
            ("int16 words", frames_to_screens_from_words, small_i16["am"], "am"),
            ("FM int16 words", frames_to_screens_from_words, small_i16["fm"], "fm")):
        def plain(data=data, demod=demod):
            env = data if demod is None else resample_kernel.words_envelope_plain(data, demod)
            return frames_to_screens_plain(env, small_starts, small_geom, None, 4)

        call = functools.partial(fn, data, small_starts, *small_raster, None, 4,
                                 **({} if demod is None else {"demod": demod}))
        got, ref = call(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        print(f"[K1 {name}, 4 taps] {small_frames} frames of {SMALL_MODE_NAME} at "
              f"{SMALL_SAMPLE_RATE / 1e6:g} Msps: max abs diff {err:.3e}")
        check(got.shape == (small_frames, h, w) and bool(torch.equal(got, ref)),
              f"K1 on {name}, 4 taps, at the 640x480 shapes equals its plain version to the bit")
        del got, ref
        n_small = small_env.shape[0]
        word = 0 if demod is None else resample_kernel.word_code(data.dtype, demod)[0]
        bound_ms, bound_by, nbytes = k1_bound(n_small, 4, small_frames, small_raster, word, 4)
        parts = k1_bound_parts(n_small, 4, small_frames, small_raster, word, 4)
        m = dict(err=err, ms=time_call(torch, call), b2b_ms=time_back_to_back(torch, call),
                 device_ms=kernels_device_ms(torch, call, ("catmull_rom_tiles_kernel",))[
                     "catmull_rom_tiles_kernel"],
                 plain_ms=time_call(torch, plain, calls=5),
                 bound_ms=bound_ms, bound_by=bound_by, bytes_bound_ms=parts["bytes"],
                 instruction_bound_ms=parts["instructions"])
        check(m["device_ms"] > 0, f"the profiler traced K1's 4-tap kernel on {name}")
        measured_small[name] = m
        print(f"[K1 {name}, 4 taps] {small_frames} frames of {SMALL_MODE_NAME} at "
              f"{SMALL_SAMPLE_RATE / 1e6:g} Msps: {m['ms']:.4f} ms single call, "
              f"{m['b2b_ms']:.4f} ms back to back, {m['device_ms']:.4f} ms of device time; "
              f"bound {bound_ms:.4f} ms, by {bound_by} (bytes {parts['bytes']:.4f} ms for "
              f"{nbytes / 1e6:.1f} MB, instructions {parts['instructions']:.4f} ms), share "
              f"reached {bound_ms / m['b2b_ms']:.3f} back to back, "
              f"{bound_ms / m['device_ms']:.3f} of device time; plain {m['plain_ms']:.4f} ms, "
              f"on {card}")
    small_fm = resample_kernel.words_envelope_plain(small_i16["fm"], "fm")
    fm_rows_sweep(torch, card, resample_kernel,
                  f"{small_frames} frames of {SMALL_MODE_NAME}, 4 taps",
                  functools.partial(frames_to_screens_from_words, small_i16["fm"], small_starts,
                                    *small_raster, None, 4, demod="fm"),
                  frames_to_screens_plain(small_fm, small_starts, small_geom, None, 4))
    del small_fm
    if args.parent is not None:
        # The FM row at these shapes against the parent's kernel, in turns.
        import importlib

        parent_rk = importlib.import_module(
            f"{load_other(Path(args.parent)).__name__}.ops.resample_kernel")
        label = (f"{small_frames} frames of {SMALL_MODE_NAME} at {SMALL_SAMPLE_RATE / 1e6:g} "
                 f"Msps, 4 taps")
        fm_vs_parent(
            torch, card, parent_rk, resample_kernel,
            {label: lambda mod: mod.frames_to_screens_from_words(
                small_i16["fm"], small_starts, *small_raster, None, 4, demod="fm")},
            {label: measured_small["FM int16 words"]["bound_ms"]}, "int16 FM")
    del small_env, small_i16

    # ---- 6. the fidelity runtime: exact cuts through K1's residuals, sync skipped
    seen.clear()
    poff.demodulate = counted_demodulate
    demod_calls.clear()
    fid_gpu, fid_sync, fid_devices, seconds = run_runtime(tp, blocks, mode, dev, fidelity=True)
    poff.demodulate = demodulate
    fidelity_launches = seen["k1", 2, True, "am", False]
    fidelity_folds = seen["k3", None, True]
    check(seen["k2"] == 0
          and fidelity_folds == seen["k3"] == fidelity_launches,
          f"the fidelity chain runs no sync and K3's fold alone once a block "
          f"({dict(seen)}, K2 {seen['k2']})")
    check(fidelity_launches >= N_BLOCKS
          and k1_launches(seen, "words") == fidelity_launches
          and k1_launches(seen, "envelope") == 0 and not demod_calls,
          f"K1's fused entry with residuals launched for every fidelity block "
          f"({dict(seen)}), nothing else")
    check(fid_devices and all(d == "cuda" for d in fid_devices),
          "every fidelity step output on the card")
    check(fid_gpu.shape == (h, w) and bool(np.isfinite(fid_gpu).all()) and not fid_sync.any(),
          "fidelity EMA finite, of the screen's shape, sync stage skipped")
    print(f"[fidelity runtime] {N_BLOCKS} blocks through process_blocks in {seconds:.3f} s "
          f"({1e3 * seconds / N_BLOCKS:.2f} ms per block incl. ring copy and upload), K1 "
          f"launches with residuals {fidelity_launches}, K3 folds {fidelity_folds}, K2 0")
    t0 = time.perf_counter()
    fid_cpu, _, _, _ = run_runtime(tp, blocks, mode, "cpu", fidelity=True)
    fid_rel = float(np.abs(fid_gpu - fid_cpu).max()) / float(fid_cpu.max() - fid_cpu.min())
    print(f"[fidelity runtime] CPU run {time.perf_counter() - t0:.1f} s; card vs CPU: EMA max "
          f"diff {fid_rel:.3e} of range (tolerance {EMA_REL_TOL:g})")
    check(fid_rel < EMA_REL_TOL, "fidelity card EMA matches the CPU run")
    fid_db, fid_shift = tp.aligned_psnr(truth, fid_gpu)
    print(f"[fidelity runtime] aligned PSNR {fid_db:.3f} dB (bar {FIDELITY_PSNR_BAR_DB} dB), "
          f"shift {fid_shift}")
    check(fid_db > FIDELITY_PSNR_BAR_DB, "fidelity PSNR clears the bar")

    seen.clear()
    fid4_gpu, _, _, _ = run_runtime(tp, blocks[:1], mode, dev, fidelity=True,
                                    config_overrides={"interp_taps": 4})
    fidelity4_launches = seen["k1", 4, True, "am", False]
    check(fidelity4_launches >= 1 and k1_launches(seen, "words") == fidelity4_launches,
          f"K1's fused entry with residuals and 4 taps launched ({fidelity4_launches})")
    fid4_cpu, _, _, _ = run_runtime(tp, blocks[:1], mode, "cpu", fidelity=True,
                                    config_overrides={"interp_taps": 4})
    fid4_rel = float(np.abs(fid4_gpu - fid4_cpu).max()) / float(fid4_cpu.max() - fid4_cpu.min())
    print(f"[fidelity runtime, 4 taps] 1 block, launches {fidelity4_launches}; card vs CPU: "
          f"EMA max diff {fid4_rel:.3e} of range")
    check(bool(np.isfinite(fid4_gpu).all()) and fid4_rel < EMA_REL_TOL,
          "fidelity 4-tap card EMA matches the CPU run")

    # ---- 7. auto_reconstruct: capture in, detected mode and restored screen out
    auto_words = words[: 2 * block]      # 0.62 s as int16 words
    seen.clear()
    timing, recon = tp.auto_reconstruct(auto_words, SAMPLE_RATE, alpha=ALPHA)
    auto_launches = seen["k1", 2, False, "am", False]
    check(auto_launches == 1 and k1_launches(seen, "words") == 1
          and k1_launches(seen, "envelope") == 0,
          f"auto_reconstruct went through K1's fused entry once ({auto_launches})")
    cpu_timing = tp.estimate_timing(auto_words, SAMPLE_RATE, device="cpu")
    print(f"[auto] {timing.mode_name}, refresh {timing.refresh_hz:.6f} Hz, line count "
          f"{timing.line_count:.6f} (CPU run of the port: {cpu_timing.refresh_hz:.6f} Hz, "
          f"{cpu_timing.line_count:.6f}), SNR proxy {timing.snr_db:.3f} dB, "
          f"{recon.frames.shape[0]} frames")
    check(timing.mode_name == MODE_NAME == cpu_timing.mode_name, "auto_reconstruct names the mode")
    check(abs(timing.refresh_hz - mode.refresh) < REFRESH_TOL_HZ,
          f"refresh within {REFRESH_TOL_HZ} Hz of the capture's")
    check(abs(timing.line_count - cpu_timing.line_count) < LINES_TOL
          and abs(timing.refresh_hz - cpu_timing.refresh_hz) < 1e-3,
          "card and CPU choose the same line period and frame period")
    check(recon.image.shape == (h, w) and recon.frames.shape == (N_FRAMES, h, w)
          and bool(np.isfinite(recon.image).all()) and bool(np.isfinite(recon.image_raw).all()),
          "auto_reconstruct images finite, of the screen's shape")
    auto_db, _ = tp.aligned_psnr(truth, recon.image)
    raw_db, _ = tp.aligned_psnr(truth, recon.image_raw)
    print(f"[auto] aligned PSNR restored {auto_db:.3f} dB, raw {raw_db:.3f} dB "
          f"(bar for the raw image {PSNR_BAR_DB} dB)")
    check(raw_db > PSNR_BAR_DB, "auto_reconstruct's raw image clears the PSNR bar")
    auto_dev = torch.from_numpy(auto_words).to(dev)
    auto_cfg = tp.ReconstructionConfig(sample_rate=SAMPLE_RATE, mode=timing.mode,
                                       n_frames=N_FRAMES, align_subpixel=True)
    stage1_ms = wall_ms(torch, lambda: tp.estimate_timing(auto_dev, SAMPLE_RATE))
    stage2_ms = wall_ms(torch, lambda: tp.reconstruct_frames(auto_dev, auto_cfg, alpha=ALPHA))
    restore_ms = wall_ms(torch, lambda: tp.restore_image(recon.image_raw, auto_cfg))
    whole_ms = wall_ms(torch, lambda: tp.auto_reconstruct(auto_words, SAMPLE_RATE, alpha=ALPHA))
    print(f"[auto] stage 1 {stage1_ms:.2f} ms, stage 2 {stage2_ms:.2f} ms (words on the card, "
          f"results read back), restoration {restore_ms:.2f} ms, the whole call from host "
          f"int16 words {whole_ms:.2f} ms, wall clock, median of 3, on {card}")
    # Where stage 2's wall clock goes: its step alone, and reading the 36
    # frames back to the host; and stage 1's share of device time.
    auto_step = tp.make_reconstruct_fn(
        dataclasses.replace(auto_cfg, input_format="iq_interleaved"), dev)
    ema_zero = torch.zeros((h, w), dtype=torch.float32, device=dev)
    n_words = 2 * auto_cfg.block_samples
    step_out = auto_step(auto_dev[:n_words], ema_zero, ALPHA)
    auto_step_ms = wall_ms(torch, lambda: auto_step(auto_dev[:n_words], ema_zero, ALPHA))
    readback_ms = wall_ms(torch, lambda: [t.cpu() for t in step_out])
    upload_ms = wall_ms(torch, lambda: torch.from_numpy(auto_words).to(dev))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp.estimate_timing(auto_dev, SAMPLE_RATE)
        torch.cuda.synchronize()
    stage1_kernels = sum(evt.count for evt in prof.key_averages()
                         if evt.device_type == DeviceType.CUDA)
    print(f"[auto] stage 2's step alone {auto_step_ms:.2f} ms, its read-back of frames, sync, "
          f"score and EMA {readback_ms:.2f} ms, upload of the int16 words {upload_ms:.2f} ms; "
          f"stage 1 device time {device_ms(prof):.3f} ms in {stage1_kernels} kernels, on {card}")
    del auto_dev, step_out

    # ---- 8. auto_reconstruct where the taps rule picks 4, AM and FM
    small_launches = {}
    for kind in ("am", "fm"):
        seen.clear()
        t, r = tp.auto_reconstruct(small_words[kind], SMALL_SAMPLE_RATE, alpha=ALPHA, demod=kind)
        small_launches[kind] = seen["k1", 4, False, kind, False]
        print(f"[auto, {kind}] {t.mode_name} at {SMALL_SAMPLE_RATE / 1e6:g} Msps, refresh "
              f"{t.refresh_hz:.6f} Hz, line count {t.line_count:.4f}, {r.frames.shape[0]} frames, "
              f"4-tap launches {small_launches[kind]}")
        check(t.mode_name == SMALL_MODE_NAME, f"auto_reconstruct ({kind}) names the mode")
        check(abs(t.refresh_hz - small_mode.refresh) < REFRESH_TOL_HZ,
              f"auto_reconstruct ({kind}) refresh within {REFRESH_TOL_HZ} Hz")
        check(small_launches[kind] == 1
              and k1_launches(seen, "envelope") + k1_launches(seen, "words") == 1,
              f"auto_reconstruct ({kind}) went through K1's 4-tap words load with its demod "
              f"once ({dict(seen)})")
        check(r.frames.shape[0] == small_frames,
              f"auto_reconstruct ({kind}) rendered the {small_frames} frames phase 5 timed")
        check(r.image.shape == (h, w) and bool(np.isfinite(r.image).all()),
              f"auto_reconstruct ({kind}) image finite, of the screen's shape")

    # ---- 9-11. the wideband path: scan, combine offline and live, the tasks
    combine_launches, wide = phase_offline_wideband(tp, torch, dev, card, seen)
    combine_launches.update(phase_live_wideband(
        tp, torch, dev, card, seen, [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    phase_tasks(tp, torch, dev, card, blocks, mode)

    # ---- 12-16. the operator surface: batched serving, the mode search, every
    # resampler name, the command line and the web view, the roofline count
    batched = phase_batched(tp, torch, dev, card, words, seen, activities, args.parent)
    search = phase_search(tp, torch, dev, card, words_f32, seen)
    named = phase_resamplers(tp, torch, dev, card, words_i16, truth, seen)
    phase_cli_and_web(tp, torch, dev, card, seen)
    phase_roofline(tp, torch, dev, card, words_i16)

    # ---- 17-19. the mesh: time shards on one card (m), candidate and carrier
    # shards on one card (n), several cards in one process and on NCCL ranks (o)
    mesh_out = phase_mesh_one_card(tp, torch, dev, card, seen, loop, truth, activities)
    mesh_launches = phase_mesh_candidates_and_carriers(tp, torch, dev, card, seen,
                                                       words_f32, wide)
    del wide
    phase_several_cards(tp, torch, card, seen, loop, mesh_out["reference"], activities)

    # ---- the step on device-resident words, demod fused and as a pass of its own
    step = tp.make_reconstruct_fn(cfg, dev)
    ema0 = torch.zeros((h, w), dtype=torch.float32, device=dev)
    phase0 = poff.carry_phase_starts(0.0, spf, N_FRAMES)

    def unfused_step(iq, ema, alpha):
        fstarts = torch.from_numpy(phase0).to(dev)
        frames, sync, score = poff.process_frames(
            poff.demodulate(iq, cfg), fstarts, cfg, frame_len)
        return poff.ema_fold(ema, frames, alpha), frames, sync, score

    fused_ema = step(words_i16, ema0, ALPHA, 0.0)[0]
    unfused_ema = unfused_step(words_i16, ema0, ALPHA)[0]
    step_diff = float((fused_ema - unfused_ema).abs().max())
    print(f"[step] EMA with the demod fused vs as a separate pass: max abs diff {step_diff:.3e}")
    check(step_diff <= K1_REL_TOL * float(unfused_ema.abs().max()),
          "the step with the demod fused equals the step with the demod as a pass")
    for name, data in (("int16", words_i16), ("float32", words_f32)):
        step_ms = time_call(torch, lambda: step(data, ema0, ALPHA, 0.0), calls=10)
        unfused_ms = time_call(torch, lambda: unfused_step(data, ema0, ALPHA), calls=10)
        print(f"[step] {step_ms:.3f} ms per {N_FRAMES}-frame block on device-resident {name} "
              f"words = {block / step_ms / 1e3:.1f} Msamples/s (demod as a separate pass: "
              f"{unfused_ms:.3f} ms), on {card}")

    fid_step = tp.make_reconstruct_fn(fidelity_config(tp), dev)
    for name, data in (("int16", words_i16), ("float32", words_f32)):
        fid_ms = time_call(torch, lambda: fid_step(data, ema0, ALPHA, VARIANT_PHASE), calls=10)
        print(f"[fidelity step] {fid_ms:.3f} ms per {N_FRAMES}-frame block on device-resident "
              f"{name} words = {block / fid_ms / 1e3:.1f} Msamples/s, on {card}")

    # Device time by kernel over three steps: the step's busy share and split.
    for name, fn in (("demod as a separate pass", lambda: unfused_step(words_i16, ema0, ALPHA)),
                     ("demod fused into K1", lambda: step(words_i16, ema0, ALPHA, 0.0)),
                     ("fidelity step", lambda: fid_step(words_i16, ema0, ALPHA, VARIANT_PHASE))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        dev_step, launches = step_device_ms(device_by_kernel(prof, 3))
        print(f"[profile] {name}, int16 words: device time {dev_step:.4f} ms per step in "
              f"{launches} kernels")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    # ---- 21. the default step stage by stage, with the kernels and with their
    # plain versions in their place
    phase_step_split(tp, torch, dev, card, words_i16, activities)

    # ---- 22. the repo's bench and entry-point programs in the port
    entry_points = phase_entry_points(tp, torch, dev, card, seen)

    # ---- 23. stage 1 inside K1's words load: the bfloat16 rounding, the FM
    # discriminator; the mxu3 and FM steps; the bench line beside the parent's
    stage1 = phase_stage1(tp, torch, dev, card, words_i16, blocks, seen, args.parent,
                          activities)

    # ---- 24. invert inside K1's words load: the block maximum, the inverted
    # loads, the slice's inverted step beside the pass route and the parent's
    inverted = phase_invert(tp, torch, dev, card, words_i16, seen, args.parent,
                            activities)

    def kernel_entry(name, key, launches):
        m = key if isinstance(key, dict) else measured[key]
        return {
            "name": name,
            "route": "cuda",
            "source": "tempest_tpu_torch/csrc/resample.cu",
            "replaces": "tempest_tpu/ops/pallas_resample.py:143",
            "launches": launches,
            "max_abs_err": m["err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": None,  # no single PyTorch call computes this function
            "back_to_back_ms": m["b2b_ms"],
        }

    def taps4_entry(name, key, launches, small=None):
        """A 4-tap row: its own kernel since the redesign, its bound the larger
        of bytes and instructions, both given.  ``key`` is a key of phase 5's
        measurements or a measurement.  With ``small``, the numbers at the
        640x480 shapes its path launches (phase 5's last part), and the
        slice's as ``slice_*``."""
        m = key if isinstance(key, dict) else measured[key]
        if small is None:
            return dict(kernel_entry(name, key, launches), redesigned=True,
                        source_kernel="catmull_rom_tiles_kernel",
                        bytes_bound_ms=m["bytes_bound_ms"],
                        instruction_bound_ms=m["instruction_bound_ms"])
        s = measured_small[small]
        return dict(kernel_entry(name, s, launches), redesigned=True,
                    source_kernel="catmull_rom_tiles_kernel",
                    shapes=f"{small_frames} frames of {SMALL_MODE_NAME} at "
                           f"{SMALL_SAMPLE_RATE / 1e6:g} Msps onto {h}x{w}",
                    device_ms=s["device_ms"], bytes_bound_ms=s["bytes_bound_ms"],
                    instruction_bound_ms=s["instruction_bound_ms"],
                    slice_ms=m["ms"], slice_back_to_back_ms=m["b2b_ms"],
                    slice_plain_ms=m["plain_ms"], slice_bound_ms=m["bound_ms"],
                    slice_bound_by=m["bound_by"], slice_bytes_bound_ms=m["bytes_bound_ms"],
                    slice_instruction_bound_ms=m["instruction_bound_ms"])

    words_entry = kernel_entry("K1 frames_to_screens_from_words", "float32 words", fused_launches)
    # The runtime uploads float32 words, so the main path launches that
    # instantiation and the keys above are its numbers; the int16 one's:
    i16 = measured["int16 words"]
    words_entry.update(int16_max_abs_err=i16["err"], int16_ms=i16["ms"],
                       int16_back_to_back_ms=i16["b2b_ms"], int16_plain_ms=i16["plain_ms"],
                       int16_bound_ms=i16["bound_ms"], mesh_launches=mesh_out["default"])
    # Each variant under the instantiation its main path launched: the
    # fidelity runtime uploads float32 words, auto_reconstruct was handed
    # int16 words, and its FM chain demodulates first.  All timed at the
    # slice's shapes (36 frames of 1080p60 at 20 Msps).
    # The envelope entry also carries the combine paths, at the channel rate:
    # once per combined_reconstruct, once a block of the live combine front.
    # Its main path since the words load took invert: the live combine front
    # (phase 10, a block each).
    envelope_entry = kernel_entry("K1 frames_to_screens", "envelope", combine_launches["default"])
    envelope_entry.update(
        combine_offline_launches=combine_launches["offline"],
        combine_live_launches=combine_launches["default"],
        mesh_combined_reconstruct_launches=mesh_launches["combined"])
    residual_envelope = measured["envelope", 2, True]
    envelope_entry.update(
        combine_live_fidelity_launches=combine_launches["fidelity"],
        residuals_ms=residual_envelope["ms"], residuals_back_to_back_ms=residual_envelope["b2b_ms"],
        residuals_max_abs_err=residual_envelope["err"])
    kernels = [
        envelope_entry,
        words_entry,
        dict(kernel_entry("K1 frames_to_screens_from_words, residuals (float32 words)",
                          ("float32 words", 2, True), fidelity_launches),
             mesh_launches=mesh_out["fidelity"]),
        taps4_entry("K1 frames_to_screens_from_words, 4 taps (int16 words)",
                    ("int16 words", 4, False), small_launches["am"], "int16 words"),
        taps4_entry("K1 frames_to_screens_from_words, 4 taps, residuals (float32 words)",
                    ("float32 words", 4, True), fidelity4_launches),
        # 4 taps on an envelope: complex input (its demod stays a pass), at
        # the slice's shapes.
        taps4_entry("K1 frames_to_screens, 4 taps (envelope)",
                    ("envelope", 4, False), stage1["launches"]["complex 4 taps"]),
        # The operator surface's paths: 144 frames of 4 streams in one launch
        # a batched step; one launch over the candidates of the mode search,
        # at a 150x200 grid (one a shard of the sharded search); one launch a
        # block under an mxu name on complex input (on words, the words load).
        kernel_entry("K1 frames_to_screens_from_words, batched step (int16 words, 144 frames)",
                     batched["static cuts"], batched["static cuts"]["launches"]),
        kernel_entry("K1 frames_to_screens_from_words, batched step, residuals "
                     "(int16 words, 144 frames)", batched["carry_phase, exact cuts"],
                     batched["carry_phase, exact cuts"]["launches"]),
        dict(kernel_entry("K1 frames_to_screens_candidates, mode search (envelope, 26 "
                          "candidates x 2 frames at 150x200, quantised tables, one launch)",
                          search, search["launches"]),
             device_ms=search["device_ms"], mesh_search_launches=mesh_launches["search"],
             per_candidate_ms=search["per_candidate_ms"],
             per_candidate_back_to_back_ms=search["per_candidate_back_to_back_ms"],
             per_candidate_device_ms=search["per_candidate_device_ms"],
             search_ms=search["search_ms"], refine_ms=search["refine_ms"]),
        kernel_entry("K1 frames_to_screens, quantised table (envelope, mxu3 on complex input)",
                     named["quantised"], named["quantised"]["launches"]),
        # One frame onto 600x800, one launch (bench_all's scenario 3).
        dict(kernel_entry("K1 frame_to_screen, one frame (envelope, 2 taps)", f2s,
                          entry_points["frame_to_screen_launches"]),
             replaces="tempest_tpu/ops/pallas_resample.py:238", redesigned=True,
             device_ms=f2s["device_ms"], host_us=f2s["host_us"], tile_plans=f2s["plans"],
             **({"parent": f2s["parent"]} if "parent" in f2s else {})),
    ]
    # Stage 1 inside K1's words load (phase 23), each load under the word type
    # and taps its main path launched, timed at the slice's shapes.
    for name, key, launches in (
            ("AM rounded to bfloat16, residuals (int16 words): the bench chain, mxu3",
             ("int16 words", "am", True, 2, True), stage1["launches"]["bench"]),
            ("AM rounded to bfloat16 (float32 words): the runtime under mxu3",
             ("float32 words", "am", True, 2, False), stage1["launches"]["runtime mxu3"]),
            ("FM (int16 words): the slice's FM step, make_reconstruct_fn(demod='fm')",
             ("int16 words", "fm", False, 2, False), stage1["launches"]["fm step int16"]),
            ("FM (float32 words): the runtime under demod='fm'",
             ("float32 words", "fm", False, 2, False), stage1["launches"]["runtime fm"]),
            ("FM rounded to bfloat16 (float32 words): the runtime under FM and mxu3",
             ("float32 words", "fm", True, 2, False), stage1["launches"]["runtime fm mxu3"])):
        m = stage1["measured"][key]
        kernels.append(dict(kernel_entry(f"K1 frames_to_screens_from_words, {name}", m, launches),
                            device_ms=m["device_ms"], added_in="stage 1 in the words load"))
    # FM with 4 taps: auto_reconstruct(demod='fm') at 640x480 (phase 8), timed
    # there in phase 5 and at the slice's shapes in phase 23.
    kernels.append(dict(taps4_entry(
        "K1 frames_to_screens_from_words, FM, 4 taps (int16 words): "
        "auto_reconstruct(demod='fm') at 640x480",
        stage1["measured"]["int16 words", "fm", False, 4, False], small_launches["fm"],
        "FM int16 words"), added_in="stage 1 in the words load"))
    # invert in the words load (phase 24; the runtime's in phases 4 and 23)
    # and the batched step's new routes (phase 12): the block maximum, a
    # launch of its own, and K1's inverted instantiations.
    maxima = inverted["maxima"]
    for name, key, launches in (
            ("block maximum words_max_kernel (int16 words, AM): the slice's step under invert",
             ("int16 words", "am"), inverted["launches"]["2 taps, block maximum"]),
            ("block maximum words_max_kernel (float32 words, AM): the runtime with invert",
             ("float32 words", "am"), max_launches)):
        m = maxima[key]
        fm = maxima[key[0], "fm"]
        kernels.append({
            "name": name, "route": "cuda", "source": "tempest_tpu_torch/csrc/resample.cu",
            "replaces": "tempest_tpu/pipeline/offline.py:498", "launches": launches,
            "max_abs_err": m["err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "library_ms": None,
            "back_to_back_ms": m["b2b_ms"], "device_ms": m["device_ms"],
            "torch_max_of_envelope_ms": m["torch_max_ms"], "fm_ms": fm["ms"],
            "fm_device_ms": fm["device_ms"], "fm_bound_ms": fm["bound_ms"],
            "bytes_bound_ms": m["bytes_bound_ms"],
            "instruction_bound_ms": m["instruction_bound_ms"],
            "fm_bytes_bound_ms": fm["bytes_bound_ms"],
            "fm_instruction_bound_ms": fm["instruction_bound_ms"],
            "added_in": "invert in the words load"})
    for name, m, launches in (
            ("AM inverted (float32 words): the runtime with invert",
             inverted["measured"]["float32 words", "am", False, 2, False], invert_launches),
            ("AM inverted, 4 taps (float32 words): the runtime with invert and 4 taps",
             inverted["measured"]["float32 words", "am", False, 4, False],
             stage1["launches"]["runtime invert 4 taps"]),
            ("AM inverted (int16 words): the slice's step under invert",
             inverted["measured"]["int16 words", "am", False, 2, False],
             inverted["launches"]["2 taps"]),
            ("AM inverted, rounded to bfloat16 (int16 words): mxu3 with invert",
             inverted["measured"]["int16 words", "am", True, 2, False],
             inverted["launches"]["mxu3"]),
            ("FM (int16 words), batched step of 4 streams, 144 frames", batched["FM"],
             batched["FM"]["launches"]),
            ("AM inverted (int16 words), batched step of 4 streams, 144 frames",
             batched["invert"], batched["invert"]["launches"])):
        kernels.append(dict(kernel_entry(f"K1 frames_to_screens_from_words, {name}", m, launches),
                            device_ms=m["device_ms"], added_in="invert and streams in the words "
                                                               "load"))
    # K2 and K3, timed at the slice's 36 screens of 600x800 (phase 20); their
    # launches are the runtime's over its 3 blocks (phase 3) and the fidelity
    # runtime's (phase 6).  No single PyTorch call computes either function:
    # library_ms is null; K3's entry also gives one torch.tensordot of the
    # EMA's weighted sum alone.
    for key, name, source, replaces, launches, extra in (
            (("K2", True), "K2 blanking_sync, sub-pixel (K2a profiles + K2b search)",
             "tempest_tpu_torch/csrc/sync.cu", "tempest_tpu/ops/framesync.py:239", k2_launches,
             {"integer_ms": sync_align["K2", False]["ms"],
              "integer_back_to_back_ms": sync_align["K2", False]["b2b_ms"],
              "integer_plain_ms": sync_align["K2", False]["plain_ms"],
              "integer_max_abs_err": sync_align["K2", False]["err"]}),
            (("K3", "linear"), "K3 align_fold, linear alignment with the EMA fold",
             "tempest_tpu_torch/csrc/align_ema.cu",
             "tempest_tpu/ops/framesync.py:302 and tempest_tpu/pipeline/offline.py:664",
             k3_launches,
             {"fold_only_launches_fidelity": fidelity_folds,
              "fold_only_ms": sync_align["K3", None]["ms"],
              "fold_only_back_to_back_ms": sync_align["K3", None]["b2b_ms"],
              "fold_only_plain_ms": sync_align["K3", None]["plain_ms"],
              "fold_only_bound_ms": sync_align["K3", None]["bound_ms"],
              "fold_only_device_ms": sync_align["K3", None]["device_ms"]})):
        m = sync_align[key]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": m["err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "back_to_back_ms": m["b2b_ms"], "device_ms": m["device_ms"],
        }
        entry["redesigned"] = True
        if key[0] == "K2":
            entry.update(score_max_rel_err=m["score_rel"], k2a_device_ms=m["k2a_device_ms"],
                         k2b_device_ms=m["k2b_device_ms"], k2a_bound_ms=m["k2a_bound_ms"],
                         k2b_bound_ms=m["k2b_bound_ms"], k2b_bound_by=m["k2b_bound_by"])
        else:
            entry.update(tensordot_ema_ms=m["tensordot_ms"], tensordot_ema_rel_err=m["lib_rel"])
        entry.update(extra)
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
