"""The sharded pipelines in PyTorch — the counterpart of
``tempest_tpu/parallel/sharded.py``: one stream's timeline split into time
spans over a device mesh, B streams split over it, video-mode hypotheses
split over it, and the carriers of a wideband capture split over it; and
the static mode search, which runs on one device.

Every function is a per-shard function on one device plus the collectives
of ``parallel.mesh`` (``from_next``, ``all_gather``, ``all_reduce_sum``,
``all_reduce_min``, ``mean``), so the same code runs on a one-process mesh
(``make_mesh``: a loop over the shards, collectives as copies between their
devices) and on a mesh of one process a shard (``distributed.global_mesh``:
NCCL or gloo).  Outputs are replicated: they are placed on ``mesh.device``,
the first shard's device of this process.

**Time shards.**  The timeline is laid out as ``(n_shards, S)``: consecutive,
non-overlapping spans of S samples.  Each shard reconstructs the frames that
start in its span from its span plus a *halo*, the head of the next span
(``from_next``; the JAX package's ``ppermute``), with the port's
single-device chain: AM demod inside K1's load, K1, sub-pixel sync (K2) and
alignment fused with the fold (K3), or exact cuts with the residuals in K1
and K3's fold alone.  So each kernel runs once on every shard.  The
exponential average is a linear recurrence ``e' = α e + (1-α) f``: a span of
F frames acts on the carried image as ``e' = A e + B`` with ``A = α^F`` and
``B`` the span's EMA from zero.  Each shard computes its ``B``, one
``all_gather`` brings them together, and the fold ``e_d = A·e_{d-1} + B_d``
runs in time order.  ``A`` is the float32 tensor power that K3's fold takes
(``ops.align_kernel.fold_weights``) and ``B`` what K3's fold returns from a
zero image: its sum over the span's frames, which the single-device step
adds to ``A·e``.  So a mesh step is the same float32 arithmetic as the
single-device step on blocks of S samples, span by span: equal to the bit.

**Candidate shards.**  Each shard scores its slice of the candidate modes on
the same envelope: one K1 launch over its candidates
(``frames_to_screens_candidates``: every candidate's line table,
unquantised, the exact-geometry read of the JAX package's
``frame_to_screen_dynamic``), one batched ``frame_sync``; the winner is the
argmax over the gathered scores.

**Carrier shards.**  The capture's spectrum is computed once on the first
device; each shard takes its carriers' band slices, and channelises and
scores them.  The sweep needs no collective; the fusion needs five small
ones (:func:`_combine_local_builder`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.combine import CombineResult, _demod_channels, _gated_weights, _row_stats
from ..ops.demod import am_envelope_from_iq
from ..ops.framesync import frame_sync
from ..ops.resample import RENDER_SIZE, round_to_bfloat16
from ..ops.resample_kernel import frames_to_screens_candidates
from ..ops.scan import (
    ScanResult,
    _band_slices,
    _band_starts,
    _channel_geometry,
    _channels_from_bands,
    _comb_contrast,
    _demod_rows,
    _noise_floor,
    _spectrum,
    _words,
    check_excise_demod,
)
from ..pipeline.offline import (
    ReconstructionConfig,
    _check_supported,
    _process_and_fold,
    demodulate,
    fuses_demod,
    make_batched_reconstruct_fn,
    make_reconstruct_fn,
)
from ..utils.device import as_tensor
from ..utils.profiling import annotate, count, enabled
from ..video.modes import VideoMode
from .mesh import Mesh, block_sharding, replicated

__all__ = [
    "ModeSearchResult",
    "mode_search_static",
    "sharded_reconstruct_fn",
    "sharded_streaming_reconstruct_fn",
    "sharded_batched_reconstruct_fn",
    "sharded_mode_search",
    "sharded_mode_search_2d",
    "sharded_scan_band",
    "sharded_combine_harmonics",
    "sharded_combined_reconstruct_fn",
    "sharded_streaming_combine_front",
]


@dataclasses.dataclass
class ModeSearchResult:
    best_index: int
    best_mode: VideoMode
    scores: np.ndarray       # (n_candidates,) sync contrast per hypothesis
    names: list[str]


def mode_search_static(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, VideoMode]],
    n_frames: int = 2,
    score_size: tuple[int, int] = (150, 200),
    num_phases: int = 16,
    device: torch.device | str | None = None,
) -> ModeSearchResult:
    """Hypothesis search over candidate video modes on ``device`` (``None``:
    where a tensor lies, else the CUDA card; raises when there is none).

    For each candidate ``(y_t, x_t)``, render ``n_frames`` frames of the
    capture on a reduced ``score_size`` grid and take the two-axis
    ``frame_sync`` contrast, mean over the frames; the best-scoring
    candidate wins.  Blanking contrast discrimination doesn't need render
    fidelity, hence the small grid and the coarse ``num_phases``.

    ``iq`` is complex samples, or a real signal taken as an envelope that is
    demodulated already.  The AM envelope is taken once and rounded to
    bfloat16 (as the JAX package's select matmuls round it, so that the
    scores compare); then ONE K1 launch renders every candidate's frames
    with its own phase-quantised line table (``frames_to_screens_candidates``:
    the candidates' tables stacked on the card once per set, as the JAX
    program stacks them over the candidates), and one batched ``frame_sync``
    scores all C·F screens.  Where the JAX program pads each frame with its
    last sample, K1 reads on into the next frame: the bottom row of a screen
    may differ, the scores barely."""
    if not candidates:
        raise ValueError("empty candidate set")
    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(n_frames) * spf).astype(np.int64)
    need = int(starts[-1]) + frame_len + 1
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        words = np.ascontiguousarray(iq[:need], np.complex64).view(np.float32)
        env = am_envelope_from_iq(as_tensor(words, device))
    else:
        sig = as_tensor(iq, device)
        env = sig.abs().to(torch.float32)
    if env.shape[0] < need:
        raise ValueError(f"need {need} samples for the mode search, got {env.shape[0]}")
    env = round_to_bfloat16(env[:need]).contiguous()
    fstarts = torch.from_numpy(starts.astype(np.int32)).to(env.device)
    screens = frames_to_screens_candidates(
        env, fstarts, frame_len, [(m.height, m.width) for _, m in candidates],
        tuple(score_size), num_phases)                             # [C, F, h, w]
    _, _, score = frame_sync(screens.reshape(-1, *screens.shape[2:]))
    return _search_result(score.reshape(len(candidates), n_frames).mean(dim=1).cpu().numpy(),
                          candidates)


# ------------------------------------------------------------- time shards
def _as_rows(iq, config: ReconstructionConfig):
    """Rows of I/Q as the step reads them, and the config for that format:
    host complex rows become interleaved float32 words (the upload stays
    real), real rows under a complex config are taken as words — as
    ``reconstruct_frames`` does."""
    if config.input_format == "iq_planar":
        raise ValueError("the sharded steps take complex, interleaved or envelope rows, "
                         "not iq_planar")
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        return iq, dataclasses.replace(config, input_format="iq_interleaved")
    if config.input_format == "complex64" and not (isinstance(iq, torch.Tensor) and iq.is_complex()):
        return iq, dataclasses.replace(config, input_format="iq_interleaved")
    return iq, config


def _words_per_sample(config: ReconstructionConfig) -> int:
    return 2 if config.input_format == "iq_interleaved" else 1


def _span_frames(config, ext, starts, alpha):
    """The single-device chain on one shard's window at int32 frame
    ``starts``, folded from a zero image: (B, frames, sync, score).  Words
    go to K1's words entry where ``fuses_demod`` says so (AM or FM, rounded
    where the resampler rounds, inverted under ``invert``): FM's 0 then lands
    on the window's first sample and the inversion divides by the window's
    maximum, where ``demodulate(ext)`` puts them."""
    frame_len = int(np.floor(config.samples_per_frame))
    fstarts = torch.from_numpy(starts).to(ext.device)
    from_words = fuses_demod(config, ext)
    zero = torch.zeros(config.render_size, dtype=torch.float32, device=ext.device)
    return _process_and_fold(ext if from_words else demodulate(ext, config), fstarts, config,
                             frame_len, zero, alpha, from_words=from_words)


def _grid_span(config, ext, d: int, S: int, alpha):
    """(B, frames, sync, score) of span ``d`` of a timeline cut into spans of
    S samples, read from ``ext`` (the span and its halo): frame starts on the
    global grid, whose first boundary lies ``(-d·S) % spf`` into the span,
    in float64 and rounded as the JAX step states it, ``floor(phase + spf·k
    + 0.5)``; ``B`` the span's EMA from zero."""
    spf = config.samples_per_frame
    phase = (-(d * S)) % spf
    starts = np.floor(phase + spf * np.arange(config.n_frames, dtype=np.float64)
                      + 0.5).astype(np.int32)
    return _span_frames(config, ext, starts, alpha)


def _ema_combine(mesh: Mesh, axis: str, b_parts, ema, alpha, n_frames: int) -> torch.Tensor:
    """The associative EMA combine: gather every span's ``B`` and fold
    ``e_d = A·e_{d-1} + B_d`` in time order on ``mesh.device``, with ``A``
    the float32 tensor power of K3's fold."""
    b_all = mesh.comm.all_gather(b_parts, axis)[0]
    a = torch.as_tensor(alpha, dtype=torch.float32, device=mesh.device)
    big_a = a ** n_frames
    out = as_tensor(ema, mesh.device).to(torch.float32)
    for b in b_all:
        out = big_a * out + b
    return out


def _time_shard_outputs(mesh, axis, outs, ema, alpha, n_frames):
    """(ema', frames, sync, score) of a time-sharded step from each shard's
    (B, frames, sync, score)."""
    b_parts, f_parts, s_parts, c_parts = zip(*outs)
    ema_out = _ema_combine(mesh, axis, list(b_parts), ema, alpha, n_frames)
    return (ema_out, mesh.gather(list(f_parts), axis), mesh.gather(list(s_parts), axis),
            mesh.gather(list(c_parts), axis))


def sharded_batched_reconstruct_fn(config: ReconstructionConfig, mesh: Mesh, axis: str = "blocks"):
    """Serving parallelism: B independent I/Q streams, the stream axis split
    over the mesh — each shard runs ``make_batched_reconstruct_fn`` on its
    slice of the streams (one K1 launch for all of them), with no
    collective.  Returns ``step(iq[B, ...], ema[B, h, w], alpha[, phases])``
    like ``make_batched_reconstruct_fn``; B must be a multiple of the mesh
    size."""
    n = mesh.shape[axis]
    steps = {dev: make_batched_reconstruct_fn(config, device=dev) for dev in set(mesh.devices)}
    place = block_sharding(mesh, axis).place

    def _split(x, per):
        return x.reshape(n, per, *x.shape[1:])

    def _run(iq_b, ema_b, alpha, phases=None):
        if len(iq_b) % n:
            raise ValueError(f"{len(iq_b)} streams do not split over {n} shards")
        per = len(iq_b) // n
        parts = [place(_split(x, per)) for x in (iq_b, ema_b)]
        if phases is not None:
            phases = np.asarray(phases, np.float64).reshape(n, per)
        outs = []
        for i, (k, dev) in enumerate(mesh.shards()):
            extra = () if phases is None else (phases[mesh.coord(k, axis)],)
            outs.append(steps[dev](parts[0][i], parts[1][i], alpha, *extra))
        return tuple(mesh.gather(list(p), axis) for p in zip(*outs))

    if config.carry_phase:

        def step(iq_b, ema_b, alpha, phases):
            return _run(iq_b, ema_b, alpha, phases)

    else:

        def step(iq_b, ema_b, alpha):
            return _run(iq_b, ema_b, alpha)

    return step


def sharded_reconstruct_fn(config: ReconstructionConfig, mesh: Mesh, axis: str = "blocks"):
    """The multi-device reconstruction step over one capture's timeline.

    Returns ``step(iq_shards, ema, alpha) -> (ema', frames, sync, score)``
    with ``iq_shards`` of shape ``(n_shards, S)``: consecutive,
    non-overlapping spans (complex samples, interleaved words or an
    envelope), ``n_shards`` the mesh axis's size.  The timeline is circular
    (a file replay loops): the last shard's halo is the stream's head.

    Per shard: its span and the halo from the next, frame starts on the
    global grid (frames tick at multiples of spf from the stream's start;
    span d's first boundary lies ``(-d·S) % spf`` in), computed in float64
    on the host and rounded as the JAX step states it, ``floor(phase + spf·k
    + 0.5)``; AM demod and K1, sync, alignment, the span's EMA from zero;
    then the EMA combine.  ``config.n_frames`` is the frames per shard.
    ``step.n_shards`` and ``step.shard_samples_min`` expose the geometry."""
    _check_supported(config)
    n_shards = mesh.shape[axis]
    n_frames = config.n_frames
    spf = config.samples_per_frame
    shard_samples_min = int(np.ceil(n_frames * spf))
    # The single-device carry-phase step's window for n_frames: the span
    # plus its halo is at least that.
    block_need = dataclasses.replace(config, carry_phase=True).block_samples

    def step(iq_shards, ema, alpha):
        rows, cfg = _as_rows(iq_shards, config)
        u = _words_per_sample(cfg)
        S = int(rows.shape[1]) // u
        if rows.shape[0] != n_shards:
            raise ValueError(f"{rows.shape[0]} rows for a mesh of {n_shards} shards")
        if S < shard_samples_min:
            raise ValueError(f"shards have {S} samples; need ≥ {shard_samples_min} "
                             f"for {n_frames} frames")
        overlap = max(block_need - S, 1)
        if overlap > S:
            raise ValueError(f"halo ({overlap}) exceeds the shard ({S}); use larger "
                             "shards or fewer frames per shard")
        spans = block_sharding(mesh, axis).place(rows)
        halos = mesh.comm.from_next([p[: u * overlap] for p in spans], axis)
        outs = [_grid_span(cfg, torch.cat([span, halo]), mesh.coord(k, axis), S, alpha)
                for (k, _), span, halo in zip(mesh.shards(), spans, halos)]
        return _time_shard_outputs(mesh, axis, outs, ema, alpha, n_frames)

    step.n_shards = n_shards
    step.shard_samples_min = shard_samples_min
    return step


def sharded_streaming_reconstruct_fn(config: ReconstructionConfig, mesh: Mesh, shard_samples: int,
                                     axis: str = "blocks"):
    """The live multi-device step: one source block split into ``n_shards``
    consecutive spans of ``shard_samples``, with the carried frame phase of
    each span from the host — the step ``MeshStreamingRuntime`` feeds block
    after block.

    Returns ``step(rows, tail, ema, alpha, phases) -> (ema', frames, sync,
    score)``: ``rows`` ``(n_shards, u·S)`` (interleaved float32 words, u = 2,
    or an envelope, u = 1), ``tail`` the next block's first ``u·overlap``
    values, which are the last shard's halo (there is no circular wrap), and
    ``phases`` ``(n_shards,)`` float64, each span's fractional offset to its
    next frame boundary.  Each shard's cuts are the single-device step's own
    (``pipeline.offline._cut_fn``): rounded starts in the f32 arithmetic of
    ``carry_phase_starts``, or with ``subsample_align`` float64 exact cuts
    whose residuals K1 takes.  Each shard runs ``make_reconstruct_fn(config)``
    on the first ``config.block_samples`` samples of its span and halo,
    exactly the window that the single-device runtime uploads from a block
    of S samples, so the step equals that runtime span by span, to the bit.
    ``n_shards``, ``n_frames``, ``overlap`` and ``shard_samples`` expose the
    geometry."""
    if not config.carry_phase:
        raise ValueError("sharded_streaming_reconstruct_fn needs config.carry_phase=True "
                         "(the streaming grid)")
    if config.input_format not in ("iq_interleaved", "envelope"):
        raise ValueError("the streaming mesh step takes 'iq_interleaved' or 'envelope' rows "
                         "(real device boundaries)")
    n_shards = mesh.shape[axis]
    u = _words_per_sample(config)
    S = int(shard_samples)
    block_need = config.block_samples
    overlap = max(block_need - S, 1)
    if overlap > S:
        raise ValueError(f"halo ({overlap}) exceeds the shard ({S}); use larger shards or "
                         "fewer frames per shard")
    window = u * block_need
    steps = {dev: make_reconstruct_fn(config, dev) for dev in set(mesh.devices)}

    def step(rows, tail, ema, alpha, phases):
        phases = np.asarray(phases, np.float64)
        # Only what the windows read goes to the devices: the span, or its
        # first block_need samples when the span holds the whole window.
        with annotate("mesh.place"):
            spans = block_sharding(mesh, axis).place(rows[:, : u * min(S, block_need)])
        if enabled():
            count("mesh.place.bytes", sum(p.nbytes for p in spans))
        with annotate("mesh.halo"):
            halos = mesh.comm.from_next([p[: u * overlap] for p in spans], axis)
        outs = []
        for (k, dev), span, halo in zip(mesh.shards(), spans, halos):
            with annotate("mesh.shard"):
                d = mesh.coord(k, axis)
                if d == n_shards - 1:
                    halo = as_tensor(tail, dev)
                ext = span[:window] if block_need <= S else torch.cat([span, halo])[:window]
                outs.append(steps[dev](ext, torch.zeros(config.render_size, device=dev), alpha,
                                       float(phases[d])))
        with annotate("mesh.combine"):
            return _time_shard_outputs(mesh, axis, outs, ema, alpha, config.n_frames)

    step.n_shards = n_shards
    step.n_frames = config.n_frames
    step.overlap = overlap
    step.shard_samples = S
    return step


# -------------------------------------------------------- candidate shards
def _padded_candidate_arrays(candidates: list[tuple[str, VideoMode]],
                             n_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Candidate (height, width) arrays padded to a multiple of the shard
    count (the pad repeats the last candidate; scores beyond the real set are
    discarded by the callers)."""
    y_arr = np.array([m.height for _, m in candidates], np.float32)
    x_arr = np.array([m.width for _, m in candidates], np.float32)
    pad = (-len(candidates)) % n_shards
    if pad:
        y_arr = np.concatenate([y_arr, np.repeat(y_arr[-1:], pad)])
        x_arr = np.concatenate([x_arr, np.repeat(x_arr[-1:], pad)])
    return y_arr, x_arr


def _candidate_scores(env, starts: np.ndarray, frame_len: int, ys, xs, render_size) -> torch.Tensor:
    """Mean sync contrast over the frames of each candidate (y_t, x_t): one
    K1 launch over the candidates with their unquantised line tables, one
    batched ``frame_sync`` over all the screens."""
    fstarts = torch.from_numpy(starts.astype(np.int32)).to(env.device)
    screens = frames_to_screens_candidates(env, fstarts, frame_len, list(zip(ys, xs)),
                                           tuple(render_size))
    _, _, score = frame_sync(screens.reshape(-1, *screens.shape[2:]))
    return score.reshape(len(ys), len(starts)).mean(dim=1)


def _search_result(scores: np.ndarray, candidates) -> "ModeSearchResult":
    best = int(np.argmax(scores))
    return ModeSearchResult(best_index=best, best_mode=candidates[best][1], scores=scores,
                            names=[n for n, _ in candidates])


def sharded_mode_search(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, VideoMode]],
    mesh: Mesh,
    axis: str = "blocks",
    n_frames: int = 2,
    render_size: tuple[int, int] = RENDER_SIZE,
) -> "ModeSearchResult":
    """Score every candidate video mode on the same signal, the candidates
    split over the mesh; the best sync contrast wins.

    ``iq``: complex samples (host complex is uploaded as interleaved float32
    words) or a demodulated real envelope.  The envelope is taken once on
    ``mesh.device`` and copied to the other shards' devices; each shard
    renders its candidates in one K1 launch at ``render_size`` with their
    exact line tables and scores them in one batched ``frame_sync``."""
    if not candidates:
        raise ValueError("empty candidate set")
    n = mesh.shape[axis]
    y_arr, x_arr = _padded_candidate_arrays(candidates, n)
    per = len(y_arr) // n
    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(n_frames) * spf).astype(np.int64)
    need = int(starts[-1]) + frame_len
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        words = np.ascontiguousarray(iq[:need], np.complex64).view(np.float32)
        env = am_envelope_from_iq(as_tensor(words, mesh.device))
    else:
        env = as_tensor(iq[:need], mesh.device).abs().to(torch.float32)
    if env.shape[0] < need:
        raise ValueError(f"need {need} samples for the mode search, got {env.shape[0]}")
    parts = []
    for (k, _), e in zip(mesh.shards(), replicated(mesh).place(env)):
        sl = slice(mesh.coord(k, axis) * per, (mesh.coord(k, axis) + 1) * per)
        parts.append(_candidate_scores(e, starts, frame_len, y_arr[sl], x_arr[sl], render_size))
    scores = mesh.gather(parts, axis).cpu().numpy()[: len(candidates)]
    return _search_result(scores, candidates)


def sharded_mode_search_2d(
    iq: np.ndarray,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, VideoMode]],
    mesh: Mesh,
    time_axis: str = "blocks",
    mode_axis: str = "modes",
    frames_per_shard: int = 1,
    render_size: tuple[int, int] = RENDER_SIZE,
) -> "ModeSearchResult":
    """Hypothesis search over a 2-D mesh: the timeline split along
    ``time_axis`` and the candidate modes along ``mode_axis`` at once.  Each
    shard scores its candidates on its time span (frames from the span's
    start); a ``mean`` over the time axis averages the scores, so every
    candidate is judged on ``n_time × frames_per_shard`` frames."""
    if not candidates:
        raise ValueError("empty candidate set")
    n_time, n_mode = mesh.shape[time_axis], mesh.shape[mode_axis]
    y_arr, x_arr = _padded_candidate_arrays(candidates, n_mode)
    per = len(y_arr) // n_mode
    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(frames_per_shard) * spf).astype(np.int64)
    span = int(starts[-1]) + frame_len
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        env = np.abs(iq).astype(np.float32)
    else:
        env = np.asarray(iq, np.float32)
    if env.shape[0] < n_time * span:
        raise ValueError(f"need {n_time * span} samples for {n_time} time shards, "
                         f"got {env.shape[0]}")
    parts = []
    for (k, _), e in zip(mesh.shards(), block_sharding(mesh, time_axis).place(
            env[: n_time * span].reshape(n_time, span))):
        m = mesh.coord(k, mode_axis)
        parts.append(_candidate_scores(e, starts, frame_len, y_arr[m * per:(m + 1) * per],
                                       x_arr[m * per:(m + 1) * per], render_size))
    parts = mesh.comm.mean(parts, time_axis)
    scores = mesh.gather(parts, mode_axis).cpu().numpy()[: len(candidates)]
    return _search_result(scores, candidates)


# ---------------------------------------------------------- carrier shards
def _carrier_layout(centers: np.ndarray, fs: float, N: int, M: int,
                    n_dev: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-carrier slice starts into the capture spectrum (the carrier's bin
    minus M/2, mod N: ``ops.scan._band_starts``, the channeliser's own
    rounding) plus carrier indices, both padded to a multiple of the mesh
    axis (pads repeat carrier 0 and get indices ≥ K, so downstream gating
    discards them).  One definition for every carrier-sharded path."""
    starts = _band_starts(centers, fs, N, M)
    pad = (-len(centers)) % n_dev
    starts_p = np.concatenate([starts, np.repeat(starts[:1], pad)])
    kidx_p = np.arange(len(centers) + pad, dtype=np.int64)
    return starts_p, kidx_p


def _carrier_channels(mesh: Mesh, axis: str, iq_words, fs: float, centers: np.ndarray,
                      chan_bw: float, excise_db: float | None, n_samples: int | None = None):
    """Each shard's slice of the carriers as complex channels on its device,
    and their carrier indices: the spectrum once on ``mesh.device``, the band
    slices to the shards.  Returns (channels, indices, (N, M, fs_channel))."""
    words = _words(iq_words, mesh.device)
    n_c = int(words.shape[0]) // 2 if n_samples is None else int(n_samples)
    N, M, fs_chan = _channel_geometry(n_c, fs, chan_bw)
    spec = _spectrum(words, N)
    starts_p, kidx_p = _carrier_layout(centers, fs, N, M, mesh.shape[axis])
    per = len(starts_p) // mesh.shape[axis]
    chans, kidxs = [], []
    for k, dev in mesh.shards():
        sl = slice(mesh.coord(k, axis) * per, (mesh.coord(k, axis) + 1) * per)
        bands = _band_slices(spec, starts_p[sl], M).to(dev, non_blocking=True)
        chans.append(_channels_from_bands(bands, N, excise_db))
        kidxs.append(torch.from_numpy(kidx_p[sl]).to(dev))
    return chans, kidxs, (N, M, fs_chan)


def sharded_scan_band(
    iq_words: np.ndarray | torch.Tensor,
    fs: float,
    centers_hz: np.ndarray,
    mesh: Mesh,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    demod: str = "am",
    excise_db: float | None = None,
) -> ScanResult:
    """Carrier scan with the candidate channels split over the mesh —
    hypothesis parallelism for ``ops.scan.scan_band``: each shard
    channelises and scores its own carriers (band slice, inverse FFT,
    envelope or discriminator, refresh-comb mass and prominence); channels
    are independent, so there is no collective.  The measured noise floor is
    the single-device sweep's (the port's host draws, once, on
    ``mesh.device``), so the result is ``scan_band``'s."""
    check_excise_demod(demod, excise_db)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    chans, _, (_, M, fs_chan) = _carrier_channels(mesh, axis, iq_words, float(fs), centers,
                                                  float(chan_bw), excise_db)
    scored = [_comb_contrast(_demod_rows(ch, demod), fs_chan, float(corr_seconds),
                             float(rate_min), float(rate_max)) for ch in chans]
    mass, prom, fv = (mesh.gather(list(p), axis).cpu().numpy().astype(np.float64)[:K]
                      for p in zip(*scored))
    floor = _noise_floor(fs_chan, M, float(corr_seconds), float(rate_min), float(rate_max),
                         demod=demod, device=mesh.device)
    return ScanResult(centers_hz=centers, scores_db=mass, prominence_db=prom, refresh_hz=fv,
                      fs_channel=fs_chan, floor_db=np.full(K, float(floor)))


_NO_CARRIER = 2 ** 30


def _combine_local_builder(mesh: Mesh, axis: str, K: int, fs_chan: float, corr_seconds: float,
                           rate_min: float, rate_max: float, weighting: str, fv_known):
    """The carrier-sharded fusion: ``local(amps, kidxs) -> (env, weights,
    polarity, mass_db, refresh)``, each a list with one tensor per shard,
    from every shard's demodulated channels ``amps`` (K_local, M) and their
    carrier indices.  The per-channel statistics and weight formulas are
    ``ops.combine``'s (``_row_stats``, ``_gated_weights``); the decisions
    that need every channel come from five small collectives:

    * ``all_gather`` of each channel's comb mass and on-comb dot (2·K
      scalars): the anchor and the gates' maxima;
    * ``all_reduce_sum`` of the one-hot-selected anchor envelope (M values):
      every shard reads its channels' polarity against it;
    * ``all_reduce_sum`` of the weights' mass;
    * ``all_reduce_min`` of the first gated carrier's index and
      ``all_reduce_sum`` of its sign: the output polarity is re-based to it,
      as ``combine_core`` does (no gated carrier: carrier 0, as there);
    * ``all_reduce_sum`` of the weighted envelopes and of their DC.

    ``fv_known`` is None for the full per-channel scoring with the lag-1 MRC,
    or the refresh for the known-refresh scoring with the robust MRC."""
    comm = mesh.comm

    def local(amps, kidxs):
        stats = [_row_stats(a, fs_chan, corr_seconds, rate_min, rate_max, fv_known) for a in amps]
        valid = [kidx < K for kidx in kidxs]
        keys = [torch.stack([
            torch.where(v, st.mass_db, float("-inf")),
            torch.where(v, st.mass_db if st.comb is None else st.comb, float("-inf"))])
            for st, v in zip(stats, valid)]
        every = [g.permute(1, 0, 2).reshape(2, -1) for g in comm.all_gather(keys, axis)]
        anchors = [torch.argmax(e[0]) for e in every]
        anchor_env = comm.all_reduce_sum(
            [(kidx == a).to(torch.float32) @ st.env0
             for kidx, a, st in zip(kidxs, anchors, stats)], axis)
        pols, weights = [], []
        for st, v, e, ae in zip(stats, valid, every, anchor_env):
            dots = torch.mv(st.env0, ae)
            pols.append(torch.where(dots >= 0.0, 1.0, -1.0).to(torch.float32))
            w = _gated_weights(st, weighting, torch.max(e[1]), torch.max(e[0]))
            weights.append(torch.where(v, w, torch.zeros_like(w)))
        wsum = comm.all_reduce_sum([torch.sum(w) for w in weights], axis)
        weights = [w / torch.clamp(s, min=1e-30) for w, s in zip(weights, wsum)]
        first = comm.all_reduce_min(
            [torch.min(torch.where(w > 0.0, kidx, torch.full_like(kidx, _NO_CARRIER)))
             for w, kidx in zip(weights, kidxs)], axis)
        first = [torch.where(f == _NO_CARRIER, torch.zeros_like(f), f) for f in first]
        sign = comm.all_reduce_sum(
            [torch.sum(torch.where(kidx == f, p, torch.zeros_like(p)))
             for kidx, f, p in zip(kidxs, first, pols)], axis)
        pols = [p * s for p, s in zip(pols, sign)]
        env = comm.all_reduce_sum([torch.mv(st.env0.T, w * p)
                                   for st, w, p in zip(stats, weights, pols)], axis)
        dc = comm.all_reduce_sum([torch.sum(w * st.mean[:, 0])
                                  for st, w in zip(stats, weights)], axis)
        return ([x + c for x, c in zip(env, dc)], weights, pols,
                [st.mass_db for st in stats], [st.fv for st in stats])

    return local


def sharded_combine_harmonics(
    iq_words: np.ndarray | torch.Tensor,
    fs: float,
    centers_hz: np.ndarray,
    mesh: Mesh,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    refresh_hz: float | str | None = "auto",
    demod: str = "am",
    excise_db: float | None = None,
) -> CombineResult:
    """Multi-harmonic combining with the carriers split over the mesh —
    channel parallelism for ``ops.combine.combine_harmonics``, with its
    arguments and result.  Each shard channelises, demodulates and scores its
    carriers; the fusion's global decisions come from the small collectives
    of :func:`_combine_local_builder` (about 2·M values a call, whatever K).
    ``refresh_hz="auto"`` runs the two passes of ``combine_harmonics``, the
    second at the anchor's refresh quantised to a whole frame period."""
    check_excise_demod(demod, excise_db)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    chans, kidxs, (_, _, fs_chan) = _carrier_channels(mesh, axis, iq_words, float(fs), centers,
                                                      float(chan_bw), excise_db)
    amps = [_demod_channels(ch, demod) for ch in chans]

    def run_pass(fv_known):
        local = _combine_local_builder(mesh, axis, K, float(fs_chan), float(corr_seconds),
                                       float(rate_min), float(rate_max), weighting, fv_known)
        env, *rest = local(amps, kidxs)
        return (env[0], *(mesh.gather(p, axis)[:K].cpu().numpy().astype(np.float64)
                          for p in rest))

    env, w, pol, mass, fv = run_pass(None if refresh_hz == "auto" else refresh_hz)
    if refresh_hz == "auto" and weighting == "mrc":
        fv_anchor = float(fv[int(np.argmax(mass))])
        # Integer-frame-period quantisation, as combine_harmonics does.
        fv_anchor = fs_chan / round(fs_chan / fv_anchor)
        env, w, pol, _, _ = run_pass(fv_anchor)
    return CombineResult(envelope=env.cpu().numpy().astype(np.float32), fs_channel=float(fs_chan),
                         centers_hz=centers, weights=w, polarity=pol, mass_db=mass, refresh_hz=fv)


def _combine_front(mesh, axis, fs, n_samples, centers_hz, refresh_hz, chan_bw, weighting, demod,
                   excise_db):
    """The known-refresh carrier-sharded front of one block: ``front(words)
    -> (env per shard, weights, polarity, mass)``, and its geometry
    (N, M, fs_channel).  The comb lags are read at the refresh quantised to
    a whole frame period, the gate band ±5 Hz around it."""
    check_excise_demod(demod, excise_db)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    K = len(centers)
    geometry = _channel_geometry(int(n_samples), fs, chan_bw)
    fs_chan = geometry[2]
    fv_q = fs_chan / round(fs_chan / float(refresh_hz))
    local = _combine_local_builder(mesh, axis, K, fs_chan, 0.1, max(fv_q - 5.0, 20.0), fv_q + 5.0,
                                   weighting, fv_q)

    def front(words):
        chans, kidxs, _ = _carrier_channels(mesh, axis, words, fs, centers, chan_bw, excise_db,
                                            n_samples)
        env, w, pol, mass, _ = local([_demod_channels(ch, demod) for ch in chans], kidxs)
        return env, *(mesh.gather(p, axis)[:K] for p in (w, pol, mass))

    return front, geometry


def sharded_combined_reconstruct_fn(
    config: ReconstructionConfig,
    mesh: Mesh,
    fs: float,
    n_samples: int,
    centers_hz: np.ndarray,
    refresh_hz: float,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    weighting: str = "mrc",
    demod: str = "am",
    excise_db: float | None = None,
):
    """Fused reconstruction over one mesh: the combine front with the
    CARRIERS split over the shards, whose fused envelope (replicated: every
    shard holds it after the fusion's ``all_reduce_sum``) is then cut into
    consecutive TIME spans, one a shard, and reconstructed as
    :func:`sharded_reconstruct_fn` does (circular halo, EMA combine) — carriers
    to time without leaving the devices.

    ``config``: the chain at the CHANNEL rate (``sample_rate`` = the
    channeliser's ``fs·M/N``; ``input_format="envelope"``; ``n_frames`` per
    shard).  ``n_samples``: complex samples per input block (sets the FFT
    geometry).  ``refresh_hz``: the screen's refresh.  Returns
    ``step(words, ema, alpha) -> (ema', frames, sync, score, weights,
    polarity)``, ``words`` the block's interleaved float32 I/Q."""
    _check_supported(config)
    n_shards = mesh.shape[axis]
    front, (_, M, fs_chan) = _combine_front(mesh, axis, fs, n_samples, centers_hz, refresh_hz,
                                            chan_bw, weighting, demod, excise_db)
    if abs(config.sample_rate - fs_chan) > 1e-6 * fs_chan:
        raise ValueError(f"config.sample_rate {config.sample_rate} != channel rate {fs_chan} "
                         f"(= fs·M/N for n_samples={n_samples}, chan_bw={chan_bw})")
    if config.input_format != "envelope":
        raise ValueError("config.input_format must be 'envelope' — the chain consumes the "
                         "fused envelope")
    S = M // n_shards
    shard_samples_min = int(np.ceil(config.n_frames * config.samples_per_frame))
    if S < shard_samples_min:
        raise ValueError(f"per-shard envelope span ({S}) < {config.n_frames} frame periods "
                         f"({shard_samples_min}) — larger blocks or fewer frames per shard")
    overlap = max(dataclasses.replace(config, carry_phase=True).block_samples - S, 1)

    def step(words, ema, alpha):
        env, w, pol, _ = front(words)
        outs = []
        for (k, _), e in zip(mesh.shards(), env):
            # The envelope is on every shard: its span, and the halo from
            # the next span (the stream's head for the last one).
            d = mesh.coord(k, axis)
            nxt = ((d + 1) % n_shards) * S
            ext = torch.cat([e[d * S:(d + 1) * S], e[nxt: nxt + overlap]])
            outs.append(_grid_span(config, ext, d, S, alpha))
        return (*_time_shard_outputs(mesh, axis, outs, ema, alpha, config.n_frames), w, pol)

    step.n_shards = n_shards
    step.fs_channel = fs_chan
    step.shard_samples = S
    return step


def sharded_streaming_combine_front(
    fs: float,
    n_samples: int,
    centers_hz: np.ndarray,
    refresh_hz: float,
    mesh: Mesh,
    axis: str = "blocks",
    chan_bw: float = 4e6,
    weighting: str = "mrc",
    demod: str = "am",
    excise_db: float | None = None,
):
    """The carrier-sharded per-block combine front of the live mesh runtime:
    ``front(words) -> (env, weights, polarity, mass)``, all tensors on
    ``mesh.device``; the fused envelope stays there for
    :func:`sharded_streaming_reconstruct_fn` (``input_format="envelope"``),
    which takes it as the pending block and its head as the previous block's
    tail.  ``front.fs_channel``, ``front.n_fft`` and ``front.m_chan`` expose
    the geometry."""
    inner, (n_fft, m_chan, fs_chan) = _combine_front(
        mesh, axis, fs, n_samples, centers_hz, refresh_hz, chan_bw, weighting, demod, excise_db)

    def front(words):
        env, w, pol, mass = inner(words)
        return env[0], w, pol, mass

    front.fs_channel = fs_chan
    front.n_fft = n_fft
    front.m_chan = m_chan
    return front
