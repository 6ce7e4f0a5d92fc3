"""The reconstruction pipeline in PyTorch — the counterpart of
``tempest_tpu/pipeline/offline.py``: stage 1 (timing estimation), stage 2
(the reconstruction step) and ``auto_reconstruct``, capture in, detected
video mode and restored screen out; and the multi-harmonic entries
(``combined_reconstruct``, ``discover_screens``,
``reconstruct_all_emissions``), wideband capture in, one fused image per
screen out.

Stage 1, ``estimate_timing`` / ``timing_evidence``: envelope power → FFT
autocorrelation → refresh rate and total line count (``ops.autocorr``),
snapped to the closest known video mode.

Stage 2, one step on a block of I/Q:

1. demodulates it (``demodulate``): AM envelope or FM discriminator, from
   complex samples, interleaved words or planar I/Q — or takes an envelope
   that is demodulated already (``input_format="envelope"``, the combine
   front's fused envelope at the channel rate);
2. cuts it into frames: at rounded frame starts, or with
   ``subsample_align`` at ``floor`` of the true start with the fractional
   residual handed to the resampler (sub-sample-exact cuts); carried across
   blocks by the fractional phase of the first frame boundary
   (``carry_phase``);
3. resamples every frame from signal to screen with K1
   (``ops.resample_kernel.frames_to_screens``), which takes the residuals
   and 2 or 4 taps itself — or, for interleaved I/Q words under AM or FM,
   inverted or not (``fuses_demod``), does 1 and 3 in one pass with K1's
   fused entry (``frames_to_screens_from_words``; under ``invert`` after one
   launch of the block maximum), which gives the same values without
   writing the envelope.  Every ``resampler=`` name of the JAX package is
   accepted and keeps its values (``RESAMPLERS``): ``"gather"`` and
   ``"rows"`` are that package's gather formulation in plain PyTorch,
   ``"fft"`` its band-limited resampler on ``torch.fft``, and the ``mxu``
   names go through K1 with the line fractions quantised to ``num_phases``
   levels and, where the JAX formulation rounds the envelope to bfloat16,
   with that rounding too: inside K1's load on words, else one elementwise
   pass first;
4. finds each frame's sub-pixel blanking position: on the card with K2
   (``ops.sync_kernel``), two launches for all frames of the block;
5. aligns the frame by a fractional circular shift and
6. folds the frames into the carried EMA image: 5 and 6 in ONE launch of K3
   (``ops.align_kernel.align_fold``), which writes the aligned frames and the
   new EMA; ``ema_fold`` is its fold alone, the fidelity chain's route.

``step(iq, ema, alpha[, phase]) -> (ema, frames, sync, score)`` runs
eagerly on the device it was built for (the CUDA card unless the caller
names another); there is no jit and no vmap.
``make_batched_reconstruct_fn`` serves B streams in one step: their blocks
are one contiguous buffer, and all B·F frames go through ONE K1 launch, one
K2 call and one K3 launch, which folds each stream into its own EMA.

The step's issue never waits for the card.  Its cuts go up through a few
pinned host slots taken in turn, each copy on the step's stream (a slot is
written again once its own last copy has ended), and stages 3-6 come from a
plan kept per geometry (``_StepPlan``): a key's first step goes through the
kernels' wrappers, which check its tensors, and the steps after it issue the
plan's launches with cheap checks of what may differ from step to step, each
output a fresh tensor.  Every launch still goes through ``_build.launch``.

Frame positions.  The K1 routes compute exact-cut starts and residuals in
float64 on the host and hand K1 int32 starts and float32 residuals: at 36
frames of 333,333 samples a float32 position has a spacing of 1.0, so its
residual would be lost.  The JAX package's quantised fidelity plan keeps
this track in float64 too; its traced ``gather`` chain computes it in
float32, and so does the port's ``resampler="gather"`` with
``carry_phase``, so that it equals its JAX counterpart.

The multi-harmonic entries keep the fused envelope on the device from the
combiner to K1's envelope entry; only the returned ``CombineResult`` holds a
host copy.

``auto_reconstruct(refine_with_search=True)`` scores the video modes near
the measured refresh with ``parallel.sharded.mode_search_static`` (one
device).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import typing

import numpy as np
import torch

from ..ops.autocorr import (
    autocorrelation,
    estimate_line_count,
    estimate_refresh,
    estimate_snr,
    suggest_alpha,
    top_line_period_peaks,
    zoom_autocorr,
)
from ..ops.demod import (
    am_demod,
    am_demod_power,
    am_envelope_from_iq,
    am_envelope_from_iq_planar,
    am_power_from_iq,
    fm_demod,
    fm_demod_from_iq,
    fm_demod_from_iq_planar,
    invert_envelope,
    to_planar_iq,
)
from ..ops.combine import CombineResult, _combine_on_device
from ..ops.enhance import restore_image
from ..ops.align_kernel import _SHIFT_TYPES, align_fold, fold_weights
from ..ops.align_kernel import _prepare as _prepare_k3
from ..ops.sync_kernel import _prepare as _prepare_k2
from ..ops.sync_kernel import blanking_sync
from ..ops.resample import (
    RENDER_SIZE,
    frames_to_screens_fft,
    frames_to_screens_gather,
    round_to_bfloat16,
)
from ..ops.resample_kernel import (
    _ENVELOPE,
    _line_tables,
    _prepare_maxima,
    _words_load,
    frames_to_screens,
    frames_to_screens_from_words,
    line_reach,
)
from ..ops.resample_kernel import _prepare as _prepare_k1
from ..ops.scan import _channel_part, _words, scan_band, scan_centers
from ..utils.device import as_tensor as _as_tensor
from ..utils.device import resolve_device, staged_upload
from ..utils.profiling import annotate, count, enabled
from ..video.modes import VideoMode, candidate_modes, find_closest_mode, find_configuration

__all__ = [
    "TimingEstimate",
    "TimingEvidence",
    "ReconstructionConfig",
    "Reconstruction",
    "estimate_timing",
    "timing_evidence",
    "pick_line_peak",
    "auto_reconstruct",
    "exact_cut_starts",
    "demodulate",
    "fuses_demod",
    "process_frames",
    "ema_fold",
    "carry_phase_starts",
    "make_reconstruct_fn",
    "make_batched_reconstruct_fn",
    "reconstruct_frames",
    "RESAMPLERS",
    "combined_reconstruct",
    "discover_screens",
    "reconstruct_all_emissions",
]


@dataclasses.dataclass(frozen=True)
class TimingEstimate:
    refresh_hz: float
    line_count: float
    mode_name: str
    mode: VideoMode
    snr_db: float = float("nan")  # autocorrelation contrast proxy

    @property
    def suggested_alpha(self) -> float:
        """EMA coefficient matched to the measured SNR (see suggest_alpha)."""
        return float(suggest_alpha(self.snr_db)) if np.isfinite(self.snr_db) else 0.1


@dataclasses.dataclass(frozen=True)
class ReconstructionConfig:
    """Static parameters of a reconstruction step — the fields of the JAX
    package's config, with the same ``samples_per_frame`` and
    ``block_samples``.

    Fields that only choose a TPU formulation (``align_impl``, ``segments``,
    ``einsum_bf16``, ``frame_loop``, ``phase_bins``, ``fuse_demod_cut``) are
    accepted and change no value: the JAX package's ``align_impl="matmul"``
    is the roll form up to f32 reassociation, both frame loops give the same
    values (there is one loop-free formulation here), and K1 takes each
    frame's residual as it is, so there are no phase bins.  ``num_phases``
    sets the quantisation of the ``mxu`` resamplers' line fractions.
    """

    sample_rate: float
    mode: VideoMode
    n_frames: int
    render_size: tuple[int, int] = RENDER_SIZE
    invert: bool = False      # use the inverted, max-normalised envelope
    do_align: bool = True     # per-frame blanking sync + alignment
    align_subpixel: bool = False
    align_interp: str = "linear"  # "linear" (2-tap) or "cubic" (Catmull-Rom)
    align_impl: str = "matmul"
    # "complex64": iq is complex [block_samples]; "iq_interleaved": iq is
    # int16/float32 [2*block_samples] raw I/Q words; "iq_planar": iq is
    # int16/float32 [2, block_samples], row 0 = I (ops.demod.to_planar_iq);
    # "envelope": iq is float32 [block_samples], ALREADY demodulated (the
    # multi-harmonic fusion of ops.combine) — only ``invert`` applies.
    input_format: str = "complex64"
    demod: str = "am"         # "am" envelope or "fm" discriminator
    # "pallas" is K1, the counterpart of the JAX package's Pallas kernel and
    # the default here; "gather" is that package's gather formulation in
    # plain PyTorch (positions clipped into the frame, 2 taps only).  The
    # other names of the JAX package: see RESAMPLERS.
    resampler: str = "pallas"
    segments: int = 1
    num_phases: int = 64
    einsum_bf16: bool = False
    # Interpolation along the scan in K1: 2 = linear, 4 = Catmull-Rom.
    interp_taps: int = 2
    frame_loop: str = "vmap"
    # Sub-sample-exact frame cuts: each frame is cut at the floor of its
    # true start and the fractional residual moves the resampler's read
    # positions, instead of rounding the start to the nearest sample.
    subsample_align: bool = False
    # With carry_phase, step() takes the fractional sample offset of the
    # first frame boundary inside the block, so that frame cuts stay
    # continuous across blocks; the block holds one frame period of slack.
    carry_phase: bool = False
    phase_bins: int = 0
    fuse_demod_cut: bool = False

    @property
    def samples_per_frame(self) -> float:
        return self.sample_rate / self.mode.refresh

    @property
    def block_samples(self) -> int:
        """IQ samples consumed per call: n_frames frame periods plus slack —
        one sample for fractional cuts, plus a whole frame period of phase
        headroom when ``carry_phase`` is on."""
        slack = 1 + (int(np.ceil(self.samples_per_frame)) if self.carry_phase else 0)
        return int(np.ceil(self.samples_per_frame * self.n_frames)) + slack


class Resampler(typing.NamedTuple):
    """How one ``resampler=`` name is evaluated here."""

    route: str                    # "k1", or the plain formulations "gather" and "fft"
    quantised: bool = False       # line fractions quantised to num_phases levels
    bf16_envelope: bool = False   # envelope rounded to bfloat16 first
    takes_taps: bool = False      # honours config.interp_taps (else 2 taps)


# Every ``resampler=`` name of the JAX package.  "aligned" and "mxu_batched"
# are 2-tap formulations there whatever ``interp_taps`` says, and so here.
RESAMPLERS = {
    "pallas": Resampler("k1", takes_taps=True),
    "aligned": Resampler("k1"),
    "mxu": Resampler("k1", quantised=True, takes_taps=True),
    "mxu2": Resampler("k1", quantised=True, takes_taps=True),
    "mxu3": Resampler("k1", quantised=True, bf16_envelope=True, takes_taps=True),
    "mxu4": Resampler("k1", quantised=True, bf16_envelope=True, takes_taps=True),
    "mxu_batched": Resampler("k1", quantised=True, bf16_envelope=True),
    "gather": Resampler("gather"),
    "rows": Resampler("gather"),
    "fft": Resampler("fft"),
}
# Resamplers that take the residual of a sub-sample-exact cut: the JAX
# package's two, and K1 under its own name.
_EXACT_CUT_RESAMPLERS = ("pallas", "gather", "mxu3")


def _check_supported(config: ReconstructionConfig) -> None:
    """Raise for a config that names no known option."""
    if config.resampler not in RESAMPLERS:
        raise ValueError(
            f"unknown resampler {config.resampler!r}: one of {sorted(RESAMPLERS)}")
    if config.subsample_align and config.resampler not in _EXACT_CUT_RESAMPLERS:
        raise ValueError(
            "subsample_align needs a resampler that takes the boundary residual: "
            f"one of {_EXACT_CUT_RESAMPLERS}, not {config.resampler!r}")
    if config.frame_loop not in ("vmap", "scan"):
        raise ValueError(f"frame_loop must be 'vmap' or 'scan', got {config.frame_loop!r}")
    if config.input_format not in ("complex64", "iq_interleaved", "iq_planar", "envelope"):
        raise ValueError(f"unknown input_format {config.input_format!r}")
    if config.demod not in ("am", "fm"):
        raise ValueError(f"demod must be 'am' or 'fm', got {config.demod!r}")
    if config.interp_taps not in (2, 4):
        raise ValueError(f"interp taps must be 2 or 4, got {config.interp_taps}")
    if config.align_interp not in ("linear", "cubic"):
        raise ValueError(f"align_interp must be 'linear' or 'cubic', got {config.align_interp!r}")


@dataclasses.dataclass
class Reconstruction:
    image: np.ndarray        # EMA-averaged aligned frame (render_size)
    frames: np.ndarray       # per-frame aligned screens (n_frames, *render_size)
    sync: np.ndarray         # per-frame (s_y, s_x)
    score: np.ndarray        # per-frame sync contrast score
    # When MTF restoration ran (auto_reconstruct(restore=True)), ``image`` is
    # the restored screen and this keeps the raw EMA it was computed from.
    image_raw: np.ndarray | None = None

    @property
    def blanking_is_dark(self) -> bool:
        """Detected blanking polarity: after alignment the blanking interval
        sits along the top/left border; compare its level to the interior.
        True ⇒ blanking darker than content (display the image as-is);
        False ⇒ blanking brighter (real TEMPEST intermodulation often inverts
        video — render with ``invert=True`` for a natural-looking screen)."""
        h, w = self.image.shape
        bh, bw = max(h // 40, 2), max(w // 40, 2)
        border = float(
            np.concatenate([self.image[:bh].ravel(), self.image[:, :bw].ravel()]).mean())
        interior = float(self.image[h // 4 : -h // 4, w // 4 : -w // 4].mean())
        return border < interior


# ------------------------------------------------------------------ stage 1
def _timing_signal(iq, envelope: bool, device) -> tuple[torch.Tensor, bool]:
    """The estimators' input on ``device`` and whether it is interleaved
    words: host complex input goes up as float32 words (a zero-copy view), a
    tensor stays where it lies unless ``device`` names another place."""
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
    sig = _as_tensor(iq, device)
    return sig, not envelope and not sig.is_complex()


def _timing_kernel(sig: torch.Tensor, fs: float, corr_seconds: float, interleaved: bool,
                   rate_min: float, rate_max: float, envelope: bool):
    """(gamma, fv, y_t, snr) of one signal: what both stage-1 entries compute."""
    if envelope:
        env = sig.to(torch.float32)  # already demodulated
    elif interleaved:
        env = am_power_from_iq(sig)
    else:
        env = am_demod_power(sig)  # |z|^2 envelope
    gamma, _ = autocorrelation(env, fs, 0.0, corr_seconds)
    fv = estimate_refresh(gamma, fs, rate_min, rate_max)
    y_t = estimate_line_count(gamma, fs, fv, rate_min=rate_min, rate_max=rate_max)
    return gamma, fv, y_t, estimate_snr(env)


def _snap(fv: float, y_t: float, snr: float) -> TimingEstimate:
    """Snap the estimates to the closest known video mode.  Keeps the
    *measured* refresh (the true pixel clock differs from nominal) but the
    mode's pixel geometry."""
    name, mode = find_closest_mode(y_t, fv)
    return TimingEstimate(fv, y_t, name, VideoMode(mode.width, mode.height, fv), snr)


def estimate_timing(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    envelope: bool = False,
    device: torch.device | str | None = None,
) -> TimingEstimate:
    """Stage 1: refresh rate + line count from ~``corr_seconds`` of signal,
    snapped to the closest known video mode.

    ``iq`` may be complex64 or raw interleaved I/Q words (int16/float32, even
    length) — or, with ``envelope=True``, an already-demodulated real
    signal.  Runs on ``device`` (``None``: where a tensor lies, else the CUDA
    card; raises when there is none)."""
    sig, interleaved = _timing_signal(iq, envelope, device)
    _, fv, y_t, snr = _timing_kernel(sig, float(fs), float(corr_seconds), interleaved,
                                     float(rate_min), float(rate_max), envelope)
    return _snap(float(fv), float(y_t), float(snr))


@dataclasses.dataclass(frozen=True)
class TimingEvidence:
    """The correlation evidence behind a :class:`TimingEstimate`: the zoomed
    autocorrelation over the refresh band with the detected peak, and the
    line-period lag window with the detected line-rate peak."""

    rates_hz: np.ndarray       # refresh-band axis (descending, Hz)
    gamma_rates: np.ndarray    # 10log10|Γ|² over the refresh band
    refresh_hz: float          # detected peak (marked on the panel)
    line_lags: np.ndarray      # line-period lag axis [samples]
    gamma_lines: np.ndarray    # 10log10|Γ|² over the line-lag window
    line_lag: float            # detected line period [samples]
    line_count: float          # fs / (fv * line_lag)
    # Ranked alternative line-period peaks, rows (lag, y_t, comb score) —
    # the operator's recovery path when the automatic lock is wrong.
    line_peaks: np.ndarray | None = None

    def rate_mark(self) -> float:
        """Fractional x position of the refresh peak ON THE DRAWN PANEL: the
        panels plot the gamma arrays against INDEX and the rates axis is
        1/lag-spaced, so the mark is the peak's index fraction, not its
        rate-linear fraction."""
        r = np.asarray(self.rates_hz)
        i = int(np.argmin(np.abs(r - self.refresh_hz)))
        return i / max(len(r) - 1, 1)

    def line_mark(self) -> float:
        """Fractional x position of the line-period peak on the drawn
        panel (index space, as :meth:`rate_mark`)."""
        lags = np.asarray(self.line_lags)
        i = int(np.argmin(np.abs(lags - self.line_lag)))
        return i / max(len(lags) - 1, 1)


def timing_evidence(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    y_min: int = 200,
    y_max: int = 2500,
    envelope: bool = False,
    device: torch.device | str | None = None,
) -> tuple[TimingEstimate, TimingEvidence]:
    """Stage 1 with its evidence: the timing estimate plus the correlation
    windows it was read from, for rendering.  Same input conventions as
    :func:`estimate_timing`."""
    sig, interleaved = _timing_signal(iq, envelope, device)
    gamma, fv, y_t, snr = _timing_kernel(sig, float(fs), float(corr_seconds), interleaved,
                                         float(rate_min), float(rate_max), envelope)
    timing = _snap(float(fv), float(y_t), float(snr))
    fv_f, y_f = timing.refresh_hz, timing.line_count
    rates, g_rates = zoom_autocorr(gamma, fs, rate_min, rate_max)
    # Line-period window: the same bounds estimate_line_count searches.
    n = int(gamma.shape[0])
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    gamma_host = gamma.cpu().numpy()
    evidence = TimingEvidence(
        rates_hz=rates.cpu().numpy(),
        gamma_rates=g_rates.cpu().numpy(),
        refresh_hz=fv_f,
        line_lags=np.arange(lag_lo, lag_hi + 1, dtype=np.float64),
        gamma_lines=gamma_host[lag_lo : lag_hi + 1],
        line_lag=float(fs / (fv_f * y_f)),
        line_count=y_f,
        line_peaks=top_line_period_peaks(
            gamma_host, fs, fv_f, rate_min=rate_min, rate_max=rate_max,
            y_min=y_min, y_max=y_max),
    )
    return timing, evidence


def pick_line_peak(timing: TimingEstimate, evidence: TimingEvidence, n: int) -> TimingEstimate:
    """Adopt ranked line-period peak ``n`` (0-based) from the evidence: the
    operator override for a wrong automatic lock.  Returns a new
    TimingEstimate snapped to the closest video mode at the picked line
    count (measured refresh kept)."""
    if evidence.line_peaks is None or not len(evidence.line_peaks):
        raise ValueError("evidence carries no ranked line peaks")
    if not 0 <= n < len(evidence.line_peaks):
        raise IndexError(f"peak {n} out of range (have {len(evidence.line_peaks)})")
    return _snap(timing.refresh_hz, float(evidence.line_peaks[n][1]), timing.snr_db)


# ------------------------------------------------------------------ stage 2
def demodulate(iq: torch.Tensor, config: ReconstructionConfig) -> torch.Tensor:
    """Demodulation stage: the float32 AM envelope or FM discriminator
    output of one block."""
    fm = config.demod == "fm"
    if config.input_format == "envelope":
        # Demodulated already: pass through, honouring only the inversion.
        env = iq.to(torch.float32)
    elif config.input_format == "iq_planar":
        env = fm_demod_from_iq_planar(iq) if fm else am_envelope_from_iq_planar(iq)
    elif config.input_format == "iq_interleaved":
        env = fm_demod_from_iq(iq) if fm else am_envelope_from_iq(iq)
    else:
        env = fm_demod(iq) if fm else am_demod(iq)
    return invert_envelope(env) if config.invert else env


def fuses_demod(config: ReconstructionConfig, iq: torch.Tensor) -> bool:
    """Whether the step hands ``iq`` to K1 as raw words, with the demod (AM
    or FM), the inversion (``invert``: the block maximum a launch of its
    own before K1) and the bfloat16 rounding of the ``mxu3``, ``mxu4`` and
    ``mxu_batched`` chains done inside the resampler's load: interleaved
    int16 or float32 words and a resampler that is K1, in the single step,
    the batched step (each stream demodulated, inverted and clamped on its
    own) and a shard's window.  The values are those of ``demodulate``, the
    rounding and K1 on the envelope, to the bit.

    The routes that keep the demod as a pass: complex input (``am_demod`` is
    ``torch.abs``, whose bits differ from ``sqrt(I² + Q²)``), planar and
    envelope input and other word types; the plain resamplers; and the mode
    search (its candidate launch takes an envelope)."""
    how = RESAMPLERS[config.resampler]
    return (how.route == "k1" and config.input_format == "iq_interleaved"
            and iq.dtype in (torch.int16, torch.float32))


def _on_card(device: torch.device) -> bool:
    """Whether a step on ``device`` launches the kernels itself: on a CUDA
    card.  Elsewhere it calls the kernels' wrappers, which run their plain
    versions."""
    return device.type == "cuda"


# Bytes every part of a step's scratch and outputs starts on, in the one
# buffer each is cut from: the kernels' vector loads and stores need 16.
_PART_ALIGN = 256


def _layout(sizes: dict[str, int]) -> tuple[dict[str, int], int]:
    """Where parts of ``sizes`` 4-byte elements lie in one buffer, each from
    a multiple of ``_PART_ALIGN`` bytes: (each part's offset, the elements
    in all), both in elements."""
    unit = _PART_ALIGN // 4
    offsets, end = {}, 0
    for name, n in sizes.items():
        offsets[name] = end
        end += -(-n // unit) * unit
    return offsets, end


class _StepPlan:
    """Stages 3-6 of one geometry's step (:func:`_step`), worked out once.

    Stage 3, the [B·F, h, w] screens: with ``from_words`` K1 demodulates,
    inverts and rounds the words itself, of ``n_streams`` streams laid end to
    end each on its own; an envelope (laid out by the caller so that no
    stream's reads leave it) is rounded first where the resampler asks for
    it.  Stages 4-6: the sync is K2 on the card; alignment and the fold are
    ONE call of K3's entry (``align_fold``), alignment alone without ``ema``;
    without ``do_align`` the same entry only folds.  So every route (single
    step, batched step, a mesh's spans; default and fidelity chains) folds
    through the same arithmetic.

    :meth:`plain` takes a step through the kernels' wrappers.  On a card,
    :meth:`prepare_launches` keeps each launch's arguments but the
    addresses, and the layout of the step's scratch and outputs, so that
    :meth:`run` issues a step of the same geometry as its launches alone:
    each output a fresh tensor, K1's screens, K2's scratch and the block
    maximum's in one allocation, K2's sync, centres and scores and the new
    EMA in another, the aligned frames in a third."""

    def __init__(self, config: ReconstructionConfig, frame_len: int, n_streams: int,
                 from_words: bool, exact: bool):
        mode = config.mode
        how = RESAMPLERS[config.resampler]
        self.route = how.route
        self.raster = (frame_len, mode.height, mode.width, config.render_size)
        self.taps = config.interp_taps if how.takes_taps else 2
        self.from_words = from_words
        self.round_envelope = how.bf16_envelope and not from_words
        self.load = (config.demod, how.bf16_envelope, config.invert)   # the words load's
        self.n_streams = n_streams
        self.do_align = config.do_align
        self.subpixel = config.align_subpixel
        self.align = config.align_interp if config.align_subpixel else "integer"
        # A residual moves every position of its frame, so the quantised
        # line table does not apply to an exact cut: K1 takes it unquantised.
        self.num_phases = config.num_phases if how.quantised and not exact else None
        self.options = {} if self.num_phases is None else {"num_phases": self.num_phases}
        if from_words:
            # The load's options only where they differ from one stream of AM
            # without inversion or rounding.
            if config.demod != "am":
                self.options["demod"] = config.demod
            if how.bf16_envelope:
                self.options["bf16"] = True
            if config.invert:
                self.options["invert"] = True
            if n_streams != 1:
                self.options["streams"] = n_streams
        self.device = None   # the card's, once prepare_launches has run

    def screens(self, env, frame_starts, frac_offsets) -> torch.Tensor:
        """Stage 3 through the wrappers."""
        if self.route == "gather":
            return frames_to_screens_gather(env, frame_starts, *self.raster, frac_offsets)
        if self.route == "fft":
            return frames_to_screens_fft(env, frame_starts, *self.raster)
        if self.from_words:
            return frames_to_screens_from_words(env, frame_starts, *self.raster, frac_offsets,
                                                self.taps, **self.options)
        if self.round_envelope:
            env = round_to_bfloat16(env)
        return frames_to_screens(env, frame_starts, *self.raster, frac_offsets, self.taps,
                                 **self.options)

    def plain(self, env, frame_starts, frac_offsets, ema, alpha):
        """(ema' or None, frames, sync [B·F, 2], score [B·F]) through the
        kernels' wrappers: their plain versions off the card, their checked
        launches on it."""
        screens = self.screens(env, frame_starts, frac_offsets).contiguous()
        n = screens.shape[0]
        if not self.do_align:
            frames, ema_out = ((screens, None) if ema is None
                               else align_fold(screens, ema=ema, alpha=alpha, align=None,
                                               n_streams=self.n_streams))
            return (ema_out, frames,
                    torch.zeros((n, 2), dtype=torch.int32, device=screens.device),
                    torch.zeros(n, dtype=torch.float32, device=screens.device))
        # K2 writes the [B·F, 2] sync beside s_y and s_x: no stacking launch.
        s_y, s_x, score, sync = blanking_sync(screens, subpixel=self.subpixel, pairs=True)
        frames, ema_out = align_fold(screens, s_y, s_x, ema, alpha, self.align, self.n_streams)
        return ema_out, frames, sync, score

    def prepare_launches(self, env, frame_starts, frac_offsets, ema) -> None:
        """Keep what the launches of a step like this one need besides the
        addresses of its tensors: called after :meth:`plain` took the step,
        whose wrappers checked its tensors."""
        dev = env.device
        n = frame_starts.shape[0]
        h, w = (int(d) for d in self.raster[3])
        self.screens_shape = (n, h, w)
        self.k1 = self.maxima = None
        scratch = {}
        if self.route == "k1":
            if self.from_words:
                n_samples, (demod, bf16, invert) = env.shape[0] // 2, self.load
                staged, load = _words_load(env.dtype, demod, bf16, invert)
                if invert:
                    parts, self.maxima = _prepare_maxima(n_samples, env.dtype, demod,
                                                         self.n_streams, dev)
                    scratch["parts"], scratch["maxima"] = parts, self.n_streams
            else:
                n_samples, staged, load = env.shape[0], _ENVELOPE, ()
            _, self.k1 = _prepare_k1(n_samples, staged, n, *self.raster, frac_offsets is not None,
                                     self.taps, self.num_phases,
                                     self.n_streams if self.from_words else 1, load, dev)
            if self.do_align:
                scratch["screens"] = n * h * w
        if self.do_align:
            (rows, cols), self.k2 = _prepare_k2(n, h, w, 0.01, 0.05, 0, self.subpixel, dev)
            scratch["rows"], scratch["cols"] = rows, cols
            outs = {"sync": 2 * n, "s_y": n, "s_x": n, "score": n}
            if ema is not None:
                outs["ema"] = ema.numel()
            self.outs, self.outs_len = _layout(outs)
            code = _SHIFT_TYPES[torch.float32 if self.subpixel else torch.int32]
            types, align = (code, code), self.align
        else:
            types, align = (0, 0), None
        self.scratch, self.scratch_len = _layout(scratch)
        self.k3, self.vec = None, False
        if self.do_align or ema is not None:
            self.vec = w % 4 == 0
            self.k3 = _prepare_k3(n, h, w, self.n_streams, align, ema is not None, types, self.vec,
                                  dev)
        self.ema_shape = None if ema is None else (tuple(ema.shape), ema.stride())
        self.per_stream = n // self.n_streams
        self.device = dev

    def accepts(self, env, frame_starts, frac_offsets, ema) -> bool:
        """Whether this step's tensors are what :meth:`prepare_launches` saw,
        where the plan's key does not say: on its device, contiguous, of the
        types the kernels take, the EMA on the bytes the launch assumed."""
        dev = self.device
        return (env.is_contiguous() and frame_starts.device == dev
                and frame_starts.dtype == torch.int32 and frame_starts.is_contiguous()
                and (frac_offsets is None
                     or (frac_offsets.device == dev and frac_offsets.dtype == torch.float32
                         and frac_offsets.shape == frame_starts.shape
                         and frac_offsets.is_contiguous()))
                and (ema is None
                     or (ema.device == dev and ema.dtype == torch.float32
                         and (not self.vec or ema.data_ptr() % 16 == 0))))

    def run(self, env, frame_starts, frac_offsets, ema, alpha):
        """The step: its launches alone where :meth:`accepts` says so, else
        :meth:`plain`."""
        if self.device is None or not self.accepts(env, frame_starts, frac_offsets, ema):
            return self.plain(env, frame_starts, frac_offsets, ema, alpha)
        dev = self.device
        f32 = torch.float32
        scratch = torch.empty(self.scratch_len, dtype=f32, device=dev) if self.scratch_len else None
        at = None if scratch is None else scratch.data_ptr()
        part = self.scratch
        if self.k1 is not None:
            src = round_to_bfloat16(env) if self.round_envelope else env
            maxima = None
            if self.maxima is not None:
                maxima = at + 4 * part["maxima"]
                self.maxima(src.data_ptr(), at + 4 * part["parts"], maxima)
            if self.do_align:
                screens, screens_at = None, at + 4 * part["screens"]
            else:
                screens = torch.empty(self.screens_shape, dtype=f32, device=dev)
                screens_at = screens.data_ptr()
            self.k1(src.data_ptr(), frame_starts.data_ptr(),
                    None if frac_offsets is None else frac_offsets.data_ptr(), maxima, screens_at)
        else:
            screens = self.screens(env, frame_starts, frac_offsets).contiguous()
            screens_at = screens.data_ptr()
        weights = (None, None)
        if ema is not None:
            fold_w, big_a = fold_weights(alpha, self.per_stream, dev)
            weights = (fold_w.data_ptr(), big_a.data_ptr())
        if not self.do_align:
            n = self.screens_shape[0]
            ema_out = None
            if ema is not None:
                ema_out = torch.empty_like(ema)
                self.k3(screens_at, None, ema.data_ptr(), ema_out.data_ptr(), None, None,
                        *weights)
            return (ema_out, screens, torch.zeros((n, 2), dtype=torch.int32, device=dev),
                    torch.zeros(n, dtype=f32, device=dev))
        outs = torch.empty(self.outs_len, dtype=f32, device=dev)
        out, out_at = self.outs, outs.data_ptr()
        s_y, s_x = out_at + 4 * out["s_y"], out_at + 4 * out["s_x"]
        self.k2(screens_at, at + 4 * part["rows"], at + 4 * part["cols"], s_y, s_x,
                out_at + 4 * out["score"], out_at + 4 * out["sync"])
        frames = torch.empty(self.screens_shape, dtype=f32, device=dev)
        self.k3(screens_at, frames.data_ptr(), None if ema is None else ema.data_ptr(),
                None if ema is None else out_at + 4 * out["ema"], s_y, s_x, *weights)
        n = self.screens_shape[0]
        sync = (outs if self.subpixel else outs.view(torch.int32)).as_strided(
            (n, 2), (2, 1), out["sync"])
        score = outs.as_strided((n,), (1,), out["score"])
        ema_out = None if ema is None else outs.as_strided(*self.ema_shape, out["ema"])
        return ema_out, frames, sync, score


# The plans of the steps by their keys (_step): made by a key's first step,
# only read after that, by any thread (a mesh's shards issue from several);
# the oldest dropped first beyond _PLANS_KEPT.
_PLANS: dict = {}
_PLANS_KEPT = 64
_PLANS_LOCK = threading.Lock()


def _step(env, frame_starts, config: ReconstructionConfig, frame_len: int, ema, alpha,
          n_streams: int, from_words: bool, frac_offsets):
    """Stages 3-6 of a step, from its plan (:class:`_StepPlan`).  The plan's
    key is what the step can observe: the source's device, type and shape,
    the frames, whether residuals are given, the EMA's shape, whether
    ``alpha`` is a tensor, the streams, whether the words go to K1, and the
    fields of ``config`` that reach a launch.  A key not seen before takes
    its step through the kernels' wrappers, which check its tensors, and
    then keeps its plan (``step.plan.builds``); a key seen before reuses it
    (``step.plan.reuses``).  Two threads that meet a new key at once may
    each build its plan; one is kept."""
    mode = config.mode
    key = (env.device, env.dtype, env.shape, frame_starts.shape, frac_offsets is not None,
           None if ema is None else ema.shape, isinstance(alpha, torch.Tensor), n_streams,
           from_words, frame_len, mode.height, mode.width, tuple(config.render_size),
           config.resampler, config.interp_taps, config.num_phases, config.demod, config.invert,
           config.do_align, config.align_subpixel, config.align_interp)
    plan = _PLANS.get(key)
    if plan is not None:
        count("step.plan.reuses")
        return plan.run(env, frame_starts, frac_offsets, ema, alpha)
    plan = _StepPlan(config, frame_len, n_streams, from_words, frac_offsets is not None)
    out = plan.plain(env, frame_starts, frac_offsets, ema, alpha)
    if _on_card(env.device):
        plan.prepare_launches(env, frame_starts, frac_offsets, ema)
    with _PLANS_LOCK:
        if len(_PLANS) >= _PLANS_KEPT:
            del _PLANS[next(iter(_PLANS))]
        _PLANS.setdefault(key, plan)
    count("step.plan.builds")
    return out


def process_frames(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    config: ReconstructionConfig,
    frame_len: int,
    from_words: bool = False,
    frac_offsets: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resample + sync + align all frames of one envelope block: returns
    ``(frames [F,h,w], sync [F,2], score [F])``.  With ``from_words``,
    ``env`` is the block's interleaved I/Q words instead and K1 takes their
    envelope (``config.demod``, rounded where the resampler rounds) itself.
    ``frac_offsets`` (per frame, in [0, 1)) are the
    residuals of sub-sample-exact cuts (``config.subsample_align``)."""
    return _step(env, frame_starts, config, frame_len, None, None, 1, from_words,
                 frac_offsets)[1:]


def _process_and_fold(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    config: ReconstructionConfig,
    frame_len: int,
    ema: torch.Tensor,
    alpha,
    n_streams: int = 1,
    from_words: bool = False,
    frac_offsets: torch.Tensor | None = None,
):
    """:func:`process_frames` with the fold: (ema', frames, sync, score) of
    ``n_streams`` streams' frames laid out stream-major, ``ema`` [B, h, w]
    (or [h, w] for one stream); with ``from_words`` the words are the
    streams' blocks end to end.  Equals ``ema_fold`` of each stream's
    frames, to the bit."""
    return _step(env, frame_starts, config, frame_len, ema.contiguous(), alpha, n_streams,
                 from_words, frac_offsets)


def ema_fold(ema: torch.Tensor, frames: torch.Tensor, alpha) -> torch.Tensor:
    """EMA over the frame axis (``image = α·image + (1-α)·frame`` per frame)
    in closed form: ``α^F · ema + (1-α) · Σ_n α^(F-1-n) · frame_n``, the sum
    taken in frame order (``ops.align_kernel``): K3's fold on the card, its
    plain version on the CPU."""
    return align_fold(frames, ema=ema, alpha=alpha, align=None)[1]


def carry_phase_starts(phase: float, spf: float, n_frames: int) -> np.ndarray:
    """Rounded frame starts of a carry-phase block, int32 [n_frames].

    The JAX step computes ``floor(phase + spf·k + 0.5)`` in float32, where
    at 36 frames ``spf·k`` reaches 11.7 M and the f32 spacing is 1.0, so a
    float64 computation cuts some frames a sample apart.  This reproduces
    the f32 arithmetic of that expression on the host, one rounding per
    operation, as the JAX program states it."""
    exact = np.float32(phase) + np.float32(spf) * np.arange(n_frames, dtype=np.float32)
    return np.floor(exact + np.float32(0.5)).astype(np.int32)


_BELOW_ONE = np.nextafter(np.float32(1.0), np.float32(0.0))


def exact_cut_starts(phase: float, spf: float, n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """Sub-sample-exact cuts of a block whose first frame boundary lies
    ``phase`` samples in: (int32 starts ``floor(phase + spf·k)``, float32
    residuals in [0, 1)), computed in float64 — a float32 position of
    millions of samples has no fraction left.  A residual that float32 would
    round up to 1 stays just below it."""
    exact = float(phase) + float(spf) * np.arange(n_frames, dtype=np.float64)
    starts = np.floor(exact)
    fracs = np.minimum((exact - starts).astype(np.float32), _BELOW_ONE)
    return starts.astype(np.int32), fracs


def _carry_phase_exact_f32(phase: float, spf: float, n_frames: int):
    """The traced JAX chain's exact cuts of a carry-phase block, in its
    stated float32 arithmetic (one rounding per operation): the port's
    ``gather`` route keeps it so as to equal its counterpart.  See
    :func:`exact_cut_starts` for what it loses at large positions."""
    exact = np.float32(phase) + np.float32(spf) * np.arange(n_frames, dtype=np.float32)
    starts = np.floor(exact)
    return starts.astype(np.int32), exact - starts


def _cut_fn(config: ReconstructionConfig):
    """``cuts(phase) -> (int32 starts, float32 residuals or None)`` of one
    block of ``config``, on the host: rounded starts, or with
    ``subsample_align`` the floor and the residual.  Without ``carry_phase``
    the table is static and ``phase`` is not read."""
    n_frames = config.n_frames
    spf = config.samples_per_frame
    sub = config.subsample_align
    if not config.carry_phase:
        if sub:
            static_cuts = exact_cut_starts(0.0, spf, n_frames)
        else:
            static_cuts = (np.round(np.arange(n_frames) * spf).astype(np.int32), None)
        return lambda phase=0.0: static_cuts
    if not sub:
        return lambda phase: (carry_phase_starts(phase, spf, n_frames), None)
    if config.resampler == "gather":
        return lambda phase: _carry_phase_exact_f32(phase, spf, n_frames)
    return lambda phase: exact_cut_starts(phase, spf, n_frames)


class _CutSlots:
    """The pinned host slots through which a step function's cuts go up to a
    card, taken in turn, so that an upload is a copy on the step's stream
    that the host does not wait for.  Each slot's copy records the slot's
    event; the slot is written again only after that event, which in a
    stream of steps came a few steps back.  Shared by the threads that call
    the step function."""

    SLOTS = 4

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (device, pinned int32 tensor, its int32 and float32 arrays, event)
        self._slots: list = [None] * self.SLOTS
        self._next = 0
        self._streams: dict = {}   # (device index, raw stream) -> its torch.cuda.Stream

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        """The current stream of ``device``, its Python object made once."""
        key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(device)
        return stream

    def upload(self, starts: np.ndarray, fracs: np.ndarray | None,
               device: torch.device) -> torch.Tensor:
        """The starts, then the residuals' bits, as one fresh int32 tensor
        on the CUDA ``device``: its copy issued on the current stream."""
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        n = len(starts)
        size = n if fracs is None else 2 * n
        buf = torch.empty(size, dtype=torch.int32, device=device)
        stream = self._stream(device)
        with self._lock:
            k = self._next
            self._next = (k + 1) % self.SLOTS
            slot = self._slots[k]
            if slot is None or slot[0] != device or slot[1].numel() != size:
                host = torch.empty(size, dtype=torch.int32, pin_memory=True)
                array = host.numpy()
                slot = self._slots[k] = (device, host, array, array.view(np.float32),
                                         torch.cuda.Event())
            _, host, array, real, event = slot
            if not event.query():
                event.synchronize()
            array[:n] = starts
            if fracs is not None:
                real[n:] = fracs
            buf.copy_(host, non_blocking=True)
            event.record(stream)
        return buf


def _upload_cuts(starts: np.ndarray, fracs: np.ndarray | None, device: torch.device,
                 slots: _CutSlots):
    """(int32 frame starts, float32 residuals or None) on ``device`` in ONE
    upload: the residuals' bits ride behind the starts in one int32 buffer,
    and both are views of it.  To a card through ``slots``
    (``step.upload_cuts.pinned.bytes``), elsewhere one copy."""
    n = len(starts)
    nbytes = 4 * (n if fracs is None else 2 * n)
    count("step.upload_cuts.bytes", nbytes)
    if device.type == "cuda":
        buf = slots.upload(starts, fracs, device)
        count("step.upload_cuts.pinned.bytes", nbytes)
    else:
        if fracs is None:
            host = np.asarray(starts, np.int32)
        else:
            host = np.concatenate([np.asarray(starts, np.int32),
                                   np.asarray(fracs, np.float32).view(np.int32)])
        buf = torch.from_numpy(host).to(device)
        count("step.upload_cuts.pinned.bytes", 0)
    if fracs is None:
        return buf, None
    return buf[:n], buf[n:].view(torch.float32)


def make_reconstruct_fn(config: ReconstructionConfig, device: torch.device | str | None = None):
    """Build the stage-2 step for a fixed config on ``device`` (``None``:
    the CUDA card; raises when there is none).

    Returns ``step(iq, ema, alpha) -> (ema', frames, sync, score)``, or with
    ``carry_phase`` ``step(iq, ema, alpha, phase)`` where ``phase`` is the
    host-known fractional offset of the first frame boundary in [0, spf).
    ``iq`` and ``ema`` may be numpy arrays or tensors; they are moved to
    ``device``, and the outputs stay there."""
    _check_supported(config)
    device = resolve_device(device)
    frame_len = int(np.floor(config.samples_per_frame))  # samples fed to the resampler per frame
    cuts = _cut_fn(config)
    slots = _CutSlots()

    def _body(iq, ema, alpha, starts: np.ndarray, fracs: np.ndarray | None):
        iq = _as_tensor(iq, device)
        ema = _as_tensor(ema, device)
        if ema.dtype != torch.float32:
            ema = ema.to(torch.float32)
        with annotate("step.upload_cuts"):
            fstarts, frac_offsets = _upload_cuts(starts, fracs, device, slots)
        with annotate("step.launch"):
            from_words = fuses_demod(config, iq)
            return _process_and_fold(
                iq if from_words else demodulate(iq, config), fstarts, config, frame_len, ema,
                alpha, from_words=from_words, frac_offsets=frac_offsets)

    if config.carry_phase:

        def step(iq, ema, alpha, phase):
            with annotate("step"):
                with annotate("step.cuts"):
                    cut = cuts(float(phase))
                return _body(iq, ema, alpha, *cut)

    else:

        def step(iq, ema, alpha):
            with annotate("step"):
                with annotate("step.cuts"):
                    cut = cuts()
                return _body(iq, ema, alpha, *cut)

    return step


# Resamplers whose frames the JAX package can fuse across streams
# (``fuse=True``): its per-frame formulations.
_FUSABLE_RESAMPLERS = ("gather", "rows", "mxu", "mxu2", "mxu3", "mxu4")


def _stream_margins(config: ReconstructionConfig, frame_len: int, exact: bool) -> tuple[int, int]:
    """(lead, tail): the samples K1 may read before a frame's start and from
    it on (its last line's start, the span, the taps' and the residual's
    reach).  Streams laid end to end must keep these inside their own block,
    where a single stream's reads are clamped."""
    how = RESAMPLERS[config.resampler]
    if how.route != "k1":
        return 0, frame_len  # the plain formulations read inside the frame
    mode = config.mode
    line_start, _, _, _, span = _line_tables(frame_len, mode.height, mode.width,
                                             tuple(config.render_size))
    lead, extra = line_reach(config.interp_taps if how.takes_taps else 2, exact)
    return lead, int(line_start[-1, 1]) + span + extra


def make_batched_reconstruct_fn(config: ReconstructionConfig, fuse: bool | None = None,
                                device: torch.device | str | None = None):
    """Multi-stream variant: B independent I/Q channels (different carriers,
    antennas, or targets) reconstruct concurrently on one card.

    Returns ``step(iq[B, ...], ema[B, h, w], alpha) -> (ema', frames[B, F, h,
    w], sync[B, F, 2], score[B, F])`` (alpha shared), or with ``carry_phase``
    ``step(iq, ema, alpha, phases)`` with one host-known phase per stream.

    The B blocks are ONE contiguous buffer and stream b's frame starts are
    offset by b·(samples per block), so all B·F frames go through one K1
    launch, one sync over the B·F screens and one K3 launch that aligns them
    and folds each stream's frames into its EMA, in the single step's order:
    each stream's EMA is the single-stream step's to the bit.  Each stream's
    frames equal the single-stream step's.  Where ``fuses_demod`` says so
    (AM or FM, inverted or not), K1's words entry takes the caller's words
    as they lie, with the stream geometry: each stream demodulated (FM's 0
    on its own first pair), inverted by its own maximum and every read
    clamped into its own block, as the single-stream kernel clamps.  Else
    one demodulation per stream goes to the envelope entry, and where a
    stream's last frame, or the tap before its first, would read past its
    own block, the envelopes are first laid out with each block's edge
    samples repeated.  K1 indexes the buffer with int32 frame starts:
    B·(samples per block) beyond that raises.

    ``fuse=True`` is the JAX package's option to fuse the frame axis across
    streams; here that is the one formulation, so it changes no value, but it
    keeps that package's ``ValueError`` for the configurations it could not
    fuse (``carry_phase``, ``subsample_align``, ``frame_loop="scan"``, or a
    block-level resampler)."""
    _check_supported(config)
    if fuse and not (not config.carry_phase and not config.subsample_align
                     and config.frame_loop == "vmap"
                     and config.resampler in _FUSABLE_RESAMPLERS):
        raise ValueError(
            "fuse=True needs static cuts and a per-frame resampler "
            "(no carry_phase/subsample_align, frame_loop='vmap')")
    device = resolve_device(device)
    n_frames = config.n_frames
    frame_len = int(np.floor(config.samples_per_frame))
    h, w = config.render_size
    cuts = _cut_fn(config)
    slots = _CutSlots()
    lead, tail = _stream_margins(config, frame_len, config.subsample_align)

    def _body(iq_b, ema_b, alpha, stream_cuts):
        iq_b = _as_tensor(iq_b, device)
        ema_b = _as_tensor(ema_b, device).to(torch.float32)
        n_streams = iq_b.shape[0]
        if len(stream_cuts) != n_streams or ema_b.shape[0] != n_streams:
            raise ValueError(
                f"{n_streams} streams of I/Q, {ema_b.shape[0]} EMA images and "
                f"{len(stream_cuts)} phases: one of each per stream")
        from_words = fuses_demod(config, iq_b)
        starts = np.stack([c[0] for c in stream_cuts]).astype(np.int64)         # [B, F]
        fracs = None
        if stream_cuts[0][1] is not None:
            fracs = np.stack([c[1] for c in stream_cuts]).astype(np.float32).reshape(-1)
        front = 0
        # The streams' layout sets the cuts' offsets, so it comes before the
        # cuts' upload, under a span of its own; the chain's launches after.
        with annotate("step.layout"):
            if from_words:
                # K1 clamps each stream's reads into its own block.
                buf = iq_b[:, : 2 * (iq_b.shape[1] // 2)]
                n_block = buf.shape[1] // 2
            else:
                buf = torch.stack([demodulate(iq_b[b], config) for b in range(n_streams)])
                n_block = buf.shape[1]
                front = lead if int(starts.min()) < lead else 0
                back = max(int(starts.max()) + tail - n_block, 0)
                if front or back:
                    # Repeat each block's first and last sample, as the
                    # single-stream kernel's index clamp does.
                    buf = torch.cat([buf[:, :1].repeat(1, front), buf,
                                     buf[:, n_block - 1:].repeat(1, back)], dim=1)
                    n_block += front + back
        if n_streams * n_block > np.iinfo(np.int32).max:
            raise ValueError(
                f"{n_streams} streams of {n_block} samples do not fit K1's int32 frame "
                "starts: serve them in smaller batches")
        offsets = np.arange(n_streams, dtype=np.int64)[:, None] * n_block + front
        with annotate("step.upload_cuts"):
            fstarts, frac_offsets = _upload_cuts((starts + offsets).reshape(-1), fracs, device,
                                                 slots)
        with annotate("step.launch"):
            ema_out, frames, sync, score = _process_and_fold(
                buf.reshape(-1), fstarts, config, frame_len, ema_b, alpha, n_streams,
                from_words=from_words, frac_offsets=frac_offsets)
        return (ema_out, frames.reshape(n_streams, n_frames, h, w),
                sync.reshape(n_streams, n_frames, 2), score.reshape(n_streams, n_frames))

    if config.carry_phase:

        def step(iq_b, ema_b, alpha, phases):
            with annotate("step"):
                with annotate("step.cuts"):
                    stream_cuts = [cuts(float(p)) for p in np.asarray(phases)]
                return _body(iq_b, ema_b, alpha, stream_cuts)

    else:

        def step(iq_b, ema_b, alpha):
            with annotate("step"):
                with annotate("step.cuts"):
                    stream_cuts = [cuts()] * len(iq_b)
                return _body(iq_b, ema_b, alpha, stream_cuts)

    return step


def reconstruct_frames(
    iq: np.ndarray | torch.Tensor,
    config: ReconstructionConfig,
    alpha: float = 0.1,
    ema: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> Reconstruction:
    """Run stage 2 over one I/Q block on ``device`` (``None``: the CUDA
    card; raises when there is none).

    Host complex input is reinterpreted as interleaved float32 words
    (zero-copy view), keeping the host→device copy real; real input under a
    complex config is taken as interleaved words, as in the JAX package.
    Under ``input_format="iq_planar"`` a 1-D input (complex samples or
    interleaved words) is de-interleaved on the host first."""
    if config.input_format == "iq_planar" and getattr(iq, "ndim", 1) == 1:
        iq = to_planar_iq(iq.cpu().numpy() if isinstance(iq, torch.Tensor) else np.asarray(iq))
    if config.input_format == "complex64":
        if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
            iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
            config = dataclasses.replace(config, input_format="iq_interleaved")
        elif not (isinstance(iq, torch.Tensor) and iq.is_complex()):
            config = dataclasses.replace(config, input_format="iq_interleaved")
    if config.carry_phase:
        raise ValueError("reconstruct_frames runs one block from phase 0; "
                         "use make_reconstruct_fn for carry_phase streaming")
    step = make_reconstruct_fn(config, device)
    h, w = config.render_size
    ema0 = np.zeros((h, w), np.float32) if ema is None else np.asarray(ema, np.float32)
    n = config.block_samples
    if config.input_format == "iq_interleaved":
        n *= 2  # raw I/Q words, two per complex sample
    if iq.shape[-1] < n:
        raise ValueError(f"need {n} samples for {config.n_frames} frames, got {iq.shape[-1]}")
    with annotate("offline.stage2"):
        outs = step(iq[..., :n], ema0, alpha)
    with annotate("offline.readback"):
        arrays, pinned = _read_back(outs)
        recon = Reconstruction(*arrays)  # image (the EMA), frames, sync, score
    if enabled():
        count("offline.readback.bytes", sum(a.nbytes for a in arrays))
        count("offline.readback.pinned.bytes", pinned)
    return recon


def _read_back(tensors) -> tuple[list[np.ndarray], int]:
    """``tensors`` (all on one device) as host arrays, and the bytes read
    into pinned memory.

    From the card each tensor is copied into a pinned tensor of PyTorch's
    caching host allocator, all on the current stream with one
    synchronisation after them, and its array is a view that keeps the
    tensor: the block goes back to the allocator's cache when the caller
    drops the array, and one the caller still holds is never handed out
    again.  On the CPU the arrays are views of the tensors themselves."""
    device = tensors[0].device
    if device.type != "cuda":
        return [t.cpu().numpy() for t in tensors], 0
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return [h.numpy() for h in host], sum(h.nbytes for h in host)


def auto_reconstruct(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    n_frames: int | None = None,
    alpha: float | str = 0.1,
    invert: bool = False,
    corr_seconds: float = 0.1,
    refine_with_search: bool = False,
    search_tol_hz: float = 1.0,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    align_subpixel: bool = True,
    pick_line_peak: int | None = None,
    restore: bool = True,
    restore_nsr: float = 0.002,
    demod: str = "am",
    device: torch.device | str | None = None,
) -> tuple[TimingEstimate, Reconstruction]:
    """Fully automatic capture → image on ``device`` (``None``: the CUDA
    card; raises when there is none): stage 1 finds refresh and line count
    and snaps them to a video mode, stage 2 reconstructs with that geometry
    through K1, and the known MTF of the chain is Wiener-inverted on the
    final average (``ops.enhance``; the raw EMA stays in
    ``Reconstruction.image_raw``).

    ``iq`` is complex samples or real interleaved I/Q words.  The capture is
    uploaded once and stays on the device between the stages.

    ``demod="fm"`` drives the whole chain off the FM discriminator: a
    constant-amplitude FM capture has a flat envelope, so the AM statistic
    cannot even find its refresh.  ``alpha="auto"`` takes the EMA coefficient
    from the measured SNR proxy.  ``pick_line_peak=N`` adopts ranked
    line-period peak N from the correlation evidence instead of the automatic
    lock.  ``refine_with_search=True`` additionally scores every video mode
    within ``search_tol_hz`` of the measured refresh by sync contrast
    (``parallel.sharded.mode_search_static``) and keeps the winner — a
    safety net when the line-count estimate is ambiguous at low SNR."""
    with annotate("offline.auto", request=next(_AUTO_CALLS)):
        device = resolve_device(device)
        if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
            iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        with annotate("offline.upload"):
            if isinstance(iq, np.ndarray):
                sig = staged_upload(iq, device)
            else:
                sig = _as_tensor(iq, device)
        if isinstance(iq, np.ndarray):
            count("offline.upload.bytes", iq.nbytes)
        # Real input is interleaved I/Q words: two words per complex sample.
        interleaved = not sig.is_complex()
        n_complex = sig.shape[0] // 2 if interleaved else sig.shape[0]
        # Stage 1 ends with the mode on the host.
        with annotate("offline.stage1"):
            timing_sig, envelope = sig, False
            if demod == "fm":
                # One discriminator pass feeds the timing estimation; the
                # reconstruction step demodulates its own block again
                # (ReconstructionConfig.demod="fm"), which is negligible offline.
                timing_sig, envelope = ((fm_demod_from_iq(sig) if interleaved else fm_demod(sig)),
                                        True)
            if pick_line_peak is not None:
                timing, evidence = timing_evidence(timing_sig, fs, corr_seconds, rate_min,
                                                   rate_max, envelope=envelope)
                timing = _pick_line_peak_fn(timing, evidence, pick_line_peak)
            else:
                timing = estimate_timing(timing_sig, fs, corr_seconds, rate_min, rate_max,
                                         envelope=envelope)
            if alpha == "auto":
                alpha = timing.suggested_alpha
            if refine_with_search:
                from ..parallel.sharded import mode_search_static

                cands = candidate_modes(timing.refresh_hz, tol_hz=search_tol_hz)
                if len(cands) > 1:
                    # The search scores an envelope: the discriminator's
                    # output, or the AM envelope of the words (a raw real
                    # array would be scored as an envelope that is
                    # demodulated already).
                    if envelope:
                        env = timing_sig
                    else:
                        env = am_envelope_from_iq(sig) if interleaved else am_demod(sig)
                    res = mode_search_static(env, fs, timing.refresh_hz, cands, device=device)
                    best = res.best_mode
                    timing = dataclasses.replace(
                        timing, mode_name=res.names[res.best_index],
                        mode=VideoMode(best.width, best.height, timing.refresh_hz))
        spf = fs / timing.mode.refresh
        if n_frames is None:
            n_frames = max(int((n_complex - 1) / spf), 1)
        # Interpolation-order rule of the JAX package: Catmull-Rom only when
        # the envelope is NOT undersampled relative to the raster (≥ 1
        # sample per raster pixel); below that it preserves alias energy
        # that linear's stronger roll-off suppresses.
        taps = 4 if spf / timing.mode.pixels_per_frame >= 1.0 else 2
        config = ReconstructionConfig(
            sample_rate=fs, mode=timing.mode, n_frames=n_frames, invert=invert,
            align_subpixel=align_subpixel, interp_taps=taps, demod=demod,
        )
        recon = reconstruct_frames(sig, config, alpha=alpha, device=device)
        if restore:
            with annotate("offline.restore"):
                recon.image_raw = recon.image
                recon.image = restore_image(recon.image, config, nsr=restore_nsr, device=device)
        return timing, recon


# Running number of ``auto_reconstruct`` calls: the request id of their spans.
_AUTO_CALLS = itertools.count()


# ------------------------------------------------- multi-harmonic entries
def combined_reconstruct(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    centers_hz: np.ndarray | list[float] | None = None,
    chan_bw: float = 4e6,
    n_frames: int | None = None,
    alpha: float | str = 0.1,
    invert: bool = False,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    restore: bool = True,
    restore_nsr: float = 0.002,
    min_margin_db: float = 5.0,
    mode: VideoMode | None = None,
    demod: str = "am",
    excise_db: float | None = None,
    device: torch.device | str | None = None,
):
    """Multi-harmonic capture → image on ``device`` (``None``: the CUDA
    card; raises when there is none): find (or take) the screen's carriers
    in ONE wideband capture, fuse their envelopes at maximal ratio
    (``ops.combine``), and reconstruct from the combined envelope.

    ``centers_hz=None`` auto-discovers the carriers: a band scan
    (``ops.scan.scan_band``) groups detected channels into emissions, and
    every emission whose refresh estimate matches the strongest one's
    (same screen, different harmonic) contributes its best channel.
    Returns ``(timing, reconstruction, combine_result)``.

    The part of the capture that the channeliser reads (its first N
    complex samples, N the largest power of two it holds) goes to the
    device once and stays there through the scan, the fusion and the
    reconstruction; the fused envelope reaches K1's
    envelope entry as a device tensor, and ``combine_result.envelope`` is
    its host copy.

    ``demod="fm"`` runs the per-channel FM discriminator instead of the
    amplitude envelope — both the discovery sweep and the fusion — for
    targets that leak the video in carrier frequency.

    ``excise_db`` (e.g. ``0.0``): null in-channel CW interference louder
    than each channel's carrier peak by this margin before demodulation —
    RECOVERS a hit channel where the robust MRC alone can only refuse to
    weight it.  See ``ops.scan._excise_spikes`` for why the carrier-relative
    criterion cannot touch the emission's own comb."""
    with annotate("offline.combined", request=next(_COMBINED_CALLS)):
        with annotate("offline.upload"):
            part = _channel_part(iq)
            words = _words(part, resolve_device(device))
        if isinstance(part, np.ndarray):
            count("offline.upload.bytes", part.nbytes)
        if centers_hz is None:
            screens = discover_screens(words, fs, chan_bw, corr_seconds, rate_min, rate_max,
                                       min_margin_db, demod=demod)
            if not screens:
                raise ValueError(
                    "no emissions detected in the band; pass centers_hz "
                    "explicitly or lower min_margin_db")
            centers_hz = [e["best_channel_hz"] for e in screens[0]]
        with annotate("offline.combine"):
            env, fields = _combine_on_device(words, fs, centers_hz, chan_bw, corr_seconds,
                                             rate_min, rate_max, weighting, "auto", demod,
                                             excise_db, None)
            comb = CombineResult(envelope=env.cpu().numpy().astype(np.float32), **fields)
        count("offline.combine.envelope.bytes", comb.envelope.nbytes)
        return _reconstruct_from_combine(comb, env, n_frames, alpha, invert, corr_seconds,
                                         rate_min, rate_max, restore, restore_nsr, mode)


# Running number of ``combined_reconstruct`` calls: the request id of their spans.
_COMBINED_CALLS = itertools.count()


def _reconstruct_from_combine(comb, envelope, n_frames, alpha, invert, corr_seconds, rate_min,
                              rate_max, restore, restore_nsr, mode=None):
    """The tail of combined_reconstruct: combined envelope → timing →
    reconstruction (+ optional restoration).  ``envelope`` is
    ``comb.envelope`` as a tensor on the device that runs the chain.
    ``mode`` overrides the detected video mode (the manual-mode path of the
    plain chain, for captures too degraded to auto-detect)."""
    device = envelope.device
    # Stage 1 ends with the mode on the host.
    with annotate("offline.stage1"):
        timing = estimate_timing(envelope, comb.fs_channel, corr_seconds, rate_min, rate_max,
                                 envelope=True)
        if mode is not None:
            name = (find_configuration(mode)
                    or f"{mode.width}x{mode.height} @ {mode.refresh:g}Hz")
            timing = dataclasses.replace(timing, mode=mode, mode_name=name)
    if alpha == "auto":
        alpha = timing.suggested_alpha
    spf = comb.fs_channel / timing.mode.refresh
    if n_frames is None:
        n_frames = max(int((envelope.shape[0] - 1) / spf), 1)
    # The taps rule of auto_reconstruct, at the channel rate.
    taps = 4 if spf / timing.mode.pixels_per_frame >= 1.0 else 2
    config = ReconstructionConfig(
        sample_rate=comb.fs_channel, mode=timing.mode, n_frames=n_frames,
        invert=invert, align_subpixel=True, interp_taps=taps,
        input_format="envelope",
    )
    recon = reconstruct_frames(envelope, config, alpha=alpha, device=device)
    if restore:
        with annotate("offline.restore"):
            recon.image_raw = recon.image
            recon.image = restore_image(recon.image, config, nsr=restore_nsr, device=device)
    return timing, recon, comb


def discover_screens(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    min_margin_db: float = 5.0,
    refresh_group_hz: float = 0.005,
    scan_result=None,
    demod: str = "am",
    device: torch.device | str | None = None,
) -> list[list[dict]]:
    """Scan the band and group detected emissions into distinct SCREENS.

    Harmonics of one screen ride one pixel clock, so their per-channel
    refresh estimates agree; distinct monitors' crystals differ by ppm
    (60 Hz ± a few mHz).  Emissions whose refresh estimates agree within
    ``refresh_group_hz`` (default 5 mHz) are one screen.  Limits: two
    monitors closer in refresh than the scan window's estimator resolution
    merge — pass explicit ``centers_hz`` lists to ``combined_reconstruct``
    to separate them by hand.

    Returns screens ordered by their strongest emission's comb mass; each
    screen is the list of its ``ScanResult.emissions()`` dicts (strongest
    first).  ``iq``: complex samples or interleaved float32 I/Q words; the
    scan runs on ``device`` (``None``: where a tensor lies, else the CUDA
    card; raises when there is none).  Pass ``scan_result`` to group an
    already-run sweep instead of scanning here (``iq`` is then unused).
    """
    if scan_result is None:
        centers = scan_centers(fs, step_hz=chan_bw / 2.0, guard_hz=chan_bw / 2.0)
        scan_result = scan_band(iq, fs, centers, chan_bw, corr_seconds, rate_min, rate_max,
                                demod=demod, device=device)
    ems = scan_result.emissions(min_margin_db=min_margin_db)
    screens: list[list[dict]] = []
    for e in ems:  # already ordered by comb mass
        for s in screens:
            if abs(e["refresh_hz"] - s[0]["refresh_hz"]) < refresh_group_hz:
                s.append(e)
                break
        else:
            screens.append([e])
    return screens


def reconstruct_all_emissions(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    chan_bw: float = 4e6,
    n_frames: int | None = None,
    alpha: float | str = 0.1,
    invert: bool = False,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    restore: bool = True,
    restore_nsr: float = 0.002,
    min_margin_db: float = 5.0,
    refresh_group_hz: float = 0.005,
    max_screens: int | None = None,
    demod: str = "am",
    excise_db: float | None = None,
    device: torch.device | str | None = None,
) -> list[tuple]:
    """Reconstruct EVERY screen radiating in one wideband capture, on
    ``device`` (``None``: the CUDA card; raises when there is none).

    Band scan → emissions → screens (``discover_screens``) → one
    multi-harmonic ``combined_reconstruct`` per screen.  Returns a list of
    ``(timing, reconstruction, combine_result)`` ordered by emission
    strength — two monitors in one capture give two images, each fused
    from all of that monitor's harmonics.  The part of the capture that the
    channeliser reads is uploaded once."""
    words = _words(_channel_part(iq), resolve_device(device))
    screens = discover_screens(words, fs, chan_bw, corr_seconds, rate_min, rate_max,
                               min_margin_db, refresh_group_hz, demod=demod)
    out = []
    for group in screens[:max_screens]:
        centers_hz = [e["best_channel_hz"] for e in group]
        out.append(combined_reconstruct(
            words, fs, centers_hz, chan_bw=chan_bw, n_frames=n_frames,
            alpha=alpha, invert=invert, corr_seconds=corr_seconds,
            rate_min=rate_min, rate_max=rate_max, weighting=weighting,
            restore=restore, restore_nsr=restore_nsr, demod=demod,
            excise_db=excise_db, device=words.device))
    return out


# auto_reconstruct's ``pick_line_peak`` parameter shadows the function.
_pick_line_peak_fn = pick_line_peak
