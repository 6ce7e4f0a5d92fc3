"""Stage 2 of the reconstruction chain in PyTorch — the counterpart of the
streaming subset of ``tempest_tpu/pipeline/offline.py``.

One step takes a block of I/Q, and:

1. demodulates it to the AM envelope (``demodulate``);
2. cuts it into frames at rounded frame starts, carried across blocks by
   the fractional phase of the first frame boundary (``carry_phase``);
3. resamples every frame from signal to screen with K1
   (``ops.resample_kernel.frames_to_screens``) — or, for interleaved I/Q
   words with plain AM demod (``fuses_demod``), does 1 and 3 in one pass
   with K1's fused entry (``frames_to_screens_from_words``), which gives
   the same values without writing the envelope;
4. finds each frame's sub-pixel blanking position and
5. aligns the frame by a fractional circular shift (``ops.framesync``);
6. folds the frames into the carried EMA image (``ema_fold``).

``step(iq, ema, alpha[, phase]) -> (ema, frames, sync, score)`` runs
eagerly on the device it was built for (the CUDA card unless the caller
names another); there is no jit and no vmap.  The port
implements ``resampler="pallas"`` (K1) only, with rounded frame cuts; the
other options raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.demod import am_demod, am_envelope_from_iq, invert_envelope
from ..ops.framesync import (
    align_frame,
    align_frame_subpixel,
    frame_sync,
    frame_sync_subpixel,
)
from ..ops.resample import RENDER_SIZE
from ..ops.resample_kernel import frames_to_screens, frames_to_screens_from_words
from ..utils.device import resolve_device
from ..video.modes import VideoMode

__all__ = [
    "ReconstructionConfig",
    "Reconstruction",
    "demodulate",
    "fuses_demod",
    "process_frames",
    "ema_fold",
    "carry_phase_starts",
    "make_reconstruct_fn",
    "reconstruct_frames",
]


@dataclasses.dataclass(frozen=True)
class ReconstructionConfig:
    """Static parameters of a reconstruction step — the fields of the JAX
    package's config, with the same ``samples_per_frame`` and
    ``block_samples``.

    Fields that only choose a TPU formulation (``align_impl``, ``segments``,
    ``num_phases``, ``einsum_bf16``, ``interp_taps``, ``frame_loop``,
    ``phase_bins``, ``fuse_demod_cut``) are accepted and change no value on
    the K1 path: the JAX package's Pallas path ignores them too, and its
    ``align_impl="matmul"`` is the roll form up to f32 reassociation.
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
    # int16/float32 [2*block_samples] raw I/Q words.
    input_format: str = "complex64"
    demod: str = "am"
    # The port's only resampler is K1, the counterpart of the JAX package's
    # "pallas"; it is the default here.
    resampler: str = "pallas"
    segments: int = 1
    num_phases: int = 64
    einsum_bf16: bool = False
    interp_taps: int = 2
    frame_loop: str = "vmap"
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


def _check_supported(config: ReconstructionConfig) -> None:
    """Raise for the options this port does not implement yet."""
    if config.resampler != "pallas":
        raise NotImplementedError(
            f"resampler={config.resampler!r}: the port has only K1 (resampler='pallas'); "
            "the gather resampler comes with ROADMAP Queue 1, 'Exact cuts'")
    if config.subsample_align:
        raise NotImplementedError(
            "subsample_align=True: ROADMAP Queue 1, 'Exact cuts'")
    if config.demod != "am":
        raise NotImplementedError(
            f"demod={config.demod!r}: ROADMAP Queue 1, 'FM and planar demod'")
    if config.input_format == "iq_planar":
        raise NotImplementedError(
            "input_format='iq_planar': ROADMAP Queue 1, 'FM and planar demod'")
    if config.input_format == "envelope":
        raise NotImplementedError(
            "input_format='envelope' (the combine front's output): "
            "ROADMAP Queue 1, 'Scan and combine'")
    if config.input_format not in ("complex64", "iq_interleaved"):
        raise ValueError(f"unknown input_format {config.input_format!r}")
    if config.align_interp not in ("linear", "cubic"):
        raise ValueError(f"align_interp must be 'linear' or 'cubic', got {config.align_interp!r}")


@dataclasses.dataclass
class Reconstruction:
    image: np.ndarray        # EMA-averaged aligned frame (render_size)
    frames: np.ndarray       # per-frame aligned screens (n_frames, *render_size)
    sync: np.ndarray         # per-frame (s_y, s_x)
    score: np.ndarray        # per-frame sync contrast score


def demodulate(iq: torch.Tensor, config: ReconstructionConfig) -> torch.Tensor:
    """Demodulation stage: the float32 AM envelope of one block."""
    if config.input_format == "iq_interleaved":
        env = am_envelope_from_iq(iq)
    else:
        env = am_demod(iq)
    return invert_envelope(env) if config.invert else env


def fuses_demod(config: ReconstructionConfig, iq: torch.Tensor) -> bool:
    """Whether the step hands ``iq`` to K1 as raw words, with the demod done
    inside the resampler: interleaved int16 or float32 words, plain AM.  The
    values are those of ``demodulate`` followed by K1 on the envelope."""
    return (config.input_format == "iq_interleaved" and config.demod == "am"
            and not config.invert and iq.dtype in (torch.int16, torch.float32))


def process_frames(
    env: torch.Tensor,
    frame_starts: torch.Tensor,
    config: ReconstructionConfig,
    frame_len: int,
    from_words: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Resample + sync + align all frames of one envelope block: returns
    ``(frames [F,h,w], sync [F,2], score [F])``.  With ``from_words``,
    ``env`` is the block's interleaved I/Q words instead and K1 takes their
    AM envelope itself."""
    mode = config.mode
    resample = frames_to_screens_from_words if from_words else frames_to_screens
    screens = resample(
        env, frame_starts, frame_len, mode.height, mode.width, config.render_size)
    if config.do_align and config.align_subpixel:
        s_y, s_x, score = frame_sync_subpixel(screens)
        aligned = align_frame_subpixel(screens, s_y, s_x, config.align_interp)
        return aligned, torch.stack([s_y, s_x], dim=1), score
    if config.do_align:
        s_y, s_x, score = frame_sync(screens)
        return align_frame(screens, s_y, s_x), torch.stack([s_y, s_x], dim=1), score
    n = screens.shape[0]
    return (screens, torch.zeros((n, 2), dtype=torch.int32, device=env.device),
            torch.zeros(n, dtype=torch.float32, device=env.device))


def ema_fold(ema: torch.Tensor, frames: torch.Tensor, alpha) -> torch.Tensor:
    """EMA over the frame axis (``image = α·image + (1-α)·frame`` per frame)
    in closed form: ``α^F · ema + (1-α) · Σ_n α^(F-1-n) · frame_n``."""
    n = frames.shape[0]
    a = torch.as_tensor(alpha, dtype=torch.float32, device=frames.device)
    k = torch.arange(n - 1, -1, -1, dtype=torch.float32, device=frames.device)
    w = (1.0 - a) * a ** k
    return a ** n * ema + torch.tensordot(w, frames, dims=1)


def carry_phase_starts(phase: float, spf: float, n_frames: int) -> np.ndarray:
    """Rounded frame starts of a carry-phase block, int32 [n_frames].

    The JAX step computes ``floor(phase + spf·k + 0.5)`` in float32, where
    at 36 frames ``spf·k`` reaches 11.7 M and the f32 spacing is 1.0, so a
    float64 computation cuts some frames a sample apart.  This reproduces
    the f32 arithmetic of that expression on the host, one rounding per
    operation, as the JAX program states it."""
    exact = np.float32(phase) + np.float32(spf) * np.arange(n_frames, dtype=np.float32)
    return np.floor(exact + np.float32(0.5)).astype(np.int32)


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            x = np.ascontiguousarray(x, np.complex64)
        return torch.from_numpy(x).to(device)
    return torch.as_tensor(x, device=device)


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
    n_frames = config.n_frames
    spf = config.samples_per_frame
    frame_len = int(np.floor(spf))  # samples fed to the resampler per frame
    static_starts = np.round(np.arange(n_frames) * spf).astype(np.int32)

    def _body(iq, ema, alpha, starts: np.ndarray):
        iq = _as_tensor(iq, device)
        ema = _as_tensor(ema, device).to(torch.float32)
        fstarts = torch.from_numpy(starts).to(device)
        if fuses_demod(config, iq):
            frames, sync, score = process_frames(iq, fstarts, config, frame_len, from_words=True)
        else:
            frames, sync, score = process_frames(
                demodulate(iq, config), fstarts, config, frame_len)
        return ema_fold(ema, frames, alpha), frames, sync, score

    if config.carry_phase:

        def step(iq, ema, alpha, phase):
            return _body(iq, ema, alpha, carry_phase_starts(float(phase), spf, n_frames))

    else:

        def step(iq, ema, alpha):
            return _body(iq, ema, alpha, static_starts)

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
    complex config is taken as interleaved words, as in the JAX package."""
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
    if iq.shape[0] < n:
        raise ValueError(f"need {n} samples for {config.n_frames} frames, got {iq.shape[0]}")
    ema_out, frames, sync, score = step(iq[:n], ema0, alpha)
    return Reconstruction(
        image=ema_out.cpu().numpy(),
        frames=frames.cpu().numpy(),
        sync=sync.cpu().numpy(),
        score=score.cpu().numpy(),
    )
