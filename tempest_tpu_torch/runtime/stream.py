"""Streaming runtime: source → ring → reconstruction step → frame sink — the
counterpart of the core of ``tempest_tpu/runtime/stream.py``.

A producer thread fills the host ring from a ``SampleSource``; the consumer
takes block after block, uploads it to the device, and runs the carry-phase
step, with the EMA image carried on the device between blocks.  Frame cuts
stay continuous across blocks: the phase of the first frame boundary of each
block comes from the absolute sample position, which follows the ring's
production sequence so that dropped blocks do not shear the frame grid.

Ported so far: construction, ``start``/``stop``, ``process_blocks``, the
fidelity chain (``fidelity=True``, ``set_fidelity``), ``correlate`` with the
mode hot-swap, and checkpoints.  ``scan``, ``record``, drift feedback,
``health``, the operator overrides and the live combine front are ROADMAP
Queue 1 items of their own.
"""

from __future__ import annotations

import dataclasses
import threading
from collections.abc import Callable

import numpy as np
import torch

from ..pipeline.offline import (
    ReconstructionConfig,
    TimingEstimate,
    estimate_timing,
    make_reconstruct_fn,
    timing_evidence,
)
from ..utils.device import resolve_device
from ..video.modes import VideoMode
from .ring import RingBuffer
from .sources import SampleSource

__all__ = ["StreamingRuntime", "frames_per_window", "state_from_jax"]

FrameSink = Callable[[np.ndarray, dict], None]


def frames_per_window(cap: int, spf: float) -> int:
    """Whole frame periods fitting one block of ``cap`` samples after a frame
    period of phase headroom + fractional-cut slack."""
    n = max(int((cap - 2 - spf) / spf), 1)
    while n > 1 and int(np.ceil(spf * n)) + 1 + int(np.ceil(spf)) > cap:
        n -= 1
    return n


def state_from_jax(
    ema: np.ndarray, abs_pos: int, device: torch.device | str | None = None
) -> tuple[torch.Tensor, int]:
    """Streaming state held by a live JAX runtime (its EMA image, as a numpy
    array, and its absolute sample position) → the port's device EMA tensor
    and position, ready to assign to ``StreamingRuntime.ema``/``abs_pos``.
    ``device=None`` is the CUDA card (raises when there is none)."""
    ema_t = torch.from_numpy(np.ascontiguousarray(ema, np.float32)).to(resolve_device(device))
    return ema_t, int(abs_pos)


class StreamingRuntime:
    """Block-streaming executor around one ``SampleSource``, on ``device``
    (``None``: the CUDA card; raises when there is none)."""

    def __init__(
        self,
        source: SampleSource,
        mode: VideoMode,
        n_frames_per_block: int | None = None,
        alpha: float = 0.1,
        ring_depth: int = 16,
        invert: bool = False,
        fidelity: bool = False,
        fidelity_bins: int = 64,
        config_overrides: dict | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        """``fidelity=True`` selects the fidelity chain: sub-sample-exact
        frame cuts with the per-frame sync stage skipped.  K1 takes each
        frame's exact residual, computed in float64 from the absolute sample
        position; pair it with a drift-locked refresh (``correlate()``), since
        nothing re-registers the frames.  ``fidelity_bins`` is the JAX
        runtime's phase quantisation of its table-driven fidelity program: it
        is kept, checkpointed and handed to the config, and changes no value
        here.

        ``config_overrides`` passes extra ReconstructionConfig fields to
        the step (e.g. ``do_align``, ``align_interp``, ``interp_taps``,
        ``resampler``); the fields the runtime owns cannot be overridden.
        The JAX runtime's combine and native-ring options are not ported yet
        (ROADMAP Queue 1)."""
        if config_overrides:
            owned = {"carry_phase", "input_format", "n_frames", "mode",
                     "sample_rate", "block_samples"}
            bad = owned & set(config_overrides)
            if bad:
                raise ValueError(f"config_overrides may not set {sorted(bad)}"
                                 " — the streaming runtime owns these")
        self._overrides = dict(config_overrides or {})
        self.device = resolve_device(device)
        self.source = source
        self.alpha = alpha
        self.invert = invert
        self.fidelity = fidelity
        self.fidelity_bins = fidelity_bins
        self._mode = mode
        self._n_frames_fixed = n_frames_per_block
        self._rebuild()
        self.ring = RingBuffer(source.block_size, ring_depth)
        self._producer: threading.Thread | None = None
        self._stop = threading.Event()
        self._producer_error: BaseException | None = None
        self.ema = torch.zeros(self.config.render_size, dtype=torch.float32, device=self.device)
        # Block seq 0 of this runtime's source sits at this stream offset
        # (nonzero after a checkpoint resume).
        self._abs_base = 0
        self.frames_out = 0
        self.last_evidence = None      # TimingEvidence from correlate()
        self.last_correlate_gaps = 0   # ring gaps detected by correlate()

    # ------------------------------------------------------------ config
    def _rebuild(self) -> None:
        spf = self.source.sample_rate / self._mode.refresh
        cap = self.source.block_size
        self._n_frames = (frames_per_window(cap, spf) if self._n_frames_fixed is None
                          else self._n_frames_fixed)
        self.config = ReconstructionConfig(
            sample_rate=self.source.sample_rate,
            mode=self._mode,
            n_frames=self._n_frames,
            invert=self.invert,
            carry_phase=True,
            input_format="iq_interleaved",
            resampler="pallas",
            subsample_align=self.fidelity,
            do_align=not self.fidelity,
            align_subpixel=not self.fidelity,
            phase_bins=self.fidelity_bins if self.fidelity else 0,
        )
        if self._overrides:
            self.config = dataclasses.replace(self.config, **self._overrides)
        self._spf = spf
        self.abs_pos = 0  # absolute source-sample index of the next block
        if self.config.block_samples > cap:
            raise ValueError(
                f"blocks ({cap} samples) are smaller than "
                f"{self._n_frames} frame periods ({self.config.block_samples})")
        self._step = make_reconstruct_fn(self.config, self.device)

    @property
    def mode(self) -> VideoMode:
        return self._mode

    @mode.setter
    def mode(self, new_mode: VideoMode) -> None:
        """Hot-swap the video configuration: the step is rebuilt for it."""
        self._mode = new_mode
        self._rebuild()

    def set_fidelity(self, on: bool) -> None:
        """Hot-swap between the default chain (rounded cuts + per-frame
        sync) and the fidelity chain (sub-sample-exact cuts, sync skipped).
        Typical flow: warm up with sync on, lock the refresh, then switch
        fidelity on with the frame grid drift-locked."""
        self.fidelity = on
        self._rebuild()

    # ---------------------------------------------------------- producer
    def start(self) -> None:
        """Spawn the producer thread that fills the ring from the source."""
        if self._producer is not None:
            return
        self._stop.clear()

        def _produce() -> None:
            block = np.empty(self.source.block_size, np.complex64)
            try:
                while not self._stop.is_set():
                    self.source.read(block)
                    self.ring.put(block)
            except BaseException as exc:  # surfaced to the consumer, not lost
                self._producer_error = exc
                self.ring.close()

        self._producer = threading.Thread(target=_produce, daemon=True, name="sdr-producer")
        self._producer.start()

    def stop(self) -> None:
        """Cooperative shutdown: stop the producer, close ring and source."""
        self._stop.set()
        self.ring.close()
        if self._producer is not None:
            self._producer.join(timeout=5.0)
            self._producer = None
        self.source.close()

    # ---------------------------------------------------------- consumer
    def _resync_abs_pos(self) -> None:
        """Re-anchor the absolute sample position to the block just taken,
        from the ring's production sequence (the overwrite-oldest ring drops
        blocks silently when the consumer lags)."""
        seq = getattr(self.ring, "last_seq", -1)
        if seq >= 0:
            self.abs_pos = self._abs_base + seq * self.source.block_size

    def process_blocks(
        self,
        n_blocks: int,
        sink: FrameSink | None = None,
        emit_every_frame: bool = False,
    ) -> np.ndarray:
        """Consume up to ``n_blocks`` from the ring through the step.

        ``sink(image, info)`` is called once per block with the EMA image (or
        per frame with ``emit_every_frame``).  Returns the final EMA image as
        a host array; the device copy stays on ``self.ema``."""
        ema = self.ema
        for _ in range(n_blocks):
            # A FRESH host buffer per block.  The copy below is a blocking
            # one from pageable memory; if it ever becomes non_blocking from
            # pinned memory, a reused buffer could be overwritten by the next
            # ring.take while its copy is still in flight.
            buf = np.empty(self.source.block_size, np.complex64)
            if self.ring.take(buf) is None:
                if self._producer_error is not None:
                    raise RuntimeError("sample source failed") from self._producer_error
                break
            self._resync_abs_pos()
            # Fractional offset of the next absolute frame boundary (frames
            # tick at multiples of spf from stream start) inside this block.
            phase = (-self.abs_pos) % self._spf
            words = buf[: self.config.block_samples].view(np.float32)
            iq = torch.from_numpy(words).to(self.device)
            ema, frames, sync, score = self._step(iq, ema, self.alpha, phase)
            self.abs_pos += self.source.block_size
            self.frames_out += frames.shape[0]
            if sink is not None:
                info = {
                    "sync": sync.cpu().numpy(),
                    "score": score.cpu().numpy(),
                    "mode": self._mode,
                    "frames_out": self.frames_out,
                }
                if emit_every_frame:
                    for f in frames.cpu().numpy():
                        sink(f, info)
                else:
                    sink(ema.cpu().numpy(), info)
        self.ema = ema
        return ema.cpu().numpy()

    # ------------------------------------------------------------- tasks
    def _gather_window(self, seconds: float) -> np.ndarray:
        """Take ~``seconds`` of CONTIGUOUS signal from the ring (complex64).

        Sequence-fenced against ring-overflow gaps: a dropped block inside a
        concatenated window puts a frame-phase discontinuity in it, which
        dilutes the refresh comb.  A gap restarts the run; bounded retakes
        get a fully contiguous window in all but pathological cases, else
        the longest contiguous run is used.  The gap count lands on
        ``self.last_correlate_gaps``."""
        n_needed = int(np.ceil(seconds * self.source.sample_rate))
        n_blocks = max(1 + n_needed // self.source.block_size, 1)
        chunks: list[np.ndarray] = []
        best_run: list[np.ndarray] = []
        buf = np.empty(self.source.block_size, np.complex64)
        prev_seq = None
        gaps = 0
        max_takes = max(4 * n_blocks, n_blocks + 8)
        for _ in range(max_takes):
            if self.ring.take(buf) is None:
                raise RuntimeError("ring closed while gathering a window")
            self._resync_abs_pos()
            seq = getattr(self.ring, "last_seq", -1)
            self.abs_pos += self.source.block_size  # keep the frame grid honest
            if prev_seq is not None and seq >= 0 and seq != prev_seq + 1:
                gaps += 1
                if len(chunks) > len(best_run):
                    best_run = chunks
                chunks = []
            prev_seq = seq if seq >= 0 else (prev_seq + 1 if prev_seq is not None else None)
            chunks.append(buf.copy())
            if len(chunks) >= n_blocks:
                break
        if len(best_run) > len(chunks):
            chunks = best_run
        self.last_correlate_gaps = gaps
        return np.concatenate(chunks)

    def correlate(
        self,
        seconds: float = 0.1,
        rate_min: float = 50.0,
        rate_max: float = 90.0,
        keep_evidence: bool = False,
    ) -> TimingEstimate:
        """Re-estimate timing from the live stream, on the runtime's device,
        and hot-swap the detected mode.

        ``rate_min``/``rate_max`` bound the refresh search band [Hz].  With
        ``keep_evidence`` the correlation windows behind the estimate are
        kept on ``self.last_evidence``.  The window is contiguous signal (see
        ``_gather_window``); a shortened window still estimates correctly, so
        the correlation seconds follow the signal actually gathered."""
        sig = self._gather_window(seconds)
        fs = self.source.sample_rate
        seconds = min(seconds, len(sig) / fs)
        if keep_evidence:
            timing, self.last_evidence = timing_evidence(
                sig, fs, seconds, rate_min, rate_max, device=self.device)
        else:
            timing = estimate_timing(sig, fs, seconds, rate_min, rate_max, device=self.device)
        self.mode = timing.mode
        return timing

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, path: str) -> None:
        """Persist the streaming state (EMA image, frame phase, config) in
        the JAX package's ``.npz`` format, so either runtime can resume it."""
        from ..utils.checkpoint import RuntimeState, save_state

        save_state(
            RuntimeState(
                ema=self.ema.cpu().numpy(),
                abs_pos=self.abs_pos,
                mode=self._mode,
                sample_rate=self.source.sample_rate,
                alpha=self.alpha,
                frames_out=self.frames_out,
                fidelity=self.fidelity,
                fidelity_bins=self.fidelity_bins,
                invert=self.invert,
            ),
            path,
        )

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint written by either runtime, its chain
        (default or fidelity) included.  A state this port cannot continue
        (live combine) raises."""
        from ..utils.checkpoint import load_state

        state = load_state(path)
        if state.sample_rate != self.source.sample_rate:
            raise ValueError(
                f"checkpoint sample rate {state.sample_rate} != source "
                f"{self.source.sample_rate}")
        if state.combine_centers:
            raise NotImplementedError(
                "checkpoint carries live-combine centres: ROADMAP Queue 1, 'Scan and combine'")
        self._mode = state.mode
        self.alpha = state.alpha
        self.fidelity = state.fidelity
        self.fidelity_bins = state.fidelity_bins
        self.invert = state.invert
        self._rebuild()
        self.ema, self.abs_pos = state_from_jax(state.ema, state.abs_pos, self.device)
        # The NEXT delivered block continues the checkpointed stream at
        # state.abs_pos: anchor the sequence-based position tracking there,
        # accounting for any blocks this runtime already consumed.
        consumed = getattr(self.ring, "last_seq", -1) + 1
        self._abs_base = state.abs_pos - consumed * self.source.block_size
        self.frames_out = state.frames_out
