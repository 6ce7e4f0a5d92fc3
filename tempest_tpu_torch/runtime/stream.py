"""Streaming runtime: source → ring → reconstruction step → frame sink — the
counterpart of the core of ``tempest_tpu/runtime/stream.py``.

A producer thread fills the host ring from a ``SampleSource``; the consumer
takes block after block, uploads it to the device, and runs the carry-phase
step, with the EMA image carried on the device between blocks.  Frame cuts
stay continuous across blocks: the phase of the first frame boundary of each
block comes from the absolute sample position, which follows the ring's
production sequence so that dropped blocks do not shear the frame grid.

Ported so far: construction, ``start``/``stop``, ``process_blocks`` and
checkpoints.  ``correlate``, ``scan``, ``record``, drift feedback,
``health``, the live combine front and the fidelity chain are ROADMAP
Queue 1 items of their own.
"""

from __future__ import annotations

import dataclasses
import threading
from collections.abc import Callable

import numpy as np
import torch

from ..pipeline.offline import ReconstructionConfig, make_reconstruct_fn
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
        config_overrides: dict | None = None,
        device: torch.device | str | None = None,
    ) -> None:
        """``config_overrides`` passes extra ReconstructionConfig fields to
        the step (e.g. ``do_align``, ``align_interp``); the fields the
        runtime owns cannot be overridden.  The JAX runtime's fidelity,
        combine and native-ring options are not ported yet (ROADMAP Queue 1)."""
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
            do_align=True,
            align_subpixel=True,
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
                invert=self.invert,
            ),
            path,
        )

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint written by either runtime.  A state this
        port cannot continue (live combine, fidelity chain) raises."""
        from ..utils.checkpoint import load_state

        state = load_state(path)
        if state.sample_rate != self.source.sample_rate:
            raise ValueError(
                f"checkpoint sample rate {state.sample_rate} != source "
                f"{self.source.sample_rate}")
        if state.combine_centers:
            raise NotImplementedError(
                "checkpoint carries live-combine centres: ROADMAP Queue 1, 'Scan and combine'")
        if state.fidelity:
            raise NotImplementedError(
                "checkpoint carries the fidelity chain: ROADMAP Queue 1, 'Exact cuts'")
        self._mode = state.mode
        self.alpha = state.alpha
        self.invert = state.invert
        self._rebuild()
        self.ema, self.abs_pos = state_from_jax(state.ema, state.abs_pos, self.device)
        # The NEXT delivered block continues the checkpointed stream at
        # state.abs_pos: anchor the sequence-based position tracking there,
        # accounting for any blocks this runtime already consumed.
        consumed = getattr(self.ring, "last_seq", -1) + 1
        self._abs_base = state.abs_pos - consumed * self.source.block_size
        self.frames_out = state.frames_out
