"""Live streaming over a device mesh — the counterpart of
``tempest_tpu/runtime/mesh_stream.py``.

:class:`MeshStreamingRuntime` is the single-device
:class:`~tempest_tpu_torch.runtime.stream.StreamingRuntime` with its step
replaced by the time-sharded step
(:func:`~tempest_tpu_torch.parallel.sharded.sharded_streaming_reconstruct_fn`):
each ring block is split into ``n_shards`` consecutive spans, one a shard,
frame cuts tick on the same global carry-phase grid, and the EMA folds
across the spans.  K1 runs once on every shard a dispatch.

Its semantics are those of the single-device runtime on blocks of
``block / n_shards`` samples, ``n_shards`` of them a dispatch: the same
frames a span, the same grid, the same windows, the same chain — so the two
fed the same stream give the same EMA, frames and sync, to the bit
(``tests/test_torch_mesh_runtime.py``; on the card, ``chip_smoke.py``).

* **One-block lookahead.**  The last shard's halo is the next block's head
  (the true continuation, no circular wrap), so block *t* is dispatched when
  block *t+1* arrives: one block more of latency.  Phases are anchored on
  the ring's production sequence in float64, so a dropped block moves no
  frame; only the halo of the block before the gap comes from another place
  in the signal.
* **Live combining on the same mesh**: the carrier-sharded front
  (:func:`~tempest_tpu_torch.parallel.sharded.sharded_streaming_combine_front`)
  fuses each block's harmonics; the fused envelope stays on the device as
  the pending payload, and its head is the previous block's tail.  Frame-grid
  math stays in source samples, scaled by the channeliser's exact decimation
  M/N on dispatch.  The combine weights are published with the block they
  fused, when that block is dispatched.
* **The fidelity chain** (``fidelity=True``) runs on the mesh as on one
  device: float64 exact cuts per span, residuals into K1.
* ``process_blocks`` says how many blocks it dispatched: on the image it
  returns (``.dispatched``) and in ``health()["mesh"]``.  Fewer than asked
  means the ring closed first.
* Everything else — ring, producer thread, correlate, scan, record,
  console, web view, checkpoints (resumable by either package's runtime) —
  is inherited; a config change rebuilds the mesh step and drops the
  pending block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.scan import _channel_geometry
from ..parallel.mesh import Mesh, ProcessGroupCollectives
from ..parallel.sharded import sharded_streaming_combine_front, sharded_streaming_reconstruct_fn
from ..utils.profiling import annotate
from ..video.modes import VideoMode
from .sources import SampleSource
from .stream import FrameSink, StreamingRuntime

__all__ = ["MeshStreamingRuntime", "DispatchedImage"]


class DispatchedImage(np.ndarray):
    """The EMA image that :meth:`MeshStreamingRuntime.process_blocks`
    returns, with ``dispatched``: the blocks that call dispatched."""

    dispatched: int = 0


class MeshStreamingRuntime(StreamingRuntime):
    """Block-streaming executor whose step spans the shards of ``mesh``
    along ``axis``; the EMA and outputs live on ``mesh.device``."""

    def __init__(
        self,
        source: SampleSource,
        mode: VideoMode,
        mesh: Mesh,
        axis: str = "blocks",
        n_frames_per_shard: int | None = None,
        alpha: float = 0.1,
        ring_depth: int = 16,
        invert: bool = False,
        ring_impl: str = "python",
        fidelity: bool = False,
        fidelity_bins: int = 64,
        config_overrides: dict | None = None,
        combine: list[float] | None = None,
        combine_bw: float = 4e6,
        combine_demod: str = "am",
        combine_excise_db: float | None = None,
    ) -> None:
        self.mesh = mesh
        self._mesh_axis = axis
        # (payload, absolute position, the combine weights of that block,
        # its production sequence)
        self._pending: tuple | None = None
        self._mesh_front = None
        self.dispatched = 0          # blocks dispatched by the last process_blocks
        self.dispatched_total = 0
        super().__init__(
            source, mode, n_frames_per_block=n_frames_per_shard, alpha=alpha,
            ring_depth=ring_depth, invert=invert, ring_impl=ring_impl, fidelity=fidelity,
            fidelity_bins=fidelity_bins, config_overrides=config_overrides, combine=combine,
            combine_bw=combine_bw, combine_demod=combine_demod,
            combine_excise_db=combine_excise_db, device=mesh.device)

    # ------------------------------------------------------------ config
    def _rebuild(self) -> None:
        n_shards = self.mesh.shape[self._mesh_axis]
        block = self.source.block_size
        fs = self.source.sample_rate
        self._spf = fs / self._mode.refresh
        if self._combine_centers:
            n_fft, m_chan, fs_chan = _channel_geometry(block, fs, self._combine_bw)
            if block != n_fft:
                # The lookahead tail is the NEXT block's envelope head: with
                # block > N the chain would take it as continuing at N, a
                # tear of (block − N)·M/N channel samples in the last shard's
                # halo every dispatch.
                raise ValueError(
                    f"mesh live combine needs a power-of-two block size (the channeliser "
                    f"FFT window): block {block} vs window {n_fft} — use block_size={n_fft} "
                    f"(cli: --block-seconds {n_fft / fs:.6f})")
            if m_chan % n_shards:
                raise ValueError(f"channel length {m_chan} must divide into {n_shards} "
                                 "equal envelope spans")
            S, chain_fs = m_chan // n_shards, fs_chan
            self._phase_scale = m_chan / n_fft
            self._combine_geometry = (n_fft, m_chan, fs_chan)
            self._mesh_front = sharded_streaming_combine_front(
                fs, block, np.asarray(self._combine_centers), self._mode.refresh, self.mesh,
                self._mesh_axis, chan_bw=self._combine_bw, demod=self._combine_demod,
                excise_db=self._combine_excise)
        else:
            if block % n_shards:
                raise ValueError(f"source block_size {block} must divide into {n_shards} "
                                 "equal shard spans")
            S, chain_fs = block // n_shards, fs
            self._phase_scale = 1.0
            self._combine_geometry = None
            self._mesh_front = None
        # The single-device runtime's chain with the window set to ONE SPAN:
        # that makes the mesh step per-span identical to blocks of S samples.
        self.config = self._chain_config(chain_fs, S)
        self.abs_pos = 0
        self.combine_weights = None
        # A config change unpairs the pending block from the new geometry:
        # drop it (one block of signal, as a ring drop).
        self._pending = None
        self._step = sharded_streaming_reconstruct_fn(self.config, self.mesh, S, self._mesh_axis)

    # ---------------------------------------------------------- consumer
    def process_blocks(
        self,
        n_blocks: int,
        sink: FrameSink | None = None,
        emit_every_frame: bool = False,
    ) -> DispatchedImage:
        """Dispatch ``n_blocks`` ring blocks through the mesh step.

        Because the last shard's halo is the NEXT block's head, the first
        call primes a one-block lookahead (``n_blocks`` dispatches take
        ``n_blocks + 1`` ring blocks; the last stays pending for the next
        call).  ``sink(image, info)`` is called once a dispatch (or once a
        frame with ``emit_every_frame``).  Returns the final EMA as a host
        image whose ``dispatched`` is the count of blocks this call
        dispatched, fewer than ``n_blocks`` when the ring closed first; the
        device copy stays on ``self.ema``."""
        ema = self.ema
        block = self.source.block_size
        step = self._step
        n_shards, S, ov = step.n_shards, step.shard_samples, step.overlap
        # Chain-grid frame period: source samples, or channel samples scaled
        # by the exact decimation M/N when the front is active.
        spf_chain = self._spf * self._phase_scale
        dispatched = 0
        while dispatched < n_blocks:
            # A block's span is the dispatch of the pending block, under its
            # sequence, and the take of the next.
            with annotate("runtime.block") as span:
                buf = np.empty(block, np.complex64)
                if self.ring.take(buf) is None:
                    if self._producer_error is not None:
                        raise RuntimeError("sample source failed") from self._producer_error
                    break
                seq = getattr(self.ring, "last_seq", -1)
                if seq >= 0:
                    abs_this = self._abs_base + seq * block
                elif self._pending is not None:
                    abs_this = self._pending[1] + block
                else:
                    abs_this = self.abs_pos
                weights = None
                if self._mesh_front is not None:
                    # Fuse THIS block's carriers now; the envelope stays on
                    # the device as the pending payload (its head is also
                    # the tail of the block dispatched below).
                    payload, w, pol, mass = self._mesh_front(
                        torch.from_numpy(buf.view(np.float32)).to(self.device))
                    weights = (w, pol, mass)
                else:
                    payload = buf
                if self._pending is not None:
                    prev, ppos, prev_weights, span.request = self._pending
                    # Phases stay float64 on the host, as the single-device
                    # runtime computes them block by block.
                    if self._mesh_front is not None:
                        rows = prev[: n_shards * S].reshape(n_shards, S)
                        tail = payload[:ov]
                        ph0 = ((-ppos) % self._spf) * self._phase_scale
                        phases = [(ph0 - d * S) % spf_chain for d in range(n_shards)]
                    else:
                        rows = prev.view(np.float32).reshape(n_shards, 2 * S)
                        tail = np.ascontiguousarray(buf[:ov]).view(np.float32)
                        phases = [(-(ppos + d * S)) % self._spf for d in range(n_shards)]
                    with annotate("runtime.dispatch"):
                        ema, frames, sync, score = step(rows, tail, ema, self.alpha, phases)
                    # The weights of the block whose envelope was just
                    # dispatched.
                    self.combine_weights = prev_weights
                    self.abs_pos = ppos + block
                    self.frames_out += frames.shape[0]
                    dispatched += 1
                    if sink is not None:
                        self._sink(sink, ema, frames, sync, score, emit_every_frame)
                self._pending = (payload, abs_this, weights, seq)
        self.ema = ema
        self.dispatched = dispatched
        self.dispatched_total += dispatched
        image = ema.cpu().numpy().view(DispatchedImage)
        image.dispatched = dispatched
        return image

    # -------------------------------------------------- failure detection
    def health(self) -> dict:
        h = super().health()
        h["mesh"] = {
            "n_shards": int(self.mesh.shape[self._mesh_axis]),
            "axis": self._mesh_axis,
            "devices": [str(d) for d in self.mesh.devices],
            "processes": isinstance(self.mesh.comm, ProcessGroupCollectives),
            "shard_samples": int(self._step.shard_samples),
            "frames_per_shard": int(self._step.n_frames),
            "halo_samples": int(self._step.overlap),
            "pending_block": self._pending is not None,
            "dispatched": self.dispatched,
            "dispatched_total": self.dispatched_total,
        }
        return h
