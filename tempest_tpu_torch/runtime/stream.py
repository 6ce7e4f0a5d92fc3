"""Streaming runtime: source → ring → reconstruction step → frame sink — the
counterpart of ``tempest_tpu/runtime/stream.py``.

A producer thread fills the host ring from a ``SampleSource``; the consumer
takes block after block, uploads it to the device, and runs the carry-phase
step, with the EMA image carried on the device between blocks.  Frame cuts
stay continuous across blocks: the phase of the first frame boundary of each
block comes from the absolute sample position, which follows the ring's
production sequence so that dropped blocks do not shear the frame grid.

With live combining (``combine=[...]``, ``set_combine``, ``combine_auto``)
every block is channelised at the given carrier offsets, the channels'
envelopes are fused at maximal ratio on the device (``ops.combine``), and the
chain runs on the fused envelope at the channel rate: it goes from the
combine front to K1's envelope entry without leaving the device.

The tasks beside the steady state: ``correlate`` re-estimates the video mode
from the live stream, ``scan`` retunes a tunable source across candidate
carriers and scores each dwell, ``record`` dumps raw blocks to a ``.dat``
capture, ``refine_refresh_from_drift`` closes the loop on the refresh rate,
``health`` and ``summary`` report liveness.  Config changes (refresh, line
count, alpha, fidelity, combine) are plain calls that rebuild the step for
the next block; checkpoints are in the JAX package's format, so either
runtime resumes the other's.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections.abc import Callable

import numpy as np
import torch

from ..io.dat import write_complex_binary
from ..ops.combine import combine_core
from ..ops.scan import _channel_geometry, _noise_floor, carrier_score, check_excise_demod
from ..pipeline.offline import (
    ReconstructionConfig,
    TimingEstimate,
    discover_screens,
    estimate_timing,
    make_reconstruct_fn,
    pick_line_peak,
    timing_evidence,
)
from ..render.plots import sparkline
from ..utils.device import resolve_device
from ..utils.profiling import annotate, count, enabled, summary
from ..video.modes import VideoMode, find_closest_mode
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
        ring_impl: str = "python",
        fidelity: bool = False,
        fidelity_bins: int = 64,
        config_overrides: dict | None = None,
        combine: list[float] | None = None,
        combine_bw: float = 4e6,
        combine_demod: str = "am",
        combine_excise_db: float | None = None,
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

        ``combine`` (carrier offsets in Hz from the source's tuned centre)
        turns live multi-harmonic combining on: every block is channelised
        at these carriers in channels of ``combine_bw`` and the MRC-fused
        envelope feeds the chain at the channel rate.  ``combine_demod`` is
        the front's per-channel demodulator, ``"am"`` or ``"fm"``;
        ``combine_excise_db`` opts into the spectral excision of in-channel
        CW interference (``ops.scan._excise_spikes``, AM only).

        ``ring_impl="native"`` takes the C++ ring of ``native/`` (built on
        demand with g++) instead of the Python one; same overwrite-oldest
        semantics."""
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
        self._combine_centers = list(combine) if combine else None
        self._combine_bw = float(combine_bw)
        self._combine_demod = str(combine_demod)
        self._combine_excise = combine_excise_db
        self._combine_front = None     # words -> (env, w, pol, mass)
        self.combine_weights = None    # device tensors from the last block
        self._rebuild()
        if ring_impl == "native":
            from ..native import NativeRing

            self.ring = NativeRing(source.block_size, ring_depth)
        else:
            self.ring = RingBuffer(source.block_size, ring_depth)
        self._producer: threading.Thread | None = None
        self._stop = threading.Event()
        self._producer_error: BaseException | None = None
        self.ema = torch.zeros(self.config.render_size, dtype=torch.float32, device=self.device)
        # Block seq 0 of this runtime's source sits at this stream offset
        # (nonzero after a checkpoint resume).
        self._abs_base = 0
        self.frames_out = 0
        self._record_idx = 0           # next auto-rotated capture index
        self.last_record_path: str | None = None
        self.last_evidence = None      # TimingEvidence from correlate()
        self.corr_spark: str | None = None  # HUD sparkline of the evidence
        self.last_correlate_gaps = 0   # ring gaps detected by correlate()

    # ------------------------------------------------------------ config
    def _rebuild(self) -> None:
        # With live combining the chain runs on the CHANNEL-rate fused
        # envelope: each source block of block_size complex samples is
        # channelised over its first N (power-of-two) samples into M channel
        # samples at fs·M/N.  Frame-phase accounting stays in SOURCE samples
        # (frames tick at multiples of the source-rate frame period from
        # stream start); the per-block phase is scaled by M/N on dispatch,
        # which also absorbs the (block_size − N) source samples the FFT
        # window does not cover — the next block re-anchors exactly.
        if self._combine_centers:
            n_fft, m_chan, fs_chan = _channel_geometry(
                self.source.block_size, self.source.sample_rate, self._combine_bw)
            chain_fs, cap = fs_chan, m_chan
            self._phase_scale = m_chan / n_fft
            self._upload_samples = n_fft
            self._combine_geometry = (n_fft, m_chan, fs_chan)
        else:
            chain_fs, cap = self.source.sample_rate, self.source.block_size
            self._phase_scale = 1.0
            self._upload_samples = None  # the chain's block, set below
            self._combine_geometry = None
        self.config = self._chain_config(chain_fs, cap)
        self._spf = self.source.sample_rate / self._mode.refresh
        self.abs_pos = 0  # absolute SOURCE-sample index of the next block
        if self.config.block_samples > cap:
            raise ValueError(
                f"blocks ({cap} chain samples) are smaller than "
                f"{self._n_frames} frame periods ({self.config.block_samples})")
        if self._upload_samples is None:
            self._upload_samples = self.config.block_samples
        self._step = make_reconstruct_fn(self.config, self.device)
        self._combine_front = self._make_combine_front() if self._combine_centers else None

    def _chain_config(self, chain_fs: float, cap: int) -> ReconstructionConfig:
        """The chain's config at ``chain_fs`` for windows of ``cap`` samples
        (one block, or one span of the mesh runtime's block): as many whole
        frame periods as fit, re-derived on every mode change (a slower
        refresh may fit one frame less); default or fidelity chain; the
        overrides on top."""
        spf = chain_fs / self._mode.refresh
        self._n_frames = (frames_per_window(cap, spf) if self._n_frames_fixed is None
                          else self._n_frames_fixed)
        config = ReconstructionConfig(
            sample_rate=chain_fs,
            mode=self._mode,
            n_frames=self._n_frames,
            invert=self.invert,
            carry_phase=True,
            input_format="envelope" if self._combine_centers else "iq_interleaved",
            resampler="pallas",
            subsample_align=self.fidelity,
            do_align=not self.fidelity,
            align_subpixel=not self.fidelity,
            phase_bins=self.fidelity_bins if self.fidelity else 0,
        )
        return dataclasses.replace(config, **self._overrides) if self._overrides else config

    def _make_combine_front(self):
        """The per-block combine front: raw I/Q words on the device → the
        MRC-fused envelope (cut to the chain's block length) + channel
        diagnostics, all tensors there.  The runtime KNOWS the refresh (its
        video mode), so the comb masses are read at the known frame lags
        (``combine_core``'s ``refresh_hz`` path) instead of a full
        autocorrelation and period search per channel."""
        _, _, fs_chan = self._combine_geometry
        fs = float(self.source.sample_rate)
        bw = float(self._combine_bw)
        centers = tuple(float(c) for c in self._combine_centers)
        fv = float(self._mode.refresh)
        block_len = self.config.block_samples
        demod = self._combine_demod
        excise = self._combine_excise
        # Fail at construction / set_combine / resume, not at the first
        # block: excision's carrier-relative criterion is AM-only.
        check_excise_demod(demod, excise)

        def front(words: torch.Tensor):
            env, w, pol, mass, _ = combine_core(
                words, fs, centers, bw, fs_chan, 0.1, max(fv - 5.0, 20.0), fv + 5.0,
                "mrc", refresh_hz=fv, demod=demod, excise_db=excise)
            return env[:block_len], w, pol, mass

        return front

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

    # ------------------------------------------------- operator overrides
    def set_refresh(self, fv: float) -> None:
        """Override the refresh rate [Hz], keeping the pixel geometry."""
        m = self._mode
        self.mode = VideoMode(m.width, m.height, float(fv))

    def set_line_count(self, y_t: int) -> None:
        """Override the total line count, keeping width and refresh."""
        m = self._mode
        self.mode = VideoMode(m.width, int(y_t), m.refresh)

    def nudge_lines(self, delta: int = 1) -> int:
        """±N-line nudge — the standard manual fix when the image shears.
        Returns the new line count."""
        self.set_line_count(self._mode.height + delta)
        return self._mode.height

    def snap_to_mode(self) -> str:
        """Re-match the current (line count, refresh) against the video-mode
        table and adopt the winner's pixel geometry, keeping the measured
        refresh.  Returns the matched mode name."""
        m = self._mode
        name, best = find_closest_mode(m.height, m.refresh)
        self.mode = VideoMode(best.width, best.height, m.refresh)
        return name

    def pick_line_peak(self, n: int) -> str:
        """Adopt ranked line-period peak ``n`` from the last correlation
        evidence (``correlate(keep_evidence=True)``): the recovery when the
        automatic lock took the wrong peak.  Returns the matched mode name."""
        if self.last_evidence is None:
            raise RuntimeError(
                "no correlation evidence — run correlate(keep_evidence=True) first")
        m = self._mode
        timing = TimingEstimate(m.refresh, m.height, "", m)
        picked = pick_line_peak(timing, self.last_evidence, n)
        self.mode = picked.mode
        return picked.mode_name

    def set_combine(self, centers_hz: list[float] | None,
                    chan_bw: float | None = None,
                    demod: str | None = None,
                    excise_db: float | None | str = "keep") -> None:
        """Turn live multi-harmonic combining on (carrier offsets in Hz,
        relative to the source's tuned centre) or off (``None``) mid-stream.
        Every block is then channelised at these carriers and the MRC-fused
        envelope (``ops.combine``) feeds the reconstruction chain at the
        channel rate — the per-channel weights/polarity/comb-mass of the
        last block are kept on ``self.combine_weights``.  ``demod`` switches
        the front's per-channel demodulator ("am"/"fm") — ``None`` keeps the
        current setting.  ``excise_db`` sets the CW-excision margin (a
        float) or turns it off (``None``); the default string ``"keep"``
        leaves it unchanged."""
        self._combine_centers = list(centers_hz) if centers_hz else None
        if chan_bw is not None:
            self._combine_bw = float(chan_bw)
        if demod is not None:
            self._combine_demod = str(demod)
        if excise_db != "keep":
            self._combine_excise = excise_db
        self.combine_weights = None
        self._rebuild()

    def combine_auto(self, seconds: float = 0.4,
                     min_margin_db: float = 5.0,
                     refresh_tol_hz: float = 0.5) -> list[float]:
        """Discover the strongest screen's carriers from the live stream and
        switch combining onto them: gather a contiguous window from the
        ring (sequence-fenced), run the band scan + same-refresh emission
        grouping (``pipeline.offline.discover_screens``) on the runtime's
        device, and ``set_combine`` the winning screen's channel centres.
        Returns the centres chosen (empty list = nothing detected, combining
        off).

        The discovered screen's measured refresh RE-ANCHORS the runtime
        mode first: the combine front takes its comb lags and ±5 Hz gate
        band from ``self.mode.refresh``, so a mode nobody ``correlate()``d
        (or a stale one) would silently score the wrong lags and degrade
        every weight.  When the discovery disagrees by more than
        ``refresh_tol_hz`` the emission's refresh is adopted; within the
        tolerance the current — possibly mHz-refined — lock is kept."""
        sig = self._gather_window(seconds)
        screens = discover_screens(
            np.ascontiguousarray(sig, np.complex64).view(np.float32),
            self.source.sample_rate, self._combine_bw,
            min_margin_db=min_margin_db, device=self.device)
        centers = [e["best_channel_hz"] for e in screens[0]] if screens else []
        if centers:
            fv_disc = float(screens[0][0]["refresh_hz"])
            if abs(fv_disc - self._mode.refresh) > refresh_tol_hz:
                self._mode = VideoMode(self._mode.width, self._mode.height, fv_disc)
        self.set_combine(centers or None)
        return centers

    # -------------------------------------------------------- live retuning
    def _source_call(self, name: str, what: str, value: float) -> None:
        fn = getattr(self.source, name, None)
        if fn is None:
            raise AttributeError(f"{type(self.source).__name__} does not support {what}")
        fn(value)

    def set_carrier(self, freq: float) -> None:
        """Retune the source's carrier frequency mid-stream.  Raises for
        sources without a tuner (replay/synthetic)."""
        self._source_call("set_carrier", "carrier retuning", freq)

    def set_gain(self, gain: float) -> None:
        """Update the source's RX gain mid-stream."""
        self._source_call("set_gain", "gain control", gain)

    def set_sample_rate(self, rate: float) -> None:
        """Update the source sample rate and rebuild the step, whose shapes
        derive from it."""
        self._source_call("set_sample_rate", "rate changes", rate)
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
        for _ in range(n_blocks):
            with annotate("runtime.block") as span:
                # A FRESH host buffer per block.  The copy below is a
                # blocking one from pageable memory; if it ever becomes
                # non_blocking from pinned memory, a reused buffer could be
                # overwritten by the next ring.take while its copy is still
                # in flight.
                buf = np.empty(self.source.block_size, np.complex64)
                if self.ring.take(buf) is None:
                    if self._producer_error is not None:
                        raise RuntimeError("sample source failed") from self._producer_error
                    break
                if enabled():
                    span.request = self.ring.last_seq
                self._resync_abs_pos()
                # Fractional offset of the next absolute frame boundary
                # (frames tick at multiples of spf from stream start) inside
                # this block.
                phase = (-self.abs_pos) % self._spf
                words = buf[: self._upload_samples].view(np.float32)
                with annotate("runtime.upload"):
                    iq = torch.from_numpy(words).to(self.device)
                count("runtime.upload.bytes", words.nbytes)
                ema, frames, sync, score = self.step_words(iq, phase)
                self.abs_pos += self.source.block_size
                self.frames_out += frames.shape[0]
                if sink is not None:
                    self._sink(sink, ema, frames, sync, score, emit_every_frame)
        return self.ema.cpu().numpy()

    def step_words(self, iq: torch.Tensor, phase: float):
        """One block through the runtime's device path, as ``process_blocks``
        runs it: ``iq`` is the block's interleaved float32 I/Q words on the
        runtime's device (its first ``_upload_samples`` complex samples),
        ``phase`` the offset of the next absolute frame boundary in it, in
        source samples.  With combining on, the combine front fuses the
        block's channels (their weights, polarities and comb masses on
        ``self.combine_weights``) and the step runs on the fused envelope at
        the channel rate; without it, the step runs on the words.  Threads
        ``self.ema``; returns ``(ema, frames, sync, score)``, tensors on the
        device."""
        with annotate("runtime.step"):
            if self._combine_front is not None:
                # Channelise + MRC-fuse on the device; the envelope feeds the
                # chain at the channel rate without a host round trip.  The
                # phase is scaled to channel samples BEFORE the step takes its
                # frame starts and residuals from it.
                with annotate("runtime.combine"):
                    count("runtime.combine.bytes",
                          2 * self._combine_geometry[0] * iq.element_size())
                    env, w, pol, mass = self._combine_front(iq)
                self.combine_weights = (w, pol, mass)
                out = self._step(env, self.ema, self.alpha, phase * self._phase_scale)
            else:
                out = self._step(iq, self.ema, self.alpha, phase)
        self.ema = out[0]
        return out

    def _sink(self, sink: FrameSink, ema, frames, sync, score, emit_every_frame: bool) -> None:
        """A block's outputs to the host and the sink: the EMA image, or
        with ``emit_every_frame`` each frame, with the block's info."""
        with annotate("runtime.sink"):
            info = {
                "sync": sync.cpu().numpy(),
                "score": score.cpu().numpy(),
                "mode": self._mode,
                "frames_out": self.frames_out,
            }
            if self.corr_spark:
                info["spark"] = self.corr_spark
            if emit_every_frame:
                images = frames.cpu().numpy()
                for f in images:
                    sink(f, info)
            else:
                images = ema.cpu().numpy()
                sink(images, info)
        if enabled():
            count("runtime.sink.bytes",
                  info["sync"].nbytes + info["score"].nbytes + images.nbytes)

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
        kept on ``self.last_evidence`` and a refresh-band sparkline on
        ``self.corr_spark`` (the sink's ``info["spark"]``).  The window is
        contiguous signal (see
        ``_gather_window``); a shortened window still estimates correctly, so
        the correlation seconds follow the signal actually gathered."""
        sig = self._gather_window(seconds)
        fs = self.source.sample_rate
        seconds = min(seconds, len(sig) / fs)
        if keep_evidence:
            timing, ev = timing_evidence(
                sig, fs, seconds, rate_min, rate_max, device=self.device)
            self.last_evidence = ev
            self.corr_spark = (
                f"corr[{rate_min:.0f}-{rate_max:.0f}Hz] "
                f"{sparkline(ev.gamma_rates, mark=ev.rate_mark())} "
                f"peak {ev.refresh_hz:.2f} Hz")
        else:
            timing = estimate_timing(sig, fs, seconds, rate_min, rate_max, device=self.device)
        self.mode = timing.mode
        return timing

    def _take_aside(self, buf: np.ndarray) -> bool:
        """Take one block for a task beside the chain, keeping the frame
        grid honest; False when the ring is closed."""
        if self.ring.take(buf) is None:
            return False
        self._resync_abs_pos()
        self.abs_pos += self.source.block_size
        return True

    def scan(
        self,
        freqs_hz,
        dwell_seconds: float = 0.1,
        settle_blocks: int = 1,
        retune_to_best: bool = True,
        rate_min: float = 50.0,
        rate_max: float = 90.0,
    ) -> list[tuple[float, float, float, float]]:
        """Retune across candidate carriers and score each dwell's
        screen-ness on the runtime's device.  Requires a retunable source
        (``set_carrier``).

        Per dwell: retune, drop blocks until the delivered one was produced
        ``settle_blocks`` after the retune (sequence-fenced: the ring may
        hold a full depth of pre-retune blocks), then score ~``dwell_
        seconds`` of signal block-by-block with the scale-free refresh-comb
        prominence (gain-independent — AGC may differ per dwell; see
        ``ops.scan.carrier_score``), keeping the best block.

        Detection is CALIBRATED like the offline sweep: the measured noise
        selection floor of the dwell's own window geometry (white-noise
        surrogates through the identical estimator at the per-block length,
        ``ops.scan._noise_floor``) is measured once per geometry, so a dwell's
        margin-over-floor is comparable with an offline ``scan_band`` of
        the same geometry.

        Returns ``[(freq, prominence_db, floor_db, refresh_hz), ...]`` in
        input order and, by default, leaves the source tuned to the best
        candidate.  For a single wideband CAPTURE use
        :func:`tempest_tpu_torch.ops.scan.scan_band` instead — it scores
        every channel in one batch."""
        retune = getattr(self.source, "set_carrier", None)
        if retune is None:
            raise RuntimeError(
                f"{type(self.source).__name__} does not support carrier "
                "retuning — scan a wideband capture with ops.scan.scan_band")
        fs = self.source.sample_rate
        block = self.source.block_size
        # Coverage precondition: blocks are scored individually, and the
        # autocorrelation's usable lag range is HALF its power-of-two FFT
        # window (lags past n/2 are circular mirrors) — worst case
        # block_seconds/4.  If the frame period 1/rate_min does not fit,
        # every dwell on a real emission scores at the noise floor and the
        # "best" carrier is arbitrary; refuse instead.
        n_fft = 1 << (max(int(block), 2).bit_length() - 1)
        usable_lag_s = (n_fft // 2) / fs
        if usable_lag_s < 1.0 / rate_min:
            raise ValueError(
                f"block too short to score the {rate_min:.0f}-{rate_max:.0f}"
                f" Hz band: usable correlation lag {usable_lag_s*1e3:.1f} ms"
                f" < one frame period {1e3/rate_min:.1f} ms — use"
                f" block_seconds >= {4.0/rate_min:.2f} s")
        n_blocks = max(int(np.ceil(dwell_seconds * fs)) // block + 1, 1)
        buf = np.empty(block, np.complex64)
        # ONE floor per scan: the dwell scores whole blocks, so the null
        # geometry is (block_size envelope, per-block correlation window) —
        # identical for every candidate carrier.
        corr_s = min(dwell_seconds, 0.5 * block / fs)
        floor = float(_noise_floor(fs, block, corr_s, rate_min, rate_max, device=self.device))

        def take() -> None:
            if not self._take_aside(buf):
                raise RuntimeError("ring closed during scan()")

        results: list[tuple[float, float, float, float]] = []
        for freq in freqs_hz:
            retune(float(freq))
            # Fence against stale data: the overwrite-oldest ring may hold up
            # to `depth` blocks captured BEFORE the retune (plus one the
            # producer was mid-read on).  Sequence stamps make the fence
            # exact — drop until the delivered block was produced at least
            # `settle_blocks` after the retune (counting a fixed number of
            # takes instead mixes old-carrier samples into the dwell and
            # dilutes the score).
            produced = getattr(self.ring, "produced", None)
            if produced is not None:
                target = produced + settle_blocks
                while True:
                    take()
                    if self.ring.last_seq >= target:
                        break
            else:
                for _ in range(settle_blocks):
                    take()
            # Score each block INDEPENDENTLY and keep the best: under
            # overflow successive takes are not contiguous in the signal,
            # and concatenating across a gap puts a frame-phase
            # discontinuity inside the correlation window.  Per-block
            # coverage of the refresh band is guaranteed by the usable-lag
            # check above.
            best_sf = (-np.inf, float("nan"))
            for _ in range(n_blocks):
                take()
                sc, fv = carrier_score(buf, fs, corr_s, rate_min, rate_max,
                                       device=self.device)
                if sc > best_sf[0]:
                    best_sf = (sc, fv)
            results.append((float(freq), best_sf[0], floor, best_sf[1]))
        if retune_to_best and results:
            best = max(results, key=lambda r: r[1])
            retune(best[0])
        return results

    def record(
        self,
        path: str | None = None,
        n_blocks: int = 10,
        fmt: str = "single",
        prefix: str = "dumpIQ",
    ) -> int:
        """Dump raw IQ blocks to a GNURadio-compatible capture.  Returns the
        samples written.

        With ``path=None`` successive calls auto-rotate output files
        (``dumpIQ_0.dat``, ``dumpIQ_1.dat``, …): the first index whose file
        does not yet exist is used.  The chosen path is exposed as
        ``self.last_record_path``."""
        if path is None:
            k = self._record_idx
            while os.path.exists(f"{prefix}_{k}.dat"):
                k += 1
            path = f"{prefix}_{k}.dat"
            self._record_idx = k + 1
        self.last_record_path = path
        block = self.source.block_size
        out = np.empty(n_blocks * block, np.complex64)
        n = 0
        for i in range(n_blocks):
            if not self._take_aside(out[i * block : (i + 1) * block]):
                break
            n += block
        write_complex_binary(out[:n], path, fmt)
        return n

    # ----------------------------------------------------- drift feedback
    @staticmethod
    def _median_circular_step(values: np.ndarray, n: int) -> float:
        """Median per-frame step of a circular quantity (sync offsets)."""
        if len(values) < 2:
            return 0.0
        d = np.diff(values.astype(np.float64))
        d = (d + n / 2) % n - n / 2  # wrap to [-n/2, n/2)
        return float(np.median(d))

    def refine_refresh_from_drift(self, sync_history: np.ndarray) -> float:
        """Closed-loop refresh refinement: a residual error in the assumed
        frame period makes the detected blanking position drift linearly
        across frames; converting that drift (render px/frame on each axis)
        back to samples/frame gives the period correction directly.

        ``sync_history``: (n_frames, 2) recent per-frame (s_y, s_x).  Returns
        the refined refresh [Hz] and hot-swaps the runtime's mode to it."""
        h, w = self.config.render_size
        x_t, y_t = self._mode.width, self._mode.height
        dy = self._median_circular_step(sync_history[:, 0], h)
        dx = self._median_circular_step(sync_history[:, 1], w)
        spf = self._spf
        samples_per_raster_px = spf / (x_t * y_t)
        # A period error drifts the blank along the RASTER: the x position
        # is the fine odometer (raster px/frame, ambiguous modulo x_t) and
        # the y position the coarse one (lines/frame ≈ the SAME drift / x_t)
        # — they are redundant, NOT additive.  Use dx for precision and dy
        # only to resolve dx's whole-line wraps.
        dx_px = dx * (x_t / w)             # fine: raster px/frame, mod x_t
        coarse_px = dy * (y_t / h) * x_t   # coarse: from the line odometer
        wraps = np.round((coarse_px - dx_px) / x_t)
        drift_samples = (dx_px + wraps * x_t) * samples_per_raster_px
        new_spf = spf + drift_samples
        new_fv = self.source.sample_rate / new_spf
        self.mode = VideoMode(x_t, y_t, float(new_fv))
        return float(new_fv)

    # --------------------------------------------------- failure detection
    def health(self) -> dict:
        """Liveness/health snapshot: producer thread state, ring
        backlog/overflow, source error, throughput, the combine front's
        carriers and last weights, and while the tracer is on
        (``utils.profiling``) its ``summary()`` over the spans and counts it
        keeps."""
        if hasattr(self.ring, "producer"):
            _, prod_msps = self.ring.producer.rates()
            _, cons_msps = self.ring.consumer.rates()
        else:  # native ring: counters only
            prod_msps = cons_msps = float("nan")
        return {
            "producer_alive": self._producer is not None and self._producer.is_alive(),
            "producer_error": repr(self._producer_error) if self._producer_error else None,
            "ring_available": self.ring.available,
            "ring_overflows": self.ring.overflows,
            # Live conditions that hardware sources count in their receive loop.
            "source_overflows": getattr(self.source, "overflows", 0),
            "source_timeouts": getattr(self.source, "timeouts", 0),
            "producer_msps": round(prod_msps, 2),
            "consumer_msps": round(cons_msps, 2),
            "frames_out": self.frames_out,
            "combine": (
                {
                    "centers_hz": list(self._combine_centers),
                    "chan_bw": self._combine_bw,
                    "demod": self._combine_demod,
                    "excise_db": self._combine_excise,
                    "fs_channel": self._combine_geometry[2],
                    "weights": (
                        self.combine_weights[0].cpu().numpy().round(3).tolist()
                        if self.combine_weights is not None else None
                    ),
                }
                if self._combine_centers else None
            ),
            "realtime_factor": round(
                cons_msps * 1e6 / self.source.sample_rate, 3
            ) if self.source.sample_rate else None,
            "trace": summary() if enabled() else None,
        }

    def summary(self) -> str:
        base = (
            self.ring.summary()
            if hasattr(self.ring, "summary")
            else f"NativeRing: {self.ring.overflows} overflows"
        )
        return base + f" | {self.frames_out} frames reconstructed"

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
                combine_centers=self._combine_centers,
                combine_bw=self._combine_bw,
                combine_demod=self._combine_demod,
                combine_excise_db=self._combine_excise,
                fidelity=self.fidelity,
                fidelity_bins=self.fidelity_bins,
                invert=self.invert,
            ),
            path,
        )

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint written by either runtime, its chain
        (default or fidelity, with or without live combining) included."""
        from ..utils.checkpoint import load_state

        state = load_state(path)
        if state.sample_rate != self.source.sample_rate:
            raise ValueError(
                f"checkpoint sample rate {state.sample_rate} != source "
                f"{self.source.sample_rate}")
        self._mode = state.mode
        self.alpha = state.alpha
        self._combine_centers = list(state.combine_centers) if state.combine_centers else None
        self._combine_bw = state.combine_bw
        self._combine_demod = state.combine_demod
        self._combine_excise = state.combine_excise_db
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
