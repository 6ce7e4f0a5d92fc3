"""Scenario benchmarks of the port — the counterpart of the repo's
``bench_all.py``: the same scenarios in the same order, with the same
``metric`` names and units, one JSON line each; every line also carries the
card's name and power limit (``device``, ``power_limit_w``).

  1. offline AM envelope demod of int16 words
  2. FFT autocorrelation refresh and line-count estimation
  3. resample one frame to the screen (K1's single-frame launch)
  4. the full chain at 1080p60; 4b batched serving of 4 streams; 4c the
     streaming fidelity chain; 4c the live-combine front
  5. the sharded mode search over every shard of the mesh
  6. the host ring's put + take (Python, and the C++ ring where it builds)
  7. the streaming host loop end to end (source -> ring -> card -> EMA)
  8. the same loop over the mesh (``MeshStreamingRuntime``)

Each scenario is one function ``(device, fs, iters, rng) -> dict``.  On the
card every timed region is fenced by ``torch.cuda.synchronize()``.  What the
port's counterparts are:

* scenario 3 runs ``ops.resample_kernel.frame_to_screen``, the counterpart of
  ``frame_to_screen_pallas``: one K1 launch a frame.  (The JAX script's
  ``frame_to_screen_rows`` is that package's gather evaluation of the same
  read, which the port keeps in plain PyTorch as ``ops.resample``'s.)
* the live-combine front places its three carriers and its channels at the
  same fractions of ``fs`` as the JAX script at 20 Msps (-6, 1.5 and 7 MHz,
  4 MHz channels), and its window at the same 0.21 s (2²² samples at 20 Msps,
  a power of two at any rate), so that ``--fs`` scales it instead of moving
  the carriers out of the band;
* scenarios 5 and 8 run on ``make_mesh()``, every visible card (one card:
  one shard, and the metric says so), or with ``--device cpu`` on a mesh of
  8 CPU shards, as the JAX script's 8 virtual devices;
* scenario 7 measures the runtime as it is, uploads from pageable memory
  included; scenarios 7 and 8 fail unless every block asked for was
  processed (8 reads the count the mesh runtime reports), so that a short
  run cannot pass as a rate.

    python -m tempest_tpu_torch.bench.bench_all [--device cpu] [--iters 8] [--fs 20e6]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time

import numpy as np
import torch

from ..native import NativeRing, native_available
from ..ops.autocorr import autocorrelation, estimate_line_count, estimate_refresh
from ..ops.combine import combine_core
from ..ops.demod import am_envelope_from_iq
from ..ops.resample_kernel import frame_to_screen
from ..ops.scan import _channel_geometry
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharded import sharded_mode_search
from ..pipeline.offline import (
    ReconstructionConfig,
    make_batched_reconstruct_fn,
    make_reconstruct_fn,
)
from ..runtime.mesh_stream import MeshStreamingRuntime
from ..runtime.ring import RingBuffer
from ..runtime.stream import StreamingRuntime
from ..utils.device import resolve_device
from ..video.modes import ALL_VIDEO_MODES, candidate_modes
from . import device_fields, fence

__all__ = ["SCENARIOS", "bench_mesh", "main"]

MODE = ALL_VIDEO_MODES["1920x1080 @ 60Hz"]
BASELINE_MSPS = 20.0
CPU_SHARDS = 8


def _line(metric: str, samples: float, seconds: float, unit: str = "Msamples/s/chip",
          **extra) -> dict:
    msps = samples / seconds / 1e6
    return {"metric": metric, "value": msps, "unit": unit,
            "vs_baseline": msps / BASELINE_MSPS, **extra}


def _rate(device, metric: str, fn, samples_per_iter: int, iters: int) -> dict:
    """``fn()`` once to warm, then ``iters`` calls in one fenced region."""
    fn()
    fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    fence(device)
    return _line(metric, samples_per_iter * iters, time.perf_counter() - t0)


def _chained(device, fn, iters: int) -> float:
    """Seconds of ``iters`` steps chained through the EMA by ``fn(ema, i) ->
    ema``, from the zero image ``fn(None, 0)`` starts, in one fenced region."""
    fence(device)
    t0 = time.perf_counter()
    e = None
    for i in range(iters):
        e = fn(e, i)
    fence(device)
    return time.perf_counter() - t0


def bench_mesh(device: torch.device) -> Mesh:
    """The mesh of scenarios 5 and 8: every visible card, or 8 CPU shards."""
    if device.type == "cpu":
        return make_mesh(devices=["cpu"] * CPU_SHARDS)
    return make_mesh()


def _words(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(-16384, 16384, shape, dtype=np.int16)).to(device)


def _chain_config(fs: float, **fields) -> ReconstructionConfig:
    return ReconstructionConfig(sample_rate=fs, mode=MODE, n_frames=6,
                                input_format="iq_interleaved", **fields)


# ---------------------------------------------------------------- scenarios
def demod(device, fs, iters, rng) -> dict:
    """1. The AM envelope of 2 M samples of int16 I/Q words on the card."""
    n = 2_000_000
    words = _words(rng, 2 * n, device)
    return _rate(device, "AM envelope demod (int16 ingest)",
                 lambda: am_envelope_from_iq(words), n, iters)


def timing(device, fs, iters, rng) -> dict:
    """2. Refresh and line count from the autocorrelation of 0.2 s."""
    n2 = int(fs * 0.2)
    env = torch.from_numpy(rng.random(n2).astype(np.float32)).to(device)

    def estimate():
        gamma, _ = autocorrelation(env, fs, 0.0, 0.1)
        fv = estimate_refresh(gamma, fs)
        return fv, estimate_line_count(gamma, fs, fv)

    return _rate(device, "autocorrelation timing estimation", estimate, n2, iters)


def resample_one_frame(device, fs, iters, rng) -> dict:
    """3. One frame's envelope onto the 600x800 screen: K1's single-frame
    launch."""
    frame_len = int(fs / 60.0)
    sig = torch.from_numpy(rng.random(frame_len).astype(np.float32)).to(device)
    return _rate(device, "signal->screen resample (1 frame)",
                 lambda: frame_to_screen(sig, MODE.height, MODE.width), frame_len, iters)


def full_chain(device, fs, iters, rng) -> dict:
    """4. Six frames a block through the default step, chained through the
    EMA (``bench.py``'s methodology)."""
    cfg = _chain_config(fs)
    step = make_reconstruct_fn(cfg, device)
    iq = _words(rng, 2 * cfg.block_samples, device)
    ema0 = torch.zeros(cfg.render_size, dtype=torch.float32, device=device)

    def one(e, _):
        return step(iq, ema0 if e is None else e, 0.1)[0]

    _chained(device, one, iters)  # build and warm
    dt = _chained(device, one, iters)
    return _line("full chain 1080p60", cfg.block_samples * iters, dt)


def batched(device, fs, iters, rng) -> dict:
    """4b. Four independent streams through one batched step (aggregate)."""
    bsz = 4
    cfg = _chain_config(fs)
    bstep = make_batched_reconstruct_fn(cfg, device=device)
    biq = _words(rng, (bsz, 2 * cfg.block_samples), device)
    bema0 = torch.zeros((bsz, *cfg.render_size), dtype=torch.float32, device=device)

    def one(e, _):
        return bstep(biq, bema0 if e is None else e, 0.1)[0]

    _chained(device, one, iters)
    dt = _chained(device, one, iters)
    return _line(f"batched serving x{bsz} streams 1080p60 (aggregate)",
                 bsz * cfg.block_samples * iters, dt)


def fidelity(device, fs, iters, rng) -> dict:
    """4c. The streaming fidelity chain: carried phase, sub-sample-exact cuts
    (K1 takes each frame's residual), sync skipped."""
    cfg = _chain_config(fs, carry_phase=True, subsample_align=True, do_align=False,
                        resampler="mxu3", phase_bins=64)
    step = make_reconstruct_fn(cfg, device)
    iq = _words(rng, 2 * cfg.block_samples, device)
    ema0 = torch.zeros(cfg.render_size, dtype=torch.float32, device=device)
    phases = [(-i * cfg.block_samples) % cfg.samples_per_frame for i in range(iters)]

    def one(e, i):
        return step(iq, ema0 if e is None else e, 0.1, phases[i])[0]

    _chained(device, one, iters)  # build and warm
    _chained(device, one, iters)  # settle
    dt = _chained(device, one, iters)
    return _line("streaming fidelity 1080p60 (quantised exact-cut tables)",
                 cfg.block_samples * iters, dt)


def combine_front(device, fs, iters, rng) -> dict:
    """4c. The live-combine front: channelise and MRC-fuse three carriers of
    one wideband block (``ops.combine.combine_core``, what
    ``StreamingRuntime(combine=...)`` runs a block before the chain),
    chained through a carried accumulator."""
    n_wide = 1 << int(round(np.log2(fs * (1 << 22) / 20e6)))
    chan_bw = 0.2 * fs
    centers = (-0.3 * fs, 0.075 * fs, 0.35 * fs)
    _, m_chan, fs_chan = _channel_geometry(n_wide, fs, chan_bw)
    words = torch.from_numpy(rng.standard_normal(2 * n_wide).astype(np.float32)).to(device)
    corr = min(0.1, 0.25 * m_chan / fs_chan)
    acc0 = torch.zeros(m_chan, dtype=torch.float32, device=device)

    def one(acc, _):
        env, *_ = combine_core(words, fs, centers, chan_bw, fs_chan, corr, 55.0, 65.0, "mrc")
        return 0.5 * (acc0 if acc is None else acc) + env

    _chained(device, one, iters)
    dt = _chained(device, one, iters)
    return _line("live-combine front (K=3 channelise + MRC fusion)", n_wide * iters, dt)


def mode_search(device, fs, iters, rng) -> dict:
    """5. The mode search over the 26 modes within 0.5 Hz of 60 Hz, the
    candidates split over the mesh's shards."""
    mesh = bench_mesh(device)
    cands = candidate_modes(60.0, tol_hz=0.5)
    frame_len = int(fs / 60.0)
    sig = rng.random(2 * frame_len + 8).astype(np.float32)
    return _rate(device, f"sharded mode search ({len(cands)} candidates, {len(mesh.devices)} dev)",
                 lambda: sharded_mode_search(sig, fs, 60.0, cands, mesh, n_frames=1),
                 2 * frame_len, iters)


def _ring_line(ring, label: str, data: np.ndarray, out: np.ndarray) -> dict:
    n_iter = 50
    t0 = time.perf_counter()
    for _ in range(n_iter):
        ring.put(data)
        ring.take(out)
    return _line(f"host ring put+take ({label})", data.size * n_iter, time.perf_counter() - t0,
                 unit="Msamples/s")


def _ring_data(rng):
    block = 1 << 20
    data = (rng.standard_normal(block) + 1j * rng.standard_normal(block)).astype(np.complex64)
    return block, data, np.empty(block, np.complex64)


def ring_python(device, fs, iters, rng) -> dict:
    """6. The Python ring's put + take of 1 M complex samples (the host's
    headroom for the producer; no card involved)."""
    block, data, out = _ring_data(rng)
    return _ring_line(RingBuffer(block, 4), "python", data, out)


def ring_native(device, fs, iters, rng) -> dict:
    """6. The same through the C++ ring of ``native/``, built with g++ at
    first use; raises where it cannot be built."""
    block, data, out = _ring_data(rng)
    return _ring_line(NativeRing(block, 4), "C++ native", data, out)


class MemSource:
    """Pregenerated in-memory blocks served in a loop: the producer's cost is
    one copy, so the measurement charges the loop, not signal generation."""

    def __init__(self, blocks: np.ndarray, sample_rate: float) -> None:
        self._blocks = blocks
        self._i = 0
        self.sample_rate = sample_rate
        self.block_size = blocks.shape[1]

    def read(self, out: np.ndarray) -> None:
        np.copyto(out, self._blocks[self._i % len(self._blocks)])
        self._i += 1

    def close(self) -> None:
        pass


def _stream_blocks(fs, rng) -> np.ndarray:
    blk = int(fs * 0.15)
    return (rng.standard_normal((2, blk)) + 1j * rng.standard_normal((2, blk))).astype(np.complex64)


def streaming(device, fs, iters, rng) -> dict:
    """7. ``StreamingRuntime`` end to end: a producer thread fills the ring,
    ``process_blocks`` uploads each block and runs the step."""
    src_blocks = _stream_blocks(fs, rng)
    blk = src_blocks.shape[1]
    rt = StreamingRuntime(MemSource(src_blocks, fs), MODE, alpha=0.1, device=device)
    n_loop = max(iters, 8)
    rt.start()
    try:
        rt.process_blocks(2)  # build and settle
        frames_before = rt.frames_out
        fence(device)
        t0 = time.perf_counter()
        rt.process_blocks(n_loop)
        fence(device)
        dt = time.perf_counter() - t0
    finally:
        rt.stop()
    done = (rt.frames_out - frames_before) // rt.config.n_frames
    if done != n_loop:
        raise RuntimeError(f"the streaming loop processed {done} of {n_loop} blocks")
    line = _line("streaming host loop 1080p60 (source->ring->device->EMA)", n_loop * blk, dt)
    return {**line, "blocks_per_s": n_loop / dt, "realtime_factor": line["value"] * 1e6 / fs}


def mesh_streaming(device, fs, iters, rng) -> dict:
    """8. ``MeshStreamingRuntime``: the same loop with each dispatch spanning
    the mesh (time spans, halos from the next span, one block of lookahead)."""
    mesh = bench_mesh(device)
    n_dev = len(mesh.devices)
    src_blocks = _stream_blocks(fs, rng)
    blk_m = (src_blocks.shape[1] // n_dev) * n_dev
    mrt = MeshStreamingRuntime(MemSource(src_blocks[:, :blk_m], fs), MODE, mesh, alpha=0.1)
    n_loop = max(iters, 8)
    mrt.start()
    try:
        mrt.process_blocks(2)  # build and settle (+1 lookahead)
        fence(device)
        t0 = time.perf_counter()
        done = mrt.process_blocks(n_loop).dispatched
        fence(device)
        dt = time.perf_counter() - t0
    finally:
        mrt.stop()
    if done != n_loop:
        raise RuntimeError(f"the mesh streaming loop dispatched {done} of {n_loop} blocks")
    line = _line(f"mesh streaming host loop 1080p60 ({n_dev} shards)", n_loop * blk_m, dt,
                 unit="Msamples/s")
    return {**line, "blocks_per_s": n_loop / dt, "realtime_factor": line["value"] * 1e6 / fs}


# In the JAX script's order.
SCENARIOS = (demod, timing, resample_one_frame, full_chain, batched, fidelity, combine_front,
             mode_search, ring_python, ring_native, streaming, mesh_streaming)


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description="The scenario benchmarks of the port.")
    ap.add_argument("--device", default=None, help="'cpu', or a CUDA device (default: the card)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--fs", type=float, default=20e6)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    fields = device_fields(device)
    rng = np.random.default_rng(0)
    results = []
    for scenario in SCENARIOS:
        if scenario is ring_native and not native_available():
            gxx = shutil.which("g++")
            why = f"{gxx} did not build native/host_core.cpp" if gxx else "no g++ on PATH"
            print(f"bench_all: the C++ ring is not measured: {why}", file=sys.stderr)
            continue
        line = {**scenario(device, args.fs, args.iters, rng), **fields}
        results.append(line)
        print(json.dumps(line), flush=True)
    return results


if __name__ == "__main__":
    main()
