#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the streaming reconstruction chain of
``tempest_tpu_torch`` — at full size: 1920x1080 @ 60 Hz (2576x1125 total)
sampled at 20 Msps, 36 frames (12,333,335 samples) per block, 600x800
screens.  Phases, each of which fails the run if it fails:

1. build K1 (``tempest_tpu_torch/csrc/resample.cu``) with nvcc for sm_90a;
2. hold K1 against its plain PyTorch version on the card, at the slice's
   shapes, and time both;
3. run three blocks of a synthetic capture through
   ``StreamingRuntime.process_blocks`` on the card, check that K1 carried
   them, that the outputs stayed on the card, that the final EMA matches the
   port's CPU run of the same blocks, and that its PSNR against the
   capture's ground truth clears the bar; time the step.

Run ``python3 chip_smoke.py`` from the root of a checkout on a machine with
a CUDA card; it ends with a torch.profiler table of three steps.  The last
line of standard output is ``{"ok": true, "device": {...}}``; any
failure exits non-zero without it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
K1_REL_TOL = 1e-6     # K1 and its plain version do the same f32 operations
# Card vs CPU: the f32 profile sums and prefix sums reassociate, which moves
# the sub-pixel sync fraction (2.7e-3 px measured, PERF.md) and the EMA.
EMA_REL_TOL = 1e-3    # of the EMA's range
SYNC_ABS_TOL = 1e-2   # px
TIMED_CALLS = 30


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


def make_capture(generate_iq, mode, block: int):
    """``N_BLOCKS`` blocks of the synthetic 1080p60 capture, quantised to
    int16 words as an SDR delivers them.  Returns (words int16 [2·n],
    ground-truth raster).  The capture holds one frame period more than the
    blocks, so that a reference may read past the last block."""
    spf = SAMPLE_RATE / mode.refresh
    n = N_BLOCKS * block + int(np.ceil(spf)) + 1
    cap = generate_iq(mode, SAMPLE_RATE, n, snr_db=SNR_DB, seed=SEED)
    words = np.clip(np.round(cap.iq.view(np.float32) * INT16_SCALE), -32768, 32767)
    return words.astype(np.int16), cap.frame


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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def run_runtime(tp, blocks, mode, device):
    """Drive ``StreamingRuntime.process_blocks`` over the blocks on
    ``device``; returns (final EMA, per-block syncs, output device types,
    seconds)."""
    rt = tp.StreamingRuntime(BlockSource(blocks, SAMPLE_RATE), mode,
                             n_frames_per_block=N_FRAMES, alpha=ALPHA,
                             ring_depth=4, device=device)
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
        ema = rt.process_blocks(N_BLOCKS, sink=lambda img, info: syncs.append(info["sync"]))
        seconds = time.perf_counter() - t0
    finally:
        rt.stop()
    check(rt.ring.overflows == 0 and rt.ring.last_seq == N_BLOCKS - 1,
          f"runtime on {device} took blocks 0..{N_BLOCKS - 1} in order "
          f"(overflows {rt.ring.overflows}, last seq {rt.ring.last_seq})")
    check(len(syncs) == N_BLOCKS, f"{N_BLOCKS} blocks processed on {device}")
    return ema, np.concatenate(syncs), out_devices, seconds


def main() -> int:
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
    from tempest_tpu_torch.ops.resample_kernel import (
        frames_to_screens, frames_to_screens_plain, screen_geometry)
    from tempest_tpu_torch.pipeline.offline import carry_phase_starts

    check("jax" not in sys.modules, "the port imports no jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    # ---- 1. build
    t0 = time.perf_counter()
    lib = _build.load_library("resample")
    print(f"[build] {Path(lib.path).name} in {time.perf_counter() - t0:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

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

    # ---- 2. K1 against its plain version, at the slice's shapes
    words0 = torch.from_numpy(words[: 2 * block]).to(dev)
    env = tp.am_envelope_from_iq(words0)
    starts = torch.from_numpy(carry_phase_starts(0.0, spf, N_FRAMES)).to(dev)
    geom = screen_geometry(frame_len, mode.height, mode.width, (h, w), dev)
    k1 = frames_to_screens(env, starts, frame_len, mode.height, mode.width, (h, w))
    plain = frames_to_screens_plain(env, starts, geom)
    torch.cuda.synchronize()
    check(k1.shape == (N_FRAMES, h, w) and bool(torch.isfinite(k1).all()),
          "K1 output finite, of the slice's shape")
    k1_err = float((k1 - plain).abs().max())
    k1_rel = k1_err / float(plain.abs().max())
    print(f"[K1] max abs diff vs plain {k1_err:.3e}, relative {k1_rel:.3e} "
          f"(tolerance {K1_REL_TOL:g})")
    check(k1_rel < K1_REL_TOL, "K1 agrees with its plain version")
    k1_ms = time_call(torch, lambda: frames_to_screens(
        env, starts, frame_len, mode.height, mode.width, (h, w)))
    plain_ms = time_call(torch, lambda: frames_to_screens_plain(env, starts, geom))
    out_mb = N_FRAMES * h * w * 4 / 1e6
    print(f"[K1] {k1_ms:.4f} ms per {N_FRAMES}-frame block ({out_mb / k1_ms:.1f} GB/s "
          f"of output), plain {plain_ms:.4f} ms, on {card}")

    # ---- 3. the slice end to end through the streaming runtime
    frames_to_screens.launches = 0
    ema_gpu, sync_gpu, out_devices, seconds = run_runtime(tp, blocks, mode, dev)
    launches = frames_to_screens.launches
    check(launches >= N_BLOCKS, f"K1 launched for every block ({launches})")
    check(out_devices and all(d == "cuda" for d in out_devices),
          f"every step output on the card ({sorted(set(out_devices))})")
    check(ema_gpu.shape == (h, w) and bool(np.isfinite(ema_gpu).all()),
          "final EMA finite, of the screen's shape")
    print(f"[runtime] {N_BLOCKS} blocks through process_blocks in {seconds:.3f} s "
          f"({1e3 * seconds / N_BLOCKS:.2f} ms per block incl. ring copy and upload), "
          f"K1 launches {launches}")

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

    truth = tp.downgrade_image(torch.from_numpy(truth_raster), (h, w)).numpy()
    db, shift = tp.aligned_psnr(truth, ema_gpu)
    print(f"[runtime] aligned PSNR {db:.3f} dB (bar {PSNR_BAR_DB} dB), shift {shift}")
    check(db > PSNR_BAR_DB, "PSNR clears the bar")

    step = tp.make_reconstruct_fn(cfg, dev)
    ema0 = torch.zeros((h, w), dtype=torch.float32, device=dev)
    step_ms = time_call(torch, lambda: step(words0, ema0, ALPHA, 0.0), calls=10)
    print(f"[step] {step_ms:.3f} ms per {N_FRAMES}-frame block on device-resident int16 "
          f"words = {block / step_ms / 1e3:.1f} Msamples/s, on {card}")

    # Device time by kernel over three steps: the step's busy share and split.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(words0, ema0, ALPHA, 0.0)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    kernels = [{
        "name": "K1 frames_to_screens",
        "route": "cuda",
        "source": "tempest_tpu_torch/csrc/resample.cu",
        "replaces": "tempest_tpu/ops/pallas_resample.py:143",
        "launches": launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
