"""The flagship step and the multi-device dry run in the port — the
counterpart of the repo's ``__graft_entry__.py``, which stays the JAX
package's own.

``entry()`` returns the flagship step and its arguments: the full chain (AM
demod, frame cuts, signal→screen resample, sub-pixel frame sync and
alignment, EMA) at 1920x1080 @ 60 Hz from a 20 Msps stream of raw int16 I/Q
words, ``__graft_entry__.entry()``'s configuration.  Its resampler is the one
that configuration takes by default in the JAX package, ``mxu3``: in the port
K1 on the bfloat16-rounded envelope with the line fractions on a 64-phase
grid.

``dryrun_multichip(n)`` runs one step of every sharded program on an
n-shard mesh at ``__graft_entry__.dryrun_multichip``'s shapes and with its
asserts: the time shards (offline and streaming), the stream shards, the
candidate shards (1-D, and 2-D where n is even and at least 4), the static
search, the carrier shards (scan, combine, and the combine front feeding the
time shards) and the sharded Welch PSD.  The mesh is ``n`` cards, or the
shards ``devices=`` names (``["cpu"] * 4``; ``["cuda:0"] * 4`` runs four
shards on one card).  The configs take the JAX package's default resampler
too, so that the outputs compare with that package's.

    python -m tempest_tpu_torch.bench.graft_entry [--devices N] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..ops.scan import _channel_geometry
from ..ops.spectrum import get_welch_sharded
from ..parallel.mesh import make_mesh
from ..parallel.sharded import (
    mode_search_static,
    sharded_batched_reconstruct_fn,
    sharded_combine_harmonics,
    sharded_combined_reconstruct_fn,
    sharded_mode_search,
    sharded_mode_search_2d,
    sharded_reconstruct_fn,
    sharded_scan_band,
    sharded_streaming_reconstruct_fn,
)
from ..pipeline.offline import ReconstructionConfig, make_reconstruct_fn
from ..utils.device import resolve_device
from ..video.modes import ALL_VIDEO_MODES

__all__ = ["entry", "dryrun_multichip", "JAX_DEFAULT_RESAMPLER"]

# The resampler a JAX ``ReconstructionConfig`` takes when it names none.
JAX_DEFAULT_RESAMPLER = "mxu3"


def entry(device=None):
    """``(step, (iq, ema, alpha))``: the flagship step on ``device`` (``None``:
    the card) and its arguments there — 2 frames of 1080p60 at 20 Msps, the
    words ``default_rng(0)`` integers in [-16384, 16384)."""
    device = resolve_device(device)
    config = ReconstructionConfig(
        sample_rate=20e6,
        mode=ALL_VIDEO_MODES["1920x1080 @ 60Hz"],
        n_frames=2,
        input_format="iq_interleaved",
        align_subpixel=True,
        resampler=JAX_DEFAULT_RESAMPLER,
    )
    step = make_reconstruct_fn(config, device)
    rng = np.random.default_rng(0)
    iq = torch.from_numpy(
        rng.integers(-16384, 16384, 2 * config.block_samples, dtype=np.int16)).to(device)
    ema = torch.zeros(config.render_size, dtype=torch.float32, device=device)
    return step, (iq, ema, 0.1)


def _centers(n: int) -> np.ndarray:
    return np.arange(-n // 2, n // 2) * 1e5


def dryrun_multichip(n_devices: int, devices: list | None = None,
                     iq: np.ndarray | None = None) -> dict:
    """One step of each sharded program over ``n_devices`` shards; returns
    each program's outputs by name (the time-sharded step's under
    ``"reconstruct"``: ema, frames, sync, score).  ``iq`` is the complex
    (n_devices, shard_samples) timeline of the time and stream shards, from
    which the searches take their envelope; by default the JAX dry run's,
    standard normal noise from ``default_rng(0)``."""
    mode = ALL_VIDEO_MODES["640x480 @ 60Hz"]
    fs = 1e6  # tiny: ~16.7k samples a frame
    config = ReconstructionConfig(sample_rate=fs, mode=mode, n_frames=1,
                                  resampler=JAX_DEFAULT_RESAMPLER)
    mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.device
    out = {}

    # Time shards: the circular halo from the next shard, the EMA combine.
    step = sharded_reconstruct_fn(config, mesh)
    shard_samples = config.block_samples
    if iq is None:
        rng = np.random.default_rng(0)
        iq = (rng.standard_normal((n_devices, shard_samples))
              + 1j * rng.standard_normal((n_devices, shard_samples))).astype(np.complex64)
    if iq.shape != (n_devices, shard_samples):
        raise ValueError(f"iq must be ({n_devices}, {shard_samples}), got {iq.shape}")
    ema0 = torch.zeros(config.render_size, dtype=torch.float32, device=dev)
    ema, frames, sync, score = out["reconstruct"] = step(iq, ema0, 0.5)
    assert frames.shape == (n_devices, *config.render_size)
    assert ema.shape == config.render_size

    # Serving: the stream axis over the mesh, one independent stream a shard.
    bstep = sharded_batched_reconstruct_fn(config, mesh)
    bema = torch.zeros((n_devices, *config.render_size), dtype=torch.float32, device=dev)
    out["batched"] = bstep(iq, bema, 0.5)
    assert out["batched"][0].shape == (n_devices, *config.render_size)

    # Hypotheses: the candidate modes over the mesh.
    cands = [(name, ALL_VIDEO_MODES[name]) for name in
             ("640x480 @ 60Hz", "800x600 @ 60Hz", "1024x768 @ 60Hz", "1152x864 @ 60Hz")]
    sig = np.abs(iq.reshape(-1))[: 4 * config.block_samples]
    out["mode_search"] = sharded_mode_search(sig, fs, mode.refresh, cands, mesh, n_frames=1)
    assert len(out["mode_search"].scores) == len(cands)

    # Time blocks x mode candidates on a 2-D mesh.
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = make_mesh({"blocks": 2, "modes": n_devices // 2}, devices=devices)
        out["mode_search_2d"] = sharded_mode_search_2d(sig, fs, mode.refresh, cands, mesh2d,
                                                       frames_per_shard=1)
        assert len(out["mode_search_2d"].scores) == len(cands)

    # The static-table search, on one device.
    out["mode_search_static"] = mode_search_static(sig, fs, mode.refresh, cands, n_frames=1,
                                                   device=dev)
    assert len(out["mode_search_static"].scores) == len(cands)

    # Carriers: candidate channels over the mesh, scored independently.
    wide = np.random.default_rng(2).standard_normal(2 * (1 << 17)).astype(np.float32)
    out["scan_band"] = sharded_scan_band(wide, fs, _centers(n_devices), mesh, chan_bw=2e5,
                                         corr_seconds=0.02)
    assert len(out["scan_band"].scores_db) == n_devices

    # Multi-harmonic combining over the carriers: gathered comb masses, the
    # summed anchor envelope and weighted fusion.
    comb = out["combine"] = sharded_combine_harmonics(wide, fs, _centers(n_devices), mesh,
                                                      chan_bw=2e5, corr_seconds=0.02)
    assert comb.envelope.ndim == 1 and len(comb.weights) == n_devices

    # The carrier-sharded combine front feeding the time-sharded chain.
    n_cb = 1 << 18
    _, _, fs_cb = _channel_geometry(n_cb, fs, 2.5e5)
    cfg_cb = ReconstructionConfig(sample_rate=fs_cb, mode=mode, n_frames=1,
                                  input_format="envelope", resampler=JAX_DEFAULT_RESAMPLER)
    cstep = sharded_combined_reconstruct_fn(cfg_cb, mesh, fs, n_cb, _centers(n_devices), 60.0,
                                            chan_bw=2.5e5)
    words_cb = np.random.default_rng(3).standard_normal(2 * n_cb).astype(np.float32)
    out["combined_reconstruct"] = cstep(
        words_cb, torch.zeros(cfg_cb.render_size, dtype=torch.float32, device=dev), 0.5)
    assert out["combined_reconstruct"][1].shape[0] == n_devices

    # The live mesh step: the carried phase of each span and the next
    # block's head as the last shard's halo; two consecutive steps.
    spf = fs / mode.refresh
    s_live = config.block_samples
    cfg_live = dataclasses.replace(config, carry_phase=True, input_format="iq_interleaved",
                                   align_subpixel=True)
    lstep = sharded_streaming_reconstruct_fn(cfg_live, mesh, s_live)
    stream = np.random.default_rng(4).standard_normal(
        (2 * n_devices + 1) * s_live * 2).astype(np.float32)
    lema = torch.zeros(cfg_live.render_size, dtype=torch.float32, device=dev)
    for t in range(2):
        blk0 = t * n_devices * s_live * 2
        rows = stream[blk0: blk0 + n_devices * s_live * 2].reshape(n_devices, 2 * s_live)
        end = blk0 + n_devices * s_live * 2
        tail = stream[end: end + 2 * lstep.overlap]
        phases = np.asarray([(-(t * n_devices * s_live + d * s_live)) % spf
                             for d in range(n_devices)])
        lema, lframes, _, _ = lstep(rows, tail, lema, 0.5, phases)
    out["streaming"] = (lema, lframes)
    assert lframes.shape == (n_devices, *cfg_live.render_size)

    # Welch PSD: each shard's segments, one sum over the mesh.
    z = (np.random.default_rng(1).standard_normal((n_devices * 8 * 256, 2))
         @ np.array([1.0, 1.0j])).astype(np.complex64)
    out["welch"] = get_welch_sharded(fs, z, mesh, fft_size=256)
    assert out["welch"][1].shape == (256,)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="One flagship step and the multi-device dry run.")
    ap.add_argument("--device", default=None, help="'cpu', or a CUDA device (default: the card)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shards of the dry run (default: every visible card, or 8 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    step, step_args = entry(device)
    ema, frames, _, _ = step(*step_args)
    print(f"entry: EMA {tuple(ema.shape)}, frames {tuple(frames.shape)} on {ema.device}, "
          f"finite {bool(torch.isfinite(ema).all())}")
    if device.type == "cpu":
        n = args.devices or 8
        shards = ["cpu"] * n
    else:
        n = args.devices or torch.cuda.device_count()
        shards = None
    ran = dryrun_multichip(n, shards)
    print(f"dryrun_multichip({n}): {', '.join(ran)}")


if __name__ == "__main__":
    main()
