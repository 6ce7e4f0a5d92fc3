"""The live stream: ``StreamingRuntime.process_blocks`` with the runtime's
default chain, or with ``mesh_shards`` in the traffic ``MeshStreamingRuntime``
over ``make_mesh(mesh_shards)`` in one process (CLI ``stream --mesh``), fed by
an in-memory source that loops the capture's blocks, a sink taking every
block's EMA image to the host (as the GUI does).

The producer is ``MemSource``, a copy of ``tempest_tpu_torch/bench/
bench_all.py``'s at commit 535d04e: one copy a block, so the run charges the
runtime and not the signal's making; it keeps the ring full ahead of the
consumer without overwriting (an unpaced producer took the ring's lock
from the consumer for seconds at a time).  The harness wraps the runtime's
``ring.take`` (the block's take time and sequence) and its step (to keep the
sampled blocks' frames), from its own files.  The loop is closed: the next
block is taken once the last image reached the sink.  The mesh runtime
dispatches a block when the next one is taken (its one-block lookahead).

An item is a block taken and dispatched in the window: from its take to its
image at the sink.  The
check holds a seeded sample of the window's blocks (their EMA image at the
sink, frames and sync) against the reference.  The mesh equals the
single-device runtime on spans of ``block / mesh_shards`` samples, so the
reference rebuilds a block span by span, from zero over the spans of the
blocks dispatched before it (``history_blocks``; the EMA forgets a span by
α^F).
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from portbench import rooflines
from portbench.capture import CaptureSpec, capture_complex
from portbench.harness import Reservoir, abs_max, check, rel_max
from portbench.reference import chain

__all__ = ["prepare", "measure", "collect", "control", "verify"]


class MemSource:
    """Pregenerated in-memory blocks served in a loop.  With ``ring`` set it
    keeps one slot of the ring free: it serves the next block once the
    consumer has taken one (``room`` is set after each take, and waited on
    for at most ``WAIT_S``), so that the ring is always full ahead of the
    consumer and no block is dropped, and an unpaced producer does not hold
    the ring's lock against the consumer."""

    WAIT_S = 1.0

    def __init__(self, blocks: np.ndarray, sample_rate: float) -> None:
        self._blocks = blocks
        self._i = 0
        self.sample_rate = sample_rate
        self.block_size = blocks.shape[1]
        self.ring = None
        self.room = threading.Event()

    def read(self, out: np.ndarray) -> None:
        if self.ring is not None and self.ring.available >= self.ring.depth - 1:
            self.room.wait(self.WAIT_S)
        self.room.clear()
        np.copyto(out, self._blocks[self._i % len(self._blocks)])
        self._i += 1

    def close(self) -> None:
        self.room.set()


def frames_per_window(cap: int, spf: float) -> int:
    """Whole frame periods in a window of ``cap`` samples after a period of
    phase headroom and the fractional cut's slack (the runtime's rule,
    worked out again)."""
    n = max(int((cap - 2 - spf) / spf), 1)
    while n > 1 and int(np.ceil(spf * n)) + 1 + int(np.ceil(spf)) > cap:
        n -= 1
    return n


class State:
    pass


def _shards(ctx) -> int:
    return int(ctx.traffic.get("mesh_shards", 0))


def _runtime(ctx, source, mode):
    from tempest_tpu_torch.runtime.stream import StreamingRuntime

    cfg = ctx.config
    overrides = ({"render_size": tuple(cfg["render_size"])}
                 if tuple(cfg["render_size"]) != (600, 800) else None)
    n = _shards(ctx)
    if not n:
        return StreamingRuntime(source, mode, alpha=float(cfg["alpha"]), device=ctx.device,
                                config_overrides=overrides)
    from tempest_tpu_torch.parallel.mesh import make_mesh
    from tempest_tpu_torch.runtime.mesh_stream import MeshStreamingRuntime

    mesh = (make_mesh(n) if ctx.device.type == "cuda"
            else make_mesh(devices=[str(ctx.device)] * n))
    return MeshStreamingRuntime(source, mode, mesh, alpha=float(cfg["alpha"]),
                                config_overrides=overrides)


def prepare(ctx) -> State:
    from tempest_tpu_torch.video.modes import VideoMode

    cfg, tr = ctx.config, ctx.traffic
    fs = float(cfg["sample_rate"])
    blk = int(round(fs * float(tr["block_seconds"])))
    n_loop = int(tr["loop_blocks"])
    spec = CaptureSpec.from_config(cfg)
    st = State()
    st.blocks = capture_complex(spec, blk * n_loop, ctx.seed, ctx.device).cpu().numpy().reshape(
        n_loop, blk)
    st.fs, st.blk = fs, blk
    # A dispatched block's take is the last one, or under the mesh's
    # lookahead the one before it.
    st.lag = 2 if _shards(ctx) else 1
    mode = VideoMode(int(cfg["width_total"]), int(cfg["height_total"]), float(cfg["refresh_hz"]))
    source = MemSource(st.blocks, fs)
    st.rt = rt = _runtime(ctx, source, mode)
    source.ring = rt.ring
    st.keep = Reservoir(int(tr["checked_blocks"]), ctx.rng)
    st.seqs, st.items = [], []     # every dispatched block's sequence; the window's items
    st.takes = []                  # (time, sequence) of every take
    st.pending = None              # the outputs of the block in flight
    st.stop = False

    take = rt.ring.take

    def timed_take(out=None, timeout=None):
        if st.stop:  # the window has closed: process_blocks returns
            return None
        with ctx.spans.timed("ring_take"):
            t = ctx.now()
            got = take(out, timeout)
        source.room.set()
        st.takes.append((t, rt.ring.last_seq))
        return got

    step = rt._step

    @functools.wraps(step)  # the mesh's step carries its geometry as attributes
    def kept_step(*args):
        out = step(*args)
        st.pending = out
        return out

    rt.ring.take = timed_take
    rt._step = kept_step
    rt.start()
    # Warm: every phase of the loop's blocks seen once and more.  Every
    # dispatched block's sequence is kept: the reference rebuilds a block's
    # EMA from the blocks before it.
    rt.process_blocks(int(tr["warm_blocks"]),
                      sink=lambda img, info: st.seqs.append(st.takes[-st.lag][1]))
    return st


def measure(ctx, st: State, seconds: float | None) -> dict:
    rt = st.rt
    count = None if seconds is not None else int(ctx.traffic["traced_blocks"])
    t0 = ctx.now()
    t_end = t0 + seconds if seconds is not None else float("inf")

    def sink(img, info):
        t1 = ctx.now()
        taken, seq = st.takes[-st.lag]
        st.seqs.append(seq)
        # A block of the window is taken and dispatched in it (the mesh's
        # first dispatch is of a block taken before the window opened).
        if t0 <= taken and t1 <= t_end:
            st.items.append({"t0": taken, "t1": t1, "samples": st.blk})
            slot = st.keep.slot()
            if slot is not None:
                _, frames, _, _ = st.pending
                st.keep.put(slot, (len(st.seqs) - 1, img, frames, info["sync"]))
        st.pending = None
        if t1 > t_end or (count is not None and len(st.items) >= count):
            st.stop = True

    with ctx.spans.timed("blocks"):
        rt.process_blocks(1 << 62, sink=sink)
    window_s = (seconds if seconds is not None else ctx.now() - t0)
    rt.stop()
    return {"window_s": window_s, "items": st.items, "attempted": len(st.items),
            "work": _work(ctx, st.fs / float(ctx.config["refresh_hz"]), rt.config.n_frames)}


def _work(ctx, spf, n_frames) -> dict:
    """K1's and K2 + K3's work in one block (every span of it)."""
    cfg = ctx.config
    parts = max(_shards(ctx), 1)
    h, w = cfg["render_size"]
    g = chain.geometry(int(np.floor(spf)), int(cfg["height_total"]), int(cfg["width_total"]),
                       (h, w))
    span = int(np.ceil((w - 1) * g.delta + 1)) + 2
    n_win = int(np.ceil(spf * n_frames)) + 1 + int(np.ceil(spf))
    read = rooflines.addressed_samples(chain.carry_phase_starts(0.0, spf, n_frames),
                                       g.line_start, span, n_win)
    k1 = rooflines.k1_work(n_frames, h, w, read, 8, 2, False)
    k23 = rooflines.k2k3_work(n_frames, h, w)
    return {"k1": (parts * k1[0], parts * k1[1], parts),
            "k2k3": (parts * k23[0], parts * k23[1], 3 * parts)}


def collect(ctx, st: State) -> dict:
    """The sampled answers on the host, and what the reference needs."""
    kept = [(i, img, frames.cpu(), np.asarray(sync)) for i, img, frames, sync in st.keep.values()]
    out = {"kept": kept, "seqs": list(st.seqs), "blocks": st.blocks, "fs": st.fs, "blk": st.blk}
    st.rt = None
    return out


def _reference(ctx, ans: dict, index: int, q):
    """(ema, frames, sync) of dispatched block ``index``, rebuilt span by
    span from zero over the blocks dispatched before it."""
    cfg, dev = ctx.config, ctx.device
    fs, blk = ans["fs"], ans["blk"]
    blocks = ans["blocks"]
    parts = max(_shards(ctx), 1)
    span_len = blk // parts
    spf = fs / float(cfg["refresh_hz"])
    n_frames = frames_per_window(span_len, spf)
    n_win = int(np.ceil(spf * n_frames)) + 1 + int(np.ceil(spf))
    g = chain.geometry(int(np.floor(spf)), int(cfg["height_total"]), int(cfg["width_total"]),
                       tuple(cfg["render_size"]))
    ema = torch.zeros(tuple(cfg["render_size"]), dtype=torch.float32, device=dev)
    for j in range(max(0, index - int(ctx.traffic["history_blocks"])), index + 1):
        seq = ans["seqs"][j]
        block = blocks[seq % len(blocks)]
        frames, syncs = [], []
        for d in range(parts):
            window = block[d * span_len: d * span_len + n_win]
            if window.shape[0] < n_win:  # the window runs on into the next block
                nxt = blocks[(seq + 1) % len(blocks)]
                window = np.concatenate([window, nxt[: n_win - window.shape[0]]])
            words = torch.from_numpy(np.ascontiguousarray(window).view(np.float32)).to(dev)
            phase = (-(seq * blk + d * span_len)) % spf
            starts = chain.carry_phase_starts(phase, spf, n_frames)
            ema, f, s, _ = chain.chain(chain.envelope(words, q), starts, None, g, ema,
                                       float(cfg["alpha"]), 2, q)
            frames.append(f)
            syncs.append(s)
    return ema, torch.cat(frames), torch.cat(syncs)


def control(ctx, ans: dict) -> dict:
    """The answers of the reference in bfloat16, in the program's place."""
    kept = []
    for i, _, _, _ in ans["kept"]:
        ema, frames, sync = _reference(ctx, ans, i, chain.bfloat16)
        kept.append((i, ema.cpu().numpy(), frames.cpu(), sync.cpu().numpy()))
    return {**ans, "kept": kept}


def verify(ctx, ans: dict) -> dict:
    readings = {}
    if not ans["kept"]:
        return {"blocks_checked": float("inf")}
    for i, img, frames, sync in ans["kept"]:
        ema_r, frames_r, sync_r = _reference(ctx, ans, i, chain.exact)
        check(readings, "ema_rel", rel_max(torch.as_tensor(img), ema_r))
        check(readings, "frames_rel", rel_max(frames, frames_r))
        check(readings, "sync_px", abs_max(torch.as_tensor(sync), sync_r))
    return readings
