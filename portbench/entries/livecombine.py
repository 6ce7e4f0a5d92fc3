"""Live harmonic fusion: ``StreamingRuntime(combine=carriers).step_words`` on
blocks of float32 words that stay on the card, the runtime's own per-block
path (the combine front, then the step at the channel rate), the EMA
threaded on the runtime.

The words are ``loop_blocks`` consecutive blocks of ``block_samples`` of one
seeded wideband capture (``capture_wide.capture_words``), taken once to
float32 words as the ring's complex64 holds them.  Step i takes block
``b = i mod loop_blocks`` at its phase ``(-b·n) mod spf`` in source samples,
so that every block is cut on the frame grid of its place in the capture.
The runtime is never started: no ring, no upload.  The loop is closed: a
block is issued once the last one has been issued, and the window is fenced
once, at its end.  An item is a block, worth ``block_samples`` source
samples.

The harness wraps the runtime's combine front, from its own file, to keep
the fused envelope of a sampled block.  The check holds a seeded sample of
blocks (the front's weights, polarities and envelope; EMA, frames, sync,
score) against ``reference/livecombine.py``, rebuilt from zero over the
blocks before it (``history_blocks``; the EMA forgets a block by α^F).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.capture_wide import WideSpec, capture_words
from portbench.harness import Reservoir, abs_max, check, rel_max
from portbench.reference import chain, livecombine

__all__ = ["prepare", "measure", "collect", "control", "verify"]


class HeldSource:
    """The runtime's source where every block is handed to ``step_words``
    directly: its rate and block size, and no samples."""

    def __init__(self, sample_rate: float, block_size: int) -> None:
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)

    def read(self, out: np.ndarray) -> None:
        raise RuntimeError("the blocks are handed to step_words; the source is not read")

    def close(self) -> None:
        pass


class State:
    pass


def _block_samples(ctx) -> int:
    return int(ctx.config["block_samples"])


def prepare(ctx) -> State:
    from tempest_tpu_torch.runtime.stream import StreamingRuntime
    from tempest_tpu_torch.video.modes import VideoMode

    cfg, tr = ctx.config, ctx.traffic
    a = cfg["assumed"]
    st = State()
    st.n = n = _block_samples(ctx)
    st.k = k = int(tr["loop_blocks"])
    fs = float(cfg["sample_rate"])
    words = capture_words(WideSpec.from_config(cfg), n * k, ctx.seed, ctx.device)
    st.words = words.to(torch.float32)
    del words
    st.blocks = [st.words[2 * b * n: 2 * (b + 1) * n] for b in range(k)]
    spf = fs / float(cfg["refresh_hz"])
    st.phases = [(-b * n) % spf for b in range(k)]
    mode = VideoMode(int(cfg["width_total"]), int(cfg["height_total"]), float(cfg["refresh_hz"]))
    st.rt = StreamingRuntime(HeldSource(fs, n), mode, alpha=float(cfg["alpha"]), ring_depth=2,
                             combine=[float(c) for c in a["carriers_hz"]],
                             combine_bw=float(a["chan_bw"]), device=ctx.device,
                             config_overrides={"render_size": tuple(cfg["render_size"])})
    front = st.rt._combine_front
    st.env = None

    def kept_front(iq):
        out = front(iq)
        st.env = out[0]
        return out

    st.rt._combine_front = kept_front
    st.i = 0
    for _ in range(int(tr["warm_blocks"])):
        _one(st)
    st.keep = Reservoir(int(tr["checked_blocks"]), ctx.rng)
    return st


def _one(st: State):
    b = st.i % st.k
    out = st.rt.step_words(st.blocks[b], st.phases[b])
    st.i += 1
    return out


def measure(ctx, st: State, seconds: float | None) -> dict:
    count = None if seconds is not None else int(ctx.traffic["traced_blocks"])
    ctx.fence()
    t0 = ctx.now()
    t_end = t0 + seconds if seconds is not None else float("inf")
    done = 0
    while (ctx.now() < t_end) if count is None else (done < count):
        i = st.i
        out = _one(st)
        slot = st.keep.slot()
        if slot is not None:
            w, pol, _ = st.rt.combine_weights
            st.keep.put(slot, (i, *out, st.env, w, pol))
        done += 1
    ctx.fence()
    window_s = ctx.now() - t0
    items = [{"t0": t0, "t1": t0 + window_s, "samples": st.n}] * done
    return {"window_s": window_s, "items": items, "attempted": done, "work": {}}


def collect(ctx, st: State) -> dict:
    kept = [tuple(x if isinstance(x, int) else x.cpu() for x in item)
            for item in st.keep.values()]
    out = {"kept": kept, "words": st.words.cpu(), "n": st.n, "k": st.k}
    st.rt = st.blocks = st.words = st.env = None
    return out


def _reference(ctx, ans: dict, i: int, q) -> dict:
    """The reference's outputs of block ``i`` of the stream, rebuilt from
    zero over the blocks before it."""
    cfg, dev = ctx.config, ctx.device
    n, k = ans["n"], ans["k"]
    g = livecombine.geometry(cfg, n)
    centers = [float(c) for c in cfg["assumed"]["carriers_hz"]]
    spf = float(cfg["sample_rate"]) / float(cfg["refresh_hz"])
    ema = torch.zeros(tuple(cfg["render_size"]), dtype=torch.float32, device=dev)
    for j in range(max(0, i - int(ctx.traffic["history_blocks"])), i + 1):
        b = j % k
        words = ans["words"][2 * b * n: 2 * (b + 1) * n].to(dev)
        out = livecombine.block(words, (-b * n) % spf, g, centers, ema, float(cfg["alpha"]), q)
        ema = out["ema"]
    return out


def control(ctx, ans: dict) -> dict:
    """The answers of the reference in bfloat16, in the program's place."""
    kept = []
    for i, *_ in ans["kept"]:
        r = _reference(ctx, ans, i, chain.bfloat16)
        kept.append((i, *(r[key].cpu() for key in ("ema", "frames", "sync", "score", "envelope",
                                                   "weights", "polarity"))))
    return {**ans, "kept": kept}


def _circular_gap(got, want: torch.Tensor, periods) -> float:
    """max over frames of the circular distance between two blanking
    centres (s_y, s_x) on a screen of ``periods`` = (h, w): the alignment
    shifts circularly, so centres a whole screen apart (-0.004 and 799.996)
    are one shift; inf where the shapes differ or a value is not finite."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    want = want.to(torch.float64)
    if got.shape != want.shape:
        return float("inf")
    p = torch.tensor([float(x) for x in periods], dtype=torch.float64, device=want.device)
    d = torch.remainder(got - want, p)
    gap = float(torch.max(torch.minimum(d, p - d)))
    return gap if gap == gap else float("inf")


def _differ(got: torch.Tensor, want: torch.Tensor) -> float:
    got = torch.as_tensor(got).to(want.device, torch.float64)
    return float(got.shape != want.shape or not torch.equal(got, want.to(torch.float64)))


def verify(ctx, ans: dict) -> dict:
    if not ans["kept"]:
        return {"blocks_checked": float("inf")}
    readings = {}
    for i, ema, frames, sync, score, env, w, pol in ans["kept"]:
        r = _reference(ctx, ans, i, chain.exact)
        # Which polarity each carrier takes is a decision, held exact; the
        # rest are numbers, held to a gap between the program's and the
        # control's readings.
        check(readings, "polarity_wrong", _differ(pol, r["polarity"]))
        check(readings, "weights_gap", abs_max(w, r["weights"]))
        check(readings, "envelope_rel", rel_max(env, r["envelope"]))
        check(readings, "ema_rel", rel_max(ema, r["ema"]))
        check(readings, "frames_rel", rel_max(frames, r["frames"]))
        check(readings, "sync_px", _circular_gap(sync, r["sync"], ctx.config["render_size"]))
        check(readings, "score_rel", abs_max(score, r["score"]) / float(r["score"].abs().max()))
    return readings
