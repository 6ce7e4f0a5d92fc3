"""The resident chain: the step of ``bench.py:59-80`` (carried phase,
sub-sample-exact cuts, sub-pixel sync, ``resampler="mxu3"``) on blocks of
int16 words that stay on the card, the EMA threaded from step to step.

The words are ``loop_blocks`` consecutive blocks of one capture; step i takes
block ``b = i mod loop_blocks`` at its phase ``(-b·n) mod spf``, so that every
block is cut on the frame grid of its place in the capture.  The window is
fenced once, at its end.  An item is a step.  The check holds a seeded sample
of steps (EMA, frames, sync, score) against the reference, rebuilt from zero
over the step before it (the EMA forgets a step by α^F).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import rooflines
from portbench.capture import CaptureSpec, capture_words
from portbench.harness import Reservoir, abs_max, check, rel_max
from portbench.reference import chain

__all__ = ["prepare", "measure", "collect", "control", "verify"]

# Steps the reference rebuilds before a checked one: the EMA keeps α^36 of
# the step before, nothing in float32.
HISTORY_STEPS = 1


class State:
    pass


def _config(ctx):
    from tempest_tpu_torch.pipeline.offline import ReconstructionConfig
    from tempest_tpu_torch.video.modes import VideoMode

    cfg, tr = ctx.config, ctx.traffic
    return ReconstructionConfig(
        sample_rate=float(cfg["sample_rate"]),
        mode=VideoMode(int(cfg["width_total"]), int(cfg["height_total"]),
                       float(cfg["refresh_hz"])),
        n_frames=int(tr["n_frames"]),
        render_size=tuple(cfg["render_size"]),
        input_format="iq_interleaved",
        carry_phase=True,
        subsample_align=True,
        do_align=True,
        align_subpixel=True,
        resampler=str(tr["resampler"]),
        phase_bins=64,
        einsum_bf16=True,
    )


def prepare(ctx) -> State:
    from tempest_tpu_torch.pipeline.offline import make_reconstruct_fn

    cfg, tr = ctx.config, ctx.traffic
    st = State()
    config = _config(ctx)
    st.step = make_reconstruct_fn(config, ctx.device)
    st.n, st.spf = config.block_samples, config.samples_per_frame
    st.k = int(tr["loop_blocks"])
    words = capture_words(CaptureSpec.from_config(cfg), st.n * st.k, ctx.seed, ctx.device)
    st.words = words
    st.blocks = [words[2 * b * st.n: 2 * (b + 1) * st.n] for b in range(st.k)]
    st.phases = [(-b * st.n) % st.spf for b in range(st.k)]
    st.alpha = float(cfg["alpha"])
    st.ema = torch.zeros(config.render_size, dtype=torch.float32, device=ctx.device)
    st.i = 0
    for _ in range(int(tr["warm_steps"])):
        _one(st)
    st.keep = Reservoir(int(tr["checked_steps"]), ctx.rng)
    return st


def _one(st: State):
    b = st.i % st.k
    out = st.step(st.blocks[b], st.ema, st.alpha, st.phases[b])
    st.ema = out[0]
    st.i += 1
    return out


def _untimed(name: str):
    return contextlib.nullcontext()


def measure(ctx, st: State, seconds: float | None) -> dict:
    count = None if seconds is not None else int(ctx.traffic["traced_steps"])
    ctx.fence()
    t0 = ctx.now()
    t_end = t0 + seconds if seconds is not None else float("inf")
    done = 0
    # The issue span is read in the traced run; the timed window keeps no
    # per-step bookkeeping beside the sample.
    timed = ctx.spans.timed if count is not None else _untimed
    while (ctx.now() < t_end) if count is None else (done < count):
        i = st.i
        with timed("issue"):
            out = _one(st)
        slot = st.keep.slot()
        if slot is not None:
            st.keep.put(slot, (i, *out))
        done += 1
    ctx.fence()
    window_s = ctx.now() - t0
    items = [{"t0": t0, "t1": t0 + window_s, "samples": st.n}] * done
    return {"window_s": window_s, "items": items, "attempted": done,
            "work": _work(ctx, st)}


def _work(ctx, st: State) -> dict:
    cfg, tr = ctx.config, ctx.traffic
    h, w = cfg["render_size"]
    f = int(tr["n_frames"])
    g = chain.geometry(int(np.floor(st.spf)), int(cfg["height_total"]),
                       int(cfg["width_total"]), (h, w))
    span = int(np.ceil((w - 1) * g.delta + 1)) + 3
    starts, _ = chain.exact_cut_starts(0.0, st.spf, f)
    read = rooflines.addressed_samples(starts, g.line_start, span, st.n)
    bf16 = tr["resampler"] in ("mxu3", "mxu4", "mxu_batched")
    return {"k1": (*rooflines.k1_work(f, h, w, read, 4, 2, bf16), 1),
            "k2k3": (*rooflines.k2k3_work(f, h, w), 3)}


def collect(ctx, st: State) -> dict:
    kept = [(i, e.cpu(), fr.cpu(), sy.cpu(), sc.cpu()) for i, e, fr, sy, sc in st.keep.values()]
    out = {"kept": kept, "words": st.words.cpu(), "n": st.n, "k": st.k}
    st.step = st.blocks = st.words = None
    return out


def _reference(ctx, ans: dict, i: int, q):
    """(ema, frames, sync, score) of step ``i``, rebuilt from zero."""
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    n, k = ans["n"], ans["k"]
    spf = float(cfg["sample_rate"]) / float(cfg["refresh_hz"])
    f = int(tr["n_frames"])
    g = chain.geometry(int(np.floor(spf)), int(cfg["height_total"]), int(cfg["width_total"]),
                       tuple(cfg["render_size"]))
    bf16 = tr["resampler"] in ("mxu3", "mxu4", "mxu_batched")
    ema = torch.zeros(tuple(cfg["render_size"]), dtype=torch.float32, device=dev)
    for j in range(max(0, i - HISTORY_STEPS), i + 1):
        b = j % k
        words = ans["words"][2 * b * n: 2 * (b + 1) * n].to(dev)
        phase = (-b * n) % spf
        starts, fracs = chain.exact_cut_starts(phase, spf, f)
        env = chain.envelope(words, q, bf16=bf16)
        ema, frames, sync, score = chain.chain(env, starts, fracs, g, ema, float(cfg["alpha"]),
                                               2, q)
    return ema, frames, sync, score


def control(ctx, ans: dict) -> dict:
    kept = []
    for i, *_ in ans["kept"]:
        ema, frames, sync, score = _reference(ctx, ans, i, chain.bfloat16)
        kept.append((i, ema.cpu(), frames.cpu(), sync.cpu(), score.cpu()))
    return {**ans, "kept": kept}


def verify(ctx, ans: dict) -> dict:
    readings = {}
    if not ans["kept"]:
        return {"steps_checked": float("inf")}
    for i, ema, frames, sync, score in ans["kept"]:
        ema_r, frames_r, sync_r, score_r = _reference(ctx, ans, i, chain.exact)
        check(readings, "ema_rel", rel_max(ema, ema_r))
        check(readings, "frames_rel", rel_max(frames, frames_r))
        check(readings, "sync_px", abs_max(sync, sync_r))
        check(readings, "score_rel", abs_max(score, score_r) / float(score_r.abs().max()))
    return readings
