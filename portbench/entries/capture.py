"""A recording to an image: ``auto_reconstruct(words, fs)`` on the capture's
int16 words on the host, as a user hands a recording over, call after call.

An item is a call: stage 1 (timing and mode), stage 2 over every whole frame
period, the restoration, and the read-back.  Every call's mode, refresh, raw
EMA and restored image are kept (a few MB); one call, drawn from the seed,
also keeps its frames and sync.  The reference works the timing, the mode,
the cuts, the taps and the restoration out again from the same words.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import rooflines
from portbench.capture import CaptureSpec, capture_words
from portbench.harness import Reservoir, abs_max, check, rel_max
from portbench.reference import chain, restore, timing

__all__ = ["prepare", "measure", "collect", "control", "verify"]


class State:
    pass


def prepare(ctx) -> State:
    from tempest_tpu_torch.pipeline.offline import auto_reconstruct

    cfg = ctx.config
    st = State()
    st.fs = float(cfg["sample_rate"])
    n = int(round(st.fs * float(cfg["seconds"])))
    st.words = capture_words(CaptureSpec.from_config(cfg), n, ctx.seed, ctx.device).cpu().numpy()
    st.call = lambda: auto_reconstruct(st.words, st.fs, alpha=float(cfg["alpha"]),
                                       device=ctx.device)
    for _ in range(int(ctx.traffic["warm_calls"])):
        st.call()
    st.keep = Reservoir(1, ctx.rng)
    st.calls, st.items = [], []
    return st


def measure(ctx, st: State, seconds: float | None) -> dict:
    count = None if seconds is not None else int(ctx.traffic["traced_calls"])
    t0 = ctx.now()
    t_end = t0 + seconds if seconds is not None else float("inf")
    while (ctx.now() < t_end) if count is None else (len(st.items) < count):
        t1 = ctx.now()
        with ctx.spans.timed("capture"):
            tm, recon = st.call()
        t2 = ctx.now()
        st.items.append({"t0": t1, "t1": t2, "samples": st.words.shape[0] // 2})
        st.calls.append((tm.mode_name, float(tm.refresh_hz), recon.image, recon.image_raw))
        slot = st.keep.slot()
        if slot is not None:
            st.keep.put(slot, (len(st.calls) - 1, recon.frames, recon.sync))
    window_s = st.items[-1]["t1"] - t0
    return {"window_s": window_s, "items": st.items, "attempted": len(st.items),
            "work": _work(ctx.config, st.words.shape[0] // 2)}


def _work(cfg, n_complex: int) -> dict:
    h_t, w_t = int(cfg["height_total"]), int(cfg["width_total"])
    spf = float(cfg["sample_rate"]) / float(cfg["refresh_hz"])
    n_frames = max(int((n_complex - 1) / spf), 1)
    h, w = cfg["render_size"]
    g = chain.geometry(int(np.floor(spf)), h_t, w_t, (h, w))
    span = int(np.ceil((w - 1) * g.delta + 1)) + 3
    read = rooflines.addressed_samples(chain.static_starts(spf, n_frames), g.line_start, span,
                                       int(np.ceil(spf * n_frames)) + 1)
    return {"k1": (*rooflines.k1_work(n_frames, h, w, read, 4, 4, False), 1),
            "k2k3": (*rooflines.k2k3_work(n_frames, h, w), 3)}


def collect(ctx, st: State) -> dict:
    kept = [(i, torch.from_numpy(f), np.asarray(s)) for i, f, s in st.keep.values()]
    out = {"calls": st.calls, "kept": kept, "words": st.words, "fs": st.fs}
    st.call = None
    return out


def _reference(ctx, ans: dict, q):
    """(mode name, refresh, raw EMA, restored image, frames, sync)."""
    cfg, dev = ctx.config, ctx.device
    fs = ans["fs"]
    words = torch.from_numpy(ans["words"]).to(dev)
    name, fv, _ = timing.estimate_timing(words, fs, q=q)
    w_t, h_t, _ = timing.MODES[name]
    n_complex = words.shape[0] // 2
    spf = fs / fv
    n_frames = max(int((n_complex - 1) / spf), 1)
    taps = 4 if spf / (w_t * h_t) >= 1.0 else 2
    n_block = int(np.ceil(spf * n_frames)) + 1
    g = chain.geometry(int(np.floor(spf)), h_t, w_t, tuple(cfg["render_size"]))
    env = chain.envelope(words[: 2 * n_block], q)
    del words
    ema0 = torch.zeros(tuple(cfg["render_size"]), dtype=torch.float32, device=dev)
    ema, frames, sync, _ = chain.chain(env, chain.static_starts(spf, n_frames), None, g, ema0,
                                       float(cfg["alpha"]), taps, q)
    image = restore.restore_image(ema, fs, fv, h_t, taps, q=q)
    return name, fv, ema, image, frames, sync


def control(ctx, ans: dict) -> dict:
    """The answers of the reference in bfloat16, in the program's place."""
    name, fv, ema, image, frames, sync = _reference(ctx, ans, chain.bfloat16)
    calls = [(name, fv, image.cpu().numpy(), ema.cpu().numpy())] * len(ans["calls"])
    kept = [(i, frames.cpu(), sync.cpu().numpy()) for i, _, _ in ans["kept"]]
    return {**ans, "calls": calls, "kept": kept}


def verify(ctx, ans: dict) -> dict:
    if not ans["calls"]:
        return {"calls_checked": float("inf")}
    name, fv, ema, image, frames, sync = _reference(ctx, ans, chain.exact)
    readings = {}
    for got_name, got_fv, got_image, got_raw in ans["calls"]:
        # The mode is a name, held exact; the measured refresh is a number,
        # held to a gap between the program's and the control's readings.
        check(readings, "mode_wrong", float(got_name != name))
        check(readings, "refresh_gap_hz", abs(float(got_fv) - float(fv)))
        check(readings, "raw_rel", rel_max(torch.as_tensor(got_raw), ema))
        check(readings, "image_rel", rel_max(torch.as_tensor(got_image), image))
    for _, got_frames, got_sync in ans["kept"]:
        check(readings, "frames_rel", rel_max(got_frames, frames))
        check(readings, "sync_px", abs_max(torch.as_tensor(got_sync), sync))
    return readings
