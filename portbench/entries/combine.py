"""A wideband recording to an image: ``combined_reconstruct(words, fs, None)``
on the recording's int16 words on the host, no carrier given, call after
call.

An item is a call: the upload, the band scan and its noise floor, the
discovery of the screen's carriers, the two-pass fusion, the timing of the
fused envelope, K1's envelope entry over every whole frame period, K2, K3,
the read-back and the restoration.  Every call's carriers, weights,
polarities, fused envelope (its host copy), mode, refresh, raw EMA and
restored image are kept; one call, drawn from the seed, also keeps its
frames and sync.  The reference (``reference/combine.py``) works all of it
out again from the same words.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.capture_wide import WideSpec, capture_words
from portbench.harness import Reservoir, abs_max, check, rel_max
from portbench.reference import chain, combine

__all__ = ["prepare", "measure", "collect", "control", "verify"]


class State:
    pass


def prepare(ctx) -> State:
    from tempest_tpu_torch.pipeline.offline import combined_reconstruct

    cfg = ctx.config
    a = cfg["assumed"]
    st = State()
    st.fs = float(cfg["sample_rate"])
    n = int(round(st.fs * float(cfg["seconds"])))
    st.words = capture_words(WideSpec.from_config(cfg), n, ctx.seed, ctx.device).cpu().numpy()
    st.call = lambda: combined_reconstruct(
        st.words, st.fs, None, chan_bw=float(a["chan_bw"]), alpha=float(cfg["alpha"]),
        corr_seconds=float(a["corr_seconds"]), min_margin_db=float(a["min_margin_db"]),
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
        with ctx.spans.timed("combined"):
            tm, recon, comb = st.call()
        t2 = ctx.now()
        st.items.append({"t0": t1, "t1": t2, "samples": st.words.shape[0] // 2})
        st.calls.append({"centers": comb.centers_hz, "weights": comb.weights,
                         "polarity": comb.polarity, "envelope": comb.envelope,
                         "mode": tm.mode_name, "refresh": float(tm.refresh_hz),
                         "image": recon.image, "raw": recon.image_raw})
        slot = st.keep.slot()
        if slot is not None:
            st.keep.put(slot, (len(st.calls) - 1, recon.frames, recon.sync))
    return {"window_s": st.items[-1]["t1"] - t0, "items": st.items,
            "attempted": len(st.items), "work": {}}


def collect(ctx, st: State) -> dict:
    kept = [(i, torch.from_numpy(f), np.asarray(s)) for i, f, s in st.keep.values()]
    out = {"calls": st.calls, "kept": kept, "words": st.words, "fs": st.fs}
    st.call = None
    return out


def _reference(ctx, ans: dict, q) -> dict:
    cfg = ctx.config
    a = cfg["assumed"]
    words = torch.from_numpy(ans["words"]).to(ctx.device)
    return combine.reconstruct(words, ans["fs"], float(a["chan_bw"]), float(a["corr_seconds"]),
                               float(a["min_margin_db"]), float(cfg["alpha"]),
                               cfg["render_size"], q)


def control(ctx, ans: dict) -> dict:
    """The answers of the reference in bfloat16, in the program's place."""
    ref = _reference(ctx, ans, chain.bfloat16)
    call = {"centers": ref["centers_hz"], "weights": ref["weights"].cpu().numpy(),
            "polarity": ref["polarity"].cpu().numpy(), "envelope": ref["envelope"].cpu().numpy(),
            "mode": ref["mode"], "refresh": ref["refresh_hz"],
            "image": ref["image"].cpu().numpy(), "raw": ref["raw"].cpu().numpy()}
    kept = [(i, ref["frames"].cpu(), ref["sync"].cpu().numpy()) for i, _, _ in ans["kept"]]
    return {**ans, "calls": [call] * len(ans["calls"]), "kept": kept}


def _circular_gap(got, want: torch.Tensor, periods) -> float:
    """max over frames of the circular distance between two blanking
    centres (s_y, s_x) on a screen of ``periods`` = (h, w): the alignment
    shifts circularly, so centres a whole screen apart (-0.004 and 799.996)
    are one shift; inf where the shapes differ or a value is not finite."""
    got = torch.as_tensor(got).to(want.device, torch.float64)
    want = want.to(torch.float64)
    if got.shape != want.shape:
        return float("inf")
    n = torch.tensor([float(p) for p in periods], dtype=torch.float64, device=want.device)
    d = torch.remainder(got - want, n)
    gap = float(torch.max(torch.minimum(d, n - d)))
    return gap if gap == gap else float("inf")


def _differ(got, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    return float(got.shape != want.shape or not np.array_equal(got, want))


def verify(ctx, ans: dict) -> dict:
    if not ans["calls"]:
        return {"calls_checked": float("inf")}
    ref = _reference(ctx, ans, chain.exact)
    centers = np.asarray(ref["centers_hz"], np.float64)
    polarity = ref["polarity"].cpu().numpy().astype(np.float64)
    readings = {}
    for c in ans["calls"]:
        # Which carriers, which polarities and which mode are decisions,
        # held exact; the rest are numbers, held to a gap between the
        # program's and the control's readings.
        check(readings, "carriers_wrong", _differ(c["centers"], centers))
        check(readings, "polarity_wrong", _differ(c["polarity"], polarity))
        check(readings, "weights_gap", abs_max(torch.as_tensor(np.asarray(c["weights"])),
                                               ref["weights"].double()))
        check(readings, "envelope_rel", rel_max(torch.as_tensor(c["envelope"]), ref["envelope"]))
        check(readings, "mode_wrong", float(c["mode"] != ref["mode"]))
        check(readings, "refresh_gap_hz", abs(c["refresh"] - ref["refresh_hz"]))
        check(readings, "raw_rel", rel_max(torch.as_tensor(c["raw"]), ref["raw"]))
        check(readings, "image_rel", rel_max(torch.as_tensor(c["image"]), ref["image"]))
    for _, got_frames, got_sync in ans["kept"]:
        check(readings, "frames_rel", rel_max(got_frames, ref["frames"]))
        check(readings, "sync_px", _circular_gap(got_sync, ref["sync"], ctx.config["render_size"]))
    return readings
