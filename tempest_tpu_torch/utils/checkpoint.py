"""Checkpoint/resume for the streaming runtime.

The reference's only persistence is raw IQ recording (``GUI.jl:182-190``);
its processing state (EMA image, video config, Observables) dies with the
process.  Here the streaming state is an explicit, small pytree — so we
checkpoint it: the carried EMA image, the absolute sample position (frame
phase), the video mode, and the tuning knobs.  A resumed runtime continues
frame-phase-continuous averaging exactly where it stopped.

Format: a single ``.npz`` (no external checkpoint dependency needed at this
state size; the arrays are one 600×800 image and scalars).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..video.modes import VideoMode

__all__ = ["RuntimeState", "save_state", "load_state"]

_VERSION = 1


@dataclasses.dataclass
class RuntimeState:
    ema: np.ndarray          # carried EMA image (float32)
    abs_pos: int             # absolute sample index of the next block start
    mode: VideoMode
    sample_rate: float
    alpha: float
    frames_out: int = 0
    # Live multi-harmonic combining (ops.combine): carrier offsets [Hz] and
    # channel bandwidth.  Empty/None = combining off.
    combine_centers: list[float] | None = None
    combine_bw: float = 4e6
    combine_demod: str = "am"
    # Spectral CW excision margin [dB] (None = off) — must round-trip or a
    # resumed session silently loses interference rejection (r4 verdict).
    combine_excise_db: float | None = None
    # Chain-selection knobs owned by the runtime constructor; without them a
    # resume falls back to the constructor's chain, not the saved one.
    fidelity: bool = False
    fidelity_bins: int = 64
    invert: bool = False


def save_state(state: RuntimeState, path: str) -> None:
    np.savez_compressed(
        path,
        version=_VERSION,
        ema=state.ema.astype(np.float32),
        abs_pos=np.int64(state.abs_pos),
        mode=np.array([state.mode.width, state.mode.height, state.mode.refresh]),
        sample_rate=np.float64(state.sample_rate),
        alpha=np.float32(state.alpha),
        frames_out=np.int64(state.frames_out),
        combine_centers=np.asarray(state.combine_centers or [], np.float64),
        combine_bw=np.float64(state.combine_bw),
        combine_demod=np.str_(state.combine_demod),
        combine_excise_db=np.float64(
            np.nan if state.combine_excise_db is None
            else state.combine_excise_db),
        fidelity=np.bool_(state.fidelity),
        fidelity_bins=np.int64(state.fidelity_bins),
        invert=np.bool_(state.invert),
    )


def load_state(path: str) -> RuntimeState:
    with np.load(path) as z:
        version = int(z["version"])
        if version != _VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        w, h, r = z["mode"]
        # Combine fields are absent in pre-round-4 checkpoints — key-presence
        # gated rather than version-bumped so old checkpoints keep loading.
        centers = (z["combine_centers"].tolist()
                   if "combine_centers" in z.files else [])
        return RuntimeState(
            ema=z["ema"].astype(np.float32),
            abs_pos=int(z["abs_pos"]),
            mode=VideoMode(int(w), int(h), float(r)),
            sample_rate=float(z["sample_rate"]),
            alpha=float(z["alpha"]),
            frames_out=int(z["frames_out"]),
            combine_centers=centers or None,
            combine_bw=(float(z["combine_bw"])
                        if "combine_bw" in z.files else 4e6),
            combine_demod=(str(z["combine_demod"])
                           if "combine_demod" in z.files else "am"),
            combine_excise_db=(
                None
                if "combine_excise_db" not in z.files
                or np.isnan(float(z["combine_excise_db"]))
                else float(z["combine_excise_db"])),
            fidelity=(bool(z["fidelity"])
                      if "fidelity" in z.files else False),
            fidelity_bins=(int(z["fidelity_bins"])
                           if "fidelity_bins" in z.files else 64),
            invert=(bool(z["invert"]) if "invert" in z.files else False),
        )
