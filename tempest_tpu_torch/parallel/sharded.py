"""The single-device part of ``tempest_tpu/parallel/sharded.py``: the static
video-mode hypothesis search.

``mode_search_static`` lives under ``parallel/`` because its siblings in the
JAX package shard candidates or time over a device mesh; it runs on ONE
device itself, and it is what ``auto_reconstruct(refine_with_search=True)``
calls.  Everything of that file that takes a mesh
(``sharded_reconstruct_fn``, ``sharded_mode_search``,
``sharded_mode_search_2d`` and their kin) waits for ROADMAP's "Multi-GPU"
queue and raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.demod import am_envelope_from_iq
from ..ops.framesync import frame_sync
from ..ops.resample import round_to_bfloat16
from ..ops.resample_kernel import frames_to_screens
from ..utils.device import as_tensor, resolve_device
from ..video.modes import VideoMode

__all__ = [
    "ModeSearchResult",
    "mode_search_static",
    "sharded_reconstruct_fn",
    "sharded_mode_search",
    "sharded_mode_search_2d",
]


@dataclasses.dataclass
class ModeSearchResult:
    best_index: int
    best_mode: VideoMode
    scores: np.ndarray       # (n_candidates,) sync contrast per hypothesis
    names: list[str]


def mode_search_static(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    refresh_hz: float,
    candidates: list[tuple[str, VideoMode]],
    n_frames: int = 2,
    score_size: tuple[int, int] = (150, 200),
    num_phases: int = 16,
    device: torch.device | str | None = None,
) -> ModeSearchResult:
    """Hypothesis search over candidate video modes on ``device`` (``None``:
    where a tensor lies, else the CUDA card; raises when there is none).

    For each candidate ``(y_t, x_t)``, render ``n_frames`` frames of the
    capture on a reduced ``score_size`` grid and take the two-axis
    ``frame_sync`` contrast, mean over the frames; the best-scoring
    candidate wins.  Blanking contrast discrimination doesn't need render
    fidelity, hence the small grid and the coarse ``num_phases``.

    ``iq`` is complex samples, or a real signal taken as an envelope that is
    demodulated already.  The AM envelope is taken once and rounded to
    bfloat16 (as the JAX package's select matmuls round it, so that the
    scores compare); then each candidate is ONE K1 launch with its own
    phase-quantised line table (a geometry is a host table, so C candidates
    are C launches on one stream with no host synchronisation between them),
    and one batched ``frame_sync`` scores all C·F screens.  Where the JAX
    program pads each frame with its last sample, K1 reads on into the next
    frame: the bottom row of a screen may differ, the scores barely."""
    if not candidates:
        raise ValueError("empty candidate set")
    names = [n for n, _ in candidates]
    spf = fs / refresh_hz
    frame_len = int(np.floor(spf))
    starts = np.round(np.arange(n_frames) * spf).astype(np.int64)
    need = int(starts[-1]) + frame_len + 1
    if isinstance(iq, np.ndarray) and np.iscomplexobj(iq):
        words = np.ascontiguousarray(iq[:need], np.complex64).view(np.float32)
        env = am_envelope_from_iq(as_tensor(words, device))
    else:
        sig = as_tensor(iq, device)
        env = sig.abs().to(torch.float32)
    if env.shape[0] < need:
        raise ValueError(f"need {need} samples for the mode search, got {env.shape[0]}")
    env = round_to_bfloat16(env[:need]).contiguous()
    fstarts = torch.from_numpy(starts.astype(np.int32)).to(env.device)
    screens = torch.cat([
        frames_to_screens(env, fstarts, frame_len, m.height, m.width, tuple(score_size),
                          None, 2, num_phases)
        for _, m in candidates])                                   # [C·F, h, w]
    _, _, score = frame_sync(screens)
    scores = score.reshape(len(candidates), n_frames).mean(dim=1).cpu().numpy()
    best = int(np.argmax(scores))
    return ModeSearchResult(
        best_index=best,
        best_mode=candidates[best][1],
        scores=scores,
        names=names,
    )


def _needs_mesh(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} runs over a device mesh: ROADMAP Queue 1, 'Multi-GPU'")

    fn.__name__ = name
    fn.__doc__ = f"``{name}`` of the JAX package takes a device mesh; not ported yet."
    return fn


sharded_reconstruct_fn = _needs_mesh("sharded_reconstruct_fn")
sharded_mode_search = _needs_mesh("sharded_mode_search")
sharded_mode_search_2d = _needs_mesh("sharded_mode_search_2d")
