"""AM demodulation in PyTorch — the counterpart of ``tempest_tpu/ops/demod.py``.

The JAX version sums ``I² + Q²`` of interleaved words with a (128, 64)
one-hot matmul, because strided minor-axis loads lower badly on a TPU.  On a
GPU a stride-2 read is an ordinary coalesced load, so here the demod is plain
elementwise torch: view the words as (N, 2) pairs, square, add, sqrt.  The
one-hot sum adds exact zeros, so both give the same ``I² + Q²``.

The streaming step does not call ``am_envelope_from_iq`` for plain AM on
interleaved words: K1 takes the envelope inside its load, with the same
roundings (``ops/resample_kernel.frames_to_screens_from_words``).  It stays
the plain version that entry is held against, and the demod of the
``invert`` option.

FM and planar I/Q are not ported yet (ROADMAP Queue 1, "FM and planar demod").
"""

from __future__ import annotations

import torch

__all__ = ["am_demod", "am_envelope_from_iq", "invert_envelope"]


def am_envelope_from_iq(iq: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """AM envelope from an *interleaved* I/Q word vector (int16 or float32,
    shape (2N,)) — ``scale * sqrt(I² + Q²)`` as float32 (N,).  An odd
    trailing word is dropped, as in the JAX version."""
    if iq.dim() != 1:
        raise ValueError(f"interleaved I/Q words must be 1-D, got shape {tuple(iq.shape)}")
    n = iq.shape[0] // 2
    pairs = iq[: 2 * n].to(torch.float32).view(n, 2)
    sq = pairs * pairs
    env = torch.sqrt(sq[:, 0] + sq[:, 1])
    return env if scale == 1.0 else scale * env


def am_demod(sig: torch.Tensor) -> torch.Tensor:
    """AM envelope ``|z|`` of complex samples, as float32."""
    if not sig.is_complex():
        raise ValueError("am_demod takes complex samples; use am_envelope_from_iq for I/Q words")
    return torch.abs(sig).to(torch.float32)


def invert_envelope(env: torch.Tensor) -> torch.Tensor:
    """Inverted, max-normalised envelope ``1 - env / max(env)`` — the
    ``invert`` option of the reconstruction config."""
    return 1.0 - env / torch.max(env)
