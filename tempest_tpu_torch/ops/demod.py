"""Demodulation in PyTorch — the counterpart of ``tempest_tpu/ops/demod.py``:
the AM envelope, its square (what the timing estimators correlate), the
inverted normalised envelope, and the FM discriminator, each from complex
samples, from interleaved I/Q words and from planar (2, N) I/Q.

The JAX version sums ``I² + Q²`` of interleaved words with a (128, 64)
one-hot matmul, because strided minor-axis loads lower badly on a TPU.  On a
GPU a stride-2 read is an ordinary coalesced load, so here the demod is plain
elementwise torch: view the words as (N, 2) pairs, square, add, sqrt.  The
one-hot sum adds exact zeros, so both give the same ``I² + Q²``; the FM
discriminator reads I and Q as the two strided columns of the same view
where the JAX version selects them with two more one-hot matmuls.

The streaming step does not call ``am_envelope_from_iq``,
``fm_demod_from_iq`` or ``invert_envelope`` on interleaved words: K1 takes
the envelope or the discriminator inside its load, inverted by the block
maximum of its own launch, with the same roundings
(``ops/resample_kernel.frames_to_screens_from_words``, ``words_maxima``),
in the single step, the batched step and a shard's window.  They stay the
plain versions those launches are held against, and the demod of the routes
that keep it a pass (``pipeline.offline.fuses_demod``): complex, planar and
envelope input, the plain resamplers, the mode search.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "am_demod",
    "invert_am_demod",
    "am_demod_power",
    "am_envelope_from_iq",
    "am_envelope_from_iq_planar",
    "am_power_from_iq",
    "fm_demod",
    "fm_demod_from_iq",
    "fm_demod_from_iq_planar",
    "fm_demod_rows",
    "invert_envelope",
    "to_planar_iq",
]


def _pairs(iq: torch.Tensor) -> torch.Tensor:
    """Interleaved I/Q words (2N,) as float32 (N, 2) pairs; an odd trailing
    word is dropped, as in the JAX version."""
    if iq.dim() != 1:
        raise ValueError(f"interleaved I/Q words must be 1-D, got shape {tuple(iq.shape)}")
    n = iq.shape[0] // 2
    return iq[: 2 * n].to(torch.float32).view(n, 2)


def am_envelope_from_iq(iq: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """AM envelope from an *interleaved* I/Q word vector (int16 or float32,
    shape (2N,)) — ``scale * sqrt(I² + Q²)`` as float32 (N,).  An odd
    trailing word is dropped, as in the JAX version."""
    env = torch.sqrt(am_power_from_iq(iq))
    return env if scale == 1.0 else scale * env


def am_power_from_iq(iq: torch.Tensor) -> torch.Tensor:
    """Squared envelope ``I² + Q²`` from interleaved words, float32 (N,) —
    what the timing estimators feed the autocorrelation; no sqrt."""
    pairs = _pairs(iq)
    sq = pairs * pairs
    return sq[:, 0] + sq[:, 1]


def am_envelope_from_iq_planar(iq2: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """AM envelope from *planar* I/Q — shape (2, N), row 0 = I, row 1 = Q."""
    xf = iq2.to(torch.float32)
    env = torch.sqrt(xf[0] * xf[0] + xf[1] * xf[1])
    return env if scale == 1.0 else scale * env


def _discriminator(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``arg(z[n]·conj(z[n-1]))`` along the last axis from real and imaginary
    parts, with element 0 set to 0."""
    re0, im0 = re[..., :-1], im[..., :-1]
    re1, im1 = re[..., 1:], im[..., 1:]
    disc = torch.atan2(im1 * re0 - re1 * im0, re1 * re0 + im1 * im0)
    return torch.nn.functional.pad(disc, (1, 0))


def fm_demod_from_iq(iq: torch.Tensor) -> torch.Tensor:
    """FM discriminator straight from interleaved I/Q words (real ops only):
    ``atan2(im_n re_{n-1} - re_n im_{n-1}, re_n re_{n-1} + im_n im_{n-1})``,
    float32 (N,), out[0] = 0."""
    pairs = _pairs(iq)
    return _discriminator(pairs[:, 0], pairs[:, 1])


def fm_demod_from_iq_planar(iq2: torch.Tensor) -> torch.Tensor:
    """FM discriminator from planar (2, N) I/Q words (see
    :func:`fm_demod_from_iq`)."""
    xf = iq2.to(torch.float32)
    return _discriminator(xf[0], xf[1])


def to_planar_iq(words: np.ndarray) -> np.ndarray:
    """Host-side de-interleave: (2N,) interleaved I/Q words → contiguous
    (2, N).  Accepts int16/float32 interleaved words or complex64 (viewed as
    float32 words, zero-copy)."""
    if np.iscomplexobj(words):
        words = np.ascontiguousarray(words, np.complex64).view(np.float32)
    return np.ascontiguousarray(words.reshape(-1, 2).T)


def am_demod(sig: torch.Tensor) -> torch.Tensor:
    """AM envelope ``|z|`` of complex samples, as float32."""
    if not sig.is_complex():
        raise ValueError("am_demod takes complex samples; use am_envelope_from_iq for I/Q words")
    return torch.abs(sig).to(torch.float32)


def am_demod_power(sig: torch.Tensor) -> torch.Tensor:
    """Squared envelope ``|z|²`` of complex samples — cheaper than ``|z|``
    and monotone in it, so correlation peaks do not move."""
    return sig.real ** 2 + sig.imag ** 2


def fm_demod_rows(chans: torch.Tensor) -> torch.Tensor:
    """Batched FM discriminator over complex rows — shape (..., M) complex
    in, (..., M) float32 out with column 0 zeroed."""
    return _discriminator(chans.real, chans.imag).to(torch.float32)


def fm_demod(sig: torch.Tensor) -> torch.Tensor:
    """FM discriminator ``arg(z[n]·conj(z[n-1]))`` of complex samples, with
    out[0] = 0."""
    return _discriminator(sig.real, sig.imag)


def invert_envelope(env: torch.Tensor) -> torch.Tensor:
    """Inverted, max-normalised envelope ``1 - env / max(env)`` — the
    ``invert`` option of the reconstruction config."""
    return 1.0 - env / torch.max(env)


def invert_am_demod(sig: torch.Tensor) -> torch.Tensor:
    """Inverted, max-normalised envelope ``1 - |z|/max|z|`` of complex
    samples (reference ``invert_amDemod``, ``Demodulation.jl:31-35``)."""
    return invert_envelope(am_demod(sig))
