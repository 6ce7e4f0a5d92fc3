"""Spectral estimation in PyTorch — the counterpart of
``tempest_tpu/ops/spectrum.py``: periodogram, Welch PSD and waterfall.

The Welch and waterfall estimators reshape the signal into a
(segments, fft_size) matrix and run one batched FFT.  Signals may be numpy
arrays or tensors, complex or real, of any float or int dtype; with
``device=None`` a tensor is taken where it lies and a host array goes to the
CUDA card (raising when there is none).  ``get_welch_sharded`` splits the
segment axis over a device mesh (``parallel.mesh``): each shard accumulates
its segments and one ``all_reduce_sum`` adds the parts.
"""

from __future__ import annotations

import torch

from ..utils.device import as_tensor

__all__ = ["get_spectrum", "get_welch", "get_welch_sharded", "welch_accumulate", "get_waterfall"]

_EPS = 1e-30  # keep log10 finite; 10*log10(1e-30) = -300 dB floor


def _freq_axis(n: int, fs: float, device: torch.device) -> torch.Tensor:
    return (torch.arange(n, device=device) / n - 0.5) * fs


def _signal(sig, device) -> torch.Tensor:
    """The signal on its device in a dtype the FFT takes (ints as float32)."""
    sig = as_tensor(sig, device)
    if not (sig.is_complex() or sig.is_floating_point()):
        sig = sig.to(torch.float32)
    return sig


def _abs2(spec: torch.Tensor) -> torch.Tensor:
    return spec.real ** 2 + spec.imag ** 2


def get_spectrum(
    fs, sig=None, n: int | None = None, device: torch.device | str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Periodogram in dB over a centred frequency axis.

    The fs-less form ``get_spectrum(sig)`` returns a normalised frequency
    axis in [-0.5, 0.5)."""
    if sig is None:
        fs, sig = 1.0, fs
    sig = _signal(sig, device)
    if n is None:
        n = sig.shape[0]
    spec = torch.fft.fftshift(torch.fft.fft(sig[:n]))
    power = 10.0 * torch.log10(_abs2(spec) + _EPS)
    return _freq_axis(n, fs, sig.device), power


def welch_accumulate(segs: torch.Tensor) -> torch.Tensor:
    """Sum of per-segment ``|FFT|^2`` for a (n_seg, fft_size) batch — the
    reduction inside Welch, exposed so that callers holding partial batches
    can add their accumulations."""
    return torch.sum(_abs2(torch.fft.fft(segs, dim=-1)), dim=0)


def _segments(sig: torch.Tensor, fft_size: int) -> torch.Tensor:
    n_seg = sig.shape[0] // fft_size
    return sig[: n_seg * fft_size].reshape(n_seg, fft_size)


def get_welch(
    fs: float, sig, fft_size: int = 1024, device: torch.device | str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Welch-style PSD: the sum of per-segment ``|FFT|^2`` over
    non-overlapping rectangular segments, in dB (a sum, not a mean: the
    constant offset does not change the shape in dB)."""
    sig = _signal(sig, device)
    acc = welch_accumulate(_segments(sig, fft_size))
    power = 10.0 * torch.log10(torch.fft.fftshift(acc) + _EPS)
    return _freq_axis(fft_size, fs, sig.device), power


def get_welch_sharded(
    fs: float, sig, mesh, fft_size: int = 1024, axis: str = "blocks"
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`get_welch` with the segment axis split over ``mesh``: each
    shard FFTs and accumulates its segments, one ``all_reduce_sum`` adds the
    parts (in shard order on a one-process mesh).  The segment count is cut
    to a multiple of the mesh axis (trailing samples dropped, as in the
    single-device version).  The result lies on ``mesh.device``."""
    from ..parallel.mesh import block_sharding

    n_dev = mesh.shape[axis]
    sig = _signal(sig, mesh.device)
    n_seg = sig.shape[0] // fft_size
    n_seg -= n_seg % n_dev
    if n_seg == 0:
        raise ValueError("signal too short for one segment per device")
    segs = sig[: n_seg * fft_size].reshape(n_dev, n_seg // n_dev, fft_size)
    parts = [welch_accumulate(s) for s in block_sharding(mesh, axis).place(segs)]
    acc = mesh.comm.all_reduce_sum(parts, axis)[0]
    power = 10.0 * torch.log10(torch.fft.fftshift(acc) + _EPS)
    return _freq_axis(fft_size, fs, acc.device), power


def get_waterfall(
    fs: float, sig, fft_size: int = 1024, device: torch.device | str | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time × frequency power matrix.  Returns (time_axis, freq_axis, power)
    with ``power[f, t]`` in a (fft_size, n_seg) layout."""
    sig = _signal(sig, device)
    segs = _segments(sig, fft_size)
    power = _abs2(torch.fft.fftshift(torch.fft.fft(segs, dim=-1), dim=-1))
    t_ax = torch.arange(segs.shape[0], device=sig.device) * (fft_size / fs)
    return t_ax, _freq_axis(fft_size, fs, sig.device), power.T
