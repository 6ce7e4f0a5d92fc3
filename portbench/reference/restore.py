"""Plain reference of the restoration: the Wiener inverse of the chain's known
resampling and registration transfer functions, per axis by real FFTs,
clipped to the input's range.

A frozen copy of the plain math of ``tempest_tpu_torch`` at commit 535d04e
(``ops/enhance.py``: ``interp_kernel_ft``, ``wiener_gain``, ``_apply_gains``,
``restore_image``; ``ops/framesync.py``: ``_interp_weights``), in plain
PyTorch and NumPy, importing nothing of that package.
"""

from __future__ import annotations

import numpy as np
import torch

from .chain import exact

__all__ = ["restore_image"]


def _weights(f: torch.Tensor, interp: str):
    if interp == "linear":
        return (0, 1), (1.0 - f, f)
    f2, f3 = f * f, f * f * f
    return (-1, 0, 1, 2), (0.5 * (-f3 + 2.0 * f2 - f), 0.5 * (3.0 * f3 - 5.0 * f2 + 2.0),
                           0.5 * (-3.0 * f3 + 4.0 * f2 + f), 0.5 * (f3 - f2))


def _kernel_ft(interp: str, u: np.ndarray, res: int = 128) -> np.ndarray:
    f = np.arange(res) / res
    offs, ws = _weights(torch.from_numpy(f), interp)
    u = np.asarray(u, np.float64)
    k = np.zeros_like(u)
    for off, w in zip(offs, ws):
        x = off - f
        k += np.sum(w.numpy()[None, :] * np.cos(2.0 * np.pi * u[:, None] * x[None, :]), axis=1)
    return k / res


def _gain(n: int, kernels, nsr: float) -> np.ndarray:
    if not kernels:
        return np.ones(n // 2 + 1, np.float32)
    nu = np.fft.rfftfreq(n)
    h = np.ones_like(nu)
    for delta, interp in kernels:
        h = h * _kernel_ft(interp, nu * float(delta))
    return (h / (h * h + float(nsr))).astype(np.float32)


def restore_image(image: torch.Tensor, sample_rate: float, refresh: float, height: int,
                  taps: int, nsr: float = 0.002, q=exact) -> torch.Tensor:
    """The restored [h, w] image of a chain with sub-pixel linear alignment."""
    h, w = image.shape
    delta = w / (sample_rate / (refresh * height))
    kx = [(delta, "linear" if taps == 2 else "cubic"), (1.0, "linear")]
    ky = [(1.0, "linear")]
    gx = torch.from_numpy(_gain(w, kx, nsr)).to(image.device)
    gy = torch.from_numpy(_gain(h, ky, nsr)).to(image.device)
    lo, hi = torch.min(image), torch.max(image)
    spec = torch.fft.rfft(image, dim=1)
    out = q(torch.fft.irfft(torch.complex(q(spec.real), q(spec.imag)) * gx[None, :], n=w, dim=1))
    spec = torch.fft.rfft(out, dim=0)
    out = q(torch.fft.irfft(torch.complex(q(spec.real), q(spec.imag)) * gy[:, None], n=h, dim=0))
    return torch.clamp(out, lo, hi)
