"""Post-average restoration: Wiener deconvolution of the reconstruction's
KNOWN resampling/registration MTF — the counterpart of
``tempest_tpu/ops/enhance.py``.

The deep-averaged image is the true raster convolved with kernels the
pipeline itself chose, so their transfer functions are known exactly — no
blind deblurring:

* **Envelope sampling** (horizontal): along a scan line the envelope is
  sampled every ``Δ = w / samples_per_line`` render pixels and interpolated
  by the resampler's 2-tap linear / 4-tap Catmull-Rom kernel.  Frame-to-frame
  drift sweeps the sample phase across the raster, so the deep average
  converges to the continuous envelope convolved with that kernel at pitch Δ.
* **Sub-pixel registration** (both axes): the fractional alignment roll
  interpolates by the same 2/4-tap kernel at 1-px pitch.

The restoration divides the averaged image by the product of those transfer
functions, Wiener-regularised: ``G = H / (H² + nsr)``, applied as per-axis
real FFTs on the final (h, w) image.  The result is clipped to the input's
value range: deconvolution ringing otherwise stretches the min–max
normalisation that the fidelity metric and every renderer apply.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.device import resolve_device
from .framesync import _interp_weights

__all__ = ["interp_kernel_ft", "wiener_gain", "restore_image"]


def interp_kernel_ft(interp: str, u: np.ndarray, res: int = 128) -> np.ndarray:
    """Transfer function of the pipeline's fractional-interpolation kernel at
    normalised frequencies ``u`` [cycles/sample]: numerically Fourier-
    transform the kernel sampled through the SAME weight formulas the
    registration uses (``ops.framesync._interp_weights``), so the restoration
    filter cannot drift from the blur it inverts.  For ``interp='linear'``
    this equals ``sinc²(u)`` to ~1e-4."""
    f = np.arange(res) / res
    offs, ws = _interp_weights(torch.from_numpy(f), interp)
    u = np.asarray(u, np.float64)
    K = np.zeros_like(u)
    for off, w in zip(offs, ws):
        # Kernel identity: k(off - f) = w_off(f), so each weight array is
        # the kernel sampled on a unit-spaced grid offset by the tap index.
        x = off - f
        K += np.sum(w.numpy()[None, :] * np.cos(2.0 * np.pi * u[:, None] * x[None, :]), axis=1)
    return K / res


def wiener_gain(n: int, kernels: tuple[tuple[float, str], ...], nsr: float) -> np.ndarray:
    """Per-rfft-bin Wiener gain for one image axis of length ``n``:
    ``H = Π_i K_i(ν·δ_i)`` over (pitch δ [px], kernel name) pairs,
    ``G = H / (H² + nsr)``.  An empty kernel list is the identity."""
    if not kernels:
        return np.ones(n // 2 + 1, np.float32)
    nu = np.fft.rfftfreq(n)
    H = np.ones_like(nu)
    for delta, interp in kernels:
        H = H * interp_kernel_ft(interp, nu * float(delta))
    return (H / (H * H + float(nsr))).astype(np.float32)


def _apply_gains(image: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Separable frequency-domain filtering + clip to the input value range."""
    lo, hi = torch.min(image), torch.max(image)
    h, w = image.shape
    out = torch.fft.irfft(torch.fft.rfft(image, dim=1) * gx[None, :], n=w, dim=1)
    out = torch.fft.irfft(torch.fft.rfft(out, dim=0) * gy[:, None], n=h, dim=0)
    return torch.clamp(out, lo, hi)


@lru_cache(maxsize=32)
def _gains_cached(h, w, kx, ky, nsr, device):
    return (torch.from_numpy(wiener_gain(w, kx, nsr)).to(device),
            torch.from_numpy(wiener_gain(h, ky, nsr)).to(device))


def restore_image(
    image: np.ndarray | torch.Tensor,
    config,
    nsr: float = 0.002,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Restore a reconstructed screen by inverting ``config``'s known MTF.

    ``config`` is a :class:`~tempest_tpu_torch.pipeline.offline.
    ReconstructionConfig` (duck-typed: sample_rate, mode, interp_taps,
    do_align, align_subpixel, align_interp are read).  ``nsr`` is the Wiener
    noise-to-signal floor — raise it for noisy/shallow averages, lower it
    for deep clean ones.  A tensor is restored where it lies; a numpy image
    on ``device`` (``None``: the CUDA card; raises when there is none).
    Returns a host array."""
    if isinstance(image, torch.Tensor):
        img = image.to(torch.float32)
    else:
        img = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(resolve_device(device))
    h, w = img.shape
    mode = config.mode
    samples_per_line = config.sample_rate / (mode.refresh * mode.height)
    delta = w / samples_per_line           # render px per envelope sample
    interp = "linear" if config.interp_taps == 2 else "cubic"
    kx = [(delta, interp)]
    ky = []
    if config.do_align and config.align_subpixel:
        reg = config.align_interp
        kx.append((1.0, reg))
        ky.append((1.0, reg))
    gx, gy = _gains_cached(h, w, tuple(kx), tuple(ky), float(nsr), img.device)
    return _apply_gains(img, gx, gy).cpu().numpy()
