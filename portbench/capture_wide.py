"""The wideband benchmark input: one screen leaking at several harmonics of
its pixel clock, as one SDR capture receives them, made on the device from
the seed.

The model of ``tempest_tpu_torch/io/synthetic.py`` ``generate_iq_harmonics``
(AM), rewritten in PyTorch beside ``capture.py``, whose screen, envelope and
raster start phase it takes: ``Σ_k A_k (dc + d_k·env) e^{j(2π f_k t + φ_k)}``
plus one complex white noise whose power lies ``snr_db`` below the strongest
carrier's modulated power over the whole capture.  The screen's glyph rows,
the raster's start phase, the carriers' phases ``φ_k`` and the noise are
drawn from the seed by ``torch.Generator``s on the device, in chunks of
``capture.CHUNK`` samples.

    spec = WideSpec.from_config(cfg)
    words = capture_words(spec, n_samples, seed, device)   # int16 [2n]
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .capture import CHUNK, CaptureSpec, _envelope, _generator, _start_phase, screen

__all__ = ["WideSpec", "capture_words"]


@dataclasses.dataclass(frozen=True)
class WideSpec:
    """The raster and receiver (``base``: its ``snr_db``, ``dc_level`` and
    ``int16_scale`` hold for the capture) and each carrier's offset,
    amplitude and modulation depth (negative: inverted video)."""

    base: CaptureSpec
    carriers_hz: tuple[float, ...]
    amplitudes: tuple[float, ...]
    depths: tuple[float, ...]

    @classmethod
    def from_config(cls, cfg: dict) -> "WideSpec":
        a = cfg["assumed"]
        base = CaptureSpec(int(cfg["width_total"]), int(cfg["height_total"]),
                           float(cfg["refresh_hz"]), float(cfg["sample_rate"]),
                           snr_db=float(a["snr_db"]), carrier_offset_hz=0.0,
                           dc_level=float(a["dc_level"]), int16_scale=float(a["int16_scale"]))
        return cls(base, tuple(float(f) for f in a["carriers_hz"]),
                   tuple(float(x) for x in a["amplitudes"]),
                   tuple(float(x) for x in a["depths"]))


def _chunks(spec: WideSpec, n_samples: int, seed: int, device):
    """(offset, complex64 samples) of the capture, chunk by chunk."""
    b = spec.base
    raster = screen(b, seed, device).reshape(-1)
    phase0 = _start_phase(b, seed, device)
    phis = (torch.rand(len(spec.carriers_hz), generator=_generator(seed, device, 3),
                       device=device, dtype=torch.float64) * (2.0 * math.pi)).tolist()
    # The envelope's first two moments over the whole capture give each
    # carrier's modulated power; the strongest sets the noise.
    m1 = m2 = 0.0
    for k0 in range(0, n_samples, CHUNK):
        env, _ = _envelope(raster, b, phase0, k0, min(CHUNK, n_samples - k0))
        e = env.to(torch.float64)
        m1 += float(torch.sum(e))
        m2 += float(torch.sum(e * e))
    m1, m2 = m1 / n_samples, m2 / n_samples
    ref_power = max(a * a * (b.dc_level ** 2 + 2.0 * b.dc_level * d * m1 + d * d * m2)
                    for a, d in zip(spec.amplitudes, spec.depths))
    noise_std = math.sqrt(ref_power / (10.0 ** (b.snr_db / 10.0)) / 2.0)
    noise = _generator(seed, device, 2)
    for k0 in range(0, n_samples, CHUNK):
        n = min(CHUNK, n_samples - k0)
        env, k = _envelope(raster, b, phase0, k0, n)
        env = env.to(torch.float64)
        z = torch.zeros(n, dtype=torch.complex128, device=device)
        for a, d, fc, phi in zip(spec.amplitudes, spec.depths, spec.carriers_hz, phis):
            theta = torch.remainder(2.0 * math.pi * fc / b.sample_rate * k + phi, 2.0 * math.pi)
            z += torch.polar(a * (b.dc_level + d * env), theta)
        z = z.to(torch.complex64) + noise_std * math.sqrt(2.0) * torch.randn(
            n, generator=noise, device=device, dtype=torch.complex64)
        yield k0, z


def capture_words(spec: WideSpec, n_samples: int, seed: int, device) -> torch.Tensor:
    """int16 interleaved I/Q words [2·n_samples] on ``device``: the capture
    scaled by ``int16_scale`` and rounded, saturating as a 16-bit ADC does."""
    out = torch.empty(2 * n_samples, dtype=torch.int16, device=device)
    for k0, z in _chunks(spec, n_samples, seed, device):
        w = torch.view_as_real(z).reshape(-1) * spec.base.int16_scale
        out[2 * k0: 2 * (k0 + z.shape[0])] = torch.round(w).clamp(-32768, 32767).to(torch.int16)
    return out
