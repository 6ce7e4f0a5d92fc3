"""The benchmark's input generator: a screen's emanation as an SDR receives
it, made on the device from the seed.

A copy of ``tempest_tpu_torch/io/synthetic.py`` at commit 535d04e
(``test_pattern``, ``render_frame``, ``_sample_envelope``, ``generate_iq`` with
``modulation="am"``), rewritten in PyTorch so that hundreds of millions of
samples are made on the card in a few large calls.  The screen's glyph rows,
the raster's start phase and the noise are drawn from the seed by a
``torch.Generator`` on the device; the bars, the gradient and the blanking
are the original's.  A float64 position per sample keeps the raster exact
over any length, so a capture of a whole number of frame periods repeats
exactly.

    words = capture_words(spec, n_samples, seed, device)   # int16 [2n]
    iq = capture_complex(spec, n_samples, seed, device)    # complex64 [n]
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["CaptureSpec", "screen", "capture_complex", "capture_words"]

CHUNK = 1 << 25  # samples made per call


@dataclasses.dataclass(frozen=True)
class CaptureSpec:
    """One deployment's emanation: the raster (totals incl. blanking), the
    receiver's rate, and the signal model's constants."""

    width_total: int
    height_total: int
    refresh_hz: float
    sample_rate: float
    snr_db: float = 18.0
    carrier_offset_hz: float = 1.25e6
    modulation_depth: float = 0.8
    dc_level: float = 1.0
    int16_scale: float = 8192.0
    visible_fraction: tuple[float, float] = (0.92, 0.80)

    @classmethod
    def from_config(cls, cfg: dict) -> "CaptureSpec":
        a = cfg["assumed"]
        return cls(int(cfg["width_total"]), int(cfg["height_total"]), float(cfg["refresh_hz"]),
                   float(cfg["sample_rate"]), float(a["snr_db"]), float(a["carrier_offset_hz"]),
                   float(a["modulation_depth"]), float(a["dc_level"]), float(a["int16_scale"]))

    @property
    def pixel_clock(self) -> float:
        return self.width_total * self.height_total * self.refresh_hz


def _generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 4 + stream) % (1 << 63))
    return g


def screen(spec: CaptureSpec, seed: int, device) -> torch.Tensor:
    """The full (height, width) raster in [0, 1]: vertical bars on the top
    third, a gradient in the middle, seeded glyph rows on the bottom third of
    the visible area; blanking at 0."""
    h_t, w_t = spec.height_total, spec.width_total
    vis_w = int(round(w_t * spec.visible_fraction[0]))
    vis_h = int(round(h_t * spec.visible_fraction[1]))
    img = torch.zeros((vis_h, vis_w), dtype=torch.float32, device=device)
    bar_w = max(vis_w // 16, 1)
    cols = (torch.arange(vis_w, device=device) // bar_w) % 2
    img[: vis_h // 3, :] = 0.25 + 0.7 * cols[None, :].to(torch.float32)
    img[vis_h // 3: 2 * vis_h // 3, :] = torch.linspace(0, 1, vis_w, device=device)
    gh, gw = 4, 3
    rows = vis_h - 2 * vis_h // 3
    glyphs = torch.rand((rows // gh + 1, vis_w // gw + 1), generator=_generator(seed, device, 0),
                        device=device) > 0.55
    glyph_img = glyphs.to(torch.float32).repeat_interleave(gh, 0).repeat_interleave(gw, 1)
    img[2 * vis_h // 3:, :] = glyph_img[:rows, :vis_w] * 0.9
    frame = torch.zeros((h_t, w_t), dtype=torch.float32, device=device)
    frame[:vis_h, :vis_w] = img
    return frame


def _start_phase(spec: CaptureSpec, seed: int, device) -> float:
    u = torch.rand((), generator=_generator(seed, device, 1), device=device, dtype=torch.float64)
    return float(u) * spec.width_total * spec.height_total


def _envelope(raster: torch.Tensor, spec: CaptureSpec, start_phase: float, k0: int, n: int):
    n_pix = raster.shape[0]
    step = spec.pixel_clock / spec.sample_rate
    k = torch.arange(k0, k0 + n, dtype=torch.float64, device=raster.device)
    idx = torch.remainder(start_phase + step * k, float(n_pix))
    i0 = idx.to(torch.int64)
    frac = (idx - i0).to(torch.float32)
    i1 = torch.where(i0 + 1 == n_pix, torch.zeros_like(i0), i0 + 1)
    return raster[i0] * (1.0 - frac) + raster[i1] * frac, k


def _chunks(spec: CaptureSpec, n_samples: int, seed: int, device):
    """(offset, complex64 samples) of the capture, chunk by chunk."""
    raster = screen(spec, seed, device).reshape(-1)
    phase0 = _start_phase(spec, seed, device)
    # The clean signal's mean power, over the whole capture, sets the noise.
    power = 0.0
    for k0 in range(0, n_samples, CHUNK):
        env, _ = _envelope(raster, spec, phase0, k0, min(CHUNK, n_samples - k0))
        amp = spec.dc_level + spec.modulation_depth * env.to(torch.float64)
        power += float(torch.sum(amp * amp))
    noise_std = math.sqrt(power / n_samples / (10.0 ** (spec.snr_db / 10.0)) / 2.0)
    noise = _generator(seed, device, 2)
    w = 2.0 * math.pi * spec.carrier_offset_hz / spec.sample_rate
    for k0 in range(0, n_samples, CHUNK):
        n = min(CHUNK, n_samples - k0)
        env, k = _envelope(raster, spec, phase0, k0, n)
        amp = spec.dc_level + spec.modulation_depth * env
        theta = torch.remainder(w * k, 2.0 * math.pi)
        z = torch.polar(amp.to(torch.float64), theta).to(torch.complex64)
        z = z + noise_std * torch.randn(n, generator=noise, device=device, dtype=torch.complex64) \
            * math.sqrt(2.0)
        yield k0, z


def capture_complex(spec: CaptureSpec, n_samples: int, seed: int, device) -> torch.Tensor:
    """complex64 [n_samples] on ``device``."""
    out = torch.empty(n_samples, dtype=torch.complex64, device=device)
    for k0, z in _chunks(spec, n_samples, seed, device):
        out[k0:k0 + z.shape[0]] = z
    return out


def capture_words(spec: CaptureSpec, n_samples: int, seed: int, device) -> torch.Tensor:
    """int16 interleaved I/Q words [2·n_samples] on ``device``: the capture
    scaled by ``int16_scale`` and rounded, as an SDR's 16-bit ADC delivers it."""
    out = torch.empty(2 * n_samples, dtype=torch.int16, device=device)
    for k0, z in _chunks(spec, n_samples, seed, device):
        w = torch.view_as_real(z).reshape(-1) * spec.int16_scale
        out[2 * k0: 2 * (k0 + z.shape[0])] = torch.round(w).clamp(-32768, 32767).to(torch.int16)
    return out
