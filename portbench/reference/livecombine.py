"""Plain reference of the live combine front and the chain behind it, one
block at a time.

A restatement in plain PyTorch and NumPy of what
``StreamingRuntime(combine=centers).step_words(words, phase)`` of
``tempest_tpu_torch`` computes (``runtime/stream.py``: the channel geometry,
the frames of a block, the phase scaled to the channel rate;
``ops/combine.py``: the amplitude rows and the fusion at the known refresh),
importing nothing of that package.  It takes the spectrum, the channels and
the comb dots from ``combine`` and the chain from ``chain`` beside it.  ``q``
is the precision every intermediate is stored in, as in ``chain``.

For one block of interleaved words:

* the N-point spectrum of its first N complex samples and the K channels of
  M samples around the carriers (``combine.spectrum``, ``combine.channel``);
* each channel's AM row with its mean removed;
* the comb dots at the known frame period and half a period off
  (``combine._comb_dots``), the gates, the weights √s/N, normalised;
* each row's polarity against the row of the largest comb mass, re-based to
  the first carrier that survives the gates;
* the fused envelope plus the combined DC, cut to the chain's block;
* the chain at the channel rate on the rounded carry-phase starts of
  ``phase·M/N`` (``chain.carry_phase_starts``, ``chain.chain``, 2 taps).

Where it departs from the program's description, each changing a value by
rounding alone: each channel is its own M-point inverse FFT (the program: one
batched inverse FFT of the stacked bands), and the polarity dots and the
fused envelope are sums over the rows in a loop (the program: matrix-vector
products).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import chain, combine
from .chain import exact

__all__ = ["Geometry", "geometry", "frames_per_window", "front", "block"]


def frames_per_window(cap: int, spf: float) -> int:
    """Whole frame periods in a window of ``cap`` samples after a period of
    phase headroom and the fractional cut's slack."""
    n = max(int((cap - 2 - spf) / spf), 1)
    while n > 1 and int(np.ceil(spf * n)) + 1 + int(np.ceil(spf)) > cap:
        n -= 1
    return n


class Geometry:
    """One configuration's live combine geometry: the source block's FFT
    length N, the channel length M and rate, the frame period at the channel
    rate, the frames of a block, the chain's block and its line tables."""

    def __init__(self, block_samples: int, fs: float, chan_bw: float, refresh_hz: float,
                 y_t: int, x_t: int, render_size) -> None:
        self.fs, self.refresh_hz = float(fs), float(refresh_hz)
        self.n_fft, self.m, self.fs_chan = combine.geometry(block_samples, fs, chan_bw)
        self.spf = self.fs_chan / self.refresh_hz
        self.n_frames = frames_per_window(self.m, self.spf)
        self.block_len = int(np.ceil(self.spf * self.n_frames)) + 1 + int(np.ceil(self.spf))
        self.chain = chain.geometry(int(np.floor(self.spf)), y_t, x_t, tuple(render_size))


def geometry(cfg: dict, block_samples: int) -> Geometry:
    """The geometry of a configuration file's deployment."""
    a = cfg["assumed"]
    return Geometry(block_samples, float(cfg["sample_rate"]), float(a["chan_bw"]),
                    float(cfg["refresh_hz"]), int(cfg["height_total"]), int(cfg["width_total"]),
                    cfg["render_size"])


def front(words: torch.Tensor, g: Geometry, centers, q=exact):
    """The fused envelope of one block, cut to the chain's block, and the
    weights and polarities: (envelope, weights, polarity)."""
    spec = combine.spectrum(words, g.n_fft, q)
    amp = torch.stack([q(torch.abs(combine.channel(spec, fc, g.fs, g.m, q))) for fc in centers])
    del spec
    mean = torch.mean(amp, dim=1, keepdim=True)
    env0 = q(amp - mean)
    del amp
    var = q(torch.mean(q(env0 * env0), dim=1))
    comb = combine._comb_dots(env0, g.spf, 0, q)
    off = combine._comb_dots(env0, g.spf, 1, q)
    anchor = int(torch.argmax(10.0 * torch.log10(torch.clamp(comb, min=1e-30))))
    dots = torch.stack([q(torch.sum(q(row * env0[anchor]))) for row in env0])
    pol = torch.where(dots >= 0.0, 1.0, -1.0).to(torch.float32)
    s = torch.clamp(q(comb - off), min=0.0)
    noise = torch.maximum(q(var - s), 1e-6 * var)
    w = q(torch.sqrt(s) / noise)
    gate = (comb > torch.max(comb) * 1e-2) & (comb * float(math.sqrt(env0.shape[1])) > 6.0 * var)
    w = torch.where(gate, w, torch.zeros_like(w))
    w = q(w / torch.clamp(torch.sum(w), min=1e-30))
    first = int(torch.argmax((w > 0.0).to(torch.int32)))
    pol = pol * pol[first]
    env = torch.zeros_like(env0[0, : g.block_len])
    for k in range(env0.shape[0]):
        env = q(env + q(float(w[k] * pol[k]) * env0[k, : g.block_len]))
    env = q(env + torch.sum(w * mean[:, 0]))
    return env, w, pol


def block(words: torch.Tensor, phase: float, g: Geometry, centers, ema: torch.Tensor,
          alpha: float, q=exact) -> dict:
    """One block through the front and the chain, ``phase`` the offset of its
    next frame boundary in source samples: the front's outputs and (ema',
    frames, sync, score)."""
    env, w, pol = front(words, g, centers, q)
    starts = chain.carry_phase_starts(phase * (g.m / g.n_fft), g.spf, g.n_frames)
    ema, frames, sync, score = chain.chain(env, starts, None, g.chain, ema, float(alpha), 2, q)
    return {"envelope": env, "weights": w, "polarity": pol, "ema": ema, "frames": frames,
            "sync": sync, "score": score}
