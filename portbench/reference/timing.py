"""Plain reference of stage 1, timing estimation: the FFT autocorrelation of
the envelope's power, the refresh rate and the total line count by harmonic
combs, and the snap to the closest video mode.

A frozen copy of the plain math of ``tempest_tpu_torch`` at commit 535d04e,
in plain PyTorch, importing nothing of that package: ``ops/autocorr.py``
(``autocorrelation``, ``_linear_power``, ``_widen_peaks``, ``_lerp``,
``_median``, ``_comb_prominence``, ``_descend_subharmonics``,
``refine_period``, ``estimate_refresh``, ``estimate_line_count``),
``ops/demod.py`` (``am_power_from_iq``), ``pipeline/offline.py``
(``estimate_timing``'s snap) and ``video/modes.py`` (``find_closest_mode``;
the mode table is ``modes.json`` beside this file).  ``q`` is the precision
every intermediate is stored in, as in ``chain``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .chain import exact

__all__ = ["MODES", "find_closest_mode", "estimate_timing"]

_TABLE = json.loads((Path(__file__).with_name("modes.json")).read_text())
# name -> (width total, height total, refresh Hz)
MODES = {row[0]: (int(row[1]), int(row[2]), float(row[3])) for row in _TABLE["modes"]}
_EPS = 1e-30


def find_closest_mode(y_t: float, refresh: float) -> str:
    """The closest known refresh rate first, then the closest height."""
    rates = []
    for _, _, r in MODES.values():
        if r not in rates:
            rates.append(r)
    rates = np.array(rates)
    chosen = rates[np.argmin((refresh - rates) ** 2)]
    best, best_d = None, np.inf
    for name, (_, h, r) in MODES.items():
        if r != chosen:
            continue
        d = (float(y_t) - h) ** 2
        if d < best_d:
            best, best_d = name, d
    return best


def _autocorrelation(x, fs, min_delay, max_delay, q):
    i_lo, i_hi = int(round(min_delay * fs)), int(round(max_delay * fs))
    n_x = x.shape[-1]
    n_raw = min(2 * i_hi, n_x)
    n_up = 1 << max(n_raw - 1, 1).bit_length()
    n = n_up if n_up <= n_x else 1 << (max(n_x, 2).bit_length() - 1)
    i_hi = min(i_hi, n // 2)
    spec = torch.fft.rfft(x[..., :n].to(torch.float32))
    spec = torch.complex(q(spec.real), q(spec.imag))
    corr = q(torch.fft.irfft(q(torch.abs(spec) ** 2), n=n))
    mag = torch.abs(corr[..., i_lo:i_hi])
    return q(20.0 * torch.log10(mag + _EPS ** 0.5))


def _linear(gamma, q):
    return q(10.0 ** ((gamma - torch.amax(gamma, dim=-1, keepdim=True)) / 10.0))


def _widen(lin):
    prev = torch.cat([lin[..., :1], lin[..., :-1]], dim=-1)
    nxt = torch.cat([lin[..., 1:], lin[..., -1:]], dim=-1)
    return lin + prev + nxt


def _lerp(values, pos):
    n = values.shape[-1]
    pos = torch.clamp(pos, 0.0, n - 1.000001)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0
    lo = torch.gather(values, -1, i0)
    hi = torch.gather(values, -1, torch.clamp(i0 + 1, max=n - 1))
    return lo * (1.0 - frac) + hi * frac


def _median(x):
    s, _ = torch.sort(x, dim=-1)
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _comb(lin, floor, pos_f, harmonics):
    n = lin.shape[-1]
    floor = floor[..., None]
    score = torch.zeros_like(pos_f, dtype=lin.dtype)
    count = torch.zeros_like(pos_f, dtype=lin.dtype)
    for k in range(1, harmonics + 1):
        p = k * pos_f
        valid = p < n - 1
        score = score + torch.where(valid, _lerp(lin, p) - floor, torch.zeros_like(score))
        count = count + valid.to(lin.dtype)
    return score / torch.clamp(count, min=1.0)


def _descend(lin, floor, lag, best, lag_lo, harmonics):
    for k in (3, 2):
        sub = lag / k
        sub_score = _comb(lin, floor, sub[..., None], harmonics)[..., 0]
        take = (sub >= lag_lo) & (sub_score >= 0.7 * best)
        lag = torch.where(take, sub, lag)
        best = torch.where(take, sub_score, best)
    return lag


def _refine(lin, lag0, half_window, harmonics=5, step=0.125):
    n = lin.shape[-1]
    lin = _widen(lin)
    offs = np.arange(-half_window / step, half_window / step + 1) * step
    cand = lag0.to(torch.float32)[..., None] + torch.from_numpy(offs.astype(np.float32)).to(
        lin.device)
    score = torch.zeros_like(cand, dtype=lin.dtype)
    wsum = torch.zeros_like(cand, dtype=lin.dtype)
    for k in range(1, harmonics + 1):
        pos = k * cand
        valid = pos < n - 1
        score = score + torch.where(valid, k * _lerp(lin, pos), torch.zeros_like(score))
        wsum = wsum + valid.to(lin.dtype) * float(k)
    best = torch.argmax(score / torch.clamp(wsum, min=1.0), dim=-1, keepdim=True)
    return torch.gather(cand, -1, best)[..., 0]


def _refresh(gamma, fs, rate_min, rate_max, q, harmonics=5):
    n = gamma.shape[-1]
    lin = _linear(gamma, q)
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    lag0 = pos_lo + torch.argmax(lin[..., pos_lo:pos_hi + 1], dim=-1)
    linw = _widen(lin)
    floor = _median(linw[..., pos_lo:pos_hi + 1])
    lag_f = lag0.to(torch.float32)
    best = _comb(linw, floor, lag_f[..., None], harmonics)[..., 0]
    lag_f = _descend(linw, floor, lag_f, best, pos_lo, harmonics)
    lag = _refine(lin, lag_f, max(int(3 * fs / 10000), 8), harmonics)
    return fs / lag


def _line_count(gamma, fs, fv, q, y_min=200, y_max=2500, harmonics=6, rate_min=50.0,
                rate_max=90.0):
    n = gamma.shape[0]
    lin_raw = _linear(gamma, q)
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    lin = _widen(lin_raw)
    cand = torch.arange(lag_lo, lag_hi + 1, device=gamma.device)
    floor = _median(lin[lag_lo:lag_hi + 1])
    scores = _comb(lin, floor, cand.to(torch.float32), harmonics)
    best = torch.argmax(scores)
    lag = cand[best].to(torch.float32)
    lag = _descend(lin, floor, lag, scores[best], lag_lo, harmonics)
    lag = _refine(lin_raw, lag, 3, harmonics)
    return fs / (fv * lag)


def estimate_timing(words: torch.Tensor, fs: float, corr_seconds: float = 0.1,
                    rate_min: float = 50.0, rate_max: float = 90.0, q=exact):
    """(mode name, measured refresh Hz, line count) of interleaved I/Q words:
    the power ``I² + Q²`` of the envelope, its autocorrelation over
    ``corr_seconds`` of lags, the combs, the snap."""
    n = words.shape[0] // 2
    pairs = q(words[: 2 * n].to(torch.float32).view(n, 2))
    sq = q(pairs * pairs)
    power = q(sq[:, 0] + sq[:, 1])
    gamma = _autocorrelation(power, float(fs), 0.0, float(corr_seconds), q)
    fv = _refresh(gamma, float(fs), float(rate_min), float(rate_max), q)
    y_t = _line_count(gamma, float(fs), fv, q, rate_min=float(rate_min), rate_max=float(rate_max))
    fv, y_t = float(fv), float(y_t)
    return find_closest_mode(y_t, fv), fv, y_t
