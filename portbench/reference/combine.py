"""Plain reference of the wideband path: the band scan, the carriers'
discovery, the maximal-ratio fusion, and the chain on the fused envelope.

A restatement in plain PyTorch and NumPy of what ``combined_reconstruct(words,
fs, None)`` of ``tempest_tpu_torch`` computes (``ops/scan.py``: the channel
geometry, the spectrum, the band slices, the comb mass and prominence, the
noise floor, the emissions; ``pipeline/offline.py``: ``discover_screens``, the
tail on the envelope; ``ops/combine.py``: the amplitude rows and the two-pass
fusion), importing nothing of that package.  It takes ``timing``'s estimators
and ``chain`` and ``restore`` from beside it.  ``q`` is the precision every
intermediate is stored in, as in ``chain``.

Where it departs from the program's description, each changing a value by
rounding alone:

* each channel is its own M-point inverse FFT of a gathered band, the band's
  upper half first (the program stacks the K slices, rolls them and runs one
  batched inverse FFT);
* the noise floor takes the same normals the program's does: four
  surrogates of ``(2, M)`` from ``torch.Generator("cpu").manual_seed(7)``,
  which is how the floor is defined, not a sample of it;
* the fusion's first pass forms only what the second reads, each channel's
  comb mass and refresh; the first pass's weights and polarity, which the
  program forms and discards, are not formed;
* the polarity dots and the fused envelope are sums over the rows in a loop
  (the program: matrix-vector products).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import chain, restore, timing
from .chain import exact

__all__ = ["geometry", "scan_centers", "scan", "emissions", "screens", "fuse", "reconstruct"]

HARMONICS = 5
FLOOR_SEED = 7
FLOOR_DRAWS = 4
REFRESH_GROUP_HZ = 0.005


# --------------------------------------------------------------- the scan
def geometry(n_samples: int, fs: float, chan_bw: float) -> tuple[int, int, float]:
    """(N, M, channel rate): the capture's FFT length, a power of two
    rounded down; the channel's, a power of two rounded up from ``chan_bw``."""
    n_fft = 1 << (max(int(n_samples), 2).bit_length() - 1)
    m = 1 << max(int(np.ceil(chan_bw / fs * n_fft)) - 1, 1).bit_length()
    m = min(m, n_fft)
    return n_fft, m, fs * m / n_fft


def scan_centers(fs: float, chan_bw: float) -> np.ndarray:
    """Channel centres every ``chan_bw / 2``, ``chan_bw / 2`` clear of the
    band's edges."""
    step = chan_bw / 2.0
    k = int(np.floor((fs / 2.0 - chan_bw / 2.0) / step))
    return np.arange(-k, k + 1, dtype=np.float64) * step


def _cq(z: torch.Tensor, q) -> torch.Tensor:
    return torch.complex(q(z.real), q(z.imag))


def spectrum(words: torch.Tensor, n_fft: int, q=exact) -> torch.Tensor:
    """The N-point FFT of the first N complex samples of interleaved words."""
    pairs = q(words[: 2 * n_fft].to(torch.float32).view(n_fft, 2))
    return _cq(torch.fft.fft(torch.complex(pairs[:, 0], pairs[:, 1])), q)


def channel(spec: torch.Tensor, fc: float, fs: float, m: int, q=exact) -> torch.Tensor:
    """The complex baseband channel of M samples at carrier ``fc``: the M
    bins around the carrier's rounded bin (negative frequencies wrap to the
    top of the spectrum), the carrier's bin first, and their inverse FFT
    scaled by M/N."""
    n = spec.shape[0]
    first = (int(np.round(float(fc) / fs * n)) - m // 2) % n
    idx = (first + (torch.arange(m, device=spec.device) + m // 2) % m) % n
    return _cq(torch.fft.ifft(spec[idx]) * (m / n), q)


def _autocorr_linear(x: torch.Tensor, fs: float, max_delay: float, q) -> torch.Tensor:
    """|corr|² of rows ``x`` over lags 0 .. ``max_delay``, on the power-of-two
    window the program's autocorrelation takes."""
    i_hi = int(round(max_delay * fs))
    n_x = x.shape[-1]
    n_raw = min(2 * i_hi, n_x)
    n_up = 1 << max(n_raw - 1, 1).bit_length()
    n = n_up if n_up <= n_x else 1 << (max(n_x, 2).bit_length() - 1)
    i_hi = min(i_hi, n // 2)
    spec = _cq(torch.fft.rfft(x[..., :n]), q)
    corr = q(torch.fft.irfft(q(torch.abs(spec) ** 2), n=n))
    return q(corr[..., :i_hi] ** 2)


def _refresh_linear(lin: torch.Tensor, fs: float, rate_min: float, rate_max: float):
    """Each row's refresh from its linear autocorrelation: the band's argmax,
    the sub-harmonic descent and the fractional comb of ``timing``."""
    n = lin.shape[-1]
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    lag0 = pos_lo + torch.argmax(lin[..., pos_lo:pos_hi + 1], dim=-1)
    linw = timing._widen(lin)
    floor = timing._median(linw[..., pos_lo:pos_hi + 1])
    lag_f = lag0.to(torch.float32)
    best = timing._comb(linw, floor, lag_f[..., None], HARMONICS)[..., 0]
    lag_f = timing._descend(linw, floor, lag_f, best, pos_lo, HARMONICS)
    lag = timing._refine(lin, lag_f, max(int(3 * fs / 10000), 8), HARMONICS)
    return fs / lag


def _db(x: torch.Tensor, offset_db: torch.Tensor) -> torch.Tensor:
    return torch.clamp(10.0 * torch.log10(torch.clamp(x, min=0.0)) + offset_db, min=-300.0)


def comb_score(env0: torch.Tensor, fs: float, corr_seconds: float, rate_min: float,
               rate_max: float, q=exact):
    """(comb mass dB, prominence dB, refresh Hz) of mean-removed rows
    ``env0`` (K, n): the rows divided by the power of two nearest their RMS,
    the linear autocorrelation, the refresh, the mean of the box-3 widened
    correlation at the first five multiples of the frame lag less the band's
    median (mass, with the scale's 40·log10 added back), over the band's
    median absolute deviation (prominence)."""
    rms = torch.sqrt(torch.mean(env0 * env0, dim=-1))
    ok = torch.isfinite(rms) & (rms > 0)
    scale = torch.where(ok, torch.exp2(torch.round(torch.log2(torch.where(ok, rms, 1.0)))),
                        torch.ones_like(rms))
    lin = _autocorr_linear(q(env0 / scale[..., None]), fs, corr_seconds, q)
    offset = 40.0 * torch.log10(scale)
    fv = _refresh_linear(lin, fs, rate_min, rate_max)
    n = lin.shape[-1]
    linw = q(timing._widen(lin))
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    band = linw[..., pos_lo:pos_hi + 1]
    med = timing._median(band)
    mad = timing._median(q(torch.abs(band - med[..., None])))
    lag = fs / fv
    mass = torch.zeros_like(fv)
    count = torch.zeros_like(fv)
    for k in range(1, HARMONICS + 1):
        p = k * lag
        valid = p < n - 1
        mass = q(mass + torch.where(valid, timing._lerp(linw, p[..., None])[..., 0],
                                    torch.zeros_like(mass)))
        count = count + valid.to(linw.dtype)
    comb = q(mass / torch.clamp(count, min=1.0))
    mass_db = q(_db(q(comb - med), offset))
    return mass_db, q(mass_db - _db(mad, offset)), fv


def noise_floor(fs_chan: float, m: int, corr_seconds: float, rate_min: float, rate_max: float,
                device, q=exact) -> float:
    """The largest prominence of the comb score over the four white-noise
    surrogates |CN(0, 1)|² of M samples drawn from the fixed CPU generator."""
    gen = torch.Generator(device="cpu").manual_seed(FLOOR_SEED)
    z = torch.randn((FLOOR_DRAWS, 2, int(m)), generator=gen, dtype=torch.float32).to(device)
    env = q(q(z[:, 0] ** 2) + q(z[:, 1] ** 2))
    del z
    _, prom, _ = comb_score(q(env - torch.mean(env, dim=-1, keepdim=True)), fs_chan,
                            corr_seconds, rate_min, rate_max, q)
    return float(torch.max(prom))


def scan(words: torch.Tensor, fs: float, chan_bw: float, corr_seconds: float,
         rate_min: float = 50.0, rate_max: float = 90.0, q=exact) -> dict:
    """The band scan of interleaved words: each channel's power row |z|²,
    scored, and the sweep's noise floor."""
    n_fft, m, fs_chan = geometry(words.shape[0] // 2, fs, chan_bw)
    centers = scan_centers(fs, chan_bw)
    spec = spectrum(words, n_fft, q)
    rows = []
    for fc in centers:
        z = channel(spec, fc, fs, m, q)
        rows.append(q(q(z.real ** 2) + q(z.imag ** 2)))
    del spec
    rows = torch.stack(rows)
    env0 = q(rows - torch.mean(rows, dim=-1, keepdim=True))
    del rows
    mass, prom, fv = comb_score(env0, fs_chan, corr_seconds, rate_min, rate_max, q)
    del env0
    return {"centers_hz": centers, "fs_channel": fs_chan,
            "mass_db": mass.cpu().numpy().astype(np.float64),
            "prominence_db": prom.cpu().numpy().astype(np.float64),
            "refresh_hz": fv.cpu().numpy().astype(np.float64),
            "floor_db": noise_floor(fs_chan, m, corr_seconds, rate_min, rate_max,
                                    words.device, q)}


def emissions(sweep: dict, min_margin_db: float) -> list[dict]:
    """Runs of neighbouring channels whose prominence clears the floor by the
    margin, each an emission: its best channel (the largest mass), that
    channel's refresh and mass; strongest first."""
    order = np.argsort(sweep["centers_hz"])
    c = sweep["centers_hz"][order]
    mass = sweep["mass_db"][order]
    fv = sweep["refresh_hz"][order]
    hot = sweep["prominence_db"][order] >= sweep["floor_db"] + min_margin_db
    runs: list[list[int]] = []
    for i in np.flatnonzero(hot):
        if runs and runs[-1][-1] == i - 1:
            runs[-1].append(int(i))
        else:
            runs.append([int(i)])
    out = []
    for g in runs:
        peak = g[int(np.argmax(mass[g]))]
        out.append({"best_channel_hz": float(c[peak]), "refresh_hz": float(fv[peak]),
                    "score_db": float(mass[peak])})
    out.sort(key=lambda e: -e["score_db"])
    return out


def screens(ems: list[dict], refresh_group_hz: float = REFRESH_GROUP_HZ) -> list[list[dict]]:
    """Emissions grouped by refresh: one joins the first screen whose first
    emission's refresh lies within ``refresh_group_hz`` of its own."""
    out: list[list[dict]] = []
    for e in ems:
        for s in out:
            if abs(e["refresh_hz"] - s[0]["refresh_hz"]) < refresh_group_hz:
                s.append(e)
                break
        else:
            out.append([e])
    return out


# ------------------------------------------------------------- the fusion
def _comb_dots(env0: torch.Tensor, spf: float, half: int, q) -> torch.Tensor:
    """Each row's mean lag product at the first five multiples of the frame
    period (shifted by half a period with ``half=1``), the largest over the
    lag and its two neighbours, averaged over the multiples that fit."""
    m = env0.shape[1]
    acc = torch.zeros(env0.shape[0], dtype=env0.dtype, device=env0.device)
    cnt = 0
    for k in range(1, HARMONICS + 1):
        lag0 = int(round(k * spf + half * spf / 2.0))
        if lag0 + 1 >= m:
            break
        vals = [q(torch.mean(q(env0[:, : m - lag] * env0[:, lag:]), dim=1))
                for lag in (lag0 - 1, lag0, lag0 + 1) if 0 < lag < m]
        acc = q(acc + torch.amax(torch.stack(vals), dim=0))
        cnt += 1
    return q(acc / max(cnt, 1))


def fuse(amp: torch.Tensor, fs_chan: float, corr_seconds: float, rate_min: float = 50.0,
         rate_max: float = 90.0, q=exact):
    """The two-pass fusion of amplitude rows ``amp`` (K, M): pass 1 scores
    each row (comb mass, refresh); pass 2 reads the frame-periodic power at
    the strongest row's refresh, quantised to a whole frame period, against
    the same dots half a period off, gates, weighs √s/N, takes each row's
    polarity against the strongest row of pass 2, re-bases it on the first
    weighted row, and sums.  Returns (envelope, weights, polarity, pass 1's
    mass dB, pass 1's refresh)."""
    mean = torch.mean(amp, dim=1, keepdim=True)
    env0 = q(amp - mean)
    var = q(torch.mean(q(env0 * env0), dim=1))
    mass1, _, fv1 = comb_score(env0, fs_chan, corr_seconds, rate_min, rate_max, q)
    fv_anchor = float(fv1[torch.argmax(mass1)])
    spf = fs_chan / (fs_chan / round(fs_chan / fv_anchor))
    comb = _comb_dots(env0, spf, 0, q)
    off = _comb_dots(env0, spf, 1, q)
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
    env = torch.zeros_like(env0[0])
    for k in range(env0.shape[0]):
        env = q(env + q(float(w[k] * pol[k]) * env0[k]))
    env = q(env + torch.sum(w * mean[:, 0]))
    return env, w, pol, mass1, fv1


# -------------------------------------------------------------- the chain
def envelope_timing(env: torch.Tensor, fs: float, corr_seconds: float, rate_min: float = 50.0,
                    rate_max: float = 90.0, q=exact):
    """(mode name, refresh, line count) of a demodulated envelope."""
    gamma = timing._autocorrelation(env, fs, 0.0, corr_seconds, q)
    fv = timing._refresh(gamma, fs, rate_min, rate_max, q)
    y_t = timing._line_count(gamma, fs, fv, q, rate_min=rate_min, rate_max=rate_max)
    fv, y_t = float(fv), float(y_t)
    return timing.find_closest_mode(y_t, fv), fv, y_t


def reconstruct(words: torch.Tensor, fs: float, chan_bw: float, corr_seconds: float,
                min_margin_db: float, alpha: float, render_size, q=exact) -> dict:
    """``combined_reconstruct(words, fs, None)``: the scan, the first screen's
    carriers (strongest first), the fusion, the timing of the fused envelope,
    the chain over every whole frame period from phase 0, the restoration."""
    sweep = scan(words, fs, chan_bw, corr_seconds, q=q)
    found = screens(emissions(sweep, min_margin_db))
    if not found:
        raise ValueError("the reference finds no emission in the band")
    centers = np.array([e["best_channel_hz"] for e in found[0]], np.float64)
    n_fft, m, fs_chan = geometry(words.shape[0] // 2, fs, chan_bw)
    spec = spectrum(words, n_fft, q)
    amp = torch.stack([q(torch.abs(channel(spec, fc, fs, m, q))) for fc in centers])
    del spec
    env, w, pol, mass, fv_ch = fuse(amp, fs_chan, corr_seconds, q=q)
    del amp
    name, fv, _ = envelope_timing(env, fs_chan, corr_seconds, q=q)
    w_t, h_t, _ = timing.MODES[name]
    spf = fs_chan / fv
    n_frames = max(int((env.shape[0] - 1) / spf), 1)
    taps = 4 if spf / (w_t * h_t) >= 1.0 else 2
    n_block = int(np.ceil(spf * n_frames)) + 1
    g = chain.geometry(int(np.floor(spf)), h_t, w_t, tuple(render_size))
    ema0 = torch.zeros(tuple(render_size), dtype=torch.float32, device=env.device)
    ema, frames, sync, _ = chain.chain(env[:n_block], chain.static_starts(spf, n_frames), None,
                                       g, ema0, float(alpha), taps, q)
    image = restore.restore_image(ema, fs_chan, fv, h_t, taps, q=q)
    return {"sweep": sweep, "centers_hz": centers, "weights": w, "polarity": pol,
            "mass_db": mass, "channel_refresh_hz": fv_ch, "envelope": env, "mode": name,
            "refresh_hz": fv, "raw": ema, "image": image, "frames": frames, "sync": sync}
