"""FFT autocorrelation and screen-timing estimators (refresh rate, line
count) in PyTorch — the counterpart of ``tempest_tpu/ops/autocorr.py``.

Same conventions as the JAX package:

* The envelope is real, so the correlation is ``irfft(|rfft(x)|²)``.
* Lag index 0 of the returned array corresponds to lag
  ``round(min_delay * fs)`` samples.
* Peak positions are refined by an interpolated harmonic comb on a 1/8-sample
  grid, giving sub-sample lag (hence sub-Hz refresh and sub-line count)
  resolution — one lag at 20 Msps is 0.36 lines at 1080p60.
* FFT lengths stay the JAX package's powers of two.  The card's FFT does not
  need that, but both packages then estimate from the same window.
* Everything is float32 on the input's device; the estimators return 0-d
  tensors.
* ``autocorrelation``, ``estimate_refresh`` and the helpers under them work
  along the last axis, so a (K, n) stack of envelopes is estimated in one
  pass (the carrier scan scores its K channels so); a 1-D input gives the
  same values as before.

Three places differ from a literal translation.  The log-scale correlation
is taken as ``20·log10|corr|`` and the estimators exponentiate it relative to
its peak, where the JAX version squares the correlation first: for raw int16
words (|word| up to 2¹⁵) over a million samples ``corr²`` passes the float32
range, its ``gamma`` turns infinite and its estimates meaningless.  The values
are the same wherever the JAX version stays finite, and every estimator is
invariant to the scale of its input.  ``_lerp`` clamps the upper
read index: the JAX version's position clip ``n - 1.000001`` is a no-op in
float32 once ``n`` is in the millions, and its out-of-range gather is clamped
silently, where PyTorch raises on the CPU and trips a device assert on the
card.  ``_median`` averages the two middle values as ``jnp.median`` does
(``torch.median`` returns the lower one).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "autocorrelation",
    "zoom_autocorr",
    "parabolic_peak",
    "refine_period",
    "estimate_refresh",
    "estimate_line_count",
    "estimate_snr",
    "suggest_alpha",
    "top_line_period_peaks",
]

_EPS = 1e-30   # floor under the squared correlation (-300 dB)


def autocorrelation(
    x: torch.Tensor,
    fs: float,
    min_delay: float,
    max_delay: float,
    scale: str = "log",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Circular autocorrelation magnitude over lags in ``[min_delay, max_delay)``
    seconds, along the last axis of ``x``.

    Returns ``(gamma, lags)`` where ``gamma[k]`` is ``10*log10(|corr|^2)`` (or
    ``|corr|^2`` for ``scale="linear"``) at lag ``lags[k]`` seconds, starting
    at lag index ``round(min_delay * fs)``.

    FFT length: ``min(2 * round(max_delay*fs), len(x))`` rounded to a power
    of two — up where the signal is long enough, else down.
    """
    i_lo = int(round(min_delay * fs))
    i_hi = int(round(max_delay * fs))  # exclusive lag bound
    n_x = x.shape[-1]
    n_raw = min(2 * i_hi, n_x)
    # Prefer the next power of two ABOVE n_raw (more signal, keeps ≥50%
    # circular overlap at the longest lags); fall back to the largest power
    # of two the signal can supply.
    n_up = 1 << max(n_raw - 1, 1).bit_length()
    n = n_up if n_up <= n_x else 1 << (max(n_x, 2).bit_length() - 1)
    # Lags past n/2 of a CIRCULAR autocorrelation are mirrors of low lags
    # (corr[k] == corr[n-k]), not measurements: when a short signal forces
    # n below 2·i_hi, returning them would feed mirrored near-zero-lag
    # energy to the comb estimators as fake long-lag peaks.
    i_hi = min(i_hi, n // 2)
    xw = x[..., :n]
    if xw.is_complex():
        spec = torch.fft.fft(xw)
        corr = torch.fft.ifft(spec * torch.conj(spec))
    else:
        spec = torch.fft.rfft(xw.to(torch.float32))
        corr = torch.fft.irfft(torch.abs(spec) ** 2, n=n)
    mag = torch.abs(corr[..., i_lo:i_hi])
    lags = torch.arange(i_lo, i_hi, device=x.device) / fs
    if scale == "log":
        # 10·log10(corr² + eps) without forming corr², which can overflow.
        return 20.0 * torch.log10(mag + _EPS ** 0.5), lags
    return mag ** 2, lags


def zoom_autocorr(
    gamma: torch.Tensor, fs: float, rate_min: float = 20.0, rate_max: float = 100.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-window an autocorrelation (lag k ↔ k/fs, i.e. ``min_delay=0``) to
    the band of repetition rates ``[rate_min, rate_max]`` Hz.

    Returns ``(rates, gamma_slice)`` with ``rates`` descending from near
    ``rate_max`` to ``rate_min``.
    """
    n = gamma.shape[0]
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    pos = torch.arange(pos_lo, pos_hi + 1, device=gamma.device)
    return fs / pos, gamma[pos_lo : pos_hi + 1]


def parabolic_peak(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sub-sample peak location: fit a parabola through ``y[idx-1:idx+2]`` and
    return the refined fractional index.  Falls back to ``idx`` at the array
    edges or for a degenerate (flat) vertex."""
    n = y.shape[0]
    idx = torch.as_tensor(idx, device=y.device)
    i = torch.clamp(idx, 1, n - 2)
    ym1, y0, yp1 = y[i - 1], y[i], y[i + 1]
    denom = ym1 - 2.0 * y0 + yp1
    safe = torch.where(torch.abs(denom) > 1e-12, denom, torch.ones_like(denom))
    delta = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / safe,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    refined = i + delta
    return torch.where((idx >= 1) & (idx <= n - 2), refined, idx.to(refined.dtype))


def _lerp(values: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along the last axis at fractional positions:
    ``values`` (..., n) read at ``pos`` (..., P), leading axes shared."""
    n = values.shape[-1]
    pos = torch.clamp(pos, 0.0, n - 1.000001)
    i0 = torch.floor(pos).to(torch.int64)
    frac = pos - i0
    # In float32 the clip above does not keep i0 + 1 below n for large n.
    lo = torch.gather(values, -1, i0)
    hi = torch.gather(values, -1, torch.clamp(i0 + 1, max=n - 1))
    return lo * (1.0 - frac) + hi * frac


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis that averages the two middle values of an
    even count."""
    s, _ = torch.sort(x, dim=-1)
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def _linear_power(gamma: torch.Tensor, scale: str) -> torch.Tensor:
    """The correlation in linear power for the combs: a log-scale ``gamma``
    exponentiated relative to its peak, so that it stays in float32 range
    whatever the input's scale (the combs compare ratios and argmaxes)."""
    if scale != "log":
        return gamma
    return 10.0 ** ((gamma - torch.amax(gamma, dim=-1, keepdim=True)) / 10.0)


def _widen_peaks(lin: torch.Tensor) -> torch.Tensor:
    """Box-3 energy accumulation over the linear correlation.

    The envelope's correlation peaks are effectively sub-sample deltas whose
    mass splits between two bins when the true lag is fractional; summing
    each bin with its two neighbours makes any read within ±1 sample of the
    true lag return the peak's full mass.  The edges replicate and do NOT
    wrap: a circular roll would fold the zero-lag peak into the last lag."""
    prev = torch.cat([lin[..., :1], lin[..., :-1]], dim=-1)
    nxt = torch.cat([lin[..., 1:], lin[..., -1:]], dim=-1)
    return lin + prev + nxt


def _comb_prominence(
    lin: torch.Tensor, floor: torch.Tensor, pos_f: torch.Tensor, harmonics: int
) -> torch.Tensor:
    """Mean floor-subtracted correlation over the first ``harmonics``
    multiples of each candidate period that lie inside the window:
    ``lin`` (..., n), ``floor`` (...), ``pos_f`` (..., P)."""
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


def _descend_subharmonics(
    lin: torch.Tensor, floor: torch.Tensor, lag: torch.Tensor, best_score: torch.Tensor,
    lag_lo: int, harmonics: int,
) -> torch.Tensor:
    """Every multiple of a repetition period is one too, so a comb can lock
    at 2 or 3 periods.  Descend to ``lag / k`` when its comb scores at least
    0.7 of the best prominence: then its multiples are all real peaks."""
    for k in (3, 2):
        sub = lag / k
        sub_score = _comb_prominence(lin, floor, sub[..., None], harmonics)[..., 0]
        take = (sub >= lag_lo) & (sub_score >= 0.7 * best_score)
        lag = torch.where(take, sub, lag)
        best_score = torch.where(take, sub_score, best_score)
    return lag


def refine_period(
    lin: torch.Tensor,
    lag0: torch.Tensor,
    half_window: int,
    harmonics: int = 5,
    step: float = 0.125,
) -> torch.Tensor:
    """Fractional-period refinement by an interpolated harmonic comb.

    Scores every candidate period on a ``step``-sample grid around ``lag0``
    by the k-weighted mean of the linearly-interpolated (box-3 widened)
    correlation at its first ``harmonics`` multiples: only the true period
    keeps all its harmonics on peak tops at once.  Returns the refined
    fractional lag."""
    n = lin.shape[-1]
    lin = _widen_peaks(lin)
    offs = np.arange(-half_window / step, half_window / step + 1) * step
    cand = (lag0.to(torch.float32)[..., None]
            + torch.from_numpy(offs.astype(np.float32)).to(lin.device))
    score = torch.zeros_like(cand, dtype=lin.dtype)
    wsum = torch.zeros_like(cand, dtype=lin.dtype)
    for k in range(1, harmonics + 1):
        pos = k * cand
        valid = pos < n - 1
        score = score + torch.where(valid, k * _lerp(lin, pos), torch.zeros_like(score))
        wsum = wsum + valid.to(lin.dtype) * float(k)
    best = torch.argmax(score / torch.clamp(wsum, min=1.0), dim=-1, keepdim=True)
    return torch.gather(cand, -1, best)[..., 0]


def estimate_refresh(
    gamma: torch.Tensor,
    fs: float,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    harmonics: int = 5,
    scale: str = "log",
) -> torch.Tensor:
    """Refresh rate fv [Hz] from the autocorrelation: the coarse argmax over
    the band's lags, a prominence-based octave descent (rejects locks at 2 or
    3 frame periods), then ``refine_period``'s fractional comb, which keeps
    the estimate off the ``±`` one-line-period side peaks.  Pass the same
    ``gamma`` the display path uses (log scale by default); the comb works
    on linear power."""
    n = gamma.shape[-1]
    lin = _linear_power(gamma, scale)
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    lag0 = pos_lo + torch.argmax(lin[..., pos_lo : pos_hi + 1], dim=-1)
    linw = _widen_peaks(lin)
    floor = _median(linw[..., pos_lo : pos_hi + 1])
    lag_f = lag0.to(torch.float32)
    best_score = _comb_prominence(linw, floor, lag_f[..., None], harmonics)[..., 0]
    lag_f = _descend_subharmonics(linw, floor, lag_f, best_score, pos_lo, harmonics)
    # Comb window: generously covers ±3 line periods for any plausible mode
    # (L ≤ fs / (50 Hz · 200 lines)).
    half = max(int(3 * fs / 10000), 8)
    lag = refine_period(lin, lag_f, half, harmonics)
    return fs / lag


def estimate_snr(env: torch.Tensor) -> torch.Tensor:
    """Envelope-domain SNR proxy [dB] via one-lag decorrelation: receiver
    noise is white while screen content is strongly correlated sample to
    sample, so with the mean removed ``SNR ≈ c1 / (c0 − c1)`` where ``c_k``
    is the lag-k autocovariance."""
    env0 = env - torch.mean(env)
    c0 = torch.mean(env0 * env0)
    c1 = torch.mean(env0[:-1] * env0[1:])
    ratio = torch.clamp(c1, min=1e-12) / torch.clamp(c0 - c1, min=1e-12)
    return 10.0 * torch.log10(ratio)


def suggest_alpha(snr_db: torch.Tensor | float) -> torch.Tensor:
    """EMA coefficient from the envelope-domain SNR proxy: noisy signals
    average harder (alpha→0.9), clean signals stay responsive (alpha→0.1).
    The ramp spans proxy +2 dB (clean) → −15 dB (very noisy)."""
    t = torch.clamp((2.0 - torch.as_tensor(snr_db, dtype=torch.float32)) / 17.0, 0.0, 1.0)
    return 0.1 + 0.8 * t


def top_line_period_peaks(
    gamma: np.ndarray,
    fs: float,
    fv: float,
    k: int = 5,
    y_min: int = 200,
    y_max: int = 2500,
    harmonics: int = 6,
    scale: str = "log",
    rate_min: float = 50.0,
    rate_max: float = 90.0,
) -> np.ndarray:
    """Ranked line-period candidates — the operator override for when the
    automatic lock lands on the wrong peak: every local maximum of the
    prominence-comb score ``estimate_line_count`` maximises, refined to
    fractional lag, deduplicated, ordered by score.

    Host-side numpy in float64 (an evidence surface, not a hot path).
    Returns an (m, 3) float array of rows ``(lag_samples, y_t, score)``,
    ``m ≤ k``, best first."""
    g = np.asarray(gamma, np.float64)
    n = g.shape[0]
    lin_raw = 10.0 ** (g / 10.0) if scale == "log" else g
    # Box-3 widen without wrapping (see _widen_peaks).
    lin = (lin_raw
           + np.concatenate([lin_raw[:1], lin_raw[:-1]])
           + np.concatenate([lin_raw[1:], lin_raw[-1:]]))
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    floor = np.median(lin[lag_lo : lag_hi + 1])
    cand = np.arange(lag_lo, lag_hi + 1, dtype=np.float64)
    xs = np.arange(n, dtype=np.float64)

    def comb(pos: np.ndarray) -> np.ndarray:
        score = np.zeros_like(pos)
        count = np.zeros_like(pos)
        for h in range(1, harmonics + 1):
            p = h * pos
            valid = p < n - 1
            score += np.where(valid, np.interp(p, xs, lin) - floor, 0.0)
            count += valid
        return score / np.maximum(count, 1.0)

    scores = comb(cand)
    # Local maxima of the comb score, ranked.
    locmax = np.r_[False, (scores[1:-1] > scores[:-2])
                   & (scores[1:-1] >= scores[2:]), False]
    order = np.argsort(scores[locmax])[::-1]
    lags = cand[locmax][order]
    peak_scores = scores[locmax][order]

    picked: list[tuple[float, float, float]] = []
    for lag, sc in zip(lags, peak_scores):
        # Fractional refinement (numpy mirror of refine_period, k-weighted).
        offs = np.arange(-3 / 0.125, 3 / 0.125 + 1) * 0.125
        fine = lag + offs
        fs_score = np.zeros_like(fine)
        wsum = np.zeros_like(fine)
        for h in range(1, harmonics + 1):
            p = h * fine
            valid = p < n - 1
            fs_score += np.where(valid, h * np.interp(p, xs, lin), 0.0)
            wsum += np.where(valid, float(h), 0.0)
        lag_f = float(fine[np.argmax(fs_score / np.maximum(wsum, 1.0))])
        y_t = fs / (fv * lag_f)
        if any(abs(y_t - y) < 2.0 for _, y, _ in picked):
            continue  # refines into an already-listed candidate
        picked.append((lag_f, y_t, float(sc)))
        if len(picked) == k:
            break
    return np.array(picked, np.float64).reshape(-1, 3)


def estimate_line_count(
    gamma: torch.Tensor,
    fs: float,
    fv: torch.Tensor | float,
    y_min: int = 200,
    y_max: int = 2500,
    harmonics: int = 6,
    scale: str = "log",
    rate_min: float = 50.0,
    rate_max: float = 90.0,
) -> torch.Tensor:
    """Total line count y_t: the autocorrelation peaks at the *line* period
    ``L = fs / (fv * y_t)``; find L and return ``fs / (fv * L)``.

    A harmonic comb over the integer candidate lags, by prominence over the
    window's median; a subharmonic descent (a comb can lock an octave low
    when aliasing weakens the fundamental); then the fractional refinement."""
    n = gamma.shape[0]
    lin_raw = _linear_power(gamma, scale)
    lag_lo = max(int(fs / (rate_max * y_max)) - 2, 2)
    lag_hi = min(int(fs / (rate_min * y_min)) + 2, n - 1)
    lin = _widen_peaks(lin_raw)
    cand = torch.arange(lag_lo, lag_hi + 1, device=gamma.device)
    floor = _median(lin[lag_lo : lag_hi + 1])
    scores = _comb_prominence(lin, floor, cand.to(torch.float32), harmonics)
    best = torch.argmax(scores)
    lag = cand[best].to(torch.float32)
    lag = _descend_subharmonics(lin, floor, lag, scores[best], lag_lo, harmonics)
    # Fractional refinement around the chosen period — on the *un-widened*
    # correlation: refine_period applies the box-3 read itself.
    lag = refine_period(lin_raw, lag, 3, harmonics)
    return fs / (fv * lag)
