"""Carrier-frequency scan in PyTorch — the counterpart of
``tempest_tpu/ops/scan.py``: find the emissions of screens across a wideband
capture.

One pass channelises the capture into K candidate basebands
(frequency-domain slicing: one big FFT, K circular band slices, one batched
inverse FFT) and scores every channel's "screen-ness" by the refresh-band
autocorrelation comb the timing estimator relies on.  The K channels are a
batch axis from the inverse FFT to the scores: the autocorrelation is one
batched FFT pair over (K, M) and the comb estimators of ``ops.autocorr``
run along the last axis, so no channel is looped on the host.

Scoring: a display emission's envelope autocorrelates at every multiple of
the frame period.  ``prominence`` (comb mass over the band's MAD, scale
free) says whether a channel holds a screen; ``mass`` (absolute) says how
much of the emission the channel caught, which localises the carrier.

Two places differ from a literal translation of the JAX module:

* **The noise floor's draws.**  ``_noise_floor`` scores white-noise
  surrogates through the same estimator.  The JAX version draws them from
  its own counter-based generator; this one draws them from a
  ``torch.Generator`` seeded with 7 on the CPU and moves the values to the
  device, so the floor is the same number on the card and on the CPU.  It is
  a different sample of the same null (a maximum over four draws), so the
  two packages' floors agree loosely, not to the digit; ``draws=`` takes the
  surrogate normals as a tensor for a comparison on shared draws.
* **Float32 range.**  The linear autocorrelation is a squared correlation of
  a mean-removed power envelope: for raw int16-scale words it passes the
  float32 range (the JAX version's scores turn infinite).  Here the
  mean-removed envelope is scaled by a power of two to unit RMS before the
  correlation (exact in float32, so the estimators see the same mantissas)
  and the scale comes back as a dB offset on the absolute quantities.  The
  values are the JAX version's wherever that stays finite.

The live counterpart, for hardware sources, is
``tempest_tpu_torch.runtime.stream.StreamingRuntime.scan``: it retunes across
dwell frequencies and scores each dwell with ``carrier_score``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils.device import as_tensor, staged_upload
from ..utils.profiling import annotate, count
from .autocorr import _lerp, _median, _widen_peaks, autocorrelation, estimate_refresh
from .demod import am_power_from_iq, fm_demod_rows

__all__ = ["ScanResult", "carrier_score", "channelize", "check_excise_demod",
           "scan_band", "scan_centers"]


@dataclasses.dataclass(frozen=True)
class ScanResult:
    """Ranked carrier candidates from a band scan.

    ``scores_db`` is the absolute structured comb mass — it scales with how
    much of the emission the channel captured, so it localises the carrier.
    ``prominence_db`` is the scale-free comb-over-MAD ratio — noise has a
    selection floor of several dB at any gain (the comb estimator picks the
    best of thousands of candidate periods even in noise), emissions
    measure well above it; it is the detection confidence."""

    centers_hz: np.ndarray      # candidate channel centers (input order)
    scores_db: np.ndarray       # structured comb mass per channel (ranking)
    prominence_db: np.ndarray   # comb/floor screen-ness per channel
    refresh_hz: np.ndarray      # detected refresh-band peak per channel
    fs_channel: float           # sample rate of each extracted channel
    # Measured noise selection floor [dB] for this sweep's window geometry:
    # the identical estimator run on white-noise surrogate envelopes of the
    # same length/window (see _noise_floor), one value broadcast per channel.
    # Detection thresholds on prominence - floor, so the criterion tracks
    # the window geometry automatically instead of hardcoding a constant.
    floor_db: np.ndarray | None = None

    def ranking(self) -> np.ndarray:
        """Channel indices, best first."""
        return np.argsort(-self.scores_db)

    def best(self) -> tuple[float, float, float]:
        """(center_hz, score_db, refresh_hz) of the top channel."""
        i = int(self.ranking()[0])
        return (float(self.centers_hz[i]), float(self.scores_db[i]),
                float(self.refresh_hz[i]))

    def emissions(self, min_margin_db: float = 5.0,
                  min_prominence_db: float | None = None):
        """Group detected channels into distinct emissions.

        A wide emission lights up EVERY overlapping channel (prominence is
        scale-free), so the channel list alone over-counts: this merges
        contiguous above-threshold channels into one emission each and
        reports, per emission, the mass-weighted centroid frequency, the
        span of detecting channels, the best channel's center and its
        refresh estimate.  Returns a list of dicts ordered by peak mass,
        e.g. two monitors in one capture → two entries.

        Detection: ``prominence >= floor + min_margin_db``, where ``floor``
        is the sweep's MEASURED noise selection floor (the identical
        estimator on white-noise surrogates at this window geometry, see
        ``_noise_floor``).  For noise channels, prominence sits within a
        couple dB of the floor (draws of the same selection max); an
        emission clears it by a wide margin — so the criterion holds at ANY
        window length, where a fixed threshold splits only one geometry.

        ``min_prominence_db``: legacy absolute override (used instead of
        the margin test when given, and as the fallback when the result
        carries no floors)."""
        order = np.argsort(self.centers_hz)
        c = self.centers_hz[order]
        prom = self.prominence_db[order]
        mass = self.scores_db[order]
        fv = self.refresh_hz[order]
        if min_prominence_db is not None or self.floor_db is None:
            thr = min_prominence_db if min_prominence_db is not None else 14.0
            hot = prom >= thr
            floor = np.full_like(prom, np.nan)
        else:
            floor = self.floor_db[order]
            hot = prom >= floor + min_margin_db
        groups: list[list[int]] = []
        for i, h in enumerate(hot):
            if not h:
                continue
            if groups and groups[-1][-1] == i - 1:
                groups[-1].append(i)
            else:
                groups.append([i])
        out = []
        for g in groups:
            w = 10.0 ** (mass[g] / 10.0)     # linear structured mass
            peak = g[int(np.argmax(mass[g]))]
            out.append({
                "center_hz": float(np.sum(c[g] * w) / np.sum(w)),
                "span_hz": (float(c[g[0]]), float(c[g[-1]])),
                "best_channel_hz": float(c[peak]),
                "refresh_hz": float(fv[peak]),
                "score_db": float(mass[peak]),
                "prominence_db": float(prom[peak]),
                "floor_db": float(floor[peak]),
                "n_channels": len(g),
            })
        out.sort(key=lambda e: -e["score_db"])
        return out


NOISE_FLOOR_SEED = 7


def noise_floor_draws(n_env: int, draws: int = 4) -> torch.Tensor:
    """The standard normals behind the noise floor's surrogates, float32
    (draws, 2, n_env) on the CPU, from a generator with a fixed seed: the
    same values whatever device scores them."""
    gen = torch.Generator(device="cpu").manual_seed(NOISE_FLOOR_SEED)
    return torch.randn((int(draws), 2, int(n_env)), generator=gen, dtype=torch.float32)


def _noise_floor(fs, n_env: int, corr_seconds, rate_min, rate_max,
                 harmonics: int = 5, draws: int | torch.Tensor = 4,
                 demod: str = "am",
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Measured noise selection floor [dB] for ONE window geometry.

    The comb estimator maximises over thousands of candidate periods, so
    even pure noise scores a positive prominence — and that selection floor
    depends on the window geometry (number of candidate lags, harmonics in
    range).  Rather than modelling the order statistic of a multi-stage
    estimator, this MEASURES it: run the identical scoring on white-noise
    surrogate envelopes (|CN(0,1)|², the exact null of an empty channel; for
    ``demod="fm"`` the discriminator of complex white noise) of the same
    length and window, and take the worst (max) draw.  Detection then
    thresholds ``prominence >= floor + margin``, which tracks window length
    by construction.

    Deterministic and channel-independent: ONE floor per sweep geometry.
    ``draws`` is the number of surrogates (drawn by
    :func:`noise_floor_draws`), or the normals themselves as a
    (draws, 2, n_env) tensor.

    Drawn from a fixed seed, the floor is a function of its arguments: a
    count of draws is measured once per geometry and device in a process
    (:func:`_measured_floor`) and returned as a new host tensor after that,
    so a sweep repeated on one geometry no longer draws and uploads the
    8·n_env normals again."""
    if not isinstance(draws, torch.Tensor):
        dev = torch.device(device if device is not None else "cpu")
        return torch.tensor(_measured_floor(float(fs), int(n_env), float(corr_seconds),
                                            float(rate_min), float(rate_max), int(harmonics),
                                            int(draws), str(demod), dev))
    return _floor_of_draws(draws, fs, corr_seconds, rate_min, rate_max, harmonics, demod, device)


@functools.lru_cache(maxsize=16)
def _measured_floor(fs: float, n_env: int, corr_seconds: float, rate_min: float,
                    rate_max: float, harmonics: int, draws: int, demod: str,
                    device: torch.device) -> float:
    """:func:`_noise_floor` of ``draws`` surrogates from
    :func:`noise_floor_draws`, measured on the first call of each geometry
    and device; ``_measured_floor.cache_clear()`` forgets them."""
    z = noise_floor_draws(n_env, draws)
    count("scan.floor.draws", z.numel())
    return float(_floor_of_draws(z, fs, corr_seconds, rate_min, rate_max, harmonics, demod,
                                 device))


def _floor_of_draws(draws: torch.Tensor, fs, corr_seconds, rate_min, rate_max, harmonics,
                    demod, device) -> torch.Tensor:
    """The largest prominence of the surrogates made of ``draws``
    (draws, 2, n_env), scored on ``device`` (``None``: where they lie)."""
    z = as_tensor(draws.to(torch.float32), device if device is not None else draws.device)
    if demod == "fm":
        env = fm_demod_rows(torch.complex(z[:, 0, :], z[:, 1, :]))
    else:
        env = z[:, 0, :] ** 2 + z[:, 1, :] ** 2
    _, prom, _ = _comb_contrast(env, fs, corr_seconds, rate_min, rate_max, harmonics)
    return torch.max(prom)


def _unit_scale(env0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``env0`` (..., n) divided by the power of two nearest its RMS, and
    that divisor (...): an exact rescaling that keeps the squared
    correlation of large words inside the float32 range."""
    rms = torch.sqrt(torch.mean(env0 * env0, dim=-1))
    ok = torch.isfinite(rms) & (rms > 0)
    scale = torch.where(ok, torch.exp2(torch.round(torch.log2(torch.where(ok, rms, 1.0)))),
                        torch.ones_like(rms))
    return env0 / scale[..., None], scale


def _comb_score(env0, fs, corr_seconds, rate_min, rate_max, harmonics: int = 5):
    """``_selection_prominence`` of the linear autocorrelation of
    mean-removed rows ``env0`` (..., n), with the rows brought to unit scale
    first and the scale added back in dB (the linear autocorrelation goes
    with the fourth power of the envelope's scale)."""
    scaled, scale = _unit_scale(env0)
    lin, _ = autocorrelation(scaled, fs, 0.0, corr_seconds, scale="linear")
    return _selection_prominence(lin, fs, rate_min, rate_max, harmonics,
                                 offset_db=40.0 * torch.log10(scale))


def _comb_contrast(env, fs, corr_seconds, rate_min, rate_max,
                   harmonics: int = 5):
    """Harmonic-comb mass, prominence [dB] and refined refresh of envelopes
    (..., n), along the last axis.

    Two design points of the JAX version, kept:

    * The mean MUST come off the envelope first: a channel that captures
      the emission's full band carries the envelope's large DC term, whose
      autocorrelation pedestal flattens the band in dB and erases the comb.
    * A bare max−median of the band is NOT a discriminator: over tens of
      thousands of lags the extreme value of a noise autocorrelation sits
      well over its median by order statistics alone.  A screen emission is
      the only signal whose correlation mass repeats at k·P for all k
      simultaneously, so the score is the k-averaged comb mass at the
      detected period over the band's fluctuation scale (MAD).  The floor
      depends on the window geometry; :func:`_noise_floor` measures it so
      that detection can threshold on the margin over it.
    """
    env0 = env - torch.mean(env, dim=-1, keepdim=True)
    return _comb_score(env0, fs, corr_seconds, rate_min, rate_max, harmonics)


def _db(x: torch.Tensor, offset_db: torch.Tensor | None) -> torch.Tensor:
    """``10·log10(max(x·10^(offset/10), 1e-30))`` without forming the
    product: the −300 dB floor acts on the unscaled quantity."""
    d = 10.0 * torch.log10(torch.clamp(x, min=0.0))
    if offset_db is not None:
        d = d + offset_db
    return torch.clamp(d, min=-300.0)


def _selection_prominence(lin, fs, rate_min, rate_max, harmonics, offset_db=None):
    """Comb mass/prominence + refresh for linear autocorrelation arrays
    (..., n) — shared verbatim by the real channel score and the
    noise-surrogate null (the floor is only honest if the null runs the
    exact same selection).  ``offset_db`` (...) is added to the absolute
    quantities when ``lin`` was computed from rescaled rows."""
    fv = estimate_refresh(lin, fs, rate_min, rate_max, scale="linear")
    n = lin.shape[-1]
    linw = _widen_peaks(lin)
    pos_lo = min(int(round(fs / rate_max)), n - 1)
    pos_hi = min(int(round(fs / rate_min)), n - 1)
    band = linw[..., pos_lo : pos_hi + 1]
    med = _median(band)
    # Robust positive scale, NOT the raw median: the mean-removed LINEAR
    # autocorrelation of noise fluctuates around zero, so its band median
    # can land arbitrarily close to 0 and a comb/median ratio explodes.  The
    # MAD is the band's fluctuation magnitude, which is exactly the null the
    # comb must beat.
    mad = _median(torch.abs(band - med[..., None]))
    lag = fs / fv
    mass = torch.zeros_like(fv)
    count = torch.zeros_like(fv)
    for k in range(1, harmonics + 1):
        p = k * lag
        valid = p < n - 1
        mass = mass + torch.where(valid, _lerp(linw, p[..., None])[..., 0],
                                  torch.zeros_like(mass))
        count = count + valid.to(linw.dtype)
    comb = mass / torch.clamp(count, min=1.0)
    # Two statistics, two jobs: PROMINENCE ((comb−med)/MAD, scale-free)
    # detects "there is a screen in this channel" with a bounded noise
    # floor; absolute structured MASS (comb − med) scales with how much of
    # the emission the channel actually captured, so it LOCALISES the
    # carrier (prominence alone is flat across any sub-band of a wide
    # emission).
    mass_db = _db(comb - med, offset_db)
    prominence = mass_db - _db(mad, offset_db)
    return mass_db, prominence, fv


def _channel_part(iq):
    """The part of a capture (interleaved words, or complex samples) that
    the channeliser reads, its first N complex samples (N: the capture's FFT
    length, :func:`_channel_geometry`): a host capture uploads that part
    alone, since the rest never enters a channel."""
    is_complex = iq.is_complex() if isinstance(iq, torch.Tensor) else np.iscomplexobj(iq)
    n = int(iq.shape[0]) if is_complex else int(iq.shape[0]) // 2
    n_fft = _fft_pow2_len(n)
    return iq[:n_fft] if is_complex else iq[: 2 * n_fft]


def _words(iq, device) -> torch.Tensor:
    """Interleaved float32 I/Q words on the device: host complex input is
    viewed as words (the upload stays real), a complex tensor likewise.  A
    host array goes up through :func:`staged_upload`."""
    if isinstance(iq, np.ndarray):
        if np.iscomplexobj(iq):
            iq = np.ascontiguousarray(iq, np.complex64).view(np.float32)
        iq = staged_upload(iq, device)
    else:
        iq = as_tensor(iq, device)
    if iq.is_complex():
        iq = torch.view_as_real(iq.to(torch.complex64).contiguous()).reshape(-1)
    return iq


def carrier_score(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    device: torch.device | str | None = None,
) -> tuple[float, float]:
    """Screen-ness of ONE baseband capture: ``(comb prominence dB, refresh
    Hz)`` — the per-dwell metric of a live retune scan.  Prominence (the
    scale-free statistic) is returned because successive hardware dwells may
    see different gains.  Runs on ``device`` (``None``: where a tensor lies,
    else the CUDA card; raises when there is none)."""
    words = _words(iq, device)
    _, prom, fv = _comb_contrast(am_power_from_iq(words), float(fs), float(corr_seconds),
                                 float(rate_min), float(rate_max))
    return float(prom), float(fv)


def scan_centers(fs: float, step_hz: float, guard_hz: float = 0.0) -> np.ndarray:
    """Candidate centers covering the capture's (−fs/2, fs/2) span on a
    ``step_hz`` grid, keeping ``guard_hz`` clear of the band edges."""
    half = fs / 2.0 - guard_hz
    k = int(np.floor(half / step_hz))
    return np.arange(-k, k + 1, dtype=np.float64) * step_hz


def _fft_pow2_len(n: int) -> int:
    return 1 << (max(int(n), 2).bit_length() - 1)


def _channel_geometry(n_samples: int, fs: float, chan_bw: float):
    """(N, M, fs_channel): capture FFT length (power of two, rounded down),
    channel length (power of two, rounded up from ``chan_bw``), and the
    resulting channel sample rate — shared by the channeliser and its
    callers so the shape math cannot drift."""
    N = _fft_pow2_len(n_samples)
    M = 1 << max(int(np.ceil(chan_bw / fs * N)) - 1, 1).bit_length()
    M = min(M, N)
    return N, M, fs * M / N


def _excise_spikes(bands: torch.Tensor, margin_db: float,
                   guard_bins: int = 2, dilate_bins: int = 256) -> torch.Tensor:
    """Null narrowband interference in channel spectra (K, M), carrier at
    bin 0 — bins louder than the channel's own carrier peak.

    A CW interferer inside a channel beats against the emission's carrier
    and the AM envelope picks the beat up as sample-correlated power; the
    robust MRC already refuses to *weight* such a channel
    (``combine_core``), but excision *recovers* it.  A naive spike notch is
    WRONG here — the emission's own spectrum is a forest of narrow lines
    (the raster is near-periodic: carrier ± k·line-rate comb), so "null
    everything spiky" deletes the signal.  The criterion that protects the
    comb grid by construction: the carrier line is always the STRONGEST
    line of an AM screen emission, so only bins exceeding the carrier peak
    by ``margin_db`` are presumed interference.  ``guard_bins`` protects the
    carrier's own leakage skirt (±bins around DC); ``dilate_bins`` widens
    each detection to swallow the interferer's sinc skirt."""
    p = bands.real ** 2 + bands.imag ** 2
    m = bands.shape[-1]
    idx = torch.arange(m, device=bands.device)
    prot = (idx <= guard_bins) | (idx >= m - guard_bins)
    ref = torch.amax(torch.where(prot, p, torch.zeros_like(p)), dim=-1, keepdim=True)
    hit = (~prot) & (p > ref * 10.0 ** (margin_db / 10.0))
    # Circular box dilation in O(M): box-sum the hit indicator via one
    # cumsum over a circularly padded copy.
    w = int(dilate_bins)
    hf = hit.to(torch.float32)
    ext = torch.cat([hf[..., -w:], hf, hf[..., :w]], dim=-1)
    cz = torch.nn.functional.pad(torch.cumsum(ext, dim=-1), (1, 0))
    box = cz[..., 2 * w + 1:] - cz[..., : -(2 * w + 1)]   # (…, M)
    # The dilation must never swallow the protected carrier bins: a CW
    # within ``dilate_bins`` of DC would otherwise null the channel's own
    # carrier line — destroying the channel instead of recovering it.
    return torch.where((box > 0.0) & ~prot, torch.zeros_like(bands), bands)


def _channelize_complex(
    iq_words: torch.Tensor,
    fs: float,
    centers_hz: np.ndarray,
    chan_bw: float,
    excise_db: float | None = None,
) -> tuple[torch.Tensor, float]:
    """Core of :func:`channelize` — the (K, M) complex64 channels on the
    device of ``iq_words``.

    ``excise_db``: when set, narrowband interference above each channel's
    carrier peak by this margin is nulled in the spectrum before the
    inverse FFT (see :func:`_excise_spikes`)."""
    n_c = iq_words.shape[0] // 2
    N, M, fs_chan = _channel_geometry(n_c, fs, chan_bw)
    with annotate("scan.spectrum"):
        spec = _spectrum(iq_words, N)
    with annotate("scan.channels"):
        bands = _band_slices(spec, _band_starts(centers_hz, fs, N, M), M)
        del spec
        return _channels_from_bands(bands, N, excise_db), fs_chan


def _spectrum(iq_words: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The N-point FFT of the capture's first N complex samples."""
    return torch.fft.fft(torch.view_as_complex(
        iq_words[: 2 * n_fft].to(torch.float32).reshape(n_fft, 2)))


def _band_starts(centers_hz, fs: float, n_fft: int, m_chan: int) -> np.ndarray:
    """First bin of each carrier's M-bin band: the carrier's bin minus M/2,
    mod N — the one rounding of a carrier onto the spectrum, for the
    channeliser and every carrier-sharded path."""
    return np.array([(int(np.round(float(fc) / fs * n_fft)) - m_chan // 2) % n_fft
                     for fc in np.atleast_1d(np.asarray(centers_hz))], np.int64)


def _band_slices(spec: torch.Tensor, starts, m_chan: int) -> torch.Tensor:
    """(K, M) circular band slices of the spectrum: bin b covers frequency
    b/N·fs (negative frequencies wrap into the upper half), so a band that
    crosses the end of the spectrum continues at its start."""
    n_fft = spec.shape[0]
    rows = [spec[a: a + m_chan] if a + m_chan <= n_fft
            else torch.cat([spec[a:], spec[: a + m_chan - n_fft]])
            for a in (int(s) for s in starts)]
    return torch.stack(rows)                      # (K, M), centered at DC+M/2


def _channels_from_bands(bands: torch.Tensor, n_fft: int,
                         excise_db: float | None = None) -> torch.Tensor:
    """Band slices → (K, M) complex baseband channels, each row on its own:
    the center rotated to bin 0, optional excision, the M-point inverse
    FFT."""
    m_chan = bands.shape[1]
    bands = torch.roll(bands, -(m_chan // 2), dims=1)
    if excise_db is not None:
        bands = _excise_spikes(bands, excise_db)
    return torch.fft.ifft(bands, dim=1) * (m_chan / n_fft)


def channelize(
    iq_words: np.ndarray | torch.Tensor,
    fs: float,
    centers_hz: np.ndarray,
    chan_bw: float,
    device: torch.device | str | None = None,
) -> tuple[torch.Tensor, float]:
    """Extract K baseband channels of ≈``chan_bw`` from a wideband capture.

    ``iq_words`` is interleaved float32 I/Q (or complex64, viewed) of 2·N
    words.  Frequency-domain channelisation: one N-point FFT, an M-bin
    circular slice per center, one batched M-point inverse FFT — K channels
    at ``fs·M/N`` each, no per-channel mixing or filtering passes.  Returns
    ``(channels (K, 2·M) interleaved float32, fs_channel)`` as the JAX
    version does; ``torch.view_as_complex(rows.view(K, M, 2))`` gives the
    complex channels back.

    N is the capture rounded down to a power of two, M the channel width
    rounded UP to a power of two.  Runs on ``device`` (``None``: where a
    tensor lies, else the CUDA card; raises when there is none)."""
    chans, fs_chan = _channelize_complex(_words(iq_words, device), fs, centers_hz, chan_bw)
    return torch.view_as_real(chans).reshape(chans.shape[0], -1), fs_chan


def check_excise_demod(demod: str, excise_db: float | None) -> None:
    """Refuse the unsound knob combination loudly (every public entry point
    calls this): the excision criterion nulls bins louder than the channel's
    carrier line, which is safe for AM (the carrier is always the strongest
    emission line) but NOT for wideband FM — the carrier line nulls entirely
    at J₀ zeros of the modulation index and Carson sidebands can exceed it,
    so excision could null the emission itself.  The robust frame-periodic
    MRC (``ops.combine``) still downweights interfered FM channels."""
    if excise_db is not None and demod == "fm":
        raise ValueError(
            "excise_db with demod='fm' is unsupported: wideband FM can null "
            "its own carrier line (J0 zeros), so 'louder than the carrier' "
            "no longer identifies interference — excision could delete the "
            "emission. Disable excision for FM; the robust MRC weighting "
            "already rejects interfered channels."
        )


def _demod_rows(chans: torch.Tensor, demod: str) -> torch.Tensor:
    """The per-channel detection statistic of the sweep: the squared
    envelope (AM leakage) or the discriminator output (FM leakage — an FM
    emission's amplitude is flat, so the AM sweep is blind to it)."""
    if demod == "fm":
        return fm_demod_rows(chans)
    return chans.real ** 2 + chans.imag ** 2


def scan_band(
    iq_words: np.ndarray | torch.Tensor,
    fs: float,
    centers_hz: np.ndarray,
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    demod: str = "am",
    excise_db: float | None = None,
    device: torch.device | str | None = None,
) -> ScanResult:
    """Score every candidate carrier in a wideband capture, all channels in
    one batch, on ``device`` (``None``: where a tensor lies, else the CUDA
    card; raises when there is none).

    ``iq_words``: interleaved float32 I/Q words, or complex64 (viewed).
    Per channel: envelope power → FFT autocorrelation over ``corr_seconds``
    → comb mass, prominence and the refined refresh estimate; one measured
    noise floor for the sweep.  Returns a :class:`ScanResult` over
    ``centers_hz``.

    ``demod="fm"`` scores the per-channel FM discriminator instead of the
    squared envelope (run both to survey a band for both leakage modes).

    ``excise_db``: opt-in CW excision per channel before scoring (margin
    over the carrier peak, dB — :func:`_excise_spikes`); AM only.
    """
    check_excise_demod(demod, excise_db)
    with annotate("scan.band"):
        words = _words(_channel_part(iq_words), device)
        centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
        count("scan.channels", len(centers))
        count("scan.fft.points", _fft_pow2_len(words.shape[0] // 2))
        chans, fs_chan = _channelize_complex(
            words, float(fs), centers, float(chan_bw),
            excise_db=None if excise_db is None else float(excise_db))
        # The scores and the floor each end on the host.
        with annotate("scan.score"):
            scores, proms, fvs = (
                t.cpu().numpy().astype(np.float64)
                for t in _comb_contrast(_demod_rows(chans, demod), fs_chan, float(corr_seconds),
                                        float(rate_min), float(rate_max)))
        with annotate("scan.floor"):
            floor = float(_noise_floor(fs_chan, chans.shape[1], float(corr_seconds),
                                       float(rate_min), float(rate_max), demod=demod,
                                       device=words.device))
    return ScanResult(
        centers_hz=centers,
        scores_db=scores,
        prominence_db=proms,
        refresh_hz=fvs,
        fs_channel=fs_chan,
        floor_db=np.full(len(centers), floor),
    )
