"""Multi-harmonic combining in PyTorch — the counterpart of
``tempest_tpu/ops/combine.py``: fuse the SAME screen's emission from several
carriers of one wideband capture into one higher-SNR envelope.

A display leaks at every harmonic of its pixel clock (and at intermodulation
products); each carrier carries the same video envelope with its own
strength, independent RF phase, and possibly inverted modulation polarity.
Since the carriers ride one time base, their demodulated envelopes are
sample-aligned by construction — no frame registration is needed to combine
them, and the SNR gain happens BEFORE the nonlinear sync/alignment stages.

One pass on the device channelises the capture (the scan module's big FFT +
band slices + batched inverse FFT), takes per-channel envelopes, scores each
channel's screen-content power by the refresh-comb mass the scanner uses,
detects per-channel modulation polarity against the strongest channel (one
matrix-vector product of mean-removed envelopes), solves maximal-ratio
weights from the comb/variance statistics, and emits the weighted sum.  The
K channels are a batch axis throughout; the fused envelope is a tensor that
stays on the device for whoever consumes it (the runtime's combine front,
``pipeline.offline.combined_reconstruct``), and only the public
:class:`CombineResult` holds it as a host array.

MRC weight derivation: with mean-removed envelopes ``e_k = a_k·v + n_k``,
screen content is FRAME-periodic while receiver noise, CW envelope beats,
hum and other interference are not.  Per channel the comb dots at the known
frame lags minus the same dots at half-frame offsets isolate the screen
power (``s_k ≈ ρ·a_k²·σ_v²`` with the content persistence ρ common to all
channels — interference contributes equally to both dot sets and cancels),
the remainder ``N_k = c0_k − s_k`` is noise+interference, and the
SNR-optimal weights are ``w_k = √s_k / N_k`` (matched-filter MRC) — no
cross-channel calibration needed.  A pure-noise channel has s≈0 ⇒ w≈0, so
combining over a blind carrier list is safe; gates on comb evidence zero
channels outright (see ``combine_core``).  The lag-1 decorrelation split
(``s=c1``, ``N=c0−c1``) is kept as ``refresh_hz=None``; it mis-reads
coherent in-channel interference as signal.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ..utils.profiling import annotate, count
from .demod import fm_demod_rows
from .scan import (
    _channel_geometry,
    _channel_part,
    _channelize_complex,
    _comb_score,
    _words,
    check_excise_demod,
)

__all__ = ["CombineResult", "combine_core", "combine_harmonics"]


@dataclasses.dataclass(frozen=True)
class CombineResult:
    """A combined envelope plus the per-channel evidence behind it."""

    envelope: np.ndarray        # combined envelope, float32 [M]
    fs_channel: float           # its sample rate [Hz]
    centers_hz: np.ndarray      # the carriers combined (input order)
    weights: np.ndarray         # MRC weight per channel (sums to 1)
    polarity: np.ndarray        # +1/-1 modulation polarity vs the anchor
    mass_db: np.ndarray         # refresh-comb mass per channel (dB)
    refresh_hz: np.ndarray      # per-channel refresh estimate

    def best_channel(self) -> int:
        return int(np.argmax(self.mass_db))


def _channel_envelopes(words, fs, centers, chan_bw, demod, excise_db) -> torch.Tensor:
    """The (K, M) float32 demodulated channels of a capture: AM amplitude
    envelopes or FM discriminator rows."""
    check_excise_demod(demod, excise_db)
    chans, _ = _channelize_complex(words, fs, np.asarray(centers), chan_bw,
                                   excise_db=excise_db)
    return _demod_channels(chans, demod)


def _demod_channels(chans: torch.Tensor, demod: str) -> torch.Tensor:
    """Complex channels (K, M) → their float32 demodulated rows."""
    if demod == "fm":
        return fm_demod_rows(chans)
    return torch.abs(chans).to(torch.float32)


def _comb_dots(env0: torch.Tensor, spf_c: float, half_off: int) -> torch.Tensor:
    """Mean lag products of every row of ``env0`` (K, M) at the first five
    multiples of the frame period ``spf_c`` (shifted by half a period with
    ``half_off=1``), each the box-3 maximum over neighbouring lags (which
    tolerates the known refresh being ppm-off the emission's crystal)."""
    m = env0.shape[1]
    acc = torch.zeros(env0.shape[0], dtype=env0.dtype, device=env0.device)
    cnt = 0
    for k in range(1, 6):
        lag0 = int(round(k * spf_c + half_off * spf_c / 2.0))
        if lag0 + 1 >= m:
            break
        vals = [torch.mean(env0[:, : m - lag] * env0[:, lag:], dim=1)
                for lag in (lag0 - 1, lag0, lag0 + 1) if 0 < lag < m]
        acc = acc + torch.amax(torch.stack(vals), dim=0)
        cnt += 1
    return acc / max(cnt, 1)


class _RowStats(typing.NamedTuple):
    """What each demodulated channel contributes to the fusion, row by row."""

    mean: torch.Tensor       # (K, 1)
    env0: torch.Tensor       # (K, M) mean removed
    var: torch.Tensor        # (K,) σ_k²
    comb: torch.Tensor | None       # on-comb dots (known refresh only)
    comb_off: torch.Tensor | None   # off-comb dots at half-frame offsets
    mass_db: torch.Tensor    # (K,) refresh-comb mass
    fv: torch.Tensor         # (K,) refresh per channel


def _row_stats(amp, fs_chan, corr_seconds, rate_min, rate_max, refresh_hz) -> _RowStats:
    """Per-channel statistics of demodulated channels ``amp`` (K, M); every
    row on its own, so that a carrier-sharded fusion computes them shard by
    shard."""
    mean = torch.mean(amp, dim=1, keepdim=True)
    env0 = amp - mean
    var = torch.mean(env0 * env0, dim=1)
    if refresh_hz is None:
        mass_db, _, fv = _comb_score(env0, fs_chan, corr_seconds, rate_min, rate_max, 5)
        return _RowStats(mean, env0, var, None, None, mass_db, fv)
    spf_c = fs_chan / float(refresh_hz)
    comb = _comb_dots(env0, spf_c, 0)
    # Off-comb null at half-frame lag offsets: any NON-frame-periodic
    # correlated power (a CW interferer's envelope beat, hum, receiver
    # artifacts) contributes to both on- and off-comb dots alike, while
    # screen content is frame-periodic and does not — the difference
    # isolates SCREEN power for the MRC weights below.
    comb_off = _comb_dots(env0, spf_c, 1)
    mass_db = 10.0 * torch.log10(torch.clamp(comb, min=1e-30))
    return _RowStats(mean, env0, var, comb, comb_off, mass_db,
                     torch.full_like(var, float(refresh_hz)))


def _gated_weights(st: _RowStats, weighting: str, comb_max, mass_max) -> torch.Tensor:
    """Unnormalised MRC weights of each row, zero where a gate refuses the
    channel.  ``comb_max`` and ``mass_max`` are the largest on-comb dot and
    comb mass over ALL the channels of the fusion."""
    var = st.var
    if weighting == "equal":
        return torch.ones_like(var)
    if st.comb is not None:
        # Interference-robust MRC: signal power = frame-PERIODIC correlated
        # power (on-comb minus off-comb — a CW beat, hum, or any correlated
        # non-screen power cancels in the difference); noise = everything
        # else, interference included.
        s = torch.clamp(st.comb - st.comb_off, min=0.0)
        noise = torch.maximum(var - s, 1e-6 * var)
        w = torch.sqrt(s) / noise
        # Raw envelope dots scale as amplitude² where the offline linear-
        # autocorrelation mass scales as amplitude⁴: the offline 40 dB gate
        # is 20 dB here.  Second gate: the selection-biased noise null of a
        # max-of-3 mean-of-5 dot estimate is a few c0/√M; 6× clears noise
        # even when the anchor itself is weak.
        gate = ((st.comb > comb_max * 1e-2)
                & (st.comb * float(np.sqrt(st.env0.shape[1])) > 6.0 * var))
        return torch.where(gate, w, torch.zeros_like(w))
    # MRC from the lag-1 decorrelation split (estimate_snr's separation):
    # signal power s = c1 (correlated), noise N = c0 - c1 (white).
    # Assumes WHITE receiver noise — coherent interference inside a
    # channel is misread as signal; the refresh_hz path above is the
    # robust estimator (the public wrappers run it by default).
    c1 = torch.mean(st.env0[:, :-1] * st.env0[:, 1:], dim=1)
    s = torch.clamp(c1, min=0.0)
    noise = torch.maximum(var - c1, 1e-6 * var)
    w = torch.sqrt(s) / noise
    # Zero out channels with no refresh-comb evidence (correlated
    # interference is not screen signal).
    return torch.where(st.mass_db > mass_max - 40.0, w, torch.zeros_like(w))


def _fuse(amp, fs_chan, corr_seconds, rate_min, rate_max, weighting, refresh_hz):
    """Polarity → MRC weights → fusion of demodulated channels ``amp``
    (K, M): ``(env, weights, polarity, mass_db, refresh)``."""
    st = _row_stats(amp, fs_chan, corr_seconds, rate_min, rate_max, refresh_hz)
    anchor = torch.argmax(st.mass_db)
    # Modulation polarity: sign of the correlation against the anchor
    # channel's envelope (intermodulation regularly inverts video).
    dots = torch.mv(st.env0, st.env0.index_select(0, anchor.reshape(1))[0])
    pol = torch.where(dots >= 0.0, 1.0, -1.0).to(torch.float32)
    w = _gated_weights(st, weighting, None if st.comb is None else torch.max(st.comb),
                       torch.max(st.mass_db))
    w = w / torch.clamp(torch.sum(w), min=1e-30)
    # Deterministic output polarity: ``pol`` is measured relative to the
    # data-dependent anchor (the strongest channel), which may itself carry
    # INVERTED modulation — equal-strength harmonics then make the fused
    # video's sense an arbitrary draw.  Re-base to the first carrier that
    # survives gating, so the contract is "the fused envelope carries
    # centers_hz[0]'s modulation sense" — reproducible, and the operator's
    # existing ``invert`` knob handles the (physically unknowable) absolute
    # sense.
    first = torch.argmax((w > 0.0).to(torch.int32))
    pol = pol * pol.index_select(0, first.reshape(1))
    env = torch.mv(st.env0.T, w * pol)
    # Re-add the combined DC so the output looks like a standard positive
    # envelope to downstream consumers (blanking-polarity detection etc.).
    env = env + torch.sum(w * st.mean[:, 0])
    return env, w, pol, st.mass_db, st.fv


def combine_core(words, fs, centers, chan_bw, fs_chan, corr_seconds,
                 rate_min, rate_max, weighting, refresh_hz=None,
                 demod="am", excise_db=None):
    """Channelise → polarity → MRC weights → fusion of interleaved float32
    I/Q words on their device: ``(env, weights, polarity, mass_db,
    refresh)``, all tensors there.

    ``refresh_hz`` (float): when the screen's refresh is already known (the
    streaming runtime's video mode), the per-channel comb mass is read
    directly at the known frame lags — 15 lag products per channel
    (harmonics 1–5 × a box-3 lag neighbourhood absorbing ppm-level drift),
    batched over the channels, instead of a full FFT autocorrelation +
    period search per channel.  The mass scale differs from the offline
    estimator (no band-median removal / peak widening), which is irrelevant
    for its only use here: the relative gate between channels of ONE call.
    ``None`` keeps the full search and honest per-channel refresh
    estimates.

    ``demod``: ``"am"`` (default — amplitude envelope per channel) or
    ``"fm"`` (per-channel FM discriminator, ``ops.demod.fm_demod_rows``);
    every downstream stage (comb mass, polarity, frame-periodic MRC) works
    on the mean-removed demodulated rows and is demod-agnostic.

    ``excise_db`` (float | None): null narrowband interference louder than
    each channel's own carrier peak by this margin in the channel spectra
    before demodulation (``ops.scan._excise_spikes``) — RECOVERS a CW-hit
    channel where the robust MRC alone can only refuse to weight it.  AM
    only (:func:`tempest_tpu_torch.ops.scan.check_excise_demod`)."""
    with annotate("combine.channels"):
        amp = _channel_envelopes(words, fs, centers, chan_bw, demod, excise_db)
    with annotate("combine.fuse"):
        return _fuse(amp, fs_chan, corr_seconds, rate_min, rate_max, weighting, refresh_hz)


def _combine_on_device(iq, fs, centers_hz, chan_bw, corr_seconds, rate_min, rate_max,
                       weighting, refresh_hz, demod, excise_db, device):
    """:func:`combine_harmonics` with the fused envelope left on the device:
    ``(envelope tensor, CombineResult fields without the envelope)``.  The
    capture is channelised once; the two-pass ``"auto"`` fuses the same
    demodulated channels twice."""
    words = _words(_channel_part(iq), device)
    centers = np.atleast_1d(np.asarray(centers_hz, np.float64))
    _, _, fs_chan = _channel_geometry(int(words.shape[0]) // 2, fs, chan_bw)
    count("combine.carriers", len(centers))
    with annotate("combine.channels"):
        amp = _channel_envelopes(words, float(fs), centers, float(chan_bw), demod, excise_db)
    args = (amp, float(fs_chan), float(corr_seconds), float(rate_min), float(rate_max),
            weighting)
    with annotate("combine.fuse"):
        env, w, pol, mass_db, fv = _fuse(*args, None if refresh_hz == "auto" else refresh_hz)
    if refresh_hz == "auto" and weighting == "mrc":
        # Pass 1 keeps the honest per-channel diagnostics (mass, refresh);
        # pass 2 re-weights at the anchor's refresh, quantised to an integer
        # frame period as in the JAX package (the box-3 lag neighbourhood
        # absorbs the ≤0.5-sample rounding), so both packages read the same
        # lags.
        fv_anchor = float(fv[torch.argmax(mass_db)])
        fv_anchor = fs_chan / round(fs_chan / fv_anchor)
        with annotate("combine.fuse"):
            env, w, pol, _, _ = _fuse(*args, fv_anchor)
    fields = dict(
        fs_channel=float(fs_chan),
        centers_hz=centers,
        weights=w.cpu().numpy().astype(np.float64),
        polarity=pol.cpu().numpy().astype(np.float64),
        mass_db=mass_db.cpu().numpy().astype(np.float64),
        refresh_hz=fv.cpu().numpy().astype(np.float64),
    )
    return env, fields


def combine_harmonics(
    iq: np.ndarray | torch.Tensor,
    fs: float,
    centers_hz: np.ndarray | list[float],
    chan_bw: float = 4e6,
    corr_seconds: float = 0.1,
    rate_min: float = 50.0,
    rate_max: float = 90.0,
    weighting: str = "mrc",
    refresh_hz: float | str | None = "auto",
    demod: str = "am",
    excise_db: float | None = None,
    device: torch.device | str | None = None,
) -> CombineResult:
    """Extract and fuse the emission at each carrier of ``centers_hz`` from
    one wideband capture, on ``device`` (``None``: where a tensor lies, else
    the CUDA card; raises when there is none).

    ``iq``: complex64 (viewed as words) or interleaved float32 I/Q.
    Returns a :class:`CombineResult` whose ``envelope`` (at ``fs_channel``)
    feeds the standard pipeline via ``ReconstructionConfig(
    input_format="envelope")`` — see ``pipeline.offline.combined_reconstruct``
    for the one-call wrapper, which keeps the envelope on the device.
    ``weighting``: ``"mrc"`` (default) or ``"equal"``.

    ``refresh_hz``: ``"auto"`` (default) runs TWO passes — a scoring pass
    estimates each channel's refresh, then the fusion pass re-weights with
    the interference-robust frame-periodic MRC at the anchor's refresh
    (``combine_core(refresh_hz=...)``).  A float skips the scoring pass
    (the streaming runtime's mode of use); ``None`` keeps the single-pass
    lag-1 MRC, which misreads coherent in-channel interference as signal —
    kept for comparison only.

    ``demod``: ``"am"`` (envelope) or ``"fm"`` (per-channel discriminator,
    for targets that leak the video in carrier frequency).

    ``excise_db``: opt-in spectral excision of in-channel CW interference
    (bins louder than the channel's carrier peak by this margin, nulled
    before demod — 0.0 is a good setting; see ``combine_core``)."""
    env, fields = _combine_on_device(iq, fs, centers_hz, chan_bw, corr_seconds, rate_min,
                                     rate_max, weighting, refresh_hz, demod, excise_db,
                                     device)
    return CombineResult(envelope=env.cpu().numpy().astype(np.float32), **fields)
