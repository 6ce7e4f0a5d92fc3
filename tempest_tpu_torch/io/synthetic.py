"""Synthetic TEMPEST signal generator — the framework's golden test fixture.

The reference ships a recorded capture (``dumpIQ_0.dat``) as its de-facto
golden input, but that blob is git-ignored and absent from the mounted copy
(``/root/reference/.MISSING_LARGE_BLOBS``).  Following SURVEY.md §7 step 1, we
instead *render* a known image into a scanline envelope at a chosen
``VideoMode``, amplitude-modulate it onto a complex baseband carrier at a given
sample rate, and add calibrated noise.  Every downstream kernel (demod,
autocorrelation, resampling, frame sync, the full pipeline) is tested against
signals from this generator, where ground truth (refresh rate, line count,
image content, sync offset) is known exactly.

Physics of the modelled emanation: a monitor redraws ``height`` lines,
``width`` pixel periods each (both including blanking), ``refresh`` times per
second.  Radiated harmonics of the pixel clock are amplitude-modulated by the
video signal, so the magnitude envelope of the received IQ stream traces the
raster scan — which is exactly what the reconstruction pipeline inverts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..video.modes import VideoMode

__all__ = ["SyntheticCapture", "test_pattern", "render_frame", "generate_iq",
           "generate_iq_harmonics"]


def test_pattern(vis_h: int, vis_w: int, seed: int = 0) -> np.ndarray:
    """Deterministic grayscale test card in [0, 1]: vertical bars, a horizontal
    gradient band, and a block of text-like random glyph rows.  Structured
    enough that misalignment by even one line/pixel is measurable."""
    rng = np.random.default_rng(seed)
    img = np.zeros((vis_h, vis_w), np.float32)
    # Vertical bars of alternating intensity (top third).
    bar_w = max(vis_w // 16, 1)
    cols = (np.arange(vis_w) // bar_w) % 2
    img[: vis_h // 3, :] = 0.25 + 0.7 * cols[None, :]
    # Horizontal gradient (middle third).
    img[vis_h // 3 : 2 * vis_h // 3, :] = np.linspace(0, 1, vis_w, dtype=np.float32)
    # Text-like glyph rows (bottom third): coarse random binary blocks.
    gh, gw = 4, 3
    rows = vis_h - 2 * vis_h // 3  # rows of the target slice img[2*vis_h//3:]
    glyphs = rng.random((rows // gh + 1, vis_w // gw + 1)) > 0.55
    glyph_img = np.kron(glyphs, np.ones((gh, gw))).astype(np.float32)
    img[2 * vis_h // 3 :, :] = glyph_img[:rows, :vis_w] * 0.9
    return img


def render_frame(
    mode: VideoMode,
    visible: np.ndarray | None = None,
    blank_level: float = 0.0,
    visible_fraction: tuple[float, float] = (0.92, 0.80),
) -> np.ndarray:
    """Place visible content into the full (height, width) raster of a mode.

    ``visible_fraction`` = (horizontal, vertical) active fraction of the total
    timing; the rest is the blanking interval held at ``blank_level``.  The
    defaults approximate real VESA timings (e.g. 1920/2576 ≈ 0.75–0.92 active).
    """
    frame = np.full((mode.height, mode.width), blank_level, np.float32)
    vis_w = int(round(mode.width * visible_fraction[0]))
    vis_h = int(round(mode.height * visible_fraction[1]))
    if visible is None:
        visible = test_pattern(vis_h, vis_w)
    if visible.shape != (vis_h, vis_w):
        # Nearest-neighbour fit of the provided image into the active area.
        ys = np.minimum(
            (np.arange(vis_h) * visible.shape[0] // vis_h), visible.shape[0] - 1
        )
        xs = np.minimum(
            (np.arange(vis_w) * visible.shape[1] // vis_w), visible.shape[1] - 1
        )
        visible = visible[np.ix_(ys, xs)]
    frame[:vis_h, :vis_w] = visible
    return frame


@dataclasses.dataclass(frozen=True)
class SyntheticCapture:
    """A generated IQ capture plus its ground truth."""

    iq: np.ndarray          # complex64 [n_samples]
    mode: VideoMode         # true video mode
    sample_rate: float      # Fs [Hz]
    frame: np.ndarray       # true full raster (height, width) in [0,1]
    start_phase: float      # pixel index (fractional) at sample 0
    snr_db: float

    @property
    def samples_per_frame(self) -> float:
        return self.sample_rate / self.mode.refresh


def _sample_envelope(
    frame: np.ndarray,
    mode: VideoMode,
    sample_rate: float,
    n_samples: int,
    start_phase: float,
) -> np.ndarray:
    """Raster pixel value at every receiver sample: fractional pixel index
    ``start_phase + k * pixel_clock / Fs`` into the row-major scan, linearly
    interpolated and wrapped over frames."""
    raster = frame.ravel()  # row-major scan: line after line
    n_pix = raster.size
    step = mode.pixel_clock / sample_rate
    idx = (start_phase + step * np.arange(n_samples, dtype=np.float64)) % n_pix
    i0 = idx.astype(np.int64)
    frac = (idx - i0).astype(np.float32)
    i1 = i0 + 1
    i1[i1 == n_pix] = 0
    return raster[i0] * (1.0 - frac) + raster[i1] * frac


def generate_iq(
    mode: VideoMode,
    sample_rate: float,
    n_samples: int,
    *,
    visible: np.ndarray | None = None,
    snr_db: float = 30.0,
    carrier_offset_hz: float = 1.25e6,
    modulation_depth: float = 0.8,
    dc_level: float = 1.0,
    start_phase: float = 0.0,
    seed: int = 0,
    modulation: str = "am",
) -> SyntheticCapture:
    """Generate ``n_samples`` of complex-baseband IQ for a screen emanation.

    The envelope at receiver sample ``k`` is the raster pixel value at
    fractional pixel index ``start_phase + k * pixel_clock / Fs`` (linear
    interpolation, wrapping over frames), AM-modulated as
    ``(dc + depth * env) * exp(j 2π f_off k / Fs)`` with complex AWGN at the
    requested SNR.  ``abs()`` of the result recovers ``dc + depth * env``
    (plus noise) — the signal model assumed by the reference's ``amDemod``
    pipeline (``/root/reference/src/GUI.jl:163-168``).
    """
    rng = np.random.default_rng(seed)
    frame = render_frame(mode, visible)
    env = _sample_envelope(frame, mode, sample_rate, n_samples, start_phase)

    if modulation == "am":
        amplitude = dc_level + modulation_depth * env
        phase = 2.0 * np.pi * carrier_offset_hz / sample_rate * np.arange(n_samples)
    elif modulation == "fm":
        # Frequency-modulated leakage: instantaneous frequency tracks the
        # video; the FM discriminator recovers ``2π (f_off + dev·env) / fs``.
        amplitude = np.full(n_samples, dc_level, np.float64)
        deviation_hz = modulation_depth * sample_rate / 16.0
        inst_freq = carrier_offset_hz + deviation_hz * env
        phase = 2.0 * np.pi * np.cumsum(inst_freq) / sample_rate
    else:
        raise ValueError(f"unknown modulation {modulation!r}")
    clean = (amplitude * np.exp(1j * phase)).astype(np.complex64)

    sig_power = float(np.mean(np.abs(clean) ** 2))
    noise_power = sig_power / (10.0 ** (snr_db / 10.0))
    noise = np.sqrt(noise_power / 2.0) * (
        rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)
    )
    iq = (clean + noise).astype(np.complex64)
    return SyntheticCapture(
        iq=iq,
        mode=mode,
        sample_rate=float(sample_rate),
        frame=frame,
        start_phase=float(start_phase),
        snr_db=float(snr_db),
    )


def generate_iq_harmonics(
    mode: VideoMode,
    sample_rate: float,
    n_samples: int,
    carriers_hz: np.ndarray | list[float],
    *,
    amplitudes: np.ndarray | list[float] | None = None,
    depths: np.ndarray | list[float] | None = None,
    visible: np.ndarray | None = None,
    snr_db: float = 30.0,
    dc_level: float = 1.0,
    start_phase: float = 0.0,
    seed: int = 0,
    modulation: str = "am",
    deviation_hz: float | None = None,
) -> SyntheticCapture:
    """Wideband capture of ONE screen radiating at SEVERAL pixel-clock
    harmonics — the test fixture for multi-band combining (ops.combine).

    A real display leaks at every harmonic of its pixel clock, each
    amplitude-modulated by the same video envelope but with independent
    carrier phase, its own strength, and possibly inverted modulation
    (``depths`` may be negative — intermodulation regularly flips polarity,
    cf. the reference's blank-polarity note ``FrameSynchronisation.jl:51-53``).
    The emitted signal is ``Σ_k A_k (dc + d_k·env) e^{j(2π f_k t + φ_k)}``
    plus one complex AWGN whose power is set ``snr_db`` below the strongest
    single carrier's modulated power (so per-carrier channel SNRs are
    directly ``snr_db`` scaled by ``A_k²``).

    ``modulation="fm"`` models frequency-modulated leakage instead: each
    carrier rides at constant amplitude ``A_k·dc`` with instantaneous
    frequency ``f_k + d_k·deviation_hz·env`` (``depths`` scale — and may
    invert — the deviation; ``deviation_hz`` defaults to ``sample_rate/64``
    and must stay inside the combiner's channel half-bandwidth)."""
    rng = np.random.default_rng(seed)
    frame = render_frame(mode, visible)
    env = _sample_envelope(frame, mode, sample_rate, n_samples, start_phase)
    carriers = np.atleast_1d(np.asarray(carriers_hz, np.float64))
    k = len(carriers)
    amp = (np.ones(k) if amplitudes is None
           else np.asarray(amplitudes, np.float64))
    dep = (np.full(k, 0.8) if depths is None
           else np.asarray(depths, np.float64))
    if modulation not in ("am", "fm"):
        raise ValueError(f"unknown modulation {modulation!r}")
    dev = (sample_rate / 64.0 if deviation_hz is None else float(deviation_hz))
    t = np.arange(n_samples, dtype=np.float64)
    clean = np.zeros(n_samples, np.complex128)
    ref_power = 0.0
    for a, d, fc in zip(amp, dep, carriers):
        phi = rng.uniform(0.0, 2.0 * np.pi)
        if modulation == "fm":
            modulated = np.full(n_samples, a * dc_level, np.float64)
            inst_freq = fc + d * dev * env
            theta = 2.0 * np.pi * np.cumsum(inst_freq) / sample_rate + phi
        else:
            modulated = a * (dc_level + d * env)
            theta = 2.0 * np.pi * fc / sample_rate * t + phi
        clean += modulated * np.exp(1j * theta)
        ref_power = max(ref_power, float(np.mean(modulated**2)))
    noise_power = ref_power / (10.0 ** (snr_db / 10.0))
    noise = np.sqrt(noise_power / 2.0) * (
        rng.standard_normal(n_samples) + 1j * rng.standard_normal(n_samples)
    )
    return SyntheticCapture(
        iq=(clean + noise).astype(np.complex64),
        mode=mode,
        sample_rate=float(sample_rate),
        frame=frame,
        start_phase=float(start_phase),
        snr_db=float(snr_db),
    )
