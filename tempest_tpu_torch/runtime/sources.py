"""IQ sample sources: file replay, live synthesis, and hardware SDR stubs.

The acquisition layer of the framework — the role AbstractSDRs.jl plays for
the reference (``/root/reference/src/AtomicAbstractSDRs.jl:273-306``).  All
sources produce fixed-size complex64 blocks through a uniform interface so the
streaming runtime can swap them freely:

* ``ReplaySource`` — loops a recorded ``.dat`` capture, the reference's
  ``:radiosim`` backend (``GUI.jl:365-373,677-692``).
* ``SyntheticSource`` — streams the synthetic TEMPEST generator continuously
  (no reference equivalent; replaces the missing golden capture).
* ``HardwareSource`` — live SDR acquisition via SoapySDR (UHD/USRP,
  AdalmPluto, BladeRF, RTL-SDR — the reference's supported set,
  ``Project.toml:6-19``), import-guarded: without a driver stack (this build
  environment) instantiation raises with guidance.  Includes the live
  retuning surface (``set_carrier``/``set_gain``/``set_sample_rate``).
"""

from __future__ import annotations

import os
from typing import Protocol

import numpy as np

from ..io.dat import iter_complex_blocks
from ..io.synthetic import generate_iq
from ..video.modes import VideoMode

__all__ = ["SampleSource", "ReplaySource", "SyntheticSource", "HardwareSource", "open_source"]


class SampleSource(Protocol):
    """Uniform block source: fills caller-provided complex64 blocks."""

    sample_rate: float
    block_size: int

    def read(self, out: np.ndarray) -> None: ...
    def close(self) -> None: ...


class ReplaySource:
    """Loop a recorded interleaved-IQ capture as if it were live hardware."""

    def __init__(
        self,
        path: str | os.PathLike,
        sample_rate: float,
        block_size: int,
        fmt: str = "single",
    ) -> None:
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self._iter = iter_complex_blocks(path, self.block_size, fmt, loop=True)
        self._closed = False

    def read(self, out: np.ndarray) -> None:
        # A clean, explicit error after close() — not the bare StopIteration
        # a swapped-in empty iterator used to leak to a racing producer.
        if self._closed:
            raise RuntimeError("ReplaySource is closed")
        np.copyto(out, next(self._iter))

    def close(self) -> None:
        self._closed = True
        self._iter = iter(())


class SyntheticSource:
    """Stream a synthetic screen emanation block by block, phase-continuous
    across blocks (the generator carries the raster phase)."""

    def __init__(
        self,
        mode: VideoMode,
        sample_rate: float,
        block_size: int,
        snr_db: float = 20.0,
        seed: int = 0,
        visible: np.ndarray | None = None,
        modulation: str = "am",
    ) -> None:
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.mode = mode
        self._snr = snr_db
        self._seed = seed
        self._visible = visible
        # "am" (envelope) or "fm" (video rides the carrier frequency) —
        # the live counterpart of `cli synth --modulation`.
        self._modulation = modulation
        self._phase = 0.0
        self._pix_per_sample = mode.pixel_clock / sample_rate
        self._block_idx = 0

    def read(self, out: np.ndarray) -> None:
        cap = generate_iq(
            self.mode,
            self.sample_rate,
            self.block_size,
            visible=self._visible,
            snr_db=self._snr,
            start_phase=self._phase,
            seed=self._seed + self._block_idx,
            modulation=self._modulation,
        )
        np.copyto(out, cap.iq)
        n_pix = self.mode.pixels_per_frame
        self._phase = (self._phase + self._pix_per_sample * self.block_size) % n_pix
        self._block_idx += 1

    def close(self) -> None:
        pass


class HardwareSource:
    """Live SDR acquisition through SoapySDR (import-guarded).

    The real-hardware counterpart of the reference's driver layer —
    ``openSDR``/``recv!``/``updateCarrierFreq!``/``updateSamplingRate!``/
    ``updateGain!`` (``AtomicAbstractSDRs.jl:273-306``, ``GUI.jl:609-658``).
    SoapySDR is the vendor-neutral C++ driver shim covering the reference's
    whole hardware set (UHD/USRP, AdalmPluto, BladeRF, RTL-SDR) behind one
    stream API.  When the ``SoapySDR`` python module is importable the source
    opens the device, configures (carrier, rate, gain), and ``read`` drains
    the RX stream into each block; otherwise instantiation raises with
    guidance (this build environment ships no driver stack).

    ``set_carrier`` / ``set_gain`` / ``set_sample_rate`` retune the running
    device — the live-update surface the reference wires to its GUI textboxes
    and sliders (``GUI.jl:609-658``).
    """

    SUPPORTED = ("uhd", "pluto", "bladerf", "rtlsdr")
    # tempest_tpu backend name -> SoapySDR driver key
    _DRIVERS = {
        "uhd": "uhd",
        "pluto": "plutosdr",
        "bladerf": "bladerf",
        "rtlsdr": "rtlsdr",
    }
    # SoapySDR/include/SoapySDR/Errors.h codes (fallbacks when the python
    # module predates the constants).  TIMEOUT and OVERFLOW are *routine*
    # live-stream conditions, not failures — the reference's producer loop
    # survives both as a matter of course (it measures overflow,
    # ``AtomicAbstractSDRs.jl:263-268``, and never dies, ``:284-306``).
    _TIMEOUT_DEFAULT = -1
    _OVERFLOW_DEFAULT = -4

    def __init__(
        self,
        backend: str,
        carrier_freq: float,
        sample_rate: float,
        gain: float,
        block_size: int,
        channel: int = 0,
        device_args: dict | None = None,
        timeout_limit: int = 200,
    ) -> None:
        try:
            import SoapySDR  # noqa: F401 — optional driver stack
        except ImportError as exc:
            raise RuntimeError(
                f"No SDR driver stack is available in this environment "
                f"(requested backend {backend!r}; supported: {self.SUPPORTED}). "
                f"Install SoapySDR + the vendor module, or use ReplaySource "
                f"for recorded captures / SyntheticSource for generated signal."
            ) from exc
        if backend not in self._DRIVERS:
            raise ValueError(
                f"unknown SDR backend {backend!r}; supported: {self.SUPPORTED}"
            )
        self._soapy = SoapySDR
        self._code_timeout = int(getattr(SoapySDR, "SOAPY_SDR_TIMEOUT",
                                         self._TIMEOUT_DEFAULT))
        self._code_overflow = int(getattr(SoapySDR, "SOAPY_SDR_OVERFLOW",
                                          self._OVERFLOW_DEFAULT))
        # Live-condition counters, surfaced via StreamingRuntime.health()
        # (the reference prints its overflow count in print_summary,
        # ``AtomicAbstractSDRs.jl:333-341``).
        self.overflows = 0
        self.timeouts = 0
        self.timeout_limit = int(timeout_limit)
        self.sample_rate = float(sample_rate)
        self.block_size = int(block_size)
        self.carrier_freq = float(carrier_freq)
        self.gain = float(gain)
        self._chan = int(channel)
        args = dict(device_args or {})
        args.setdefault("driver", self._DRIVERS[backend])
        self._dev = SoapySDR.Device(args)
        rx = SoapySDR.SOAPY_SDR_RX
        self._rx = rx
        self._dev.setSampleRate(rx, self._chan, self.sample_rate)
        self._dev.setFrequency(rx, self._chan, self.carrier_freq)
        self._dev.setGain(rx, self._chan, self.gain)
        self._stream = self._dev.setupStream(rx, SoapySDR.SOAPY_SDR_CF32, [self._chan])
        self._dev.activateStream(self._stream)

    def read(self, out: np.ndarray) -> None:
        """Fill ``out`` (complex64 [block_size]) from the RX stream, looping
        over partial driver reads (``recv!`` semantics,
        ``AtomicAbstractSDRs.jl:293``).

        Routine stream conditions never kill the producer (reference parity:
        its producer loop survives everything, ``AtomicAbstractSDRs.jl:
        284-306``): SOAPY_SDR_TIMEOUT retries (a saturated USB bus or a
        slow-to-settle retune stalls briefly); SOAPY_SDR_OVERFLOW means the
        driver dropped samples — count it and keep draining, exactly the
        overwrite-oldest philosophy the host ring already applies.  Only
        genuinely fatal codes (stream error, corruption, device gone) — or
        ``timeout_limit`` *consecutive* timeouts, an unresponsive device —
        raise."""
        filled = 0
        n = out.shape[0]
        dry_reads = 0
        while filled < n:
            sr = self._dev.readStream(self._stream, [out[filled:]], n - filled)
            ret = getattr(sr, "ret", sr)
            if ret > 0:
                filled += ret
                dry_reads = 0
            elif ret == self._code_timeout or ret == 0:
                self.timeouts += 1
                dry_reads += 1
                if dry_reads >= self.timeout_limit:
                    raise RuntimeError(
                        f"SoapySDR device unresponsive: {dry_reads} "
                        f"consecutive timeouts on readStream"
                    )
            elif ret == self._code_overflow:
                self.overflows += 1  # samples lost in the driver; continue
                dry_reads = 0
            else:
                raise RuntimeError(f"SoapySDR readStream fatal error {ret}")

    # ------------------------------------------------------------ retuning
    def set_carrier(self, freq: float) -> None:
        """Retune the RX carrier live (``updateCarrierFreq!``, GUI.jl:609-633)."""
        self._dev.setFrequency(self._rx, self._chan, float(freq))
        self.carrier_freq = float(freq)

    def set_gain(self, gain: float) -> None:
        """Update RX gain live (``updateGain!``, GUI.jl:651-658)."""
        self._dev.setGain(self._rx, self._chan, float(gain))
        self.gain = float(gain)

    def set_sample_rate(self, rate: float) -> None:
        """Update the sample rate live (``updateSamplingRate!``,
        GUI.jl:636-648).  The caller must rebuild any program whose static
        shapes derive from the rate (StreamingRuntime does this on mode/rate
        swap)."""
        self._dev.setSampleRate(self._rx, self._chan, float(rate))
        self.sample_rate = float(rate)

    def close(self) -> None:
        if getattr(self, "_stream", None) is not None:
            self._dev.deactivateStream(self._stream)
            self._dev.closeStream(self._stream)
            self._stream = None


def open_source(
    kind: str,
    *,
    sample_rate: float,
    block_size: int,
    path: str | None = None,
    mode: VideoMode | None = None,
    carrier_freq: float = 764e6,
    gain: float = 50.0,
    fmt: str = "single",
    snr_db: float = 20.0,
    seed: int = 0,
) -> SampleSource:
    """Factory mirroring the reference's sdr-symbol dispatch
    (``GUI.jl:667-695``): ``radiosim``→ReplaySource, ``synthetic``→generator,
    hardware names→HardwareSource."""
    if kind in ("radiosim", "replay", "file"):
        if path is None:
            raise ValueError("replay source needs path=")
        return ReplaySource(path, sample_rate, block_size, fmt)
    if kind == "synthetic":
        if mode is None:
            raise ValueError("synthetic source needs mode=")
        return SyntheticSource(mode, sample_rate, block_size, snr_db=snr_db, seed=seed)
    return HardwareSource(kind, carrier_freq, sample_rate, gain, block_size)
