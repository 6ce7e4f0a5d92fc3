"""Native host core: C++ ring buffer + sample conversion, via ctypes.

Builds ``host_core.cpp`` into ``libhost_core.so`` on first import (g++, a few
hundred ms, cached under the package's git-ignored ``_build/``) and exposes it
through ctypes.  If no
compiler is available the callers fall back to the pure-Python/numpy
implementations (``tempest_tpu_torch.runtime.ring``) — same semantics, GIL held.

``NativeRing`` mirrors ``runtime.ring.RingBuffer``'s interface so the
streaming runtime can use either.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..utils.profiling import annotate

__all__ = ["load_host_core", "native_available", "NativeRing"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_core.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libhost_core.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-o", _LIB, _SRC, "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def load_host_core() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        c = ctypes
        lib.ring_create.restype = c.c_void_p
        lib.ring_create.argtypes = [c.c_int64, c.c_int64]
        lib.ring_destroy.argtypes = [c.c_void_p]
        lib.ring_put.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
        lib.ring_take.restype = c.c_int
        lib.ring_take.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_double]
        lib.ring_close.argtypes = [c.c_void_p]
        for name in ("ring_overflows", "ring_available", "ring_produced",
                     "ring_consumed", "ring_last_seq"):
            fn = getattr(lib, name)
            fn.restype = c.c_int64
            fn.argtypes = [c.c_void_p]
        lib.iq_int16_to_float32.argtypes = [
            c.POINTER(c.c_int16), c.POINTER(c.c_float), c.c_int64, c.c_float,
        ]
        lib.iq_envelope_f32.argtypes = [
            c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int64,
        ]
        lib.iq_power_f32.argtypes = [
            c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int64,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_host_core() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeRing:
    """ctypes wrapper over the C++ SPSC ring; interface-compatible with
    ``tempest_tpu_torch.runtime.ring.RingBuffer`` (put/take/close/overflows)."""

    def __init__(self, block_size: int, depth: int = 16) -> None:
        lib = load_host_core()
        if lib is None:
            raise RuntimeError("native host core unavailable (no g++?)")
        self._lib = lib
        self.block_size = int(block_size)      # complex samples per block
        self.depth = int(depth)
        self._floats = 2 * self.block_size
        self._handle = lib.ring_create(self._floats, self.depth)
        if not self._handle:
            raise MemoryError("ring_create failed")

    def put(self, block: np.ndarray) -> None:
        """block: complex64 [block_size] or float32 [2*block_size]."""
        view = self._as_float_view(block)
        self._lib.ring_put(self._handle, _fptr(view))

    def take(self, out: np.ndarray | None = None, timeout: float | None = None):
        if out is None:
            out = np.empty(self.block_size, np.complex64)
        view = self._as_float_view(out)
        t_ms = -1.0 if timeout is None else timeout * 1e3
        with annotate("ring.take"):
            ok = self._lib.ring_take(self._handle, _fptr(view), t_ms)
        return out if ok else None

    def _as_float_view(self, a: np.ndarray) -> np.ndarray:
        if a.dtype == np.complex64:
            v = a.view(np.float32)
        elif a.dtype == np.float32:
            v = a
        else:
            raise TypeError(f"ring blocks must be complex64 or float32, got {a.dtype}")
        if v.size != self._floats:
            raise ValueError(f"block size mismatch: {v.size} != {self._floats}")
        if not v.flags["C_CONTIGUOUS"]:
            # A silent np.ascontiguousarray copy would make ring_take fill a
            # temporary and return stale caller memory.
            raise ValueError("ring blocks must be C-contiguous")
        return v

    def close(self) -> None:
        if self._handle:
            self._lib.ring_close(self._handle)

    @property
    def overflows(self) -> int:
        return self._lib.ring_overflows(self._handle)

    @property
    def available(self) -> int:
        return self._lib.ring_available(self._handle)

    @property
    def last_seq(self) -> int:
        """Production sequence of the last block taken (-1 before any take) —
        lets consumers keep absolute stream position across overflow drops."""
        return self._lib.ring_last_seq(self._handle)

    @property
    def produced(self) -> int:
        """Total blocks put so far (see RingBuffer.produced)."""
        return self._lib.ring_produced(self._handle)

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ring_close(handle)
            self._lib.ring_destroy(handle)
            self._handle = None


def int16_iq_to_float32(words: np.ndarray, scale: float = 1.0 / (1 << 14)) -> np.ndarray:
    """Convert interleaved int16 I/Q words to float32 (native if possible)."""
    words = np.ascontiguousarray(words, np.int16)
    out = np.empty(words.size, np.float32)
    lib = load_host_core()
    if lib is not None:
        lib.iq_int16_to_float32(
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            _fptr(out), words.size, ctypes.c_float(scale),
        )
    else:
        np.multiply(words, scale, out=out, casting="unsafe")
    return out
