"""GNURadio-compatible interleaved-IQ ``.dat`` capture files.

Re-implements the capability of the reference's ``DatBinaryFiles`` module
(``/root/reference/src/DatBinaryFiles.jl:15-66``): raw binary files of
interleaved real/imag words, in one of three formats —

* ``"short"``  : int16, values scaled to ±2**14 (rescaled by each component's
  max on write, like the reference),
* ``"single"`` : float32 (the GNURadio ``file_sink`` default),
* ``"double"`` : float64.

Reads always return complex64 for type stability (reference
``DatBinaryFiles.jl:63-65``).  On top of the reference's API we add offset /
count arguments and a memory-mapped block iterator so the streaming runtime can
replay multi-GB captures without loading them whole.
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np

__all__ = [
    "read_complex_binary",
    "write_complex_binary",
    "iter_complex_blocks",
    "num_samples",
]

_FORMATS: dict[str, tuple[np.dtype, int]] = {
    "short": (np.dtype(np.int16), 2),
    "single": (np.dtype(np.float32), 4),
    "double": (np.dtype(np.float64), 8),
}
_SHORT_SCALE = 1 << 14


def _dtype_for(fmt: str) -> np.dtype:
    try:
        return _FORMATS[fmt][0]
    except KeyError:
        raise ValueError(
            f"unsupported .dat format {fmt!r}; expected 'short', 'single' or 'double'"
        ) from None


def num_samples(path: str | os.PathLike, fmt: str = "single") -> int:
    """Number of complex samples stored in ``path``."""
    word = _dtype_for(fmt).itemsize
    return os.path.getsize(path) // (2 * word)


def write_complex_binary(
    x: np.ndarray, path: str | os.PathLike, fmt: str = "single"
) -> None:
    """Write complex samples as interleaved I/Q words
    (reference ``writeComplexBinary``, ``DatBinaryFiles.jl:15-31``)."""
    x = np.asarray(x)
    dtype = _dtype_for(fmt)
    out = np.empty(2 * x.size, dtype)
    re, im = np.real(x).ravel(), np.imag(x).ravel()
    if fmt == "short":
        # Reference normalises each component by its own max before scaling.
        re_max = np.max(re) if re.size else 1.0
        im_max = np.max(im) if im.size else 1.0
        out[0::2] = np.round(_SHORT_SCALE * re / (re_max if re_max != 0 else 1.0))
        out[1::2] = np.round(_SHORT_SCALE * im / (im_max if im_max != 0 else 1.0))
    else:
        out[0::2] = re
        out[1::2] = im
    out.tofile(os.fspath(path))


def read_complex_binary(
    path: str | os.PathLike,
    fmt: str = "single",
    count: int | None = None,
    offset: int = 0,
) -> np.ndarray:
    """Read complex samples; always returns complex64
    (reference ``readComplexBinary``, ``DatBinaryFiles.jl:44-66``).

    ``count`` limits the number of complex samples; ``offset`` skips complex
    samples from the start of the file (extension over the reference).
    """
    dtype = _dtype_for(fmt)
    word = dtype.itemsize
    n_words = -1 if count is None else 2 * count
    raw = np.fromfile(os.fspath(path), dtype, count=n_words, offset=2 * word * offset)
    if raw.size % 2:
        raw = raw[:-1]
    z = np.empty(raw.size // 2, np.complex64)
    z.real = raw[0::2]
    z.imag = raw[1::2]
    return z


def iter_complex_blocks(
    path: str | os.PathLike,
    block_size: int,
    fmt: str = "single",
    loop: bool = False,
) -> Iterator[np.ndarray]:
    """Yield successive ``block_size``-sample complex64 blocks from a capture
    via a read-only memory map.  With ``loop=True`` the file wraps around
    forever — the replay behaviour of the reference's ``:radiosim`` backend
    (``GUI.jl:367-373``).  The trailing partial block is dropped.
    """
    dtype = _dtype_for(fmt)
    mm = np.memmap(os.fspath(path), dtype=dtype, mode="r")
    total = mm.size // 2
    if total < block_size:
        raise ValueError(
            f"capture has {total} samples, smaller than one block ({block_size})"
        )
    while True:
        for start in range(0, total - block_size + 1, block_size):
            raw = mm[2 * start : 2 * (start + block_size)]
            z = np.empty(block_size, np.complex64)
            z.real = raw[0::2]
            z.imag = raw[1::2]
            yield z
        if not loop:
            return
