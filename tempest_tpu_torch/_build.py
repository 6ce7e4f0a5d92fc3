"""Build, load and launch the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface.  At first CUDA use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``tempest_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the flags so that an edited source rebuilds, and loaded with
``ctypes``.  Nothing here runs at import time.

Every launch of a hand-written kernel goes through :func:`launch`: it makes
the tensors' device current, passes the current stream, raises on a failed
launch, and keeps the one record of it, which the tracer's counters
(``launches.<kernel>``), a running :func:`~.utils.roofline.roofline` and
:func:`count_launches` read.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .utils import profiling, roofline

__all__ = ["load_library", "nvcc_path", "launch", "count_launches", "current_stream",
           "BUILD_DIR", "SOURCE_DIR"]

SOURCE_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures of the exported launchers: name -> (argtypes, restype).
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "resample": {
        "tt_resample_frames": (
            [_P, _LL, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P, _LL, _I,
             _P],
            ctypes.c_int),
        "tt_resample_frame": ([_P, _P, _LL, _F, _P, _P], ctypes.c_int),
        "tt_resample_candidates": (
            [_P, _LL, _P, _I, _P, _I, _I, _P, _I, _I, _I, _P], ctypes.c_int),
        "tt_fm_int16": ([_P, _LL, _P, _P], ctypes.c_int),
        "tt_fm_float32": ([_P, _LL, _P, _P], ctypes.c_int),
        "tt_words_max": ([_P, _LL, _I, _I, _I, _P, _P, _P, _P], ctypes.c_int),
    },
    "sync": {
        "tt_blanking_sync": (
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P,
             _P, _P],
            ctypes.c_int),
        "tt_blanking_sync_timed": (
            [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P,
             _P, _P, _P],
            ctypes.c_int),
        "tt_sync_clock_labels": ([], ctypes.c_char_p),
        "tt_sync_max_clusters": ([_I, _I, _P], ctypes.c_int),
    },
    "align_ema": {
        "tt_align_fold": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
            ctypes.c_int),
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, load it and
    declare the C signatures.  The compiler's report (registers, shared
    memory, spills) is kept on the returned object as ``build_log``."""
    src = SOURCE_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Compile to a private name and rename: a concurrent or interrupted
        # build never leaves a half-written library under the final name.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True, check=False,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.build_log = log
    lib.path = str(lib_path)
    return lib


def current_stream(device: torch.device) -> int:
    """The raw current CUDA stream of ``device``: what :func:`launch` passes."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# The launch counts that are open (count_launches), and the lock their
# updates take: launches come from several threads (a mesh's shards).
_COUNTS: list[collections.Counter] = []
_COUNTS_LOCK = threading.Lock()


def launch(kernel: str, launcher, device: torch.device, costs: tuple, variant: tuple | None,
           *args, after: tuple = ()) -> None:
    """Launch the kernel ``kernel`` (``k1``, ``k2``, ``k3``, ``words_max``,
    ``fm_check``): ``launcher(*args, stream, *after)``, a C launcher of
    :func:`load_library`, with ``device`` made current only where it is not
    and its current stream.  A nonzero return, a ``cudaError_t``, raises.

    ``costs`` are the launch's kernels, one ``(bytes, operations[,
    transcendentals])`` each (K2 is two, K2a and K2b); ``variant`` what
    tells its launches apart.  Only while one of them listens, each is fed:
    the tracer's counter ``launches.<kernel>`` by ``len(costs)``, every
    running roofline count by each cost, and every :func:`count_launches`
    by kernel and by ``(kernel, *variant)``.  Off the card (a stand-in
    library) no device is made current and the stream is null."""
    if device.type == "cuda":
        stream = current_stream(device)
        if device.index == torch.cuda.current_device():
            rc = launcher(*args, stream, *after)
        else:
            with torch.cuda.device(device):
                rc = launcher(*args, stream, *after)
    else:
        rc = launcher(*args, None, *after)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t {rc}")
    if _COUNTS or roofline._ACTIVE or profiling.enabled():
        _record(kernel, costs, variant)


def _record(kernel: str, costs: tuple, variant: tuple | None) -> None:
    n = len(costs)
    profiling.count("launches." + kernel, n)
    for cost in costs:
        roofline.report_launch(*cost)
    if not _COUNTS:
        return
    with _COUNTS_LOCK:
        for seen in _COUNTS:
            seen[kernel] += n
            if variant is not None:
                seen[(kernel, *variant)] += n


@contextlib.contextmanager
def count_launches():
    """Count the kernel launches inside the ``with`` block, on every thread:
    yields a ``Counter`` of them by kernel (``seen["k1"]``) and by kernel and
    variant (``seen["k3", "linear", True]``).  K1's variant is (taps,
    residuals given, *load): no load for an envelope, (demod, bfloat16
    rounding[, "invert"]) for I/Q words, ("frame",) for one frame and
    ("candidates",) for a candidate set; K3's (align, EMA folded); the FM
    checks' their words' type.  K2 counts two launches a call."""
    seen: collections.Counter = collections.Counter()
    with _COUNTS_LOCK:
        _COUNTS.append(seen)
    try:
        yield seen
    finally:
        with _COUNTS_LOCK:
            _COUNTS[:] = [c for c in _COUNTS if c is not seen]
