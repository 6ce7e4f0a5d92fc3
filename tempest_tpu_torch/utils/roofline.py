"""Per-kernel roofline accounting on the card.

``roofline(fn, *args)`` runs ``fn`` once under a ``TorchDispatchMode`` that
sees every ATen operation, and reports the floating-point operations and the
bytes accessed, the arithmetic intensity, and — given the card's peaks —
which roof binds and the speed-of-light time.  Pair with a measured time
(CUDA events around fenced calls) to get the achieved fraction of peak.

How it counts.  Bytes: every tensor an operation reads and every tensor it
writes, at its full size, once per operation; operations that only return a
view of their input move nothing and count nothing.  This is an UPPER bound
on device-memory traffic, as a compiler's cost model is: a cache that serves
a second read, or an index operation that touches a fraction of its source,
is charged in full.  FLOPs: matrix products and convolutions by
``torch.utils.flop_counter``'s formulas, FFTs as ``5·N·log2 N`` per
transform, every other operation on floating-point data as one operation
per output element.  Trust measured times for rankings.

The hand-written kernels are no ATen operations (they are launched through
``ctypes``), so the dispatch mode cannot see them: the launch boundary
(``_build.launch``) reports each kernel's cost (``report_launch``, once a
kernel) as its wrapper gives it, from the same function that gives its
bound: K1's ``ops.resample_kernel.launch_cost``, K2's
``ops.sync_kernel.launch_cost`` (reported as its two launches, K2a reading
the screens and K2b the rest) and K3's ``ops.align_kernel.launch_cost``.  The small torch operations around them
(K3's shift and fold weights) are ATen operations and counted as such.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["RooflineReport", "roofline", "report_launch", "H100_PEAKS"]

# One NVIDIA H100 SXM at its full 700 W power limit, dense rates (NVIDIA H100
# Tensor Core GPU data sheet): float32 outside the tensor cores 67 TFLOP/s,
# HBM3 3.35 TB/s.  The port's arithmetic is float32 outside the tensor cores,
# so that rate is the compute roof.
H100_PEAKS = {
    "flops_per_s": 67e12,
    "bytes_per_s": 3.35e12,
}


@dataclasses.dataclass
class RooflineReport:
    flops: float
    bytes_accessed: float
    transcendentals: float
    # Of the two totals above, what the hand-written kernels reported.
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_launches: int = 0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed else float("inf")

    def bound(self, peaks: dict = H100_PEAKS) -> str:
        ridge = peaks["flops_per_s"] / peaks["bytes_per_s"]
        return "compute" if self.arithmetic_intensity >= ridge else "memory"

    def speed_of_light_s(self, peaks: dict = H100_PEAKS) -> float:
        """Lower-bound execution time from whichever roof binds."""
        return max(
            self.flops / peaks["flops_per_s"],
            self.bytes_accessed / peaks["bytes_per_s"],
        )

    def achieved_fraction(self, measured_s: float, peaks: dict = H100_PEAKS) -> float:
        sol = self.speed_of_light_s(peaks)
        return sol / measured_s if measured_s > 0 else 0.0

    def summary(self, measured_s: float | None = None) -> str:
        parts = [
            f"{self.flops/1e9:.2f} GFLOP",
            f"{self.bytes_accessed/1e9:.3f} GB accessed",
            f"AI {self.arithmetic_intensity:.2f} flop/B",
            f"{self.bound()}-bound",
            f"speed-of-light {self.speed_of_light_s()*1e3:.3f} ms",
        ]
        if measured_s is not None:
            parts.append(
                f"measured {measured_s*1e3:.3f} ms "
                f"({100*self.achieved_fraction(measured_s):.1f}% of roof)"
            )
        return " | ".join(parts)


_TRANSCENDENTAL = (
    "sqrt", "rsqrt", "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos",
    "tan", "atan", "atan2", "asin", "acos", "sinh", "cosh", "tanh", "pow", "sigmoid", "erf",
    "hypot", "angle",
)


class _CostCount(TorchDispatchMode):
    """Adds up the cost of every ATen operation run under it, and of every
    kernel launch reported to it."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_launches = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or _returns_view(func):
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        out_ptrs = {t.data_ptr() for t in outs}
        # An in-place operation returns its own input: charge it once.
        self.bytes += sum(_nbytes(t) for t in ins if t.data_ptr() not in out_ptrs)
        self.bytes += sum(_nbytes(t) for t in outs)
        name = func.overloadpacket.__name__ if hasattr(func, "overloadpacket") else str(func)
        elems = sum(t.numel() for t in outs if t.is_floating_point() or t.is_complex())
        if name.startswith("_fft_"):
            n = max(max((t.numel() for t in ins), default=1), elems, 2)
            self.flops += 5.0 * n * math.log2(n)
        elif name in _PRODUCTS:
            self.flops += _PRODUCTS[name](ins, outs)
        else:
            self.flops += elems
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += elems
        return out

    def add_launch(self, nbytes: float, flops: float, transcendentals: float) -> None:
        self.bytes += nbytes
        self.flops += flops
        self.transcendentals += transcendentals
        self.kernel_bytes += nbytes
        self.kernel_flops += flops
        self.kernel_launches += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _returns_view(func) -> bool:
    """Whether every tensor ``func`` returns aliases an input without being
    written (``view``, ``slice``, ``transpose``, ...): no bytes move."""
    schema = getattr(func, "_schema", None)
    if schema is None or not schema.returns:
        return False
    return all(r.alias_info is not None and not r.alias_info.is_write for r in schema.returns)


def _mm_flops(ins, outs) -> float:
    # (..., m, k) @ (..., k, n): 2·k operations per output element.
    k = ins[-2].shape[-1] if len(ins) >= 2 else 1
    return 2.0 * k * outs[0].numel()


def _conv_flops(ins, outs) -> float:
    weight = ins[1]
    return 2.0 * outs[0].numel() * weight[0].numel()


_PRODUCTS = {
    "mm": _mm_flops, "bmm": _mm_flops, "matmul": _mm_flops, "mv": _mm_flops, "dot": _mm_flops,
    "addmm": _mm_flops, "baddbmm": _mm_flops,
    "convolution": _conv_flops, "_convolution": _conv_flops,
}

# The cost counts that are running, innermost last.
_ACTIVE: list[_CostCount] = []


def report_launch(nbytes: float, flops: float, transcendentals: float = 0.0) -> None:
    """The launch boundary calls this once a kernel launched, with its bytes
    (inputs read once, outputs written once) and operations; it is added to
    every roofline count that is running."""
    for count in _ACTIVE:
        count.add_launch(nbytes, flops, transcendentals)


def roofline(fn, *args, **kwargs) -> RooflineReport:
    """Run ``fn(*args, **kwargs)`` once and report what it cost: the ATen
    operations it dispatched and the kernel launches its wrappers reported."""
    count = _CostCount()
    _ACTIVE.append(count)
    try:
        with count:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(count)
    return RooflineReport(
        flops=count.flops,
        bytes_accessed=count.bytes,
        transcendentals=count.transcendentals,
        kernel_flops=count.kernel_flops,
        kernel_bytes=count.kernel_bytes,
        kernel_launches=count.kernel_launches,
    )
