"""What a metric's reader reads: the ``Run`` record of one run, and the
helpers the readers share.

A reader is ``metrics/<name>.py`` with ``read(run) -> float | None``; it
returns ``None`` where its run has nothing for it to read (a device metric
in a run without a trace, a layer with no operation in the trace), and the
harness then leaves the metric out of the result.
"""

from __future__ import annotations

import dataclasses
import math

from .rooflines import bound_seconds
from .tracing import busy_seconds

__all__ = ["Run", "quantile", "layer_ops", "layer_seconds", "idle_share", "roofline_share"]


@dataclasses.dataclass
class Run:
    window_s: float                          # the measured window, host clock
    items: list                              # completed items: {"t0", "t1", "samples"}
    spans: dict                              # span name -> host seconds, one a call
    layers: dict                             # layers.json
    work: dict                               # layer -> (bytes, flops, launches) of one item
    traced: bool = False
    device_ops: list = dataclasses.field(default_factory=list)  # (name, start µs, end µs, device)
    window_us: tuple | None = None           # the traced window on the profiler's clock
    setup_s: float = 0.0                     # process start to the window's start

    @property
    def count(self) -> int:
        return len(self.items)

    @property
    def samples(self) -> int:
        return sum(int(i["samples"]) for i in self.items)


def quantile(values, q: float) -> float | None:
    """The ``q`` quantile (0..1) by linear interpolation between ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def layer_ops(run: Run, layer: str) -> list:
    """The traced device operations whose name holds one of the layer's
    patterns in ``layers.json``."""
    patterns = run.layers["device"][layer]
    return [op for op in run.device_ops if any(p in op[0] for p in patterns)]


def layer_seconds(run: Run, layer: str) -> float | None:
    """Device seconds of a layer's operations over the traced window, or
    ``None`` where it ran none."""
    ops = layer_ops(run, layer)
    return sum((e - s) for _, s, e, _ in ops) * 1e-6 if ops else None


def idle_share(run: Run) -> float | None:
    """Percent of the traced window with no operation on a card, averaged
    over the cards that ran one."""
    if not run.traced or not run.device_ops or run.window_us is None:
        return None
    start, end = run.window_us
    return 100.0 * (1.0 - busy_seconds(run.device_ops, run.window_us) / ((end - start) * 1e-6))


def roofline_share(run: Run, layer: str) -> float | None:
    """Percent: the least time of the layer's work in one item over the
    layer's device time in one item, taken as its mean time a launch times
    its launches an item (a profiler that drops an event now and then then
    drops it from both counts)."""
    ops = layer_ops(run, layer)
    if not ops or layer not in run.work:
        return None
    nbytes, flops, launches = run.work[layer]
    per_item = sum((e - s) for _, s, e, _ in ops) * 1e-6 / len(ops) * launches
    return 100.0 * bound_seconds((nbytes, flops)) / per_item
