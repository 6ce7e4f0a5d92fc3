"""Observability: first-class throughput metrics and device profiling.

The reference's observability is ad-hoc: wall-clock ``Rate`` meters printed
at exit (``AtomicAbstractSDRs.jl:199-268,333-341``) and FPS ``@info`` lines
(``GUI.jl:201-203``).  Here metrics are a structured API (the ring's
``RateMeter`` feeds this registry) and device-side profiling delegates to
``torch.profiler``: a Chrome trace per traced block, viewable in
``chrome://tracing`` or Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

__all__ = ["Metrics", "trace", "annotate"]


class Metrics:
    """Lightweight metric registry: counters + gauges + derived rates."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def rate(self, name: str) -> float:
        """Counter per second since creation."""
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self.counters.get(name, 0.0) / dt

    def snapshot(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "uptime_s": dt,
            "counters": dict(self.counters),
            "rates_per_s": {k: v / dt for k, v in self.counters.items()},
            "gauges": dict(self.gauges),
        }

    def json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    kernels where there is a card) for the enclosed block:

    >>> with trace("/tmp/tt_trace") as prof:
    ...     step(iq, ema, alpha)

    Writes ``<log_dir>/trace_<n>.json`` (Chrome trace format; ``n`` counts
    the traces already in the directory) and yields the profiler, whose
    ``key_averages()`` hold the times by kernel after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_") and f.endswith(".json"))
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{n}.json"))


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    return record_function(name)
