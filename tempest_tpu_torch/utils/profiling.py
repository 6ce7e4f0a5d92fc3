"""Observability: the program's spans and counters, and device profiling.

The reference's observability is ad-hoc: wall-clock ``Rate`` meters printed
at exit (``AtomicAbstractSDRs.jl:199-268,333-341``) and FPS ``@info`` lines
(``GUI.jl:201-203``).  Here the port records its own spans and counters at
its layer boundaries (the ring's take and put, the runtime's block and its
combine front, the step's cuts, upload and launches and its plan's builds
and reuses, ``auto_reconstruct``'s and
``combined_reconstruct``'s stages, the band scan's and the fusion's parts,
the mesh's placement and shards, the kernels' launches), and device-side profiling
delegates to ``torch.profiler``: a Chrome trace per traced block, viewable
in ``chrome://tracing`` or Perfetto.

* ``annotate(name, request=None)`` is the program's span.  The tracer is on
  while :func:`enable` is in force and while a ``torch.profiler`` session
  (``trace()`` among them) is recording.  Off, a span is one check of those
  two flags and a shared no-op context: no clock read, no allocation, no
  profiler range.  On, it records ``(name, start, end)`` on
  ``time.perf_counter_ns``, the span it nests in (a stack a thread), its
  request id (the parent's where not given) and its thread, in a bounded
  buffer; under a recording profiler it also opens a range ``name`` of the
  profiler (its fast record function where torch has it), so the span stands on the profiler's
  clock beside the device's operations.
* ``count(name, n)`` adds to a counter, only while the tracer is on: it
  feeds one :class:`Metrics` (:func:`metrics`) and a bounded buffer of
  timed counts.  Nothing else feeds ``Metrics``; the ring's ``RateMeter``
  keeps its own rates for ``health()``.
* :func:`summary` gives, a span name, the count, total and self seconds (the
  span's time less its child spans') and the median and 95th percentile,
  with the counters, over a window of ``perf_counter_ns``; :func:`records`
  gives the spans themselves.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

_autograd_profiler = torch.autograd.profiler

__all__ = ["Metrics", "trace", "annotate", "count", "enable", "disable", "enabled", "reset",
           "records", "summary", "metrics", "SpanRecord"]


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


class SpanRecord(NamedTuple):
    """One closed span: times in ``perf_counter_ns``; ``parent`` is the
    ``id`` of the span it nested in on its thread (-1 at the top)."""

    name: str
    t0: int
    t1: int
    id: int
    parent: int
    request: object
    thread: int


# Records kept: the newest of them, the oldest dropped.
BUFFER = 65536

_on = False
_records: collections.deque = collections.deque(maxlen=BUFFER)
_counts: collections.deque = collections.deque(maxlen=BUFFER)   # (t ns, name, n)
_metrics = Metrics()
_metrics_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


def enable() -> None:
    """Turn the tracer on (until :func:`disable`)."""
    global _on
    _on = True


def disable() -> None:
    """Turn off what :func:`enable` turned on; a recording profiler keeps the
    tracer on while it records."""
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans and counts are recorded now."""
    return _on or _autograd_profiler._is_profiler_enabled


def reset() -> None:
    """Drop every record and count."""
    global _metrics
    _records.clear()
    _counts.clear()
    with _metrics_lock:
        _metrics = Metrics()


def metrics() -> Metrics:
    """The counters that :func:`count` fed since the last :func:`reset`."""
    return _metrics


def _profiler_range(name: str):
    """A range ``name`` of the recording profiler: its fast record function
    (a C++ context, about 2 µs where ``torch.profiler.record_function``
    takes about 15), where this torch has it."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(name) if fast is not None else torch.profiler.record_function(name)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span of a tracer that is off: enters and leaves doing nothing,
    and takes no request."""

    __slots__ = ()
    request = property(lambda self: None, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


class _Span:
    """An open span of a tracer that is on (see :func:`annotate`)."""

    __slots__ = ("name", "request", "id", "parent", "t0", "_range")

    def __init__(self, name: str, request) -> None:
        self.name = name
        self.request = request

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.request is None:
                self.request = top.request
        else:
            self.parent = -1
        self.id = next(_ids)
        stack.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _profiler_range(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        _stack().pop()
        _records.append(SpanRecord(self.name, self.t0, t1, self.id, self.parent, self.request,
                                   threading.get_ident()))
        return None


def annotate(name: str, request=None):
    """The program's span ``name`` around a ``with`` block (see the module's
    docstring): a no-op context while the tracer is off.  ``request`` is the
    id the span's work belongs to; the context's ``request`` may be set
    inside the block, where the id is learnt there (a ring's take)."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, request)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while the tracer is on."""
    if not (_on or _autograd_profiler._is_profiler_enabled):
        return
    with _metrics_lock:
        _metrics.count(name, n)
    _counts.append((time.perf_counter_ns(), name, n))


def _inside(t0: int, t1: int, since_ns: int | None, until_ns: int | None) -> bool:
    return (since_ns is None or t0 >= since_ns) and (until_ns is None or t1 <= until_ns)


def records(since_ns: int | None = None, until_ns: int | None = None) -> list[SpanRecord]:
    """The closed spans kept that lie inside ``[since_ns, until_ns]``
    (``perf_counter_ns``; None leaves a side open), in the order they
    closed."""
    return [r for r in list(_records) if _inside(r.t0, r.t1, since_ns, until_ns)]


def _quantile(values: list, q: float) -> float:
    """The ``q`` quantile of sorted ``values`` by linear interpolation
    between ranks."""
    pos = q * (len(values) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def summary(since_ns: int | None = None, until_ns: int | None = None) -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s", "p50_s",
    "p95_s"}}, "counters": {name: total}}`` of the spans and counts kept
    inside ``[since_ns, until_ns]``.  A span's self time is its time less
    that of the spans nested directly in it."""
    spans = records(since_ns, until_ns)
    child_ns: collections.Counter = collections.Counter()
    for r in spans:
        child_ns[r.parent] += r.t1 - r.t0
    by_name: dict[str, list] = collections.defaultdict(list)
    for r in spans:
        by_name[r.name].append(r)
    out = {}
    for name, rs in by_name.items():
        times = sorted((r.t1 - r.t0) * 1e-9 for r in rs)
        out[name] = {
            "count": len(rs),
            "total_s": sum(times),
            "self_s": sum(r.t1 - r.t0 - child_ns[r.id] for r in rs) * 1e-9,
            "p50_s": _quantile(times, 0.5),
            "p95_s": _quantile(times, 0.95),
        }
    counters: collections.Counter = collections.Counter()
    for t, name, n in list(_counts):
        if _inside(t, t, since_ns, until_ns):
            counters[name] += n
    return {"spans": out, "counters": dict(counters)}
