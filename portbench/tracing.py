"""Spans, the profiler window and what is read from its trace.

Spans are taken from the benchmark's own files: ``Spans.timed(name)`` around
a call an entry makes, and ``Spans.wrap_functions(entries)`` for the public
functions of the port that ``layers.json`` names (the module attribute is
replaced by a wrapper for the run and put back after it).  A span keeps its
host seconds; in a traced run it is also a ``record_function`` range of the
profiler, so that an idle gap of the device can be named by what the host
was doing.  A span marked ``fence`` waits for the card before it closes.

``Profile`` runs ``torch.profiler`` over the traced window and keeps the
device operations (kernels, copies, memsets) as (name, start µs, end µs,
device index) and the host ranges, from the profiler's event list: no
Chrome trace is written.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import importlib
import time

import torch

__all__ = ["Spans", "Profile", "union_seconds", "busy_seconds", "breakdown", "short_name"]


class Spans:
    """Host seconds of named spans, kept in memory."""

    def __init__(self, device: torch.device, traced: bool) -> None:
        self.device = device
        self.traced = traced
        self.seconds: dict[str, list[float]] = collections.defaultdict(list)
        self._restore: list = []

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def timed(self, name: str, fence: bool = False):
        rf = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if fence:
                    self._fence()
                self.seconds[name].append(time.perf_counter() - t0)

    def wrap(self, fn, name: str, fence: bool = False):
        spans = self

        def wrapper(*args, **kwargs):
            with spans.timed(name, fence):
                return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        return wrapper

    def wrap_functions(self, entries: list) -> None:
        """Replace each ``{"span", "module", "attr", "fence"}`` entry's module
        attribute with a timed wrapper; a missing one is left out (its span
        then reads nothing)."""
        for e in entries:
            try:
                module = importlib.import_module(e["module"])
                fn = getattr(module, e["attr"])
            except (ImportError, AttributeError):
                continue
            setattr(module, e["attr"], self.wrap(fn, e["span"], bool(e.get("fence", False))))
            self._restore.append((module, e["attr"], fn))

    def unwrap(self) -> None:
        for module, attr, fn in reversed(self._restore):
            setattr(module, attr, fn)
        self._restore.clear()


def short_name(name: str, limit: int = 96) -> str:
    """A device operation's name without its parameter list."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:limit]


class Profile:
    """The traced window's device operations and host ranges."""

    def __init__(self, device: torch.device, enabled: bool) -> None:
        self.enabled = enabled and device.type == "cuda"
        self.device_ops: list[tuple[str, float, float, int]] = []
        self.host_ranges: list[tuple[str, float, float]] = []
        self.window_us: tuple[float, float] | None = None

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        # The profiler's first session in a process starts its tracing on
        # each card: a session on every card first, out of the window.
        with torch.profiler.profile(activities=acts):
            for d in range(torch.cuda.device_count()):
                torch.ones(1, device=d).add_(1)
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("portbench.window"):
                yield
        self._read(prof)

    def _read(self, prof) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        # A record_function range also appears on the device's timeline (a
        # user annotation spanning its kernels): it is no operation.
        ranges = {e.name for e in prof.events() if e.device_type != cuda}
        for e in prof.events():
            start, end = float(e.time_range.start), float(e.time_range.end)
            if e.device_type == cuda:
                if not getattr(e, "is_user_annotation", False) and e.name not in ranges:
                    self.device_ops.append((e.name, start, end, int(e.device_index)))
            elif e.name == "portbench.window":
                self.window_us = (start, end)
            else:
                self.host_ranges.append((e.name, start, end))


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Seconds covered by the union of (start µs, end µs) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def busy_seconds(ops: list, window: tuple[float, float]) -> float:
    """Busy seconds of the window, averaged over the devices that ran an
    operation in it."""
    start, end = window
    per_device: dict[int, list] = collections.defaultdict(list)
    for _, s, e, d in ops:
        if e > start and s < end:
            per_device[d].append((max(s, start), min(e, end)))
    if not per_device:
        return 0.0
    return sum(union_seconds(v) for v in per_device.values()) / len(per_device)


def _gaps(ops: list, window: tuple[float, float]):
    """Idle intervals of the devices' union inside the window."""
    out, t = [], window[0]
    for _, s, e, _ in sorted(ops, key=lambda x: x[1]):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def breakdown(profile: Profile, top: int = 10) -> dict | None:
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[host activity, s],
    ...]}``: device time by operation, and idle time by what the host was
    doing: the shortest host range that holds the gap's middle."""
    if not profile.device_ops or profile.window_us is None:
        return None
    by_op = collections.Counter()
    for name, s, e, _ in profile.device_ops:
        by_op[short_name(name)] += (e - s) * 1e-6
    by_host = collections.Counter()
    hosts = sorted(profile.host_ranges, key=lambda x: x[1])
    starts = [s for _, s, _ in hosts]
    longest = max((e - s for _, s, e in hosts), default=0.0)
    for gs, ge in _gaps(profile.device_ops, profile.window_us):
        mid = 0.5 * (gs + ge)
        best, best_len = "untraced host time", None
        for name, s, e in hosts[bisect.bisect_left(starts, mid - longest):]:
            if s > mid:
                break
            if e >= mid and (best_len is None or e - s < best_len):
                best, best_len = name, e - s
        by_host[short_name(best)] += (ge - gs) * 1e-6
    return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
            "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}
