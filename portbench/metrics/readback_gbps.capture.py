"""readback_gbps.capture: GB/s of the read-back, the program's counter
``offline.readback.bytes`` (image, frames, sync and score) over its span
``offline.readback`` (``tempest_tpu_torch.utils.profiling``), both summed
over the run's window (the first item's start to the last item's end, on
``perf_counter``, the spans' clock).  Nothing where the program recorded no
such span (a run without the tracer)."""

from math import ceil, floor


def read(run):
    try:
        from tempest_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the tracer's summary
        return None
    if not run.items:
        return None
    got = summary(floor(run.items[0]["t0"] * 1e9), ceil(run.items[-1]["t1"] * 1e9))
    s = got["spans"].get("offline.readback")
    nbytes = got["counters"].get("offline.readback.bytes")
    return nbytes / s["total_s"] / 1e9 if s and nbytes else None
