"""front_ms.combine3: host ms of the live combine front a block (the
channeliser, the demod, the comb dots and the fusion issued), from the
program's span ``runtime.combine`` (``tempest_tpu_torch.utils.profiling``)
over the run's window (the first item's start to the last item's end, on
``perf_counter``, the spans' clock): its mean over the spans there, one a
block. Nothing where the program recorded no such span (a run without the
tracer, or a program without the span)."""

from math import ceil, floor


def read(run):
    try:
        from tempest_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the tracer's summary
        return None
    if not run.items:
        return None
    spans = summary(floor(run.items[0]["t0"] * 1e9), ceil(run.items[-1]["t1"] * 1e9))["spans"]
    s = spans.get("runtime.combine")
    return 1e3 * s["total_s"] / s["count"] if s else None
