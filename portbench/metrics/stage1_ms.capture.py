"""stage1_ms.capture: host ms of stage 1 a capture (the timing estimate and the
snap to a mode, ending with the mode on the host), from the program's span
``offline.stage1`` (``tempest_tpu_torch.utils.profiling``) over the run's
window (the first item's start to the last item's end, on ``perf_counter``,
the spans' clock): its mean over the spans there, one a capture. Nothing
where the program recorded no such span (a run without the tracer)."""

from math import ceil, floor


def read(run):
    try:
        from tempest_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the tracer's summary
        return None
    if not run.items:
        return None
    spans = summary(floor(run.items[0]["t0"] * 1e9), ceil(run.items[-1]["t1"] * 1e9))["spans"]
    s = spans.get("offline.stage1")
    return 1e3 * s["total_s"] / s["count"] if s else None
