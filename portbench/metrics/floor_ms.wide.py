"""floor_ms.wide: host ms of the band scan's noise floor a call (`ops/scan.py`
`_noise_floor`, ending with the floor on the host: where the program measures the
floor once per geometry, the set-up's first call draws the surrogate normals on the
host, uploads and scores them, and a call in the window looks the floor up; where it
does not, every call draws, uploads and scores), from the program's span ``scan.floor``
(``tempest_tpu_torch.utils.profiling``) over the run's window (the first item's
start to the last item's end, on ``perf_counter``, the spans' clock): its mean over
the spans there, one a call. Nothing where the program recorded no such span (a run
without the tracer, or a program without the span)."""

from math import ceil, floor


def read(run):
    try:
        from tempest_tpu_torch.utils.profiling import summary
    except ImportError:  # a program without the tracer's summary
        return None
    if not run.items:
        return None
    spans = summary(floor(run.items[0]["t0"] * 1e9), ceil(run.items[-1]["t1"] * 1e9))["spans"]
    s = spans.get("scan.floor")
    return 1e3 * s["total_s"] / s["count"] if s else None
