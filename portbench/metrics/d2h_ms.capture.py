"""d2h_ms.capture: device ms of device-to-host copies a capture (frames,
sync, score, images back), from the trace."""

from portbench.readings import layer_seconds


def read(run):
    s = layer_seconds(run, "d2h")
    return 1e3 * s / run.count if s is not None and run.count else None
