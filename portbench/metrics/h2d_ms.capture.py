"""h2d_ms.capture: device ms of host-to-device copies a capture (the words up), from the
trace."""

from portbench.readings import layer_seconds


def read(run):
    s = layer_seconds(run, "h2d")
    return 1e3 * s / run.count if s is not None and run.count else None
