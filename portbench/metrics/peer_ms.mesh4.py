"""peer_ms.mesh4: device ms of copies between cards a dispatch (the spans
out, the EMA's and the frames' gathers back), from the trace."""

from portbench.readings import layer_seconds


def read(run):
    s = layer_seconds(run, "peer")
    return 1e3 * s / run.count if s is not None and run.count else None
