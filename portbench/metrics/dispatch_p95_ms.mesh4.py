"""dispatch_p95_ms.mesh4: the 95th percentile, over the traced window's
dispatches, of the time from the take of the dispatched block from the ring
to its EMA image at the sink (ms), by the host's clock.  The mesh dispatches
a block when the next one is taken, so this holds one take more than a
single card's block."""

from portbench.readings import quantile


def read(run):
    if not run.items:
        return None
    return 1e3 * quantile([i["t1"] - i["t0"] for i in run.items], 0.95)
