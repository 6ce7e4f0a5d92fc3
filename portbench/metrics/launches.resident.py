"""launches.resident: device operations (kernels, copies, memsets) a step,
from the trace."""

from portbench.readings import layer_ops


def read(run):
    ops = layer_ops(run, "launches")
    return len(ops) / run.count if ops and run.count else None
