"""launches.combine3: device operations (kernels, copies, memsets) a block,
the combine front's and the step's, from the trace: the count a graph or a
fused front would cut."""

from portbench.readings import layer_ops


def read(run):
    ops = layer_ops(run, "launches")
    return len(ops) / run.count if ops and run.count else None
