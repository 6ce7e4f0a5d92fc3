"""front_device_ms.combine3: device ms a block of the live combine front's
operations (the channeliser's FFTs and band slices, the demod, the comb
dots, the fusion), from the trace: every traced device operation that is
not of the step, whose layers ``layers.json`` names (``k1``, ``k2k3``, and
``h2d``, the upload of the block's cuts), over the blocks of the window."""

from portbench.readings import layer_ops

STEP_LAYERS = ("k1", "k2k3", "h2d")


def read(run):
    if not run.device_ops or not run.count:
        return None
    step = {id(op) for layer in STEP_LAYERS for op in layer_ops(run, layer)}
    ops = [op for op in run.device_ops if id(op) not in step]
    if not ops:
        return None
    return 1e3 * sum(e - s for _, s, e, _ in ops) * 1e-6 / run.count
