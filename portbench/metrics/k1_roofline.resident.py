"""k1_roofline.resident: percent of K1's roofline a step: the least time of
its bytes and operations (``rooflines.k1_work`` from the cell's shapes) over
its device time, from the trace."""

from portbench.readings import roofline_share


def read(run):
    return roofline_share(run, "k1")
