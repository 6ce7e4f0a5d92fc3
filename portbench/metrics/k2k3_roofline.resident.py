"""k2k3_roofline.resident: percent of the roofline of K2 (both launches) and
K3 a step: the least time of their bytes and operations
(``rooflines.k2k3_work``) over their device time, from the trace."""

from portbench.readings import roofline_share


def read(run):
    return roofline_share(run, "k2k3")
