"""idle_share.combine3: percent of the traced window with no kernel or copy on
the card (the union of its operations), from the trace."""

from portbench.readings import idle_share


def read(run):
    return idle_share(run)
