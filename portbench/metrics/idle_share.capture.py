"""idle_share: percent of the traced window with no kernel or copy on a card (the union
of its operations), averaged over the cards, from the trace."""

from portbench.readings import idle_share


def read(run):
    return idle_share(run)
