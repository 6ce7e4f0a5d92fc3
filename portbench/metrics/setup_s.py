"""setup_s: seconds from the process's start to the window's start (imports,
the card's start, the kernels' build or load, the inputs made from the seed,
the warm-up), by the host's clock."""


def read(run):
    return run.setup_s
