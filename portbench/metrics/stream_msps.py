"""stream_msps: source samples of every block taken and dispatched in the
window whose EMA image reached the sink in it, over the window's length
(Msamples/s), by the host's clock."""


def read(run):
    if run.traced or not run.items:
        return None
    return run.samples / run.window_s / 1e6
