"""capture_s: seconds from the window's start to the end of its last whole
capture, over the captures completed in that time, by the host's clock."""


def read(run):
    if run.traced or not run.items:
        return None
    return run.window_s / run.count
