"""resident_msps: samples of every step issued in the window over the window's
length, the window fenced once at its end (Msamples/s), by the host's clock."""


def read(run):
    if run.traced or not run.items:
        return None
    return run.samples / run.window_s / 1e6
