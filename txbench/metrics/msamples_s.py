"""msamples_s: every IQ sample the cell's steps completed on the cards in
the window, over the window's whole time (host clock, the last step
waited for)."""


def read(run):
    if not run.window_s or not run.samples:
        return None
    return run.samples / run.window_s / 1e6
