"""Percent of the traced window in which no operation ran on the card:
one less the union of the device's operations over the window, from the
profiler's trace."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100 * (1 - t.busy_s / t.window_s)
