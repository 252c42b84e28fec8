"""Milliseconds a check spends in the interpreter's cyclic garbage
collector (its generation scans over the objects the check keeps alive),
mean over the window's checks, on the host's clock (`run.Collector`)."""


def read(run):
    gc_s = [c.gc_s for c in run.checks if c.gc_s is not None]
    if not gc_s:
        return None
    return 1000 * sum(gc_s) / len(gc_s)
