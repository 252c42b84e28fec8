"""What the per-layer metrics' readers (metrics/<name>.py) share.

A reader is `read(run) -> float | None`, given the run's `run.Run`:
its window's checks, the profiler's `devtrace.DeviceTrace`, the
kernels' timed and captured launches and the program's counters. It
returns None when the run gave it nothing to read, and the harness then
leaves its metric out of the result line.
"""

from __future__ import annotations

from . import bounds


def roofline_share(run, kernel: str, bound) -> float | None:
    """Percent of the least time the captured launches of `kernel` could
    take (the larger of their byte and operation bounds, summed) in the
    time they took on the card (their CUDA events, summed). Each captured
    launch is replayed once after the window, for the steps and depths
    its bound counts; a search is deterministic, so the replay takes the
    steps the timed launch took. `bound(launch, out)` gives a launch's
    (seconds for the bytes, seconds for the operations)."""
    import torch

    log = run.kernels.get(kernel)
    if log is None:
        return None
    least_s = took_ms = 0.0
    for launch, (start, end) in zip(log.captured, log.timed):
        out = log.module.search(*launch)
        torch.cuda.synchronize()
        least_s += max(bound(launch, out))
        took_ms += start.elapsed_time(end)
    if took_ms <= 0:
        return None
    return 100 * least_s * 1000 / took_ms


def bound_vec(launch, out) -> tuple:
    packed, _, jm, n_pad, n_state, _ = launch
    small = out[0].cpu()
    return bounds.bound_vec(packed.numel(), packed.shape[1], n_pad,
                            int(small[1].sum()),
                            bounds.vec_key_words(jm.name, n_pad, n_state))


def host_ms_per_check(run) -> float | None:
    """Mean milliseconds of a check's wall (its profiler range) in which
    nothing ran on the card."""
    t = run.trace
    if t is None or not t.device or not t.checks:
        return None
    return sum((e - s) / 1e3 - 1e3 * t.busy_in(s, e)
               for s, e in t.checks) / len(t.checks)
