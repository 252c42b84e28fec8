"""What the device did in a traced window, read from `torch.profiler`.

The harness wraps its window in a profiler with CPU and CUDA activities,
the window in a `record_function` range named WINDOW and every check in
one named CHECK. `DeviceTrace.from_profile` keeps, on the profiler's own
clock (microseconds):

- `device`: the merged intervals in which some operation (a kernel, a
  copy, a memset) ran on the card, clipped to the window;
- `ops`: each device operation's name and length;
- `host`: the host-side events (operators, CUDA runtime calls, the
  harness's ranges), to name what the host did while the card idled;
- `checks`: the CHECK ranges, in order.

Device-side copies of the harness's own ranges (the profiler mirrors a
`record_function` on the GPU timeline) are not operations and are left
out by their PREFIX.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PREFIX = "portbench."
WINDOW = PREFIX + "window"
CHECK = PREFIX + "check"


def merge(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged, start, end) -> float:
    """Length of [start, end) that the disjoint `merged` intervals
    cover."""
    return sum(max(0.0, min(e, end) - max(s, start)) for s, e in merged)


@dataclass
class DeviceTrace:
    window: tuple
    device: list
    ops: list = field(default_factory=list)
    host: list = field(default_factory=list)
    checks: list = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> "DeviceTrace":
        """From (name, on_device, start_us, end_us) tuples."""
        window = None
        checks, host, ops = [], [], []
        for name, on_device, s, e in events:
            if on_device:
                if not name.startswith(PREFIX) and e > s:
                    ops.append((name, s, e))
            elif name == WINDOW:
                window = (s, e)
            else:
                if name == CHECK:
                    checks.append((s, e))
                host.append((name, s, e))
        if window is None:
            raise ValueError(f"no {WINDOW!r} range in the trace")
        ws, we = window
        ops = [(n, max(s, ws), min(e, we)) for n, s, e in ops
               if e > ws and s < we]
        return cls(window, merge((s, e) for _, s, e in ops), ops, host,
                   sorted(checks))

    @classmethod
    def from_profile(cls, prof) -> "DeviceTrace":
        from torch.autograd import DeviceType

        return cls.from_events(
            (e.name, e.device_type == DeviceType.CUDA,
             float(e.time_range.start), float(e.time_range.end))
            for e in prof.events())

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.device) / 1e6

    def busy_in(self, start, end) -> float:
        """Seconds of [start, end) (microseconds) in which the card ran
        some operation."""
        return covered(self.device, start, end) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...] of the device operations that took most
        time in the window, summed by name."""
        total: dict = {}
        for name, s, e in self.ops:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self) -> list:
        """(start, end) of every stretch of the window with nothing on the
        card."""
        out, t = [], self.window[0]
        for s, e in self.device:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if t < self.window[1]:
            out.append((t, self.window[1]))
        return out

    def host_at(self, t) -> str:
        """The innermost host event around instant `t`: what the host was
        doing then (the window itself when nothing narrower)."""
        best, width = WINDOW, float("inf")
        for name, s, e in self.host:
            if s <= t < e and e - s < width:
                best, width = name, e - s
        return best

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds], ...] of the `n` longest
        idle gaps, longest first."""
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return [[self.host_at((s + e) / 2), (e - s) / 1e6]
                for s, e in longest]
