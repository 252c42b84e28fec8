"""The end-to-end arithmetic: the rate over the window's whole span, a
stall included, and the 95th percentile over every check."""

from __future__ import annotations

import statistics
import time

from portbench import run


class Sleeper:
    """An entry whose checks sleep; the `stall`-th sleeps longer."""

    def __init__(self, each, stall_at, stall):
        self.n, self.each, self.stall_at, self.stall = 0, each, stall_at, stall

    def check(self, history):
        time.sleep(self.stall if self.n == self.stall_at else self.each)
        self.n += 1
        return {"valid": True, "results": {}}

    @staticmethod
    def steps(result):
        return 0


def test_rate_divides_by_the_whole_span_with_a_stall():
    pool = [[("p", "invoke", "read", None, None)] * 10,
            [("p", "invoke", "read", None, None)] * 30]
    entry = Sleeper(0.01, 3, 0.3)

    def check(k, record=None):
        return run.run_check(entry, pool[k], k, lambda: None, {}, {})

    checks, span = run.window(check, len(pool), 0.2)
    r = run.Run({}, {}, {}, checks, span, 0.0)
    rate = run.END_TO_END["ops_checked_per_s"](r)
    assert rate == sum(c.events for c in checks) / span
    # the span runs from the window's start to the last check's end: the
    # stall inside it, the last check started within the seconds
    w0 = checks[-1].end - span
    assert checks[0].start - w0 < 0.05
    assert span >= sum(c.wall_s for c in checks) >= 0.3
    assert checks[-1].start - w0 < 0.2 < span
    # pool histories alternate, starting after the warm check's (0)
    assert [c.pool for c in checks[:4]] == [1, 0, 1, 0]


def test_p95_is_over_every_check():
    walls = [0.01] * 90 + [1.0] * 10
    checks = [run.Check(0, 1, 0.0, w, {}, ()) for w in walls]
    r = run.Run({}, {}, {}, checks, 2.0, 0.0)
    p = run.END_TO_END["check_p95_ms"](r)
    assert p == 1000 * statistics.quantiles(walls, n=100,
                                            method="inclusive")[94]
    assert p > 500  # the slowest tenth reaches the 95th percentile
    assert run.p95([3.0]) == 3.0
