"""List-append workload: transactions of appends and whole-list reads
(the port's copy of `jepsen_tpu/workloads/list_append.py`; reference:
Elle's list-append test, elle.list-append; jepsen's append workload).

Each micro-op is [f, k, v] with f "append" (push v onto key k's list)
or "r" (read the whole list). Because reads return the complete list,
the per-key version order is recoverable exactly from the observed
prefixes — the richest inference path the cycle checker
(checker/cycle) supports, turning ww/wr/rw edges into Adya anomalies
via matrix closure (ops/closure.py on the card).

Besides the live generator, `simulate` produces a seeded serializable
history (invoke/ok pairs, no cluster needed) with optional injected
G1c / G-single anomalies on dedicated keys — the acceptance fixture of
the tests and of chip_smoke.py. The same seed gives the same history
as the JAX package's `simulate`.
"""

from __future__ import annotations

import itertools
import random
import threading

from .. import txn as mop
from ..checker import cycle
from ..history import Op, index as _index

DEFAULT_ANOMALIES = ("G0", "G1c", "G-single", "G2")


class ListAppendGen:
    """Random txns of 1..max_txn_len micro-ops over a rolling key
    window; append values are unique per key (a counter), which the
    inference requires."""

    def __init__(self, keys: int = 16, max_txn_len: int = 4,
                 read_ratio: float = 0.5, seed: int | None = None):
        self.keys = keys
        self.max_txn_len = max_txn_len
        self.read_ratio = read_ratio
        self._rng = random.Random(seed)
        self._counters: dict = {}
        self._lock = threading.Lock()

    def _next_value(self, k) -> int:
        c = self._counters.setdefault(k, itertools.count(1))
        return next(c)

    def op(self, test, process):
        with self._lock:
            n = self._rng.randint(1, self.max_txn_len)
            t = []
            for _ in range(n):
                k = self._rng.randrange(self.keys)
                if self._rng.random() < self.read_ratio:
                    t.append([mop.READ, k, None])
                else:
                    t.append([mop.APPEND, k, self._next_value(k)])
            return {"type": "invoke", "f": "txn", "value": t}


def checker(anomalies=DEFAULT_ANOMALIES, **kw) -> cycle.CycleChecker:
    """The cycle checker parameterized for list-append histories."""
    return cycle.checker(anomalies, **kw)


# ---------------------------------------------------------------------------
# Seeded simulation (no cluster)

def _emit(h, proc, value_in, value_out):
    h.append(Op(proc, "invoke", "txn", value_in))
    h.append(Op(proc, "ok", "txn", value_out))


def inject_g1c(h, proc, key_a, key_b) -> None:
    """A circular-information-flow pair on two fresh keys: each txn
    appends one value and reads the OTHER txn's append — mutual wr
    edges, a two-cycle in ww|wr (anomalies.py G1c)."""
    _emit(h, proc,
          [[mop.APPEND, key_a, 1], [mop.READ, key_b, None]],
          [[mop.APPEND, key_a, 1], [mop.READ, key_b, [1]]])
    _emit(h, proc,
          [[mop.APPEND, key_b, 1], [mop.READ, key_a, None]],
          [[mop.APPEND, key_b, 1], [mop.READ, key_a, [1]]])


def inject_g_single(h, proc, key_x, key_y) -> None:
    """Read skew on two fresh keys: T2 appends to both; T1 misses the
    x append (rw T1->T2) but observes the y append (wr T2->T1) —
    a cycle with exactly one rw. A trailing read makes the missed x
    version observed, which the prefix inference needs to position
    it."""
    _emit(h, proc,
          [[mop.APPEND, key_x, 1], [mop.APPEND, key_y, 1]],
          [[mop.APPEND, key_x, 1], [mop.APPEND, key_y, 1]])
    _emit(h, proc,
          [[mop.READ, key_x, None], [mop.READ, key_y, None]],
          [[mop.READ, key_x, []], [mop.READ, key_y, [1]]])
    _emit(h, proc,
          [[mop.READ, key_x, None]],
          [[mop.READ, key_x, [1]]])


def simulate(n_ops: int = 5000, seed: int = 0, keys: int = 32,
             processes: int = 5, max_txn_len: int = 4,
             read_ratio: float = 0.5,
             inject=("G1c", "G-single")) -> list:
    """A seeded list-append history of ~n_ops invoke/ok pairs executed
    serially against an in-memory store (so the base history is
    serializable and anomaly-free), plus the requested injected
    anomalies on dedicated keys disjoint from the workload's. Returns
    an indexed Op list ready for the cycle checker."""
    rng = random.Random(seed)
    store: dict = {k: [] for k in range(keys)}
    counters = {k: itertools.count(1) for k in range(keys)}
    h: list = []
    n_txns = max(1, n_ops // 2)
    inject = list(inject)
    # spread injection sites deterministically through the middle
    sites = {max(1, (i + 1) * n_txns // (len(inject) + 1)): a
             for i, a in enumerate(inject)} if inject else {}
    extra_key = itertools.count(keys)  # fresh keys for injections
    for t in range(n_txns):
        a = sites.get(t)
        if a == "G1c":
            inject_g1c(h, rng.randrange(processes),
                       next(extra_key), next(extra_key))
        elif a == "G-single":
            inject_g_single(h, rng.randrange(processes),
                            next(extra_key), next(extra_key))
        proc = rng.randrange(processes)
        value_in, value_out = [], []
        for _ in range(rng.randint(1, max_txn_len)):
            k = rng.randrange(keys)
            if rng.random() < read_ratio:
                value_in.append([mop.READ, k, None])
                value_out.append([mop.READ, k, list(store[k])])
            else:
                v = next(counters[k])
                value_in.append([mop.APPEND, k, v])
                value_out.append([mop.APPEND, k, v])
                store[k].append(v)
        _emit(h, proc, value_in, value_out)
    return _index(h)
