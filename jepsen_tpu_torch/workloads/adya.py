"""Adya G2 anti-dependency-cycle workload (the port's copy of
`jepsen_tpu/workloads/adya.py`; reference: jepsen/src/jepsen/tests/
adya.clj:1-89; see Adya's thesis for G2).

For each key, two concurrent transactions each predicate-read both
tables and insert one row; under serializability at most one insert
per key may commit. Ops are {"f": "insert", "value": (key, (a_id,
b_id))} with exactly one of a_id/b_id set; clients predicate-read both
tables for the key, and insert into table a or b iff both reads came
back empty.
"""

from __future__ import annotations

import itertools
import threading

from .. import generator as gen
from .. import independent
from ..checker import Checker
from ..history import ops as _ops


class _IdSource:
    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n


def g2_gen() -> gen.Generator:
    """Pairs of insert ops per key, ids globally unique; one txn holds
    a_id, the other b_id (adya.clj:13-61)."""
    ids = _IdSource()
    return independent.concurrent_generator(
        2,
        itertools.count(),
        lambda k: gen.seq(
            [
                lambda t, p: {
                    "type": "invoke",
                    "f": "insert",
                    "value": (None, ids.next()),
                },
                lambda t, p: {
                    "type": "invoke",
                    "f": "insert",
                    "value": (ids.next(), None),
                },
            ]
        ),
    )


class G2Checker(Checker):
    """At most one insert may succeed per key (adya.clj:63-89).

    The default path restates each ok insert as the transaction the
    client actually ran — predicate-read both tables empty, then write
    its own row — and hands the lot to the cycle checker on `device`
    (None = CUDA, raising when it is absent; "cpu" the kernels' plain
    versions): two committed inserts for one key each read the emptiness
    the other destroyed, a mutual anti-dependency cycle, which is
    exactly Adya's G2. legacy=True counts per key on the host instead
    (both paths produce the key/legal/illegal tallies)."""

    def __init__(self, legacy: bool = False, device=None):
        self.legacy = legacy
        self.device = device

    def check(self, test, history, opts=None) -> dict:
        keys: dict = {}
        inserts: dict = {}
        for op in _ops(history):
            if op.f != "insert" or not independent.is_tuple(op.value):
                continue
            k = op.value.key
            if op.is_ok:
                keys[k] = keys.get(k, 0) + 1
                inserts.setdefault(k, []).append(op)
            else:
                keys.setdefault(k, 0)
        insert_count = sum(1 for c in keys.values() if c > 0)
        illegal = {k: c for k, c in sorted(keys.items()) if c > 1}
        out = {
            "key-count": len(keys),
            "legal-count": insert_count - len(illegal),
            "illegal-count": len(illegal),
            "illegal": illegal,
        }
        if self.legacy:
            out["valid"] = not illegal
            return out
        r = self._cycle_verdict(test, inserts, opts)
        if r["valid"] is False:
            out["valid"] = False
            out["anomaly-types"] = r["anomaly-types"]
            out["anomalies"] = r["anomalies"]
        elif illegal:
            # the per-key count is structural ground truth; a double
            # insert the inference couldn't attribute still fails
            out["valid"] = False
        elif r["valid"] == "unknown":
            out["valid"] = "unknown"
            out["error"] = r.get("error")
        else:
            out["valid"] = True
        return out

    def _cycle_verdict(self, test, inserts, opts) -> dict:
        from ..checker import cycle

        txn_history = []
        for k, ops in inserts.items():
            for op in ops:
                a_id, b_id = op.value.value
                table = (k, "a") if a_id is not None else (k, "b")
                txn_history.append(op.with_(value=[
                    ["r", (k, "a"), None],
                    ["r", (k, "b"), None],
                    ["w", table, a_id if a_id is not None else b_id],
                ]))
        return cycle.checker(("G2",), version_order="write-once",
                             device=self.device).check(
            test, txn_history, opts)


def g2_checker(legacy: bool = False, device=None) -> G2Checker:
    return G2Checker(legacy=legacy, device=device)


def workload(device=None) -> dict:
    """Checker + generator bundle; the checker's cycle search runs on
    `device`."""
    return {"checker": g2_checker(device=device), "generator": g2_gen()}
