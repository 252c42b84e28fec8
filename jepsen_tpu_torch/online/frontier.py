"""Incremental transactional cycle checking: an edge-insert frontier over
checker/cycle (the port's copy of `jepsen_tpu/online/frontier.py`).

The frontier ingests ops one at a time (``append``) and produces, on
demand (``advance``), the Adya classification of everything seen so
far. It maintains the dependency structure incrementally — per-key
micro-op slots and per-key edge lists, recomputed only for keys the new
ops touched — and then runs the batch classifier
(``checker/cycle/anomalies.classify``) over the assembled matrices, with
the per-component closure jobs memoized across advances through
``classify``'s journal hook (the content-hash keys
``store.AnalysisJournal`` uses). A weakly-connected component no new
edge touched hashes to the same closure job as last advance and is
reused; only dirty components are closed again, on the checker's engine
and device (None = the card, ops/csrc/closure.cu).

Contract: ``advance()`` returns exactly what ``CycleChecker.check(test,
history[:n], opts)`` returns for the same prefix, minus the store-side
timeline rendering. The per-key edge functions, the mixed-mode key
check, the classifier, the witness recovery and the first-failing-key
error selection are the batch code's own, so the streaming and batch
paths cannot drift apart. A fault of the card (checker.is_fault) raises.
"""

from __future__ import annotations

import numpy as np

from ..checker.cycle import CycleChecker, checker as cycle_checker
from ..checker.cycle import deps as _deps
from ..checker.cycle.anomalies import classify
from ..checker.cycle.deps import DepGraph, IllegalInference
from ..history import ops as _ops

__all__ = ["ClosureMemo", "CycleFrontier"]


class ClosureMemo:
    """A duck-typed ``store.AnalysisJournal`` for ``classify``'s journal
    hook: per-component closure results keyed by content hash, held in
    memory for the frontier's lifetime and optionally written through to
    a real journal (so a resumed watch session reloads them from
    disk)."""

    def __init__(self, journal=None):
        self._mem: dict = {}
        self._journal = journal

    def get(self, kind: str, key):
        r = self._mem.get((kind, str(key)))
        if r is None and self._journal is not None:
            r = self._journal.get(kind, key)
        return r

    def record(self, kind: str, key, result) -> None:
        self._mem[(kind, str(key))] = result
        if self._journal is not None:
            self._journal.record(kind, key, result)

    def __len__(self) -> int:
        return len(self._mem)


class CycleFrontier:
    """Streaming frontier over one (possibly keyed) transactional
    history.

    checker      the CycleChecker whose verdicts to stream (anomalies,
                 version order, realtime flavor, engine and device);
                 default ``cycle.checker()``, on the card
    journal      optional store.AnalysisJournal the closure memo writes
                 through to (resume support)
    history_key  the independent history_key, as in
                 ``CycleChecker.check`` opts (None for a global stream:
                 register ops lift against key 0)
    """

    def __init__(self, checker: CycleChecker | None = None, *,
                 journal=None, history_key=None):
        self.checker = checker if checker is not None else cycle_checker()
        self.memo = ClosureMemo(journal)
        self.history_key = history_key
        self.ops: list = []        # every appended op, coerced to Op
        self._nodes: list = []     # completion Op per graph node
        self._slots: dict = {}     # key -> {"appends","writes","reads"}
        self._key_order: list = []  # first-touch key order (= extract's)
        self._dirty: set = set()
        self._edges: dict = {}     # key -> {rel: [(i, j)]} | {"error": info}
        self.checked = 0           # prefix length of the last advance
        self.verdict: dict | None = None

    @property
    def pending(self) -> int:
        """Ops appended since the last advance."""
        return len(self.ops) - self.checked

    def append(self, op) -> None:
        """Ingest one op: update the per-key slots and mark the keys it
        touches dirty. Non-ok and non-transactional ops join the prefix
        but add no node (exactly as ``deps.txns_of`` skips them)."""
        (o,) = _ops([op])
        o = self.checker._unwrap(o)
        self.ops.append(o)
        txns = _deps.txns_of([o], key=self.history_key)
        if not txns:
            return
        (_, t), = txns
        i = len(self._nodes)
        self._nodes.append(o)
        for m in t:
            k = _deps.mop.key(m)
            slot = self._slots.get(k)
            if slot is None:
                slot = {"appends": [], "writes": [], "reads": []}
                self._slots[k] = slot
                self._key_order.append(k)
            if _deps.mop.is_append(m):
                slot["appends"].append((i, _deps.mop.value(m)))
            elif _deps.mop.is_write(m):
                slot["writes"].append((i, _deps.mop.value(m)))
            else:
                slot["reads"].append((i, _deps.mop.value(m)))
            self._dirty.add(k)

    def extend(self, ops) -> None:
        for op in ops:
            self.append(op)

    def advance(self) -> dict:
        """Classify the current prefix; returns (and stores in
        ``.verdict``) the batch-identical result dict."""
        self.checked = len(self.ops)
        c = self.checker
        if c.realtime:
            # realtime edges are dense over ALL node pairs: no
            # incremental structure helps; defer to the batch extract
            try:
                g = c.graph(self.ops, key=self.history_key)
            except IllegalInference as e:
                self.verdict = {"valid": "unknown", "error": e.info}
                return self.verdict
        else:
            g = self._graph()
            if g is None:
                self.verdict = {"valid": "unknown",
                                "error": self._first_error()}
                return self.verdict
        r = classify(g, c.anomalies, realtime=c.realtime, engine=c.engine,
                     device=c.device, max_witnesses=c.max_witnesses,
                     journal=self.memo)
        self.verdict = {"valid": not r["anomaly-types"], **r}
        return self.verdict

    # -- incremental graph maintenance ------------------------------------

    def _key_edges(self, k) -> dict:
        """Recompute one key's edge lists through the batch inference
        functions (deps._append_key_edges / _register_key_edges)."""
        c = self.checker
        slot = self._slots[k]
        edges: dict = {r: [] for r in _deps.RELATIONS}

        def add(rel, i, j):
            # mirrors extract()'s add: drop _INIT endpoints, self-loops
            if i is not _deps._INIT and j is not _deps._INIT and i != j:
                edges[rel].append((i, j))

        try:
            reads_lists = any(isinstance(v, (list, tuple))
                              for _, v in slot["reads"])
            if slot["appends"] or reads_lists:
                if slot["writes"]:
                    raise IllegalInference(
                        f"key {k!r} saw both append/list-read and write "
                        f"micro-ops", key=k)
                _deps._append_key_edges(k, slot["appends"], slot["reads"],
                                        add)
            elif slot["writes"] or slot["reads"]:
                _deps._register_key_edges(
                    k, slot["writes"], slot["reads"], add,
                    version_order=c.version_order,
                    init_values=c.init_values)
        except IllegalInference as e:
            return {"error": e.info}
        return edges

    def _graph(self) -> DepGraph | None:
        """The prefix's dependency graph, recomputing edges only for
        dirty keys; None when any key's inference fails (the prefix is
        uncheckable, matching ``extract`` raising)."""
        for k in self._dirty:
            self._edges[k] = self._key_edges(k)
        self._dirty.clear()
        if any("error" in e for e in self._edges.values()):
            return None
        n = len(self._nodes)
        adj = {r: np.zeros((n, n), dtype=bool) for r in _deps.RELATIONS}
        for e in self._edges.values():
            for rel, ij in e.items():
                for i, j in ij:
                    adj[rel][i, j] = True
        return DepGraph(ops=list(self._nodes), adj=adj)

    def _first_error(self) -> dict:
        """The error the batch extract would raise: its per-key loop runs
        in first-touch key order and raises at the first failing key, so
        pick that key's error."""
        for k in self._key_order:
            e = self._edges.get(k)
            if e is not None and "error" in e:
                return e["error"]
        raise AssertionError("no key error recorded")
