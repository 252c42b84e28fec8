"""Windowed WGL frontier: per-independent-key streaming advance of the
linearizable checker (the port's copy of `jepsen_tpu/online/wgl.py`).

The frontier ingests a keyed (KVTuple-valued) history op by op and, on
each ``advance``, re-checks ONLY the keys whose subhistory changed since
their last verdict — every dirty key's subhistory goes through the
wrapped sub-checker in one ``check_batch`` call (the same cross-key
window packing ``independent.IndependentChecker`` and the verdict
daemon's ``pack_check`` use: K1, K5 or K2 on the card, or the native
engine, as "auto" routes the window), and the per-key verdicts recombine
through ``independent.combine_results``. Unchanged keys keep their
memoized verdicts, identified by ``independent._journal_key`` — the
per-key content identity the ``store.AnalysisJournal``
"independent-key" kind journals — so a frontier backed by a journal
resumes across process kills.

Contract: ``advance()`` returns what ``IndependentChecker.check(test,
history[:n], {})`` returns for the same prefix, minus store artifacts.
P-compositionality licenses the reuse: a key's verdict depends only on
its own subhistory, never on which batch its lane rode in.

Unlike the JAX package, an exception of the batched window check
propagates (as IndependentChecker's does) instead of falling back to
per-key ``check_safe``: that fallback would turn a kernel fault into
"unknown" verdicts. A window of one dirty key goes through
``check_safe``, which re-raises the faults of the card
(checker.is_fault).
"""

from __future__ import annotations

import time

from .. import independent as indep
from ..checker import check_safe
from ..history import ops as _ops

__all__ = ["WGLFrontier"]


class WGLFrontier:
    """Streaming frontier over one keyed history.

    checker  an ``independent.IndependentChecker`` (e.g. the registry's
             register workload: independent over the WGL linearizable
             search); its wrapped sub-checker does the per-key work,
             batched through ``check_batch`` when it has one
    test     the test map handed to the sub-checker (model, name, ...)
    journal  optional store.AnalysisJournal to write per-key verdicts
             through to ("independent-key" kind, resume support)
    window_budget_s
             optional wall-clock budget per ``advance``: each check runs
             with ``test["deadline"]`` stamped that far in the future,
             so the keys that did not fit come back ``unknown:
             deadline`` (and stay dirty, to be retried next advance)
             instead of one slow window stalling the stream
    """

    def __init__(self, checker: indep.IndependentChecker, *, test=None,
                 journal=None, window_budget_s: float | None = None):
        if not isinstance(checker, indep.IndependentChecker):
            raise TypeError(
                f"WGLFrontier wants an IndependentChecker, got "
                f"{type(checker).__name__}")
        self.checker = checker
        self.test = test or {}
        self.journal = journal
        self.window_budget_s = window_budget_s
        self.ops: list = []
        self._keys: set = set()
        self._dirty: set = set()
        self._global_dirty = False  # a non-tuple op joins EVERY subhistory
        self._verdicts: dict = {}   # key -> verdict for its current sub
        self._jkeys: dict = {}      # key -> _journal_key of that verdict
        self.checked = 0
        self.verdict: dict | None = None

    @property
    def pending(self) -> int:
        """Ops appended since the last advance."""
        return len(self.ops) - self.checked

    def append(self, op) -> None:
        (o,) = _ops([op])
        self.ops.append(o)
        if indep.is_tuple(o.value):
            self._keys.add(o.value.key)
            self._dirty.add(o.value.key)
        else:
            self._global_dirty = True

    def extend(self, ops) -> None:
        for op in ops:
            self.append(op)

    def advance(self) -> dict:
        """Re-check dirty keys, recombine everything, return (and store
        in ``.verdict``) the batch-identical result dict."""
        self.checked = len(self.ops)
        dirty = set(self._keys) if self._global_dirty else set(self._dirty)
        self._dirty.clear()
        self._global_dirty = False

        ks = sorted(dirty, key=str)
        subs = indep._split(self.ops, ks)
        todo = []  # (key, subhistory, journal key, per-item opts)
        for k in ks:
            sub = subs[k]
            jk = indep._journal_key(k, sub)
            if self._jkeys.get(k) == jk:
                continue  # marked dirty, but content-identical
            if self.journal is not None:
                r = self.journal.get("independent-key", jk)
                if r is not None:
                    self._verdicts[k], self._jkeys[k] = r, jk
                    continue
            todo.append((k, sub, jk,
                         {"subdirectory": [indep.DIR, str(k)],
                          "history_key": k}))
        if todo:
            for (k, _sub, jk, _o), r in zip(todo, self._check(todo)):
                self._verdicts[k] = r
                if (isinstance(r, dict) and r.get("valid") == "unknown"
                        and r.get("error") == "deadline"):
                    # budget expiry is transient: keep the key dirty and
                    # unmemoized so the next advance retries it
                    self._dirty.add(k)
                    self._jkeys.pop(k, None)
                    continue
                self._jkeys[k] = jk
                if self.journal is not None:
                    self.journal.record("independent-key", jk, r)
        self.verdict = indep.combine_results(dict(self._verdicts))
        return self.verdict

    def _check(self, todo) -> list:
        """One batched pass over the dirty keys' window — the
        batch-else-per-key structure IndependentChecker.check runs. A
        window budget stamps a fresh absolute deadline per pass."""
        test = self.test
        if self.window_budget_s is not None:
            test = {**test,
                    "deadline": time.monotonic() + self.window_budget_s}
        sub_checker = self.checker.checker
        if len(todo) > 1 and hasattr(sub_checker, "check_batch"):
            return sub_checker.check_batch(
                test, [(sub, o) for _, sub, _, o in todo])
        return [check_safe(sub_checker, test, sub, o)
                for _, sub, _, o in todo]
