"""Key-space sharding: lift single-key checkers to many independent keys
(reference: jepsen.independent; the port's copy of the checking half of
`jepsen_tpu.independent`).

Values are wrapped in KVTuple(key, v); a key's subhistory keeps every
op whose value is NOT a tuple for a different key (so nemesis/info ops
appear in every subhistory), unwrapping matching tuples.
"""

from __future__ import annotations

from typing import NamedTuple

from .checker import Checker, check_safe, merge_valid
from .history import Op, op as to_op
from .util import bounded_pmap

DIR = "independent"


class KVTuple(NamedTuple):
    """A kv tuple (independent.clj:21-29)."""

    key: object
    value: object


def tuple_(k, v) -> KVTuple:
    return KVTuple(k, v)


def is_tuple(v) -> bool:
    return isinstance(v, KVTuple)


def history_keys(history) -> set:
    """All keys appearing in tuple values."""
    out = set()
    for o in history:
        v = to_op(o).value
        if is_tuple(v):
            out.add(v.key)
    return out


def subhistory(k, history) -> list:
    """Ops without a *different* key's tuple value, tuples unwrapped."""
    return _split(history, [k])[k]


def _split(history, ks) -> dict:
    """The subhistory of every key in `ks`, in one pass over the history
    (the unwrapped copies are built with Op's constructor, several times
    faster than `Op.with_` at a million ops)."""
    subs: dict = {k: [] for k in ks}
    for o in history:
        o = to_op(o)
        v = o.value
        if not is_tuple(v):
            for sub in subs.values():
                sub.append(o)
        elif v.key in subs:
            subs[v.key].append(Op(o.process, o.type, o.f, v.value, o.time,
                                  o.index, o.error, o.extra))
    return subs


class IndependentChecker(Checker):
    """Lift a checker over v to one over [k v] tuples: check each key's
    subhistory, merge validities, list failing keys
    (independent.clj:247-298).

    A sub-checker with `check_batch` (the linearizable checker) gets all
    per-key subhistories in ONE call, so its kernel sees the whole key
    space in one launch. Unlike the JAX package, an exception from that
    call propagates: re-running per key under check_safe would turn a
    kernel fault into "unknown" verdicts. Other sub-checkers (the cycle
    checker), and a history of one key, go key by key under check_safe,
    which re-raises kernel, build and missing-CUDA faults."""

    def __init__(self, checker: Checker):
        self.checker = checker

    def check(self, test, history, opts=None) -> dict:
        opts = dict(opts or {})
        history = list(history)
        ks = sorted(history_keys(history), key=str)
        subs = _split(history, ks)

        def item_opts(k):
            subdir = list(opts.get("subdirectory") or []) + [DIR, str(k)]
            return {**opts, "subdirectory": subdir, "history_key": k}

        if len(ks) > 1 and hasattr(self.checker, "check_batch"):
            rs = self.checker.check_batch(
                test, [(subs[k], item_opts(k)) for k in ks])
            results = dict(zip(ks, rs))
        else:
            def check_key(k):
                return k, check_safe(self.checker, test, subs[k],
                                     item_opts(k))

            results = dict(bounded_pmap(check_key, ks))
        return combine_results(results)


def combine_results(results: dict) -> dict:
    """Fold per-key result dicts into one verdict: merged validity, the
    failing keys and, for cycle-checker results, the union of the keys'
    anomaly types. Only definite falsifications are failures; "unknown"
    keys are excluded, as in the reference."""
    failures = [k for k, r in results.items() if r["valid"] is False]
    out = {
        "valid": merge_valid(r["valid"] for r in results.values()),
        "results": results,
        "failures": failures,
    }
    anomaly_types = sorted({
        t for r in results.values() if isinstance(r, dict)
        for t in r.get("anomaly-types") or ()
    })
    if anomaly_types:
        out["anomaly-types"] = anomaly_types
    return out


def checker(c: Checker) -> IndependentChecker:
    return IndependentChecker(c)
