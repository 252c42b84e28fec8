"""Key-space sharding: lift single-key checkers to many independent keys
(reference: jepsen.independent; the port's copy of the checking half of
`jepsen_tpu.independent`).

Values are wrapped in KVTuple(key, v); a key's subhistory keeps every
op whose value is NOT a tuple for a different key (so nemesis/info ops
appear in every subhistory), unwrapping matching tuples.

With a store dir on the test (name and start_time), each key's
results.edn and history.txt go to independent/<key>/ (as the JAX
package writes them); with an analysis journal on the test
(`test["_analysis_journal"]`, a store.AnalysisJournal), keys whose
verdicts it holds are not checked again and new verdicts are recorded
after the check.
"""

from __future__ import annotations

import hashlib
import logging
from typing import NamedTuple

from .checker import Checker, check_safe, merge_valid
from .history import Op, op as to_op
from .util import bounded_pmap, bounded_pmap_processes

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
    which re-raises kernel, build and missing-CUDA faults.

    processes=True checks the keys over a pool of spawned worker
    processes instead of threads (an int: that many workers; True: the
    cpu count), where the sub-checker has no check_batch, as in the JAX
    package. Each worker gets the checker, its key's subhistory and the
    picklable slice of the test map and opts, and opens its own CUDA
    context: a checker's device=None resolves in the worker. A fault of
    the card in a worker re-raises here, as does a worker's death.

    The JAX package counts journal skips in its supervisor's telemetry
    ("journal_skips"); the port has no supervisor, so the skip count is
    only logged, as the JAX package also does."""

    def __init__(self, checker: Checker, processes: bool | int = False):
        self.checker = checker
        self.processes = processes

    def check(self, test, history, opts=None) -> dict:
        opts = dict(opts or {})
        history = list(history)
        ks = sorted(history_keys(history), key=str)
        subs = _split(history, ks)

        # resumable analysis: keys whose verdicts the journal holds are
        # skipped; the identity covers the subhistory's content, so a
        # key whose history grew is checked again
        journal = (test or {}).get("_analysis_journal")
        journaled: dict = {}
        jkeys: dict = {}
        if journal is not None:
            remaining = []
            for k in ks:
                jkeys[k] = _journal_key(k, subs[k])
                r = journal.get("independent-key", jkeys[k])
                if r is not None:
                    journaled[k] = r
                else:
                    remaining.append(k)
            if journaled:
                logging.getLogger("jepsen_tpu_torch.independent").info(
                    "analysis journal: skipping %d finished key(s), "
                    "%d to check", len(journaled), len(remaining))
            ks = remaining

        def item_opts(k):
            subdir = list(opts.get("subdirectory") or []) + [DIR, str(k)]
            return {**opts, "subdirectory": subdir, "history_key": k}

        if len(ks) > 1 and hasattr(self.checker, "check_batch"):
            items = [(subs[k], item_opts(k)) for k in ks]
            rs = self.checker.check_batch(test, items)
            results = dict(zip(ks, rs))
            for k, (sub, o) in zip(ks, items):
                self._write_artifacts(test, o["subdirectory"], sub,
                                      results[k])
        elif self.processes and len(ks) > 1:
            # a worker needs only its own subhistory, never the test's
            # recorded bulk
            lite = _picklable_map({
                k: v for k, v in (test or {}).items()
                if k not in ("history", "active_histories")})
            payloads = [(self.checker, lite, subs[k],
                         _picklable_map(item_opts(k)), k) for k in ks]
            bound = None if self.processes is True else int(self.processes)
            results = dict(bounded_pmap_processes(_check_payload, payloads,
                                                  bound=bound))
            for _, _, sub, o, k in payloads:
                self._write_artifacts(test, o["subdirectory"], sub,
                                      results[k])
        else:
            def check_key(k):
                o = item_opts(k)
                r = check_safe(self.checker, test, subs[k], o)
                self._write_artifacts(test, o["subdirectory"], subs[k], r)
                return k, r

            results = dict(bounded_pmap(check_key, ks))
        if journal is not None:
            for k, r in results.items():
                journal.record("independent-key", jkeys[k], r)
            results = {**journaled, **results}
        return combine_results(results)

    @staticmethod
    def _write_artifacts(test, subdir, sub, result) -> None:
        """Each key's results.edn and history.txt under the test's store
        dir (independent.clj:269-287), when the test has one. A failed
        write is logged and does not mask the verdict."""
        if not (test and test.get("start_time")):
            return
        from . import store

        try:
            store.write_edn(test, subdir + ["results.edn"], result)
            store.write_history_txt(test, subdir + ["history.txt"], sub)
        except Exception:  # noqa: BLE001 — artifacts are best-effort
            logging.getLogger("jepsen_tpu_torch.independent").warning(
                "couldn't write %s's artifacts", "/".join(subdir),
                exc_info=True)


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


def pack_check(checker: IndependentChecker, test, jobs,
               opts=None) -> list[dict]:
    """Cross-run batch packing: check MANY independent histories in one
    batched engine pass (the JAX package's `pack_check`). Every job's
    per-key subhistories flatten into ONE check_batch call of the wrapped
    sub-checker, so the engines see the union of all jobs' key lanes at
    once; P-compositionality makes a key's verdict independent of the
    job its lane arrived with. Each job's verdict recombines through
    combine_results, so it equals IndependentChecker.check of that
    history alone.

    Unlike the JAX package, an exception of the packed pass propagates
    (as IndependentChecker's does): re-checking job by job would turn a
    kernel fault into "unknown" verdicts. Only a sub-checker without
    check_batch is checked job by job."""
    opts = dict(opts or {})
    jobs = [list(h) for h in jobs]
    if not hasattr(checker.checker, "check_batch"):
        return [checker.check(test, h, opts) for h in jobs]
    payload = []  # flat (job index, key, subhistory, per-item opts)
    for j, history in enumerate(jobs):
        ks = sorted(history_keys(history), key=str)
        subs = _split(history, ks)
        for k in ks:
            subdir = list(opts.get("subdirectory") or []) + [DIR, str(k)]
            payload.append((j, k, subs[k],
                            {**opts, "subdirectory": subdir,
                             "history_key": k}))
    rs = checker.checker.check_batch(
        test, [(sub, o) for _, _, sub, o in payload])
    per_job: list = [dict() for _ in jobs]
    for (j, k, _sub, _o), r in zip(payload, rs):
        per_job[j][k] = r
    return [combine_results(res) for res in per_job]


def _journal_key(k, sub) -> str:
    """A stable journal identity for one key's analysis: the key plus a
    digest of its subhistory's verdict-relevant fields (the JAX
    package's, so either package's journal serves the other)."""
    h = hashlib.sha1()
    for o in sub:
        h.update(repr((o.process, o.type, o.f, o.value,
                       o.index, o.error)).encode())
    return f"{k}#{len(sub)}#{h.hexdigest()[:16]}"


def _picklable_map(m: dict) -> dict:
    """The subset of a dict whose values survive pickling — what a
    process-pool worker can receive (clients, remotes, journals and live
    sockets don't; names, models and options do)."""
    import pickle

    out = {}
    for k, v in m.items():
        try:
            pickle.dumps(v)
        except Exception:  # noqa: BLE001 — unpicklable: drop
            continue
        out[k] = v
    return out


def _check_payload(payload):
    """Process-pool worker: run one key's check under check_safe, which
    re-raises a fault of the card (module-level so it pickles)."""
    chk, test, sub, opts, k = payload
    return k, check_safe(chk, test, sub, opts)


def checker(c: Checker, processes: bool | int = False) -> IndependentChecker:
    return IndependentChecker(c, processes=processes)
