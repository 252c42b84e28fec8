"""Key-space sharding: lift single-key workloads and checkers to many
independent keys (reference: jepsen.independent; the port's copy of
`jepsen_tpu.independent`: the keyed generators and the checker).

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
import threading
from typing import Callable, Iterable, NamedTuple

from . import generator as gen
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


def _wrap(o: dict, k) -> dict:
    o = dict(o)
    o["value"] = KVTuple(k, o.get("value"))
    return o


class SequentialGenerator(gen.Generator):
    """One key at a time: serve ops from fgen(k1) until exhausted, then
    move to k2 ... (independent.clj:31-64)."""

    def __init__(self, keys: Iterable, fgen: Callable):
        self._keys = iter(keys)
        self._fgen = fgen
        self._lock = threading.Lock()
        self._current = None  # (k, gen)
        self._done = False
        self._advance()

    def _advance(self):
        try:
            k = next(self._keys)
            self._current = (k, gen.to_gen(self._fgen(k)))
        except StopIteration:
            self._current = None
            self._done = True

    def op(self, test, process):
        while True:
            with self._lock:
                if self._done:
                    return None
                k, g = self._current
            o = g.op(test, process)
            if o is not None:
                return _wrap(o, k)
            with self._lock:
                if not self._done and self._current[0] == k:
                    self._advance()


def sequential_generator(keys, fgen) -> SequentialGenerator:
    return SequentialGenerator(keys, fgen)


class ConcurrentGenerator(gen.Generator):
    """n threads per key, thread-count/n keys in flight at once; each
    group of n contiguous threads works through keys, rebinding *threads*
    so barriers inside per-key generators span exactly that group
    (independent.clj:66-220). Requires concurrency to be a multiple of n;
    the nemesis never enters sub-generators."""

    def __init__(self, n: int, keys: Iterable, fgen: Callable):
        assert n > 0 and isinstance(n, int)
        self.n = n
        self._keys = iter(keys)
        self._fgen = fgen
        self._lock = threading.Lock()
        self._state = None  # {"active": [...], "group_threads": [...]}

    def _next_key(self):
        try:
            k = next(self._keys)
            return (k, gen.to_gen(self._fgen(k)))
        except StopIteration:
            return None

    def _init(self, test):
        threads = gen.current_threads()
        if threads is None:
            threads = list(range(test["concurrency"]))
        threads = [t for t in threads if isinstance(t, int)]
        thread_count = len(threads)
        assert sorted(threads) == list(range(thread_count)), (
            "concurrent_generator expects integer threads 0..n"
        )
        group_size = self.n
        group_count = thread_count // group_size
        assert group_size <= thread_count, (
            f"with {thread_count} worker threads, cannot run a key with "
            f"{group_size} threads concurrently; raise concurrency"
        )
        assert thread_count == group_size * group_count, (
            f"{thread_count} threads cannot be split into groups of "
            f"{group_size}; make concurrency a multiple of {group_size}"
        )
        self._state = {
            "active": [self._next_key() for _ in range(group_count)],
            "group_threads": [
                threads[g * group_size : (g + 1) * group_size]
                for g in range(group_count)
            ],
        }

    def op(self, test, process):
        with self._lock:
            if self._state is None:
                self._init(test)
            s = self._state
        thread = gen.process_to_thread(test, process)
        assert isinstance(thread, int), (
            f"only integer worker threads may draw from "
            f"concurrent_generator, got {thread!r}"
        )
        group = thread // self.n
        while True:
            with self._lock:
                pair = s["active"][group]
            if pair is None:
                return None
            k, g = pair
            with gen.with_threads(s["group_threads"][group]):
                o = g.op(test, process)
            if o is not None:
                return _wrap(o, k)
            with self._lock:
                if s["active"][group] is pair:
                    s["active"][group] = self._next_key()


def concurrent_generator(n, keys, fgen) -> ConcurrentGenerator:
    return ConcurrentGenerator(n, keys, fgen)


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
