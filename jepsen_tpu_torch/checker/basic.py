"""Non-search checkers: linear scans and reductions over the history
(the port's copy of `jepsen_tpu/checker/basic.py`).

Result-map keys and verdict logic are the reference's jepsen.checker
implementations (file:line cites on each class). These are the O(n)
checkers, all on the host; the linearizability search lives in
checker/linearizable.py.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any

from ..history import Op, complete, op as to_op
from ..models import inconsistent
from ..util import integer_interval_set_str, nanos_to_ms
from . import Checker


def _ops(history):
    return [to_op(o) for o in history]


class Queue(Checker):
    """Every dequeue must come from somewhere: assume every non-failing
    enqueue succeeded and only ok dequeues succeeded, then fold the model
    over that sequence (checker.clj:143-163). Use with an unordered-queue
    model; O(n)."""

    def __init__(self, model):
        self.model = model

    def check(self, test, history, opts=None) -> dict:
        state = self.model
        for o in _ops(history):
            take = (o.f == "enqueue" and o.is_invoke) or (
                o.f == "dequeue" and o.is_ok
            )
            if not take:
                continue
            state = state.step(o.f, o.value)
            if inconsistent(state):
                return {"valid": False, "error": state.msg}
        return {"valid": True, "final_queue": state}


def queue(model) -> Queue:
    return Queue(model)


class SetChecker(Checker):
    """:add operations followed by a final :read of the whole set
    (checker.clj:165-216). Verifies every acknowledged add is present and
    nothing unexpected appears."""

    def check(self, test, history, opts=None) -> dict:
        ops = _ops(history)
        attempts = {o.value for o in ops if o.is_invoke and o.f == "add"}
        adds = {o.value for o in ops if o.is_ok and o.f == "add"}
        final_read = None
        for o in ops:
            if o.is_ok and o.f == "read":
                final_read = o.value
        if final_read is None:
            return {"valid": "unknown", "error": "Set was never read"}
        final_read = set(final_read)
        ok = final_read & attempts
        unexpected = final_read - attempts
        lost = adds - final_read
        recovered = ok - adds
        return {
            "valid": not lost and not unexpected,
            "attempt_count": len(attempts),
            "acknowledged_count": len(adds),
            "ok_count": len(ok),
            "lost_count": len(lost),
            "recovered_count": len(recovered),
            "unexpected_count": len(unexpected),
            "ok": integer_interval_set_str(ok),
            "lost": integer_interval_set_str(lost),
            "unexpected": integer_interval_set_str(unexpected),
            "recovered": integer_interval_set_str(recovered),
        }


def set_checker() -> SetChecker:
    return SetChecker()


@dataclass
class _SetElement:
    """Per-element timeline state for set-full (checker.clj:238-263):
    known = op confirming existence (add ok or first observing read);
    last_present / last_absent = most recent read *invocations* that did /
    didn't observe the element."""

    element: Any
    known: Op | None = None
    last_present: Op | None = None
    last_absent: Op | None = None

    def add_ok(self, o: Op):
        if self.known is None:
            self.known = o

    def read_present(self, inv: Op, o: Op):
        if self.known is None:
            self.known = o
        if self.last_present is None or self.last_present.index < inv.index:
            self.last_present = inv

    def read_absent(self, inv: Op, o: Op):
        if self.last_absent is None or self.last_absent.index < inv.index:
            self.last_absent = inv

    def results(self) -> dict:
        """Final per-element outcome (checker.clj:265-330). An element is
        stable if some read invoked after the last absent read observed it;
        lost if it was known and the last absent read began after both the
        last present read and the known time; else never-read."""
        lp = self.last_present.index if self.last_present else -1
        la = self.last_absent.index if self.last_absent else -1
        stable = self.last_present is not None and la < lp
        lost = (
            self.known is not None
            and self.last_absent is not None
            and lp < la
            and self.known.index < la
        )
        stable_time = (
            (self.last_absent.time + 1 if self.last_absent else 0)
            if stable
            else None
        )
        lost_time = (
            (self.last_present.time + 1 if self.last_present else 0)
            if lost
            else None
        )
        known_time = self.known.time if self.known else 0
        return {
            "element": self.element,
            "outcome": "stable" if stable else "lost" if lost else "never-read",
            "stable_latency": (
                int(nanos_to_ms(max(0, stable_time - known_time)))
                if stable
                else None
            ),
            "lost_latency": (
                int(nanos_to_ms(max(0, lost_time - known_time)))
                if lost
                else None
            ),
        }


def _frequency_distribution(points, coll):
    """Percentile map over a collection (checker.clj:332-343)."""
    xs = sorted(coll)
    if not xs:
        return None
    n = len(xs)
    return {p: xs[min(n - 1, int(n * p))] for p in points}


class SetFull(Checker):
    """Rigorous set analysis over a full timeline of adds and
    whole-set reads (checker.clj:345-503): classifies each element as
    stable / lost / never-read, computes stable & lost latencies, flags
    stale (slow-to-appear) elements, and — with linearizable=True — fails
    on staleness too."""

    def __init__(self, linearizable: bool = False):
        self.linearizable = linearizable

    def check(self, test, history, opts=None) -> dict:
        elements: dict = {}
        reads: dict = {}  # process -> read invocation
        for o in _ops(history):
            if not isinstance(o.process, int):
                continue  # ignore the nemesis
            if o.f == "add":
                if o.is_invoke:
                    elements.setdefault(o.value, _SetElement(o.value))
                elif o.is_ok:
                    e = elements.get(o.value)
                    if e is not None:
                        e.add_ok(o)
            elif o.f == "read":
                if o.is_invoke:
                    reads[o.process] = o
                elif o.is_fail:
                    reads.pop(o.process, None)
                elif o.is_ok:
                    inv = reads.pop(o.process, o)
                    v = set(o.value)
                    for element, state in elements.items():
                        if element in v:
                            state.read_present(inv, o)
                        else:
                            state.read_absent(inv, o)
        rs = [e.results() for e in elements.values()]
        outcomes: dict = {}
        for r in rs:
            outcomes.setdefault(r["outcome"], []).append(r)
        stable = outcomes.get("stable", [])
        lost = outcomes.get("lost", [])
        never_read = outcomes.get("never-read", [])
        stale = [r for r in stable if r["stable_latency"] > 0]
        worst_stale = sorted(
            stale, key=lambda r: r["stable_latency"], reverse=True
        )[:8]
        if lost:
            valid: Any = False
        elif not stable:
            valid = "unknown"
        elif self.linearizable and stale:
            valid = False
        else:
            valid = True
        out = {
            "valid": valid,
            "attempt_count": len(rs),
            "stable_count": len(stable),
            "lost_count": len(lost),
            "lost": sorted(r["element"] for r in lost),
            "never_read_count": len(never_read),
            "never_read": sorted(r["element"] for r in never_read),
            "stale_count": len(stale),
            "stale": sorted(r["element"] for r in stale),
            "worst_stale": worst_stale,
        }
        points = (0, 0.5, 0.95, 0.99, 1)
        sl = _frequency_distribution(
            points, [r["stable_latency"] for r in rs if r["stable_latency"] is not None]
        )
        ll = _frequency_distribution(
            points, [r["lost_latency"] for r in rs if r["lost_latency"] is not None]
        )
        if sl:
            out["stable_latencies"] = sl
        if ll:
            out["lost_latencies"] = ll
        return out


def set_full(linearizable: bool = False) -> SetFull:
    return SetFull(linearizable)


def expand_queue_drain_ops(history) -> list:
    """Expand :drain ops (value = collection of elements) into dequeue
    invoke/ok pairs (checker.clj:505-537).

    A crashed (:info) drain that carries a partial element list — e.g.
    disque's drain hitting its deadline after acking some jobs — has
    those elements expanded too (they were definitely consumed); the
    drain's incompleteness is preserved simply by not having drained
    the rest. Only a crashed drain with NO value is unhandleable, as in
    the reference."""
    out = []
    for o in _ops(history):
        if o.f != "drain":
            out.append(o)
        elif o.is_invoke or o.is_fail:
            continue
        elif o.is_ok or (o.is_info and isinstance(o.value, (list, tuple))):
            for element in o.value:
                out.append(o.with_(type="invoke", f="dequeue", value=None))
                out.append(o.with_(type="ok", f="dequeue", value=element))
        else:
            raise ValueError(f"can't handle a crashed drain operation: {o}")
    return out


class TotalQueue(Checker):
    """What goes in must come out — multiset analysis of enqueues vs
    dequeues; requires the history to drain the queue
    (checker.clj:539-598)."""

    def check(self, test, history, opts=None) -> dict:
        ops = expand_queue_drain_ops(history)
        attempts = Counter(
            o.value for o in ops if o.is_invoke and o.f == "enqueue"
        )
        enqueues = Counter(o.value for o in ops if o.is_ok and o.f == "enqueue")
        dequeues = Counter(o.value for o in ops if o.is_ok and o.f == "dequeue")
        ok = dequeues & attempts
        unexpected = Counter(
            {v: n for v, n in dequeues.items() if v not in attempts}
        )
        duplicated = dequeues - attempts - unexpected
        lost = enqueues - dequeues
        recovered = ok - enqueues
        return {
            "valid": not lost and not unexpected,
            "attempt_count": sum(attempts.values()),
            "acknowledged_count": sum(enqueues.values()),
            "ok_count": sum(ok.values()),
            "unexpected_count": sum(unexpected.values()),
            "duplicated_count": sum(duplicated.values()),
            "lost_count": sum(lost.values()),
            "recovered_count": sum(recovered.values()),
            "lost": dict(lost),
            "unexpected": dict(unexpected),
            "duplicated": dict(duplicated),
            "recovered": dict(recovered),
        }


def total_queue() -> TotalQueue:
    return TotalQueue()


class UniqueIds(Checker):
    """A unique-id generator must actually emit unique ids: :generate
    invokes answered by :ok with distinct values (checker.clj:600-645)."""

    def check(self, test, history, opts=None) -> dict:
        ops = _ops(history)
        attempted = sum(1 for o in ops if o.is_invoke and o.f == "generate")
        acks = [o.value for o in ops if o.is_ok and o.f == "generate"]
        counts = Counter(acks)
        dups = {k: n for k, n in counts.items() if n > 1}
        rng = [min(acks), max(acks)] if acks else None
        worst = dict(
            sorted(dups.items(), key=lambda kv: kv[1], reverse=True)[:48]
        )
        return {
            "valid": not dups,
            "attempted_count": attempted,
            "acknowledged_count": len(acks),
            "duplicated_count": len(dups),
            "duplicated": worst,
            "range": rng,
        }


def unique_ids() -> UniqueIds:
    return UniqueIds()


class CounterChecker(Checker):
    """A monotonically-increasing counter: each read must fall between the
    sum of acknowledged increments (lower bound at its invocation) and the
    sum of attempted increments (upper bound at its completion)
    (checker.clj:648-701)."""

    def check(self, test, history, opts=None) -> dict:
        lower = 0
        upper = 0
        pending: dict = {}  # process -> (lower-at-invoke, value)
        reads = []
        for o in complete(_ops(history)):
            key = (o.type, o.f)
            if key == ("invoke", "read"):
                pending[o.process] = (lower, o.value)
            elif key == ("ok", "read"):
                lo, v = pending.pop(o.process, (lower, o.value))
                reads.append((lo, v, upper))
            elif key == ("invoke", "add"):
                upper += o.value
            elif key == ("ok", "add"):
                lower += o.value
        errors = [r for r in reads if not (r[0] <= r[1] <= r[2])]
        return {"valid": not errors, "reads": reads, "errors": errors}


def counter() -> CounterChecker:
    return CounterChecker()
