"""Consistency models as pure state-transition functions (the port's
copy of `jepsen_tpu.models`: the models of the kernel path, and the
host-only NoOp and GrowOnlySet).

Parity target: knossos.model — `step(f, value)` returns a new model
state or an `Inconsistent`. `value` follows the completed-op
convention (a read's value is the value it RETURNED, or None if
unknown). The int32 kernel encodings of these models live in
`models.jit`; these objects are the semantics oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class Inconsistent:
    """A model transition that cannot happen (knossos.model/inconsistent)."""

    msg: str


def inconsistent(x: Any) -> bool:
    """knossos.model/inconsistent? parity."""
    return isinstance(x, Inconsistent)


class Model:
    """Base for all models. Subclasses must be immutable and hashable —
    the search memoizes on (linearized-bitset, model-state) pairs."""

    def step(self, f, value):  # -> Model | Inconsistent
        raise NotImplementedError

    def step_op(self, op):
        """Step with an Op or op dict."""
        from ..history import op as to_op

        o = to_op(op)
        return self.step(o.f, o.value)

    def components(self, es):
        """P-compositional decomposition hook ("Faster linearizability
        checking via P-compositionality", Horn & Kroening; ops/pcomp.py).
        When this model is a PRODUCT of independent sub-objects and every
        entry of `es` (a history.Entries) touches exactly one of them,
        return a list of

            (sub_model, entry_indices, rewrite)

        components: the history is then linearizable iff each
        component's projection is. `rewrite` is None or an (f, value) ->
        (f, value) mapping applied to projected entries (a single-key
        txn becomes a plain register op, which has a kernel encoding).
        An entry that can NEVER linearize and is optional (a crashed op
        with unknown payload) may be dropped from every component.
        Return None when the history doesn't decompose."""
        return None


@dataclass(frozen=True)
class NoOp(Model):
    """Every operation is fine (knossos.model/noop)."""

    def step(self, f, value):
        return self


@dataclass(frozen=True)
class Register(Model):
    """A read/write register (knossos.model/register). value None = unset."""

    value: Any = None

    def step(self, f, value):
        if f == "write":
            return Register(value)
        if f == "read":
            if value is None or value == self.value:
                return self
            return Inconsistent(
                f"read {value!r} from register holding {self.value!r}"
            )
        return Inconsistent(f"unknown op {f!r}")


@dataclass(frozen=True)
class CASRegister(Model):
    """A compare-and-set register (knossos.model/cas-register)."""

    value: Any = None

    def step(self, f, value):
        if f == "write":
            return CASRegister(value)
        if f == "cas":
            if value is None:
                return Inconsistent("cas with unknown arguments")
            old, new = value
            if self.value == old:
                return CASRegister(new)
            return Inconsistent(f"can't CAS {self.value!r} from {old!r} to {new!r}")
        if f == "read":
            if value is None or value == self.value:
                return self
            return Inconsistent(
                f"can't read {value!r} from register holding {self.value!r}"
            )
        return Inconsistent(f"unknown op {f!r}")


@dataclass(frozen=True)
class Mutex(Model):
    """A lock (knossos.model/mutex)."""

    locked: bool = False

    def step(self, f, value):
        if f == "acquire":
            if self.locked:
                return Inconsistent("cannot acquire a held lock")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return Inconsistent("cannot release a free lock")
            return Mutex(False)
        return Inconsistent(f"unknown op {f!r}")


def _freeze_map(d: dict) -> tuple:
    """A canonical (key, value) tuple for a register map, so ==-equal
    maps compare and hash equal in the search memo. Unorderable keys fall
    back to a type-aware sort key (memo pruning only, never
    soundness)."""
    try:
        return tuple(sorted(d.items()))
    except TypeError:
        return tuple(sorted(
            d.items(), key=lambda kv: (type(kv[0]).__name__, repr(kv[0]))))


def _freeze_multiset(items) -> tuple:
    """A canonical tuple for a multiset, so ==-equal pending sets compare
    and hash equal in the search memo. Unorderable payloads fall back to
    a type-aware sort key (memo pruning only, never soundness)."""
    try:
        return tuple(sorted(items))
    except TypeError:
        return tuple(sorted(items, key=lambda x: (type(x).__name__, repr(x))))


@dataclass(frozen=True)
class UnorderedQueue(Model):
    """A queue where dequeues may come back in any order
    (knossos.model/unordered-queue). State is a frozen multiset."""

    pending: tuple = ()

    def step(self, f, value):
        if f == "enqueue":
            return UnorderedQueue(_freeze_multiset(self.pending + (value,)))
        if f == "dequeue":
            if value in self.pending:
                items = list(self.pending)
                items.remove(value)
                return UnorderedQueue(_freeze_multiset(items))
            return Inconsistent(f"can't dequeue {value!r}")
        return Inconsistent(f"unknown op {f!r}")

    def components(self, es):
        """By VALUE: the multiset is one counter per value and
        enqueue(v)/dequeue(v) touch only v's counter. A crashed dequeue
        that recorded no value steps to Inconsistent (it can never
        linearize) and is optional, so it drops. An entry with an op the
        model doesn't know makes its own lane invalid, which is the
        whole history's verdict either way."""
        if self.pending:
            return None
        groups: dict = {}
        try:
            for i, (f, v, crashed) in enumerate(
                    zip(es.f, es.value_out, es.crashed)):
                if f == "dequeue" and crashed and v is None:
                    continue  # can never linearize; optional -> absent
                groups.setdefault(v, []).append(i)
        except TypeError:  # unhashable payload
            return None
        return [(UnorderedQueue(), idx, None) for idx in groups.values()]


@dataclass(frozen=True)
class FIFOQueue(Model):
    """A strictly-ordered queue (knossos.model/fifo-queue)."""

    items: tuple = ()

    def step(self, f, value):
        if f == "enqueue":
            return FIFOQueue(self.items + (value,))
        if f == "dequeue":
            if self.items and self.items[0] == value:
                return FIFOQueue(self.items[1:])
            head = self.items[0] if self.items else None
            return Inconsistent(f"expected dequeue of {head!r}, got {value!r}")
        return Inconsistent(f"unknown op {f!r}")


@dataclass(frozen=True)
class MultiRegister(Model):
    """A map of named registers stepped by "txn" ops
    (knossos.model/multi-register). The op value is a sequence of
    micro-ops [f, k, v] with f "r"/"read" or "w"/"write", applied
    atomically in order; a read of an unwritten register observes its
    initial value (None unless given in `registers`). State is a frozen
    sorted (key, value) tuple."""

    registers: tuple = ()

    def step(self, f, value):
        if f != "txn":
            return Inconsistent(f"unknown op {f!r}")
        if value is None:
            return Inconsistent("txn with unknown micro-ops")
        if not isinstance(value, (list, tuple)):
            return Inconsistent(f"malformed txn payload {value!r}")
        regs = dict(self.registers)
        for micro in value:
            try:
                mf, k, v = micro
            except (TypeError, ValueError):
                return Inconsistent(f"malformed micro-op {micro!r}")
            if mf in ("w", "write"):
                regs[k] = v
            elif mf in ("r", "read"):
                if v is not None and regs.get(k) != v:
                    return Inconsistent(
                        f"read {v!r} from register {k!r} holding "
                        f"{regs.get(k)!r}")
            else:
                return Inconsistent(f"unknown micro-op f {mf!r}")
        return MultiRegister(_freeze_map(regs))

    def components(self, es):
        """By KEY, when every kept entry is a SINGLE-micro-op txn: the map
        is a product of per-key registers and a one-key txn touches
        exactly one of them. Projected entries REWRITE to plain register
        ops ([['w', k, v]] -> write v, [['r', k, v]] -> read v), so the
        micro-lanes get the Register kernel encoding. Multi-micro-op
        txns couple keys; the history then stays on the full search. A
        crashed txn with no recorded micro-ops can never linearize and
        is optional, so it drops."""
        inits = dict(self.registers)
        groups: dict = {}
        for i, (f, v, crashed) in enumerate(
                zip(es.f, es.value_out, es.crashed)):
            if crashed and v is None:
                continue  # can never linearize; optional -> absent
            if (f != "txn" or not isinstance(v, (list, tuple))
                    or len(v) != 1):
                return None
            try:
                mf, k, _val = v[0]
            except (TypeError, ValueError):
                return None
            if mf not in ("r", "read", "w", "write"):
                return None
            try:
                groups.setdefault(k, []).append(i)
            except TypeError:  # unhashable key
                return None

        def rewrite(f, value):
            # rewrite also sees value_IN: a malformed invoke payload
            # beside a well-formed completion degrades to an
            # unconstraining read (the search steps value_out only)
            if (not isinstance(value, (list, tuple))
                    or len(value) != 1):
                return "read", None
            try:
                mf, _k, val = value[0]
            except (TypeError, ValueError):
                return "read", None
            return (("write", val) if mf in ("w", "write")
                    else ("read", val))

        return [(Register(inits.get(k)), idx, rewrite)
                for k, idx in groups.items()]


@dataclass(frozen=True)
class GrowOnlySet(Model):
    """A set supporting add and read-everything (knossos model/set shape;
    used by set workloads)."""

    items: frozenset = frozenset()

    def step(self, f, value):
        if f == "add":
            return GrowOnlySet(self.items | {value})
        if f == "read":
            if value is None or frozenset(value) == self.items:
                return self
            return Inconsistent(f"read {value!r} but set is {sorted(self.items)!r}")
        return Inconsistent(f"unknown op {f!r}")


# convenience constructors mirroring knossos.model's lowercase fns
def noop() -> NoOp:
    return NoOp()


def register(value=None) -> Register:
    return Register(value)


def cas_register(value=None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()
