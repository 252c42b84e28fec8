"""Consistency models as pure state-transition functions (the port's
copy of the `jepsen_tpu.models` the kernel path covers).

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


# convenience constructors mirroring knossos.model's lowercase fns
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
