"""Operation histories (the port's own copy of the parts of
`jepsen_tpu.history` the per-key linearizability check needs).

Reference semantics: knossos.op + knossos.history and jepsen's history
vector. An operation is a record with

    process  int client process id, or a name like "nemesis"
    type     one of invoke / ok / fail / info
    f        operation function (e.g. read / write / cas)
    value    operation payload (input on invoke, result on ok)
    time     relative nanoseconds
    index    monotone position in the history
    error    optional error payload

Determinacy rules: an :ok completion means the op definitely happened;
:fail means it definitely did NOT happen; :info means unknown — the op
stays concurrent with every later op.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Sequence

import numpy as np


@dataclass
class Op:
    """One history event (knossos.op parity)."""

    process: Any
    type: str
    f: Any
    value: Any = None
    time: int = -1
    index: int = -1
    error: Any = None
    extra: dict = field(default_factory=dict)

    @property
    def is_invoke(self) -> bool:
        return self.type == "invoke"

    @property
    def is_ok(self) -> bool:
        return self.type == "ok"

    @property
    def is_fail(self) -> bool:
        return self.type == "fail"

    @property
    def is_info(self) -> bool:
        return self.type == "info"

    def with_(self, **kw) -> "Op":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        d = {
            "process": self.process,
            "type": self.type,
            "f": self.f,
            "value": self.value,
            "time": self.time,
            "index": self.index,
        }
        if self.error is not None:
            d["error"] = self.error
        if self.extra:
            d.update(self.extra)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Op":
        known = {"process", "type", "f", "value", "time", "index", "error"}
        return Op(
            process=d.get("process"),
            type=d.get("type"),
            f=d.get("f"),
            value=d.get("value"),
            time=d.get("time", -1),
            index=d.get("index", -1),
            error=d.get("error"),
            extra={k: v for k, v in d.items() if k not in known},
        )

    def __str__(self) -> str:
        return (
            f"{self.index}\t{self.process}\t{self.type}\t{self.f}\t{self.value}"
            + (f"\t{self.error}" if self.error is not None else "")
        )


def invoke_op(process, f, value=None, **kw) -> Op:
    return Op(process, "invoke", f, value, **kw)


def ok_op(process, f, value=None, **kw) -> Op:
    return Op(process, "ok", f, value, **kw)


def op(d) -> Op:
    return d if isinstance(d, Op) else Op.from_dict(d)


def index(history: Sequence[Op]) -> list[Op]:
    """Assign a monotone :index to each op (knossos.history/index)."""
    return [o.with_(index=i) for i, o in enumerate(history)]


def client_ops(history: Iterable[Op]) -> list[Op]:
    """Only ops from integer (client) processes."""
    return [o for o in history if isinstance(o.process, int)]


@dataclass
class Pair:
    """An invocation paired with its completion (None: never completed,
    which has the same concurrency semantics as an :info completion)."""

    invoke: Op
    completion: Op | None

    @property
    def ok(self) -> bool:
        return self.completion is not None and self.completion.is_ok

    @property
    def failed(self) -> bool:
        return self.completion is not None and self.completion.is_fail

    @property
    def crashed(self) -> bool:
        """Unknown outcome: :info completion or no completion at all."""
        return self.completion is None or self.completion.is_info

    @property
    def value(self):
        """Authoritative value: the completion's when ok (e.g. a read's
        result), else the invocation's."""
        if self.ok and self.completion.value is not None:
            return self.completion.value
        return self.invoke.value


def pairs(history: Sequence[Op]) -> list[Pair]:
    """Pair invocations with completions, in invocation order. Non-invoke
    ops without a pending invocation are dropped."""
    pending: dict = {}
    out: list[Pair] = []
    for o in history:
        if o.is_invoke:
            if o.process in pending:
                raise ValueError(
                    f"process {o.process} invoked twice without completing: {o}"
                )
            p = Pair(o, None)
            pending[o.process] = p
            out.append(p)
        else:
            p = pending.pop(o.process, None)
            if p is not None:
                p.completion = o
    return out


def complete(history: Sequence[Op]) -> list[Op]:
    """Rewrite the history so each :ok invocation carries its
    completion's value (knossos.history/complete)."""
    out = list(history)
    pending: dict = {}
    for i, o in enumerate(out):
        if o.is_invoke:
            pending[o.process] = i
        elif o.process in pending:
            j = pending.pop(o.process)
            if o.is_ok and o.value is not None:
                out[j] = out[j].with_(value=o.value)
    return out


@dataclass
class Entries:
    """A paired history prepared for linearizability search.

    Per entry e (one invoke + completion): f[e], value_in[e],
    value_out[e], crashed[e] (outcome unknown). call_pos[e] < ret_pos[e]
    are positions in the interleaved event sequence; crashed entries
    return after every real event, in invoke order. Failed pairs are
    excluded (they never happened).
    """

    f: list
    value_in: list
    value_out: list
    crashed: np.ndarray
    call_pos: np.ndarray
    ret_pos: np.ndarray
    invokes: list  # original invoke Ops, for counterexample reporting

    def __len__(self) -> int:
        return len(self.f)

    @property
    def n_completed(self) -> int:
        return int((~self.crashed).sum())


def entries(history: Sequence[Op]) -> Entries:
    """Build search entries from a raw client history."""
    ps = [p for p in pairs(client_ops(history)) if not p.failed]
    n = len(ps)
    f = [p.invoke.f for p in ps]
    value_in = [p.invoke.value for p in ps]
    value_out = [p.value for p in ps]
    crashed = np.array([p.crashed for p in ps], bool)
    call_pos = np.empty(n, np.int64)
    ret_pos = np.empty(n, np.int64)
    pos = 0
    op_to_entry = {id(p.invoke): i for i, p in enumerate(ps)}
    completion_to_entry = {
        id(p.completion): i for i, p in enumerate(ps) if p.completion is not None
    }
    for o in history:
        if id(o) in op_to_entry:
            call_pos[op_to_entry[id(o)]] = pos
            pos += 1
        elif id(o) in completion_to_entry:
            i = completion_to_entry[id(o)]
            if not crashed[i]:
                ret_pos[i] = pos
                pos += 1
    for i in range(n):
        if crashed[i]:
            ret_pos[i] = pos
            pos += 1
    return Entries(
        f=f,
        value_in=value_in,
        value_out=value_out,
        crashed=crashed,
        call_pos=call_pos,
        ret_pos=ret_pos,
        invokes=[p.invoke for p in ps],
    )
