"""Operation histories (the port's own copy of the parts of
`jepsen_tpu.history` the port's checkers and store need).

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
from typing import Any, Callable, Iterable, Sequence

import numpy as np

# Op types (tensor encoding values)
INVOKE, OK, FAIL, INFO = 0, 1, 2, 3
TYPE_NAMES = ("invoke", "ok", "fail", "info")
TYPE_INDEX = {n: i for i, n in enumerate(TYPE_NAMES)}

# Reserved process encodings for non-client processes in tensors
NEMESIS_PROCESS = -1

# int64 sentinel for "no value" in tensor columns
NIL = np.int64(2**62)


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


def fail_op(process, f, value=None, **kw) -> Op:
    return Op(process, "fail", f, value, **kw)


def info_op(process, f, value=None, **kw) -> Op:
    return Op(process, "info", f, value, **kw)


def op(d) -> Op:
    return d if isinstance(d, Op) else Op.from_dict(d)


def ops(history: Iterable) -> list[Op]:
    """Coerce a whole history of dicts/Ops to Op records."""
    return [op(o) for o in history]


def index(history: Sequence[Op]) -> list[Op]:
    """Assign a monotone :index to each op (knossos.history/index)."""
    return [o.with_(index=i) for i, o in enumerate(history)]


def client_ops(history: Iterable[Op]) -> list[Op]:
    """Only ops from integer (client) processes."""
    return [o for o in history if isinstance(o.process, int)]


def processes(history: Iterable[Op]) -> list:
    """Distinct processes in order of first appearance."""
    seen: dict = {}
    for o in history:
        if o.process not in seen:
            seen[o.process] = True
    return list(seen)


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


def crashed_invokes(history: Sequence[Op]) -> list[Op]:
    """Invocations whose outcome is unknown."""
    return [p.invoke for p in pairs(history) if p.crashed]


# ---------------------------------------------------------------------------
# Tensor encoding (the store's history.npz)

class FSchema:
    """Maps workload op functions and values onto fixed int64 columns.

    A schema declares the known :f names (index = encoding) and how a
    value encodes into `width` int64 columns. The default covers
    register-style workloads: read/write take one scalar column, cas takes
    two. Unencodable values raise, so lossy conversions are explicit.
    """

    def __init__(
        self,
        fs: Sequence[str],
        width: int = 2,
        encode_value: Callable[[Any, Any], Sequence] | None = None,
        decode_value: Callable[[Any, Sequence], Any] | None = None,
    ):
        self.fs = list(fs)
        self.f_index = {f: i for i, f in enumerate(self.fs)}
        self.width = width
        self._encode = encode_value or self._default_encode
        self._decode = decode_value or self._default_decode

    @staticmethod
    def _encode_scalar(v):
        if v is None:
            return NIL
        v = int(v)
        if abs(v) >= NIL:
            raise OverflowError(
                f"value {v} collides with the NIL sentinel (|v| >= 2^62)"
            )
        return np.int64(v)

    def _default_encode(self, f, value):
        cols = [NIL] * self.width
        if value is None:
            return cols
        if isinstance(value, (tuple, list)):
            for i, v in enumerate(value):
                cols[i] = self._encode_scalar(v)
        else:
            cols[0] = self._encode_scalar(value)
        return cols

    def _default_decode(self, f, cols):
        vals = [None if c == NIL else int(c) for c in cols]
        if f == "cas":
            return (vals[0], vals[1])
        return vals[0]


REGISTER_SCHEMA = FSchema(["read", "write", "cas"], width=2)


class TensorHistory:
    """Structure-of-arrays history: one row per op.

    Columns: process int64, type int64 (INVOKE/OK/FAIL/INFO), f int64
    (schema index), value int64[width], time int64, index int64. In the
    port it is the store's history.npz, byte-compatible with the JAX
    package's.
    """

    COLUMNS = ("process", "type", "f", "time", "index")

    def __init__(
        self,
        process: np.ndarray,
        type_: np.ndarray,
        f: np.ndarray,
        value: np.ndarray,
        time: np.ndarray,
        index_: np.ndarray,
        schema: FSchema,
        process_names: dict | None = None,
        aux: dict | None = None,
    ):
        self.process = process
        self.type = type_
        self.f = f
        self.value = value
        self.time = time
        self.index = index_
        self.schema = schema
        # encoding -> original process name, for non-int processes
        self.process_names = process_names or {}
        # row -> original (f, value) for ops outside the schema (nemesis
        # fs with arbitrary payloads): columns hold NIL, this restores
        # them losslessly on decode
        self.aux = aux or {}

    def __len__(self) -> int:
        return len(self.process)

    @staticmethod
    def encode(
        history: Sequence[Op], schema: FSchema = REGISTER_SCHEMA
    ) -> "TensorHistory":
        n = len(history)
        process = np.empty(n, np.int64)
        type_ = np.empty(n, np.int64)
        f = np.empty(n, np.int64)
        value = np.full((n, schema.width), NIL, np.int64)
        time = np.empty(n, np.int64)
        index_ = np.empty(n, np.int64)
        names: dict = {}
        name_codes: dict = {}
        aux: dict = {}
        for i, o in enumerate(history):
            if isinstance(o.process, int):
                process[i] = o.process
            else:
                code = name_codes.setdefault(
                    o.process, NEMESIS_PROCESS - len(name_codes)
                )
                names[code] = o.process
                process[i] = code
            type_[i] = TYPE_INDEX[o.type]
            if o.f in schema.f_index:
                # In-schema (client) ops encode strictly: overflow raises
                f[i] = schema.f_index[o.f]
                value[i] = schema._encode(o.f, o.value)
            else:
                # Out-of-schema ops (nemesis start/stop with arbitrary
                # payloads): columns stay NIL, original kept in aux
                f[i] = -1
                aux[i] = (o.f, o.value)
            time[i] = o.time
            index_[i] = o.index if o.index >= 0 else i
        return TensorHistory(
            process, type_, f, value, time, index_, schema, names, aux
        )

    def decode(self) -> list[Op]:
        out = []
        for i in range(len(self)):
            p = int(self.process[i])
            proc = self.process_names.get(p, p)
            fi = int(self.f[i])
            if i in self.aux:
                fname, val = self.aux[i]
            elif 0 <= fi < len(self.schema.fs):
                fname = self.schema.fs[fi]
                val = self.schema._decode(fname, self.value[i])
            else:
                fname, val = None, None
            out.append(
                Op(
                    process=proc,
                    type=TYPE_NAMES[int(self.type[i])],
                    f=fname,
                    value=val,
                    time=int(self.time[i]),
                    index=int(self.index[i]),
                )
            )
        return out

    def save(self, path) -> None:
        import json

        aux_json = json.dumps(
            {str(k): [v[0], repr(v[1])] for k, v in self.aux.items()}
        )
        np.savez_compressed(
            path,
            process=self.process,
            type=self.type,
            f=self.f,
            value=self.value,
            time=self.time,
            index=self.index,
            fs=np.array(self.schema.fs),
            process_names_k=np.array(list(self.process_names.keys()), np.int64),
            process_names_v=np.array([str(v) for v in self.process_names.values()]),
            aux=np.array(aux_json),
        )

    @staticmethod
    def load(path) -> "TensorHistory":
        import ast
        import json

        z = np.load(path, allow_pickle=False)
        schema = FSchema([str(x) for x in z["fs"]], width=z["value"].shape[1])
        names = {
            int(k): str(v)
            for k, v in zip(z["process_names_k"], z["process_names_v"])
        }
        aux = {}
        if "aux" in z:
            for k, (fname, vrepr) in json.loads(str(z["aux"])).items():
                try:
                    val = ast.literal_eval(vrepr)
                except (ValueError, SyntaxError):
                    val = vrepr
                aux[int(k)] = (fname, val)
        return TensorHistory(
            z["process"], z["type"], z["f"], z["value"], z["time"], z["index"],
            schema, names, aux,
        )


# ---------------------------------------------------------------------------
# Entry form: the search input

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
