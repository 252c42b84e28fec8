"""Dgraph workloads: bank, delete, sequential, linearizable-register,
and long-fork — the transactional suites of the reference
(dgraph/src/jepsen/dgraph/{bank,delete,sequential,
linearizable_register,long_fork}.clj), driven through the MVCC txn
layer in dgraph.py/dgraph_sim.py.

Shapes mirrored from the reference:

- bank stripes keys/amounts/types across PRED_COUNT predicates
  (bank.clj:14-15) so the tablet-mover nemesis splits accounts across
  groups; zero-balance accounts are deleted and recreated on demand
  (bank.clj:85-99's write-account!).
- delete checks that index reads never surface half-deleted records
  (delete.clj:66-89).
- sequential restricts txns to read-only or write-your-full-read-set,
  then requires per-process monotonic register observations
  (sequential.clj:1-49).
- linearizable-register is the stock per-key CAS register bundle with
  reads-as-fail-on-timeout (linearizable_register.clj:24-31).
- long-fork is the stock incompatible-snapshot-order workload over
  single-key write txns (long_fork.clj via dgraph/long_fork.clj:1-8).

The port's copy of `jepsen_tpu/dbs/dgraph_workloads.py`. The test map's
`device` (the CLI's `--device`; None = the card) goes to the register
workloads' per-key `linearizable` (K1 or K5) and to long-fork's cycle
checker (K3's `closure_word`); the other checkers run on the host.
"""

from __future__ import annotations

import itertools
import logging
import random
import socket
import threading
import urllib.error

from .. import checker as checker_mod
from .. import generator as gen, independent, trace
from .. import client as client_mod
from ..checker import Checker
from ..history import Op, ops as _ops
from ..workloads import bank as bank_wl
from ..workloads import linearizable_register as lr_wl
from ..workloads import long_fork as lf_wl
from .. import txn as mop
from .dgraph import (DgraphConn, DgraphError, TxnConflict, node_host,
                     node_port, with_conflict_as_fail, with_txn)

log = logging.getLogger("jepsen_tpu_torch.dbs.dgraph")

NETWORK_ERRORS = (socket.timeout, TimeoutError, urllib.error.URLError,
                  ConnectionError, OSError)

PRED_COUNT = 3  # bank.clj:14-15


def gen_pred(prefix: str, k: int) -> str:
    """Predicate for key k, striped across PRED_COUNT predicates
    (client.clj's gen-pred)."""
    return f"{prefix}_{k % PRED_COUNT}"


def gen_preds(prefix: str) -> list:
    return [f"{prefix}_{i}" for i in range(PRED_COUNT)]


def _open_conn(test, node) -> DgraphConn:
    return DgraphConn(node_host(test, node), node_port(test, node))


def _upsert_directive(test) -> str:
    """' @upsert' when the test runs with the upsert schema (the
    reference's --upsert-schema option, on by default here: without it
    concurrent insert-if-absent races produce duplicate records, e.g.
    bank.clj:111-117, linearizable_register.clj:40-43)."""
    return " @upsert" if test.get("upsert_schema", True) else ""


def _complete(op: Op, body, read_only: bool) -> Op:
    """Shared completion taxonomy for every transactional client:
    conflicts are safe :fail (the txn did not apply,
    client.clj:105-167); other errors :fail for idempotent read-only
    ops and :info (indeterminate) for writes
    (linearizable_register.clj:24-31's read-info->fail)."""

    def run():
        try:
            return body()
        except TxnConflict:
            raise  # with_conflict_as_fail's job (subclass of DgraphError)
        except (DgraphError, *NETWORK_ERRORS) as e:
            crash = "fail" if read_only else "info"
            return op.with_(type=crash, error=str(e))

    return with_conflict_as_fail(op, run)


# ---------------------------------------------------------------------------
# Bank (bank.clj)


def _acct_row_to_key_amount(row: dict) -> tuple:
    """{'key_0': 1, 'amount_2': 5, ...} -> (1, 5)
    (bank.clj:17-34's multi-pred-acct->key+amount)."""
    key = amount = None
    for pred, v in row.items():
        if pred.startswith("key_"):
            assert key is None, f"multiple keys in {row!r}"
            key = v
        elif pred.startswith("amount_"):
            assert amount is None, f"multiple amounts in {row!r}"
            amount = v
    return key, amount


class BankClient(client_mod.Client):
    """Striped-predicate bank accounts (bank.clj:36-180)."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        return BankClient(_open_conn(test, node))

    def setup(self, test):
        with trace.with_trace("bank.setup"):
            up = _upsert_directive(test)
            schema = "".join(
                f"{p}: int @index(int){up} .\n" for p in gen_preds("key")
            ) + "".join(
                f"{p}: string @index(exact) .\n" for p in gen_preds("type")
            ) + "".join(
                f"{p}: int .\n" for p in gen_preds("amount"))
            self.conn.alter(schema)
            # Seed the whole total into the first account
            # (bank.clj:130-141); races between clients are benign.
            k = test["accounts"][0]
            try:
                with with_txn(self.conn) as t:
                    if not t.query(self._key_query(k, with_amount=False)):
                        t.mutate(sets=[self._record(
                            k, test["total_amount"])])
            except TxnConflict:
                pass

    @staticmethod
    def _record(k: int, amount: int, uid: str | None = None) -> dict:
        rec = {gen_pred("key", k): k,
               gen_pred("type", k): "account",
               gen_pred("amount", k): amount}
        if uid is not None:
            rec["uid"] = uid
        return rec

    @staticmethod
    def _key_query(k: int, with_amount: bool = True) -> str:
        kp, ap = gen_pred("key", k), gen_pred("amount", k)
        fields = f"uid {kp} {ap}" if with_amount else "uid"
        return f"{{ q(func: eq({kp}, {k})) {{ {fields} }} }}"

    def _find_account(self, t, k: int) -> dict:
        """{'uid'?, 'key', 'amount'} — a fresh zero account when absent
        (bank.clj:60-82)."""
        rows = t.query(self._key_query(k))
        if rows:
            key, amount = _acct_row_to_key_amount(rows[0])
            return {"uid": rows[0]["uid"], "key": key, "amount": amount}
        return {"key": k, "amount": 0}

    def _write_account(self, t, acct: dict) -> None:
        """Zero-balance accounts are deleted; others written back
        (bank.clj:85-99)."""
        if acct["amount"] == 0 and acct.get("uid"):
            t.mutate(dels=[{"uid": acct["uid"]}])
        elif acct["amount"] != 0:
            t.mutate(sets=[self._record(
                acct["key"], acct["amount"], acct.get("uid"))])

    def _read_accounts(self, t) -> dict:
        """All accounts across every type predicate (bank.clj:36-58)."""
        fields = " ".join(["uid"] + gen_preds("key") + gen_preds("amount"))
        out = {}
        for tp in gen_preds("type"):
            rows = t.query(
                f'{{ q(func: eq({tp}, "account")) {{ {fields} }} }}')
            for row in rows:
                key, amount = _acct_row_to_key_amount(row)
                if key is not None:
                    out[key] = amount
        return out

    def invoke(self, test, op: Op) -> Op:
        def body():
            if op.f == "read":
                with with_txn(self.conn) as t:
                    val = self._read_accounts(t)
                return op.with_(type="ok", value=val)
            if op.f == "transfer":
                v = op.value
                t = self.conn.txn()
                try:
                    frm = self._find_account(t, v["from"])
                    to = self._find_account(t, v["to"])
                    frm = {**frm, "amount": frm["amount"] - v["amount"]}
                    to = {**to, "amount": to["amount"] + v["amount"]}
                    if frm["amount"] < 0:
                        # Insufficient funds: abort, nothing applied
                        # (bank.clj:176-180 backs the txn out).
                        return op.with_(type="fail",
                                        error="insufficient-funds")
                    self._write_account(t, frm)
                    self._write_account(t, to)
                    t.commit()
                    return op.with_(type="ok")
                finally:
                    t.discard()
            raise ValueError(f"unknown op {op.f!r}")

        with trace.with_trace("bank.invoke"):
            return _complete(op, body, read_only=op.f == "read")

    def close(self, test):
        pass


def bank_workload(opts: dict) -> dict:
    n = opts.get("accounts", 5)
    total = opts.get("total_amount", 100)
    return {
        "name": "bank",
        "client": BankClient(),
        "during": gen.stagger(opts.get("stagger", 0.05),
                              bank_wl.generator()),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "bank": bank_wl.checker(),
            "plot": bank_wl.plotter(),
        }),
        "test_opts": {"accounts": list(range(n)),
                      "total_amount": total,
                      "max_transfer": opts.get("max_transfer", 5)},
    }


# ---------------------------------------------------------------------------
# Delete (delete.clj)


class DeleteClient(client_mod.Client):
    """Upsert/delete/read of indexed records per key (delete.clj:23-64);
    values are independent (k, v) tuples."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        conn = _open_conn(test, node)
        conn.alter(f"key: int @index(int){_upsert_directive(test)} .")
        return DeleteClient(conn)

    def invoke(self, test, op: Op) -> Op:
        k = op.value[0] if isinstance(op.value, tuple) else op.value

        def body():
            if op.f == "read":
                with with_txn(self.conn) as t:
                    rows = t.query(
                        f"{{ q(func: eq(key, {k})) {{ uid key }} }}")
                return op.with_(type="ok",
                                value=independent.tuple_(k, rows))
            if op.f == "upsert":
                with with_txn(self.conn) as t:
                    uids = t.mutate(
                        sets=[{"key": k}],
                        query=f"{{ v(func: eq(key, {k})) {{ uid }} }}",
                        cond="@if(eq(len(v), 0))")
                if not uids:
                    return op.with_(type="fail", error="present")
                return op.with_(type="ok")
            if op.f == "delete":
                with with_txn(self.conn) as t:
                    rows = t.query(
                        f"{{ q(func: eq(key, {k})) {{ uid }} }}")
                    if not rows:
                        return op.with_(type="fail", error="not-found")
                    t.mutate(dels=[{"uid": rows[0]["uid"]}])
                return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")

        return _complete(op, body, read_only=op.f == "read")

    def close(self, test):
        pass


class DeleteChecker(Checker):
    """Every ok read sees nothing, or exactly one {uid, key} record for
    its key (delete.clj:66-89)."""

    def check(self, test, history, opts=None) -> dict:
        k = (opts or {}).get("history_key")
        bad = []
        for o in _ops(history):
            if not (o.is_ok and o.f == "read"):
                continue
            rows = o.value[1] if isinstance(o.value, tuple) else o.value
            if len(rows) == 0:
                continue
            if (len(rows) == 1 and set(rows[0]) == {"uid", "key"}
                    and (k is None or rows[0]["key"] == k)):
                continue
            bad.append(o.to_dict())
        return {"valid": not bad, "bad_reads": bad}


def _d_r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def _d_u(test, process):
    return {"type": "invoke", "f": "upsert", "value": None}


def _d_d(test, process):
    return {"type": "invoke", "f": "delete", "value": None}


def delete_workload(opts: dict) -> dict:
    n = len(opts["nodes"])
    return {
        "name": "delete",
        "client": DeleteClient(),
        "during": independent.concurrent_generator(
            2 * n, itertools.count(),
            lambda k: gen.limit(
                opts.get("ops_per_key", 1000),
                gen.stagger(0.01, gen.mix([_d_r, _d_u, _d_d])))),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "deletes": independent.checker(checker_mod.compose({
                "deletes": DeleteChecker(),
                "timeline": checker_mod.timeline_html(),
            })),
        }),
    }


# ---------------------------------------------------------------------------
# Sequential (sequential.clj)


class SequentialClient(client_mod.Client):
    """Read-only txns and read-inc-write txns on per-key counters;
    values are (k, observed-count) tuples (sequential.clj:66-105)."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        conn = _open_conn(test, node)
        conn.alter(f"key: int @index(int){_upsert_directive(test)} .\n"
                   "value: int @index(int) .\n")
        return SequentialClient(conn)

    def invoke(self, test, op: Op) -> Op:
        k = op.value[0] if isinstance(op.value, tuple) else op.value

        def body():
            with with_txn(self.conn) as t:
                rows = t.query(
                    f"{{ q(func: eq(key, {k})) {{ uid value }} }}")
                if op.f == "inc":
                    value = (rows[0].get("value", 0) if rows else 0) + 1
                    if rows:
                        t.mutate(sets=[{"uid": rows[0]["uid"],
                                        "value": value}])
                    else:
                        t.mutate(sets=[{"key": k, "value": value}])
                    return op.with_(type="ok",
                                    value=independent.tuple_(k, value))
                if op.f == "read":
                    value = rows[0].get("value", 0) if rows else 0
                    return op.with_(type="ok",
                                    value=independent.tuple_(k, value))
            raise ValueError(f"unknown op {op.f!r}")

        return _complete(op, body, read_only=op.f == "read")

    def close(self, test):
        pass


def non_monotonic_pairs(history) -> list:
    """Same-process consecutive ok ops where the observed register
    value decreased (sequential.clj:107-124). Values may be (k, count)
    tuples, or bare counts inside an independent subhistory."""
    last: dict = {}
    bad = []
    for o in _ops(history):
        if not o.is_ok:
            continue
        v = o.value[1] if isinstance(o.value, tuple) else o.value
        if not isinstance(v, int):
            continue
        prev = last.get(o.process)
        if prev is not None and v < prev[0]:
            bad.append([prev[1], o.to_dict()])
        last[o.process] = (v, o.to_dict())
    return bad


class SequentialChecker(Checker):
    """Per-process monotonicity of observed counts
    (sequential.clj:126-141)."""

    def check(self, test, history, opts=None) -> dict:
        bad = non_monotonic_pairs(history)
        return {"valid": not bad, "non_monotonic": bad}


def _s_inc(test, process):
    return {"type": "invoke", "f": "inc", "value": None}


def _s_read(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def sequential_workload(opts: dict) -> dict:
    n = len(opts["nodes"])
    return {
        "name": "sequential",
        "client": SequentialClient(),
        "during": independent.concurrent_generator(
            n, itertools.count(),
            lambda k: gen.limit(
                opts.get("ops_per_key", 500),
                gen.stagger(0.01, gen.mix([_s_inc, _s_read])))),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "sequential": independent.checker(checker_mod.compose({
                "sequential": SequentialChecker(),
                "timeline": checker_mod.timeline_html(),
            })),
        }),
    }


# ---------------------------------------------------------------------------
# Linearizable register (linearizable_register.clj)


class LrClient(client_mod.Client):
    """Single key/value predicates, read/write/cas in a txn
    (linearizable_register.clj:33-67). Read timeouts demote :info to
    :fail — reads are idempotent (linearizable_register.clj:24-31)."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        conn = _open_conn(test, node)
        conn.alter(f"key: int @index(int){_upsert_directive(test)} .\n"
                   "value: int .\n")
        return LrClient(conn)

    def _read(self, t, k: int) -> dict | None:
        rows = t.query(f"{{ q(func: eq(key, {k})) {{ uid value }} }}")
        assert len(rows) < 2, f"multiple records for key {k}: {rows!r}"
        return rows[0] if rows else None

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value

        def body():
            with with_txn(self.conn) as t:
                if op.f == "read":
                    rec = self._read(t, k)
                    return op.with_(
                        type="ok",
                        value=independent.tuple_(
                            k, rec.get("value") if rec else None))
                if op.f == "write":
                    rec = self._read(t, k)
                    if rec:
                        t.mutate(sets=[{"uid": rec["uid"], "value": v}])
                    else:
                        t.mutate(sets=[{"key": k, "value": v}])
                    return op.with_(type="ok")
                if op.f == "cas":
                    expect, new = v
                    rec = self._read(t, k)
                    if not rec or rec.get("value") != expect:
                        return op.with_(type="fail",
                                        error="value-mismatch")
                    t.mutate(sets=[{"uid": rec["uid"], "value": new}])
                    return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")

        return _complete(op, body, read_only=op.f == "read")

    def close(self, test):
        pass


def lr_workload(opts: dict) -> dict:
    wl = lr_wl.test(opts)
    return {
        "name": "linearizable-register",
        "client": LrClient(),
        "during": gen.stagger(0.01, wl["generator"]),
        "model": wl["model"],
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "register": wl["checker"],
        }),
    }


# ---------------------------------------------------------------------------
# Long fork (long_fork.clj via dgraph/long_fork.clj)


class LongForkClient(client_mod.Client):
    """Executes [f k v] micro-op txns: single-key write txns and
    multi-key read txns, all in one dgraph transaction."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        conn = _open_conn(test, node)
        conn.alter(f"key: int @index(int){_upsert_directive(test)} .\n"
                   "value: int .\n")
        return LongForkClient(conn)

    def invoke(self, test, op: Op) -> Op:
        def body():
            with with_txn(self.conn) as t:
                out = []
                for m in op.value:
                    if mop.is_write(m):
                        rows = t.query(
                            f"{{ q(func: eq(key, {mop.key(m)}))"
                            " { uid } }")
                        sets = [{"key": mop.key(m), "value": mop.value(m)}]
                        if rows:
                            sets[0]["uid"] = rows[0]["uid"]
                        t.mutate(sets=sets)
                        out.append(m)
                    else:
                        rows = t.query(
                            f"{{ q(func: eq(key, {mop.key(m)}))"
                            " { value } }")
                        val = rows[0].get("value") if rows else None
                        out.append([mop.READ, mop.key(m), val])
            return op.with_(type="ok", value=out)

        return _complete(op, body,
                         read_only=all(mop.is_read(m) for m in op.value))

    def close(self, test):
        pass


def long_fork_workload(opts: dict) -> dict:
    wl = lf_wl.workload(opts.get("long_fork_n", 2),
                        device=opts.get("device"))
    return {
        "name": "long-fork",
        "client": LongForkClient(),
        "during": gen.stagger(0.01, wl["generator"]),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "long-fork": wl["checker"],
        }),
    }


# ---------------------------------------------------------------------------
# Types (types.clj): type safety & integer overflow hunting


def type_cases() -> list:
    """[attribute, value] pairs sweeping the integer boundaries where
    type systems break (types.clj:137-165): ranges around byte/short/
    int/long maxima (positive and negative), the largest exactly-
    float/double-representable integers, and values well outside
    signed 64-bit."""
    interesting = [
        0,
        (1 << 7) - 1,        # Byte/MAX_VALUE
        (1 << 15) - 1,       # Short/MAX_VALUE
        (1 << 31) - 1,       # Integer/MAX_VALUE
        (1 << 63) - 1,       # Long/MAX_VALUE
        16777217,            # largest exact-float int + 1
        9007199254740993,    # largest exact-double int + 1
        3 * ((1 << 63) - 1),  # well outside signed longs
    ]
    values: list = []
    for x in interesting:
        values.extend(range(x - 8, x + 8))
        values.extend(range(-x - 8, -x + 8))
    # nsect-style probe between two near-Long.MAX points
    lo, hi = 9223372036854775293, 9223372036854775299
    values.extend(lo + (hi - lo) * i // 15 for i in range(16))
    seen: set = set()
    out = []
    for a in ("foo", "int64"):
        for v in values:
            if (a, v) not in seen:
                seen.add((a, v))
                out.append([a, v])
    return out


class TypesClient(client_mod.Client):
    """Writes entity-attribute-value triples and reads them back by
    uid (types.clj:24-57). Values are [e, a, v] triples; writes create
    fresh entities and complete with the assigned uid."""

    def __init__(self, conn=None, entities=None):
        self.conn = conn
        self.entities = entities if entities is not None else []

    def open(self, test, node):
        conn = _open_conn(test, node)
        # 'foo' is deliberately schemaless; only int64 declares a type
        # (types.clj:29-30)
        conn.alter("int64: int .\n")
        return TypesClient(conn, self.entities)

    def invoke(self, test, op: Op) -> Op:
        e, a, v = op.value

        def body():
            with with_txn(self.conn) as t:
                if op.f == "write":
                    uids = t.mutate(sets=[{a: v}])
                    uid = next(iter(uids.values()))
                    # record the attribute too: the final phase reads
                    # each entity under the one attribute it was
                    # written with, not the full cross product
                    self.entities.append((uid, a))
                    return op.with_(type="ok", value=[uid, a, v])
                if op.f == "read":
                    rows = t.query(
                        f"{{ q(func: uid({e})) {{ {a} }} }}")
                    got = rows[0].get(a) if rows else None
                    return op.with_(type="ok", value=[e, a, got])
            raise ValueError(f"unknown op {op.f!r}")

        return _complete(op, body, read_only=op.f == "read")

    def close(self, test):
        pass


class TypesChecker(Checker):
    """Everything written must read back EXACTLY (types.clj:59-125):
    errs collect (entity, attribute, wrote, read) mismatches — the
    signature of float64 coercion or int64 overflow; writes that were
    never successfully read make the verdict unknown, not valid."""

    def check(self, test, history, opts=None) -> dict:
        state: dict = {}
        dup_writes = []
        for o in _ops(history):
            if o.is_ok and o.f == "write":
                e, a, v = o.value
                if (e, a) in state:
                    # the reference assert+'s here; a checker must
                    # never crash on the anomaly it hunts — report it
                    dup_writes.append({"entity": e, "attribute": a})
                    continue
                state[(e, a)] = v
        read_state: dict = {}
        inconsistent = []
        errs = []
        for o in _ops(history):
            if not (o.is_ok and o.f == "read"):
                continue
            e, a, v = o.value
            prev = read_state.get((e, a), v)
            if prev != v:
                # two ok reads of the same (entity, attribute) that
                # disagree — e.g. a stale replica under a nemesis
                inconsistent.append({"entity": e, "attribute": a,
                                     "reads": sorted({str(prev),
                                                      str(v)})})
            read_state[(e, a)] = v
            if (e, a) in state and v != state[(e, a)]:
                errs.append({"entity": e, "attribute": a,
                             "wrote": state[(e, a)], "read": v})
        unread = sorted(
            (str(k) for k in set(state) - set(read_state)))
        mapping: dict = {}
        for (e, a), wrote in state.items():
            mapping.setdefault(a, {})[str(wrote)] = \
                read_state.get((e, a))
        errs = [dict(t) for t in
                {tuple(sorted(x.items())) for x in errs}]
        return {
            "valid": (False if errs or inconsistent or dup_writes
                      else "unknown" if unread else True),
            "error_count": len(errs),
            "unread_count": len(unread),
            "errors": sorted(errs, key=str)[:32],
            "inconsistent_reads": inconsistent[:32],
            "duplicate_writes": dup_writes[:32],
            "unread": unread[:32],
            "mapping": {a: dict(sorted(m.items())[:16])
                        for a, m in sorted(mapping.items())},
        }


def types_workload(opts: dict) -> dict:
    cases = type_cases()
    if opts.get("type_cases"):
        # stride-sample so a bounded run still sweeps the whole
        # boundary spectrum (small ints AND beyond-double values)
        n = opts["type_cases"]
        stride = max(1, len(cases) // n)
        cases = cases[::stride][:n]
    client = TypesClient()
    entities = client.entities

    final_cache: list = []
    final_lock = threading.Lock()

    def final():
        # derefer calls per op request; build once (delay semantics,
        # types.clj:176-188) — 3 read passes, dgraph "likes to stop
        # taking writes just cuz"
        with final_lock:
            if not final_cache:
                reads = [{"type": "invoke", "f": "read",
                          "value": [e, a, None]}
                         for _ in range(3)
                         for e, a in list(entities)]
                random.shuffle(reads)
                final_cache.append(
                    gen.stagger(0.01, gen.seq(reads)))
            return final_cache[0]

    return {
        "name": "types",
        "client": client,
        "during": gen.stagger(
            0.01,
            gen.seq({"type": "invoke", "f": "write",
                     "value": [None, a, v]} for a, v in cases)),
        "final": gen.derefer(final),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "types": TypesChecker(),
        }),
    }


class UidLrClient(client_mod.Client):
    """The uid-variant register client (linearizable_register.clj:
    80-150): keys map to uids through a client-side shared map instead
    of an @upsert index, avoiding the false linearization points index
    conflicts could introduce. A write that loses the uid-creation
    race completes :fail :lost-uid-race — its value will never be
    read."""

    def __init__(self, conn=None, uids=None, lock=None):
        self.conn = conn
        self.uids = uids if uids is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        conn = _open_conn(test, node)
        conn.alter("value: int .\n")
        return UidLrClient(conn, self.uids, self.lock)

    def _uid_read(self, t, k):
        with self.lock:
            u = self.uids.get(k)
        if u is None:
            return None
        rows = t.query(f"{{ q(func: uid({u})) {{ uid value }} }}")
        assert len(rows) < 2, rows
        return rows[0] if rows else None

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value

        def body():
            with with_txn(self.conn) as t:
                if op.f == "read":
                    rec = self._uid_read(t, k)
                    return op.with_(
                        type="ok",
                        value=independent.tuple_(
                            k, rec.get("value") if rec else None))
                if op.f == "write":
                    with self.lock:
                        u = self.uids.get(k)
                    if u is not None:
                        t.mutate(sets=[{"uid": u, "value": v}])
                        return op.with_(type="ok")
                    new_u = next(iter(
                        t.mutate(sets=[{"value": v}]).values()))
                    with self.lock:
                        # record iff nobody else won the race meanwhile
                        won = self.uids.setdefault(k, new_u) == new_u
                    if won:
                        return op.with_(type="ok")
                    return op.with_(type="fail", error="lost-uid-race")
                if op.f == "cas":
                    expect, new = v
                    rec = self._uid_read(t, k)
                    if rec is None:
                        return op.with_(type="fail", error="not-found")
                    if rec.get("value") != expect:
                        return op.with_(type="fail",
                                        error="value-mismatch")
                    t.mutate(sets=[{"uid": rec["uid"], "value": new}])
                    return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")

        return _complete(op, body, read_only=op.f == "read")

    def close(self, test):
        pass


def uid_lr_workload(opts: dict) -> dict:
    """linearizable_register.clj:152-160's uid-workload: the stock
    per-key register bundle over UidLrClient, with the reference's
    larger per-key budget."""
    wl = lr_wl.test({**opts, "per_key_limit":
                     opts.get("per_key_limit", 1024)})
    return {
        "name": "uid-linearizable-register",
        "client": UidLrClient(),
        "during": gen.stagger(0.05, wl["generator"]),
        "model": wl["model"],
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "register": wl["checker"],
        }),
    }
