"""CockroachDB workloads: register, bank, sets, monotonic, and G2,
plus the runner CLI (reference:
cockroachdb/src/jepsen/cockroach/{register,bank,sets,
monotonic,adya,runner}.clj).

Every client follows the same stack as the reference: reconnect-wrapped
pgwire connection, SQL inside explicit transactions, 40001 retry loops,
and the exception→op determinacy taxonomy from cockroach.py.

The port's copy of `jepsen_tpu/dbs/cockroach_workloads.py`. Two
workloads reach the card, on the test map's `device` (the CLI's
`--device`; None = the card, resolved before anything is provisioned):
register's per-key `linearizable` (K1, `ops/csrc/wgl_vec.cu`, or K5 as
`auto` routes each key) and g2's `adya.g2_checker`, whose cycle checker
ends in K3's `closure_word` (`ops/csrc/closure.cu`). bank, sets,
monotonic, sequential and comments check on the host.
`crdb_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
import zlib

from .. import checker as checker_mod
from .. import cli, client, generator as gen, independent, models
from ..checker import Checker
from ..history import Op, ops as _ops
from ..workloads import adya as adya_wl
from ..workloads import bank as bank_wl
from . import cockroach as cr
from .common import once as _once, shared_flag as _shared_flag

log = logging.getLogger("jepsen_tpu_torch.dbs.cockroach_workloads")


# ---------------------------------------------------------------------------
# Register (register.clj)


class RegisterClient(client.Client):
    """Independent-key linearizable registers in a `test` table
    (register.clj:22-81): read = select; write = upsert inside a txn;
    cas = conditional UPDATE whose rowcount decides ok/fail. Reads are
    idempotent → indeterminate reads remap to :fail."""

    def __init__(self, conn=None, flag=None):
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        return RegisterClient(cr.conn_wrapper(test, node), self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                cr.txn_retry(lambda: c.query("drop table if exists test"))
                cr.txn_retry(lambda: c.query(
                    "create table test (id int primary key, val int)"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value

        def body(c):
            if op.f == "read":
                vals = c.query(
                    f"select val from test where id = {k}").scalars()
                val = int(vals[0]) if vals and vals[0] is not None else None
                return op.with_(type="ok",
                                value=independent.tuple_(k, val))
            if op.f == "write":
                def w():
                    with cr.txn(c):
                        rows = c.query(
                            f"select val from test where id = {k}").rows
                        if rows:
                            c.query(f"update test set val = {v} "
                                    f"where id = {k}")
                        else:
                            c.query(f"insert into test values ({k}, {v})")
                cr.txn_retry(w)
                cr.update_keyrange(test, "test", k)
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = v

                def swap():
                    with cr.txn(c):
                        return c.query(
                            f"update test set val = {new} "
                            f"where id = {k} and val = {old}").rowcount
                count = cr.txn_retry(swap)
                return op.with_(type="ok" if count else "fail")
            raise ValueError(f"unknown op {op.f!r}")

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


def _r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def _w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def _cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def register_workload(opts: dict) -> dict:
    """10 threads/key: 5 reserved for writes/cas, 5 reading; 100 ops/key
    (register.clj:83-104)."""
    per_key = opts.get("ops_per_key", 100)
    threads_per_key = opts.get("threads_per_key", 10)
    return {
        "name": "register",
        "client": RegisterClient(),
        "during": independent.concurrent_generator(
            threads_per_key,
            itertools.count(),
            lambda k: gen.limit(
                per_key,
                gen.stagger(
                    0.1,
                    gen.delay_til(
                        0.5,
                        gen.reserve(threads_per_key // 2,
                                    gen.mix([_w, _cas, _cas]), _r)),
                ),
            ),
        ),
        "model": models.CASRegister(),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "details": independent.checker(checker_mod.compose({
                "timeline": checker_mod.timeline_html(),
                "linearizable": checker_mod.linearizable(
                    device=opts.get("device")),
            })),
        }),
    }


# ---------------------------------------------------------------------------
# Bank (bank.clj)


class BankClient(client.Client):
    """Transfers between account rows inside serializable transactions
    (bank.clj:21-88). Reads snapshot every balance; transfers fail
    definitely on insufficient funds."""

    def __init__(self, n: int = 5, starting_balance: int = 10,
                 conn=None, flag=None):
        self.n = n
        self.starting_balance = starting_balance
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        return BankClient(self.n, self.starting_balance,
                          cr.conn_wrapper(test, node), self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                cr.txn_retry(
                    lambda: c.query("drop table if exists accounts"))
                cr.txn_retry(lambda: c.query(
                    "create table accounts "
                    "(id int not null primary key, balance bigint not null)"))
                for i in range(self.n):
                    cr.txn_retry(lambda i=i: c.query(
                        f"insert into accounts (id, balance) "
                        f"values ({i}, {self.starting_balance})"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        def body(c):
            def run():
                with cr.txn(c):
                    if op.f == "read":
                        rows = c.query(
                            "select id, balance from accounts").rows
                        balances = {int(i): int(b) for i, b in rows}
                        return op.with_(type="ok", value=balances)
                    if op.f == "transfer":
                        frm = op.value["from"]
                        to = op.value["to"]
                        amount = op.value["amount"]
                        b1 = int(c.query(
                            f"select balance from accounts where id = {frm}"
                        ).scalars()[0]) - amount
                        b2 = int(c.query(
                            f"select balance from accounts where id = {to}"
                        ).scalars()[0]) + amount
                        if b1 < 0:
                            return op.with_(type="fail",
                                            error=("negative", frm, b1))
                        if b2 < 0:
                            return op.with_(type="fail",
                                            error=("negative", to, b2))
                        c.query(f"update accounts set balance = {b1} "
                                f"where id = {frm}")
                        c.query(f"update accounts set balance = {b2} "
                                f"where id = {to}")
                        cr.update_keyrange(test, "accounts", frm)
                        cr.update_keyrange(test, "accounts", to)
                        return op.with_(type="ok")
                    raise ValueError(f"unknown op {op.f!r}")

            return cr.txn_retry(run)

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


def bank_workload(opts: dict) -> dict:
    """Random transfers vs whole-table reads; the snapshot-isolation
    total checker + plotter from the framework bank workload
    (bank.clj:90-178)."""
    n = opts.get("accounts", 5)
    starting = opts.get("starting_balance", 10)
    return {
        "name": "bank",
        "client": BankClient(n, starting),
        "during": gen.stagger(opts.get("stagger", 0.1),
                              bank_wl.generator()),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "timeline": checker_mod.timeline_html(),
            "bank": bank_wl.checker(),
            "plot": bank_wl.plotter(),
        }),
        # test-map options the bank generator/checker read
        "test_opts": {"accounts": list(range(n)),
                      "total_amount": n * starting,
                      "max_transfer": 5},
    }


# ---------------------------------------------------------------------------
# Sets (sets.clj)


class SetsClient(client.Client):
    """Unique-int inserts with a final whole-table read
    (sets.clj:66-107)."""

    def __init__(self, conn=None, flag=None):
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        return SetsClient(cr.conn_wrapper(test, node), self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                cr.txn_retry(lambda: c.query("drop table if exists sets"))
                cr.txn_retry(lambda: c.query(
                    "create table sets (val int primary key)"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        def body(c):
            if op.f == "add":
                cr.txn_retry(lambda: c.query(
                    f"insert into sets values ({op.value})"))
                cr.update_keyrange(test, "sets", op.value)
                return op.with_(type="ok")
            if op.f == "read":
                vals = sorted(
                    int(v) for v in
                    c.query("select val from sets").scalars())
                return op.with_(type="ok", value=vals)
            raise ValueError(f"unknown op {op.f!r}")

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


def sets_workload(opts: dict) -> dict:
    return {
        "name": "sets",
        "client": SetsClient(),
        "during": gen.stagger(
            opts.get("stagger", 0.05),
            gen.seq({"type": "invoke", "f": "add", "value": x}
                    for x in itertools.count()),
        ),
        "final_client": gen.once({"type": "invoke", "f": "read"}),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "set": checker_mod.set_checker(),
        }),
    }


# ---------------------------------------------------------------------------
# Monotonic (monotonic.clj)


class MonotonicChecker(Checker):
    """The final read's rows, ordered by system timestamp, must carry
    strictly increasing values (monotonic.clj's analysis: a txn that
    read max=n and wrote n+1 at a later timestamp must see every earlier
    write). Reports reorders (value decreases along the sts order) and
    duplicates."""

    def check(self, test, history, opts=None) -> dict:
        final = None
        for o in _ops(history):
            if o.is_ok and o.f == "read":
                final = o.value
        if final is None:
            return {"valid": "unknown", "error": "Table was never read"}
        rows = sorted(final, key=lambda r: (int(str(r[1]).split(".")[0]),
                                            str(r[1])))
        vals = [r[0] for r in rows]
        reorders = [
            (vals[i], vals[i + 1])
            for i in range(len(vals) - 1)
            if vals[i + 1] <= vals[i]
        ]
        dup_counts: dict = {}
        for v in vals:
            dup_counts[v] = dup_counts.get(v, 0) + 1
        dups = {v: c for v, c in dup_counts.items() if c > 1}
        return {
            "valid": not reorders and not dups,
            "row_count": len(vals),
            "reorders": reorders[:10],
            "duplicates": dups,
        }


class MonotonicClient(client.Client):
    """Each :add reads the current max, asks for the cluster's logical
    timestamp, and inserts max+1 in one serializable txn
    (monotonic.clj:84-130); the final :read returns [val, sts, node,
    process] rows."""

    def __init__(self, conn=None, flag=None, nodenum: int = -1):
        self.conn = conn
        self.flag = flag or _shared_flag()
        self.nodenum = nodenum

    def open(self, test, node):
        nodenum = list(test["nodes"]).index(node)
        return MonotonicClient(cr.conn_wrapper(test, node), self.flag,
                               nodenum)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                cr.txn_retry(lambda: c.query("drop table if exists mono"))
                # val as the primary key (monotonic.clj:32-48's
                # val-as-pkey? mode) so split-at-val hits real ranges
                cr.txn_retry(lambda: c.query(
                    "create table mono (val int primary key, sts string, "
                    "node int, process int, tb int)"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        def body(c):
            if op.f == "add":
                def run():
                    with cr.txn(c):
                        cur = c.query(
                            "select max(val) as m from mono").scalars()[0]
                        cur = int(cur) if cur is not None else 0
                        sts = c.query(
                            "select cluster_logical_timestamp()"
                        ).scalars()[0]
                        c.query(
                            "insert into mono (val, sts, node, process, tb)"
                            f" values ({cur + 1}, '{sts}', {self.nodenum},"
                            f" {op.process}, 0)")
                        cr.update_keyrange(test, "mono", cur + 1)
                        return cur + 1

                val = cr.txn_retry(run)
                return op.with_(type="ok", value=val)
            if op.f == "read":
                rows = c.query(
                    "select val, sts, node, process from mono").rows
                out = [(int(v), s, int(n), int(p))
                       for v, s, n, p in rows]
                return op.with_(type="ok", value=out)
            raise ValueError(f"unknown op {op.f!r}")

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


def monotonic_workload(opts: dict) -> dict:
    return {
        "name": "monotonic",
        "client": MonotonicClient(),
        "during": gen.stagger(opts.get("stagger", 0.05),
                              {"type": "invoke", "f": "add"}),
        "final_client": gen.once({"type": "invoke", "f": "read"}),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "monotonic": MonotonicChecker(),
        }),
    }


# ---------------------------------------------------------------------------
# G2 / Adya (adya.clj)


class G2Client(client.Client):
    """Anti-dependency-cycle txns over two tables (adya.clj:25-88):
    each insert predicate-reads both tables for its key (value % 3 = 0)
    and inserts only if both came back empty; under serializability at
    most one insert per key may commit."""

    def __init__(self, conn=None, flag=None):
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        return G2Client(cr.conn_wrapper(test, node), self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                for t in ("a", "b"):
                    cr.txn_retry(
                        lambda t=t: c.query(f"drop table if exists {t}"))
                    cr.txn_retry(lambda t=t: c.query(
                        f"create table {t} (id int primary key, key int, "
                        "value int)"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        k, ids = op.value

        def body(c):
            if op.f == "insert":
                a_id, b_id = ids

                def run():
                    with cr.txn(c):
                        first, second = (("a", "b")
                                         if random.random() < 0.5
                                         else ("b", "a"))
                        rows = []
                        for t in (first, second):
                            rows += c.query(
                                f"select id from {t} where key = {k} "
                                "and value % 3 = 0").rows
                        if rows:
                            return op.with_(type="fail", error="too-late")
                        table = "a" if a_id is not None else "b"
                        row_id = a_id if a_id is not None else b_id
                        c.query(
                            f"insert into {table} (id, key, value) "
                            f"values ({row_id}, {k}, 30)")
                        cr.update_keyrange(test, table, row_id)
                        return op.with_(type="ok")

                return cr.txn_retry(run, attempts=5)
            if op.f == "read":
                found = []
                for t in ("a", "b"):
                    found += c.query(
                        f"select id from {t} where key = {k} "
                        "and value % 3 = 0").scalars()
                return op.with_(
                    type="ok",
                    value=independent.tuple_(k, [int(i) for i in found]))
            raise ValueError(f"unknown op {op.f!r}")

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


def g2_workload(opts: dict) -> dict:
    return {
        "name": "g2",
        "client": G2Client(),
        "during": adya_wl.g2_gen(),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "g2": adya_wl.g2_checker(device=opts.get("device")),
        }),
    }


# ---------------------------------------------------------------------------
# Sequential (sequential.clj): per-key subkeys written in order into
# hash-distributed tables; reads traverse in REVERSE order, so seeing a
# later subkey while an earlier one is missing is a sequential-
# consistency violation.


def _stable_hash(x) -> int:
    return zlib.crc32(str(x).encode())


SEQ_TABLE_PREFIX = "seq_"


class SequentialClient(client.Client):
    """sequential.clj:30-90: write inserts k_0..k_{n-1} in order, each
    into table seq_{hash(subkey) % table_count}; read selects the
    subkeys in reverse order and reports which were present."""

    def __init__(self, table_count: int = 5, key_count: int = 5,
                 conn=None, flag=None):
        self.table_count = table_count
        self.key_count = key_count
        self.conn = conn
        self.flag = flag or _shared_flag()

    def _table(self, subkey) -> str:
        return (SEQ_TABLE_PREFIX
                + str(_stable_hash(subkey) % self.table_count))

    def _subkeys(self, k) -> list:
        return [f"{k}_{i}" for i in range(self.key_count)]

    def open(self, test, node):
        return SequentialClient(self.table_count, self.key_count,
                                cr.conn_wrapper(test, node), self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                for i in range(self.table_count):
                    t = f"{SEQ_TABLE_PREFIX}{i}"
                    cr.txn_retry(
                        lambda t=t: c.query(f"drop table if exists {t}"))
                    cr.txn_retry(lambda t=t: c.query(
                        f"create table {t} (key varchar primary key)"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        k = op.value

        def body(c):
            if op.f == "write":
                for sub in self._subkeys(k):
                    cr.txn_retry(lambda sub=sub: c.query(
                        f"insert into {self._table(sub)} (key) "
                        f"values ('{sub}')"))
                    cr.update_keyrange(test, self._table(sub), sub)
                return op.with_(type="ok")
            if op.f == "read":
                found = []
                for sub in reversed(self._subkeys(k)):
                    rows = cr.txn_retry(lambda sub=sub: c.query(
                        f"select key from {self._table(sub)} "
                        f"where key = '{sub}'").rows)
                    found.append(sub if rows else None)
                return op.with_(type="ok", value=(k, found))
            raise ValueError(f"unknown op {op.f!r}")

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


class SequentialChecker(Checker):
    """In a read's reverse traversal (latest-written subkey first),
    once any subkey is seen every LATER-traversed (earlier-written)
    subkey must be present — a gap means writes became visible out of
    order (sequential.clj's analysis)."""

    def check(self, test, history, opts=None) -> dict:
        bad = []
        for o in _ops(history):
            if not (o.is_ok and o.f == "read"):
                continue
            k, found = o.value
            seen = False
            for sub in found:
                if sub is not None:
                    seen = True
                elif seen:
                    bad.append({"key": k, "read": found,
                                "op": o.to_dict()})
                    break
        return {"valid": not bad, "bad_reads": bad[:10]}


def sequential_workload(opts: dict) -> dict:
    keys = itertools.count()
    lock = threading.Lock()
    written: list = []

    def w(test, process):
        with lock:
            k = next(keys)
            written.append(k)
        return {"type": "invoke", "f": "write", "value": k}

    def r(test, process):
        with lock:
            k = random.choice(written) if written else 0
        return {"type": "invoke", "f": "read", "value": k}

    return {
        "name": "sequential",
        "client": SequentialClient(opts.get("tables", 5),
                                   opts.get("key_count", 5)),
        "during": gen.stagger(opts.get("stagger", 0.05),
                              gen.mix([w, r, r])),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "sequential": SequentialChecker(),
        }),
    }


# ---------------------------------------------------------------------------
# Comments (comments.clj): the stale-comment anomaly — if write w1
# completed before write w2 began, a read that sees w2's id must see
# w1's id.


COMMENT_TABLE_PREFIX = "comment_"


class CommentsClient(client.Client):
    """comments.clj:36-80: writes insert (id, key) into
    comment_{hash(id) % table_count}; reads union all tables' ids for
    the key inside one transaction."""

    def __init__(self, table_count: int = 5, conn=None, flag=None):
        self.table_count = table_count
        self.conn = conn
        self.flag = flag or _shared_flag()

    def _table(self, comment_id) -> str:
        return (COMMENT_TABLE_PREFIX
                + str(_stable_hash(comment_id) % self.table_count))

    def open(self, test, node):
        return CommentsClient(self.table_count,
                              cr.conn_wrapper(test, node), self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                for i in range(self.table_count):
                    t = f"{COMMENT_TABLE_PREFIX}{i}"
                    cr.txn_retry(
                        lambda t=t: c.query(f"drop table if exists {t}"))
                    cr.txn_retry(lambda t=t: c.query(
                        f"create table {t} (id int primary key, "
                        "key int)"))

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        k, comment_id = op.value

        def body(c):
            if op.f == "write":
                cr.txn_retry(lambda: c.query(
                    f"insert into {self._table(comment_id)} (id, key) "
                    f"values ({comment_id}, {k})"))
                cr.update_keyrange(test, self._table(comment_id),
                                   comment_id)
                return op.with_(type="ok")
            if op.f == "read":
                def run():
                    with cr.txn(c):
                        ids = []
                        for i in range(self.table_count):
                            ids += c.query(
                                f"select id from {COMMENT_TABLE_PREFIX}"
                                f"{i} where key = {k}").scalars()
                        return sorted(int(x) for x in ids)

                ids = cr.txn_retry(run)
                return op.with_(type="ok", value=(k, ids))
            raise ValueError(f"unknown op {op.f!r}")

        return cr.invoke_with_taxonomy(self.conn, op, body,
                                       idempotent_fs={"read"})

    def close(self, test):
        if self.conn:
            self.conn.close()


class CommentsChecker(Checker):
    """For writes w1, w2 on the same key where w1's :ok precedes w2's
    :invoke in real time, any read that includes w2's id must include
    w1's id (comments.clj's analysis of the lost-comment anomaly)."""

    def check(self, test, history, opts=None) -> dict:
        ops = _ops(history)
        # per-key write windows: id -> (invoke_index, ok_index)
        invoked: dict = {}
        windows: dict = {}
        for i, o in enumerate(ops):
            if o.f != "write":
                continue
            key = o.value
            if o.is_invoke:
                invoked[(o.process, key)] = i
            elif o.is_ok:
                start = invoked.get((o.process, key))
                if start is not None:
                    k, comment_id = key
                    windows.setdefault(k, []).append(
                        (comment_id, start, i))
        bad = []
        for i, o in enumerate(ops):
            if not (o.is_ok and o.f == "read"):
                continue
            k, ids = o.value
            seen = set(ids)
            for id2, inv2, ok2 in windows.get(k, []):
                if id2 not in seen:
                    continue
                for id1, inv1, ok1 in windows.get(k, []):
                    if id1 == id2 or id1 in seen:
                        continue
                    # w1 finished before w2 began, and before this read
                    if ok1 < inv2 and ok1 < i:
                        bad.append({"key": k, "saw": id2,
                                    "missing": id1,
                                    "op": o.to_dict()})
                        break
        return {"valid": not bad, "anomalies": bad[:10]}


def comments_workload(opts: dict) -> dict:
    ids = itertools.count()
    lock = threading.Lock()
    n_keys = opts.get("keys", 3)

    def w(test, process):
        with lock:
            comment_id = next(ids)
        return {"type": "invoke", "f": "write",
                "value": (random.randrange(n_keys), comment_id)}

    def r(test, process):
        return {"type": "invoke", "f": "read",
                "value": (random.randrange(n_keys), None)}

    return {
        "name": "comments",
        "client": CommentsClient(opts.get("tables", 5)),
        "during": gen.stagger(opts.get("stagger", 0.05),
                              gen.mix([w, r])),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "comments": CommentsChecker(),
        }),
    }


# ---------------------------------------------------------------------------
# Runner (runner.clj)


def workloads() -> dict:
    return {
        "register": register_workload,
        "bank": bank_workload,
        "sets": sets_workload,
        "monotonic": monotonic_workload,
        "sequential": sequential_workload,
        "comments": comments_workload,
        "g2": g2_workload,
    }


def cockroach_test(opts: dict) -> dict:
    wl = workloads()[opts["workload"]](opts)
    test = cr.basic_test(opts, wl)
    test.update(wl.get("test_opts") or {})
    return test


def _opt_spec(p) -> None:
    p.add_argument("--workload", required=True,
                   choices=sorted(workloads().keys()),
                   help="Test workload to run, e.g. register.")
    nem_names = sorted(cr.nemeses().keys())
    p.add_argument("--nemesis", default="none", choices=nem_names,
                   help="Primary nemesis (runner.clj:21-41).")
    p.add_argument("--nemesis2", default=None, choices=nem_names,
                   help="Secondary nemesis to compose with the first.")
    p.add_argument("--tarball", default=None,
                   help="CockroachDB binary tarball url (or the crdb_sim "
                        "archive for hermetic runs).")
    p.add_argument("--quiesce", type=float, default=30,
                   help="Seconds to wait before final-read phases.")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(cockroach_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
