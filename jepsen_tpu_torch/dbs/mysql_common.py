"""Shared clients and helpers for the MySQL-protocol suites (galera,
percona, mysql-cluster, tidb). The reference repeats these clients per
suite (galera.clj:214-337, percona.clj, mysql_cluster.clj:100-180,
tidb/{bank,sets,register}.clj); here they're written once and
parameterized by each suite's SuiteCfg.

Shared failure taxonomy (galera.clj:120-187's with-error-handling /
with-txn-aborts): deadlock/txn-abort errors (1213) definitely did not
commit → :fail; duplicate keys :fail; timeouts and connection errors on
writes are :info; reads always :fail on error.

The port's copy of `jepsen_tpu/dbs/mysql_common.py`. The register
workload's checker is `linearizable` on the one unkeyed CAS-register
history, which `auto` routes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024
entries), K5 (`ops/csrc/wgl_row.cu`, up to 4,064) or K2
(`ops/csrc/wgl_search.cu`, past that), or to the native search below the
committed bars; the test map's `device` (the CLI's `--device`; None =
the card) goes to that checker (the JAX package's takes none). bank,
sets and dirty-reads reach only host checkers."""

from __future__ import annotations

import logging
import random
import socket
import time

from .. import client, generator as gen, reconnect
from ..checker import Checker
from ..history import Op, ops as _ops
from . import mysql_proto as mp
from .common import once as _once, shared_flag as _shared_flag

log = logging.getLogger("jepsen_tpu_torch.dbs.mysql_common")


def probe_mysql_ready(suite, test, node) -> bool:
    """Shared readiness probe: the SQL port answers a trivial query
    (a server mid-startup can speak garbage; callers keep polling)."""
    try:
        conn = mp.MySqlConn(suite.host(test, node),
                            suite.port(test, node),
                            connect_timeout=2.0, timeout=2.0)
        try:
            conn.query("select 1")
            return True
        finally:
            conn.close()
    except (mp.MySqlError, mp.MySqlProtocolError):
        return False


def conn_wrapper(suite, test, node, user="jepsen", password="",
                 database="jepsen"):
    host, port = suite.host(test, node), suite.port(test, node)
    return reconnect.wrapper(
        open=lambda: mp.MySqlConn(host, port, user=user, password=password,
                                  database=database),
        close=lambda c: c.close(),
        name=f"{suite.name} {node}",
    ).open()


def txn_retry(body, attempts: int = 20, backoff: float = 0.02):
    """Retry deadlock aborts with backoff (galera.clj with-txn-retries)."""
    while True:
        try:
            return body()
        except mp.MySqlError as e:
            if not e.deadlock or attempts <= 0:
                raise
            attempts -= 1
            time.sleep(backoff)
            backoff *= 2


def exception_to_op(op: Op, e) -> Op | None:
    if isinstance(e, mp.MySqlError):
        if e.deadlock:
            return op.with_(type="fail", error=("txn-abort", str(e)))
        if e.code == mp.ER_DUP_ENTRY:
            return op.with_(type="fail", error="duplicate-key")
        crash = "fail" if op.f == "read" else "info"
        return op.with_(type=crash, error=str(e))
    if isinstance(e, (socket.timeout, TimeoutError)):
        return op.with_(type="fail" if op.f == "read" else "info",
                        error="timeout")
    if isinstance(e, (ConnectionError, mp.MySqlProtocolError, OSError)):
        return op.with_(type="fail" if op.f == "read" else "info",
                        error=str(e))
    return None


class _SqlClient(client.Client):
    """Base: reconnect-wrapped conn + exception taxonomy + txn
    bracket."""

    def __init__(self, suite, conn=None, flag=None):
        self.suite = suite
        self.conn = conn
        self.flag = flag or _shared_flag()

    def _clone(self, conn):
        out = type(self)(self.suite)
        out.__dict__.update(self.__dict__)
        out.conn = conn
        return out

    def open(self, test, node):
        return self._clone(conn_wrapper(self.suite, test, node))

    def _txn(self, c, body):
        c.query("begin")
        try:
            out = body()
        except BaseException:
            try:
                c.query("rollback")
            except (OSError, mp.MySqlError, mp.MySqlProtocolError):
                pass
            raise
        c.query("commit")
        return out

    def invoke(self, test, op: Op) -> Op:
        try:
            with self.conn.with_conn() as c:
                return self._invoke(c, test, op)
        except Exception as e:  # noqa: BLE001
            mapped = exception_to_op(op, e)
            if mapped is None:
                raise
            return mapped

    def _invoke(self, c, test, op: Op) -> Op:
        raise NotImplementedError

    def close(self, test):
        if self.conn:
            self.conn.close()


class BankClient(_SqlClient):
    """Account transfers in serializable transactions
    (galera.clj:260-309)."""

    def __init__(self, suite, n: int = 5, starting_balance: int = 10,
                 conn=None, flag=None):
        super().__init__(suite, conn, flag)
        self.n = n
        self.starting_balance = starting_balance

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                txn_retry(lambda: c.query("drop table if exists accounts"))
                txn_retry(lambda: c.query(
                    "create table accounts (id int not null primary key, "
                    "balance bigint not null)"))
                for i in range(self.n):
                    try:
                        txn_retry(lambda i=i: c.query(
                            f"insert into accounts (id, balance) values "
                            f"({i}, {self.starting_balance})"))
                    except mp.MySqlError as e:
                        if e.code != mp.ER_DUP_ENTRY:
                            raise

        _once(self.flag, create)

    def _invoke(self, c, test, op: Op) -> Op:
        def run():
            def body():
                if op.f == "read":
                    rows = c.query("select id, balance from accounts").rows
                    return op.with_(type="ok",
                                    value={int(i): int(b)
                                           for i, b in rows})
                frm, to = op.value["from"], op.value["to"]
                amount = op.value["amount"]
                b1 = int(c.query(
                    f"select balance from accounts where id = {frm}"
                ).scalars()[0]) - amount
                b2 = int(c.query(
                    f"select balance from accounts where id = {to}"
                ).scalars()[0]) + amount
                if b1 < 0:
                    return op.with_(type="fail", error=("negative", frm))
                if b2 < 0:
                    return op.with_(type="fail", error=("negative", to))
                c.query(f"update accounts set balance = {b1} "
                        f"where id = {frm}")
                c.query(f"update accounts set balance = {b2} "
                        f"where id = {to}")
                return op.with_(type="ok")

            return self._txn(c, body)

        return txn_retry(run, attempts=5)


class SetClient(_SqlClient):
    """Unique-int inserts + final whole-table read
    (galera.clj:214-258)."""

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                txn_retry(lambda: c.query("drop table if exists sets"))
                txn_retry(lambda: c.query(
                    "create table sets (val int primary key)"))

        _once(self.flag, create)

    def _invoke(self, c, test, op: Op) -> Op:
        if op.f == "add":
            txn_retry(lambda: c.query(
                f"insert into sets values ({op.value})"))
            return op.with_(type="ok")
        if op.f == "read":
            vals = sorted(int(v) for v in
                          c.query("select val from sets").scalars())
            return op.with_(type="ok", value=vals)
        raise ValueError(f"unknown op {op.f!r}")


class DirtyReadsClient(_SqlClient):
    """Writers set EVERY row to a unique value in one transaction;
    readers read every row. A failed write's value visible to a reader
    is a dirty read (galera/dirty_reads.clj:29-96)."""

    def __init__(self, suite, n: int = 4, conn=None, flag=None):
        super().__init__(suite, conn, flag)
        self.n = n

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                txn_retry(lambda: c.query("drop table if exists dirty"))
                txn_retry(lambda: c.query(
                    "create table dirty (id int not null primary key, "
                    "x bigint not null)"))
                for i in range(self.n):
                    try:
                        txn_retry(lambda i=i: c.query(
                            f"insert into dirty (id, x) values ({i}, -1)"))
                    except mp.MySqlError as e:
                        if e.code != mp.ER_DUP_ENTRY:
                            raise

        _once(self.flag, create)

    def _invoke(self, c, test, op: Op) -> Op:
        def body():
            if op.f == "read":
                xs = [int(x) for x in
                      c.query("select x from dirty").scalars()]
                return op.with_(type="ok", value=xs)
            if op.f == "write":
                order = list(range(self.n))
                random.shuffle(order)
                for i in order:
                    c.query(f"select x from dirty where id = {i}")
                for i in order:
                    c.query(f"update dirty set x = {op.value} "
                            f"where id = {i}")
                return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")

        return self._txn(c, body)


class DirtyReadsChecker(Checker):
    """No failed write's value may appear in any read; reads must also
    be internally consistent (dirty_reads.clj:72-96)."""

    def check(self, test, history, opts=None) -> dict:
        failed = {o.value for o in _ops(history)
                  if o.is_fail and o.f == "write"}
        reads = [o.value for o in _ops(history)
                 if o.is_ok and o.f == "read"]
        inconsistent = [r for r in reads if len(set(r)) > 1]
        dirty = [r for r in reads if any(x in failed for x in r)]
        return {
            "valid": not dirty,
            "inconsistent_reads": inconsistent[:10],
            "dirty_reads": dirty[:10],
        }


class RegisterClient(_SqlClient):
    """tidb-style single-row CAS register (tidb/register.clj): read =
    select; write = upsert; cas = conditional UPDATE rowcount."""

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                txn_retry(lambda: c.query("drop table if exists test"))
                txn_retry(lambda: c.query(
                    "create table test (id int primary key, val int)"))

        _once(self.flag, create)

    def _invoke(self, c, test, op: Op) -> Op:
        if op.f == "read":
            vals = c.query("select val from test where id = 0").scalars()
            value = int(vals[0]) if vals and vals[0] is not None else None
            return op.with_(type="ok", value=value)
        if op.f == "write":
            def w():
                def body():
                    rows = c.query(
                        "select val from test where id = 0").rows
                    if rows:
                        c.query(f"update test set val = {op.value} "
                                "where id = 0")
                    else:
                        c.query(f"insert into test values (0, {op.value})")
                return self._txn(c, body)
            txn_retry(w)
            return op.with_(type="ok")
        if op.f == "cas":
            old, new = op.value
            n = txn_retry(lambda: c.query(
                f"update test set val = {new} "
                f"where id = 0 and val = {old}").rowcount)
            return op.with_(type="ok" if n else "fail")
        raise ValueError(f"unknown op {op.f!r}")


# ---------------------------------------------------------------------------
# Generators


def bank_read(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def bank_transfer(test, process):
    n = test.get("accounts_n", 5)
    return {"type": "invoke", "f": "transfer",
            "value": {"from": random.randrange(n),
                      "to": random.randrange(n),
                      "amount": 1 + random.randrange(5)}}


def bank_diff_transfer():
    return gen.filter_gen(
        lambda op: op["value"]["from"] != op["value"]["to"], bank_transfer)


# ---------------------------------------------------------------------------
# Suite factory: the four MySQL-protocol suites differ only in name,
# port, daemon launch flags, and workload selection.


def make_sql_suite(name: str, default_port: int, binary: str,
                   daemon_args_fn, workload_names: tuple,
                   display_name: str | None = None,
                   db_cls=None,
                   extra_nemeses=None,
                   extra_nemesis_names: tuple = ()):
    """Build (suite_cfg, DBClass, workloads_fn, test_fn, opt_spec) for a
    MySQL-protocol suite. db_cls overrides the default single-daemon
    ArchiveDB (tidb's triple, mysql-cluster's role split);
    extra_nemeses(db) -> dict merges suite-specific nemesis entries
    (component killers) into the shared registry, and
    extra_nemesis_names exposes them on the --nemesis flag."""
    from .. import checker as checker_mod
    from .. import models, osdist
    from .common import ArchiveDB, SuiteCfg

    suite = SuiteCfg(name, default_port, f"/opt/{name}")

    class DB(ArchiveDB):
        binary_name = binary
        log_name = f"{name}.log"
        pid_name = f"{name}.pid"

        def __init__(self, archive_url=None, ready_timeout=60.0):
            super().__init__(suite, archive_url, ready_timeout)
            self.binary = binary

        def daemon_args(self, test, node):
            return daemon_args_fn(suite, test, node)

        def probe_ready(self, test, node):
            return probe_mysql_ready(suite, test, node)

    DB.__name__ = f"{name.title().replace('-', '')}DB"
    if db_cls is not None:
        # factory form: db_cls(suite) -> class, so multi-daemon DBs
        # close over the suite cfg built here
        DB = db_cls(suite)  # noqa: F811 — deliberate override

    def workloads(opts: dict):
        import itertools

        n_accounts = opts.get("accounts", 5)
        starting = opts.get("starting_balance", 10)
        all_workloads = {
            "bank": {
                "client": BankClient(suite, n_accounts, starting),
                "during": gen.stagger(
                    opts.get("stagger", 0.05),
                    gen.mix([bank_read, bank_diff_transfer()])),
                "final": gen.clients(gen.once(bank_read)),
                "checker_name": "bank",
                "test_opts": {"accounts_n": n_accounts},
            },
            "sets": {
                "client": SetClient(suite),
                "during": gen.stagger(
                    opts.get("stagger", 0.05),
                    gen.seq({"type": "invoke", "f": "add", "value": x}
                            for x in itertools.count())),
                "final": gen.clients(gen.each(
                    lambda: gen.once({"type": "invoke", "f": "read"}))),
                "checker_name": "set",
            },
            "dirty-reads": {
                "client": DirtyReadsClient(suite, opts.get("rows", 4)),
                "during": gen.mix([
                    {"type": "invoke", "f": "read"},
                    gen.seq({"type": "invoke", "f": "write", "value": x}
                            for x in itertools.count()),
                ]),
                "checker_name": "dirty-reads",
            },
            "register": {
                "client": RegisterClient(suite),
                "during": gen.stagger(opts.get("stagger", 0.05), gen.mix([
                    lambda t, p: {"type": "invoke", "f": "read",
                                  "value": None},
                    lambda t, p: {"type": "invoke", "f": "write",
                                  "value": random.randrange(5)},
                    lambda t, p: {"type": "invoke", "f": "cas",
                                  "value": (random.randrange(5),
                                            random.randrange(5))},
                ])),
                "checker_name": "linear",
                "model": models.CASRegister(),
            },
        }
        return {k: all_workloads[k] for k in workload_names}

    def checker_for(wl, n_accounts, starting, device=None):
        name_ = wl["checker_name"]
        if name_ == "bank":
            class _BankTotals(Checker):
                def check(self, test, history, opts=None):
                    bad = []
                    total = n_accounts * starting
                    for o in _ops(history):
                        if o.is_ok and o.f == "read" \
                                and sum(o.value.values()) != total:
                            bad.append(o.to_dict())
                    return {"valid": not bad, "bad_reads": bad[:10]}

            return _BankTotals()
        if name_ == "set":
            return checker_mod.set_checker()
        if name_ == "dirty-reads":
            return DirtyReadsChecker()
        return checker_mod.linearizable(device=device)

    def test_fn(opts: dict) -> dict:
        from ..testlib import noop_test
        from .common import pick_nemesis

        wl_name = opts.get("workload", workload_names[0])
        wl = workloads(opts)[wl_name]
        db = DB(archive_url=opts.get("archive_url"))
        nem_client = pick_nemesis(
            db, opts,
            extra=extra_nemeses(db) if extra_nemeses else None)
        dt = opts.get("nemesis_interval", 10)
        generator = gen.time_limit(
            opts.get("time_limit", 60),
            gen.nemesis(gen.start_stop(dt, dt), wl["during"]),
        )
        phases = [generator,
                  gen.nemesis(gen.once({"type": "info", "f": "stop"}))]
        if wl.get("final") is not None:
            from .common import ready_gated_final

            phases += [gen.sleep(opts.get("quiesce", 10)),
                       ready_gated_final(db, wl["final"], opts)]
        test = noop_test()
        test.update(opts)
        test.update(
            {
                "name": f"{display_name or name} {wl_name}",
                "os": osdist.debian,
                "db": db,
                "client": wl["client"],
                "nemesis": nem_client,
                "model": wl.get("model"),
                "generator": gen.phases(*phases),
                "checker": checker_mod.compose({
                    "perf": checker_mod.perf_checker(),
                    "workload": checker_for(
                        wl, opts.get("accounts", 5),
                        opts.get("starting_balance", 10),
                        opts.get("device")),
                }),
            }
        )
        test.update(wl.get("test_opts") or {})
        return test

    def opt_spec(p) -> None:
        from .common import NEMESIS_NAMES, nemesis_opt

        p.add_argument("--workload", default=workload_names[0],
                       choices=sorted(workload_names))
        nemesis_opt(p, names=NEMESIS_NAMES + tuple(extra_nemesis_names))
        p.add_argument("--archive-url", dest="archive_url", default=None)
        p.add_argument("--accounts", type=int, default=5)
        p.add_argument("--starting-balance", dest="starting_balance",
                       type=int, default=10)

    return suite, DB, workloads, test_fn, opt_spec
