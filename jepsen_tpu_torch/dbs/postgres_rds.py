"""Postgres-RDS test suite: bank transfers against a managed Postgres
endpoint (reference:
postgres-rds/src/jepsen/postgres_rds.clj:1-294).

The managed-service shape: there is NO DB lifecycle — the endpoint
exists outside the test (RDS), so db is a no-op and the node list names
the endpoint. The client holds a reconnect-on-failure pgwire connection
(the reference's with-conn atom dance, postgres_rds.clj:44-66), runs
transfers in explicit transactions with optional `for update` row
locks, converts txn aborts to definite :fails, and the checker demands
every read total the starting balance.

Hermetically testable against dbs/crdb_sim (any pgwire server works).

The port's copy of `jepsen_tpu/dbs/postgres_rds.py`: its bank checker
runs on the host and reaches no kernel.
"""

from __future__ import annotations

import logging
import random
import socket

from .. import checker as checker_mod
from .common import once as _once, shared_flag as _shared_flag
from .. import cli, client, generator as gen, nemesis, reconnect
from ..checker import Checker
from ..history import Op, ops as _ops
from . import pg_proto

log = logging.getLogger("jepsen_tpu_torch.dbs.postgres_rds")

PORT = 5432


def _cfg(test) -> dict:
    return test.get("postgres_rds") or {}


def endpoint(test) -> tuple:
    """(host, port) of the managed endpoint — the first 'node', or an
    explicit endpoint option (postgres_rds.clj:276-281 ignores the node
    list and dials the AWS hostname)."""
    cfg = _cfg(test)
    if cfg.get("endpoint"):
        return cfg["endpoint"]
    node = test["nodes"][0]
    fn = cfg.get("addr_fn")
    host = fn(node) if fn else str(node)
    ports = cfg.get("ports")
    return host, (ports[node] if ports else PORT)


TXN_ABORT_MARKERS = (
    "restart transaction",                       # cockroach-style
    "deadlock found when trying to get lock",    # galera-style
    "was aborted",                               # postgres batch aborts
    "serialization failure",
)


def txn_aborted(e: pg_proto.PgError) -> bool:
    """Aborted transactions definitely did not commit
    (postgres_rds.clj:68-99's capture-txn-abort)."""
    return e.retryable or any(
        m in str(e).lower() for m in TXN_ABORT_MARKERS)


class BankClient(client.Client):
    """Account transfers in explicit transactions
    (postgres_rds.clj:118-202). lock_type=' for update' reproduces the
    reference's row-locking variant; in_place=True updates balances
    with arithmetic in SQL instead of read-modify-write."""

    def __init__(self, n: int = 8, starting_balance: int = 10,
                 lock_type: str = "", in_place: bool = False,
                 conn=None, flag=None):
        self.n = n
        self.starting_balance = starting_balance
        self.lock_type = lock_type
        self.in_place = in_place
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        host, port = endpoint(test)
        wrapped = reconnect.wrapper(
            open=lambda: pg_proto.PgConn(host, port, user="jepsen",
                                         database="jepsen", timeout=10.0),
            close=lambda c: c.close(),
            name=f"postgres-rds {node}",
        ).open()
        return BankClient(self.n, self.starting_balance, self.lock_type,
                          self.in_place, wrapped, self.flag)

    def setup(self, test):
        def create():
            with self.conn.with_conn() as c:
                c.query("drop table if exists accounts")
                c.query("create table accounts "
                        "(id int not null primary key, "
                        "balance bigint not null)")
                for i in range(self.n):
                    try:
                        c.query(f"insert into accounts (id, balance) values "
                                f"({i}, {self.starting_balance})")
                    except pg_proto.PgError as e:
                        if "duplicate key" not in str(e):
                            raise

        _once(self.flag, create)

    def invoke(self, test, op: Op) -> Op:
        try:
            with self.conn.with_conn() as c:
                c.query("begin")
                try:
                    out = self._body(c, op)
                except BaseException:
                    try:
                        c.query("rollback")
                    except (OSError, pg_proto.PgError,
                            pg_proto.PgProtocolError):
                        pass
                    raise
                c.query("commit")
                return out
        except pg_proto.PgError as e:
            if txn_aborted(e):
                return op.with_(type="fail", error=("txn-abort", str(e)))
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))
        except (socket.timeout, TimeoutError):
            return op.with_(
                type="fail" if op.f == "read" else "info", error="timeout")
        except (ConnectionError, pg_proto.PgProtocolError, OSError) as e:
            return op.with_(
                type="fail" if op.f == "read" else "info", error=str(e))

    def _body(self, c, op: Op) -> Op:
        if op.f == "read":
            rows = c.query(
                f"select id, balance from accounts{self.lock_type}").rows
            balances = [int(b) for _, b in
                        sorted(rows, key=lambda r: int(r[0]))]
            return op.with_(type="ok", value=balances)
        if op.f == "transfer":
            frm, to = op.value["from"], op.value["to"]
            amount = op.value["amount"]
            b1 = int(c.query(
                f"select balance from accounts where id = {frm}"
                f"{self.lock_type}").scalars()[0]) - amount
            b2 = int(c.query(
                f"select balance from accounts where id = {to}"
                f"{self.lock_type}").scalars()[0]) + amount
            if b1 < 0:
                return op.with_(type="fail", error=("negative", frm, b1))
            if b2 < 0:
                return op.with_(type="fail", error=("negative", to, b2))
            if self.in_place:
                # arithmetic updates in SQL (postgres_rds.clj:195-198)
                c.query(f"update accounts set balance = balance - {amount}"
                        f" where id = {frm}")
                c.query(f"update accounts set balance = balance + {amount}"
                        f" where id = {to}")
            else:
                c.query(f"update accounts set balance = {b1} "
                        f"where id = {frm}")
                c.query(f"update accounts set balance = {b2} "
                        f"where id = {to}")
            return op.with_(type="ok")
        raise ValueError(f"unknown op {op.f!r}")

    def close(self, test):
        if self.conn:
            self.conn.close()


class RdsBankChecker(Checker):
    """Every ok read must list exactly n balances totalling n×starting
    (postgres_rds.clj:235-260)."""

    def __init__(self, n: int, total: int):
        self.n = n
        self.total = total

    def check(self, test, history, opts=None) -> dict:
        bad = []
        for o in _ops(history):
            if not (o.is_ok and o.f == "read"):
                continue
            balances = o.value
            if len(balances) != self.n:
                bad.append({"type": "wrong-n", "expected": self.n,
                            "found": len(balances), "op": o.to_dict()})
            elif sum(balances) != self.total:
                bad.append({"type": "wrong-total", "expected": self.total,
                            "found": sum(balances), "op": o.to_dict()})
        return {"valid": not bad, "bad_reads": bad[:10]}


def bank_read(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def bank_transfer(test, process):
    n = test.get("accounts_n", 8)
    return {"type": "invoke", "f": "transfer",
            "value": {"from": random.randrange(n),
                      "to": random.randrange(n),
                      "amount": random.randrange(5)}}


def bank_diff_transfer():
    return gen.filter_gen(
        lambda op: op["value"]["from"] != op["value"]["to"], bank_transfer)


def rds_test(opts: dict) -> dict:
    """Bank test against a managed endpoint (postgres_rds.clj:269-294):
    no DB lifecycle, no nemesis (the service's failovers ARE the
    nemesis), mixed reads/transfers then a final quiescent read."""
    from ..testlib import noop_test

    n = opts.get("accounts", 8)
    starting = opts.get("starting_balance", 10)
    lock_type = " for update" if opts.get("lock") else ""
    bank = BankClient(n, starting, lock_type=lock_type,
                      in_place=opts.get("in_place", False))
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": "postgres-rds bank",
            "os": None,
            "db": None,
            "client": bank,
            "nemesis": nemesis.noop,
            "accounts_n": n,
            "generator": gen.phases(
                gen.time_limit(
                    opts.get("time_limit", 20),
                    gen.clients(gen.stagger(
                        opts.get("stagger", 0.1),
                        gen.mix([bank_read, bank_diff_transfer()]))),
                ),
                gen.log("waiting for quiescence"),
                gen.sleep(opts.get("quiesce", 10)),
                gen.clients(gen.once(bank_read)),
            ),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "bank": RdsBankChecker(n, n * starting),
            }),
        }
    )
    return test


def _opt_spec(p) -> None:
    p.add_argument("--accounts", type=int, default=8)
    p.add_argument("--starting-balance", dest="starting_balance",
                   type=int, default=10)
    p.add_argument("--lock", action="store_true",
                   help="select ... for update row locking")
    p.add_argument("--in-place", dest="in_place", action="store_true")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(rds_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
