"""MongoDB test suites: document-level compare-and-set against a
replica set, in two flavors matching the reference's pair of suites —
mongodb-rocks (mongod on the RocksDB storage engine,
mongodb-rocks/src/jepsen/mongodb_rocks.clj) and
mongodb-smartos (mongod provisioned on SmartOS,
mongodb-smartos/src/jepsen/mongodb_smartos/
{core,document_cas,transfer}.clj).

Workloads:
  - document-cas: one document's `value` field as a register
    (document_cas.clj:40-95): read = find by _id (primary read
    preference); write = update-by-id asserting n==1; cas = conditional
    update, n==0 → :fail. Reads are idempotent → indeterminate reads
    remap to :fail; writes/cas keep :info (with-errors op #{:read}).
  - transfer: bank transfers across two documents WITHOUT multi-doc
    transactions — the point of transfer.clj is that mongo (of this
    era) loses money under faults; the bank totals checker reports it.

Write concern is an option ("majority" by default, the reference's
safest mode).

The port's copy of `jepsen_tpu/dbs/mongodb.py`. document-cas's checker
is `linearizable` on the one unkeyed CAS-register history, which `auto`
routes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries) or K5
(`ops/csrc/wgl_row.cu`), or to the native search below the committed
bars; the test map's `device` (the CLI's `--device`; None = the card)
goes to that checker. transfer and logger-perf reach only host
checkers. A composed package's clock family takes `opts["set_time_fn"]`
(else `nemesis.set_time`). `mongo_sim.local_test_fn` runs the suite on
simulated nodes over `LocalRemote`.
"""

from __future__ import annotations

import logging
import random
import socket
import time

from .. import checker as checker_mod
from .. import cli, client, generator as gen, models, osdist
from ..checker import Checker
from ..history import Op, ops as _ops
from . import mongo_proto
from .common import ArchiveDB, SuiteCfg, once, shared_flag
from . import common as cmn

log = logging.getLogger("jepsen_tpu_torch.dbs.mongodb")

PORT = 27017
DB_NAME = "jepsen"
COLL = "jepsen"
REG_ID = 0


_suite = SuiteCfg("mongodb", PORT, "/opt/mongodb")
node_host = _suite.host
node_port = _suite.port


class MongoDB(ArchiveDB):
    """mongod per node as one replica set; the primary issues
    replSetInitiate once members answer (core.clj:40-130's install/
    configure/start + replica-set bring-up)."""

    binary = "mongod"
    log_name = "mongod.log"
    pid_name = "mongod.pid"

    def __init__(self, archive_url: str | None = None,
                 storage_engine: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)
        self.storage_engine = storage_engine

    def daemon_args(self, test, node) -> list:
        d = _suite.dir(test, node)
        args = ["--replSet", "jepsen",
                "--dbpath", f"{d}/data",
                "--bind_ip", "0.0.0.0",
                "--port", str(node_port(test, node))]
        if self.storage_engine:
            # mongodb-rocks: mongod --storageEngine rocksdb
            args += ["--storageEngine", self.storage_engine]
        return args

    def probe_ready(self, test, node) -> bool:
        conn = mongo_proto.MongoConn(
            node_host(test, node), node_port(test, node),
            timeout=2.0, connect_timeout=2.0)
        try:
            conn.command("admin", {"ping": 1})
            return True
        except mongo_proto.MongoError:
            return False
        finally:
            conn.close()

    def post_start(self, test, node) -> None:
        if node != test["nodes"][0]:
            return
        members = [
            {"_id": i, "host": f"{node_host(test, n)}:"
                               f"{node_port(test, n)}"}
            for i, n in enumerate(test["nodes"])
        ]
        conn = mongo_proto.MongoConn(
            node_host(test, node), node_port(test, node))
        try:
            conn.command("admin", {
                "replSetInitiate": {"_id": "jepsen",
                                    "members": members}})
        except mongo_proto.MongoError as e:
            if "already initialized" not in str(e):
                raise
        finally:
            conn.close()


class DocumentCasClient(client.Client):
    """Register on one document (document_cas.clj:40-95)."""

    def __init__(self, write_concern: str = "majority", conn=None,
                 flag=None):
        self.write_concern = write_concern
        self.conn = conn
        self.flag = flag or shared_flag()

    def open(self, test, node):
        conn = mongo_proto.MongoConn(node_host(test, node),
                                     node_port(test, node))
        me = DocumentCasClient(self.write_concern, conn, self.flag)
        once(self.flag, lambda: conn.update(
            DB_NAME, COLL, {"_id": REG_ID},
            {"_id": REG_ID, "value": None}, upsert=True,
            w=self.write_concern))
        return me

    def invoke(self, test, op: Op) -> Op:
        try:
            out = self._invoke(op)
        except (mongo_proto.MongoError, socket.timeout, TimeoutError,
                ConnectionError, OSError) as e:
            out = op.with_(type="info", error=str(e))
        # reads are idempotent: indeterminate reads remap to :fail
        # (with-errors op #{:read}, core.clj's error macro)
        if op.f == "read" and out.type == "info":
            out = out.with_(type="fail")
        return out

    def _invoke(self, op: Op) -> Op:
        if op.f == "read":
            doc = self.conn.find_one(DB_NAME, COLL, {"_id": REG_ID})
            return op.with_(type="ok",
                            value=doc["value"] if doc else None)
        if op.f == "write":
            res = self.conn.update(
                DB_NAME, COLL, {"_id": REG_ID},
                {"_id": REG_ID, "value": op.value},
                w=self.write_concern)
            if res.get("n") != 1:
                return op.with_(type="info", error=f"n={res.get('n')}")
            return op.with_(type="ok")
        if op.f == "cas":
            old, new = op.value
            res = self.conn.update(
                DB_NAME, COLL, {"_id": REG_ID, "value": old},
                {"_id": REG_ID, "value": new},
                w=self.write_concern)
            n = res.get("n", 0)
            if n == 0:
                return op.with_(type="fail")
            if n == 1:
                return op.with_(type="ok")
            raise mongo_proto.MongoError(
                {"errmsg": f"CAS modified {n} documents"})
        raise ValueError(f"unknown op {op.f!r}")

    def close(self, test):
        if self.conn:
            self.conn.close()


class LoggerClient(client.Client):
    """The mongodb-rocks logger/queue perf client
    (mongodb_rocks.clj:85-134): write = insert a timestamped document
    keyed by the generator's unique id; delete = findAndModify-remove
    the OLDEST document (sort time ascending). No linearizability
    model — the workload exists to hammer the storage engine and plot
    latency (checker = perf only, :157-168)."""

    def __init__(self, conn=None, payload_bytes: int = 64):
        self.conn = conn
        self.payload = "x" * payload_bytes

    def open(self, test, node):
        conn = mongo_proto.MongoConn(node_host(test, node),
                                     node_port(test, node))
        return LoggerClient(conn, len(self.payload))

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                res = self.conn.insert(
                    DB_NAME, "logger",
                    [{"_id": op.value,
                      "time": int(time.time() * 1000),
                      "payload": self.payload}],
                    w="acknowledged")
                if res.get("writeErrors"):
                    # a server-side write error is a DEFINITE
                    # non-application (e.g. duplicate _id), not an
                    # indeterminate timeout
                    return op.with_(type="fail",
                                    error=str(res["writeErrors"][0]))
                return op.with_(type="ok")
            if op.f == "delete":
                res = self.conn.find_and_modify(
                    DB_NAME, "logger", query={}, sort={"time": 1},
                    remove=True)
                doc = res.get("value")
                if doc is None:
                    return op.with_(type="fail")
                return op.with_(type="ok", value=doc.get("_id"))
            raise ValueError(f"unknown op {op.f!r}")
        except (mongo_proto.MongoError, socket.timeout, TimeoutError,
                ConnectionError, OSError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


def logger_write(test, process):
    # timestamped unique id, the reference's "<epoch>-oempa_<rand>"
    return {"type": "invoke", "f": "write",
            "value": f"{int(time.time())}-oempa_{random.randrange(2**31)}"}


def logger_delete(test, process):
    return {"type": "invoke", "f": "delete", "value": None}


class TransferClient(client.Client):
    """Bank transfers across account documents WITHOUT transactions
    (transfer.clj:1-281): read each balance, conditionally CAS each
    document — partial failures lose or invent money, which the totals
    checker surfaces."""

    def __init__(self, n: int = 4, starting_balance: int = 10,
                 write_concern: str = "majority", conn=None, flag=None):
        self.n = n
        self.starting_balance = starting_balance
        self.write_concern = write_concern
        self.conn = conn
        self.flag = flag or shared_flag()

    def open(self, test, node):
        conn = mongo_proto.MongoConn(node_host(test, node),
                                     node_port(test, node))
        me = TransferClient(self.n, self.starting_balance,
                            self.write_concern, conn, self.flag)

        def create():
            for i in range(self.n):
                conn.update(DB_NAME, "accounts", {"_id": i},
                            {"_id": i, "balance": self.starting_balance},
                            upsert=True, w=self.write_concern)

        once(self.flag, create)
        return me

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                docs = self.conn.find_all(DB_NAME, "accounts")
                return op.with_(type="ok",
                                value={d["_id"]: d["balance"]
                                       for d in docs})
            if op.f == "transfer":
                frm, to = op.value["from"], op.value["to"]
                amount = op.value["amount"]
                a = self.conn.find_one(DB_NAME, "accounts", {"_id": frm})
                b = self.conn.find_one(DB_NAME, "accounts", {"_id": to})
                if a is None or b is None:
                    return op.with_(type="fail", error="missing-account")
                if a["balance"] < amount:
                    return op.with_(type="fail", error="insufficient")
                # two independent CAS writes — no transaction
                r1 = self.conn.update(
                    DB_NAME, "accounts",
                    {"_id": frm, "balance": a["balance"]},
                    {"_id": frm, "balance": a["balance"] - amount},
                    w=self.write_concern)
                if r1.get("n") != 1:
                    return op.with_(type="fail", error="cas-from")
                r2 = self.conn.update(
                    DB_NAME, "accounts",
                    {"_id": to, "balance": b["balance"]},
                    {"_id": to, "balance": b["balance"] + amount},
                    w=self.write_concern)
                if r2.get("n") != 1:
                    # money already left `from`: indeterminate overall
                    return op.with_(type="info", error="cas-to")
                return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except (mongo_proto.MongoError, socket.timeout, TimeoutError,
                ConnectionError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class TransferTotalsChecker(Checker):
    """Totals must be conserved — the transfer workload exists to show
    they are not under faults (transfer.clj's checker)."""

    def __init__(self, total: int):
        self.total = total

    def check(self, test, history, opts=None) -> dict:
        bad = [o.to_dict() for o in _ops(history)
               if o.is_ok and o.f == "read"
               and sum(o.value.values()) != self.total]
        return {"valid": not bad, "bad_reads": bad[:10]}


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def transfer_gen(test, process):
    n = test.get("accounts_n", 4)
    frm, to = random.sample(range(n), 2)
    return {"type": "invoke", "f": "transfer",
            "value": {"from": frm, "to": to,
                      "amount": 1 + random.randrange(3)}}


def workloads(opts: dict) -> dict:
    wc = opts.get("write_concern", "majority")
    n = opts.get("accounts", 4)
    starting = opts.get("starting_balance", 10)
    mix = ([w, cas, cas] if opts.get("no_read") else [r, w, cas, cas])
    return {
        "document-cas": {
            "client": DocumentCasClient(wc),
            "during": gen.stagger(opts.get("stagger", 0.05),
                                  gen.mix(mix)),
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "linear": checker_mod.linearizable(
                    device=opts.get("device")),
            }),
        },
        "transfer": {
            "client": TransferClient(n, starting, wc),
            "during": gen.stagger(opts.get("stagger", 0.05),
                                  gen.mix([r, transfer_gen])),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "totals": TransferTotalsChecker(n * starting),
            }),
            "test_opts": {"accounts_n": n},
        },
        # mongodb-rocks's logger-perf-test (mongodb_rocks.clj:157-168):
        # 2:1 timestamped inserts vs remove-oldest, latency plots only
        "logger-perf": {
            "client": LoggerClient(),
            "during": gen.stagger(
                opts.get("stagger", 0.01),
                gen.mix([logger_write, logger_write, logger_delete])),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
            }),
        },
    }


def mongodb_test(opts: dict) -> dict:
    from ..testlib import noop_test

    wl = workloads(opts)[opts.get("workload", "document-cas")]
    flavor = opts.get("flavor", "rocks")
    db_ = MongoDB(
        archive_url=opts.get("archive_url"),
        storage_engine="rocksdb" if flavor == "rocks" else None)
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": f"mongodb-{flavor} {opts.get('workload', 'document-cas')}",
            # mongodb-smartos runs on SmartOS; rocks on debian
            "os": osdist.smartos if flavor == "smartos" else osdist.debian,
            "db": db_,
            "client": wl["client"],
            "model": wl.get("model"),
            "generator": wl["during"],
            "checker": wl["checker"],
        }
    )
    # MongoDB inherits kill/pause from ArchiveDB, so composed fault
    # packages ("--nemesis kill,partition") work out of the box; plain
    # registry names fall through to pick_nemesis as before.
    if not cmn.fault_package_wiring(
            test, db_, opts,
            stability_generator=wl["during"],
            corrupt_paths=opts.get("corrupt_paths")
            or [lambda t, n: f"{db_.suite.dir(t, n)}/{db_.log_name}"],
            set_time_fn=opts.get("set_time_fn")):
        test.update({
            "nemesis": cmn.pick_nemesis(db_, opts),
            "generator": gen.time_limit(
                opts.get("time_limit", 60),
                gen.nemesis(
                    gen.start_stop(10, 10),
                    wl["during"],
                ),
            ),
        })
    test.update(wl.get("test_opts") or {})
    return test


def mongodb_rocks_test(opts: dict) -> dict:
    """mongodb_rocks.clj — document CAS on the RocksDB engine."""
    return mongodb_test({**opts, "flavor": "rocks"})


def mongodb_smartos_test(opts: dict) -> dict:
    """mongodb_smartos — the same suite provisioned on SmartOS."""
    return mongodb_test({**opts, "flavor": "smartos"})


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--workload", default="document-cas",
                   choices=["document-cas", "transfer", "logger-perf"])
    p.add_argument("--archive-url", dest="archive_url", default=None)
    p.add_argument("--flavor", default="rocks",
                   choices=["rocks", "smartos"])
    p.add_argument("--write-concern", dest="write_concern",
                   default="majority")
    p.add_argument("--no-read", dest="no_read", action="store_true",
                   help="document_cas.clj's no-read variant (mongo has "
                        "no linearizable reads)")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(mongodb_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
