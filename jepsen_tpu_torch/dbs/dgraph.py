"""Dgraph test suite: set and upsert workloads over the HTTP API
(reference: dgraph/src/jepsen/dgraph/{core,client,set,
upsert}.clj — the reference drives dgraph4j over gRPC; this speaks the
HTTP mutate/query API, dgraph's other first-class surface).

Workloads:
  - set: integers as nodes with a value predicate; final read queries
    has(value) — every acknowledged add must appear (set.clj:20-53)
  - upsert: concurrent insert-if-absent of the same key via an upsert
    block (query + cond); under snapshot isolation at most ONE insert
    per key may win (upsert.clj:20-68)

The port's copy of `jepsen_tpu/dbs/dgraph.py`. Of its workloads
(`dgraph_workloads.py`), linearizable-register and
uid-linearizable-register reach the card through the per-key
`linearizable` (K1, `ops/csrc/wgl_vec.cu`, a launch a key, or K5), and
long-fork through the cycle checker's K3 `closure_word`
(`ops/csrc/closure.cu`), on the test map's `device` (the CLI's
`--device`; None = the card, resolved before anything is provisioned).
`--tracing FILE` writes every client call's span (`trace.py`).
`dgraph_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import socket
import urllib.error
import urllib.parse
import urllib.request

from .. import checker as checker_mod
from .. import cli, client, generator as gen, nemesis, osdist
from .. import trace
from ..checker import Checker
from ..history import Op, ops as _ops
from .common import ArchiveDB, SuiteCfg

log = logging.getLogger("jepsen_tpu_torch.dbs.dgraph")

PORT = 8080


_suite = SuiteCfg("dgraph", PORT, "/opt/dgraph")
node_host = _suite.host
node_port = _suite.port


class DgraphDB(ArchiveDB):
    """dgraph alpha per node, pointed at the first node's zero
    (dgraph/support.clj's cluster bring-up)."""

    binary = "dgraph"
    log_name = "dgraph.log"
    pid_name = "dgraph.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        primary = test["nodes"][0]
        return ["--port", str(node_port(test, node)),
                "--zero", f"{node_host(test, primary)}:5080",
                "--my", f"{node_host(test, node)}:7080"]

    def probe_ready(self, test, node) -> bool:
        url = (f"http://{node_host(test, node)}:{node_port(test, node)}"
               "/health")
        with urllib.request.urlopen(url, timeout=2) as resp:
            return resp.status == 200


class DgraphConn:
    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def _post(self, path: str, body: dict, params: dict | None = None) -> dict:
        # Spans around every wire call, like the reference's client
        # wraps each query/mutation (dgraph/trace.clj:43-53).
        with trace.with_trace(f"dgraph.client{path}"):
            url = self.base + path
            if params:
                url += "?" + urllib.parse.urlencode(params)
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    out = json.load(resp)
            except urllib.error.HTTPError as e:
                try:
                    out = json.load(e)
                except json.JSONDecodeError:
                    raise DgraphError(f"HTTP {e.code}") from e
                msg = (out.get("errors") or [{}])[0].get("message", "")
                if "aborted" in msg.lower():
                    # client.clj:105-167 maps this to :fail :conflict
                    raise TxnConflict(msg) from e
                raise DgraphError(msg or f"HTTP {e.code}") from e
            if out.get("errors"):
                raise DgraphError(out["errors"][0].get("message", "error"))
            return out

    def alter(self, schema: str) -> None:
        self._post("/alter", {"schema": schema})

    def mutate(self, sets: list, query: str | None = None,
               cond: str | None = None) -> dict:
        """One-shot (auto-commit) mutation."""
        body: dict = {"set": sets}
        if query is not None:
            body["query"] = query
        if cond is not None:
            body["cond"] = cond
        return self._post("/mutate", body)["data"]["uids"]

    def query(self, q: str) -> list:
        return self._post("/query", {"query": q})["data"]["q"]

    def txn(self) -> "DgraphTxn":
        return DgraphTxn(self)


class DgraphTxn:
    """A dgraph transaction: start_ts assigned by the server on first
    contact, reads from that snapshot, mutations staged server-side,
    commit detects write-write conflicts (client.clj:66-103's
    Transaction object over the HTTP API)."""

    def __init__(self, conn: DgraphConn):
        self.conn = conn
        self.start_ts = 0
        self.finished = False

    def _ts(self, out: dict) -> None:
        ts = ((out.get("extensions") or {}).get("txn") or {}).get("start_ts")
        if ts and not self.start_ts:
            self.start_ts = int(ts)

    def query(self, q: str) -> list:
        out = self.conn._post("/query", {"query": q},
                              params={"startTs": self.start_ts})
        self._ts(out)
        return out["data"]["q"]

    def mutate(self, sets: list | None = None, dels: list | None = None,
               query: str | None = None, cond: str | None = None) -> dict:
        body: dict = {}
        if sets:
            body["set"] = sets
        if dels:
            body["delete"] = dels
        if query is not None:
            body["query"] = query
        if cond is not None:
            body["cond"] = cond
        out = self.conn._post(
            "/mutate", body,
            params={"startTs": self.start_ts, "commitNow": "false"})
        self._ts(out)
        return out["data"]["uids"]

    def commit(self) -> None:
        """Commit; raises TxnConflict on a write-write conflict."""
        if self.finished or not self.start_ts:
            self.finished = True
            return
        self.finished = True
        self.conn._post("/commit", {}, params={"startTs": self.start_ts})

    def discard(self) -> None:
        """Abort (client.clj:55-64's abort-txn!); idempotent."""
        if self.finished or not self.start_ts:
            self.finished = True
            return
        self.finished = True
        try:
            self.conn._post("/commit", {},
                            params={"startTs": self.start_ts,
                                    "abort": "true"})
        except (DgraphError, urllib.error.URLError, OSError,
                socket.timeout):
            # Abort must never mask the body's exception — a dead or
            # partitioned node makes the discard a best-effort no-op
            # (client.clj:55-64 tolerates ABORTED the same way).
            pass


@contextlib.contextmanager
def with_txn(conn: DgraphConn):
    """Open a transaction, commit at the end of the body, discard on
    exception (client.clj:66-89's with-txn macro)."""
    t = conn.txn()
    try:
        yield t
        t.commit()
    finally:
        t.discard()


def with_conflict_as_fail(op: Op, fn):
    """Run fn(); a transaction conflict completes `op` as :fail
    :conflict instead of raising (client.clj:105-167). Other errors
    follow the read-fail / write-indeterminate taxonomy at the call
    site."""
    try:
        return fn()
    except TxnConflict:
        return op.with_(type="fail", error="conflict")


class DgraphError(Exception):
    pass


class TxnConflict(DgraphError):
    """The server aborted the transaction at commit (write-write
    conflict) — always safe to call :fail, the txn did not apply."""


class SetClient(client.Client):
    """Adds as fresh nodes (set.clj:20-53)."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        conn = DgraphConn(node_host(test, node), node_port(test, node))
        conn.alter("value: int @index(int) .")
        return SetClient(conn)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                self.conn.mutate([{"type": "element",
                                   "value": op.value}])
                return op.with_(type="ok")
            if op.f == "read":
                rows = self.conn.query(
                    "{ q(func: has(value)) { uid value } }")
                return op.with_(
                    type="ok",
                    value=sorted(r["value"] for r in rows
                                 if "value" in r))
            raise ValueError(f"unknown op {op.f!r}")
        except (DgraphError, socket.timeout, TimeoutError,
                urllib.error.URLError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        pass


class UpsertClient(client.Client):
    """Insert-if-absent races via an upsert block (upsert.clj:20-50):
    each txn queries for the key and inserts only when absent."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        conn = DgraphConn(node_host(test, node), node_port(test, node))
        conn.alter("key: int @index(int) @upsert .")
        return UpsertClient(conn)

    def invoke(self, test, op: Op) -> Op:
        k = op.value
        try:
            if op.f == "upsert":
                uids = self.conn.mutate(
                    [{"key": k}],
                    query=f"{{ v(func: eq(key, {k})) {{ uid }} }}",
                    cond="@if(eq(len(v), 0))",
                )
                # no uids assigned => the cond failed => lost the race
                return op.with_(type="ok" if uids else "fail",
                                error=None if uids else "already-exists")
            if op.f == "read":
                rows = self.conn.query(
                    f"{{ q(func: eq(key, {k})) {{ uid }} }}")
                return op.with_(type="ok",
                                value=(k, [r["uid"] for r in rows]))
            raise ValueError(f"unknown op {op.f!r}")
        except (DgraphError, socket.timeout, TimeoutError,
                urllib.error.URLError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        pass


class UpsertChecker(Checker):
    """At most one upsert per key may succeed, AND the final read must
    show at most one uid per key (upsert.clj:53-68) — the read catches
    double-commits whose second ack was lost to a partition (:info)."""

    def check(self, test, history, opts=None) -> dict:
        ok_upserts: dict = {}
        multi_uids: dict = {}
        for o in _ops(history):
            if o.f == "upsert" and o.is_ok:
                ok_upserts[o.value] = ok_upserts.get(o.value, 0) + 1
            if o.f == "read" and o.is_ok:
                k, uids = o.value
                if len(uids) > 1:
                    multi_uids[k] = uids
        multi = {k: n for k, n in ok_upserts.items() if n > 1}
        return {"valid": not multi and not multi_uids,
                "multiple_upserts": multi,
                "multiple_uids": multi_uids}


def workloads(opts: dict) -> dict:
    # Imported here: dgraph_workloads imports this module's txn layer.
    from . import dgraph_workloads as dw

    return {
        "bank": dw.bank_workload(opts),
        "delete": dw.delete_workload(opts),
        "sequential": dw.sequential_workload(opts),
        "linearizable-register": dw.lr_workload(opts),
        "uid-linearizable-register": dw.uid_lr_workload(opts),
        "long-fork": dw.long_fork_workload(opts),
        "types": dw.types_workload(opts),
        "set": {
            "client": SetClient(),
            "during": gen.stagger(
                opts.get("stagger", 0.05),
                gen.seq({"type": "invoke", "f": "add", "value": x}
                        for x in itertools.count())),
            "final": gen.clients(gen.each(
                lambda: gen.once({"type": "invoke", "f": "read"}))),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "set": checker_mod.set_checker(),
            }),
        },
        "upsert": {
            "client": UpsertClient(),
            # every process races to upsert the same keys
            "during": gen.seq(
                gen.each(lambda k=k: gen.once(
                    {"type": "invoke", "f": "upsert", "value": k}))
                for k in range(opts.get("keys", 20))),
            # final read of every key catches double-commits whose
            # second ack went :info
            "final": gen.clients(gen.seq(
                {"type": "invoke", "f": "read", "value": k}
                for k in range(opts.get("keys", 20)))),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "upsert": UpsertChecker(),
            }),
        },
    }


def dgraph_test(opts: dict) -> dict:
    from ..testlib import noop_test

    from . import dgraph_nemesis

    # Configure span tracing (dgraph/core.clj wires trace/tracing from
    # the CLI's --tracing endpoint; here the endpoint is a JSONL path).
    trace.tracing(opts.get("tracing"))
    wl = workloads(opts)[opts.get("workload", "set")]
    db = DgraphDB(archive_url=opts.get("archive_url"))
    # Failure-mode flags select the full composed nemesis
    # (dgraph/nemesis.clj:122-180); default is partition halves.
    pkg = dgraph_nemesis.package(db, opts)
    if pkg is None:
        pkg = {"nemesis": nemesis.partition_random_halves(),
               "generator": gen.start_stop(10, 10),
               "final_generator": gen.once(
                   {"type": "info", "f": "stop"})}
    generator = gen.time_limit(
        opts.get("time_limit", 60),
        gen.nemesis(pkg["generator"], wl["during"]),
    )
    if wl.get("final") is not None:
        heal = ([gen.nemesis(pkg["final_generator"])]
                if pkg.get("final_generator") is not None else [])
        from .common import ready_gated_final

        generator = gen.phases(
            generator,
            *heal,
            gen.sleep(opts.get("quiesce", 10)),
            # health-gate the final reads: the heal's restart returns
            # before the daemon binds (common.AwaitReadyGen)
            ready_gated_final(db, wl["final"], opts),
        )
    test = noop_test()
    test.update(opts)
    test.update(wl.get("test_opts", {}))
    test.update(
        {
            "name": f"dgraph {opts.get('workload', 'set')}",
            "os": osdist.debian,
            "db": db,
            "client": wl["client"],
            "nemesis": pkg["nemesis"],
            "generator": generator,
            "checker": wl["checker"],
        }
    )
    if wl.get("model") is not None:
        test["model"] = wl["model"]
    return test


def _opt_spec(p) -> None:
    p.add_argument("--workload", default="set",
                   choices=["set", "upsert", "bank", "delete",
                            "sequential", "linearizable-register",
                            "uid-linearizable-register",
                            "long-fork", "types"])
    p.add_argument("--archive-url", dest="archive_url", default=None)
    p.add_argument("--tracing", default=None, metavar="SPANS_JSONL",
                   help="export client/nemesis spans to this JSONL file")
    # Failure-mode flags (dgraph/core.clj's nemesis options)
    for flag in ("kill-alpha", "kill-zero", "fix-alpha",
                 "partition-halves", "partition-ring", "skew-clock",
                 "move-tablet"):
        p.add_argument(f"--{flag}", dest=flag.replace("-", "_"),
                       action="store_true")
    p.add_argument("--skew", default=None,
                   choices=["tiny", "small", "big", "huge"])
    p.add_argument("--interval", type=float, default=10.0,
                   help="seconds between nemesis operations")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(dgraph_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
