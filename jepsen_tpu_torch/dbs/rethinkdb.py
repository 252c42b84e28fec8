"""RethinkDB test suite: document-level compare-and-set over ReQL with
per-key independence (reference:
rethinkdb/src/jepsen/rethinkdb.clj and
rethinkdb/document_cas.clj:1-185).

The CAS is the reference's exact ReQL shape: an update whose FUNC body
branches on get_field equality and raises r.error("abort") otherwise —
verdict decided by the reply's replaced/errors counts
(document_cas.clj:93-107). Reads use get_field with a DEFAULT fallback
for missing documents; writes insert with conflict=update.

The port's copy of `jepsen_tpu/dbs/rethinkdb.py`. Its checker is
`independent.checker(compose(timeline, linearizable))`: each key's
history goes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries) or K5
(`ops/csrc/wgl_row.cu`) as `auto` routes it, or to the native search
below the committed bars; the test map's `device` (the CLI's
`--device`; None = the card) goes to that checker.
`rethink_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`.
"""

from __future__ import annotations

import itertools
import logging
import random
import socket

from .. import checker as checker_mod
from .. import cli, client, generator as gen, independent, models
from .. import nemesis as nemesis_mod
from .. import osdist
from ..history import Op
from . import rethink_proto as rp
from .common import ArchiveDB, SuiteCfg, once, shared_flag
from . import common as cmn

log = logging.getLogger("jepsen_tpu_torch.dbs.rethinkdb")

PORT = 28015
DB_NAME = "jepsen"
TBL = "cas"


_suite = SuiteCfg("rethinkdb", PORT, "/opt/rethinkdb")
node_host = _suite.host
node_port = _suite.port


class RethinkDB(ArchiveDB):
    """rethinkdb daemon per node, joined to the primary
    (rethinkdb.clj's install/start — `rethinkdb --join primary:29015`)."""

    binary = "rethinkdb"
    log_name = "rethinkdb.log"
    pid_name = "rethinkdb.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        d = _suite.dir(test, node)
        args = ["--driver-port", str(node_port(test, node)),
                "--directory", f"{d}/data"]
        primary = test["nodes"][0]
        if node != primary:
            args += ["--join", f"{node_host(test, primary)}:29015"]
        return args

    def probe_ready(self, test, node) -> bool:
        conn = rp.ReqlConn(node_host(test, node), node_port(test, node),
                           timeout=2.0, connect_timeout=2.0)
        conn.close()
        return True


class DocumentCasClient(client.Client):
    """Register per independent key (document_cas.clj:54-110). Reads
    are idempotent → indeterminate reads remap to :fail (with-errors op
    #{:read}); writes/cas stay :info on connection trouble."""

    def __init__(self, conn=None, flag=None, read_mode: str = "majority"):
        self.conn = conn
        self.flag = flag or shared_flag()
        self.read_mode = read_mode

    def open(self, test, node):
        conn = rp.ReqlConn(node_host(test, node), node_port(test, node))
        me = DocumentCasClient(conn, self.flag, self.read_mode)

        def create():
            conn.run(rp.db_create(DB_NAME))
            conn.run(rp.table_create(rp.db(DB_NAME), TBL,
                                     replicas=len(test["nodes"])))

        once(self.flag, create)
        return me

    def _table(self):
        return rp.table(rp.db(DB_NAME), TBL, read_mode=self.read_mode)

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        try:
            out = self._invoke(k, v, op)
        except (rp.ReqlError, socket.timeout, TimeoutError,
                ConnectionError, OSError) as e:
            out = op.with_(type="info", error=str(e))
        if op.f == "read" and out.type == "info":
            out = out.with_(type="fail")
        return out

    def _invoke(self, k, v, op: Op) -> Op:
        row = rp.get(self._table(), k)
        if op.f == "read":
            value = self.conn.run(
                rp.default(rp.get_field(row, "val"), None))
            return op.with_(type="ok", value=independent.tuple_(k, value))
        if op.f == "write":
            res = self.conn.run(
                rp.insert(self._table(), {"id": k, "val": v},
                          conflict="update"))
            # an embedded write error (e.g. lost primary) arrives in a
            # SUCCESS_ATOM payload, not a RUNTIME_ERROR response
            if res.get("errors"):
                return op.with_(type="info",
                                error=res.get("first_error", "errors"))
            return op.with_(type="ok")
        if op.f == "cas":
            old, new = v
            res = self.conn.run(rp.update(
                row,
                rp.func(1, rp.branch(
                    rp.eq(rp.get_field(rp.var(1), "val"), old),
                    {"val": new},
                    rp.error("abort"),
                )),
            ))
            if res.get("errors") == 0 and res.get("replaced") == 1:
                return op.with_(type="ok")
            first_error = res.get("first_error", "")
            if res.get("errors") and "abort" not in first_error:
                # an infrastructure error (e.g. lost primary), not our
                # deliberate branch abort — the CAS may have applied
                return op.with_(type="info", error=first_error)
            return op.with_(type="fail")
        raise ValueError(f"unknown op {op.f!r}")

    def close(self, test):
        if self.conn:
            self.conn.close()


class ReconfigureNemesis(nemesis_mod.Nemesis):
    """Randomly reconfigures the table's topology: a random replica
    subset with a random primary, applied via ReQL reconfigure on the
    chosen primary, retried on the transient server-tag/unreachable
    errors a mid-partition cluster throws (rethinkdb.clj:196-231)."""

    RETRIES = 10

    def __init__(self, db_name: str = DB_NAME, table_name: str = TBL):
        self.db_name = db_name
        self.table_name = table_name

    def invoke(self, test, op):
        assert op.f == "reconfigure", op.f
        last: Exception | None = None
        for _ in range(self.RETRIES):
            nodes = list(test["nodes"])
            replicas = random.sample(nodes,
                                     1 + random.randrange(len(nodes)))
            primary = random.choice(replicas)
            try:
                conn = rp.ReqlConn(node_host(test, primary),
                                   node_port(test, primary))
            except OSError as e:
                last = e
                continue
            try:
                res = conn.run(rp.reconfigure(
                    rp.table(rp.db(self.db_name), self.table_name),
                    shards=1,
                    replicas={n: 1 for n in replicas},
                    primary_replica_tag=primary,
                ))
                if res.get("reconfigured") != 1:
                    raise rp.ReqlError(rp.RUNTIME_ERROR, str(res))
                return op.with_(value={"replicas": replicas,
                                       "primary": primary})
            except (rp.ReqlError, OSError) as e:
                # ConnectionError/timeouts are OSError subclasses; the
                # only real filter is which ReqlErrors are transient
                # (rethinkdb.clj:221-231's regex taxonomy)
                msg = str(e)
                last = e
                if (isinstance(e, OSError) or "server tag" in msg
                        or "unreachable" in msg):
                    log.warning("reconfigure caught; retrying: %s", msg)
                    continue
                raise
            finally:
                conn.close()
        return op.with_(value=f"reconfigure-failed: {last}")


def reconfigure_start_stop(t1: float, t2: float) -> gen.Generator:
    """The reference's nemesis feed: partition start/stop cycling with
    a reconfigure interposed between every transition
    (document_cas.clj:176-180's (interpose reconfigure
    (cycle [start stop])))."""

    def cycle():
        while True:
            yield gen.sleep(t1)
            yield {"type": "info", "f": "start"}
            yield {"type": "info", "f": "reconfigure"}
            yield gen.sleep(t2)
            yield {"type": "info", "f": "stop"}
            yield {"type": "info", "f": "reconfigure"}

    return gen.seq(cycle())


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def rethinkdb_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = RethinkDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    reconfigure = opts.get("workload") == "reconfigure"
    if reconfigure and opts.get("read_mode") not in (None, "majority"):
        # the reconfigure test is majority/majority BY DESIGN — it
        # "performs only writes and cas ops to prove that data loss
        # isn't just due to stale reads" (document_cas.clj:150-153);
        # silently ignoring the flag would misreport what was tested
        raise ValueError(
            "--workload reconfigure pins --read-mode majority "
            f"(got {opts['read_mode']!r})")
    test.update(
        {
            "name": ("rethinkdb document reconfigure" if reconfigure
                     else "rethinkdb document-cas"),
            "os": osdist.debian,
            "db": db_,
            "client": DocumentCasClient(
                read_mode=("majority" if reconfigure
                           else opts.get("read_mode", "majority"))),
            "nemesis": (
                # topology changes composed with partitions
                # (document_cas.clj:181-185)
                nemesis_mod.compose({
                    frozenset({"reconfigure"}): ReconfigureNemesis(),
                    frozenset({"start", "stop"}):
                        cmn.pick_nemesis(db_, opts),
                }) if reconfigure else cmn.pick_nemesis(db_, opts)),
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "indep": independent.checker(checker_mod.compose({
                    "timeline": checker_mod.timeline_html(),
                    "linear": checker_mod.linearizable(
                        device=opts.get("device")),
                })),
            }),
            "generator": gen.time_limit(
                opts.get("time_limit", 60),
                gen.nemesis(
                    (reconfigure_start_stop(10, 10) if reconfigure
                     else gen.start_stop(10, 10)),
                    independent.concurrent_generator(
                        opts.get("threads_per_key", 2),
                        itertools.count(),
                        # the reconfigure test "performs only writes
                        # and cas ops to prove that data loss isn't
                        # just due to stale reads"
                        # (document_cas.clj:150-153)
                        lambda k: gen.limit(
                            opts.get("ops_per_key", 50),
                            gen.stagger(opts.get("stagger", 0.05),
                                        gen.mix([w, cas] if reconfigure
                                                else [r, w, cas])),
                        ),
                    ),
                ),
            ),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--archive-url", dest="archive_url", default=None)
    p.add_argument("--read-mode", dest="read_mode", default="majority",
                   choices=["single", "majority", "outdated"])
    p.add_argument("--workload", default="cas",
                   choices=["cas", "reconfigure"])


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(rethinkdb_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
