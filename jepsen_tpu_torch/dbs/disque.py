"""Disque test suite: at-least-once distributed job queue driven with
enqueue/dequeue/drain ops and checked with total-queue (reference:
disque/src/jepsen/disque.clj:1-321).

Pieces, mirroring the reference:
  - DisqueDB      — build-or-install + daemon lifecycle + CLUSTER MEET
                    join to the primary (disque.clj:40-135)
  - DisqueClient  — ADDJOB/GETJOB/ACKJOB over RESP with a
                    reconnect-on-failure wrapper (the reference's
                    goldfish-replacing reconnecting-client,
                    disque.clj:163-192); dequeue acks what it takes;
                    drain loops until a poll comes back empty
                    (disque.clj:194-240)
  - disque_test   — test map with partitioner nemesis and the final
                    heal-then-drain phase; total-queue checker

The port's copy of `jepsen_tpu/dbs/disque.py`. Its total-queue
checker runs on the host: the suite reaches no kernel. `local_cluster`
and `local_test_fn` run it on simulated nodes over `LocalRemote`,
against `redis_sim.py` (whose job commands are disque's)."""

from __future__ import annotations

import itertools
import logging
import socket
import time

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, db, generator as gen, osdist, reconnect
from ..history import Op
from . import redis_proto
from .common import ArchiveDB, SuiteCfg, ready_gated_final, resp_ping_ready

log = logging.getLogger("jepsen_tpu_torch.dbs.disque")

PORT = 7711
QUEUE = "jepsen"
CLIENT_TIMEOUT_MS = 100  # job poll timeout


_suite = SuiteCfg("disque", PORT, "/opt/disque")
node_host = _suite.host
node_port = _suite.port


class DisqueDB(ArchiveDB):
    """disque-server per node, joined via CLUSTER MEET to the primary
    (disque.clj:40-135). The reference builds from source on-node;
    archive mode installs a prebuilt (or sim) tarball through the same
    daemon machinery."""

    binary = "disque-server"
    log_name = "disque.log"
    pid_name = "disque.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 30.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        return ["--port", str(node_port(test, node))]

    def probe_ready(self, test, node) -> bool:
        return resp_ping_ready(_suite, test, node)

    def post_start(self, test, node) -> None:
        # join everyone to the primary (disque.clj:96-105)
        primary = test["nodes"][0]
        if node == primary:
            return
        conn = redis_proto.RespConn(
            node_host(test, node), node_port(test, node))
        try:
            res = conn.call("CLUSTER", "MEET",
                            node_host(test, primary),
                            node_port(test, primary))
            if res != "OK":
                raise db.SetupFailed(f"cluster meet said {res!r}")
        finally:
            conn.close()


class DisqueClient(client.Client):
    """enqueue = ADDJOB, dequeue = GETJOB+ACKJOB, drain = dequeue until
    empty (disque.clj:194-262). An empty poll is a definite :fail; any
    connection trouble on enqueue/dequeue is :info (the job may or may
    not be in)."""

    def __init__(self, conn=None, queue: str = QUEUE):
        self.conn = conn
        self.queue = queue

    def open(self, test, node):
        wrapped = reconnect.wrapper(
            open=lambda: redis_proto.RespConn(
                node_host(test, node), node_port(test, node)),
            close=lambda c: c.close(),
            name=f"disque {node}",
        ).open()
        return DisqueClient(wrapped, self.queue)

    def _dequeue_once(self, c):
        """(job-id, body) or None."""
        got = c.call("GETJOB", "TIMEOUT", CLIENT_TIMEOUT_MS, "COUNT", 1,
                     "FROM", self.queue)
        if not got:
            return None
        _q, jid, body = got[0]
        c.call("ACKJOB", jid)
        return jid, body

    def _drain(self, op: Op) -> Op:
        """Dequeue until empty. Errors mid-drain keep the values already
        ACKed — dropping them would make the queue checker count
        definitely-consumed jobs as lost."""
        values = []
        deadline = time.monotonic() + 10.0
        try:
            with self.conn.with_conn() as c:
                while time.monotonic() < deadline:
                    got = self._dequeue_once(c)
                    if got is None:
                        return op.with_(type="ok", value=values)
                    values.append(int(got[1].decode()))
            return op.with_(type="info", error="drain-timeout",
                            value=values)
        except (redis_proto.RespError, ConnectionError, socket.timeout,
                TimeoutError, OSError) as e:
            return op.with_(type="info", error=str(e), value=values)

    def invoke(self, test, op: Op) -> Op:
        if op.f == "drain":
            return self._drain(op)
        try:
            with self.conn.with_conn() as c:
                if op.f == "enqueue":
                    c.call("ADDJOB", self.queue, str(op.value), 100)
                    return op.with_(type="ok")
                if op.f == "dequeue":
                    got = self._dequeue_once(c)
                    if got is None:
                        return op.with_(type="fail", error="empty")
                    return op.with_(type="ok", value=int(got[1].decode()))
                raise ValueError(f"unknown op {op.f!r}")
        except redis_proto.RespError as e:
            return op.with_(type="info", error=str(e))
        except (socket.timeout, TimeoutError):
            return op.with_(type="info", error="timeout")
        except (ConnectionError, OSError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


def queue_gen() -> gen.Generator:
    counter = itertools.count()

    def enqueue(test, process):
        return {"type": "invoke", "f": "enqueue", "value": next(counter)}

    return gen.mix([enqueue, {"type": "invoke", "f": "dequeue"}])


def disque_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = DisqueDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": "disque",
            "os": osdist.debian,
            "db": db_,
            "client": DisqueClient(),
            "nemesis": cmn.pick_nemesis(db_, opts),
            "generator": gen.phases(
                gen.time_limit(
                    opts.get("time_limit", 60),
                    gen.nemesis(
                        gen.start_stop(10, 10),
                        gen.stagger(opts.get("stagger", 1 / 10),
                                    queue_gen()),
                    ),
                ),
                gen.log("Healing cluster"),
                gen.nemesis(gen.once({"type": "info", "f": "stop"})),
                gen.sleep(opts.get("quiesce", 10)),
                ready_gated_final(
                    db_,
                    gen.clients(gen.each(
                        lambda: gen.once(
                            {"type": "invoke", "f": "drain"}))),
                    opts),
            ),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "queue": checker_mod.total_queue(),
            }),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--archive-url", dest="archive_url", default=None,
                   help="disque release archive (or the in-repo sim "
                        "archive for hermetic runs).")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(disque_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the disque suite against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under
    "disque"): `redis_sim`'s archive with a `disque-server` binary."""
    from . import redis_sim
    from .simbase import sim_cluster

    return sim_cluster(root, nodes, ports, "disque", "disque-server-sim",
                       redis_sim.build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `disque_test` on a `local_cluster` (`simbase.sim_test_fn`): the
    suite's nemesis on the no-op network (partitions recorded and
    healed); start-kill acts on a node's one simulator process;
    start-stop's `killall disque-server` finds no process of that name
    (the nodes are Python processes); fs-break refused."""
    from .simbase import sim_test_fn

    return sim_test_fn(cluster, "disque", disque_test)


if __name__ == "__main__":
    main()
