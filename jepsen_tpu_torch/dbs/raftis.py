"""Raftis test suite: a raft-replicated redis register driven with
read/write ops over RESP (reference:
raftis/src/jepsen/raftis.clj:1-138).

Pieces, mirroring the reference:
  - RaftisDB     — archive install + daemon with an initial-cluster
                   string "host:8901,..." (raftis.clj:61-105)
  - RaftisClient — GET/SET on key "r" with the reference's error
                   taxonomy (raftis.clj:36-57): reads always :fail;
                   "no leader" and "socket closed" writes :fail (the
                   write was rejected/never sent); other write errors
                   and timeouts :info
  - raftis_test  — register workload, partition nemesis, linearizable
                   checker (raftis.clj:107-130)

The port's copy of `jepsen_tpu/dbs/raftis.py`. Its checker is
`linearizable` on the one unkeyed register history, which `auto` routes
to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries) or K5
(`ops/csrc/wgl_row.cu`), or to the native search below the committed
bars; the test map's `device` (the CLI's `--device`; None = the card)
goes to that checker. `redis_sim.local_test_fn` runs the suite on
simulated nodes over `LocalRemote`.
"""

from __future__ import annotations

import itertools
import logging
import random
import socket

from .. import checker as checker_mod
from .. import cli, client, generator as gen, models, osdist
from .. import reconnect
from ..history import Op
from . import redis_proto
from .common import ArchiveDB, SuiteCfg, resp_ping_ready
from . import common as cmn

log = logging.getLogger("jepsen_tpu_torch.dbs.raftis")

PORT = 6379
RAFT_PORT = 8901
KEY = "r"


_suite = SuiteCfg("raftis", PORT, "/opt/raftis")
node_host = _suite.host
node_port = _suite.port


def initial_cluster(test) -> str:
    """host:8901,host:8901,... (raftis.clj:68-74)."""
    return ",".join(
        f"{node_host(test, n)}:{RAFT_PORT}" for n in test["nodes"]
    )


class RaftisDB(ArchiveDB):
    binary = "raftis"
    log_name = "raftis.log"
    pid_name = "raftis.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 30.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        return ["--port", str(node_port(test, node)),
                "--cluster", initial_cluster(test)]

    def probe_ready(self, test, node) -> bool:
        return resp_ping_ready(_suite, test, node)


class RaftisClient(client.Client):
    """GET/SET register with raftis.clj:44-57's taxonomy. The RESP
    connection lives behind a reconnect wrapper: after a timeout the
    server's late reply would otherwise sit in the buffer and
    desynchronize every later op's reply (off-by-one histories), so any
    exception drops the connection and the next op gets a fresh one."""

    def __init__(self, conn=None, timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        wrapped = reconnect.wrapper(
            open=lambda: redis_proto.RespConn(
                node_host(test, node), node_port(test, node),
                timeout=self.timeout),
            close=lambda c: c.close(),
            name=f"raftis {node}",
        ).open()
        return RaftisClient(wrapped, timeout=self.timeout)

    def invoke(self, test, op: Op) -> Op:
        try:
            with self.conn.with_conn() as c:
                if op.f == "read":
                    raw = c.call("GET", KEY)
                    value = int(raw) if raw is not None else None
                    return op.with_(type="ok", value=value)
                if op.f == "write":
                    c.call("SET", KEY, op.value)
                    return op.with_(type="ok")
                raise ValueError(f"unknown op {op.f!r}")
        except redis_proto.RespError as e:
            # "no leader" means the write was rejected — definite fail
            # (raftis.clj:46-49)
            if op.f == "read" or "no leader" in str(e):
                return op.with_(type="fail", error=str(e))
            return op.with_(type="info", error=str(e))
        except (socket.timeout, TimeoutError):
            return op.with_(
                type="fail" if op.f == "read" else "info", error="timeout")
        except ConnectionError as e:
            # socket closed: the reference treats this as :fail too
            return op.with_(type="fail", error=str(e))
        except OSError as e:
            return op.with_(
                type="fail" if op.f == "read" else "info", error=str(e))

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def raftis_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = RaftisDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": "raftis",
            "os": osdist.debian,
            "db": db_,
            "client": RaftisClient(),
            "nemesis": cmn.pick_nemesis(db_, opts),
            "model": models.Register(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "timeline": checker_mod.timeline_html(),
                "linear": checker_mod.linearizable(
                    device=opts.get("device")),
            }),
            "generator": gen.time_limit(
                opts.get("time_limit", 60),
                gen.nemesis(
                    gen.seq(itertools.cycle([
                        gen.sleep(5),
                        {"type": "info", "f": "start"},
                        gen.sleep(5),
                        {"type": "info", "f": "stop"},
                    ])),
                    gen.stagger(1 / 10, gen.mix([r, w])),
                ),
            ),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--archive-url", dest="archive_url", default=None,
                   help="raftis release archive (or the in-repo sim "
                        "archive for hermetic runs).")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(raftis_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
