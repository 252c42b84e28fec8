"""LogCabin test suite: a CAS register in the replicated tree, driven
through the ON-NODE `treeops` client binary over the control plane —
the reference's exact access path (reference:
logcabin/src/jepsen/logcabin.clj:163-244: every op is
`c/exec treeops -c <servers> ...` over SSH; LogCabin's RPC has no
standalone wire spec to speak directly).

Ops (logcabin.clj:212-241): read = `treeops read <path>` parsed as
JSON; write = value piped to `treeops write`; cas = conditional write
with `-p <path>:<old>` — the CLI's "CAS failed" error is a definite
:fail, its timeout message a :fail :timed-out.

The port's copy of `jepsen_tpu/dbs/logcabin.py`. Its checker is
`linearizable` on the one unkeyed CAS-register history, which `auto`
routes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries) or K5
(`ops/csrc/wgl_row.cu`), or to the native search below the committed
bars; the test map's `device` (the CLI's `--device`; None = the card)
goes to that checker. `logcabin_sim.local_test_fn` runs the suite on
simulated nodes over `LocalRemote`."""

from __future__ import annotations

import json
import logging
import random

from .. import checker as checker_mod
from .. import cli, client, generator as gen, models, osdist
from ..control import RemoteError
from ..history import Op
from .common import ArchiveDB, SuiteCfg, once, shared_flag
from . import common as cmn

log = logging.getLogger("jepsen_tpu_torch.dbs.logcabin")

PORT = 5254
PATH = "/jepsen"
OP_TIMEOUT = 5


_suite = SuiteCfg("logcabin", PORT, "/opt/logcabin")
node_host = _suite.host
node_port = _suite.port


def server_addrs(test) -> str:
    """host:port,host:port,... (logcabin.clj:52-63)."""
    return ",".join(
        f"{node_host(test, n)}:{node_port(test, n)}"
        for n in test["nodes"]
    )


class LogCabinDB(ArchiveDB):
    """logcabind per node; the first node bootstraps the cluster
    (logcabin.clj:78-100)."""

    binary = "logcabind"
    log_name = "logcabin.log"
    pid_name = "logcabin.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 30.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        args = ["--port", str(node_port(test, node))]
        if node == test["nodes"][0]:
            args.append("--bootstrap")
        return args

    def probe_ready(self, test, node) -> bool:
        import socket

        with socket.create_connection(
            (node_host(test, node), node_port(test, node)), timeout=2
        ):
            return True


def treeops(test, node, *args, stdin=None):
    """Run the on-node treeops client (logcabin.clj:163-210)."""
    d = _suite.dir(test, node)
    return test["remote"].exec(
        node,
        [f"{d}/treeops", "-c", server_addrs(test), "-q",
         "-t", str(OP_TIMEOUT), *args],
        stdin=stdin,
        timeout=OP_TIMEOUT * 4,
    )


class CASClient(client.Client):
    """JSON-encoded register at PATH (logcabin.clj:212-244)."""

    def __init__(self, node=None, flag=None):
        self.node = node
        self.flag = flag or shared_flag()

    def open(self, test, node):
        me = CASClient(node, self.flag)
        once(self.flag, lambda: treeops(
            test, node, "write", PATH, stdin=json.dumps(None)))
        return me

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                out = treeops(test, self.node, "read", PATH).out
                return op.with_(type="ok", value=json.loads(out))
            if op.f == "write":
                treeops(test, self.node, "write", PATH,
                        stdin=json.dumps(op.value))
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                r = test["remote"].exec(
                    self.node,
                    [f"{_suite.dir(test, self.node)}/treeops",
                     "-c", server_addrs(test), "-q",
                     "-t", str(OP_TIMEOUT),
                     "-p", f"{PATH}:{json.dumps(old)}",
                     "write", PATH],
                    stdin=json.dumps(new),
                    timeout=OP_TIMEOUT * 4,
                    check=False,
                )
                if r.ok:
                    return op.with_(type="ok")
                if "CAS failed" in (r.err or r.out):
                    return op.with_(type="fail")
                return op.with_(type="info", error=r.err or r.out)
            raise ValueError(f"unknown op {op.f!r}")
        except RemoteError as e:
            msg = str(e)
            if "timed out" in msg.lower() or "timeout" in msg.lower():
                return op.with_(
                    type="fail" if op.f == "read" else "info",
                    error="timed-out")
            return op.with_(
                type="fail" if op.f == "read" else "info", error=msg)
        except (json.JSONDecodeError, ValueError) as e:
            return op.with_(type="fail", error=str(e))


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def logcabin_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = LogCabinDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": "logcabin",
            "os": osdist.debian,
            "db": db_,
            "client": CASClient(),
            "nemesis": cmn.pick_nemesis(db_, opts),
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "linear": checker_mod.linearizable(
                    device=opts.get("device")),
            }),
            "generator": gen.time_limit(
                opts.get("time_limit", 60),
                gen.nemesis(
                    gen.start_stop(10, 10),
                    gen.stagger(opts.get("stagger", 0.2),
                                gen.mix([r, w, cas])),
                ),
            ),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--archive-url", dest="archive_url", default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(logcabin_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
