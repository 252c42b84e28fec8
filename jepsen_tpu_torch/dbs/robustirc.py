"""RobustIRC test suite: TOPIC messages as a grow-only set over the
raft-replicated IRC network (reference:
robustirc/src/jepsen/robustirc.clj:1-217).

Each client opens a RobustSession, registers (NICK/USER/JOIN), adds
integers by setting the channel topic ("TOPIC #jepsen :<n>",
robustirc.clj:163-176), and the final read extracts every topic value
seen in the message log; the set checker demands every acknowledged add
appear (robustirc.clj:195-211).

The port's copy of `jepsen_tpu/dbs/robustirc.py`: the set checker runs
on the host and the suite reaches no kernel. `robustirc_sim.
local_test_fn` runs the suite on simulated nodes over `LocalRemote`."""

from __future__ import annotations

import itertools
import json
import logging
import socket
import urllib.error
import urllib.request

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, generator as gen, osdist
from ..history import Op
from .common import ArchiveDB, SuiteCfg, ready_gated_final

log = logging.getLogger("jepsen_tpu_torch.dbs.robustirc")

PORT = 13001
CHANNEL = "#jepsen"


_suite = SuiteCfg("robustirc", PORT, "/opt/robustirc")
node_host = _suite.host
node_port = _suite.port


class RobustIrcDB(ArchiveDB):
    binary = "robustirc"
    log_name = "robustirc.log"
    pid_name = "robustirc.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        primary = test["nodes"][0]
        args = ["--port", str(node_port(test, node)),
                "-network_name", "jepsen"]
        if node != primary:
            args += ["-peer_addr",
                     f"{node_host(test, primary)}:"
                     f"{node_port(test, primary)}"]
        return args

    def probe_ready(self, test, node) -> bool:
        # a session create answering at all means raft is up
        try:
            RobustSession(test, node, timeout=2.0)
            return True
        except (urllib.error.URLError, OSError):
            return False


class RobustSession:
    """One RobustSession (robustirc.clj:102-135)."""

    def __init__(self, test, node, timeout: float = 5.0):
        self.base = (f"http://{node_host(test, node)}:"
                     f"{node_port(test, node)}/robustirc/v1")
        self.timeout = timeout
        self._msg_ids = itertools.count(1)
        body = self._request("POST", "/session")
        self.session_id = body["Sessionid"]
        self.session_auth = body["Sessionauth"]

    def _request(self, method: str, path: str, body=None,
                 auth: bool = False):
        data = json.dumps(body).encode() if body is not None else b""
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if auth:
            req.add_header("X-Session-Auth", self.session_auth)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            payload = resp.read()
            return json.loads(payload) if payload else {}

    def post_message(self, irc_line: str) -> None:
        self._request("POST", f"/{self.session_id}/message",
                      body={"Data": irc_line,
                            "ClientMessageId": next(self._msg_ids)},
                      auth=True)

    def read_all(self) -> list:
        return self._request("GET", f"/{self.session_id}/messages",
                             auth=True)


def filter_topic(msg: dict) -> bool:
    """Raw client lines start with TOPIC; server-echoed lines carry a
    :prefix first (robustirc.clj:138-143's 'use a proper IRC parser'
    caveat applies here too)."""
    parts = (msg.get("Data") or "").split(" ")
    return bool(parts) and (
        parts[0] == "TOPIC"
        or (len(parts) > 1 and parts[1] == "TOPIC"))


def extract_topic(msg: dict) -> int | None:
    try:
        return int((msg.get("Data") or "").rsplit(":", 1)[-1])
    except ValueError:
        return None


class SetClient(client.Client):
    """TOPIC-set client (robustirc.clj:150-182): adds are
    acknowledged-or-failed topic changes; the read collects every topic
    value in the log. An add whose POST errors is :info — the message
    may have been committed by raft anyway."""

    def __init__(self, session: RobustSession | None = None):
        self.session = session

    def open(self, test, node):
        session = RobustSession(test, node)
        session.post_message(f"NICK {node}")
        session.post_message("USER j j j j")
        session.post_message(f"JOIN {CHANNEL}")
        return SetClient(session)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                self.session.post_message(
                    f"TOPIC {CHANNEL} :{op.value}")
                return op.with_(type="ok")
            if op.f == "read":
                msgs = self.session.read_all()
                values = sorted({
                    v for v in (extract_topic(m) for m in msgs
                                if filter_topic(m))
                    if v is not None
                })
                return op.with_(type="ok", value=values)
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error="timeout")
        except (urllib.error.URLError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))


def robustirc_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = RobustIrcDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": "robustirc set",
            "os": osdist.debian,
            "db": db_,
            "client": SetClient(),
            "nemesis": cmn.pick_nemesis(db_, opts),
            "generator": gen.phases(
                gen.time_limit(
                    opts.get("time_limit", 60),
                    gen.nemesis(
                        gen.start_stop(10, 10),
                        gen.stagger(
                            opts.get("stagger", 0.1),
                            gen.seq({"type": "invoke", "f": "add",
                                     "value": x}
                                    for x in itertools.count())),
                    ),
                ),
                gen.nemesis(gen.once({"type": "info", "f": "stop"})),
                gen.sleep(opts.get("quiesce", 10)),
                ready_gated_final(
                    db_,
                    gen.clients(gen.each(
                        lambda: gen.once(
                            {"type": "invoke", "f": "read"}))),
                    opts),
            ),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "set": checker_mod.set_checker(),
            }),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--archive-url", dest="archive_url", default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(robustirc_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
