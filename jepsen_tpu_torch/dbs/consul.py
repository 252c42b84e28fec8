"""Consul test suite: a CAS register in one /v1/kv key (reference:
consul/src/jepsen/consul.clj:1-146).

Pieces, mirroring the reference:
  - ConsulDB     — agent lifecycle: primary bootstraps, the rest join it
                   (consul.clj:22-57); archive mode runs the in-repo sim
                   through the same daemon machinery
  - ConsulKV     — HTTP /v1/kv connection: base64 values,
                   X-Consul-Index, ?cas=<ModifyIndex> check-and-set
                   (consul.clj:66-109)
  - CASClient    — JSON-encoded register with the reference's
                   determinacy taxonomy: reads always :fail on error
                   ("we can always pretend they didn't happen",
                   consul.clj:121-125); writes/cas crash to :info
  - consul_test  — test map; main() — CLI entry

The port's copy of `jepsen_tpu/dbs/consul.py`. Its checker is
`linearizable` on the one unkeyed register history, which `auto` routes
to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries) or K5
(`ops/csrc/wgl_row.cu`), or to the native search below the committed
bars; the test map's `device` (the CLI's `--device`; None = the card)
goes to that checker. `consul_sim.local_test_fn` runs the suite on
simulated agents over `LocalRemote`.
"""

from __future__ import annotations

import base64
import itertools
import json
import logging
import random
import socket
import urllib.error
import urllib.parse
import urllib.request

from .. import checker as checker_mod
from .. import cli, client, generator as gen, models, osdist
from ..history import Op
from .common import ArchiveDB, SuiteCfg
from . import common as cmn

log = logging.getLogger("jepsen_tpu_torch.dbs.consul")

PORT = 8500
KEY = "jepsen"


_suite = SuiteCfg("consul", PORT, "/opt/consul")
node_host = _suite.host
node_port = _suite.port


class ConsulDB(ArchiveDB):
    """Consul agent per node (consul.clj:22-57): the first node runs
    -bootstrap, the rest -join it."""

    binary = "consul"
    log_name = "consul.log"
    pid_name = "consul.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 30.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        primary = test["nodes"][0]
        extra = (["-bootstrap"] if node == primary
                 else ["-join", node_host(test, primary)])
        # data_dir() is the single source of truth — the faultfs FUSE
        # layer mounts over exactly this path
        return ["agent", "-server", "-node", str(node),
                "-data-dir", data_dir(test, node), "-client", "0.0.0.0",
                "-http-port", str(node_port(test, node)), *extra]

    def probe_ready(self, test, node) -> bool:
        url = (f"http://{node_host(test, node)}:{node_port(test, node)}"
               "/v1/status/leader")
        with urllib.request.urlopen(url, timeout=2) as resp:
            return resp.status == 200 and resp.read().strip() != b'""' 


class ConsulKV:
    """One node's /v1/kv endpoint (consul.clj:94-109)."""

    def __init__(self, host: str, port: int, key: str = KEY,
                 timeout: float = 5.0):
        self.base = f"http://{host}:{port}/v1/kv/{key}"
        self.timeout = timeout

    def _request(self, method: str, url: str, data: bytes | None = None):
        req = urllib.request.Request(url, data=data, method=method)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def get(self):
        """(value-bytes | None, modify-index)."""
        try:
            with self._request("GET", self.base) as resp:
                body = json.load(resp)[0]
                return (base64.b64decode(body["Value"]),
                        int(body["ModifyIndex"]))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None, 0
            raise

    def put(self, value: bytes) -> bool:
        with self._request("PUT", self.base, data=value) as resp:
            return resp.read().strip() == b"true"

    def cas(self, value: bytes, new_value: bytes) -> bool:
        """Index-based CAS: read, compare the payload, then PUT with
        ?cas=<ModifyIndex> (consul.clj:100-109)."""
        cur, index = self.get()
        if cur != value:
            return False
        url = f"{self.base}?cas={index}"
        with self._request("PUT", url, data=new_value) as resp:
            return resp.read().strip() == b"true"


class CASClient(client.Client):
    """JSON-encoded CAS register (consul.clj:111-141). Reads :fail on
    any error; writes and cas crash to :info on indeterminate errors."""

    def __init__(self, conn: ConsulKV | None = None, timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        return CASClient(
            ConsulKV(node_host(test, node), node_port(test, node),
                     timeout=self.timeout),
            timeout=self.timeout,
        )

    def setup(self, test):
        try:
            self.conn.put(json.dumps(None).encode())
        except OSError:
            pass  # another client may already have seeded the key

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                cur, _ = self.conn.get()
                value = json.loads(cur) if cur else None
                return op.with_(type="ok", value=value)
            if op.f == "write":
                self.conn.put(json.dumps(op.value).encode())
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                ok = self.conn.cas(json.dumps(old).encode(),
                                   json.dumps(new).encode())
                return op.with_(type="ok" if ok else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            return op.with_(type=crash, error="timeout")
        except (urllib.error.URLError, OSError) as e:
            return op.with_(type=crash, error=str(e))


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def data_dir(test, node) -> str:
    """The agent's -data-dir (daemon_args passes {dir}/data)."""
    return f"{_suite.dir(test, node)}/data"


def consul_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = ConsulDB(archive_url=opts.get("archive_url"))
    # consul is a statically linked Go binary: the charybdefs-analog
    # fault modes need the FUSE backend (cmn.fsfault_wiring)
    db_, nemesis_ = cmn.fsfault_wiring(db_, opts, data_dir)
    if nemesis_ is None:
        nemesis_ = cmn.pick_nemesis(db_, opts)
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": "consul",
            "os": osdist.debian,
            "db": db_,
            "client": CASClient(),
            "nemesis": nemesis_,
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
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
                    gen.stagger(1 / 10, gen.mix([r, w, cas])),
                ),
            ),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p, names=cmn.NEMESIS_NAMES
                    + cmn.FSFAULT_NEMESIS_NAMES)
    p.add_argument("--archive-url", dest="archive_url", default=None,
                   help="consul release archive (or the in-repo sim "
                        "archive for hermetic runs).")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(consul_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
