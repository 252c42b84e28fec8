"""ZooKeeper test suite: a single linearizable CAS register stored in a
znode (reference: zookeeper/src/jepsen/zookeeper.clj).

Pieces, mirroring the reference:
  - zk_node_ids / zoo_cfg_servers — ensemble config (zookeeper.clj:19-38)
  - ZookeeperDB   — debian-package install + myid/zoo.cfg + service
                    restart (zookeeper.clj:40-72); an archive mode runs
                    the in-repo jute simulator through the same daemon
                    machinery for hermetic tests
  - ZkAtomClient  — the avout zk-atom analog (zookeeper.clj:78-104):
                    read = getData, write = setData, cas = optimistic
                    version-CAS retry loop; every op is wrapped in a
                    5 s timeout completing as :info :timeout
                    (zookeeper.clj:92)
  - zk_test(opts) — test map (zookeeper.clj:106-131)
  - main()        — CLI entry (zookeeper.clj:133-139)

The port's copy of `jepsen_tpu/dbs/zookeeper.py`. Its checker is
`linearizable` on the one unkeyed CAS-register history, which `auto`
routes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries) or K5
(`ops/csrc/wgl_row.cu`), or to the native search below the committed
bars; the test map's `device` (the CLI's `--device`; None = the card)
goes to that checker. `zk_sim.local_test_fn` runs the suite on
simulated nodes over `LocalRemote`.
"""

from __future__ import annotations

import itertools
import logging
import random
import socket
import time

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, db, generator as gen, models, osdist
from ..control import util as cu
from ..history import Op
from . import zk_proto

log = logging.getLogger("jepsen_tpu_torch.dbs.zookeeper")

CLIENT_PORT = 2181
ZNODE = "/jepsen"
VERSION = "3.4.5+dfsg-2"

ZOO_CFG_BASE = """tickTime=2000
initLimit=10
syncLimit=5
dataDir=/var/lib/zookeeper
clientPort=2181
"""


def _cfg(test) -> dict:
    return test.get("zk") or {}


def zk_node_ids(test) -> dict:
    """Node name -> numeric id (zookeeper.clj:19-25)."""
    return {node: i for i, node in enumerate(test["nodes"])}


def zk_node_id(test, node) -> int:
    return zk_node_ids(test)[node]


def zoo_cfg_servers(test) -> str:
    """server.N=host:2888:3888 lines (zookeeper.clj:32-38)."""
    return "\n".join(
        f"server.{i}={node}:2888:3888"
        for node, i in zk_node_ids(test).items()
    )


def node_host(test, node) -> str:
    fn = _cfg(test).get("addr_fn")
    return fn(node) if fn else str(node)


def client_port(test, node) -> int:
    ports = _cfg(test).get("client_ports")
    return ports[node] if ports else CLIENT_PORT


def ruok(test, node, timeout: float = 2.0) -> bool:
    """The `ruok` four-letter health word."""
    try:
        with socket.create_connection(
            (node_host(test, node), client_port(test, node)), timeout=timeout
        ) as s:
            s.sendall(b"ruok")
            s.settimeout(timeout)
            buf = b""
            while len(buf) < 4:  # TCP may fragment even 4 bytes
                chunk = s.recv(4 - len(buf))
                if not chunk:
                    return False
                buf += chunk
            return buf == b"imok"
    except OSError:
        return False


class ZookeeperDB(db.DB, db.LogFiles):
    """Debian-packaged ZooKeeper (zookeeper.clj:40-72). With
    archive_url set, installs an archive and runs its `zkserver` binary
    through start_daemon instead — the hermetic-simulator path."""

    def __init__(self, version: str = VERSION, archive_url: str | None = None,
                 ready_timeout: float = 30.0):
        self.version = version
        self.archive_url = archive_url
        self.ready_timeout = ready_timeout

    # -- packaged mode (reference parity) --------------------------------
    def _setup_packaged(self, test, node) -> None:
        remote = test["remote"]
        log.info("%s installing ZK %s", node, self.version)
        osdist.install(remote, node, {
            "zookeeper": self.version,
            "zookeeper-bin": self.version,
            "zookeeperd": self.version,
        })
        remote.exec(
            node,
            f"echo {zk_node_id(test, node)} > /etc/zookeeper/conf/myid",
            sudo=True,
        )
        cfg = ZOO_CFG_BASE + "\n" + zoo_cfg_servers(test) + "\n"
        remote.exec(node, ["tee", "/etc/zookeeper/conf/zoo.cfg"],
                    stdin=cfg, sudo=True)
        log.info("%s ZK restarting", node)
        remote.exec(node, ["service", "zookeeper", "restart"], sudo=True)

    def _teardown_packaged(self, test, node) -> None:
        remote = test["remote"]
        remote.exec(node, ["service", "zookeeper", "stop"], sudo=True,
                    check=False)
        remote.exec(node, "rm -rf /var/lib/zookeeper/version-* "
                          "/var/log/zookeeper/*", sudo=True, check=False)

    # -- archive/simulator mode ------------------------------------------
    def _dir(self, test, node) -> str:
        d = _cfg(test).get("dir", "/opt/zookeeper")
        return d(node) if callable(d) else d

    def _setup_archive(self, test, node) -> None:
        remote = test["remote"]
        d = self._dir(test, node)
        sudo = _cfg(test).get("sudo", True)
        cu.install_archive(remote, node, self.archive_url, d, sudo=sudo)
        cu.start_daemon(
            remote, node, f"{d}/zkserver",
            "--port", str(client_port(test, node)),
            "--name", str(node),
            logfile=f"{d}/zookeeper.log",
            pidfile=f"{d}/zookeeper.pid",
            chdir=d,
        )

    def _teardown_archive(self, test, node) -> None:
        remote = test["remote"]
        d = self._dir(test, node)
        cu.stop_daemon(remote, node, f"{d}/zookeeper.pid")
        remote.exec(node, ["rm", "-rf", d],
                    sudo=_cfg(test).get("sudo", True), check=False)

    # ---------------------------------------------------------------------
    def setup(self, test, node) -> None:
        if self.archive_url:
            self._setup_archive(test, node)
        else:
            self._setup_packaged(test, node)
        self.await_ready(test, node)

    def await_ready(self, test, node) -> None:
        deadline = time.monotonic() + self.ready_timeout
        while not ruok(test, node):
            if time.monotonic() > deadline:
                raise db.SetupFailed(f"zookeeper on {node} never said imok")
            time.sleep(0.2)
        log.info("%s ZK ready", node)

    def teardown(self, test, node) -> None:
        log.info("%s tearing down ZK", node)
        if self.archive_url:
            self._teardown_archive(test, node)
        else:
            self._teardown_packaged(test, node)

    def log_files(self, test, node) -> list:
        if self.archive_url:
            return [f"{self._dir(test, node)}/zookeeper.log"]
        return ["/var/log/zookeeper/zookeeper.log"]


class ZkAtomClient(client.Client):
    """The avout zk-atom analog: an integer register at ZNODE
    (zookeeper.clj:78-104). Reads getData; writes setData (blind);
    cas does the optimistic read-then-setData(version) loop — a
    BadVersion race retries, value mismatch is a definite :fail.
    Any timeout or connection error completes :info :timeout, exactly
    like the reference's (timeout 5000 (assoc op :type :info ...))."""

    CAS_RETRIES = 16

    def __init__(self, conn: zk_proto.ZkConn | None = None,
                 timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        conn = zk_proto.ZkConn(
            node_host(test, node), client_port(test, node),
            timeout=self.timeout,
        )
        return ZkAtomClient(conn, timeout=self.timeout)

    def setup(self, test):
        """Create the register znode with initial value 0 (the
        reference's (avout/zk-atom conn "/jepsen" 0))."""
        try:
            self.conn.create(ZNODE, b"0")
        except zk_proto.NodeExists:
            pass

    def invoke(self, test, op: Op) -> Op:
        # Overall op deadline, like the reference's (timeout 5000 ...)
        # wrapper around the whole invoke (zookeeper.clj:92): a cas
        # retry loop may not keep a worker busy past self.timeout even
        # when each socket call individually stays under its limit.
        deadline = time.monotonic() + self.timeout
        try:
            if op.f == "read":
                data, _ = self.conn.get_data(ZNODE)
                return op.with_(type="ok", value=int(data))
            if op.f == "write":
                self.conn.set_data(ZNODE, str(op.value).encode(), -1)
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                for _ in range(self.CAS_RETRIES):
                    if time.monotonic() > deadline:
                        return op.with_(type="info", error="timeout")
                    data, stat = self.conn.get_data(ZNODE)
                    if int(data) != old:
                        return op.with_(type="fail")
                    try:
                        self.conn.set_data(ZNODE, str(new).encode(),
                                           stat["version"])
                        return op.with_(type="ok")
                    except zk_proto.BadVersion:
                        continue  # raced; nothing written, try again
                return op.with_(type="fail", error="cas-retries-exhausted")
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            return op.with_(type="info", error="timeout")
        except (ConnectionError, OSError) as e:
            return op.with_(type="info", error=str(e))
        except zk_proto.ZkError as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn is not None:
            self.conn.close()


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def zk_test(opts: dict) -> dict:
    """Test map (zookeeper.clj:106-131): mixed r/w/cas staggered 1 s,
    partition nemesis 5 s on / 5 s off, cas-register(0) model, perf +
    linearizable checkers."""
    from ..testlib import noop_test

    db_ = ZookeeperDB(opts.get("version", VERSION),
                      archive_url=opts.get("archive_url"))
    test = noop_test()
    # The reference merges opts BEFORE the suite map (zookeeper.clj:115)
    # so suite settings win; we keep the same precedence.
    test.update(opts)
    test.update(
        {
            "name": "zookeeper",
            "os": osdist.debian,
            "db": db_,
            "client": ZkAtomClient(),
            "nemesis": cmn.pick_nemesis(db_, opts),
            "model": models.CASRegister(0),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "linear": checker_mod.linearizable(
                    device=opts.get("device")),
            }),
            "generator": gen.time_limit(
                opts.get("time_limit", 15),
                gen.nemesis(
                    gen.seq(itertools.cycle([
                        gen.sleep(5),
                        {"type": "info", "f": "start"},
                        gen.sleep(5),
                        {"type": "info", "f": "stop"},
                    ])),
                    gen.stagger(1, gen.mix([r, w, cas])),
                ),
            ),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p, names=cmn.PARTITION_NEMESIS_NAMES)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(zk_test, opt_spec=_opt_spec),
         **cli.serve_cmd()}, argv)


if __name__ == "__main__":
    main()
