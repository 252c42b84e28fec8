"""etcd test suite: CAS-register linearizability over independent keys
(reference: etcd/src/jepsen/etcd.clj:1-188).

Pieces, mirroring the reference:
  - EtcdDB          — archive install + daemon lifecycle (etcd.clj:51-86)
  - EtcdClient      — HTTP v2-API client with the exception-determinacy
                      taxonomy: reads may :fail on timeout, writes/cas
                      must :info (etcd.clj:103,120-136)
  - r/w/cas         — op generators (etcd.clj:145-147)
  - etcd_test(opts) — the test-map constructor (etcd.clj:149-181)
  - main()          — CLI entry (etcd.clj:183-188)

Cluster addressing is configurable through an "etcd" sub-map in the test
map (dir, ports, addr_fn, archive url, sudo) so the same code paths run
against a real 5-node cluster over SSH or against the in-repo simulator
on one machine (dbs/etcd_sim.py).

The port's copy of `jepsen_tpu/dbs/etcd.py`. Its checker reaches the
card: each key's history is one `Linearizable.check`, which `auto`
routes to K1 (`ops/csrc/wgl_vec.cu`) or K5 (`ops/csrc/wgl_row.cu`), or
to the native search below the bars (`linearizable.card_bar`). The
test map's `device` (the CLI's `--device`; None = the card) goes to
that checker, and core.run resolves it before the cluster is
provisioned. The fault packages (`--nemesis` fault families,
`--nemesis-schedule`) come from `nemesis/combined.py` and the fs-break
modes from `nemesis/fsfault.py`. `opts["set_time_fn"]` replaces the
clock family's setter (`nemesis.set_time`, which sets the node's real
clock), as the simulated cluster's recipe (`etcd_sim.local_test_fn`)
does.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import socket
import time
import urllib.error
import urllib.parse
import urllib.request

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, db, generator as gen, independent, models
from ..control import util as cu
from ..history import Op
from .. import osdist

log = logging.getLogger("jepsen_tpu_torch.dbs.etcd")

DIR = "/opt/etcd"
BINARY = "etcd"
CLIENT_PORT = 2379
PEER_PORT = 2380
VERSION = "v3.1.5"


# ---------------------------------------------------------------------------
# Addressing (etcd.clj:27-48)

def _cfg(test) -> dict:
    return test.get("etcd") or {}


def node_host(test, node) -> str:
    fn = _cfg(test).get("addr_fn")
    return fn(node) if fn else str(node)


def client_port(test, node) -> int:
    ports = _cfg(test).get("client_ports")
    return ports[node] if ports else CLIENT_PORT


def peer_port(test, node) -> int:
    ports = _cfg(test).get("peer_ports")
    return ports[node] if ports else PEER_PORT


def client_url(test, node) -> str:
    return f"http://{node_host(test, node)}:{client_port(test, node)}"


def peer_url(test, node) -> str:
    return f"http://{node_host(test, node)}:{peer_port(test, node)}"


def initial_cluster(test) -> str:
    """\"n1=http://n1:2380,n2=...\" (etcd.clj:42-48)."""
    return ",".join(
        f"{node}={peer_url(test, node)}" for node in test["nodes"]
    )


def node_dir(test, node) -> str:
    d = _cfg(test).get("dir", DIR)
    return d(node) if callable(d) else d


# ---------------------------------------------------------------------------
# DB (etcd.clj:51-86)

class EtcdDB(db.DB, db.Kill, db.Pause, db.LogFiles):
    """Installs and runs one etcd member per node. Implements the
    Kill/Pause process protocols over the daemon pidfile, so the
    kill/pause nemesis packages work against both real clusters and
    the in-repo simulator (which runs as a genuine subprocess)."""

    def __init__(self, version: str = VERSION, url: str | None = None,
                 ready_timeout: float = 30.0):
        self.version = version
        self.url = url
        self.ready_timeout = ready_timeout

    def archive_url(self) -> str:
        return self.url or (
            "https://storage.googleapis.com/etcd/" + self.version
            + "/etcd-" + self.version + "-linux-amd64.tar.gz"
        )

    def setup(self, test, node) -> None:
        self.install(test, node)
        self.start(test, node)

    def install(self, test, node) -> None:
        """Fetch + unpack only — split from start so interposers (the
        faultfs FUSE layer) can mount over the data dir BETWEEN
        install's tree wipe and the daemon opening its files."""
        remote = test["remote"]
        d = node_dir(test, node)
        sudo = _cfg(test).get("sudo", True)
        log.info("%s installing etcd %s", node, self.version)
        cu.install_archive(remote, node, self.archive_url(), d, sudo=sudo)

    def start(self, test, node) -> None:
        remote = test["remote"]
        d = node_dir(test, node)
        cu.start_daemon(
            remote, node, f"{d}/{BINARY}",
            "--name", str(node),
            "--listen-peer-urls", peer_url(test, node),
            "--listen-client-urls", client_url(test, node),
            "--advertise-client-urls", client_url(test, node),
            "--initial-cluster-state", "new",
            "--initial-advertise-peer-urls", peer_url(test, node),
            "--initial-cluster", initial_cluster(test),
            "--log-output", "stdout",
            logfile=f"{d}/etcd.log",
            pidfile=f"{d}/etcd.pid",
            chdir=d,
        )
        self.await_ready(test, node)

    def await_ready(self, test, node) -> None:
        """Poll /version until the member answers (replaces the
        reference's blind 5 s sleep, etcd.clj:76)."""
        deadline = time.monotonic() + self.ready_timeout
        url = client_url(test, node) + "/version"
        while True:
            try:
                with urllib.request.urlopen(url, timeout=2) as resp:
                    if resp.status == 200:
                        return
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise db.SetupFailed(f"etcd on {node} never became ready")
            time.sleep(0.2)

    # -- db.Kill / db.Pause (start(test, node) above doubles as the
    #    Kill revival path; it re-runs start_daemon, which is a no-op
    #    when the pidfile still points at a live process)

    def _pidfile(self, test, node) -> str:
        return f"{node_dir(test, node)}/etcd.pid"

    def kill(self, test, node) -> None:
        cu.stop_daemon(test["remote"], node, self._pidfile(test, node))

    def _signal(self, test, node, sig: str) -> None:
        r = test["remote"].exec(node, ["cat", self._pidfile(test, node)],
                                check=False)
        pid = (r.out or "").strip()
        if pid:
            test["remote"].exec(node, ["kill", f"-{sig}", pid], check=False)

    def pause(self, test, node) -> None:
        self._signal(test, node, "STOP")

    def resume(self, test, node) -> None:
        self._signal(test, node, "CONT")

    def alive(self, test, node):
        return cu.daemon_running(test["remote"], node,
                                 self._pidfile(test, node))

    def teardown(self, test, node) -> None:
        remote = test["remote"]
        d = node_dir(test, node)
        log.info("%s tearing down etcd", node)
        cu.stop_daemon(remote, node, f"{d}/etcd.pid")
        remote.exec(node, ["rm", "-rf", d],
                    sudo=_cfg(test).get("sudo", True), check=False)

    def log_files(self, test, node) -> list:
        return [f"{node_dir(test, node)}/etcd.log"]


# ---------------------------------------------------------------------------
# Client (etcd.clj:96-143)

class EtcdError(Exception):
    def __init__(self, code: int | None, message: str):
        super().__init__(message)
        self.code = code


class EtcdHTTP:
    """Minimal etcd v2 keys-API connection (one base URL, per-request
    sockets — like verschlimmbesserung, no persistent state)."""

    def __init__(self, base_url: str, timeout: float = 5.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _request(self, method: str, key, form: dict | None = None,
                 query: dict | None = None) -> dict:
        url = f"{self.base_url}/v2/keys/{urllib.parse.quote(str(key))}"
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = urllib.parse.urlencode(form).encode() if form else None
        req = urllib.request.Request(url, data=data, method=method)
        if data:
            req.add_header("Content-Type", "application/x-www-form-urlencoded")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as e:
            try:
                body = json.load(e)
            except (json.JSONDecodeError, ValueError):
                raise EtcdError(None, f"HTTP {e.code}") from e
            raise EtcdError(body.get("errorCode"),
                            body.get("message", "")) from e

    def get(self, key, quorum: bool = False):
        """Value string, or None if absent (v/get semantics).
        quorum=True requests a linearizable read."""
        try:
            q = {"quorum": "true"} if quorum else None
            return self._request("GET", key, query=q)["node"]["value"]
        except EtcdError as e:
            if e.code == 100:
                return None
            raise

    def put(self, key, value) -> None:
        self._request("PUT", key, {"value": str(value)})

    def cas(self, key, old, new) -> bool:
        """Compare-and-swap with prevExist; False on compare failure
        (v/cas! {:prev-exist? true}, etcd.clj:114-118)."""
        try:
            self._request("PUT", key, {"value": str(new),
                                       "prevValue": str(old),
                                       "prevExist": "true"})
            return True
        except EtcdError as e:
            if e.code == 101:
                return False
            raise


def parse_long(s):
    """Parses a string to an int; passes through None (etcd.clj:88-92)."""
    return None if s is None else int(s)


class EtcdClient(client.Client):
    """CAS-register client over independent-tuple values, with the
    reference's determinacy taxonomy (etcd.clj:96-136): reads may
    :fail on anything (they don't change state); writes and cas must
    :info on indeterminate errors. errorCode 100 (not-found) is always
    a definite :fail."""

    def __init__(self, conn: EtcdHTTP | None = None, timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        return EtcdClient(
            EtcdHTTP(client_url(test, node), timeout=self.timeout),
            timeout=self.timeout,
        )

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                value = parse_long(self.conn.get(k, quorum=False))
                return op.with_(type="ok",
                                value=independent.tuple_(k, value))
            if op.f == "write":
                self.conn.put(k, v)
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = v
                ok = self.conn.cas(k, old, new)
                return op.with_(type="ok" if ok else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            return op.with_(type=crash, error="timeout")
        except EtcdError as e:
            if e.code == 100:
                return op.with_(type="fail", error="not-found")
            return op.with_(type=crash, error=str(e))
        except urllib.error.URLError as e:
            if isinstance(e.reason, (socket.timeout, TimeoutError)):
                return op.with_(type=crash, error="timeout")
            return op.with_(type=crash, error=str(e))
        except OSError as e:
            return op.with_(type=crash, error=str(e))


# ---------------------------------------------------------------------------
# Generators (etcd.clj:145-147)

def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


# ---------------------------------------------------------------------------
# Test map (etcd.clj:149-181)

def data_dir(test, node) -> str:
    """etcd's default data dir: <name>.etcd under its cwd (we start
    the daemon with chdir=node_dir and no --data-dir flag)."""
    return f"{node_dir(test, node)}/{node}.etcd"


def client_generator(opts: dict, start_key: int = 0):
    """The independent-keys CAS workload (etcd.clj:166-176). start_key
    offsets the key space so a second instance (the post-heal stability
    window) never collides with the main body's keys."""
    per_key = opts.get("ops_per_key", 300)
    threads_per_key = opts.get("threads_per_key", 10)
    return independent.concurrent_generator(
        threads_per_key,
        itertools.count(start_key),
        lambda k: gen.limit(
            per_key,
            gen.stagger(1 / 30, gen.mix([r, w, cas])),
        ),
    )


def etcd_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = EtcdDB(opts.get("version", VERSION),
                 url=opts.get("archive_url"))
    # fs-break* modes interpose the FUSE fault layer around the data
    # dir: the DB wrapper owns the mount (it must precede the daemon),
    # the nemesis only flips the fault switch — etcd is statically
    # linked Go, so the LD_PRELOAD backend can't touch it
    db_, nemesis_ = cmn.fsfault_wiring(db_, opts, data_dir)
    test = noop_test()
    test.update(
        {
            "name": "etcd",
            "os": osdist.debian,
            "db": db_,
            "client": EtcdClient(),
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "indep": independent.checker(checker_mod.compose({
                    "timeline": checker_mod.timeline_html(),
                    "linear": checker_mod.linearizable(
                        device=opts.get("device")),
                })),
            }),
            "generator": client_generator(opts),
        }
    )
    if nemesis_ is None and cmn.fault_package_wiring(
            test, db_, opts,
            stability_generator=client_generator(opts, start_key=1_000_000),
            corrupt_paths=opts.get("corrupt_paths")
            or [lambda t, n: f"{node_dir(t, n)}/etcd.log"],
            set_time_fn=opts.get("set_time_fn")):
        # composed package: generator/nemesis/checker installed in place
        pass
    else:
        if nemesis_ is None:
            nemesis_ = cmn.pick_nemesis(db_, opts)
        test.update({
            "nemesis": nemesis_,
            "generator": gen.time_limit(
                opts.get("time_limit", 60),
                gen.nemesis(
                    gen.seq(itertools.cycle([
                        gen.sleep(5),
                        {"type": "info", "f": "start"},
                        gen.sleep(5),
                        {"type": "info", "f": "stop"},
                    ])),
                    test["generator"],
                ),
            ),
        })
    # The reference merges opts last (etcd.clj:152,181) so CLI options
    # like nodes/ssh/concurrency override suite defaults. "nemesis" is
    # consumed above (resolved into a nemesis OBJECT) — merging the raw
    # string back over it would hand core.run a str.
    consumed = {"version", "archive_url", "ops_per_key", "threads_per_key",
                "time_limit", "nemesis", "fsfault_opt_dir",
                "nemesis_interval", "seed", "stability_period",
                "fault_ops", "corrupt_paths", "recovery_min_ok", "targets",
                "set_time_fn"}
    test.update({k: v for k, v in opts.items() if k not in consumed})
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p, names=cmn.PARTITION_NEMESIS_NAMES
                    + cmn.FSFAULT_NEMESIS_NAMES)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(etcd_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
