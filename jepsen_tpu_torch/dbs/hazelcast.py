"""Hazelcast test suite: seven workloads over distributed data
structures — queue (total-queue), lock (linearizable mutex), three
unique-ID generators, and two set-as-map workloads (reference:
hazelcast/src/jepsen/hazelcast.clj:1-449).

Pieces, mirroring the reference:
  - HazelcastDB        — jdk + server install, daemon lifecycle with a
                         --members cluster list (hazelcast.clj:63-112)
  - HzConn             — HTTP connection with Hazelcast's 5 s
                         invocation-timeout defaults (hazelcast.clj:117-127)
  - QueueClient        — enqueue/dequeue/drain (hazelcast.clj:211-237)
  - LockClient         — tryLock/unlock through a reconnect wrapper with
                         the reference's failure taxonomy
                         (hazelcast.clj:260-301)
  - AtomicLongIdClient / AtomicRefIdClient / IdGenIdClient
                         (hazelcast.clj:155-205)
  - MapClient          — set-as-sorted-array CAS adds (hazelcast.clj:306-346)
  - workloads()        — workload registry (hazelcast.clj:364-399)
  - hazelcast_test     — test map w/ majorities-ring nemesis and the
                         heal-then-drain final phase (hazelcast.clj:401-433)
  - main()             — CLI entry with --workload (hazelcast.clj:435-448)

The real path installs a Hazelcast distribution and an HTTP shim; the
hermetic path installs dbs/hz_sim.py through the identical archive +
daemon code. Either way the client speaks the same HTTP/JSON protocol.

The port's copy of `jepsen_tpu/dbs/hazelcast.py`. The lock workload's
checker is `linearizable` on the one unkeyed history under
`models.Mutex()`, which `auto` routes to K1 (`ops/csrc/wgl_vec.cu`, up
to 1,024 entries), K5 (`ops/csrc/wgl_row.cu`, up to 4,064) or K2
(`ops/csrc/wgl_search.cu`, past that), or to the native search below
the committed bars; `workloads` takes that checker's `device` (the
test map's, the CLI's `--device`; None = the card; the JAX package's
`workloads` takes nothing). The queue, id and map checkers run on the
host. `hz_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`."""

from __future__ import annotations

import itertools
import json
import logging
import random
import socket
import time
import urllib.error
import urllib.request
import uuid

from .. import checker as checker_mod
from .. import cli, client, db, generator as gen, models, nemesis, osdist
from .. import reconnect
from ..control import util as cu
from . import common as cmn
from ..history import Op

log = logging.getLogger("jepsen_tpu_torch.dbs.hazelcast")

DIR = "/opt/hazelcast"
PORT = 5701
QUEUE_POLL_TIMEOUT_MS = 1  # hazelcast.clj:207-209
LOCK_WAIT_MS = 5000        # hazelcast.clj:276
MAP_NAME = "jepsen.map"
CRDT_MAP_NAME = "jepsen.crdt-map"


def _cfg(test) -> dict:
    return test.get("hazelcast") or {}


def node_host(test, node) -> str:
    fn = _cfg(test).get("addr_fn")
    return fn(node) if fn else str(node)


def node_port(test, node) -> int:
    ports = _cfg(test).get("ports")
    return ports[node] if ports else PORT


def node_dir(test, node) -> str:
    d = _cfg(test).get("dir", DIR)
    return d(node) if callable(d) else d


class HazelcastDB(db.DB, db.LogFiles):
    """Installs and runs one Hazelcast member per node
    (hazelcast.clj:93-112): jdk, the server archive, then a daemon
    started with the other nodes' addresses as --members."""

    def __init__(self, archive_url: str | None = None,
                 jdk: bool = True, ready_timeout: float = 60.0):
        self.archive_url = archive_url
        self.jdk = jdk
        self.ready_timeout = ready_timeout

    def setup(self, test, node) -> None:
        remote = test["remote"]
        d = node_dir(test, node)
        sudo = _cfg(test).get("sudo", True)
        url = self.archive_url or _cfg(test).get("archive_url")
        if not url:
            raise db.SetupFailed(
                "hazelcast archive_url required (server distribution "
                "tarball, or the hz_sim archive for hermetic runs)")
        if self.jdk:
            # A real Hazelcast server archive needs a JVM (the reference
            # runs a fat jar, hazelcast.clj:51-69,100); the hz_sim
            # archive ships its own interpreter, so suites pass
            # jdk=False for it.
            osdist.install_jdk(remote, node)
        cu.install_archive(remote, node, url, d, sudo=sudo)
        members = ",".join(
            node_host(test, n) for n in test["nodes"] if n != node
        )
        cu.start_daemon(
            remote, node, f"{d}/hazelcast-server",
            "--port", str(node_port(test, node)),
            "--name", str(node),
            "--members", members,
            logfile=f"{d}/server.log",
            pidfile=f"{d}/server.pid",
            chdir=d,
        )
        self.await_ready(test, node)

    def probe_ready(self, test, node) -> bool:
        url = (f"http://{node_host(test, node)}:{node_port(test, node)}"
               "/health")
        with urllib.request.urlopen(url, timeout=2) as resp:
            return resp.status == 200

    def await_ready(self, test, node) -> None:
        if cmn.poll_until_ready(self, test, [node], self.ready_timeout):
            raise db.SetupFailed(f"hazelcast on {node} never healthy")

    def teardown(self, test, node) -> None:
        remote = test["remote"]
        d = node_dir(test, node)
        log.info("%s tearing down hazelcast", node)
        cu.stop_daemon(remote, node, f"{d}/server.pid")
        remote.exec(node, ["rm", "-rf", d],
                    sudo=_cfg(test).get("sudo", True), check=False)

    def log_files(self, test, node) -> list:
        return [f"{node_dir(test, node)}/server.log"]


# ---------------------------------------------------------------------------
# Connection


class HzError(Exception):
    def __init__(self, kind: str, message: str = ""):
        super().__init__(message or kind)
        self.kind = kind


class HzConn:
    """One member's HTTP endpoint, with Hazelcast's aggressive op
    timeouts (invocation timeout 5 s, hazelcast.clj:119-127)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def call(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as e:
            try:
                payload = json.load(e)
            except (json.JSONDecodeError, ValueError):
                raise HzError("http", f"HTTP {e.code}") from e
            raise HzError(payload.get("error", "http"),
                          payload.get("message", "")) from e

    def close(self) -> None:
        pass  # per-request sockets


def _connect(test, node, timeout: float = 5.0) -> HzConn:
    return HzConn(node_host(test, node), node_port(test, node),
                  timeout=timeout)


# ---------------------------------------------------------------------------
# Clients (hazelcast.clj:155-346)


class QueueClient(client.Client):
    """enqueue/dequeue/drain against a distributed queue
    (hazelcast.clj:211-237). enqueue must :info on indeterminate errors
    (the item may have been enqueued); dequeue/drain read-modify but an
    indeterminate dequeue is also :info (an item may be lost otherwise);
    an empty poll is a definite :fail :empty."""

    def __init__(self, conn: HzConn | None = None,
                 queue_name: str = "jepsen.queue"):
        self.conn = conn
        self.queue_name = queue_name

    def open(self, test, node):
        return QueueClient(_connect(test, node), self.queue_name)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "enqueue":
                self.conn.call("/queue/put",
                               {"name": self.queue_name, "value": op.value})
                return op.with_(type="ok")
            if op.f == "dequeue":
                got = self.conn.call(
                    "/queue/poll",
                    {"name": self.queue_name,
                     "timeout_ms": QUEUE_POLL_TIMEOUT_MS},
                )["value"]
                if got is None:
                    return op.with_(type="fail", error="empty")
                return op.with_(type="ok", value=got)
            if op.f == "drain":
                values = []
                while True:
                    got = self.conn.call(
                        "/queue/poll",
                        {"name": self.queue_name,
                         "timeout_ms": QUEUE_POLL_TIMEOUT_MS},
                    )["value"]
                    if got is None:
                        return op.with_(type="ok", value=values)
                    values.append(got)
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError, urllib.error.URLError,
                OSError, HzError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class LockClient(client.Client):
    """acquire/release on a distributed lock through a reconnect
    wrapper (hazelcast.clj:260-301). Failure taxonomy from the
    reference: lock timeout → :fail; unlock-by-non-owner → :fail
    :not-lock-owner; quorum loss → :fail :quorum; client-down IO → :fail
    :client-down. All are definite :fails — an un-acquired lock and an
    un-released release don't change state."""

    def __init__(self, conn=None, lock_name: str = "jepsen.lock",
                 session: str | None = None):
        self.conn = conn
        self.lock_name = lock_name
        self.session = session

    def open(self, test, node):
        wrapped = reconnect.wrapper(
            open=lambda: _connect(test, node),
            close=lambda c: c.close(),
            name=f"hazelcast {node}",
        ).open()
        return LockClient(wrapped, self.lock_name, session=str(uuid.uuid4()))

    def invoke(self, test, op: Op) -> Op:
        try:
            with self.conn.with_conn() as c:
                if op.f == "acquire":
                    got = c.call("/lock/acquire", {
                        "name": self.lock_name, "session": self.session,
                        "timeout_ms": LOCK_WAIT_MS,
                    })["acquired"]
                    return op.with_(type="ok" if got else "fail")
                if op.f == "release":
                    c.call("/lock/release", {
                        "name": self.lock_name, "session": self.session,
                    })
                    return op.with_(type="ok")
                raise ValueError(f"unknown op {op.f!r}")
        except HzError as e:
            if e.kind == "not-lock-owner":
                return op.with_(type="fail", error="not-lock-owner")
            if e.kind == "quorum":
                time.sleep(1)
                return op.with_(type="fail", error="quorum")
            return op.with_(type="info", error=str(e))
        except (socket.timeout, TimeoutError) as e:
            # A lost acquire/release response is indeterminate: the
            # server may have granted the lock (reference's analog is
            # the client-down IOException → :fail only when the packet
            # was provably never sent, hazelcast.clj:290-298)
            return op.with_(type="info", error=str(e))
        except (ConnectionRefusedError,) as e:
            return op.with_(type="fail", error="client-down")
        except (urllib.error.URLError, OSError) as e:
            cause = getattr(e, "reason", None)
            if isinstance(cause, ConnectionRefusedError):
                return op.with_(type="fail", error="client-down")
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class AtomicLongIdClient(client.Client):
    """IDs from AtomicLong.incrementAndGet (hazelcast.clj:155-169)."""

    def __init__(self, conn: HzConn | None = None,
                 name: str = "jepsen.atomic-long"):
        self.conn = conn
        self.name = name

    def open(self, test, node):
        return AtomicLongIdClient(_connect(test, node), self.name)

    def invoke(self, test, op: Op) -> Op:
        assert op.f == "generate"
        try:
            v = self.conn.call("/atomic-long/inc", {"name": self.name})["value"]
            return op.with_(type="ok", value=v)
        except (socket.timeout, TimeoutError, urllib.error.URLError,
                OSError, HzError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class AtomicRefIdClient(client.Client):
    """IDs via AtomicReference get + compareAndSet; a lost CAS is a
    definite :fail :cas-failed (hazelcast.clj:171-189)."""

    def __init__(self, conn: HzConn | None = None,
                 name: str = "jepsen.atomic-ref"):
        self.conn = conn
        self.name = name

    def open(self, test, node):
        return AtomicRefIdClient(_connect(test, node), self.name)

    def invoke(self, test, op: Op) -> Op:
        assert op.f == "generate"
        try:
            v = self.conn.call("/atomic-ref/get", {"name": self.name})["value"]
            v2 = (v or 0) + 1
            ok = self.conn.call(
                "/atomic-ref/cas",
                {"name": self.name, "old": v, "new": v2},
            )["swapped"]
            if ok:
                return op.with_(type="ok", value=v2)
            return op.with_(type="fail", error="cas-failed")
        except (socket.timeout, TimeoutError, urllib.error.URLError,
                OSError, HzError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class IdGenIdClient(client.Client):
    """IDs from the block-allocating IdGenerator (hazelcast.clj:191-205)."""

    def __init__(self, conn: HzConn | None = None):
        self.conn = conn

    def open(self, test, node):
        return IdGenIdClient(_connect(test, node))

    def invoke(self, test, op: Op) -> Op:
        assert op.f == "generate"
        try:
            v = self.conn.call("/id-gen/new", {})["value"]
            return op.with_(type="ok", value=v)
        except (socket.timeout, TimeoutError, urllib.error.URLError,
                OSError, HzError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class MapClient(client.Client):
    """A grow-only set stored as a sorted array in one map key, added
    to via replace/putIfAbsent CAS (hazelcast.clj:306-346; Hazelcast
    can't serialize HashSet, hence the sorted-array encoding — we keep
    the same encoding so histories read the same). crdt=True targets
    the merge-policy map the reference calls the CRDT map."""

    def __init__(self, conn: HzConn | None = None, crdt: bool = False):
        self.conn = conn
        self.crdt = crdt

    @property
    def map_name(self) -> str:
        return CRDT_MAP_NAME if self.crdt else MAP_NAME

    def open(self, test, node):
        return MapClient(_connect(test, node), crdt=self.crdt)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                cur = self.conn.call(
                    "/map/get", {"name": self.map_name, "key": "hi"}
                )["value"]
                if cur is not None:
                    new = sorted(set(cur) | {op.value})
                    ok = self.conn.call("/map/replace", {
                        "name": self.map_name, "key": "hi",
                        "old": cur, "new": new,
                    })["replaced"]
                    return (op.with_(type="ok") if ok
                            else op.with_(type="fail", error="cas-failed"))
                prev = self.conn.call("/map/put-if-absent", {
                    "name": self.map_name, "key": "hi",
                    "value": [op.value],
                })["previous"]
                return (op.with_(type="fail", error="cas-failed")
                        if prev is not None else op.with_(type="ok"))
            if op.f == "read":
                cur = self.conn.call(
                    "/map/get", {"name": self.map_name, "key": "hi"}
                )["value"]
                return op.with_(type="ok", value=sorted(set(cur or [])))
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError, urllib.error.URLError,
                OSError, HzError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


# ---------------------------------------------------------------------------
# Workloads (hazelcast.clj:239-399)


def queue_gen() -> gen.Generator:
    """Enqueues of sequential ints mixed with dequeues, staggered 1 s
    (hazelcast.clj:239-248)."""
    counter = itertools.count()

    def enqueue(test, process):
        return {"type": "invoke", "f": "enqueue", "value": next(counter)}

    return gen.stagger(1, gen.mix([
        enqueue, {"type": "invoke", "f": "dequeue"},
    ]))


def map_workload(crdt: bool) -> dict:
    return {
        "client": MapClient(crdt=crdt),
        "generator": gen.stagger(
            0.1,
            gen.seq({"type": "invoke", "f": "add", "value": x}
                    for x in itertools.count()),
        ),
        "final_generator": gen.each(
            lambda: gen.once({"type": "invoke", "f": "read"})),
        "checker": checker_mod.set_checker(),
    }


def workloads(device=None) -> dict:
    """Fresh workload registry — workloads hold stateful generators
    (hazelcast.clj:364-399); `device` goes to the lock workload's
    linearizable checker."""
    return {
        "crdt-map": map_workload(crdt=True),
        "map": map_workload(crdt=False),
        "lock": {
            "client": LockClient(),
            "generator": gen.each(lambda: gen.seq(itertools.cycle([
                {"type": "invoke", "f": "acquire"},
                {"type": "invoke", "f": "release"},
            ]))),
            "checker": checker_mod.linearizable(device=device),
            "model": models.Mutex(),
        },
        "queue": {
            "client": QueueClient(),
            "generator": queue_gen(),
            "final_generator": gen.each(
                lambda: gen.once({"type": "invoke", "f": "drain"})),
            "checker": checker_mod.total_queue(),
        },
        "atomic-ref-ids": {
            "client": AtomicRefIdClient(),
            "generator": gen.stagger(
                1, {"type": "invoke", "f": "generate"}),
            "checker": checker_mod.unique_ids(),
        },
        "atomic-long-ids": {
            "client": AtomicLongIdClient(),
            "generator": gen.stagger(
                1, {"type": "invoke", "f": "generate"}),
            "checker": checker_mod.unique_ids(),
        },
        "id-gen-ids": {
            "client": IdGenIdClient(),
            "generator": gen.to_gen({"type": "invoke", "f": "generate"}),
            "checker": checker_mod.unique_ids(),
        },
    }


def hazelcast_test(opts: dict) -> dict:
    """Test map from CLI options (hazelcast.clj:401-433): chosen
    workload under a start/stop(30,15) majorities-ring partition
    nemesis; when the workload has a final generator, phases heal the
    cluster, wait for quiescence, then run it on every client."""
    from ..testlib import noop_test

    wl = workloads(opts.get("device"))[opts["workload"]]
    db_ = HazelcastDB(archive_url=opts.get("archive_url"),
                      jdk=opts.get("install_jdk", True))
    generator = gen.time_limit(
        opts.get("time_limit", 60),
        gen.nemesis(gen.start_stop(30, 15), wl["generator"]),
    )
    if wl.get("final_generator") is not None:
        generator = gen.phases(
            generator,
            gen.log("Healing cluster"),
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.log("Waiting for quiescence"),
            gen.sleep(opts.get("quiesce", 500)),
            cmn.ready_gated_final(db_, gen.clients(wl["final_generator"]),
                                opts),
        )

    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": f"hazelcast {opts['workload']}",
            "os": osdist.debian,
            "db": db_,
            "client": wl["client"],
            "nemesis": cmn.pick_nemesis(db_, opts, default="majority-ring"),
            "generator": generator,
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "timeline": checker_mod.timeline_html(),
                "workload": wl["checker"],
            }),
            "model": wl.get("model"),
        }
    )
    return test


def _opt_spec(p) -> None:
    # HazelcastDB manages its own daemon (not an ArchiveDB), so only
    # the partition modes exist — reject others at parse time
    cmn.nemesis_opt(p, names=cmn.PARTITION_NEMESIS_NAMES,
                    default="majority-ring")
    p.add_argument(
        "--workload", required=True, choices=sorted(workloads().keys()),
        help="Test workload to run, e.g. atomic-long-ids.",
    )
    p.add_argument("--archive-url", dest="archive_url", default=None,
                   help="Hazelcast server archive (or hz_sim archive).")
    p.add_argument("--quiesce", type=float, default=500,
                   help="Seconds to wait before the final drain phase.")


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(hazelcast_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
