"""Shared plumbing for per-DB suites: the per-suite config accessors
(addr_fn/ports/dir/sudo overrides under one test-map key) and the
archive-install + daemon DB lifecycle that most suites share.

Every suite keeps its own protocol client, workloads, and readiness
probe — this factors only the mechanical parts so a lifecycle fix lands
once instead of once per suite.

The port's copy of `jepsen_tpu/dbs/common.py`: the archive-DB shape
(`SuiteCfg`, `ArchiveDB`, `MultiDaemonDB`) and its kill nemeses, the
--nemesis option and its registry, the fs-break wiring
(`nemesis/fsfault.py`), the fault-package wiring (`nemesis/combined.py`:
fault families and --nemesis-schedule), the readiness poll and its
generator gate."""

from __future__ import annotations

import logging
import random
import threading
import time

from .. import db, nemesis
from .. import generator as gen
from ..control import util as cu
from ..nemesis.combined import FAULT_FAMILIES, parse_fault_spec  # noqa: F401
from ..util import real_pmap

log = logging.getLogger("jepsen_tpu_torch.dbs.common")


class SuiteCfg:
    """Accessors for a suite's config sub-map (test[name]): addressing,
    ports, install dir, sudo — the knobs that differ between a real
    cluster and a LocalRemote sandbox."""

    def __init__(self, name: str, default_port: int, default_dir: str):
        self.name = name
        self.default_port = default_port
        self.default_dir = default_dir

    def cfg(self, test) -> dict:
        return test.get(self.name) or {}

    def host(self, test, node) -> str:
        fn = self.cfg(test).get("addr_fn")
        return fn(node) if fn else str(node)

    def port(self, test, node) -> int:
        ports = self.cfg(test).get("ports")
        return ports[node] if ports else self.default_port

    def dir(self, test, node) -> str:
        d = self.cfg(test).get("dir", self.default_dir)
        return d(node) if callable(d) else d

    def sudo(self, test):
        return self.cfg(test).get("sudo", True)


class ArchiveDB(db.DB, db.Kill, db.Pause, db.LogFiles):
    """The common suite DB shape: install an archive, start one daemon,
    poll until ready, stop + wipe on teardown. Subclasses provide
    `binary`, `daemon_args(test, node)`, and `probe_ready(test, node)
    -> bool`; anything extra (cluster joins, bootstrap flags) hooks in
    via `post_start(test, node)`.

    Implements db.Kill (SIGKILL via pidfile + the shared start()) and
    db.Pause (SIGSTOP/SIGCONT), so every archive suite — mongodb's
    mongo_sim-backed MongoDB included — can host the kill/pause fault
    families from nemesis.combined."""

    binary = "server"
    log_name = "server.log"
    pid_name = "server.pid"

    def __init__(self, suite: SuiteCfg, archive_url: str | None = None,
                 ready_timeout: float = 30.0):
        self.suite = suite
        self.archive_url = archive_url
        self.ready_timeout = ready_timeout

    def resolve_url(self, test) -> str:
        url = self.archive_url or self.suite.cfg(test).get("archive_url")
        if not url:
            raise db.SetupFailed(
                f"{self.suite.name} archive_url required (release "
                "archive, or the in-repo sim archive for hermetic runs)")
        return url

    def daemon_args(self, test, node) -> list:
        return []

    def start(self, test, node) -> None:
        """Start (or restart) the daemon — the single invocation both
        setup and kill/restart nemeses use, so they can't drift."""
        d = self.suite.dir(test, node)
        cu.start_daemon(
            test["remote"], node, f"{d}/{self.binary}",
            *self.daemon_args(test, node),
            logfile=f"{d}/{self.log_name}",
            pidfile=f"{d}/{self.pid_name}",
            chdir=d,
        )

    def setup(self, test, node) -> None:
        self.install(test, node)
        self.start_and_await(test, node)

    def install(self, test, node) -> None:
        """Fetch + unpack only — split from start_and_await so
        interposers (the faultfs FUSE layer) can mount over the data
        dir between the install's tree wipe and the daemon opening
        its first file (fsfault.FaultFsDB)."""
        remote = test["remote"]
        d = self.suite.dir(test, node)
        cu.install_archive(remote, node, self.resolve_url(test), d,
                           sudo=self.suite.sudo(test))

    def start_and_await(self, test, node) -> None:
        self.start(test, node)
        self.await_ready(test, node)
        self.post_start(test, node)

    def probe_ready(self, test, node) -> bool:
        raise NotImplementedError

    def await_ready(self, test, node) -> None:
        down = poll_until_ready(self, test, [node], self.ready_timeout)
        if down:
            raise db.SetupFailed(
                f"{self.suite.name} on {node} never became ready")

    def post_start(self, test, node) -> None:
        pass

    def teardown(self, test, node) -> None:
        remote = test["remote"]
        d = self.suite.dir(test, node)
        log.info("%s tearing down %s", node, self.suite.name)
        cu.stop_daemon(remote, node, f"{d}/{self.pid_name}")
        remote.exec(node, ["rm", "-rf", d], sudo=self.suite.sudo(test),
                    check=False)

    def log_files(self, test, node) -> list:
        return [f"{self.suite.dir(test, node)}/{self.log_name}"]

    # -- db.Kill / db.Pause / db.Process ------------------------------------

    def _pidfile(self, test, node) -> str:
        return f"{self.suite.dir(test, node)}/{self.pid_name}"

    def kill(self, test, node) -> None:
        """Crash-like stop: SIGKILL via pidfile (db.Kill). start() above
        is the matching revive — the same invocation setup uses."""
        cu.stop_daemon(test["remote"], node, self._pidfile(test, node))

    def _signal(self, test, node, sig: str) -> None:
        r = test["remote"].exec(node, ["cat", self._pidfile(test, node)],
                                check=False)
        pid = r.out.strip()
        if pid:
            test["remote"].exec(node, ["kill", f"-{sig}", pid],
                                check=False)

    def pause(self, test, node) -> None:
        self._signal(test, node, "STOP")

    def resume(self, test, node) -> None:
        self._signal(test, node, "CONT")

    def alive(self, test, node):
        return cu.daemon_running(test["remote"], node,
                                 self._pidfile(test, node))


def shared_flag() -> dict:
    """A once-guard shared across a client's clones (the reference's
    (locking tbl-created? (compare-and-set! ...)) idiom)."""
    import threading

    return {"lock": threading.Lock(), "created": False}


def once(flag: dict, fn) -> None:
    """Run fn exactly once across all holders of the flag."""
    with flag["lock"]:
        if not flag["created"]:
            fn()
            flag["created"] = True


class ArchiveKillNemesis:
    """Bounded-dead-set kill/restart for any ArchiveDB suite (the
    aerospike reference's kill-nemesis shape, nemesis.clj:17-58,
    generalized): :kill stops the daemon on the named nodes while the
    dead set stays under max_dead (a majority survives); :restart
    revives them via the DB's own start() so the invocation can't
    drift from setup. Subclasses add suite-specific maintenance ops via
    extra_op()."""

    def __init__(self, db: ArchiveDB, max_dead: int = 2):
        self.db = db
        self.max_dead = max_dead
        self.dead: set = set()
        self._lock = threading.Lock()

    def setup(self, test):
        return self

    def invoke(self, test, op):
        remote = test["remote"]
        targets = list(op.value or test["nodes"])
        results = {}
        for node in targets:
            if op.f == "kill":
                with self._lock:
                    if node in self.dead or len(self.dead) < self.max_dead:
                        self.dead.add(node)
                        allowed = True
                    else:
                        allowed = False
                if allowed:
                    d = self.db.suite.dir(test, node)
                    cu.stop_daemon(remote, node,
                                   f"{d}/{self.db.pid_name}")
                    results[node] = "killed"
                else:
                    results[node] = "still-alive"
            elif op.f == "restart":
                self.db.start(test, node)
                with self._lock:
                    self.dead.discard(node)
                results[node] = "started"
            else:
                results[node] = self.extra_op(test, node, op)
        return op.with_(type="info", value=results)

    def extra_op(self, test, node, op):
        raise ValueError(
            f"{type(self).__name__} can't handle {op.f!r}")

    def teardown(self, test):
        pass


def archive_kill_nemesis(db: ArchiveDB,
                         max_dead: int = 2) -> ArchiveKillNemesis:
    return ArchiveKillNemesis(db, max_dead)


class StartKillNemesis(ArchiveKillNemesis):
    """ArchiveKillNemesis behind the partitioner's start/stop op
    convention (the shape tidb/nemesis.clj:134-142's startkill takes):
    :start kills up to n random nodes, :stop restarts whatever died."""

    def __init__(self, db: ArchiveDB, n: int = 1):
        super().__init__(db, max_dead=n)
        self.n = n

    def invoke(self, test, op):
        import random as _random

        if op.f == "start":
            nodes = list(test["nodes"])
            targets = _random.sample(nodes, min(self.n, len(nodes)))
            return super().invoke(test, op.with_(f="kill",
                                                 value=targets)
                                  ).with_(f="start")
        if op.f == "stop":
            with self._lock:
                targets = sorted(self.dead)
            if not targets:
                # nothing died since the last stop: a bare [] would
                # fall through invoke's "falsy means all nodes" default
                # and restart every healthy daemon
                return op.with_(type="info", value={})
            out = super().invoke(test, op.with_(f="restart",
                                                value=targets))
            return out.with_(f="stop")
        return super().invoke(test, op)


def poll_until_ready(db, test, nodes, timeout: float) -> list:
    """Poll db.probe_ready on `nodes` (in parallel) until all answer or
    the timeout passes; returns the still-down nodes. ANY probe
    exception counts as not-ready — a daemon mid-startup can refuse
    connections (OSError), speak garbage HTTP (http.client errors), or
    answer protocol-level errors ("-LOADING"), and a probe must poll
    through all of them, never crash the caller."""
    def probe(node) -> bool:
        try:
            return bool(db.probe_ready(test, node))
        except NotImplementedError:
            raise  # missing override is a programming error, not "down"
        except Exception:
            return False

    deadline = time.monotonic() + timeout
    down = list(nodes)
    while True:
        up = real_pmap(probe, down)
        down = [n for n, ok in zip(down, up) if not ok]
        if not down or time.monotonic() > deadline:
            return down
        time.sleep(0.2)


class AwaitReadyGen(gen.Generator):
    """A generator gate: delay the wrapped (final) generator until every
    node answers db.probe_ready, or the timeout passes. A kill/restart
    nemesis's heal returns as soon as the daemon is spawned; a fixed
    quiesce sleep races the daemon's bind on slow machines, while
    probing is deterministic. On expiry the gate logs the still-down
    nodes and proceeds — the final ops' own failures then tell the
    story (the run must not hang forever on a node that never
    revives)."""

    def __init__(self, db, inner, timeout: float = 30.0):
        """`db` is anything with probe_ready(test, node) — ArchiveDB
        subclasses, or any DB that grows the method."""
        self.db = db
        self.name = getattr(getattr(db, "suite", None), "name",
                            type(db).__name__)
        self.inner = gen.to_gen(inner)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._done = False

    def op(self, test, process):
        with self._lock:
            if not self._done:
                down = poll_until_ready(self.db, test, test["nodes"],
                                        self.timeout)
                if down:
                    log.warning(
                        "%s still not ready after %.0fs health gate: %s "
                        "— final ops may fail",
                        self.name, self.timeout, down)
                self._done = True
        return self.inner.op(test, process)


def await_ready_gen(db, inner, timeout: float = 30.0) -> AwaitReadyGen:
    return AwaitReadyGen(db, inner, timeout)


def ready_gated_final(db, inner, opts: dict) -> AwaitReadyGen:
    """The standard health-gated final phase: one place owns the
    ready_timeout option name and default for every suite."""
    return AwaitReadyGen(db, inner,
                         timeout=opts.get("ready_timeout", 30.0))


class MultiDaemonDB(ArchiveDB):
    """Shared machinery for suites whose nodes run SEVERAL daemons
    (tidb's pd/tikv/tidb triple, mysql-cluster's mgmd/ndbd/mysqld):
    per-role pid/log files, component start/stop/probe (the
    ComponentKiller surface), a readiness poll that doubles as a
    cross-node bring-up barrier, and ordered teardown. Subclasses
    declare ROLES / ROLE_TAG / ROLE_BIN / STOP_ORDER and implement
    role_args + role_port (and role_nodes when a role doesn't run
    everywhere); setup order stays suite-specific."""

    ROLES: tuple = ()
    ROLE_TAG: dict = {}
    ROLE_BIN: dict = {}
    STOP_ORDER: tuple = ()

    def role_nodes(self, test, role) -> list:
        return list(test["nodes"])

    def role_port(self, test, node, role) -> int:
        raise NotImplementedError

    def role_args(self, test, node, role) -> list:
        raise NotImplementedError

    def _role_files(self, test, node, role):
        d = self.suite.dir(test, node)
        tag = self.ROLE_TAG[role]
        return f"{d}/{tag}.log", f"{d}/{tag}.pid"

    def start_component(self, test, node, role) -> None:
        d = self.suite.dir(test, node)
        logf, pidf = self._role_files(test, node, role)
        cu.start_daemon(
            test["remote"], node, f"{d}/{self.ROLE_BIN[role]}",
            *self.role_args(test, node, role),
            logfile=logf, pidfile=pidf, chdir=d)

    def stop_component(self, test, node, role) -> None:
        _, pidf = self._role_files(test, node, role)
        cu.stop_daemon(test["remote"], node, pidf)

    def component_running(self, test, node, role):
        _, pidf = self._role_files(test, node, role)
        return cu.daemon_running(test["remote"], node, pidf)

    def _await_ports(self, test, role, timeout) -> None:
        """Poll every hosting node's `role` port from this node's
        setup — readiness-gating replaces the reference's synchronize
        + fixed sleeps (setup runs on all nodes in parallel, so this
        is an effective cross-node barrier)."""
        deadline = time.monotonic() + timeout
        pending = list(self.role_nodes(test, role))
        while pending:
            pending = [
                n for n in pending
                if not self._port_open(self.suite.host(test, n),
                                       self.role_port(test, n, role))
            ]
            if not pending:
                return
            if time.monotonic() > deadline:
                raise db.SetupFailed(
                    f"{self.suite.name} {role} never ready on {pending}")
            time.sleep(0.05)

    @staticmethod
    def _port_open(host, port) -> bool:
        import socket

        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            return False

    def teardown(self, test, node) -> None:
        remote = test["remote"]
        d = self.suite.dir(test, node)
        for role in self.STOP_ORDER:
            _, pidf = self._role_files(test, node, role)
            cu.stop_daemon(remote, node, pidf)
        remote.exec(node, ["rm", "-rf", d], sudo=self.suite.sudo(test),
                    check=False)

    def log_files(self, test, node) -> list:
        d = self.suite.dir(test, node)
        return [f"{d}/{self.ROLE_TAG[r]}.log" for r in self.ROLES]


class ComponentKiller(nemesis.Nemesis):
    """Kill one role's daemon on a random node; stop revives every
    downed instance of that role. Speaks the partitioner's start/stop
    op convention so the suites' shared nemesis generator drives it
    unchanged. For multi-daemon DBs (tidb's pd/tikv/tidb triple,
    mysql-cluster's mgmd/ndbd/mysqld roles): faults hit one component
    while the node's other daemons keep serving. The DB must expose
    start_component/stop_component(test, node, role) and may expose
    `role_nodes(test, role)` to bound which nodes host the role."""

    def __init__(self, db, role: str):
        self.db = db
        self.role = role
        self.downed: set = set()

    def _hosts(self, test) -> list:
        fn = getattr(self.db, "role_nodes", None)
        return list(fn(test, self.role)) if fn else list(test["nodes"])

    def invoke(self, test, op):
        if op.f == "start":
            candidates = [n for n in self._hosts(test)
                          if n not in self.downed]
            if not candidates:
                return op.with_(type="info", value="all-down")
            node = random.choice(candidates)
            self.db.stop_component(test, node, self.role)
            self.downed.add(node)
            return op.with_(type="info", value=[self.role, "killed", node])
        if op.f == "stop":
            revived = sorted(self.downed)
            for node in revived:
                self.db.start_component(test, node, self.role)
            self.downed.clear()
            return op.with_(type="info",
                            value=[self.role, "restarted", revived])
        raise ValueError(f"unknown nemesis op {op.f!r}")

    def teardown(self, test):
        for node in sorted(self.downed):
            try:
                self.db.start_component(test, node, self.role)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        self.downed.clear()


def standard_nemeses(db) -> dict:
    """The named-nemesis registry the per-DB runners share (the
    cockroach/tidb registries' common core, nemesis.clj:110-144):
    partitions, majorities-ring, SIGSTOP pauses, bounded kill+restart.
    Suites whose DB isn't an ArchiveDB (custom daemon management) get
    the partition entries only."""
    from .. import nemesis as nem

    out = {
        "none": lambda: nem.noop,
        "parts": nem.partition_random_halves,
        "majority-ring": nem.partition_majorities_ring,
    }
    if isinstance(db, ArchiveDB):
        out.update({
            "start-stop": lambda: nem.hammer_time(db.binary),
            "start-kill": lambda: StartKillNemesis(db, 1),
            "start-kill-2": lambda: StartKillNemesis(db, 2),
        })
    return out


NEMESIS_NAMES = ("none", "parts", "majority-ring", "start-stop",
                 "start-kill", "start-kill-2")
PARTITION_NEMESIS_NAMES = ("none", "parts", "majority-ring")


def pick_nemesis(db, opts: dict, default: str = "parts", extra=None):
    """Resolve the suite's nemesis from the shared --nemesis option
    (the cockroach/tidb CLI surface, generalized). `extra` merges
    suite-specific entries (e.g. component killers for multi-daemon
    DBs) over the standard registry."""
    name = opts.get("nemesis") or default
    registry = standard_nemeses(db)
    if extra:
        registry.update(extra)
    if name not in registry:
        raise ValueError(
            f"nemesis {name!r} not available for this suite "
            f"(have: {sorted(registry)})")
    return registry[name]()


FSFAULT_NEMESIS_NAMES = ("fs-break", "fs-break-1pct")


def fsfault_wiring(db_, opts: dict, data_dir_fn):
    """(db, nemesis) for the --nemesis fs-break modes, else
    (db, None). The DB wraps in FaultFsDB — the mount must happen
    between install and daemon start — and the nemesis only flips the
    shared fault switch; ONE opt_dir (opts['fsfault_opt_dir']) feeds
    both, since diverging control-file paths would make every
    break/clear a silent no-op. Suites add FSFAULT_NEMESIS_NAMES to
    their nemesis_opt choices and consume 'fsfault_opt_dir' in their
    merge-opts-last step."""
    name = opts.get("nemesis") or ""
    if not name.startswith("fs-break"):
        return db_, None
    from ..nemesis import fsfault

    fs_opt = opts.get("fsfault_opt_dir", fsfault.OPT_DIR)
    wrapped = fsfault.FaultFsDB(db_, data_dir_fn, opt_dir=fs_opt)
    nem = fsfault.fs_fault_nemesis(
        backend="fuse", manage_mounts=False, opt_dir=fs_opt,
        default_mode=("break-one-percent" if name == "fs-break-1pct"
                      else "break-all"))
    return wrapped, nem


def nemesis_opt(p, names=NEMESIS_NAMES, default: str = "parts") -> None:
    """argparse surface for --nemesis. The value is either a registry
    name from `names` (validated at test-build time by pick_nemesis) or
    a comma list of fault families ("kill,partition") resolved into a
    composed nemesis package by fault_package_wiring — open-ended, so
    no argparse `choices` gate."""
    p.add_argument(
        "--nemesis", default=default, metavar="SPEC",
        help=f"named fault mode (one of: {', '.join(names)}), or a "
        f"comma list of fault families ({', '.join(FAULT_FAMILIES)}) "
        f"for a composed package (default: {default})")


def fault_package_wiring(test: dict, db_, opts: dict,
                         stability_generator=None,
                         corrupt_paths=None,
                         set_time_fn=None) -> bool:
    """When --nemesis names fault families ("kill,partition"), build
    the composed NemesisPackage and install it into the test map —
    nemesis, schedules, heal phase, stability window, recovery checker
    (nemesis.combined.wire_package). The test map's CURRENT generator
    must be the client-side generator; wiring wraps it. Returns True
    when wired, False when --nemesis is a plain registry name for
    pick_nemesis.

    --nemesis-schedule FILE takes precedence over --nemesis: the file's
    schedule document (combined.schedule_to_json / a fuzz-discovered
    schedule) is replayed VERBATIM through the real nemeses — same
    wiring, no rng. `set_time_fn` replaces the clock family's setter
    (`nemesis.set_time`, which runs `date -s` on the node)."""
    from ..nemesis import combined

    wiring = {
        "time_limit": opts.get("time_limit", 60),
        "stability_period": opts.get("stability_period", 10.0),
        "stability_generator": stability_generator,
        "recovery_min_ok": opts.get("recovery_min_ok", 1),
    }
    sched_file = opts.get("nemesis_schedule")
    if sched_file:
        pkg = combined.load_schedule_file(
            sched_file, db=db_, corrupt_paths=corrupt_paths,
            set_time_fn=set_time_fn)
        combined.wire_package(test, pkg, wiring)
        return True
    fams = combined.parse_fault_spec(opts.get("nemesis"))
    if fams is None:
        return False
    pkg = combined.nemesis_package(
        faults=fams,
        db=db_,
        seed=opts.get("seed"),
        interval=opts.get("nemesis_interval", 10.0),
        fault_ops=opts.get("fault_ops"),
        corrupt_paths=corrupt_paths,
        set_time_fn=set_time_fn,
        targets=opts.get("targets"),
    )
    combined.wire_package(test, pkg, wiring)
    return True


def clock_tools(test):
    """The clock tools a suite's clock nemeses drive: the test map's
    "clock_tools" (`simbase.RecordingClockTools` on a simulated cluster),
    else `nemesis/time.py`'s native tools."""
    from ..nemesis import time as nt

    return test.get("clock_tools") or nt


def resp_ping_ready(suite: SuiteCfg, test, node,
                    timeout: float = 2.0) -> bool:
    """Readiness probe for RESP-protocol suites (disque, raftis)."""
    from . import redis_proto

    conn = redis_proto.RespConn(
        suite.host(test, node), suite.port(test, node), timeout=timeout)
    try:
        return conn.call("PING") == "PONG"
    finally:
        conn.close()
