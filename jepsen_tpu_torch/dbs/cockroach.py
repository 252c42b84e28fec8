"""CockroachDB test suite — DB lifecycle, pgwire client helpers, and
the named-nemesis registry (reference:
cockroachdb/src/jepsen/cockroach.clj,
cockroach/auto.clj, cockroach/client.clj, cockroach/nemesis.clj;
workloads live in cockroach_workloads.py).

Pieces, mirroring the reference:
  - CockroachDB       — tarball install + `cockroach start --insecure
                        --join=...` daemon lifecycle (auto.clj:142-214)
  - conn_wrapper      — reconnect-wrapped PgConn per node
                        (client.clj:76-96)
  - txn()/txn_retry() — transaction context + 40001 retry loop with
                        exponential backoff (client.clj:131-161)
  - exception_to_op   — the exception→op determinacy taxonomy
                        (client.clj:183-226)
  - with_idempotent   — :info→:fail remap for idempotent op classes
                        (client.clj:110-116)
  - nemeses registry + compose / slowing / restarting wrappers
                        (nemesis.clj:26-316)
  - basic_test        — shared test-map scaffold (cockroach.clj:83-164)

The real path installs a cockroach binary tarball; the hermetic path
installs dbs/crdb_sim.py (a pgwire server with serializable
transactions) through the identical archive + daemon code. Either way
the client speaks the same wire protocol via dbs/pg_proto.py.

The port's copy of `jepsen_tpu/dbs/cockroach.py`. The clock nemeses
(`BumpTime`, `StrobeTime`) drive the native clock tools of
`nemesis/time.py` on each node, or the test map's "clock_tools" (an
object with the same `install`, `reset_time`, `bump_time` and
`strobe_time`) where it has one: `crdb_sim.local_test_fn` records them
there, since the simulated nodes share this machine's clock.
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
from contextlib import contextmanager

from .. import db, generator as gen, nemesis, osdist, reconnect
from .. import net as net_mod
from ..control import util as cu
from ..nemesis import time as nt  # noqa: F401 (the native clock tools)
from . import pg_proto
from .common import clock_tools

log = logging.getLogger("jepsen_tpu_torch.dbs.cockroach")

DIR = "/opt/cockroach"
PORT = 26257
HTTP_PORT = 8080
DB_NAME = "jepsen"
DB_USER = "root"

TIMEOUT_DELAY = 10.0   # default op timeout, s (client.clj:21)
MAX_TIMEOUT = 30.0     # connect timeout, s (client.clj:22)

NEMESIS_DELAY = 5      # s between interruptions (nemesis.clj:20)
NEMESIS_DURATION = 5   # s per interruption (nemesis.clj:23)


def _cfg(test) -> dict:
    return test.get("cockroach") or {}


def node_host(test, node) -> str:
    fn = _cfg(test).get("addr_fn")
    return fn(node) if fn else str(node)


def node_port(test, node) -> int:
    ports = _cfg(test).get("ports")
    return ports[node] if ports else PORT


def node_dir(test, node) -> str:
    d = _cfg(test).get("dir", DIR)
    return d(node) if callable(d) else d


def data_dir(test, node) -> str:
    """The node's --store dir; single source of truth — the faultfs
    FUSE layer mounts over exactly this path."""
    return f"{node_dir(test, node)}/data"


# ---------------------------------------------------------------------------
# DB (auto.clj:142-223)


class CockroachDB(db.DB, db.LogFiles):
    """Installs and runs one cockroach node per node. The first node
    starts solo; the rest join it (auto.clj:157-190)."""

    def __init__(self, tarball: str | None = None,
                 ready_timeout: float = 60.0):
        self.tarball = tarball
        self.ready_timeout = ready_timeout

    def setup(self, test, node) -> None:
        self.install(test, node)
        self.start_and_await(test, node)

    def install(self, test, node) -> None:
        """Fetch + unpack only — split from start_and_await so the
        faultfs FUSE layer can mount over the store dir between the
        install's tree wipe and the daemon opening its first file
        (fsfault.FaultFsDB)."""
        remote = test["remote"]
        d = node_dir(test, node)
        sudo = _cfg(test).get("sudo", True)
        url = self.tarball or _cfg(test).get("tarball")
        if not url:
            raise db.SetupFailed(
                "cockroach tarball url required (binary distribution, or "
                "the crdb_sim archive for hermetic runs)")
        cu.install_archive(remote, node, url, d, sudo=sudo)

    def start_and_await(self, test, node) -> None:
        start_node(test, node)
        self.await_ready(test, node)
        # Ensure the jepsen database exists (auto.clj's csql! bootstrap)
        conn = pg_proto.PgConn(node_host(test, node), node_port(test, node),
                               user=DB_USER, database=DB_NAME,
                               timeout=5.0, connect_timeout=5.0)
        try:
            try:
                conn.query(f"create database if not exists {DB_NAME}")
            except pg_proto.PgError:
                pass  # sim has no databases; real crdb accepts this
        finally:
            conn.close()

    def await_ready(self, test, node) -> None:
        deadline = time.monotonic() + self.ready_timeout
        while True:
            try:
                conn = pg_proto.PgConn(
                    node_host(test, node), node_port(test, node),
                    user=DB_USER, database=DB_NAME,
                    timeout=2.0, connect_timeout=2.0,
                )
                try:
                    conn.query("select 1")
                    return
                finally:
                    conn.close()
            except (OSError, pg_proto.PgError, pg_proto.PgProtocolError):
                pass
            if time.monotonic() > deadline:
                raise db.SetupFailed(f"cockroach on {node} never ready")
            time.sleep(0.2)

    def teardown(self, test, node) -> None:
        remote = test["remote"]
        d = node_dir(test, node)
        log.info("%s tearing down cockroach", node)
        cu.stop_daemon(remote, node, f"{d}/cockroach.pid")
        remote.exec(node, ["rm", "-rf", d],
                    sudo=_cfg(test).get("sudo", True), check=False)

    def log_files(self, test, node) -> list:
        return [f"{node_dir(test, node)}/cockroach.log"]


def start_node(test, node) -> None:
    """(Re)start cockroach on a node — used by setup and as the
    startkill nemesis's start_fn. Bootstrap follows the reference
    (auto.clj:157-190): the first node starts solo and the rest join
    it, so a fresh real cluster actually initializes."""
    remote = test["remote"]
    d = node_dir(test, node)
    primary = test["nodes"][0]
    join_args = (
        [] if node == primary
        else ["--join", f"{node_host(test, primary)}:"
                        f"{node_port(test, primary)}"]
    )
    cu.start_daemon(
        remote, node, f"{d}/cockroach", "start",
        "--insecure",
        "--port", str(node_port(test, node)),
        *join_args,
        "--store", data_dir(test, node),
        logfile=f"{d}/cockroach.log",
        pidfile=f"{d}/cockroach.pid",
        chdir=d,
    )


def kill_node(test, node) -> None:
    """Kill -9 cockroach on a node (auto.clj:206-211)."""
    remote = test["remote"]
    d = node_dir(test, node)
    cu.stop_daemon(remote, node, f"{d}/cockroach.pid")


# ---------------------------------------------------------------------------
# Client helpers (client.clj)


def conn_wrapper(test, node) -> reconnect.Wrapper:
    """A reconnect-wrapped pgwire connection to one node
    (client.clj:76-96)."""
    host, port = node_host(test, node), node_port(test, node)

    def open_conn():
        return pg_proto.PgConn(host, port, user=DB_USER, database=DB_NAME,
                               timeout=TIMEOUT_DELAY,
                               connect_timeout=MAX_TIMEOUT)

    return reconnect.wrapper(
        open=open_conn,
        close=lambda c: c.close(),
        name=f"cockroach {node}",
    ).open()


@contextmanager
def txn(c: pg_proto.PgConn):
    """BEGIN/COMMIT bracket; ROLLBACK (best-effort) on error
    (client.clj:159-163)."""
    c.query("begin")
    try:
        yield c
    except BaseException:
        try:
            c.query("rollback")
        except (OSError, pg_proto.PgError, pg_proto.PgProtocolError):
            pass
        raise
    else:
        c.query("commit")


def txn_retry(body, attempts: int = 30, backoff: float = 0.02):
    """Run body(), retrying SQLSTATE 40001 'restart transaction' errors
    with jittered exponential backoff (client.clj:143-157)."""
    while True:
        try:
            return body()
        except pg_proto.PgError as e:
            if not e.retryable or attempts <= 0:
                raise
            attempts -= 1
            time.sleep(backoff)
            backoff *= 4 + 0.5 * (random.random() - 0.5)


def with_idempotent(idempotent_fs, op):
    """Remap :info to :fail for idempotent op classes — a read that
    maybe-happened didn't change anything (client.clj:110-116)."""
    if op.f in idempotent_fs and op.type == "info":
        return op.with_(type="fail")
    return op


def exception_to_op(op, e):
    """Map an exception to a completed op per the reference's
    determinacy taxonomy (client.clj:183-226): 40001 restart-transaction
    errors definitely failed; connection-refused definitely failed
    (nothing was sent); timeouts and other server errors are
    indeterminate."""
    if isinstance(e, pg_proto.PgError):
        if e.retryable:
            return op.with_(type="fail", error=("restart-transaction",
                                                e.message))
        if e.sqlstate == "23505":
            # unique violation: the insert definitely did NOT commit
            return op.with_(type="fail", error=("duplicate-key",
                                                e.message))
        return op.with_(type="info", error=("psql-exception", str(e)))
    if isinstance(e, ConnectionRefusedError):
        return op.with_(type="fail", error="connection-refused")
    if isinstance(e, (socket.timeout, TimeoutError)):
        return op.with_(type="info", error="timeout")
    if isinstance(e, (ConnectionError, pg_proto.PgProtocolError, OSError)):
        return op.with_(type="info", error=str(e))
    return None  # unrecognized: re-raise


def invoke_with_taxonomy(wrapper, op, body, idempotent_fs=frozenset()):
    """The with-exception->op + with-conn + with-idempotent stack every
    cockroach client shares (client.clj:98-116,228-234). body(conn) must
    return a completed op."""
    try:
        with wrapper.with_conn() as c:
            return with_idempotent(idempotent_fs, body(c))
    except Exception as e:  # noqa: BLE001
        mapped = exception_to_op(op, e)
        if mapped is None:
            raise
        return with_idempotent(idempotent_fs, mapped)


# ---------------------------------------------------------------------------
# Nemesis registry (nemesis.clj:26-316)


def nemesis_single_gen() -> dict:
    """start/stop cycle with the standard delay/duration
    (nemesis.clj:31-37)."""
    import itertools

    return {
        "during": gen.seq(itertools.cycle([
            gen.sleep(NEMESIS_DELAY),
            {"type": "info", "f": "start"},
            gen.sleep(NEMESIS_DURATION),
            {"type": "info", "f": "stop"},
        ])),
        "final": gen.once({"type": "info", "f": "stop"}),
    }


def none() -> dict:
    """The blank nemesis (nemesis.clj:110-115)."""
    return {"name": "blank", "client": nemesis.noop, "clocks": False,
            "during": gen.void, "final": gen.void}


def parts() -> dict:
    """Random-halves partitions (nemesis.clj:118-124)."""
    return {**nemesis_single_gen(), "name": "parts",
            "client": nemesis.partition_random_halves(), "clocks": False}


def majring() -> dict:
    """Majorities-ring partition (nemesis.clj:145-150)."""
    return {**nemesis_single_gen(), "name": "majring",
            "client": nemesis.partition_majorities_ring(), "clocks": False}


def startstop(n: int = 1) -> dict:
    """SIGSTOP/SIGCONT n random nodes (nemesis.clj:127-133)."""
    return {**nemesis_single_gen(),
            "name": "startstop" + (str(n) if n > 1 else ""),
            "client": nemesis.hammer_time(
                "cockroach",
                targeter=lambda nodes: random.sample(list(nodes),
                                                     min(n, len(nodes)))),
            "clocks": False}


def fs_break(pct: int | None = None) -> dict:
    """EIO storms on the --store dir via the faultfs FUSE layer —
    needs the DB wrapped in FaultFsDB (basic_test wires that when
    --nemesis/--nemesis2 name an fs-break mode); this entry is only
    the switch flipper (charybdefs.clj:72-85 semantics)."""
    from ..nemesis import fsfault

    return {**nemesis_single_gen(),
            "name": "fs-break" + ("-1pct" if pct == 1 else ""),
            "client": fsfault.fs_fault_nemesis(
                backend="fuse", manage_mounts=False,
                default_mode=("break-one-percent" if pct == 1
                              else "break-all")),
            "clocks": False}


def startkill(n: int = 1) -> dict:
    """Kill and restart cockroach on n random nodes
    (nemesis.clj:135-142)."""
    return {**nemesis_single_gen(),
            "name": "startkill" + (str(n) if n > 1 else ""),
            "client": nemesis.node_start_stopper(
                lambda nodes: random.sample(list(nodes),
                                            min(n, len(nodes))),
                kill_node, start_node),
            "clocks": False}


class Slowing(nemesis.Nemesis):
    """Wraps a nemesis: slows the network while the inner nemesis is
    active, restores speed on stop (nemesis.clj:152-174)."""

    def __init__(self, nem, dt: float):
        self.nem = nem
        self.dt = dt

    def _net(self, test):
        return test.get("net") or net_mod.noop

    def setup(self, test):
        self._net(test).fast(test)
        self.nem.setup(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            self._net(test).slow(test)
            return self.nem.invoke(test, op)
        if op.f == "stop":
            try:
                return self.nem.invoke(test, op)
            finally:
                self._net(test).fast(test)
        return self.nem.invoke(test, op)

    def teardown(self, test):
        self._net(test).fast(test)
        self.nem.teardown(test)


class Restarting(nemesis.Nemesis):
    """Wraps a nemesis: after its :stop completes, restarts cockroach
    on every node (nemesis.clj:176-199)."""

    def __init__(self, nem):
        self.nem = nem

    def setup(self, test):
        self.nem.setup(test)
        return self

    def invoke(self, test, op):
        out = self.nem.invoke(test, op)
        if op.f == "stop":
            from ..util import real_pmap

            def restart(node):
                try:
                    start_node(test, node)
                    return "started"
                except Exception as e:  # noqa: BLE001
                    return str(e)

            statuses = real_pmap(restart, test["nodes"])
            return out.with_(value=[out.value, statuses])
        return out

    def teardown(self, test):
        self.nem.teardown(test)


class BumpTime(nemesis.Nemesis):
    """On :start, bump clocks by dt seconds on a random half of the
    nodes; on :stop, reset all clocks (nemesis.clj:231-253)."""

    def __init__(self, dt: float):
        self.dt = dt

    def setup(self, test):
        remote = test["remote"]
        for node in test["nodes"]:
            clock_tools(test).install(remote, node)
            clock_tools(test).reset_time(remote, node)
        return self

    def invoke(self, test, op):
        remote = test["remote"]
        if op.f == "start":
            bumped = {}
            for node in test["nodes"]:
                if random.random() < 0.5:
                    clock_tools(test).bump_time(remote, node, self.dt * 1000)
                    bumped[node] = self.dt
                else:
                    bumped[node] = 0
            return op.with_(value=bumped)
        if op.f == "stop":
            for node in test["nodes"]:
                clock_tools(test).reset_time(remote, node)
            return op.with_(value="clocks-reset")
        return op

    def teardown(self, test):
        remote = test["remote"]
        for node in test["nodes"]:
            clock_tools(test).reset_time(remote, node)


def skew(name: str, offset: float, slow: float | None = None) -> dict:
    """A clock-skew nemesis, optionally wrapped in slowing
    (nemesis.clj:255-268)."""
    client = Restarting(BumpTime(offset))
    if slow is not None:
        client = Slowing(client, slow)
    return {**nemesis_single_gen(), "name": name, "client": client,
            "clocks": True}


def small_skews() -> dict:
    return skew("small-skews", 0.100)


def subcritical_skews() -> dict:
    return skew("subcritical-skews", 0.200)


def critical_skews() -> dict:
    return skew("critical-skews", 0.250)


def big_skews() -> dict:
    return skew("big-skews", 0.5, slow=0.5)


def huge_skews() -> dict:
    return skew("huge-skews", 5, slow=5)


class StrobeTime(nemesis.Nemesis):
    """Strobe the clock between now and delta ms ahead for duration s
    (nemesis.clj:201-223)."""

    def __init__(self, delta_ms: float, period_ms: float, duration_s: float):
        self.delta_ms = delta_ms
        self.period_ms = period_ms
        self.duration_s = duration_s

    def setup(self, test):
        remote = test["remote"]
        for node in test["nodes"]:
            clock_tools(test).install(remote, node)
            clock_tools(test).reset_time(remote, node)
        return self

    def invoke(self, test, op):
        remote = test["remote"]
        if op.f == "start":
            for node in test["nodes"]:
                clock_tools(test).strobe_time(remote, node, self.delta_ms,
                                         self.period_ms, self.duration_s)
            return op.with_(value="strobed")
        return op.with_(value=None)

    def teardown(self, test):
        remote = test["remote"]
        for node in test["nodes"]:
            clock_tools(test).reset_time(remote, node)


def strobe_skews() -> dict:
    import itertools

    return {
        "during": gen.seq(itertools.cycle([
            {"type": "info", "f": "start"},
            {"type": "info", "f": "stop"},
        ])),
        "final": gen.once({"type": "info", "f": "stop"}),
        "name": "strobe-skews",
        "client": Restarting(StrobeTime(200, 10, 10)),
        "clocks": True,
    }


def update_keyrange(test, table: str, k) -> None:
    """Record that the test touched (table, k), so the split nemesis
    can split just-written ranges (cockroach.clj:121-128). A test map
    without a keyrange simply doesn't track (the reference throws; here
    workloads always install one via the shared scaffold)."""
    kr = test.get("keyrange")
    if kr is None:
        return
    with kr["lock"]:
        kr["keys"].setdefault(table, set()).add(k)


class SplitNemesis(nemesis.Nemesis):
    """Splits a table range just below a recently written key
    (nemesis.clj:273-308): pick a not-yet-split key from the test's
    keyrange and issue `ALTER TABLE .. SPLIT AT VALUES (k)` on a
    random node; re-splitting is reported, not an error."""

    def __init__(self):
        self._already: dict = {}

    def invoke(self, test, op: Op) -> Op:
        kr = test.get("keyrange")
        if kr is None:
            return op.with_(type="info", value="no-keyrange")
        with kr["lock"]:
            candidates = [
                (t, k) for t, ks in kr["keys"].items()
                for k in ks - self._already.get(t, set())]
        if not candidates:
            return op.with_(type="info", value="nothing-to-split")
        table, k = random.choice(candidates)
        node = random.choice(list(test["nodes"]))
        wrapper = None
        try:
            # inside the try: conn_wrapper connects eagerly, and a
            # down node (e.g. split composed with start-kill) must
            # complete as an error value, not crash the nemesis worker
            wrapper = conn_wrapper(test, node)
            lit = k if isinstance(k, (int, float)) else f"'{k}'"
            with wrapper.with_conn() as c:
                c.query(f"alter table {table} split at values ({lit})")
            self._already.setdefault(table, set()).add(k)
            return op.with_(type="info", value=["split", table, k])
        except pg_proto.PgError as e:
            if "already split" in str(e):
                self._already.setdefault(table, set()).add(k)
                return op.with_(type="info",
                                value=["already-split", table, k])
            return op.with_(type="info", value=["error", str(e)])
        except (OSError, TimeoutError) as e:
            return op.with_(type="info", value=["error", str(e)])
        finally:
            if wrapper is not None:
                wrapper.close()


def splits(interval: float = 2.0) -> dict:
    """The split-nemesis package (nemesis.clj:310-316). A bare op dict
    coerces to a repeat-forever generator under gen.delay. `interval`
    paces the splits; note that under gen.mix a slow member's delay
    runs inside op() and starves its siblings' share of a bounded
    window (same hazard as the reference's generator.clj:337-349), so
    tests composing this package should shrink it."""
    return {
        "during": gen.delay(interval, {"type": "info", "f": "split"}),
        "final": None,
        "name": "splits",
        "client": SplitNemesis(),
        "clocks": False,
        "fs": ("split",),  # compose routing vocabulary
    }


def _named_f_gen(name: str, inner) -> gen.Generator:
    """Wrap a nemesis's generator so emitted fs become (name, f) tuples
    for compose routing (nemesis.clj:84-103)."""
    return gen.f_map(lambda f, name=name: (name, f), inner)


class _FMap(dict):
    """A dict usable as a nemesis.compose routing key (hashable by
    identity; compose only reads it)."""

    __hash__ = object.__hash__


def compose_nemeses(nemeses: list) -> dict:
    """Merge named-nemesis maps: ops carry (name, inner-f) fs; the
    composed client routes each back to its owner via an outer-f →
    inner-f map (nemesis.clj:61-106)."""
    nemeses = [n for n in nemeses if n is not None]
    routes = {}
    for nem in nemeses:
        name = nem["name"]
        # a package may declare its op vocabulary; start/stop is the
        # partition-style default (splits emit f="split")
        fs = nem.get("fs", ("start", "stop"))
        routes[_FMap({(name, f): f for f in fs})] = nem["client"]
    return {
        "name": "+".join(n["name"] for n in nemeses),
        "clocks": any(n.get("clocks") for n in nemeses),
        "client": nemesis.compose(routes),
        "during": gen.mix([_named_f_gen(n["name"], n["during"])
                           for n in nemeses]),
        "final": gen.concat(*[_named_f_gen(n["name"], n["final"])
                              for n in nemeses]),
    }


def nemeses() -> dict:
    """Named registry for --nemesis (runner.clj:21-41)."""
    return {
        "none": none,
        "parts": parts,
        "majority-ring": majring,
        "start-stop": lambda: startstop(1),
        "start-stop-2": lambda: startstop(2),
        "start-kill": lambda: startkill(1),
        "start-kill-2": lambda: startkill(2),
        "small-skews": small_skews,
        "subcritical-skews": subcritical_skews,
        "critical-skews": critical_skews,
        "big-skews": big_skews,
        "huge-skews": huge_skews,
        "strobe-skews": strobe_skews,
        "split": splits,
        "fs-break": fs_break,
        "fs-break-1pct": lambda: fs_break(1),
    }


def resolve_nemesis(opts: dict) -> dict:
    """Build the (possibly composed) nemesis map from --nemesis /
    --nemesis2 options (runner.clj:43-52)."""
    registry = nemeses()
    n1 = registry[opts.get("nemesis") or "none"]()
    n2_name = opts.get("nemesis2")
    if n2_name:
        return compose_nemeses([n1, registry[n2_name]()])
    return n1


# ---------------------------------------------------------------------------
# Shared test scaffold (cockroach.clj:83-164)


def basic_test(opts: dict, workload: dict) -> dict:
    """Merge the suite scaffold, a workload map {client, during,
    final_client?, checker, model?}, and CLI opts into a runnable test
    map (cockroach.clj:83-164): client ops bracketed by the nemesis's
    during/final generators, then any final client phase after heal +
    quiescence."""
    from ..testlib import noop_test

    nem = resolve_nemesis(opts)
    time_limit = opts.get("time_limit", 60)
    generator = gen.time_limit(
        time_limit,
        gen.nemesis(nem["during"], workload["during"]),
    )
    phases = [generator,
              gen.log("Stopping nemesis"),
              gen.nemesis(nem["final"])]
    if workload.get("final_client") is not None:
        phases += [
            gen.log("Waiting for quiescence"),
            gen.sleep(opts.get("quiesce", 30)),
            gen.clients(workload["final_client"]),
        ]
    db_ = CockroachDB(tarball=opts.get("tarball"))
    from .common import FSFAULT_NEMESIS_NAMES

    if {opts.get("nemesis"), opts.get("nemesis2")} \
            & set(FSFAULT_NEMESIS_NAMES):
        # cockroach is a statically linked Go binary: FS faults need
        # the FUSE backend, mounted between install and start. The
        # switch flipper (the registry entry above) and this wrapper
        # both resolve opt_dir from the test map's fsfault_opt_dir.
        from ..nemesis import fsfault

        db_ = fsfault.FaultFsDB(db_, data_dir)
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": f"cockroachdb {workload['name']} {nem['name']}",
            "os": osdist.debian,
            "db": db_,
            "client": workload["client"],
            "nemesis": nem["client"],
            "generator": gen.phases(*phases),
            "checker": workload["checker"],
            "model": workload.get("model"),
            # written-key tracker for the split nemesis
            # (cockroach.clj:112-128's :keyrange atom)
            "keyrange": {"lock": threading.Lock(), "keys": {}},
        }
    )
    return test
