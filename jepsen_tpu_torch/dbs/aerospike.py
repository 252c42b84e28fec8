"""Aerospike test suite: generation-CAS register and counter workloads
(reference: aerospike/src/aerospike/{core,support,
cas_register,counter}.clj — the reference rides the Java client; this
speaks the wire subset in aerospike_proto).

Workloads:
  - cas-register: read returns (generation, value); cas re-writes with
    GENERATION_EQUAL — result code 3 is a definite :fail (someone else
    won the race); writes are unconditional.
  - counter: unconditional add-like writes of a running total plus
    reads; the counter checker bounds the final value by acknowledged
    increments.

The port's copy of `jepsen_tpu/dbs/aerospike.py`. The cas-register
workload's checker is `linearizable` on the one unkeyed register
history (`models.CASRegister()`), which `auto` routes to K1
(`ops/csrc/wgl_vec.cu`, up to 1,024 entries), K5 (`ops/csrc/wgl_row.cu`,
up to 4,064) or K2 (`ops/csrc/wgl_search.cu`), or to the native search
below the committed bars; the test map's `device` (the CLI's `--device`;
None = the card) goes to that checker. The counter and set checkers run
on the host. `aerospike_sim.local_test_fn` runs the suite on simulated
nodes over `LocalRemote`."""

from __future__ import annotations

import itertools
import logging
import random
import socket
import time

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, generator as gen, independent, models, \
    nemesis, osdist
from ..control import util as cu
from ..history import Op
from . import aerospike_proto as ap
from .common import (ArchiveDB, ArchiveKillNemesis, SuiteCfg,
                     ready_gated_final)

log = logging.getLogger("jepsen_tpu_torch.dbs.aerospike")

PORT = 3000
KEY = "jepsen"


_suite = SuiteCfg("aerospike", PORT, "/opt/aerospike")
node_host = _suite.host
node_port = _suite.port


class AerospikeDB(ArchiveDB):
    """asd per node (support.clj's install/configure/start)."""

    binary = "asd"
    log_name = "aerospike.log"
    pid_name = "aerospike.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        return ["--port", str(node_port(test, node))]

    def log_files(self, test, node) -> list:
        # netem.log is PauseNemesis(:net)'s chain output — the only
        # post-mortem evidence when a backgrounded `tc qdisc add` fails
        # (we can't surface errors live; see PauseNemesis._pause).
        return super().log_files(test, node) + [
            f"{_suite.dir(test, node)}/netem.log"]

    def probe_ready(self, test, node) -> bool:
        conn = ap.AerospikeConn(node_host(test, node),
                                node_port(test, node),
                                timeout=2.0, connect_timeout=2.0)
        try:
            conn.get("__probe__")
            return True
        except ap.AerospikeError:
            return True  # server answered: protocol is up
        finally:
            conn.close()


class CasRegisterClient(client.Client):
    """Register via generation CAS (aerospike's cas-register
    workload): read = get(gen, value); cas = read then put with
    GENERATION_EQUAL; generation mismatch (code 3) is a definite
    :fail."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        return CasRegisterClient(
            ap.AerospikeConn(node_host(test, node),
                             node_port(test, node)))

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                _gen, bins = self.conn.get(KEY)
                return op.with_(
                    type="ok",
                    value=bins.get("value") if bins else None)
            if op.f == "write":
                self.conn.put(KEY, {"value": op.value})
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                generation, bins = self.conn.get(KEY)
                if bins is None or bins.get("value") != old:
                    return op.with_(type="fail")
                try:
                    self.conn.put(KEY, {"value": new},
                                  expected_generation=generation)
                    return op.with_(type="ok")
                except ap.AerospikeError as e:
                    if e.code == ap.RESULT_GENERATION:
                        return op.with_(type="fail",
                                        error="generation-mismatch")
                    raise
            raise ValueError(f"unknown op {op.f!r}")
        except ap.AerospikeError as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=f"code-{e.code}")
        except (socket.timeout, TimeoutError):
            return op.with_(
                type="fail" if op.f == "read" else "info",
                error="timeout")
        except (ConnectionError, OSError) as e:
            return op.with_(
                type="fail" if op.f == "read" else "info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class CounterClient(client.Client):
    """Counter via read-increment-write with generation CAS retried
    until it lands (aerospike's counter workload shape); emits :add ops
    with the delta and :read ops with the observed total, for the
    framework counter checker."""

    RETRIES = 16

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        return CounterClient(
            ap.AerospikeConn(node_host(test, node),
                             node_port(test, node)))

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "read":
                _gen, bins = self.conn.get(KEY)
                return op.with_(
                    type="ok",
                    value=bins.get("count", 0) if bins else 0)
            if op.f == "add":
                for _ in range(self.RETRIES):
                    generation, bins = self.conn.get(KEY)
                    current = bins.get("count", 0) if bins else 0
                    try:
                        self.conn.put(
                            KEY, {"count": current + op.value},
                            expected_generation=generation or 0)
                        return op.with_(type="ok")
                    except ap.AerospikeError as e:
                        if e.code != ap.RESULT_GENERATION:
                            raise
                return op.with_(type="fail", error="retries-exhausted")
            raise ValueError(f"unknown op {op.f!r}")
        except ap.AerospikeError as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=f"code-{e.code}")
        except (socket.timeout, TimeoutError, ConnectionError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class SetClient(client.Client):
    """A set as CAS-free string appends on a single bin per key
    (aerospike/set.clj:11-45): add appends " v", read splits the bin
    into a sorted set of ints. Values are independent (k, v) tuples."""

    def __init__(self, conn=None):
        self.conn = conn

    def open(self, test, node):
        return SetClient(
            ap.AerospikeConn(node_host(test, node),
                             node_port(test, node)))

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        try:
            if op.f == "read":
                _gen, bins = self.conn.get(("set", k))
                raw = (bins or {}).get("value") or ""
                vals = sorted(int(x) for x in raw.split() if x)
                return op.with_(type="ok",
                                value=independent.tuple_(k, vals))
            if op.f == "add":
                self.conn.append(("set", k), {"value": f" {v}"})
                return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except ap.AerospikeError as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=f"code-{e.code}")
        except (socket.timeout, TimeoutError):
            return op.with_(
                type="fail" if op.f == "read" else "info",
                error="timeout")
        except (ConnectionError, OSError) as e:
            return op.with_(
                type="fail" if op.f == "read" else "info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


class KillNemesis(ArchiveKillNemesis):
    """The reference's bounded-dead-set killer
    (aerospike/src/aerospike/nemesis.clj:17-58): the generic ArchiveDB
    kill/restart plus aerospike's :revive/:recluster maintenance
    commands (issued best-effort via asinfo at the node's address)."""

    def extra_op(self, test, node, op):
        if op.f in ("revive", "recluster"):
            r = test["remote"].exec(
                node,
                ["asinfo", "-h", node_host(test, node),
                 "-p", str(node_port(test, node)), "-v", op.f],
                check=False)
            return "ok" if getattr(r, "ok", False) else "not-running"
        return super().extra_op(test, node, op)


def kill_nemesis(db: "AerospikeDB", max_dead: int = 2) -> KillNemesis:
    return KillNemesis(db, max_dead)


class PauseNemesis(nemesis.Nemesis):
    """The reference's pause nemesis (aerospike/src/aerospike/
    pause.clj:17-85): pause a bounded set of "master" nodes so
    in-flight writes get trapped in their memory, then revive. Two
    modes:

      process — SIGSTOP the asd process; resume SIGCONTs it
                (pause.clj:44-45,75). Targeted by pidfile rather than
                killall so hermetic multi-node-on-one-host clusters
                only freeze the victim's daemon.
      net     — inject a large netem delay AND spawn a self-restoring
                mini-daemon (`sleep N; tc qdisc del`) in the
                background, because the delay also severs our own
                control connection — the reference's "terrible hack"
                (pause.clj:46-56). Resume is a no-op: the node heals
                itself (pause.clj:76).

    masters_limit bounds CONCURRENTLY paused nodes (pause.clj:25-27).
    Speaks pause/resume and the shared start/stop aliases, so the
    suites' standard nemesis generator drives it unchanged. A paused
    node's client ops time out into :info (indeterminate) — the
    history stays checkable because set/linearizability semantics
    treat those as concurrent forever."""

    def __init__(self, db: "AerospikeDB", mode: str = "process",
                 masters_limit: int = 1, pause_delay: float = 30.0):
        assert mode in ("process", "net"), mode
        self.db = db
        self.mode = mode
        self.masters_limit = masters_limit
        self.pause_delay = pause_delay
        # how long to wait after backgrounding the netem chain for the
        # delay to take effect (tests zero this)
        self.settle_s = 1.0
        self.paused: set = set()

    def _pidfile(self, test, node) -> str:
        d = _suite.dir(test, node)
        return f"{d}/{self.db.pid_name}"

    def _pause(self, test, node) -> str:
        remote = test["remote"]
        if self.mode == "process":
            remote.exec(
                node,
                ["bash", "-c",
                 f"kill -STOP $(cat {self._pidfile(test, node)})"],
                sudo=_suite.sudo(test))
            return "paused"
        delay_ms = int(self.pause_delay * 1000)
        hold_s = int(self.pause_delay) + 1
        # The ENTIRE add/sleep/del chain is the backgrounded
        # self-restoring mini-daemon: the netem delay severs our own
        # control connection the instant `tc qdisc add` lands, so even
        # the add must be in the subshell — a foreground add would trap
        # this exec's own reply behind the delay it just installed
        # (pause.clj:46-56 backgrounds the whole chain the same way).
        # Consequence (inherent to the reference's "terrible hack"): an
        # add failure can't be surfaced — once the delay lands we can't
        # talk to the node until it self-heals, so there is no useful
        # moment to verify. Chain output goes to netem.log in the suite
        # dir (snarfed with the other logs) for post-mortem instead.
        chain_log = f"{_suite.dir(test, node)}/netem.log"
        remote.exec(
            node,
            ["nohup", "bash", "-c",
             f"(tc qdisc add dev eth0 root netem delay {delay_ms}ms 1ms "
             f"distribution normal; "
             f"sleep {hold_s}; tc qdisc del dev eth0 root) "
             f"</dev/null >>{chain_log} 2>&1 &"],
            sudo=_suite.sudo(test))
        return "net-delayed"

    def _resume(self, test, node) -> str:
        if self.mode == "process":
            test["remote"].exec(
                node,
                ["bash", "-c",
                 f"kill -CONT $(cat {self._pidfile(test, node)})"],
                sudo=_suite.sudo(test))
            return "resumed"
        return "self-restoring"  # pause.clj:76 — :net resume is nil

    def invoke(self, test, op: Op) -> Op:
        if op.f in ("pause", "start"):
            budget = max(self.masters_limit - len(self.paused), 0)
            if op.value:
                # explicit targets are still bounded: masters_limit
                # caps CONCURRENT pauses however the op arrives
                targets = [n for n in op.value
                           if n not in self.paused][:budget]
            else:
                candidates = [n for n in test["nodes"]
                              if n not in self.paused]
                targets = random.sample(
                    candidates, min(budget, len(candidates)))
            out = {}
            for node in targets:
                out[node] = self._pause(test, node)
                self.paused.add(node)
            # One settle for the whole batch (not per node — that would
            # stagger the "concurrent" pause window by settle_s per
            # node): give the backgrounded netem adds a beat to land
            # before reporting the nodes paused.
            if self.mode == "net" and out and self.settle_s:
                time.sleep(self.settle_s)
            return op.with_(type="info", value=out or "at-limit")
        if op.f in ("resume", "stop"):
            out = {}
            for node in sorted(self.paused):
                out[node] = self._resume(test, node)
            self.paused.clear()
            return op.with_(type="info", value=out or "none-paused")
        raise ValueError(f"unknown nemesis op {op.f!r}")

    def teardown(self, test):
        for node in sorted(self.paused):
            try:
                self._resume(test, node)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
        self.paused.clear()


def pause_nemesis(db: "AerospikeDB", mode: str = "process",
                  masters_limit: int = 1) -> PauseNemesis:
    return PauseNemesis(db, mode, masters_limit)


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def add(test, process):
    return {"type": "invoke", "f": "add", "value": 1}


def workloads(opts: dict) -> dict:
    return {
        "cas-register": {
            "client": CasRegisterClient(),
            "during": gen.stagger(opts.get("stagger", 0.05),
                                  gen.mix([r, w, cas, cas])),
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "linear": checker_mod.linearizable(
                    device=opts.get("device")),
            }),
        },
        "counter": {
            "client": CounterClient(),
            "during": gen.stagger(opts.get("stagger", 0.05),
                                  gen.mix([add, add, r])),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "counter": checker_mod.counter(),
            }),
        },
        "set": _set_workload(opts),
    }


def _set_workload(opts: dict) -> dict:
    """CAS-free appends across independent keys, 5 clients per key,
    with a deferred final read of every key that was touched
    (aerospike/set.clj:47-71 — the max-key atom + derefer dance)."""
    import itertools
    import threading

    seen_keys: list = []
    lock = threading.Lock()

    def fgen(k):
        with lock:
            seen_keys.append(k)
        ctr = itertools.count()  # per-key, captured by the closure

        def add_op(test, process):
            return {"type": "invoke", "f": "add", "value": next(ctr)}

        return gen.limit(opts.get("ops_per_key", 200),
                         gen.stagger(opts.get("stagger", 0.05), add_op))

    # derefer calls its thunk per op request; the reference wraps the
    # final generator in a delay (set.clj:62-71) so it's built ONCE at
    # first deref — memoize or every request builds a fresh generator
    # and the final phase never exhausts.
    final_cache: list = []

    def final():
        with lock:
            if not final_cache:
                ks = sorted(seen_keys)
                final_cache.append(independent.concurrent_generator(
                    5, ks,
                    lambda k: gen.each(
                        lambda: gen.once(
                            {"type": "invoke", "f": "read"}))))
            return final_cache[0]

    return {
        "client": SetClient(),
        "during": independent.concurrent_generator(
            5, itertools.count(), fgen),
        "final": gen.derefer(final),
        "checker": checker_mod.compose({
            "perf": checker_mod.perf_checker(),
            "sets": independent.checker(checker_mod.set_checker()),
        }),
    }


def aerospike_test(opts: dict) -> dict:
    from ..testlib import noop_test

    wl = workloads(opts)[opts.get("workload", "cas-register")]
    db_ = AerospikeDB(archive_url=opts.get("archive_url"))
    generator = gen.time_limit(
        opts.get("time_limit", 60),
        gen.nemesis(gen.start_stop(10, 10), wl["during"]),
    )
    if wl.get("final") is not None:
        generator = gen.phases(
            generator,
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(opts.get("quiesce", 10)),
            ready_gated_final(db_, gen.clients(wl["final"]), opts),
        )
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": f"aerospike {opts.get('workload', 'cas-register')}",
            "os": osdist.debian,
            "db": db_,
            "client": wl["client"],
            "nemesis": cmn.pick_nemesis(db_, opts, extra={
                "pause": lambda: PauseNemesis(db_, "process"),
                "pause-net": lambda: PauseNemesis(db_, "net"),
            }),
            "model": wl.get("model"),
            "generator": generator,
            "checker": wl["checker"],
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p, names=cmn.NEMESIS_NAMES + ("pause", "pause-net"))
    p.add_argument("--workload", default="cas-register",
                   choices=["cas-register", "counter", "set"])
    p.add_argument("--archive-url", dest="archive_url", default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(aerospike_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
