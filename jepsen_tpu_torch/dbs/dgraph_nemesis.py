"""Dgraph failure modes (reference:
dgraph/src/jepsen/dgraph/nemesis.clj:1-180): alpha
killer/fixer, zero killer, the tablet mover, clock skews, and
partitions, composed behind one routed nemesis with a generator built
from option flags.

In the hermetic suite both alpha and zero map onto the single dgraph
sim daemon; the tablet mover drives the sim's /state + /moveTablet
surface, which reshuffles predicate → group assignments the same way
zero's API does.

The port's copy of `jepsen_tpu/dbs/dgraph_nemesis.py`. `BumpTimeSkew`
drives the native clock tools of `nemesis/time.py` on each node, or the
test map's "clock_tools" (an object with the same `bring_up`,
`bump_time` and `try_reset`) where it has one: `dgraph_sim.local_test_fn`
records them there (`simbase.RecordingClockTools`), since the simulated
nodes share this machine's clock."""

from __future__ import annotations

import json
import logging
import random
import urllib.parse
import urllib.request

from .. import generator as gen, nemesis, trace, util
from ..control import util as cu
from ..history import Op
from ..nemesis import Nemesis
from ..util import random_nonempty_subset
from .common import clock_tools

log = logging.getLogger("jepsen_tpu_torch.dbs.dgraph")


def _stop_daemon(db):
    def stop(test, node):
        cu.stop_daemon(test["remote"], node,
                       f"{db.suite.dir(test, node)}/{db.pid_name}")
        return "killed"

    return stop


def _start_daemon(db):
    def start(test, node):
        db.start(test, node)
        return "started"

    return start


def alpha_killer(db) -> Nemesis:
    """:start kills alpha on EVERY node, :stop revives
    (nemesis.clj:15-21 — the identity targeter is deliberate)."""
    return nemesis.node_start_stopper(
        lambda nodes: nodes, _stop_daemon(db), _start_daemon(db))


def zero_killer(db) -> Nemesis:
    """:start kills zero on a random nonempty subset
    (nemesis.clj:41-47)."""
    return nemesis.node_start_stopper(
        random_nonempty_subset, _stop_daemon(db), _start_daemon(db))


class AlphaFixer(Nemesis):
    """Speculative restarts: alpha likes to fall over if zero isn't
    around on startup (nemesis.clj:23-39)."""

    def __init__(self, db):
        self.db = db

    def invoke(self, test, op: Op) -> Op:
        remote = test["remote"]
        targets = random_nonempty_subset(list(test["nodes"]))

        def fix(node):
            pidfile = (f"{self.db.suite.dir(test, node)}/"
                       f"{self.db.pid_name}")
            if cu.daemon_running(remote, node, pidfile):
                return "already-running"
            self.db.start(test, node)
            return "restarted"

        return op.with_(type="info",
                        value=dict(zip(targets,
                                       util.real_pmap(fix, targets))))


class TabletMover(Nemesis):
    """Moves tablets (predicates) between groups at random via zero's
    state/moveTablet API (nemesis.clj:49-86)."""

    def __init__(self, suite):
        self.suite = suite

    def _get_state(self, test, node) -> dict:
        url = (f"http://{self.suite.host(test, node)}:"
               f"{self.suite.port(test, node)}/state")
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.load(resp)

    def _move(self, test, node, pred: str, group: str) -> None:
        q = urllib.parse.urlencode({"tablet": pred, "group": group})
        url = (f"http://{self.suite.host(test, node)}:"
               f"{self.suite.port(test, node)}/moveTablet?{q}")
        req = urllib.request.Request(url, method="POST", data=b"{}")
        with urllib.request.urlopen(req, timeout=5) as resp:
            resp.read()

    def invoke(self, test, op: Op) -> Op:
        with trace.with_trace("nemesis.tablet-mover.invoke"):
            node = random.choice(list(test["nodes"]))
            try:
                state = self._get_state(test, node)
            except OSError:
                return op.with_(type="info", value="timeout")
            groups_map = state.get("groups") or {}
            groups = list(groups_map)
            tablets = [t for g in groups_map.values()
                       for t in (g.get("tablets") or {}).values()]
            random.shuffle(tablets)
            moved = {}
            for tablet in tablets:
                pred = tablet["predicate"]
                group = str(tablet["groupId"])
                group2 = random.choice(groups) if groups else group
                if group != group2:
                    log.info("Moving %s from %s to %s",
                             pred, group, group2)
                    try:
                        self._move(test, node, pred, group2)
                    except OSError:
                        moved[pred] = "timeout"
                        continue
                    moved[pred] = [group, group2]
            return op.with_(type="info", value=moved)


class BumpTimeSkew(Nemesis):
    """On :start, bump the clock by dt ms on a random half of the
    nodes; on :stop, reset all clocks (nemesis.clj:88-112)."""

    def __init__(self, dt_ms: int):
        self.dt_ms = dt_ms

    def setup(self, test):
        # Shared clock bring-up (install native bump-time tool, stop
        # ntpd, best-effort reset) — without the install the first
        # :start would crash on a missing /opt binary.
        clock_tools(test).bring_up(test)
        return self

    def invoke(self, test, op: Op) -> Op:
        remote = test["remote"]
        if op.f == "start":
            def bump(node):
                if random.random() < 0.5:
                    clock_tools(test).bump_time(remote, node, self.dt_ms)
                    return self.dt_ms
                return 0

            nodes = list(test["nodes"])
            return op.with_(type="info",
                            value=dict(zip(nodes,
                                           util.real_pmap(bump, nodes))))
        if op.f == "stop":
            for node in test["nodes"]:
                clock_tools(test).try_reset(remote, node)
            return op.with_(type="info", value="reset")
        raise ValueError(f"bump-time can't handle {op.f!r}")

    def teardown(self, test):
        for node in test["nodes"]:
            clock_tools(test).try_reset(test["remote"], node)


SKEWS = {"huge": 7500, "big": 2000, "small": 250, "tiny": 100}


def skew(opts: dict) -> BumpTimeSkew:
    """Named skew magnitudes (nemesis.clj:114-120)."""
    return BumpTimeSkew(SKEWS.get(opts.get("skew"), 0))


class _FMap(dict):
    """A dict usable as a compose routing key (hashable by identity)."""

    __hash__ = object.__hash__


def full_nemesis(db, opts: dict) -> Nemesis:
    """The enabled failure modes behind one routed nemesis
    (nemesis.clj:122-138 composes every mode; here only flagged modes
    join the composition so their setup hooks — e.g. the partitioners'
    net heal — only run when that fault surface is in play)."""
    routes: dict = {}
    if opts.get("fix_alpha"):
        routes[frozenset({"fix-alpha"})] = AlphaFixer(db)
    if opts.get("kill_alpha"):
        routes[_FMap({"kill-alpha": "start",
                      "restart-alpha": "stop"})] = alpha_killer(db)
    if opts.get("kill_zero"):
        routes[_FMap({"kill-zero": "start",
                      "restart-zero": "stop"})] = zero_killer(db)
    if opts.get("move_tablet"):
        routes[frozenset({"move-tablet"})] = TabletMover(db.suite)
    if opts.get("partition_halves"):
        routes[_FMap({"start-partition-halves": "start",
                      "stop-partition-halves": "stop"})] = \
            nemesis.partition_random_halves()
    if opts.get("partition_ring"):
        routes[_FMap({"start-partition-ring": "start",
                      "stop-partition-ring": "stop"})] = \
            nemesis.partition_majorities_ring()
    if opts.get("skew_clock"):
        routes[_FMap({"start-skew": "start",
                      "stop-skew": "stop"})] = skew(opts)
    return nemesis.compose(routes)


def _op(f: str) -> dict:
    return {"type": "info", "f": f}


FLAG_CYCLES = [
    ("kill_alpha", ["kill-alpha", "restart-alpha"]),
    ("kill_zero", ["kill-zero", "restart-zero"]),
    ("fix_alpha", ["fix-alpha"]),
    ("partition_halves", ["start-partition-halves",
                          "stop-partition-halves"]),
    ("partition_ring", ["start-partition-ring", "stop-partition-ring"]),
    ("skew_clock", ["start-skew", "stop-skew"]),
    ("move_tablet", ["move-tablet"]),
]


def full_generator(opts: dict) -> gen.Generator | None:
    """A mix of op cycles for each enabled failure mode, staggered by
    `interval` (nemesis.clj:140-167)."""
    import itertools

    gens = [gen.seq(itertools.cycle([_op(f) for f in fs]))
            for flag, fs in FLAG_CYCLES if opts.get(flag)]
    if not gens:
        return None
    mixed = gen.mix(gens)
    interval = opts.get("interval", 10)
    return gen.stagger(interval, mixed) if interval > 0 else mixed


FINAL_FS = [("partition_halves", "stop-partition-halves"),
            ("partition_ring", "stop-partition-ring"),
            ("skew_clock", "stop-skew"),
            ("kill_zero", "restart-zero"),
            ("kill_alpha", "restart-alpha")]


def final_generator(opts: dict) -> gen.Generator | None:
    """Heal everything at the end, slightly delayed
    (nemesis.clj:169-180)."""
    fs = [f for flag, f in FINAL_FS if opts.get(flag)]
    if not fs:
        return None
    final = gen.seq([_op(f) for f in fs])
    delay = opts.get("final_delay", 5)
    return gen.delay(delay, final) if delay > 0 else final


def package(db, opts: dict) -> dict | None:
    """{'nemesis', 'generator', 'final_generator'} when any failure
    flag is set, else None (the suite keeps its default)."""
    generator = full_generator(opts)
    if generator is None:
        return None
    return {"nemesis": full_nemesis(db, opts),
            "generator": generator,
            "final_generator": final_generator(opts)}
