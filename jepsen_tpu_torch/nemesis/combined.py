"""Composable fault packages (reference: jepsen.nemesis.combined,
nemesis/combined.clj).

A NemesisPackage bundles everything one fault family needs to ride in a
test: the nemesis that applies the fault, the generator that schedules
its ops during the main phase, a FINAL generator that provably revokes
the fault once the main phase ends, perf-plot metadata, and the
fault/heal op names the recovery checker audits. `compose_packages`
merges any number of packages into one: ops route to the right nemesis
by :f (nemesis.Compose), the schedules interleave through a seeded
`gen.mix`, and the heal phases concatenate so every family is revoked
before analysis.

Determinism contract: every random draw — which grudge, which targets,
which corruption offset, which package goes next — comes from ONE
`random.Random` threaded through the builders, and all draws happen on
the single nemesis worker thread. Two runs with the same seed and a
count-bounded schedule (`fault_ops`) produce byte-identical fault
histories.

The recovery side of the contract lives in core.run (which appends the
final generator and a stability window of plain client ops after the
main phase, via test["final_generator"] / test["stability_period"]) and
checker.recovery (which fails the test if any fault family's last fault
op is never followed by a clean heal, or the post-heal window contains
no successful client ops).

The port's copy of `jepsen_tpu/nemesis/combined.py`: it imports nothing
of `jepsen_tpu`, and the same options and seed give byte-identical
schedule documents in both packages.
"""

from __future__ import annotations

import random as _random_mod
import threading
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

from .. import db as db_mod
from .. import generator as gen_mod
from ..util import majority
from . import (
    ClockScrambler,
    Nemesis,
    Partitioner,
    bisect,
    bridge,
    complete_grudge,
    compose,
    log,
    majorities_ring,
    split_one,
)

#: every fault family a package builder exists for
FAULT_FAMILIES = ("partition", "clock", "kill", "pause", "corruption",
                  "packet")

#: node-spec targeter names accepted by db_nodes
NODE_SPECS = ("one", "minority", "majority", "primaries", "all")


class _FDict(dict):
    """A dict usable as a nemesis.Compose key (outer-f -> inner-f rename
    map); hashable by identity, like the reference's persistent maps."""

    __hash__ = object.__hash__


def db_nodes(test, spec, rng=None) -> list:
    """Resolve a node-spec targeter to concrete nodes
    (nemesis/combined.clj db-nodes): "one", "minority", "majority",
    "primaries", "all", an explicit node collection, or a callable
    nodes -> nodes."""
    rng = rng or _random_mod
    nodes = list(test["nodes"])
    if callable(spec):
        return list(spec(nodes))
    if isinstance(spec, (list, tuple, set, frozenset)):
        return [n for n in nodes if n in set(spec)]
    n = len(nodes)
    if spec == "one":
        return [rng.choice(nodes)] if nodes else []
    if spec == "minority":
        k = max(0, majority(n) - 1)
        return sorted(rng.sample(nodes, k))
    if spec == "majority":
        return sorted(rng.sample(nodes, majority(n))) if nodes else []
    if spec == "primaries":
        db = test.get("db")
        if isinstance(db, db_mod.Primary):
            return list(db.primaries(test))
        return nodes[:1]
    if spec == "all":
        return nodes
    raise ValueError(
        f"unknown node spec {spec!r} (want one of {NODE_SPECS}, a node "
        "collection, or a callable)")


@dataclass
class NemesisPackage:
    """One fault family, ready to compose (nemesis/combined.clj's
    nemesis-package maps)."""

    nemesis: Nemesis
    #: main-phase nemesis op schedule (None: no scheduled ops)
    generator: object = None
    #: heal phase run after the main generator is exhausted
    final_generator: object = None
    #: every op :f this package's nemesis handles
    fs: frozenset = frozenset()
    #: family -> {"faults": set of fs, "heals": set of fs} for
    #: checker.recovery; empty heals marks an unrevokable fault
    #: (corruption) that the checker must NOT demand a heal for
    families: dict = field(default_factory=dict)
    #: perf-plot metadata: {"name", "start": fs, "stop": fs, "color"}
    perf: dict = field(default_factory=dict)


def _paced(g, interval):
    return gen_mod.delay(interval, g) if interval else g


def _alternator(fault_fn: Callable, heal_op: dict, interval: float):
    """fault, heal, fault, heal, ... — each op `interval` seconds apart.
    The fixed delay (not stagger) keeps schedules seed-reproducible."""

    def cycle():
        while True:
            yield fault_fn
            yield dict(heal_op)

    return _paced(gen_mod.seq(cycle()), interval)


def _opt(opts, key, family_key, default=None):
    """Family-specific option (e.g. kill_targets) with shared fallback.
    None means absent, so callers can thread optional kwargs through."""
    v = opts.get(family_key)
    if v is None:
        v = opts.get(key)
    return default if v is None else v


# ---------------------------------------------------------------------------
# Package builders, one per fault family

def partition_package(opts: dict) -> NemesisPackage:
    """Network partitions over every existing grudge builder
    (nemesis/combined.clj partition-package). The generator precomputes
    the grudge from the seeded rng and ships it as op.value — the
    Partitioner applies a Mapping value verbatim, so the schedule is
    reproducible and self-describing in the history."""
    rng = opts["rng"]
    interval = opts.get("interval", 10.0)

    kinds = {
        "halves": lambda nodes: complete_grudge(bisect(nodes)),
        "random-halves": lambda nodes: _shuffled_halves(nodes, rng),
        "one": lambda nodes: complete_grudge(split_one(nodes, rng=rng)),
        "majorities-ring": lambda nodes: majorities_ring(nodes, rng=rng),
        "bridge": lambda nodes: bridge(nodes),
    }
    kind_names = sorted(kinds)

    def start(test, process):
        kind = rng.choice(kind_names)
        grudge = kinds[kind](list(test["nodes"]))
        # sorted lists, not sets: the grudge rides the history as the
        # op value and must stay serializable and order-stable
        return {"type": "info", "f": "start-partition",
                "value": {n: sorted(v) for n, v in grudge.items()}}

    nemesis = compose({
        _FDict({"start-partition": "start", "stop-partition": "stop"}):
            Partitioner(lambda nodes: complete_grudge(bisect(nodes))),
    })
    fs = frozenset({"start-partition", "stop-partition"})
    return NemesisPackage(
        nemesis=nemesis,
        generator=_alternator(start, {"type": "info", "f": "stop-partition"},
                              interval),
        final_generator=gen_mod.once({"type": "info", "f": "stop-partition"}),
        fs=fs,
        families={"partition": {"faults": {"start-partition"},
                                "heals": {"stop-partition"}}},
        perf={"name": "partition", "start": {"start-partition"},
              "stop": {"stop-partition"}, "color": "#E9A4A0"},
    )


def _shuffled_halves(nodes, rng):
    nodes = list(nodes)
    rng.shuffle(nodes)
    return complete_grudge(bisect(nodes))


def clock_package(opts: dict) -> NemesisPackage:
    """Clock skew faults (nemesis/combined.clj clock-package): scramble
    node clocks within ±clock_dt seconds, reset on heal. set_time_fn is
    injectable for sandboxes where `date -s` can't run.

    The generator precomputes the per-node offsets into op.value
    (value-driven, like Partitioner/ProcessNemesis) so the schedule is
    a pure function of the seed and replays from schedule JSON; the
    ClockScrambler applies a Mapping value verbatim."""
    rng = opts["rng"]
    interval = opts.get("interval", 10.0)
    dt = opts.get("clock_dt", 60.0)
    scrambler = ClockScrambler(
        dt=dt, rng=rng, set_time_fn=opts.get("set_time_fn"))

    def scramble(test, process):
        # rounded so the JSON rendering is byte-stable across platforms
        return {"type": "info", "f": "scramble-clock",
                "value": {node: round(rng.uniform(-dt, dt), 6)
                          for node in test["nodes"]}}

    nemesis = compose({
        _FDict({"scramble-clock": "scramble", "reset-clock": "reset"}):
            scrambler,
    })
    return NemesisPackage(
        nemesis=nemesis,
        generator=_alternator(
            scramble,
            {"type": "info", "f": "reset-clock"}, interval),
        final_generator=gen_mod.once({"type": "info", "f": "reset-clock"}),
        fs=frozenset({"scramble-clock", "reset-clock"}),
        families={"clock": {"faults": {"scramble-clock"},
                            "heals": {"reset-clock"}}},
        perf={"name": "clock", "start": {"scramble-clock"},
              "stop": {"reset-clock"}, "color": "#A0E9DB"},
    )


class ProcessNemesis(Nemesis):
    """Kill or pause the DB's process via the db.Kill/db.Pause protocols
    (nemesis/combined.clj db-nemesis). Fault ops carry their target node
    list in op.value (precomputed by the package generator from the
    seeded rng); heal ops revive every node currently affected. Teardown
    best-effort revives too, so an aborted run can't strand dead or
    SIGSTOPped daemons."""

    MODES = {
        "kill": ("kill", "restart", "killed", "started"),
        "pause": ("pause", "resume", "paused", "resumed"),
    }

    def __init__(self, db, mode: str = "kill"):
        assert mode in self.MODES, mode
        self.db = db
        self.mode = mode
        (self.fault_f, self.heal_f,
         self.fault_tag, self.heal_tag) = self.MODES[mode]
        self.affected: set = set()
        self._lock = threading.Lock()

    def _fault(self, test, node):
        if self.mode == "kill":
            self.db.kill(test, node)
        else:
            self.db.pause(test, node)

    def _heal(self, test, node):
        if self.mode == "kill":
            self.db.start(test, node)
        else:
            self.db.resume(test, node)

    def invoke(self, test, op):
        if op.f == self.fault_f:
            targets = list(op.value or [])
            if not targets and test["nodes"]:
                targets = [test["nodes"][0]]
            # record BEFORE acting so teardown can revoke a half-applied
            # fault (the NodeStartStopper lesson)
            with self._lock:
                self.affected.update(targets)
            for node in targets:
                self._fault(test, node)
            return op.with_(type="info",
                            value={n: self.fault_tag for n in targets})
        if op.f == self.heal_f:
            with self._lock:
                targets = sorted(self.affected)
            for node in targets:
                self._heal(test, node)
            with self._lock:
                self.affected.difference_update(targets)
            return op.with_(type="info",
                            value={n: self.heal_tag for n in targets})
        raise ValueError(
            f"{self.mode} process nemesis can't handle {op.f!r}")

    def teardown(self, test):
        with self._lock:
            targets = sorted(self.affected)
            self.affected = set()
        for node in targets:
            try:
                self._heal(test, node)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.warning("couldn't revive %s during teardown", node,
                            exc_info=True)

    def active_faults(self):
        with self._lock:
            targets = sorted(self.affected)
        if not targets:
            return []
        return [{"kind": f"process-{self.mode}", "heal_f": self.heal_f,
                 "nodes": targets}]

    def restore_faults(self, entries):
        with self._lock:
            for e in entries:
                self.affected.update(e.get("nodes") or [])


def _process_package(opts: dict, mode: str, proto,
                     color: str) -> NemesisPackage:
    db = opts.get("db")
    if not isinstance(db, proto):
        raise ValueError(
            f"the {mode!r} fault family needs a db implementing "
            f"db.{proto.__name__}; {type(db).__name__} doesn't")
    rng = opts["rng"]
    interval = opts.get("interval", 10.0)
    nemesis = ProcessNemesis(db, mode)
    specs = list(_opt(opts, "targets", f"{mode}_targets",
                      ("one", "majority", "all")))

    def fault(test, process):
        spec = rng.choice(specs)
        return {"type": "info", "f": nemesis.fault_f,
                "value": db_nodes(test, spec, rng)}

    return NemesisPackage(
        nemesis=nemesis,
        generator=_alternator(
            fault, {"type": "info", "f": nemesis.heal_f}, interval),
        final_generator=gen_mod.once(
            {"type": "info", "f": nemesis.heal_f}),
        fs=frozenset({nemesis.fault_f, nemesis.heal_f}),
        families={mode: {"faults": {nemesis.fault_f},
                         "heals": {nemesis.heal_f}}},
        perf={"name": mode, "start": {nemesis.fault_f},
              "stop": {nemesis.heal_f}, "color": color},
    )


def kill_package(opts: dict) -> NemesisPackage:
    """SIGKILL + restart faults via db.Kill
    (nemesis/combined.clj db-package's :kill half)."""
    return _process_package(opts, "kill", db_mod.Kill, "#E9D2A0")


def pause_package(opts: dict) -> NemesisPackage:
    """SIGSTOP + SIGCONT faults via db.Pause
    (nemesis/combined.clj db-package's :pause half)."""
    return _process_package(opts, "pause", db_mod.Pause, "#C5A0E9")


class FileCorruptor(Nemesis):
    """Apply the corruption specs carried in op.value: each is
    {"node", "path", "kind": "truncate"|"bitflip", ...}. Value-driven
    like ProcessNemesis so the seeded generator owns all randomness
    (jepsen.nemesis.file's corrupt-file! ops)."""

    def invoke(self, test, op):
        assert op.f == "corrupt-file", op.f
        results = {}
        for spec in (op.value or []):
            node, path, kind = spec["node"], spec["path"], spec["kind"]
            if kind == "truncate":
                test["remote"].exec(
                    node,
                    ["truncate", "-c", "-s", f"-{spec.get('bytes', 1)}",
                     path],
                    sudo=True)
            elif kind == "bitflip":
                # the corrupting byte is drawn by the SEEDED generator
                # and rides in the spec; /dev/urandom remains only as
                # the fallback for legacy specs without one
                if "byte" in spec:
                    b = int(spec["byte"]) & 0xFF
                    test["remote"].exec(
                        node,
                        ["sh", "-c",
                         f"printf '\\x{b:02x}' | dd of={path} bs=1 "
                         f"count=1 seek={spec.get('offset', 0)} "
                         "conv=notrunc"],
                        sudo=True)
                else:
                    test["remote"].exec(
                        node,
                        ["dd", "if=/dev/urandom", f"of={path}", "bs=1",
                         "count=1", f"seek={spec.get('offset', 0)}",
                         "conv=notrunc"],
                        sudo=True)
            else:
                raise ValueError(f"unknown corruption kind {kind!r}")
            results[node] = f"{kind} {path}"
        return op.with_(type="info", value=results)


def file_corruption_package(opts: dict) -> NemesisPackage:
    """Torn writes (truncate) and silent bitflips against the paths in
    opts["corrupt_paths"]. No heal generator — corruption is not
    revocable, so its family carries an empty heals set and the recovery
    checker exempts it from the healed-before-analysis audit."""
    paths = list(opts.get("corrupt_paths") or [])
    if not paths:
        raise ValueError(
            "the 'corruption' fault family needs opts['corrupt_paths'] "
            "(files on the nodes to truncate/bitflip)")
    rng = opts["rng"]
    interval = opts.get("interval", 10.0)

    def corrupt(test, process):
        node = db_nodes(test, "one", rng)[0]
        path = rng.choice(paths)
        if callable(path):  # per-node path builder fn(test, node)
            path = path(test, node)
        kind = rng.choice(["bitflip", "truncate"])
        spec = {"node": node, "path": path, "kind": kind}
        if kind == "truncate":
            spec["bytes"] = rng.randrange(1, 65)
        else:
            # offset AND replacement byte both come from the seeded
            # rng — the fault content, not just its location, is a
            # pure function of the seed (FileCorruptor applies it)
            spec["offset"] = rng.randrange(64)
            spec["byte"] = rng.randrange(256)
        return {"type": "info", "f": "corrupt-file", "value": [spec]}

    return NemesisPackage(
        nemesis=FileCorruptor(),
        generator=_paced(gen_mod.seq(_forever(corrupt)), interval),
        final_generator=None,
        fs=frozenset({"corrupt-file"}),
        families={"corruption": {"faults": {"corrupt-file"},
                                 "heals": set()}},
        perf={"name": "corruption", "start": {"corrupt-file"},
              "stop": set(), "color": "#A0B2E9"},
    )


def _forever(x):
    while True:
        yield x


class PacketNemesis(Nemesis):
    """Degrade (slow/flaky) and restore the whole network via the
    test's Net (nemesis/combined.clj packet-package). The behavior name
    rides in op.value; net.fast on heal and teardown."""

    BEHAVIORS = ("slow", "flaky")

    def __init__(self):
        self._behavior = None

    def invoke(self, test, op):
        net = test["net"]
        if op.f == "packet-start":
            behavior = op.value or "slow"
            assert behavior in self.BEHAVIORS, behavior
            getattr(net, behavior)(test)
            self._behavior = behavior
            return op.with_(type="info", value=behavior)
        if op.f == "packet-stop":
            net.fast(test)
            self._behavior = None
            return op.with_(type="info", value="fast")
        raise ValueError(f"packet nemesis can't handle {op.f!r}")

    def teardown(self, test):
        self._behavior = None
        try:
            test["net"].fast(test)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            log.warning("couldn't restore network speed", exc_info=True)

    def active_faults(self):
        if self._behavior is None:
            return []
        return [{"kind": "packet", "heal_f": "packet-stop",
                 "behavior": self._behavior}]

    def restore_faults(self, entries):
        for e in entries:
            self._behavior = e.get("behavior") or "slow"


def packet_package(opts: dict) -> NemesisPackage:
    """Packet-level faults: netem delay (slow) and loss (flaky),
    restored by net.fast. Relies on IPTables.slow/flaky being
    idempotent (tc qdisc replace) so back-to-back behaviors swap
    cleanly."""
    rng = opts["rng"]
    interval = opts.get("interval", 10.0)

    def start(test, process):
        return {"type": "info", "f": "packet-start",
                "value": rng.choice(list(PacketNemesis.BEHAVIORS))}

    return NemesisPackage(
        nemesis=PacketNemesis(),
        generator=_alternator(start, {"type": "info", "f": "packet-stop"},
                              interval),
        final_generator=gen_mod.once({"type": "info", "f": "packet-stop"}),
        fs=frozenset({"packet-start", "packet-stop"}),
        families={"packet": {"faults": {"packet-start"},
                             "heals": {"packet-stop"}}},
        perf={"name": "packet", "start": {"packet-start"},
              "stop": {"packet-stop"}, "color": "#A0E9A4"},
    )


_BUILDERS = {
    "partition": partition_package,
    "clock": clock_package,
    "kill": kill_package,
    "pause": pause_package,
    "corruption": file_corruption_package,
    "packet": packet_package,
}


# ---------------------------------------------------------------------------
# Composition

def compose_packages(packages: Iterable[NemesisPackage],
                     rng=None, fault_ops: int | None = None
                     ) -> NemesisPackage:
    """Merge packages into one (nemesis/combined.clj compose-packages):
    one Compose nemesis routing by fs, a seeded mix of the package
    schedules, and the heal phases concatenated in order. fault_ops
    bounds the merged main schedule by op COUNT — a count bound (unlike
    a time bound) keeps seeded schedules reproducible."""
    packages = [p for p in packages if p is not None]
    if not packages:
        raise ValueError("compose_packages needs at least one package")

    fs_seen: set = set()
    for p in packages:
        overlap = fs_seen & set(p.fs)
        if overlap:
            raise ValueError(
                f"packages overlap on op fs {sorted(overlap)}; "
                "compose routing would be ambiguous")
        fs_seen |= set(p.fs)

    nemesis = compose({frozenset(p.fs): p.nemesis for p in packages})
    main = gen_mod.mix([p.generator for p in packages
                        if p.generator is not None], rng=rng)
    if fault_ops is not None:
        main = gen_mod.limit(fault_ops, main)
    finals = [p.final_generator for p in packages
              if p.final_generator is not None]
    families: dict = {}
    for p in packages:
        families.update(p.families)
    return NemesisPackage(
        nemesis=nemesis,
        generator=main,
        final_generator=gen_mod.concat(*finals) if finals else None,
        fs=frozenset(fs_seen),
        families=families,
        perf={"nemeses": [p.perf for p in packages if p.perf]},
    )


def nemesis_package(opts: dict | None = None, **kw) -> NemesisPackage:
    """Build the composed package for a set of fault families
    (nemesis/combined.clj nemesis-package). Options:

      faults          iterable of family names (default: ("partition",))
      seed            int — seeds a fresh Random when rng isn't given
      rng             random.Random — the single source of randomness
      interval        seconds between scheduled nemesis ops (default 10)
      fault_ops       bound the merged schedule to N ops (reproducible)
      db              the test's DB (required for kill/pause/primaries)
      targets         node-spec names for kill/pause (or kill_targets/
                      pause_targets per family)
      corrupt_paths   file paths for the corruption family
      clock_dt        clock skew half-window seconds (default 60)
      set_time_fn     injectable clock setter fn(test, node, t)
    """
    opts = {**(opts or {}), **kw}
    faults = list(opts.get("faults") or ("partition",))
    unknown = sorted(set(faults) - set(FAULT_FAMILIES))
    if unknown:
        raise ValueError(
            f"unknown fault families {unknown} "
            f"(have: {list(FAULT_FAMILIES)})")
    if opts.get("rng") is None:
        opts["rng"] = _random_mod.Random(opts.get("seed"))
    # canonical order: same faults + same seed => same schedule
    ordered = [f for f in FAULT_FAMILIES if f in set(faults)]
    packages = [_BUILDERS[f](opts) for f in ordered]
    return compose_packages(packages, rng=opts["rng"],
                            fault_ops=opts.get("fault_ops"))


def parse_fault_spec(spec) -> tuple | None:
    """Interpret a --nemesis value as a fault-family spec: a comma
    list of family names ("kill,partition") or a single family name.
    Returns the family tuple, or None when the spec is a suite-specific
    registry name (e.g. "parts") that pick_nemesis should resolve."""
    if not spec or not isinstance(spec, str):
        return None
    parts = [s.strip() for s in spec.split(",") if s.strip()]
    if not parts:
        return None
    if all(p in FAULT_FAMILIES for p in parts):
        return tuple(parts)
    if len(parts) > 1:
        bad = sorted(set(parts) - set(FAULT_FAMILIES))
        raise ValueError(
            f"comma-separated --nemesis must name fault families; "
            f"{bad} aren't (have: {list(FAULT_FAMILIES)})")
    return None


def wire_package(test: dict, package: NemesisPackage,
                 opts: dict | None = None) -> dict:
    """Install a package into a test map: the nemesis, the main-phase
    routing (package schedule to the nemesis thread, the test's current
    generator to clients), the heal phase + stability window fields
    core.run honors, and the recovery checker composed over the test's
    existing checker. Mutates and returns the test map."""
    opts = dict(opts or {})
    client_gen = test.get("generator")
    main = gen_mod.nemesis(package.generator, client_gen)
    tl = opts.get("time_limit")
    if tl:
        main = gen_mod.time_limit(tl, main)
    test["generator"] = main
    test["nemesis"] = package.nemesis
    test["final_generator"] = package.final_generator
    test["fault_families"] = package.families
    if package.perf:
        test["plot"] = {**(test.get("plot") or {}), **package.perf}
    if opts.get("stability_period") is not None:
        test["stability_period"] = opts["stability_period"]
    if opts.get("stability_generator") is not None:
        test["stability_generator"] = opts["stability_generator"]

    from ..checker import compose as compose_checkers
    from ..checker.recovery import recovery as recovery_checker

    rc = recovery_checker(families=package.families,
                          min_ok=opts.get("recovery_min_ok", 1))
    base = test.get("checker")
    test["checker"] = (
        compose_checkers({"workload": base, "recovery": rc})
        if base is not None else rc)
    return test


# ---------------------------------------------------------------------------
# Schedule (de)serialization
#
# A *schedule document* is the full materialized fault schedule of a
# composed package — every op the seeded generators would emit, with
# values precomputed (grudges, clock offsets, kill targets, corruption
# specs) — as plain JSON. Because every builder is value-driven, the
# document captures the schedule completely: replaying it through
# schedule_from_json drives the SAME nemeses through the SAME ops
# without consulting an rng. This is how fuzz-discovered schedules
# (fuzz/schedule.to_nemesis_doc emits the same shape) reach the real
# nemesis path via `jepsen-tpu test --nemesis-schedule <file>`.

#: family -> (fault fs, heal fs); the static side of the builders
FAMILY_FS = {
    "partition": ({"start-partition"}, {"stop-partition"}),
    "clock": ({"scramble-clock"}, {"reset-clock"}),
    "kill": ({"kill"}, {"restart"}),
    "pause": ({"pause"}, {"resume"}),
    "corruption": ({"corrupt-file"}, set()),
    "packet": ({"packet-start"}, {"packet-stop"}),
}

#: op f -> family, derived
_F_FAMILY = {f: fam for fam, (fs, hs) in FAMILY_FS.items()
             for f in (fs | hs)}


class _ScheduleDB(db_mod.DB, db_mod.Kill, db_mod.Pause):
    """Inert DB satisfying the kill/pause protocols, used when a
    package is built only to MATERIALIZE its schedule (no cluster)."""

    def alive(self, test, node):
        return True

    def kill(self, test, node):
        pass

    def start(self, test, node):
        pass

    def pause(self, test, node):
        pass

    def resume(self, test, node):
        pass


def _default_nodes(opts: dict) -> list:
    nodes = opts.get("nodes")
    if nodes:
        return list(nodes)
    return [f"n{i + 1}" for i in range(5)]


def _json_value(v):
    """Op values, coerced to canonical JSON-pure form (sets -> sorted
    lists; mappings key-sorted) so document bytes are process-stable."""
    import json as _json

    return _json.loads(_json.dumps(v, sort_keys=True, default=sorted))


def materialize_schedule(opts: dict | None = None, **kw) -> dict:
    """Step a freshly built composed package's generators to the end
    and record every op as a schedule document:

      {"version": 1, "faults": [...], "nodes": [...], "interval": s,
       "seed": n, "fault_ops": n,
       "events": [{"dt": s, "f": ..., "value": ...}, ...],
       "final":  [...]}

    Takes the same options as nemesis_package; `fault_ops` (default
    16) bounds the schedule, `interval` (default 10) is recorded as
    each main event's pacing delay but NOT slept here — the package is
    built unpaced, so materialization is instant. kill/pause families
    fall back to an inert protocol-satisfying DB when opts lacks one
    (materialization never touches a cluster)."""
    opts = {**(opts or {}), **kw}
    nodes = _default_nodes(opts)
    interval = opts.get("interval", 10.0)
    fault_ops = opts.get("fault_ops") or 16
    faults = list(opts.get("faults") or ("partition",))
    if opts.get("db") is None and ({"kill", "pause"} & set(faults)):
        opts["db"] = _ScheduleDB()
    if "corruption" in faults and not opts.get("corrupt_paths"):
        # placeholder path: replay (schedule_from_json) re-targets
        # corruption specs at the caller's corrupt_paths
        opts["corrupt_paths"] = [None]
    pkg = nemesis_package({**opts, "interval": 0,
                           "fault_ops": fault_ops})
    test = {"nodes": nodes, "db": opts.get("db")}

    def _steps(g, dt):
        out = []
        while g is not None:
            o = gen_mod.op(g, test, "nemesis")
            if o is None:
                break
            out.append({"dt": dt, "f": o["f"],
                        "value": _json_value(o.get("value"))})
        return out

    events = _steps(pkg.generator, interval)
    final = [dict(e, dt=0) for e in _steps(pkg.final_generator, 0)]
    ordered = [f for f in FAULT_FAMILIES if f in set(faults)]
    return {"version": 1, "faults": ordered, "nodes": nodes,
            "interval": interval, "seed": opts.get("seed"),
            "fault_ops": fault_ops, "events": events, "final": final}


def schedule_to_json(source=None, **kw) -> str:
    """Canonical JSON of a fault schedule. `source` may be a schedule
    document (from materialize_schedule / fuzz.schedule.to_nemesis_doc),
    a NemesisPackage built by schedule_from_json (its document rides on
    .schedule_doc), or option kwargs for a fresh seeded package. Same
    options + same seed => byte-identical string (the determinism
    property test pins this)."""
    import json as _json

    if isinstance(source, NemesisPackage):
        doc = getattr(source, "schedule_doc", None)
        if doc is None:
            raise ValueError(
                "package has no schedule document; only packages from "
                "schedule_from_json carry one — pass builder options "
                "instead")
    elif isinstance(source, Mapping) and "events" in source:
        doc = source
    else:
        doc = materialize_schedule(source, **kw)
    return _json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _node_path(path, test, node):
    return path(test, node) if callable(path) else path


class _DocEvents(gen_mod.Generator):
    """Generator replaying literal schedule-document events. Each
    event's `dt` is slept before the op is emitted (the DelayFn
    discipline), so relative fault timing survives the JSON
    round-trip; pace=False skips the sleeps (dry replay, tests).
    Corruption specs with a null path are re-targeted at the provided
    corrupt_paths cycle; a callable entry is a per-node path builder
    fn(test, node), as in file_corruption_package (the JAX package's
    replay hands the callable itself to FileCorruptor)."""

    def __init__(self, events, corrupt_paths=None, pace=True):
        self._events = list(events or [])
        self._paths = list(corrupt_paths or [])
        self._pace = pace
        self._i = 0

    def op(self, test, process):
        import time as _time

        if self._i >= len(self._events):
            return None
        e = self._events[self._i]
        self._i += 1
        dt = e.get("dt") or 0
        if dt and self._pace:
            _time.sleep(dt)
        value = e.get("value")
        if e["f"] == "corrupt-file" and self._paths:
            value = [dict(spec, path=spec.get("path")
                          or _node_path(self._paths[i % len(self._paths)],
                                        test, spec["node"]))
                     for i, spec in enumerate(value or [])]
        return {"type": e.get("type", "info"), "f": e["f"],
                "value": value}


def schedule_from_json(data, opts: dict | None = None,
                       **kw) -> NemesisPackage:
    """Rebuild a NemesisPackage from a schedule document (dict or JSON
    string): the real nemeses for every family the document touches,
    driven by generators that replay the recorded events verbatim —
    no rng anywhere. opts supplies the live-cluster dependencies the
    document can't carry: `db` (required for kill/pause families),
    `set_time_fn`, `corrupt_paths`, `clock_dt`; `pace=False` replays
    without sleeping the recorded inter-event delays.

    The document rides on the returned package as `.schedule_doc`, so
    schedule_to_json(schedule_from_json(s)) == s byte-identically."""
    import json as _json

    opts = {**(opts or {}), **kw}
    doc = _json.loads(data) if isinstance(data, str) else dict(data)
    if doc.get("version") != 1:
        raise ValueError(f"unsupported schedule version "
                         f"{doc.get('version')!r}")
    families = [f for f in FAULT_FAMILIES if f in set(doc.get("faults")
                                                      or ())]
    # families can also be implied by events (hand-written docs)
    seen = {_F_FAMILY[e["f"]] for e in (doc.get("events") or [])
            if e.get("f") in _F_FAMILY}
    families = [f for f in FAULT_FAMILIES if f in (set(families) | seen)]
    if not families:
        raise ValueError("schedule document has no fault families")
    db = opts.get("db")
    routes: dict = {}
    fams: dict = {}
    for fam in families:
        fs, hs = FAMILY_FS[fam]
        if fam == "partition":
            nem = compose({
                _FDict({"start-partition": "start",
                        "stop-partition": "stop"}):
                    Partitioner(lambda nodes: complete_grudge(
                        bisect(nodes))),
            })
        elif fam == "clock":
            nem = compose({
                _FDict({"scramble-clock": "scramble",
                        "reset-clock": "reset"}):
                    ClockScrambler(dt=opts.get("clock_dt", 60.0),
                                   set_time_fn=opts.get("set_time_fn")),
            })
        elif fam in ("kill", "pause"):
            proto = db_mod.Kill if fam == "kill" else db_mod.Pause
            if not isinstance(db, proto):
                raise ValueError(
                    f"replaying a schedule with {fam!r} faults needs "
                    f"opts['db'] implementing db.{proto.__name__}")
            nem = ProcessNemesis(db, fam)
        elif fam == "corruption":
            nem = FileCorruptor()
        else:  # packet
            nem = PacketNemesis()
        routes[frozenset(fs | hs)] = nem
        fams[fam] = {"faults": set(fs), "heals": set(hs)}
    paths = opts.get("corrupt_paths")
    pace = opts.get("pace", True)
    pkg = NemesisPackage(
        nemesis=compose(routes),
        generator=_DocEvents(doc.get("events"), corrupt_paths=paths,
                             pace=pace),
        final_generator=(_DocEvents(doc.get("final"),
                                    corrupt_paths=paths, pace=pace)
                         if doc.get("final") else None),
        fs=frozenset(_F_FAMILY) if len(families) == len(FAMILY_FS)
        else frozenset(f for fam in families
                       for f in (FAMILY_FS[fam][0] | FAMILY_FS[fam][1])),
        families=fams,
        perf={"nemeses": [{"name": fam,
                           "start": set(FAMILY_FS[fam][0]),
                           "stop": set(FAMILY_FS[fam][1])}
                          for fam in families]},
    )
    pkg.schedule_doc = doc
    return pkg


def load_schedule_file(path: str, opts: dict | None = None,
                       **kw) -> NemesisPackage:
    """schedule_from_json over a file path (the --nemesis-schedule
    CLI flag's loader)."""
    with open(path) as fh:
        return schedule_from_json(fh.read(), opts, **kw)
