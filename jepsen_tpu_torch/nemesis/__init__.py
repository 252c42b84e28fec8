"""Fault injection (reference: jepsen.nemesis, nemesis.clj).

A nemesis is a special client driven by the nemesis worker thread: it
receives ops from the generator (routed via gen.nemesis) and perturbs the
cluster — partitions, clock skew, process kills, file corruption. Grudge
builders (which nodes stop talking to which) are pure functions, tested
without any cluster.

The port's copy of `jepsen_tpu/nemesis/__init__.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import logging
import random as _random
from typing import Callable, Iterable, Mapping

from ..history import Op
from ..util import majority, real_pmap

log = logging.getLogger("jepsen_tpu_torch.nemesis")


class Nemesis:
    """Lifecycle mirror of nemesis.clj:9-14, plus the active-fault
    ledger hooks preemption-tolerant runs checkpoint: a preempted run
    leaves partitions/tc rules/SIGSTOPs planted on nodes, and resume
    must heal them before generating a single op."""

    def setup(self, test) -> "Nemesis":
        return self

    def invoke(self, test, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test) -> None:
        pass

    def active_faults(self) -> list[dict]:
        """The ledger of faults currently planted: one dict per fault,
        carrying at least {"kind", "heal_f"} (heal_f is the op :f that
        revokes it) plus whatever state restore_faults needs. Stateless
        nemeses report none."""
        return []

    def restore_faults(self, entries: list[dict]) -> None:
        """Rehydrate internal fault state from a checkpointed ledger
        (the resumed process starts with fresh objects), so the heal
        ops the resume path fires actually know their targets."""


class Noop(Nemesis):
    """Does nothing (nemesis.clj:198-201): still completes ops so
    generators advance."""

    def invoke(self, test, op):
        return op.with_(type="info")


noop = Noop()


# ---------------------------------------------------------------------------
# Grudges: pure partition math (nemesis.clj:56-156)

def bisect(coll: Iterable) -> tuple[list, list]:
    """Split a collection into two halves, first half smaller
    (nemesis.clj:56-62)."""
    coll = list(coll)
    mid = len(coll) // 2
    return coll[:mid], coll[mid:]


def split_one(coll: Iterable, node=None, rng=None) -> tuple[list, list]:
    """Isolate one node (the given one, or random) from the rest
    (nemesis.clj:64-73). Pass a seeded rng for reproducible picks."""
    coll = list(coll)
    node = node if node is not None else (rng or _random).choice(coll)
    return [node], [n for n in coll if n != node]


def complete_grudge(components: Iterable[Iterable]) -> dict:
    """From a partition into components, build the grudge: node -> set of
    nodes it cannot talk to (everything outside its component)
    (nemesis.clj:75-87)."""
    components = [list(c) for c in components]
    everyone = {n for c in components for n in c}
    grudge = {}
    for c in components:
        others = everyone - set(c)
        for n in c:
            grudge[n] = set(others)
    return grudge


def bridge(nodes: Iterable) -> dict:
    """Grudge with a bridge node connected to both halves: majorities
    overlap on one node (nemesis.clj:89-99)."""
    nodes = list(nodes)
    mid = len(nodes) // 2
    head, bridge_node, tail = nodes[:mid], nodes[mid], nodes[mid + 1 :]
    grudge = {n: set(tail) for n in head}
    grudge.update({n: set(head) for n in tail})
    grudge[bridge_node] = set()
    return grudge


def majorities_ring(nodes: Iterable, rng=None) -> dict:
    """Every node sees a majority, but no two nodes see the same majority
    (nemesis.clj:134-147): node i is connected to the majority-sized
    window of the (shuffled) ring starting at its position. Pass a
    seeded rng for a reproducible ring."""
    nodes = list(nodes)
    n = len(nodes)
    ring = list(nodes)
    (rng or _random).shuffle(ring)
    m = majority(n)
    grudge = {}
    for i, node in enumerate(ring):
        visible = {ring[(i + d) % n] for d in range(m)}
        grudge[node] = set(nodes) - visible
    return grudge


# ---------------------------------------------------------------------------
# Partitioners (nemesis.clj:95-156)

class Partitioner(Nemesis):
    """Responds to {:f "start"} by cutting links per grudge(nodes), and
    {:f "stop"} by healing (nemesis.clj:95-116)."""

    def __init__(self, grudge_fn: Callable[[list], Mapping]):
        self.grudge_fn = grudge_fn
        self._grudge: dict | None = None

    def setup(self, test):
        test["net"].heal(test)
        return self

    def invoke(self, test, op):
        if op.f == "start":
            grudge = (
                op.value
                if isinstance(op.value, Mapping)
                else self.grudge_fn(list(test["nodes"]))
            )
            test["net"].drop_all(test, grudge)
            self._grudge = {n: sorted(v) for n, v in grudge.items()}
            return op.with_(
                type="info", value=f"Cut off {_render_grudge(grudge)}"
            )
        if op.f == "stop":
            test["net"].heal(test)
            self._grudge = None
            return op.with_(type="info", value="fully connected")
        raise ValueError(f"partitioner can't handle op {op.f!r}")

    def teardown(self, test):
        test["net"].heal(test)
        self._grudge = None

    def active_faults(self):
        if self._grudge is None:
            return []
        return [{"kind": "partition", "heal_f": "stop",
                 "grudge": self._grudge}]

    def restore_faults(self, entries):
        for e in entries:
            self._grudge = dict(e.get("grudge") or {})


def _render_grudge(grudge: Mapping) -> dict:
    return {n: sorted(v) for n, v in grudge.items() if v}


def partitioner(grudge_fn) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    """Cut the network into two halves, first node in the smaller one
    (nemesis.clj:118-124)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves(rng=None) -> Partitioner:
    """Two RANDOM halves (nemesis.clj:126-132)."""

    def grudge(nodes):
        nodes = list(nodes)
        (rng or _random).shuffle(nodes)
        return complete_grudge(bisect(nodes))

    return Partitioner(grudge)


def partition_random_node(rng=None) -> Partitioner:
    """Isolate a single random node (nemesis.clj:107-116 via split-one)."""
    return Partitioner(
        lambda nodes: complete_grudge(split_one(nodes, rng=rng)))


def partition_majorities_ring(rng=None) -> Partitioner:
    """Intersecting majorities ring partition (nemesis.clj:149-156)."""
    return Partitioner(lambda nodes: majorities_ring(nodes, rng=rng))


# ---------------------------------------------------------------------------
# Composition & process nemeses

class Compose(Nemesis):
    """Route ops to sub-nemeses by :f. Takes {fs_or_fmap: nemesis, ...}
    where the key is a set of fs, or a dict mapping outer f -> inner f
    (nemesis.clj:158-196)."""

    def __init__(self, nemeses: Mapping):
        self.nemeses = dict(nemeses)

    def setup(self, test):
        self.nemeses = {
            fs: nem.setup(test) for fs, nem in self.nemeses.items()
        }
        return self

    def _route(self, f):
        for fs, nem in self.nemeses.items():
            if isinstance(fs, Mapping):
                if f in fs:
                    return nem, fs[f]
            elif f in fs:
                return nem, f
        raise ValueError(f"no nemesis can handle {f!r}")

    def invoke(self, test, op):
        nem, inner_f = self._route(op.f)
        outer_f = op.f
        completion = nem.invoke(test, op.with_(f=inner_f))
        return completion.with_(f=outer_f)

    def teardown(self, test):
        for nem in self.nemeses.values():
            nem.teardown(test)

    def active_faults(self):
        """Children's ledgers, with each inner heal_f translated back
        to the OUTER op name this Compose routes (rename-map keys), so
        the resume path can fire heal ops straight at the top."""
        out = []
        for fs, nem in self.nemeses.items():
            for e in nem.active_faults():
                e = dict(e)
                f = e.get("heal_f")
                if isinstance(fs, Mapping):
                    for outer, inner in fs.items():
                        if inner == f:
                            e["heal_f"] = outer
                            break
                out.append(e)
        return out

    def restore_faults(self, entries):
        for e in entries:
            try:
                nem, inner_f = self._route(e.get("heal_f"))
            except ValueError:
                log.warning("no nemesis routes ledger entry %r; dropping",
                            e)
                continue
            nem.restore_faults([{**e, "heal_f": inner_f}])


def compose(nemeses: Mapping) -> Compose:
    return Compose(nemeses)


def set_time(remote, node, t: float) -> None:
    """Set a node's clock to POSIX seconds t (nemesis.clj:198-201)."""
    remote.exec(node, ["date", "+%s", "-s", f"@{int(t)}"], sudo=True)


class ClockScrambler(Nemesis):
    """Randomizes node clocks within a ±dt-second window
    (nemesis.clj:203-218). A "reset"/"stop" op (and teardown) snaps
    every clock back to real time, so clock faults are revocable like
    partitions. set_time_fn(test, node, t) is injectable — hermetic
    sandboxes can't run `date -s`."""

    def __init__(self, dt: float, rng=None, set_time_fn=None):
        self.dt = dt
        self.rng = rng or _random
        self.set_time_fn = set_time_fn
        self._scrambled = False

    def _set(self, test, node, t):
        if self.set_time_fn is not None:
            self.set_time_fn(test, node, t)
        else:
            set_time(test["remote"], node, t)

    def invoke(self, test, op):
        import time as _time

        from ..control import on_nodes

        if op.f in ("reset", "stop"):
            on_nodes(test,
                     lambda t, node: self._set(test, node, _time.time()))
            self._scrambled = False
            return op.with_(type="info", value="clocks reset")

        dt = self.dt
        if isinstance(op.value, Mapping):
            # value-driven (like Partitioner/ProcessNemesis): the
            # seeded generator precomputed per-node offsets, so the
            # schedule is self-describing and replayable from JSON
            offsets = {node: float(op.value[node])
                       for node in test["nodes"] if node in op.value}
        else:
            # draw every offset up front, under one lock-free pass, so
            # a seeded rng yields the same schedule regardless of
            # on_nodes's thread interleaving
            offsets = {node: self.rng.uniform(-dt, dt)
                       for node in test["nodes"]}

        def scramble(t, node):
            # uniform over [-dt, dt); randrange would TypeError on a
            # float dt (the reference's rand-int coerces doubles).
            # Nodes outside a value-driven offset map keep true time.
            if node in offsets:
                self._set(test, node, _time.time() + offsets[node])

        self._scrambled = True
        return op.with_(value=on_nodes(test, scramble))

    def teardown(self, test):
        import time as _time

        from ..control import on_nodes

        on_nodes(test, lambda t, node: self._set(test, node, _time.time()))
        self._scrambled = False

    def active_faults(self):
        if not self._scrambled:
            return []
        return [{"kind": "clock", "heal_f": "reset"}]

    def restore_faults(self, entries):
        if entries:
            self._scrambled = True


def clock_scrambler(dt: float, rng=None, set_time_fn=None) -> ClockScrambler:
    return ClockScrambler(dt, rng=rng, set_time_fn=set_time_fn)


class NodeStartStopper(Nemesis):
    """On "start", run stop_fn on some targeted nodes (e.g. kill the DB);
    on "stop", run start_fn to revive them (nemesis.clj:220-263).
    targeter: nodes -> node collection."""

    def __init__(self, targeter, stop_fn, start_fn):
        self.targeter = targeter
        self.stop_fn = stop_fn
        self.start_fn = start_fn
        self.affected: list = []

    def invoke(self, test, op):
        if op.f == "start":
            if self.affected:
                return op.with_(type="info", value="already affecting nodes")
            targets = list(self.targeter(list(test["nodes"])))
            # record BEFORE acting: if stop_fn crashes midway (or the
            # run aborts) teardown still knows which nodes to revive
            self.affected = targets
            res = dict(
                zip(
                    targets,
                    real_pmap(lambda n: self.stop_fn(test, n), targets),
                )
            )
            return op.with_(type="info", value=res)
        if op.f == "stop":
            targets = self.affected
            res = dict(
                zip(
                    targets,
                    real_pmap(lambda n: self.start_fn(test, n), targets),
                )
            )
            self.affected = []
            return op.with_(type="info", value=res)
        raise ValueError(f"node_start_stopper can't handle {op.f!r}")

    def teardown(self, test):
        """Fault revocation: best-effort revive whatever is still down,
        so an aborted run can't leave nodes killed/paused forever."""
        targets, self.affected = self.affected, []
        for n in targets:
            try:
                self.start_fn(test, n)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.warning("couldn't revive %s during teardown", n,
                            exc_info=True)

    def active_faults(self):
        if not self.affected:
            return []
        return [{"kind": "start-stop", "heal_f": "stop",
                 "nodes": list(self.affected)}]

    def restore_faults(self, entries):
        for e in entries:
            self.affected = list(e.get("nodes") or [])


def node_start_stopper(targeter, stop_fn, start_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, stop_fn, start_fn)


def hammer_time(process_name: str, targeter=None) -> NodeStartStopper:
    """SIGSTOP/SIGCONT a process on targeted nodes — pause without kill
    (nemesis.clj:265-279)."""
    targeter = targeter or (lambda nodes: [_random.choice(nodes)])

    def stop(test, node):
        test["remote"].exec(
            node, ["killall", "-s", "STOP", process_name], sudo=True
        )
        return "paused"

    def start(test, node):
        test["remote"].exec(
            node, ["killall", "-s", "CONT", process_name], sudo=True
        )
        return "resumed"

    return NodeStartStopper(targeter, stop, start)


class TruncateFile(Nemesis):
    """Truncate a file by a few bytes on targeted nodes — torn-write
    corruption (nemesis.clj:281-307)."""

    def __init__(self, path: str, drop_bytes: int = 1, targeter=None):
        self.path = path
        self.drop_bytes = drop_bytes
        self.targeter = targeter or (lambda nodes: [_random.choice(nodes)])

    def invoke(self, test, op):
        assert op.f == "truncate"
        targets = list(self.targeter(list(test["nodes"])))
        for node in targets:
            test["remote"].exec(
                node,
                ["truncate", "-c", "-s", f"-{self.drop_bytes}", self.path],
                sudo=True,
            )
        return op.with_(type="info", value={"truncated": targets})


def truncate_file(path, drop_bytes=1, targeter=None) -> TruncateFile:
    return TruncateFile(path, drop_bytes, targeter)


class BitflipFile(Nemesis):
    """Overwrite one byte of a file with random garbage on targeted
    nodes — silent on-disk corruption, the bitflip sibling of
    TruncateFile (jepsen.nemesis.file's corrupt-file! bitflip mode)."""

    def __init__(self, path: str, targeter=None, rng=None):
        self.path = path
        self.targeter = targeter or (lambda nodes: [_random.choice(nodes)])
        self.rng = rng or _random

    def invoke(self, test, op):
        assert op.f == "bitflip"
        targets = list(self.targeter(list(test["nodes"])))
        offsets = {}
        for node in targets:
            # pick the offset from the file's tail region; seek past EOF
            # would silently extend the file instead of corrupting it
            size_out = test["remote"].exec(
                node, ["wc", "-c", self.path], check=False
            ).out.split()
            size = int(size_out[0]) if size_out else 0
            offset = self.rng.randrange(max(1, size))
            offsets[node] = offset
            test["remote"].exec(
                node,
                ["dd", "if=/dev/urandom", f"of={self.path}", "bs=1",
                 "count=1", f"seek={offset}", "conv=notrunc"],
                sudo=True,
            )
        return op.with_(type="info", value={"bitflipped": offsets})


def bitflip_file(path, targeter=None, rng=None) -> BitflipFile:
    return BitflipFile(path, targeter=targeter, rng=rng)
