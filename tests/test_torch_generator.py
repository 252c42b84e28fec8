"""The port's generator DSL (`jepsen_tpu_torch.generator`) and keyed
generators (`independent.sequential_generator`/`concurrent_generator`)
against the JAX package's: the cases of tests/test_generator.py and
tests/test_checkpoint.py that drive generators, run through both
packages single-threaded with a fixed context, after the same
`random.seed`. The drained ops must be equal, and the `snapshot` dicts
equal before and after a `restore` (each package restoring the other's
snapshot too)."""

import itertools
import json
import random
import threading

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind

TEST = {"concurrency": 4, "nodes": ["n1", "n2", "n3", "n4", "n5"]}
PACKAGES = {"jax": (jgen, jind), "port": (tgen, tind)}


def strip(o):
    """An op as both packages can compare it: the time-limit deadline is
    a monotonic instant of each run, so only its presence is kept."""
    if o is None:
        return None
    o = dict(o)
    for g in (jgen, tgen):
        if g.DEADLINE_KEY in o:
            o[g.DEADLINE_KEY] = "deadline"
    return o


def draws(g, n, process=0, test=TEST):
    out = []
    for _ in range(n):
        o = g.op(test, process)
        if o is None:
            break
        out.append(strip(o))
    return out


def drain(g, process=0, test=TEST, cap=10_000):
    out = []
    for _ in range(cap):
        o = g.op(test, process)
        if o is None:
            return out
        out.append(strip(o))
    raise AssertionError("generator did not terminate")


def by_processes(g, processes, test=TEST):
    """One draw for each process in turn (a fixed schedule)."""
    return [strip(g.op(test, p)) for p in processes]


# each case: (gen module, independent module) -> the ops it drew
CASES = {
    "void": lambda g, i: [strip(g.to_gen(None).op(TEST, 0))],
    "dict": lambda g, i: draws(g.to_gen({"f": "read"}), 3),
    "callable": lambda g, i: [
        strip(g.to_gen(lambda: {"f": "x"}).op(TEST, 0)),
        strip(g.to_gen(lambda test, p: {"f": "y", "value": p}).op(TEST, 7))],
    "once": lambda g, i: drain(g.once({"f": "read"})),
    "limit": lambda g, i: drain(g.limit(5, {"f": "read"})),
    "seq": lambda g, i: drain(g.seq([{"f": "a"}, {"f": "b"}, {"f": "c"}])),
    "seq_skips_nil": lambda g, i: drain(g.seq([{"f": "a"}, None, {"f": "b"}])),
    "f_map": lambda g, i: drain(
        g.f_map({"read": "txn-read"}, g.once({"f": "read"}))),
    "filter": lambda g, i: drain(g.filter_gen(
        lambda o: o["f"] == "a",
        g.seq([{"f": "a"}, {"f": "b"}, {"f": "a"}]))),
    "mix": lambda g, i: draws(g.mix([{"f": "a"}, {"f": "b"}, {"f": "c"}]), 50),
    "mix_seeded": lambda g, i: draws(
        g.mix([{"f": "a"}, {"f": "b"}], rng=random.Random(11)), 40),
    "each": lambda g, i: by_processes(
        g.each(lambda: g.once({"f": "x"})), [0, 0, 1, 1]),
    "drain_queue": lambda g, i: drain(g.drain_queue(g.seq(
        [{"f": "enqueue", "value": 1}, {"f": "enqueue", "value": 2}]))),
    "cas": lambda g, i: drain(g.limit(60, g.cas)),
    "stagger": lambda g, i: drain(
        g.stagger(0.001, g.limit(5, g.mix([{"f": "r"}, {"f": "w"}])))),
    "time_limit": lambda g, i: drain(g.time_limit(30, g.limit(4, {"f": "r"}))),
    "concat": lambda g, i: by_processes(
        g.concat(g.once({"f": "a"}), g.once({"f": "b"})), [0, 1, 0, 1, 0]),
    "nemesis_routing": lambda g, i: by_processes(
        g.nemesis(g.once({"f": "start"}), g.once({"f": "read"})),
        ["nemesis", 0, 0, "nemesis"]),
    "clients": lambda g, i: by_processes(
        g.clients({"f": "read"}), ["nemesis", 2, 6]),
    "phases": lambda g, i: _with_threads(g, [0], lambda: by_processes(
        g.phases(g.seq([{"f": "w", "value": v} for v in range(3)]),
                 g.once({"f": "end"})), [0] * 5)),
    "reserve": lambda g, i: _with_threads(g, [0, 1, 2, 3], lambda: by_processes(
        g.reserve(2, {"f": "w"}, {"f": "r"}), [0, 1, 2, 3, 7])),
    "sequential_keys": lambda g, i: drain(i.sequential_generator(
        range(3), lambda k: g.limit(2, g.mix([{"f": "r"}, {"f": "w"}])))),
    "concurrent_keys": lambda g, i: _with_threads(
        g, [0, 1, 2, 3], lambda: by_processes(i.concurrent_generator(
            2, itertools.count(), lambda k: g.limit(
                5, g.mix([{"f": "read"}, {"f": "write", "value": k}]))),
            [0, 1, 2, 3] * 8)),
    "etcd_keys": lambda g, i: _with_threads(
        g, list(range(6)), lambda: by_processes(i.concurrent_generator(
            3, itertools.count(), lambda k: g.limit(
                10, g.stagger(0.0005, g.mix([g.cas, {"f": "read"}])))),
            list(range(6)) * 12, test={**TEST, "concurrency": 6})),
}


def _with_threads(g, threads, fn):
    with g.with_threads(threads):
        return fn()


@pytest.mark.parametrize("name", sorted(CASES))
def test_drained_ops_equal(name):
    out = {}
    for pkg, (g, i) in PACKAGES.items():
        random.seed(20260801)
        out[pkg] = CASES[name](g, i)
    assert out["port"] == out["jax"]
    assert out["port"], "the case drew nothing"


def test_process_mapping_equal():
    for p in (0, 3, 6, "nemesis"):
        assert (tgen.process_to_thread(TEST, p)
                == jgen.process_to_thread(TEST, p))
        assert tgen.process_to_node(TEST, p) == jgen.process_to_node(TEST, p)


def test_validate_raises_in_both():
    for g in (jgen, tgen):
        with pytest.raises(g.InvalidOp):
            g.op_and_validate(lambda: 42, TEST, 0)


# ---------------------------------------------------------------------------
# snapshot / restore (tests/test_checkpoint.py), across packages

CKPT_TEST = {"concurrency": 2, "nodes": ["n1", "n2"]}


def _phases(g):
    return g.phases(g.seq([{"f": "w", "value": v} for v in range(6)]),
                    g.once({"f": "end"}))


SNAPSHOT_CASES = {
    # name: (builder, draws before the snapshot as [(process, n)])
    "phases": (_phases, [(0, 3)]),
    "limit": (lambda g: g.limit(5, {"f": "r"}), [(0, 2)]),
    "mix_rng": (lambda g: g.mix([{"f": "a"}, {"f": "b"}, {"f": "c"}],
                                rng=random.Random(7)), [(0, 5)]),
    "concat": (lambda g: g.concat(g.seq([{"f": "a1"}, {"f": "a2"}]),
                                  g.seq([{"f": "b1"}, {"f": "b2"}])),
               [(0, 2), (1, 1)]),
    "interruptible": (lambda g: g.interruptible(
        g.limit(4, {"f": "r"}), threading.Event()), [(0, 1)]),
    "mix_in_phases": (lambda g: g.phases(
        g.mix([{"f": "a"}, {"f": "b"}], rng=random.Random(3)),
        g.once({"f": "end"})), [(0, 4)]),
    "unarmed_time_limit": (lambda g: g.time_limit(30, {"f": "r"}), []),
    "etcd_shape": (lambda g: g.interruptible(g.time_limit(60, g.nemesis(
        g.seq(itertools.cycle([{"type": "info", "f": "start"},
                               {"type": "info", "f": "stop"}])),
        g.limit(9, g.mix([{"f": "read"}, {"f": "write", "value": 1}],
                         rng=random.Random(5))))), threading.Event()),
        [("nemesis", 3), (0, 4)]),
}


def _snap(g, tree):
    """A snapshot as the checkpoint file carries it (JSON), with a
    time limit's remaining budget (this run's clock) reduced to its
    presence."""
    s = json.loads(json.dumps(g.snapshot(tree)))

    def fix(node):
        st = node.get("s")
        if node["t"] == "TimeLimit" and st and st.get("remaining") is not None:
            st["remaining"] = "armed"
        for k in node.get("k", []):
            fix(k)
        return node

    return fix(s)


@pytest.mark.parametrize("name", sorted(SNAPSHOT_CASES))
def test_snapshots_equal_and_restore_across(name):
    build, before = SNAPSHOT_CASES[name]
    trees, snaps = {}, {}
    procs = sorted({p for p, _ in before if isinstance(p, int)} | {0})
    with jgen.with_threads([0]), tgen.with_threads([0]):
        for pkg, (g, _) in PACKAGES.items():
            random.seed(3)
            trees[pkg] = build(g)
            for p, n in before:
                draws(trees[pkg], n, process=p, test=CKPT_TEST)
            snaps[pkg] = _snap(g, trees[pkg])
        assert snaps["port"] == snaps["jax"]
        raw = {pkg: json.loads(json.dumps(g.snapshot(trees[pkg])))
               for pkg, (g, _) in PACKAGES.items()}
        # each package restores the other's snapshot into a fresh tree
        for pkg, other in (("port", "jax"), ("jax", "port")):
            g = PACKAGES[pkg][0]
            fresh = build(g)
            g.restore(fresh, raw[other])
            assert _snap(g, fresh) == snaps[pkg]
            rest = {q: draws(fresh, 20, process=q, test=CKPT_TEST)
                    for q in procs}
            orig = {q: draws(trees[pkg], 20, process=q, test=CKPT_TEST)
                    for q in procs}
            assert rest == orig


def test_shape_mismatch_raises_in_both():
    snap = jgen.snapshot(jgen.limit(2, {"f": "r"}))
    with pytest.raises(ValueError, match="shape mismatch"):
        tgen.restore(tgen.once({"f": "r"}), snap)
