"""The port's nemesis layer (`jepsen_tpu_torch.nemesis`, `net`,
`dbs.common`'s registry) against the JAX package's: the grudges for the
same seeded rng, the partitioner's and the process nemeses' command
streams over DummyRemote, compose routing, the active-fault ledgers, the
DB cycle, and the --nemesis forms (named modes, fault families, a
schedule file and fs-break wired as the JAX package's). The cases of
tests/test_nemesis.py."""

from __future__ import annotations

import json
import random

import pytest

from jepsen_tpu import db as jdb
from jepsen_tpu import nemesis as jnem
from jepsen_tpu import net as jnet
from jepsen_tpu.control import DummyRemote as JDummy
from jepsen_tpu.control import net as jcnet
from jepsen_tpu.history import Op as JOp
from jepsen_tpu_torch import db as tdb
from jepsen_tpu_torch import nemesis as tnem
from jepsen_tpu_torch.nemesis import combined as tcomb
from jepsen_tpu_torch import net as tnet
from jepsen_tpu_torch.control import DummyRemote as TDummy
from jepsen_tpu_torch.control import net as tcnet
from jepsen_tpu_torch.history import Op as TOp

NODES = ["n1", "n2", "n3", "n4", "n5"]
PKGS = {"jax": (jnem, jnet, JDummy, JOp), "port": (tnem, tnet, TDummy, TOp)}


def both(fn):
    """fn(package modules) in each package after the same seed."""
    out = {}
    for name, mods in PKGS.items():
        random.seed(99)
        out[name] = fn(*mods)
    return out


GRUDGES = {
    "bisect": lambda nem: nem.bisect(NODES),
    "split_one": lambda nem: nem.split_one(NODES, node="n3"),
    "split_one_rng": lambda nem: nem.split_one(NODES, rng=random.Random(4)),
    "complete_grudge": lambda nem: nem.complete_grudge(nem.bisect(NODES)),
    "bridge": lambda nem: nem.bridge(NODES),
    "majorities_ring": lambda nem: nem.majorities_ring(NODES),
    "majorities_ring_rng": lambda nem: nem.majorities_ring(
        NODES, rng=random.Random(5)),
    "majorities_ring_7": lambda nem: nem.majorities_ring(
        [f"m{i}" for i in range(7)], rng=random.Random(6)),
    "random_halves": lambda nem: nem.partition_random_halves(
        rng=random.Random(8)).grudge_fn(NODES),
    "random_node": lambda nem: nem.partition_random_node(
        rng=random.Random(9)).grudge_fn(NODES),
    "ring_partitioner": lambda nem: nem.partition_majorities_ring(
        rng=random.Random(10)).grudge_fn(NODES),
}


@pytest.mark.parametrize("name", sorted(GRUDGES))
def test_grudges_equal(name):
    out = both(lambda nem, *_: GRUDGES[name](nem))
    assert out["port"] == out["jax"]


def _partition_run(nem, net, Dummy, Op, which, monkeypatch):
    for cnet in (jcnet, tcnet):
        monkeypatch.setattr(cnet, "ip", lambda test, node: f"10.0.0.{node[-1]}")
    remote = Dummy()
    test = {"remote": remote, "nodes": list(NODES), "net": net.iptables}
    part = {"halves": nem.partition_halves,
            "random_halves": lambda: nem.partition_random_halves(
                rng=random.Random(3)),
            "ring": lambda: nem.partition_majorities_ring(
                rng=random.Random(3))}[which]()
    part.setup(test)
    start = part.invoke(test, Op("nemesis", "invoke", "start", None))
    ledger = json.loads(json.dumps(part.active_faults()))
    stop = part.invoke(test, Op("nemesis", "invoke", "stop", None))
    return (sorted(remote.commands), start.type, start.value, stop.value,
            ledger)


@pytest.mark.parametrize("which", ["halves", "random_halves", "ring"])
def test_partitioner_commands_equal(which, monkeypatch):
    out = both(lambda *m: _partition_run(*m, which, monkeypatch))
    assert out["port"] == out["jax"]
    cmds = out["port"][0]
    assert any("iptables" in c and "DROP" in c for _, c in cmds)


def test_compose_routing_equal():
    def run(nem, net, Dummy, Op):
        class Recording(nem.Nemesis):
            def __init__(self):
                self.fs = []

            def invoke(self, test, op):
                self.fs.append(op.f)
                return op.with_(type="info")

        a, b, inner = Recording(), Recording(), Recording()
        fmap = type("FMap", (dict,), {"__hash__": object.__hash__})
        comp = nem.compose({frozenset({"start-a", "stop-a"}): a,
                            frozenset({"start-b"}): b,
                            fmap({"outer-start": "start"}): inner})
        outs = [comp.invoke({}, Op("nemesis", "invoke", f, None)).f
                for f in ("start-a", "start-b", "outer-start", "stop-a")]
        with pytest.raises(ValueError):
            comp.invoke({}, Op("nemesis", "invoke", "nope", None))
        return outs, a.fs, b.fs, inner.fs

    out = both(run)
    assert out["port"] == out["jax"]


def test_process_nemeses_equal():
    def run(nem, net, Dummy, Op):
        remote = Dummy()
        test = {"remote": remote, "nodes": list(NODES)}
        hammer = nem.hammer_time("mydb", targeter=lambda nodes: [nodes[0]])
        vals = [hammer.invoke(test, Op("nemesis", "invoke", f, None)).value
                for f in ("start", "stop")]
        killed, revived = [], []
        stopper = nem.node_start_stopper(
            lambda nodes: nodes[:2],
            lambda t, n: killed.append(n) or "down",
            lambda t, n: revived.append(n) or "up")
        vals += [str(stopper.invoke(test, Op("nemesis", "invoke", f, None))
                     .value) for f in ("start", "start", "stop")]
        trunc = nem.truncate_file("/var/lib/db/log", drop_bytes=64,
                                  targeter=lambda nodes: [nodes[0]])
        trunc.invoke(test, Op("nemesis", "invoke", "truncate", None))
        flip = nem.bitflip_file("/var/lib/db/data",
                                targeter=lambda nodes: nodes[:2],
                                rng=random.Random(2))
        vals.append(str(flip.invoke(
            test, Op("nemesis", "invoke", "bitflip", None)).value))
        return vals, killed, revived, sorted(remote.commands)

    out = both(run)
    assert out["port"] == out["jax"]
    assert any("STOP" in c for _, c in out["port"][3])


def test_clock_scrambler_equal():
    def run(nem, net, Dummy, Op):
        remote = Dummy()
        test = {"remote": remote, "nodes": list(NODES)}
        sets = []
        clock = nem.clock_scrambler(
            5, rng=random.Random(12),
            set_time_fn=lambda r, n, t: sets.append((n, round(t, 3))))
        clock.setup(test)
        v = clock.invoke(test, Op("nemesis", "invoke", "scramble", None))
        ledger = clock.active_faults()
        clock.invoke(test, Op("nemesis", "invoke", "reset", None))
        return v.type, ledger, len(sets), sorted(n for n, _ in sets)

    out = both(run)
    assert out["port"] == out["jax"]


def test_fault_ledgers_cross_packages():
    """A ledger one package checkpointed rehydrates the other's
    nemesis, as core.resume does with a checkpoint from either."""
    j = jnem.partition_halves()
    j._grudge = {"n1": ["n2"], "n2": ["n1"]}
    t = tnem.partition_halves()
    t.restore_faults(json.loads(json.dumps(j.active_faults())))
    assert t._grudge == j._grudge
    assert t.active_faults() == j.active_faults()
    part, clock = tnem.partition_halves(), tnem.clock_scrambler(5)
    part._grudge = {"n1": ["n2"]}
    clock._scrambled = True
    fmap = type("FMap", (dict,), {"__hash__": object.__hash__})
    c = tnem.Compose({fmap({"part-start": "start", "part-stop": "stop"}):
                      part, frozenset({"scramble", "reset"}): clock})
    kinds = {e["kind"]: e["heal_f"] for e in c.active_faults()}
    assert kinds == {"partition": "part-stop", "clock": "reset"}
    assert tnem.Noop().active_faults() == []


def test_db_cycle_equal():
    def run(nem, net, Dummy, Op):
        db_mod = jdb if nem is jnem else tdb
        calls = []

        class Flaky(db_mod.DB):
            def __init__(self):
                self.fail = 1

            def setup(self, test, node):
                calls.append(("setup", node))
                if node == "n1" and self.fail:
                    self.fail -= 1
                    raise db_mod.SetupFailed("once")

            def teardown(self, test, node):
                calls.append(("teardown", node))

        db_mod.cycle({"nodes": NODES[:2], "db": Flaky()})
        return sorted(calls)

    out = both(run)
    assert out["port"] == out["jax"]


def test_nemesis_registry_and_unported_forms(tmp_path):
    from jepsen_tpu.dbs import common as jcmn
    from jepsen_tpu.dbs.etcd import EtcdDB as JEtcdDB
    from jepsen_tpu_torch.dbs import common as cmn
    from jepsen_tpu_torch.dbs import etcd

    db = etcd.EtcdDB("3.1.5")
    assert (set(cmn.standard_nemeses(db))
            == set(jcmn.standard_nemeses(JEtcdDB("3.1.5")))
            == {"none", "parts", "majority-ring"})
    with pytest.raises(ValueError):
        cmn.pick_nemesis(db, {"nemesis": "start-kill"})
    assert isinstance(cmn.pick_nemesis(db, {}), tnem.Partitioner)
    assert cmn.pick_nemesis(db, {"nemesis": "none"}) is tnem.noop
    from jepsen_tpu.nemesis import combined as jcomb

    assert cmn.FAULT_FAMILIES == jcomb.FAULT_FAMILIES
    for spec in ("kill", "kill,partition", "partition,clock,pause", "parts",
                 "none", None, ""):
        assert cmn.parse_fault_spec(spec) == jcomb.parse_fault_spec(spec)
    with pytest.raises(ValueError):
        cmn.parse_fault_spec("kill,bogus")
    assert cmn.FAULT_FAMILIES is tcomb.FAULT_FAMILIES
    assert cmn.parse_fault_spec is tcomb.parse_fault_spec
    # the fault-package and fs-break forms wire as the JAX package's
    from jepsen_tpu.dbs import etcd as jetcd
    from jepsen_tpu.nemesis import fsfault as jfs
    from jepsen_tpu_torch.nemesis import fsfault as tfs

    sched = tmp_path / "sched.json"
    sched.write_text(tcomb.schedule_to_json(
        {"faults": ["kill", "pause"], "seed": 2, "fault_ops": 4}))
    for opts in ({"nemesis": "kill,partition"}, {"nemesis": "kill,pause"},
                 {"nemesis": "parts", "nemesis_schedule": str(sched)}):
        t = etcd.etcd_test(dict(opts, nodes=["n1"], seed=1))
        j = jetcd.etcd_test(dict(opts, nodes=["n1"], seed=1))
        assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
        assert t["fault_families"] == j["fault_families"]
        assert sorted(t["checker"].checker_map) == ["recovery", "workload"]
    for name, mode in (("fs-break", "break-all"),
                       ("fs-break-1pct", "break-one-percent")):
        t = etcd.etcd_test({"nemesis": name, "nodes": ["n1"]})
        j = jetcd.etcd_test({"nemesis": name, "nodes": ["n1"]})
        assert isinstance(t["db"], tfs.FaultFsDB)
        assert isinstance(j["db"], jfs.FaultFsDB)
        assert isinstance(t["db"].inner, etcd.EtcdDB)
        assert (t["nemesis"].backend, t["nemesis"].manage_mounts,
                t["nemesis"].default_mode) == (
            j["nemesis"].backend, j["nemesis"].manage_mounts, mode)


def test_net_noop_and_iptables_commands_equal(monkeypatch):
    def run(nem, net, Dummy, Op):
        for cnet in (jcnet, tcnet):
            monkeypatch.setattr(cnet, "ip",
                                lambda test, node: f"10.0.0.{node[-1]}")
        remote = Dummy()
        test = {"remote": remote, "nodes": list(NODES)}
        net.noop.drop(test, "n1", "n2")
        net.iptables.drop(test, "n1", "n2")
        net.iptables.heal(test)
        net.iptables.slow(test)
        net.iptables.flaky(test)
        net.iptables.fast(test)
        return sorted(remote.commands)

    out = both(run)
    assert out["port"] == out["jax"]
