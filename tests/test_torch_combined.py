"""The port's fault packages (`jepsen_tpu_torch.nemesis.combined`) against
the JAX package's: targeters, package builders and composition, the
process, corruption and packet nemeses over recording DBs and remotes,
`wire_package`, full-engine runs over the in-memory register, and
three-node runs of the etcd suite's simulated cluster (a kill+partition
package and the five-family one, a recording clock setter, the port on
`device="cpu"`): the same nemesis op sequences, per-key verdicts and
recovery dicts in both packages. The cases of
tests/test_nemesis_combined.py; every member process a run starts is
stopped in a finalizer."""

from __future__ import annotations

import glob
import itertools
import json
import os
import random
import signal

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import core as jcore
from jepsen_tpu import db as jdb
from jepsen_tpu import generator as jgen
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu import net as jnet
from jepsen_tpu import testlib as jtl
from jepsen_tpu.control import DummyRemote as JDummy
from jepsen_tpu.control import LocalRemote as JLocal
from jepsen_tpu.dbs import etcd as jetcd
from jepsen_tpu.dbs import etcd_sim as jetcd_sim
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.nemesis import combined as jcomb
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import core as tcore
from jepsen_tpu_torch import db as tdb
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch import nemesis as tnemesis
from jepsen_tpu_torch import net as tnet
from jepsen_tpu_torch import testlib as ttl
from jepsen_tpu_torch.control import DummyRemote as TDummy
from jepsen_tpu_torch.control import LocalRemote as TLocal
from jepsen_tpu_torch.dbs import etcd as tetcd
from jepsen_tpu_torch.dbs import etcd_sim as tetcd_sim
from jepsen_tpu_torch.history import Op as TOp
from jepsen_tpu_torch.nemesis import combined as tcomb

NODES = ["n1", "n2", "n3", "n4", "n5"]


class P:
    """One package's modules under common names."""

    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)


JAX = P("jax", comb=jcomb, db=jdb, gen=jgen, Dummy=JDummy, Op=JOp,
        core=jcore, checker=jchecker, ind=jind, models=jmodels, net=jnet,
        tl=jtl, Local=JLocal, etcd=jetcd, etcd_sim=jetcd_sim, cpu={})
PORT = P("port", comb=tcomb, db=tdb, gen=tgen, Dummy=TDummy, Op=TOp,
         core=tcore, checker=tchecker, ind=tind, models=tmodels, net=tnet,
         tl=ttl, Local=TLocal, etcd=tetcd, etcd_sim=tetcd_sim,
         cpu={"device": "cpu"})
PKGS = (JAX, PORT)


def both(fn) -> dict:
    return {p.name: fn(p) for p in PKGS}


def proc_db(p):
    """A DB of package p recording every process-protocol call."""

    class FakeProcDB(p.db.DB, p.db.Kill, p.db.Pause):
        def __init__(self):
            self.calls = []

        def setup(self, test, node): ...
        def teardown(self, test, node): ...

        def kill(self, test, node):
            self.calls.append(("kill", node))

        def start(self, test, node):
            self.calls.append(("start", node))

        def pause(self, test, node):
            self.calls.append(("pause", node))

        def resume(self, test, node):
            self.calls.append(("resume", node))

        def alive(self, test, node):
            return True

    return FakeProcDB()


# ---------------------------------------------------------------------------
# Pure helpers

@pytest.mark.parametrize("n", [3, 4, 5, 6, 7])
def test_db_nodes_equal(n):
    def run(p):
        nodes = [f"n{i}" for i in range(n)]
        rng = random.Random(n)
        t = {"nodes": nodes}
        out = [p.comb.db_nodes(t, s, rng) for s in
               ("one", "minority", "majority", "all", "primaries",
                "majority", "one")]
        out.append(p.comb.db_nodes(t, [nodes[-1], nodes[0]]))
        out.append(p.comb.db_nodes(t, lambda ns: ns[-2:]))
        with pytest.raises(ValueError):
            p.comb.db_nodes(t, "everyone")
        return out

    out = both(run)
    assert out["port"] == out["jax"]


def test_db_nodes_asks_a_primary_db():
    def run(p):
        class Prim(p.db.DB, p.db.Primary):
            def setup(self, test, node): ...
            def teardown(self, test, node): ...
            def setup_primary(self, test, node): ...
            def primaries(self, test):
                return ["n3"]

        return p.comb.db_nodes({"nodes": NODES, "db": Prim()}, "primaries")

    assert both(run) == {"jax": ["n3"], "port": ["n3"]}


@pytest.mark.parametrize("spec", ["kill", "kill,partition",
                                  "partition, clock ,pause", "parts",
                                  "none", "fs-break", None, "", ",",
                                  "kill,wat", "wat,nope"])
def test_parse_fault_spec_equal(spec):
    def run(p):
        try:
            return p.comb.parse_fault_spec(spec)
        except ValueError as e:
            return ("ValueError", str(e))

    out = both(run)
    assert out["port"] == out["jax"]


def test_family_tables_equal():
    assert tcomb.FAULT_FAMILIES == jcomb.FAULT_FAMILIES
    assert tcomb.NODE_SPECS == jcomb.NODE_SPECS
    assert tcomb.FAMILY_FS == jcomb.FAMILY_FS
    assert tcomb._F_FAMILY == jcomb._F_FAMILY


def test_builder_errors_equal():
    def run(p):
        opts = {"rng": random.Random(0), "interval": 0}
        errs = []
        for fn in (
                lambda: p.comb.compose_packages(
                    [p.comb.kill_package({**opts, "db": proc_db(p)})] * 2),
                lambda: p.comb.compose_packages([]),
                lambda: p.comb.nemesis_package(faults=("gremlins",)),
                lambda: p.comb.kill_package({**opts, "db": object()}),
                lambda: p.comb.pause_package({**opts, "db": None}),
                lambda: p.comb.file_corruption_package(opts)):
            with pytest.raises(ValueError) as ei:
                fn()
            errs.append(str(ei.value))
        return errs

    out = both(run)
    assert out["port"] == out["jax"]
    assert "overlap" in out["port"][0]


# ---------------------------------------------------------------------------
# Packages over recording DBs and remotes

def test_routing_and_process_nemesis_equal():
    def run(p):
        db = proc_db(p)
        opts = {"rng": random.Random(0), "interval": 0, "db": db}
        pkg = p.comb.compose_packages([p.comb.kill_package(opts),
                                       p.comb.pause_package(opts)])
        test = {"nodes": list(NODES), "remote": p.Dummy(), "db": db}
        values = []
        for f, v in (("kill", ["n2", "n4"]), ("pause", ["n5"]),
                     ("kill", []), ("restart", None), ("resume", None),
                     ("kill", ["n3"])):
            out = pkg.nemesis.invoke(test, p.Op("nemesis", "invoke", f, v))
            values.append((out.type, out.f, out.value))
        ledger = pkg.nemesis.active_faults()
        with pytest.raises(ValueError):
            pkg.nemesis.invoke(test, p.Op("nemesis", "invoke", "nope", None))
        pkg.nemesis.teardown(test)
        fresh = p.comb.ProcessNemesis(proc_db(p), "kill")
        fresh.restore_faults(ledger)
        return values, db.calls, ledger, fresh.active_faults()

    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"][2] == [{"kind": "process-kill", "heal_f": "restart",
                               "nodes": ["n3"]}]


def test_corruption_and_packet_commands_equal():
    def run(p):
        remote = p.Dummy()
        test = {"nodes": list(NODES), "remote": remote, "net": p.net.iptables}
        corr = p.comb.FileCorruptor()
        outs = [corr.invoke(test, p.Op("nemesis", "invoke", "corrupt-file", [
            {"node": "n1", "path": "/d/wal", "kind": "truncate",
             "bytes": 7},
            {"node": "n2", "path": "/d/wal", "kind": "bitflip",
             "offset": 9, "byte": 200},
            {"node": "n3", "path": "/d/wal", "kind": "bitflip"}])).value]
        with pytest.raises(ValueError):
            corr.invoke(test, p.Op("nemesis", "invoke", "corrupt-file", [
                {"node": "n1", "path": "/d", "kind": "shred"}]))
        pk = p.comb.PacketNemesis()
        for f, v in (("packet-start", "flaky"), ("packet-start", None)):
            outs.append(pk.invoke(test, p.Op("nemesis", "invoke", f, v)).value)
        outs.append(pk.active_faults())
        outs.append(pk.invoke(test, p.Op("nemesis", "invoke", "packet-stop",
                                         None)).value)
        pk.restore_faults([{"behavior": "flaky"}])
        outs.append(pk.active_faults())
        pk.teardown(test)
        return outs, remote.commands

    out = both(run)
    assert out["port"] == out["jax"]


def _gen_ops(p, g, test, process="nemesis", n=100) -> list:
    out = []
    while g is not None and len(out) < n:
        o = p.gen.op(g, test, process)
        if o is None:
            break
        out.append(json.loads(json.dumps(o, sort_keys=True, default=sorted)))
    return out


@pytest.mark.parametrize("faults", [("partition",), ("kill", "pause"),
                                    tuple(jcomb.FAULT_FAMILIES)])
def test_package_schedules_and_metadata_equal(faults):
    def run(p):
        pkg = p.comb.nemesis_package(
            faults=faults, db=proc_db(p), seed=7, interval=0, fault_ops=10,
            corrupt_paths=["/d/wal", lambda t, n: f"/d/{n}.log"])
        test = {"nodes": list(NODES), "db": None}
        return (_gen_ops(p, pkg.generator, test),
                _gen_ops(p, pkg.final_generator, test),
                sorted(pkg.fs),
                {k: {kk: sorted(vv) for kk, vv in v.items()}
                 for k, v in pkg.families.items()},
                [{k: sorted(v) if isinstance(v, (set, frozenset)) else v
                  for k, v in d.items()} for d in pkg.perf["nemeses"]])

    out = both(run)
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 10


def test_wire_package_equal():
    def run(p):
        pkg = p.comb.nemesis_package(faults=("kill", "clock"),
                                     db=proc_db(p), seed=3, interval=0,
                                     fault_ops=4)
        test = {"generator": p.gen.limit(3, p.gen.cas),
                "checker": p.checker.unbridled_optimism(),
                "plot": {"title": "t"}}
        p.comb.wire_package(test, pkg, {"time_limit": 5,
                                        "stability_period": 2.0,
                                        "stability_generator": p.gen.cas,
                                        "recovery_min_ok": 3})
        bare = p.comb.wire_package({}, pkg, {})
        return (sorted(test), test["stability_period"],
                {k: {kk: sorted(vv) for kk, vv in v.items()}
                 for k, v in test["fault_families"].items()},
                sorted(test["plot"]), type(test["checker"]).__name__,
                sorted(test["checker"].checker_map),
                test["checker"].checker_map["recovery"].min_ok,
                type(bare["checker"]).__name__)

    out = both(run)
    assert out["port"] == out["jax"]


# ---------------------------------------------------------------------------
# Full-engine runs over the in-memory register

def _atom_run(p, seed):
    clock_sets = []
    db = proc_db(p)
    test = p.tl.noop_test()
    test.update({
        "name": None, "nodes": list(NODES), "remote": p.Dummy(),
        "net": p.net.noop, "db": db,
        "client": p.tl.AtomClient(p.tl.SharedAtom()),
        "model": p.models.cas_register(),
        "checker": p.checker.linearizable(algorithm="host", **p.cpu),
        "concurrency": 4, "generator": p.gen.limit(60, p.gen.cas),
    })
    pkg = p.comb.nemesis_package(
        faults=("partition", "clock", "kill", "pause", "corruption"),
        db=db, seed=seed, interval=0, fault_ops=12,
        corrupt_paths=["/var/log/db.log"],
        set_time_fn=lambda t, node, at: clock_sets.append(node))
    p.comb.wire_package(test, pkg, {
        "time_limit": 30, "stability_period": 0.2,
        "stability_generator": p.gen.limit(40, p.gen.cas),
        "recovery_min_ok": 1})
    res = p.core.run(test)
    sched = [(o.type, o.f, json.loads(json.dumps(o.value, default=str)))
             for o in res["history"] if o.process == "nemesis"]
    r = res["results"]
    return (sched, sorted(set(clock_sets)), r["valid"],
            r["recovery"]["valid"], r["recovery"]["faults_seen"],
            sorted(set(db.calls)))


@pytest.mark.parametrize("seed", [1, 1234])
def test_seeded_engine_fault_history_equal(seed):
    random.seed(seed)
    out = both(lambda p: _atom_run(p, seed))
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][2] is True


# ---------------------------------------------------------------------------
# The etcd suite's simulated cluster, three nodes, in both packages

SIM_NODES = ["n1", "n2", "n3"]
SIM_TIME_LIMIT = 8


def _stop_members(root):
    for pidfile in glob.glob(os.path.join(root, "**", "etcd.pid"),
                             recursive=True):
        try:
            with open(pidfile) as f:
                os.kill(int(f.read().strip()), signal.SIGKILL)
        except (OSError, ValueError):
            pass


def _sim_fault_run(p, root, faults, seed, **pkg_opts):
    """`_sim_fault_run` of tests/test_nemesis_combined.py in package p, at
    a SIM_TIME_LIMIT-s limit: (nemesis ops as (type, f, value) with the
    run's root left out, per-key verdicts, recovery dict)."""
    remote = p.Local(root=os.path.join(root, "nodes"))
    archive = os.path.join(root, "etcd-sim.tar.gz")
    p.etcd_sim.build_archive(archive, os.path.join(root, "shared",
                                                   "state.json"))
    cfg = {
        "addr_fn": lambda n: "127.0.0.1",
        "client_ports": {n: tetcd_sim.free_port() for n in SIM_NODES},
        "peer_ports": {n: tetcd_sim.free_port() for n in SIM_NODES},
        "dir": lambda n: os.path.join(remote.node_dir(n), "opt", "etcd"),
        "sudo": None,
    }
    database = p.etcd.EtcdDB(version="sim", url=f"file://{archive}",
                             ready_timeout=30.0)

    def workload(start):
        return p.gen.clients(p.ind.concurrent_generator(
            3, itertools.count(start), lambda k: p.gen.limit(
                25, p.gen.stagger(0.01, p.gen.mix(
                    [p.etcd.r, p.etcd.w, p.etcd.cas])))))

    test = {
        "name": None, "nodes": SIM_NODES, "remote": remote, "etcd": cfg,
        "db": database, "client": p.etcd.EtcdClient(timeout=1.0), "os": None,
        "net": p.net.noop, "concurrency": 6,
        "model": p.models.CASRegister(),
        "checker": p.ind.checker(p.checker.linearizable(**p.cpu)),
        "generator": workload(0),
    }
    pkg = p.comb.nemesis_package(faults=faults, db=database, seed=seed,
                                 interval=0.3, fault_ops=6, **pkg_opts)
    p.comb.wire_package(test, pkg, {
        "time_limit": SIM_TIME_LIMIT, "stability_period": 1.0,
        "stability_generator": workload(10_000), "recovery_min_ok": 1})
    random.seed(seed)
    try:
        result = p.core.run(test)
    finally:
        _stop_members(root)
    ops = [(o.type, o.f, json.loads(json.dumps(o.value, default=str)
                                    .replace(root, "<root>")))
           for o in result["history"] if o.process == "nemesis"]
    res = result["results"]
    keys = {k: r["valid"] for k, r in res["workload"]["results"].items()}
    return ops, keys, res["recovery"], res["valid"]


def _sim_both(tmp_path, faults, seed, kw):
    out = {}
    for p in PKGS:
        root = str(tmp_path / p.name)
        try:
            out[p.name] = _sim_fault_run(p, root, faults, seed, **kw(p))
        finally:
            _stop_members(root)
    return out


def test_sim_kill_partition_equal(tmp_path):
    out = _sim_both(tmp_path, ("kill", "partition"), 5, lambda p: {})
    (ops, keys, rec, valid), jax = out["port"], out["jax"]
    assert ops == jax[0]
    assert {f for _, f, _ in ops} >= {"restart", "stop-partition"}
    assert keys and set(keys.values()) == {True}
    assert set(jax[1].values()) == {True}
    assert valid is True and jax[3] is True
    assert (rec["valid"], rec["faults_seen"]) == (
        jax[2]["valid"], jax[2]["faults_seen"])
    assert rec["valid"] is True and rec["post_heal_ok_count"] >= 1


def test_sim_five_families_equal(tmp_path):
    """The JAX package's five-family acceptance run (a `slow` class
    there, at 45 s) at a SIM_TIME_LIMIT-s limit, in both packages."""
    clock_sets = {}
    faults = ("partition", "clock", "kill", "pause", "corruption")

    def kw(p):
        sets = clock_sets.setdefault(p.name, [])
        return {"corrupt_paths": [
                    lambda t, n: f"{p.etcd.node_dir(t, n)}/etcd.log"],
                "set_time_fn": lambda t, node, at: sets.append(node)}

    out = _sim_both(tmp_path, faults, 21, kw)
    (ops, keys, rec, valid), jax = out["port"], out["jax"]
    assert ops == jax[0]
    assert keys and set(keys.values()) == {True}
    assert set(jax[1].values()) == {True}
    assert valid is True and jax[3] is True
    assert (rec["valid"], rec["faults_seen"]) == (
        jax[2]["valid"], jax[2]["faults_seen"])
    fs = [f for _, f, _ in ops]
    for fault_f, heal_f in [("start-partition", "stop-partition"),
                            ("scramble-clock", "reset-clock"),
                            ("kill", "restart"), ("pause", "resume")]:
        if fault_f in fs:
            assert heal_f in fs, f"{fault_f} never healed"
    if "scramble-clock" in fs:
        assert clock_sets["port"] and (
            sorted(set(clock_sets["port"])) == sorted(set(clock_sets["jax"])))


# ---------------------------------------------------------------------------
# The etcd suite's `test` subcommand with fault packages

SUITE = {"threads_per_key": 3, "ops_per_key": 30, "fault_ops": 4,
         "stability_period": 1.0}


def test_cli_fault_families_build_the_package(tmp_path):
    """`--nemesis kill,pause,clock` on the simulated cluster's recipe:
    the package's nemesis kept on the no-op network, clock faults to the
    recording setter; a named mode keeps the recipe's no-op nemesis."""
    from jepsen_tpu_torch import cli

    c = tetcd_sim.local_cluster(str(tmp_path), SIM_NODES)
    fn = tetcd_sim.local_test_fn(c, suite_opts=SUITE)
    t = fn({"nodes": SIM_NODES, "nemesis": "kill,pause,clock", "seed": 3,
            "nemesis_interval": 0.3})
    assert set(t["fault_families"]) == {"kill", "pause", "clock"}
    assert t["net"] is tnet.noop and t["stability_period"] == 1.0
    clock = t["nemesis"].nemeses[frozenset({"scramble-clock",
                                            "reset-clock"})]
    inner = next(iter(clock.nemeses.values()))
    inner.set_time_fn(t, "n2", 1.0)
    assert c["clock_sets"] == [("n2", 1.0)]
    t = fn({"nodes": SIM_NODES, "nemesis": "parts"})
    assert t["nemesis"] is tnemesis.noop and t["net"] is None
    assert "fault_families" not in t
    assert cli.single_test_cmd(fn, opt_spec=tetcd._opt_spec)


def test_cli_clock_always_recorded(tmp_path):
    """The recipe's clock setter cannot be replaced: a `set_time_fn` in
    the options gives way to `recording_clock`, so no run on the
    simulated cluster sets this machine's clock."""
    def must_not_run(test, node, t):
        raise AssertionError("a caller's clock setter ran")

    c = tetcd_sim.local_cluster(str(tmp_path), SIM_NODES)
    fn = tetcd_sim.local_test_fn(
        c, suite_opts={**SUITE, "set_time_fn": must_not_run})
    t = fn({"nodes": SIM_NODES, "nemesis": "clock", "seed": 1,
            "set_time_fn": must_not_run})
    clock = t["nemesis"].nemeses[frozenset({"scramble-clock",
                                            "reset-clock"})]
    next(iter(clock.nemeses.values())).set_time_fn(t, "n3", 2.0)
    assert c["clock_sets"] == [("n3", 2.0)]


@pytest.mark.parametrize("mode", ["fs-break", "fs-break-1pct"])
def test_cli_fs_break_refused_before_any_node_command(tmp_path, mode):
    """`test --nemesis fs-break` on the simulated cluster's recipe exits
    254 before any command reaches a node: its FUSE layer would mount
    over the members' data as the caller (`LocalRemote` drops `sudo`)
    and the recipe could not inject through it. Suites with real nodes
    still wire it (test_torch_nemesis)."""
    from jepsen_tpu_torch import cli

    c = tetcd_sim.local_cluster(str(tmp_path / "cluster"), SIM_NODES)
    c["remote"] = remote = TDummy()
    rc = cli.run_cli(
        cli.single_test_cmd(tetcd_sim.local_test_fn(c, suite_opts=SUITE),
                            opt_spec=tetcd._opt_spec),
        ["test", *[a for n in SIM_NODES for a in ("--node", n)],
         "--concurrency", "2n", "--time-limit", "5", "--store-dir",
         str(tmp_path / "store"), "--device", "cpu", "--nemesis", mode])
    assert rc == 254
    assert (remote.commands, remote.uploads) == ([], [])
    assert not os.path.exists(tmp_path / "cluster" / "nodes")
    assert not os.path.exists(tmp_path / "store" / "etcd")


def test_cli_nemesis_schedule_replays_exactly(tmp_path):
    """`test --nemesis-schedule FILE` on three simulated members, on the
    CPU: exit 0, every key valid, recovery valid, and the run's nemesis
    ops the document's events then its final ops."""
    from jepsen_tpu_torch import cli, store

    root = str(tmp_path / "cluster")
    doc = tcomb.materialize_schedule(
        faults=["kill", "pause", "clock", "partition"], seed=4,
        interval=0.3, fault_ops=4, nodes=SIM_NODES)
    path = tmp_path / "schedule.json"
    path.write_text(tcomb.schedule_to_json(doc))
    c = tetcd_sim.local_cluster(root, SIM_NODES)
    sd = str(tmp_path / "store")
    try:
        rc = cli.run_cli(
            cli.single_test_cmd(tetcd_sim.local_test_fn(c, suite_opts=SUITE),
                                opt_spec=tetcd._opt_spec),
            ["test", *[a for n in SIM_NODES for a in ("--node", n)],
             "--concurrency", "2n", "--time-limit", "5", "--store-dir", sd,
             "--device", "cpu", "--nemesis-schedule", str(path)])
    finally:
        _stop_members(root)
    assert rc == 0
    run_dir = os.path.realpath(os.path.join(sd, "etcd", "latest"))
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    assert res["recovery"]["valid"] is True
    assert res["workload"]["indep"]["valid"] is True
    hist = store.load_history({"name": "etcd",
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    nem = [o for o in hist if o.process == "nemesis"][0::2]
    assert [(o.f, json.loads(json.dumps(o.value))) for o in nem] == [
        (e["f"], e["value"]) for e in doc["events"] + doc["final"]]
    if any(e["f"] == "scramble-clock" for e in doc["events"]):
        assert c["clock_sets"]
