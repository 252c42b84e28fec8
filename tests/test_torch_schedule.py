"""The port's schedule documents (`jepsen_tpu_torch.nemesis.combined`)
and fuzz documents (`jepsen_tpu_torch.fuzz.schedule.to_nemesis_doc`)
against the JAX package's: byte-identical JSON for every family alone,
all six composed, seeds 0-7 and several `fault_ops`; documents written
by either package replayed through the other's `schedule_from_json`,
and `schedule_to_json(schedule_from_json(s)) == s`. The cases of
tests/test_nemesis_schedule.py."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu.fuzz import schedule as jfs
from jepsen_tpu.nemesis import combined as jcomb
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch.fuzz import schedule as tfs
from jepsen_tpu_torch.nemesis import combined as tcomb

ALL = list(tcomb.FAULT_FAMILIES)
PKGS = {"jax": (jcomb, jgen), "port": (tcomb, tgen)}


def _opts(faults, seed=11, **kw):
    return {"faults": list(faults), "seed": seed, "fault_ops": 8,
            "interval": 4.0, "corrupt_paths": ["/var/lib/db/wal"], **kw}


def _docs(opts) -> dict:
    return {name: comb.schedule_to_json(dict(opts))
            for name, (comb, _) in PKGS.items()}


def _replay(comb, gen_mod, s) -> list:
    """Every (f, value) the replayed package's main generator emits."""
    pkg = comb.schedule_from_json(s, db=comb._ScheduleDB(),
                                  corrupt_paths=["/var/lib/db/wal"],
                                  pace=False)
    test = {"nodes": json.loads(s)["nodes"]}
    out = []
    while True:
        o = gen_mod.op(pkg.generator, test, "nemesis")
        if o is None:
            return out
        out.append((o["f"], o.get("value")))


@pytest.mark.parametrize("fam", ALL)
@pytest.mark.parametrize("seed", range(8))
def test_single_family_documents_equal(fam, seed):
    d = _docs(_opts([fam], seed=seed))
    assert d["port"] == d["jax"]
    assert len(json.loads(d["port"])["events"]) == 8


@pytest.mark.parametrize("fault_ops", [1, 6, 18, 40])
@pytest.mark.parametrize("seed", range(8))
def test_composed_documents_equal(seed, fault_ops):
    d = _docs(_opts(ALL, seed=seed, fault_ops=fault_ops,
                    nodes=["a", "b", "c"], interval=1.5))
    assert d["port"] == d["jax"]


def test_unseeded_options_and_placeholder_paths_equal():
    """No corrupt_paths (the null-path placeholder), the default five
    nodes and the default fault_ops and interval."""
    opts = {"faults": ["corruption", "kill", "pause"], "seed": 3}
    d = _docs(opts)
    assert d["port"] == d["jax"]
    assert json.loads(d["port"])["fault_ops"] == 16


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
@pytest.mark.parametrize("faults", [["partition"], ["kill", "clock"], ALL])
def test_documents_replay_across_packages(writer, reader, faults):
    s = PKGS[writer][0].schedule_to_json(_opts(faults, fault_ops=12))
    comb, gen_mod = PKGS[reader]
    pkg = comb.schedule_from_json(s, db=comb._ScheduleDB(),
                                  corrupt_paths=["/var/lib/db/wal"],
                                  pace=False)
    assert comb.schedule_to_json(pkg) == s
    assert sorted(pkg.families) == sorted(faults)
    assert _replay(comb, gen_mod, s) == [
        (e["f"], e.get("value")) for e in json.loads(s)["events"]]


def test_roundtrip_via_file_and_errors(tmp_path):
    p = tmp_path / "sched.json"
    s = tcomb.schedule_to_json(_opts(["partition", "packet"]))
    p.write_text(s)
    assert tcomb.schedule_to_json(
        tcomb.load_schedule_file(str(p), pace=False)) == s
    with pytest.raises(ValueError, match="db.Kill"):
        tcomb.schedule_from_json(tcomb.schedule_to_json(_opts(["kill"])))
    with pytest.raises(ValueError, match="version"):
        tcomb.schedule_from_json({"version": 2, "events": []})
    with pytest.raises(ValueError, match="only packages from"):
        tcomb.schedule_to_json(tcomb.nemesis_package(faults=["partition"]))


def test_replay_retargets_corruption_paths_as_jax():
    opts = _opts(["corruption"])
    del opts["corrupt_paths"]
    out = {}
    for name, (comb, gen_mod) in PKGS.items():
        s = comb.schedule_to_json(dict(opts))
        pkg = comb.schedule_from_json(s, corrupt_paths=["/a", "/b"],
                                      pace=False)
        test = {"nodes": json.loads(s)["nodes"]}
        seen = []
        while (o := gen_mod.op(pkg.generator, test, "nemesis")) is not None:
            seen.append(o["value"])
        out[name] = seen
    assert out["port"] == out["jax"]
    assert {spec["path"] for v in out["port"] for spec in v} == {"/a"}


def test_same_seed_across_processes():
    """The port's document bytes do not depend on the interpreter
    launch (hash seeds, id order), and equal the JAX package's."""
    prog = ("from jepsen_tpu_torch.nemesis import combined as C; "
            "print(C.schedule_to_json({'faults': list(C.FAULT_FAMILIES), "
            "'seed': 123, 'fault_ops': 15, 'interval': 2.0, "
            "'corrupt_paths': ['/w']}))")
    outs = {subprocess.run([sys.executable, "-c", prog], capture_output=True,
                           text=True, check=True, timeout=120).stdout
            for _ in range(2)}
    assert len(outs) == 1
    assert outs.pop().strip() == jcomb.schedule_to_json(
        {"faults": ALL, "seed": 123, "fault_ops": 15, "interval": 2.0,
         "corrupt_paths": ["/w"]})


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_documents_equal(seed):
    sched = tfs.random_schedule(seed, tfs.DEFAULT_SPEC)
    assert (sched == jfs.random_schedule(seed, jfs.DEFAULT_SPEC)).all()
    kw = {"seed": seed} if seed % 2 else {
        "seed": seed, "nodes": [f"m{i}" for i in range(5)], "interval": 0.5}
    port = tfs.to_nemesis_doc(sched, tfs.DEFAULT_SPEC, **kw)
    jax = jfs.to_nemesis_doc(sched, jfs.DEFAULT_SPEC, **kw)
    dump = lambda d: json.dumps(d, sort_keys=True, separators=(",", ":"))
    assert dump(port) == dump(jax)
    if not port["events"]:
        return
    # a fuzz document replays through either package's combined
    for comb, gen_mod in PKGS.values():
        s = dump(port)
        pkg = comb.schedule_from_json(s, db=comb._ScheduleDB(),
                                      corrupt_paths=["/w"], pace=False)
        assert comb.schedule_to_json(pkg) == s


def test_dump_schedule_file_bytes_equal(tmp_path):
    sched = tfs.random_schedule(5, tfs.DEFAULT_SPEC)
    doc = tfs.dump_schedule_file(tmp_path / "p.json", sched, seed=5,
                                 interval=0.5)
    jfs.dump_schedule_file(tmp_path / "j.json", sched, seed=5, interval=0.5)
    assert (tmp_path / "p.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()
    assert tcomb.schedule_to_json(tcomb.load_schedule_file(
        str(tmp_path / "p.json"), db=tcomb._ScheduleDB(),
        corrupt_paths=["/w"], pace=False)) == tcomb.schedule_to_json(doc)


def test_replay_builds_callable_corrupt_paths_per_node():
    """A callable corrupt path is a per-node builder fn(test, node) on
    replay as in file_corruption_package (the JAX package's replay hands
    the callable itself to the corruptor)."""
    opts = _opts(["corruption"], fault_ops=6)
    del opts["corrupt_paths"]
    s = tcomb.schedule_to_json(opts)
    pkg = tcomb.schedule_from_json(
        s, corrupt_paths=[lambda t, n: f"{t['root']}/{n}/etcd.log"],
        pace=False)
    test = {"nodes": json.loads(s)["nodes"], "root": "/r"}
    specs = []
    while (o := tgen.op(pkg.generator, test, "nemesis")) is not None:
        specs.extend(o["value"])
    assert specs and all(sp["path"] == f"/r/{sp['node']}/etcd.log"
                         for sp in specs)
