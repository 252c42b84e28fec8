"""Full runs of the port's dgraph suite on simulated nodes with
device="cpu", at the sizes tests/test_dgraph_workloads.py and
tests/test_dgraph_nemesis.py use (2 nodes, a 3-s limit): every workload
(bank, delete, sequential, linearizable-register,
uid-linearizable-register, long-fork, types, set and upsert), and the
set workload under --kill-alpha and under --move-tablet. Each run is
valid (types: invalid, as the simulator's float64 decoding corrupts the
big integers), and its recorded history, given to the JAX package's
checker, gives the port's verdict dict."""

from __future__ import annotations

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import dgraph as jdgraph
from jepsen_tpu.dbs import dgraph_workloads as jdw
from jepsen_tpu.workloads import bank as jbank
from jepsen_tpu.workloads import long_fork as jlf

from jepsen_tpu_torch import core, nemesis
from jepsen_tpu_torch.dbs import dgraph, dgraph_sim
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def full_run(tmp_path, workload, nemesis_noop=True, **extra) -> dict:
    """The JAX package's _full_run on the port's recipe cluster,
    device="cpu"."""
    c = dgraph_sim.local_cluster(str(tmp_path), NODES)
    opts = {"workload": workload, "nodes": NODES, "remote": c["remote"],
            "archive_url": c["archive_url"], "dgraph": c["dgraph"],
            "concurrency": 4, "time_limit": 3, "quiesce": 0.2,
            "store_dir": str(tmp_path / "store"), "device": "cpu", **extra}
    t = dgraph.dgraph_test(opts)
    t["os"] = None
    t["net"] = None
    if nemesis_noop:
        t["nemesis"] = nemesis.noop
    return core.run(t)


def per_key(checker):
    """independent.checker over one named part, as the port's runs hold
    it (the port's keys carry the timeline too, stripped before the
    comparison)."""
    return jind.checker(checker)


JAX_PARTS = {
    "bank": ("bank", lambda: jbank.checker()),
    "delete": ("deletes", lambda: per_key(jchecker.compose(
        {"deletes": jdw.DeleteChecker()}))),
    "sequential": ("sequential", lambda: per_key(jchecker.compose(
        {"sequential": jdw.SequentialChecker()}))),
    "linearizable-register": ("register", lambda: per_key(jchecker.compose(
        {"linearizable": jchecker.linearizable()}))),
    "uid-linearizable-register": ("register", lambda: per_key(
        jchecker.compose({"linearizable": jchecker.linearizable()}))),
    "long-fork": ("long-fork", lambda: jlf.checker(2)),
    "types": ("types", lambda: jdw.TypesChecker()),
    "set": ("set", lambda: jchecker.set_checker()),
    "upsert": ("upsert", lambda: jdgraph.UpsertChecker()),
}

RUNS = {
    "bank": {},
    "delete": dict(ops_per_key=30),
    "sequential": dict(ops_per_key=30),
    "linearizable-register": dict(per_key_limit=40),
    "uid-linearizable-register": dict(per_key_limit=40),
    "long-fork": {},
    "types": dict(time_limit=30, type_cases=40, quiesce=0.3),
    "set": dict(stagger=0.02),
    "upsert": {},
}


def strip_keys(got: dict, inner: str) -> dict:
    """A per-key result with each key's `inner` part alone (the port's
    keys also hold the timeline)."""
    return {**got, "results": {k: {inner: r[inner], "valid": r[inner][
        "valid"]} for k, r in got["results"].items()}}


@pytest.mark.parametrize("workload", sorted(RUNS))
def test_full_run_matches_the_jax_checker(tmp_path, workload):
    result = full_run(tmp_path, workload, **RUNS[workload])
    res, hist = result["results"], result["history"]
    part, make = JAX_PARTS[workload]
    got = res[part]
    if workload == "types":
        assert got["valid"] is False and got["error_count"] > 0, got
        for err in got["errors"]:
            assert err["wrote"] != err["read"]
            assert abs(err["wrote"]) > (1 << 53)
    else:
        assert res["valid"] is True, res
    test = {"model": jmodels.CASRegister(),
            **{k: result[k] for k in ("accounts", "total_amount",
                                      "max_transfer") if k in result}}
    want = make().check(test, to_jax(hist), {})
    inner = {"deletes": "deletes", "sequential": "sequential",
             "register": "linearizable"}.get(part)
    if inner is not None:
        got = strip_keys(got, inner)
    assert normalise(got) == normalise(want)
    assert sum(o.type == "ok" for o in hist) > 5


@pytest.mark.parametrize("flag,fs", [
    ("kill_alpha", {"kill-alpha", "restart-alpha"}),
    ("move_tablet", {"move-tablet"})])
def test_full_run_under_a_failure_mode(tmp_path, flag, fs):
    """The set workload under one failure mode (its cycle deterministic),
    healed by the final generator before the final read: valid, the mode's
    ops in the history, and the set dict the JAX package's."""
    result = full_run(tmp_path, "set", nemesis_noop=False, interval=1.0,
                      final_delay=0.3, time_limit=4, quiesce=0.5,
                      stagger=0.02, **{flag: True})
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert fs <= {o.f for o in hist if o.process == "nemesis"}
    want = jchecker.set_checker().check({}, to_jax(hist), {})
    assert normalise(res["set"]) == normalise(want)
