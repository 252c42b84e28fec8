"""The port's raftis suite (dbs/raftis.py on redis_sim.py) and logcabin
suite (dbs/logcabin.py on logcabin_sim.py) against the JAX package's, on
the cases of tests/test_consul_disque_raftis.py::TestRespSim and
::TestRaftis and tests/test_final_suites.py::TestLogCabin: the same RESP
command sequence (the disque job commands included) against both
packages' simulators gives the same replies; the raftis client's
taxonomy and the `treeops` contract ("CAS failed", a read of a missing
path) are the same; full runs on simulated nodes with device="cpu" are
valid and each recorded history gives the JAX package's linearizable
dict. Also each recipe (`redis_sim.local_test_fn`,
`logcabin_sim.local_test_fn`) through the CLI, fs-break refused, and
member processes and `treeops` processes that load neither torch nor
jax."""

from __future__ import annotations

import glob
import json
import os
import threading

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import logcabin as jlogcabin
from jepsen_tpu.dbs import logcabin_sim as jlsim
from jepsen_tpu.dbs import raftis as jraftis
from jepsen_tpu.dbs import redis_proto as jresp
from jepsen_tpu.dbs import redis_sim as jrsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, nemesis
from jepsen_tpu_torch.dbs import logcabin, logcabin_sim, raftis
from jepsen_tpu_torch.dbs import redis_proto, redis_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0

    srv = sim.Server(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sims(tmp_path):
    """(proto module, port) of the JAX package's RESP simulator and the
    port's, each on a fresh store."""
    srvs = [serve(jrsim, str(tmp_path / "jax.json")),
            serve(redis_sim, str(tmp_path / "port.json"))]
    yield [(jresp, srvs[0].server_address[1]),
           (redis_proto, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def replies(proto, port, calls) -> list:
    c = proto.RespConn("127.0.0.1", port)
    out = []
    try:
        for args in calls:
            try:
                out.append(c.call(*args))
            except proto.RespError as e:
                out.append(["error", str(e)])
    finally:
        c.close()
    return out


RESP_CASES = {
    "ping_get_set": [("PING",), ("GET", "r"), ("SET", "r", 5), ("GET", "r"),
                     ("SET", "r", "x y"), ("GET", "r"), ("GET", "other")],
    "unknown_command_errors": [("FLY",), ("PING",), ("fly", 1)],
    "job_lifecycle": [("ADDJOB", "q", "77", 100), ("ADDJOB", "q", "78", 100),
                      ("GETJOB", "TIMEOUT", 10, "COUNT", 1, "FROM", "q"),
                      ("ACKJOB", "D-00000001"), ("ACKJOB", "D-00000009"),
                      ("GETJOB", "COUNT", 5, "FROM", "q"),
                      ("ACKJOB", "D-00000002"),
                      ("GETJOB", "TIMEOUT", 10, "COUNT", 1, "FROM", "q"),
                      ("CLUSTER", "MEET", "127.0.0.1", 7711)],
}


@pytest.mark.parametrize("case", sorted(RESP_CASES))
def test_resp_simulators_reply_alike(sims, case):
    (jp, jport), (tp, tport) = sims
    got = replies(tp, tport, RESP_CASES[case])
    assert got == replies(jp, jport, RESP_CASES[case])
    if case == "ping_get_set":
        assert got[:4] == ["PONG", None, "OK", b"5"]
    elif case == "unknown_command_errors":
        assert got[0][0] == "error" and got[1] == "PONG"
    else:
        assert got[2][0][1] == b"D-00000001" and got[2][0][2] == b"77"
        assert got[3:5] == [1, 0] and got[-2] is None


# ---------------------------------------------------------------------------
# raftis (TestRaftis)

def raftis_taxonomy(mod, op_cls, port) -> list:
    t = {"raftis": {"addr_fn": lambda n: "127.0.0.1",
                    "ports": {"n1": port}}}
    c = mod.RaftisClient().open(t, "n1")
    out = [(r.type, r.value, r.error) for r in (
        c.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("read", None), ("write", 3), ("read", None), ("write", 4),
            ("read", None)))]
    with pytest.raises(ValueError):
        c.invoke(t, op_cls(0, "invoke", "frob", None))
    c.close(t)
    return out


def test_raftis_client_roundtrip(sims):
    (_, jport), (_, tport) = sims
    got = raftis_taxonomy(raftis, Op, tport)
    assert got == raftis_taxonomy(jraftis, JOp, jport)
    assert got[0] == ("ok", None, None) and got[2] == ("ok", 3, None)


def test_raftis_dead_node_taxonomy():
    t = {"raftis": {"addr_fn": lambda n: "127.0.0.1",
                    "ports": {"n1": free_port()}}}
    for mod in (raftis, jraftis):
        with pytest.raises(Exception):
            mod.RaftisClient(timeout=0.3).open(t, "n1")


def test_raftis_suite_surface_matches():
    assert raftis.initial_cluster({"nodes": NODES, "raftis": {
        "addr_fn": lambda n: f"h-{n}"}}) == jraftis.initial_cluster(
        {"nodes": NODES, "raftis": {"addr_fn": lambda n: f"h-{n}"}})
    for opts in ({"nodes": NODES}, {"nodes": NODES, "nemesis": "start-kill"},
                 {"nodes": NODES, "nemesis": "none"}):
        t, j = raftis.raftis_test(dict(opts)), jraftis.raftis_test(dict(opts))
        assert sorted(t) == sorted(j) and t["name"] == j["name"] == "raftis"
        assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
        assert sorted(t["checker"].checker_map) == ["linear", "perf",
                                                    "timeline"]
    db = raftis.RaftisDB()
    test = {"nodes": NODES, "raftis": {"addr_fn": lambda n: "h",
                                       "ports": {"n1": 7}}}
    assert db.daemon_args(test, "n1") == jraftis.RaftisDB().daemon_args(
        test, "n1")


def test_raftis_full_run_matches_the_jax_checker(tmp_path):
    c = redis_sim.local_cluster(str(tmp_path), NODES)
    t = raftis.raftis_test({"nodes": NODES, "remote": c["remote"],
                            "archive_url": c["archive_url"],
                            "raftis": c["raftis"], "concurrency": 4,
                            "time_limit": 4, "device": "cpu"})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    t["generator"] = gen.time_limit(3, gen.clients(gen.stagger(
        0.01, gen.mix([raftis.r, raftis.w]))))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert sum(o.type == "ok" for o in hist) > 10
    want = jchecker.linearizable().check(
        {"model": jmodels.Register()}, to_jax(hist), {})
    assert normalise(res["linear"]) == normalise(want)


# ---------------------------------------------------------------------------
# logcabin (TestLogCabin)

@pytest.fixture
def cabins(tmp_path):
    """Two logcabin nodes set up through each package's LogCabinDB on
    its own simulator archive; torn down after."""
    out = []
    for name, mod, sim in (("jax", jlogcabin, jlsim),
                           ("port", logcabin, logcabin_sim)):
        if sim is logcabin_sim:
            c = logcabin_sim.local_cluster(str(tmp_path / name), NODES)
            remote, archive, cfg = c["remote"], c["archive_url"], \
                c["logcabin"]
        else:
            from jepsen_tpu.control import LocalRemote

            remote = LocalRemote(root=str(tmp_path / name / "nodes"))
            path = str(tmp_path / name / "lc.tar.gz")
            jlsim.build_archive(path, str(tmp_path / name / "s" / "lc.json"))
            archive = f"file://{path}"
            cfg = {"addr_fn": lambda n: "127.0.0.1",
                   "ports": {n: free_port() for n in NODES},
                   "dir": lambda n, r=remote: os.path.join(r.node_dir(n),
                                                           "opt"),
                   "sudo": None}
        database = mod.LogCabinDB(archive_url=archive)
        test = {"remote": remote, "nodes": NODES, "logcabin": cfg}
        for n in NODES:
            database.setup(test, n)
        out.append((mod, database, test))
    yield out
    for _, database, test in out:
        for n in NODES:
            database.teardown(test, n)


def treeops_contract(mod, test) -> list:
    remote, d = test["remote"], test["logcabin"]["dir"]("n1")
    mod.treeops(test, "n1", "write", "/k", stdin="5")
    out = [mod.treeops(test, "n2", "read", "/k").out]
    for v in ("6", "7"):
        r = remote.exec("n1", [f"{d}/treeops", "-c", "x", "-q", "-t", "5",
                               "-p", "/k:5", "write", "/k"],
                        stdin=v, check=False)
        out.append([r.ok, r.err.strip()])
    out.append(mod.treeops(test, "n1", "read", "/k").out)
    r = remote.exec("n2", [f"{d}/treeops", "-c", "x", "read", "/missing"],
                    check=False)
    out.append([r.ok, r.err.strip()])
    r = remote.exec("n2", [f"{d}/treeops", "-c", "x", "-p", "/j:1", "write",
                           "/k"], stdin="8", check=False)
    out.append([r.ok, r.err.strip()])
    mod.treeops(test, "n1", "remove", "/k")
    r = remote.exec("n1", [f"{d}/treeops", "-c", "x", "read", "/k"],
                    check=False)
    out.append(r.ok)
    return out


def test_treeops_cli_contract(cabins):
    (jmod, _, jtest), (tmod, _, ttest) = cabins
    got = treeops_contract(tmod, ttest)
    assert got == treeops_contract(jmod, jtest)
    assert got[0] == "5" and got[1] == [True, ""]
    assert not got[2][0] and "CAS failed" in got[2][1]
    assert got[3] == "6" and got[4] == [False, "Error: /missing does not "
                                               "exist"]
    assert got[5] == [False, "Error: predicate path mismatch"]
    assert got[6] is False


def cas_client(mod, test, op_cls) -> list:
    c = mod.CASClient().open(test, "n1")
    return [(r.type, r.value) for r in (
        c.invoke(test, op_cls(0, "invoke", f, v)) for f, v in (
            ("read", None), ("write", 3), ("cas", (3, 4)), ("cas", (3, 9)),
            ("read", None)))]


def test_cas_client(cabins):
    (jmod, _, jtest), (tmod, _, ttest) = cabins
    got = cas_client(tmod, ttest, Op)
    assert got == cas_client(jmod, jtest, JOp)
    assert got == [("ok", None), ("ok", 3), ("ok", (3, 4)), ("fail", (3, 9)),
                   ("ok", 4)]


def test_logcabin_suite_surface_matches():
    test = {"nodes": NODES, "logcabin": {"addr_fn": lambda n: f"h-{n}",
                                         "ports": {"n1": 1, "n2": 2}}}
    assert logcabin.server_addrs(test) == jlogcabin.server_addrs(test)
    for n in NODES:
        assert logcabin.LogCabinDB().daemon_args(test, n) == \
            jlogcabin.LogCabinDB().daemon_args(test, n)
    for opts in ({"nodes": NODES}, {"nodes": NODES, "nemesis": "start-kill"}):
        t, j = logcabin.logcabin_test(dict(opts)), jlogcabin.logcabin_test(
            dict(opts))
        assert sorted(t) == sorted(j) and t["name"] == j["name"]
        assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
        assert type(t["model"]).__name__ == "CASRegister"


def test_logcabin_full_run_matches_the_jax_checker(tmp_path):
    c = logcabin_sim.local_cluster(str(tmp_path), NODES)
    t = logcabin.logcabin_test({"nodes": NODES, "remote": c["remote"],
                                "archive_url": c["archive_url"],
                                "logcabin": c["logcabin"], "concurrency": 2,
                                "time_limit": 4, "stagger": 0.05,
                                "device": "cpu"})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert sum(o.type == "ok" for o in hist) > 5
    want = jchecker.linearizable().check(
        {"model": jmodels.CASRegister()}, to_jax(hist), {})
    assert normalise(res["linear"]) == normalise(want)


# ---------------------------------------------------------------------------
# the recipes through the CLI

def import_profile(text: str) -> set:
    return {ln.rsplit("|", 1)[1].strip() for ln in text.splitlines()
            if ln.startswith("import time:") and "|" in ln}


def no_heavy(mods: set) -> set:
    return {m for m in mods
            if m.split(".")[0] in ("jax", "jepsen_tpu", "torch")}


@pytest.mark.parametrize("suite", ["raftis", "logcabin"])
def test_recipe_cli_run_and_members_load_no_jax(tmp_path, monkeypatch,
                                                suite):
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    sim, mod = ((redis_sim, raftis) if suite == "raftis"
                else (logcabin_sim, logcabin))
    c = sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(sim.local_test_fn(c), opt_spec=mod._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "2",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu"])
    assert rc == 0
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, suite, "latest"))]
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    assert res["linear"]["valid"] is True, res["linear"]
    logs = glob.glob(os.path.join(run_dir, "n*", f"*{suite}.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_treeops_process_loads_no_jax(cabins, monkeypatch):
    (_, _, _), (tmod, _, ttest) = cabins
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    r = tmod.treeops(ttest, "n1", "write", "/p", stdin="1")
    mods = import_profile(r.err)
    assert "jepsen_tpu_torch.dbs.logcabin_sim" in mods
    assert not no_heavy(mods), sorted(no_heavy(mods))


@pytest.mark.parametrize("suite", ["raftis", "logcabin"])
def test_recipe_refuses_fs_break(tmp_path, suite):
    sim, mod = ((redis_sim, raftis) if suite == "raftis"
                else (logcabin_sim, logcabin))
    c = sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(sim.local_test_fn(c), opt_spec=mod._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
