"""The port's crate suite (dbs/crate_sim.py, crate.py) against the JAX
package's, on the cases of tests/test_crate.py and
tests/test_final_suites.py::TestCrateDirtyRead: the _sql endpoint and
its `_version` column, the version-register, lost-updates and dirty-read
clients, the multiversion checker, and full runs of the three workloads
on simulated nodes. Then parity: the same statements against both
packages' simulators give the same statuses and bodies; the clients give
the same ops for the same session and the same errors; the test maps are
the same; each full run's history gives the JAX package's checker dict;
and the recipe (`crate_sim.local_test_fn`) through the CLI, its members
loading neither torch nor jax, fs-break refused."""

from __future__ import annotations

import glob
import http.client
import json
import os
import socket
import threading
from http.server import ThreadingHTTPServer

import pytest

from jepsen_tpu import independent as jind
from jepsen_tpu.dbs import crate as jcrate
from jepsen_tpu.dbs import crate_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, independent, nemesis, store
from jepsen_tpu_torch.dbs import crate, crate_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0

        def log_message(self, fmt, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sim(tmp_path):
    srv = serve(crate_sim, str(tmp_path / "crate.json"))
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def sims(tmp_path):
    """(suite module, independent module, Op class, port) of the JAX
    package's _sql simulator and the port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(crate_sim, str(tmp_path / "port.json"))]
    yield [(jcrate, jind, JOp, srvs[0].server_address[1]),
           (crate, independent, Op, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# the _sql endpoint and _version (TestSqlEndpointAndVersions)

def test_select_rowcount(sim):
    c = crate.CrateConn("127.0.0.1", sim)
    c.sql("create table t (id int primary key, v int)")
    assert c.sql("insert into t values (1, 5)")["rowcount"] == 1
    assert c.sql("select v from t where id = 1")["rows"] == [["5"]]


def test_version_bumps_on_update(sim):
    c = crate.CrateConn("127.0.0.1", sim)
    c.sql("create table r (id int primary key, v int)")
    c.sql("alter table r add _version")
    c.sql("insert into r (id, v) values (1, 0)")
    assert c.sql("select _version from r where id = 1")["rows"] == [["1"]]
    c.sql("update r set v = 9 where id = 1")
    assert c.sql("select _version from r where id = 1")["rows"] == [["2"]]


def test_optimistic_version_check(sim):
    c = crate.CrateConn("127.0.0.1", sim)
    c.sql("create table s (id int primary key, v int)")
    c.sql("alter table s add _version")
    c.sql("insert into s (id, v) values (1, 0)")
    assert c.sql("update s set v = 5 where id = 1 and _version = 9"
                 )["rowcount"] == 0
    assert c.sql("update s set v = 5 where id = 1 and _version = 1"
                 )["rowcount"] == 1


def test_duplicate_key_is_409(sim):
    c = crate.CrateConn("127.0.0.1", sim)
    c.sql("create table d (id int primary key, v int)")
    c.sql("insert into d values (1, 1)")
    with pytest.raises(crate.CrateError) as ei:
        c.sql("insert into d values (1, 2)")
    assert "duplicate" in str(ei.value).lower() and ei.value.code == 4091


BODIES = [
    {"stmt": "create table t (id int primary key, v int)"},
    {"stmt": "alter table t add _version"},
    {"stmt": "insert into t (id, v) values (1, 0)"},
    {"stmt": "insert into t (id, v) values (1, 2)"},
    {"stmt": "select v, _version from t where id = 1"},
    {"stmt": "update t set v = 3 where id = 1 and _version = 1"},
    {"stmt": "update t set v = 4 where id = 1 and _version = 1"},
    {"stmt": "select v, _version from t"},
    {"stmt": "refresh table t"},
    {"stmt": "select * from nowhere"},
    {"nostmt": 1},
    "not json",
    {"stmt": "drop table if exists t"},
]


def replies(port) -> list:
    out = []
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        for body in BODIES:
            data = (body if isinstance(body, str) else json.dumps(body))
            c.request("POST", "/_sql", body=data.encode(),
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            out.append((r.status, json.loads(r.read())))
    finally:
        c.close()
    return out


def test_simulators_reply_alike(sims):
    (_, _, _, jport), (_, _, _, port) = sims
    got = replies(port)
    assert got == replies(jport)
    assert [s for s, _ in got] == [200, 200, 200, 409, 200, 200, 200, 200,
                                   400, 400, 400, 400, 200]
    assert got[4][1]["rows"] == [["0", "1"]]
    assert got[7][1]["rows"] == [["3", "2"]]


# ---------------------------------------------------------------------------
# the clients (TestClients, TestCrateDirtyRead's client)

def cfg(port) -> dict:
    return {"crate": {"addr_fn": lambda n: "127.0.0.1",
                      "ports": {"n1": port}}}


def test_version_register(sim):
    t = cfg(sim)
    c = crate.VersionRegisterClient().open(t, "n1")
    r0 = c.invoke(t, Op(0, "invoke", "read", independent.tuple_(1, None)))
    assert r0.type == "ok" and r0.value == (1, (None, None))
    assert c.invoke(t, Op(0, "invoke", "write",
                          independent.tuple_(1, 7))).type == "ok"
    r1 = c.invoke(t, Op(0, "invoke", "read", independent.tuple_(1, None)))
    k, (value, version) = r1.value
    assert value == 7 and version >= 1


def test_lost_updates_client(sim):
    t = cfg(sim)
    c = crate.LostUpdatesClient().open(t, "n1")
    for v in (1, 2, 3):
        assert c.invoke(t, Op(0, "invoke", "add",
                              independent.tuple_(0, v))).type == "ok"
    r = c.invoke(t, Op(0, "invoke", "read", independent.tuple_(0, None)))
    assert r.type == "ok" and r.value == (0, [1, 2, 3])


def test_multiversion_checker():
    chk = crate.MultiversionChecker()
    ok_hist = [
        Op(0, "invoke", "read", None, index=0),
        Op(0, "ok", "read", independent.tuple_(1, (5, 2)), index=1),
        Op(1, "invoke", "read", None, index=2),
        Op(1, "ok", "read", independent.tuple_(1, (5, 2)), index=3),
    ]
    assert chk.check({}, ok_hist, {})["valid"] is True
    bad_hist = ok_hist[:3] + [
        Op(1, "ok", "read", independent.tuple_(1, (9, 2)), index=3)]
    res = chk.check({}, bad_hist, {})
    assert res["valid"] is False and res["multis"]


def client_session(mod, ind, op_cls, port) -> list:
    t = cfg(port)
    out = []

    def run(client, calls):
        c = client().open(t, "n1")
        for f, v in calls:
            r = c.invoke(t, op_cls(0, "invoke", f, v))
            out.append((r.type, r.value, r.error))
        with pytest.raises(ValueError):
            c.invoke(t, op_cls(0, "invoke", "frob", ind.tuple_(0, 0)
                               if client is not mod.DirtyReadClient else 0))
        c.close(t)

    tup = ind.tuple_
    run(mod.VersionRegisterClient, [
        ("read", tup(1, None)), ("write", tup(1, 3)), ("read", tup(1, None)),
        ("write", tup(1, 4)), ("write", tup(2, 0)), ("read", tup(1, None)),
        ("read", tup(2, None))])
    run(mod.LostUpdatesClient, [
        ("read", tup(0, None)), ("add", tup(0, 5)), ("add", tup(0, 1)),
        ("add", tup(1, 2)), ("read", tup(0, None)), ("read", tup(1, None))])
    run(mod.DirtyReadClient, [
        ("write", 1), ("write", 2), ("write", 1), ("read", 2), ("read", 3),
        ("refresh", None), ("strong-read", None)])
    return out


def test_clients_match(sims):
    (jmod, jind_, jop, jport), (mod, ind, op, port) = sims
    got = client_session(mod, ind, op, port)
    assert normalise(got) == normalise(client_session(jmod, jind_, jop,
                                                      jport))
    assert got[0][:2] == ("ok", (1, (None, None)))
    assert got[2][:2] == ("ok", (1, (3, 1)))
    assert got[5][:2] == ("ok", (1, (4, 2)))
    assert got[11][:2] == ("ok", (0, [1, 5]))
    assert [t for t, _, _ in got[13:]] == ["ok", "ok", "info", "ok",
                                           "fail", "ok", "ok"]
    assert got[-1][1] == [1, 2]


def test_dead_node_taxonomy():
    """Every client against a port nothing listens on: reads (and the
    dirty-read workload's refresh and strong read) fail, writes and adds
    are info; the same in both packages."""
    t = cfg(free_port())
    got = []
    for mod, ind, cls in ((crate, independent, Op), (jcrate, jind, JOp)):
        row = []
        for client, calls in (
                (mod.VersionRegisterClient, (("read", ind.tuple_(1, None)),
                                             ("write", ind.tuple_(1, 2)))),
                (mod.LostUpdatesClient, (("add", ind.tuple_(1, 2)),
                                         ("read", ind.tuple_(1, None)))),
                (mod.DirtyReadClient, (("write", 1), ("read", 1),
                                       ("refresh", None),
                                       ("strong-read", None)))):
            c = client()
            c.conn = mod.CrateConn("127.0.0.1", t["crate"]["ports"]["n1"],
                                   timeout=0.5)
            row += [c.invoke(t, cls(0, "invoke", f, v)).type
                    for f, v in calls]
        got.append(row)
    assert got[0] == got[1] == ["fail", "info", "info", "fail", "info",
                                "fail", "fail", "fail"]


class Raising:
    def __init__(self, exc):
        self.exc = exc

    def sql(self, stmt):
        raise self.exc


@pytest.mark.parametrize("kind", ["no-master", "error", "timeout", "reset"])
def test_error_taxonomy_matches(kind):
    got = []
    for mod, ind, cls in ((crate, independent, Op), (jcrate, jind, JOp)):
        exc = {"no-master": mod.CrateError("no master node", 5000),
               "error": mod.CrateError("boom", 5000),
               "timeout": socket.timeout("timed out"),
               "reset": ConnectionResetError(104, "reset")}[kind]
        row = []
        for client, calls in ((mod.VersionRegisterClient,
                               (("read", ind.tuple_(1, None)),
                                ("write", ind.tuple_(1, 2)))),
                              (mod.LostUpdatesClient,
                               (("add", ind.tuple_(1, 2)),
                                ("read", ind.tuple_(1, None)))),
                              (mod.DirtyReadClient,
                               (("write", 1), ("read", 1),
                                ("strong-read", None)))):
            c = client(conn=Raising(exc))
            for f, v in calls:
                r = c.invoke({}, cls(0, "invoke", f, v))
                row.append((r.type, r.error))
        got.append(row)
    assert got[0] == got[1]
    if kind == "no-master":
        assert got[0][:2] == [("fail", "no-master")] * 2


# ---------------------------------------------------------------------------
# the test maps

@pytest.mark.parametrize("opts", [{}, {"workload": "lost-updates"},
                                  {"workload": "dirty-read"},
                                  {"nemesis": "start-kill"}])
def test_crate_test_maps_match(opts):
    base = {"nodes": NODES, "time_limit": 5, **opts}
    t, j = crate.crate_test(dict(base)), jcrate.crate_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    for k in ("nemesis", "client", "db"):
        assert type(t[k]).__name__ == type(j[k]).__name__, k
    assert sorted(t["checker"].checker_map) == sorted(
        j["checker"].checker_map)
    assert t["db"].daemon_args(t, "n1") == j["db"].daemon_args(j, "n1")
    assert sorted(crate.workloads()) == sorted(jcrate.workloads())


# ---------------------------------------------------------------------------
# full runs (TestFullRuns, TestCrateDirtyRead), each history also through
# the JAX package's checker

def run_crate(tmp_path, workload, **extra):
    c = crate_sim.local_cluster(str(tmp_path / "c"), NODES)
    opts = {"workload": workload, "nodes": NODES, "concurrency": 4,
            "time_limit": 5, "quiesce": 0.2, **extra}
    t = crate.crate_test({**opts, "remote": c["remote"],
                          "archive_url": c["archive_url"],
                          "crate": c["crate"]})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    result = core.run(t)
    part = {"version-divergence": "multiversion", "lost-updates": "sets",
            "dirty-read": "dirty-read"}[workload]
    want = jcrate.crate_test(opts)["checker"].checker_map[part].check(
        {}, to_jax(result["history"]), {})
    assert normalise(result["results"][part]) == normalise(want)
    return result


def test_version_divergence(tmp_path):
    result = run_crate(tmp_path, "version-divergence")
    assert result["results"]["valid"] is True, result["results"]


def test_lost_updates(tmp_path):
    result = run_crate(tmp_path, "lost-updates", keys=2, ops_per_key=15)
    res = result["results"]
    assert res["valid"] is True, res
    assert [o for o in result["history"] if o.type == "ok"
            and o.f == "read"]


def test_dirty_read_client_and_full_run(tmp_path):
    result = run_crate(tmp_path, "dirty-read", time_limit=4)
    res = result["results"]
    assert res["valid"] is True, res
    strong = [o for o in result["history"]
              if o.type == "ok" and o.f == "strong-read"]
    assert strong and strong[-1].value


# ---------------------------------------------------------------------------
# the recipe through the CLI

def test_recipe_cli_run_and_members_load_no_jax(tmp_path, monkeypatch):
    """version-divergence at its defaults through the recipe's CLI (its
    nemesis on the no-op network holds the workers 10 s): exit 0, the
    stored history giving the JAX package's multiversion dict; members
    load neither torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = crate_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(crate_sim.local_test_fn(c),
                            opt_spec=crate._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "4",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu"])
    assert rc == 0
    (run_dir,) = [os.path.realpath(d)
                  for d in glob.glob(os.path.join(sd, "*", "latest"))]
    assert os.path.basename(os.path.dirname(run_dir)) == \
        "crate version-divergence"
    res = json.load(open(os.path.join(run_dir, "results.json")))
    hist = store.load_history({"name": "crate version-divergence",
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    want = jcrate.MultiversionChecker().check({}, to_jax(hist), {})
    assert res["multiversion"] == normalise(want)
    assert res["multiversion"]["valid"] is True
    assert sum(o.type == "ok" and o.f == "read" for o in hist) > 5
    logs = glob.glob(os.path.join(run_dir, "n*", "*crate.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_refuses_fs_break(tmp_path):
    c = crate_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(crate_sim.local_test_fn(c),
                            opt_spec=crate._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
