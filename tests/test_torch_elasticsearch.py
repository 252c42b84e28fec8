"""The port's elasticsearch suite (dbs/es_sim.py, elasticsearch.py)
against the JAX package's, on the cases of
tests/test_rds_elasticsearch.py::TestEsSim, ::TestEsClients,
::TestEsFullRuns, ::TestEsDirtyRead and ::TestSearchPagination: the same
HTTP requests against both packages' simulators give the same statuses
and bodies (version CAS, op_type=create, near-real-time search, search
pagination); the clients' taxonomies, the dirty-read checker and the test
maps are the same; full runs on simulated nodes with device="cpu" are
valid, and each workload (register, set, dirty-read) runs end to end on
the port's recipe, its stored history, given to the JAX package's
composed checker, giving the port's results. Also fs-break refused and
member processes that load neither torch nor jax."""

from __future__ import annotations

import glob
import http.client
import json
import os
import threading
import urllib.error
from http.server import ThreadingHTTPServer

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import elasticsearch as jes
from jepsen_tpu.dbs import es_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, nemesis, store
from jepsen_tpu_torch.dbs import elasticsearch as es
from jepsen_tpu_torch.dbs import es_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0
        refresh_lag = True

        def log_message(self, fmt, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sims(tmp_path):
    """(suite module, port) of the JAX package's REST simulator and the
    port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(es_sim, str(tmp_path / "port.json"))]
    yield [(jes, srvs[0].server_address[1]),
           (es, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# the simulators reply alike (TestEsSim)

REQUESTS = [
    ("GET", "/_cluster/health", None),
    ("GET", "/jepsen/register/0", None),
    ("PUT", "/jepsen/register/0", {"value": 1}),
    ("GET", "/jepsen/register/0", None),
    ("PUT", "/jepsen/register/0?version=1", {"value": 2}),
    ("PUT", "/jepsen/register/0?version=1", {"value": 9}),
    ("PUT", "/jepsen/register/9?version=3", {"value": 9}),
    ("GET", "/jepsen/register/0", None),
    ("PUT", "/jepsen/register/7?op_type=create", {"num": 7}),
    ("PUT", "/jepsen/register/7?op_type=create", {"num": 7}),
    ("POST", "/jepsen/register/8", {"num": 8}),
    ("POST", "/jepsen/_search", {"query": {"match_all": {}}}),
    ("POST", "/jepsen/_refresh", None),
    ("POST", "/jepsen/_search", {"query": {"match_all": {}}, "size": 10,
                                 "sort": [{"num": "asc"}]}),
    ("POST", "/jepsen/_search", {"size": 1, "sort": [{"num": "asc"}],
                                 "search_after": [7]}),
    ("POST", "/jepsen/_search", [1, 2]),
    ("GET", "/nowhere", None),
    ("PUT", "/jepsen/x", {"a": 1}),
]


def replies(port) -> list:
    out = []
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        for method, path, body in REQUESTS:
            data = None if body is None else json.dumps(body).encode()
            c.request(method, path, body=data,
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            out.append((r.status, r.read()))
    finally:
        c.close()
    return out


def test_simulators_reply_alike(sims):
    (_, jport), (_, tport) = sims
    got = replies(tport)
    assert got == replies(jport)
    assert [s for s, _ in got] == [200, 404, 201, 200, 200, 409, 409, 200,
                                   201, 409, 201, 200, 200, 200, 200, 200,
                                   404, 400]
    assert json.loads(got[7][1])["_source"] == {"value": 2}
    assert json.loads(got[11][1])["hits"]["hits"] == []  # before refresh
    hits = json.loads(got[13][1])["hits"]["hits"]
    assert [h["_source"] for h in hits] == [{"num": 7}, {"num": 8},
                                            {"value": 2}]
    after = json.loads(got[14][1])["hits"]["hits"]
    assert [h["_id"] for h in after] == ["8"]


def conn_calls(mod, port) -> list:
    """TestEsSim's and TestSearchPagination's calls through each package's
    EsConn."""
    conn = mod.EsConn("127.0.0.1", port)
    out = [conn.get_doc("0"), conn.index_doc("0", {"value": 1}),
           conn.get_doc("0"), conn.index_doc("0", {"value": 2}, version=1),
           conn.index_doc("0", {"value": 9}, version=1), conn.get_doc("0"),
           conn.index_doc("7", {"num": 7}, create=True),
           conn.index_doc("7", {"num": 7}, create=True),
           conn.search_all()]
    conn.refresh()
    out.append(conn.search_all())
    for i in range(25):
        conn.index_doc(f"{i:03d}", {"id": i}, create=True)
    conn.refresh()
    out.append(sorted(d["id"] for d in conn.search_all(page_size=10,
                                                        sort_field="id")))
    out.append(len(conn.search_all()))
    return out


def test_conn_calls_and_pagination_match(sims):
    (jmod, jport), (tmod, tport) = sims
    got = conn_calls(tmod, tport)
    assert got == conn_calls(jmod, jport)
    assert got[:8] == [(None, 0), True, ({"value": 1}, 1), True, False,
                       ({"value": 2}, 2), True, False]
    assert got[8] == [] and sorted(got[9], key=str) == [{"num": 7},
                                                       {"value": 2}]
    assert got[10] == list(range(25)) and got[11] == 27


# ---------------------------------------------------------------------------
# the clients (TestEsClients, TestEsDirtyRead)

def cfg(port) -> dict:
    return {"elasticsearch": {"addr_fn": lambda n: "127.0.0.1",
                              "ports": {"n1": port}}}


def client_run(mod, op_cls, port) -> list:
    t = cfg(port)
    reg = mod.RegisterClient().open(t, "n1")
    out = [(r.type, r.value) for r in (
        reg.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("read", None), ("write", 3), ("cas", (3, 4)), ("cas", (3, 9)),
            ("read", None)))]
    sets = mod.SetClient().open(t, "n1")
    out += [(r.type, r.value) for r in (
        sets.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("add", 1), ("add", 2), ("add", 2), ("add", 3),
            ("read", None)))]
    dirty = mod.DirtyReadClient().open(t, "n1")
    out += [(r.type, r.value) for r in (
        dirty.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("write", 7), ("read", 7), ("read", 99), ("refresh", None),
            ("strong-read", None)))]
    for c in (reg, sets, dirty):
        with pytest.raises(ValueError):
            c.invoke(t, op_cls(0, "invoke", "frob", None))
    return out


def test_clients_match(sims):
    (jmod, jport), (tmod, tport) = sims
    got = client_run(tmod, Op, tport)
    assert got == client_run(jmod, JOp, jport)
    assert got[:5] == [("ok", None), ("ok", 3), ("ok", (3, 4)),
                       ("fail", (3, 9)), ("ok", 4)]
    assert got[5:10] == [("ok", 1), ("ok", 2), ("fail", 2), ("ok", 3),
                         ("ok", [1, 2, 3])]
    assert got[10:14] == [("ok", 7), ("ok", 7), ("fail", 99),
                          ("ok", None)]
    assert got[14] == ("ok", [7])


def test_dead_node_taxonomy():
    t = cfg(free_port())
    got = []
    for mod, cls in ((es, Op), (jes, JOp)):
        row = []
        for client, fs in ((mod.RegisterClient, ("read", "write", "cas")),
                           (mod.SetClient, ("add", "read")),
                           (mod.DirtyReadClient, ("write", "read",
                                                  "refresh",
                                                  "strong-read"))):
            c = client(timeout=0.5).open(t, "n1")
            row += [c.invoke(t, cls(0, "invoke", f, (1, 2) if f == "cas"
                                    else 1)).type for f in fs]
        got.append(row)
    assert got[0] == got[1] == ["fail", "info", "info", "info", "fail",
                                "info", "fail", "fail", "fail"]


def sr(cls, ids, p, i):
    return [cls(p, "invoke", "strong-read", None, index=i, time=i),
            cls(p, "ok", "strong-read", ids, index=i + 1, time=i + 1)]


def dirty_histories(cls) -> dict:
    base = [cls(0, "invoke", "write", 1, index=0, time=0),
            cls(0, "ok", "write", 1, index=1, time=1),
            cls(1, "invoke", "read", 1, index=2, time=2),
            cls(1, "ok", "read", 1, index=3, time=3)]
    return {
        "ok": base + sr(cls, [1], 0, 10) + sr(cls, [1], 1, 20),
        "dirty": base + [cls(2, "invoke", "read", 2, index=4, time=4),
                         cls(2, "ok", "read", 2, index=5, time=5)]
        + sr(cls, [1], 0, 10) + sr(cls, [1], 1, 20),
        "lost": base + sr(cls, [], 0, 10) + sr(cls, [], 1, 20),
        "disagree": base + sr(cls, [1], 0, 10) + sr(cls, [], 1, 20),
        "partial": base + sr(cls, [1], 0, 10)
        + [cls(1, "invoke", "strong-read", None, index=30, time=30)],
        "none": base,
    }


@pytest.mark.parametrize("case", ["ok", "dirty", "lost", "disagree",
                                  "partial", "none"])
def test_dirty_read_checker_matches(case):
    got = es.DirtyReadChecker().check({}, dirty_histories(Op)[case], {})
    assert got == jes.DirtyReadChecker().check(
        {}, dirty_histories(JOp)[case], {})
    want = {"ok": True, "dirty": False, "lost": False, "disagree": False,
            "partial": "unknown", "none": "unknown"}[case]
    assert got["valid"] == want, got
    if case == "dirty":
        assert got["dirty"] == [2]
    if case == "lost":
        assert got["lost"] == [1]
    if case == "disagree":
        assert not got["nodes_agree"]


def test_dirty_rw_gen_shape():
    import random

    g, jg = es.dirty_rw_gen(), jes.dirty_rw_gen()
    random.seed(2)
    got = [g.op({}, 0) for _ in range(30)]
    random.seed(2)
    assert got == [jg.op({}, 0) for _ in range(30)]
    writes = [o["value"] for o in got if o["f"] == "write"]
    assert writes == list(range(len(writes)))
    assert {o["f"] for o in got} == {"write", "read"}


# ---------------------------------------------------------------------------
# the test maps

@pytest.mark.parametrize("opts", [{}, {"workload": "set"},
                                  {"workload": "dirty-read", "quiesce": 1},
                                  {"nemesis": "start-kill"}])
def test_es_test_maps_match(opts):
    base = {"nodes": NODES, "time_limit": 5, **opts}
    t, j = es.es_test(dict(base)), jes.es_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert type(t["client"]).__name__ == type(j["client"]).__name__
    assert sorted(t["checker"].checker_map) == sorted(
        j["checker"].checker_map)
    assert t["db"].daemon_args(t, "n1") == j["db"].daemon_args(j, "n1")
    assert sorted(es.workloads()) == sorted(jes.workloads())


# ---------------------------------------------------------------------------
# full runs (TestEsFullRuns, TestEsDirtyRead.test_full_run)

def cluster_test(tmp_path, workload, **extra) -> dict:
    c = es_sim.local_cluster(str(tmp_path), NODES)
    t = es.es_test({"workload": workload, "nodes": NODES,
                    "remote": c["remote"], "archive_url": c["archive_url"],
                    "elasticsearch": c["elasticsearch"], "concurrency": 4,
                    "time_limit": 4, "quiesce": 0.2, "device": "cpu",
                    **extra})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    return t


def test_full_run_register(tmp_path):
    t = cluster_test(tmp_path, "register")
    t["generator"] = gen.time_limit(3, gen.clients(
        gen.stagger(0.02, gen.mix([es.r, es.w, es.cas]))))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    want = jchecker.linearizable().check(
        {"model": jmodels.CASRegister()}, to_jax(hist), {})
    assert normalise(res["linear"]) == normalise(want)


@pytest.mark.parametrize("workload", ["set", "dirty-read"])
def test_full_run_with_final_reads(tmp_path, workload):
    t = cluster_test(tmp_path, workload, time_limit=8)
    wl = es.workloads()[workload]
    during = (gen.stagger(0.01, es.dirty_rw_gen()) if workload ==
              "dirty-read" else gen.stagger(0.01, wl["during"]))
    t["generator"] = gen.phases(gen.time_limit(3, gen.clients(during)),
                                gen.clients(wl["final"]))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    part, jc = (("set", jchecker.set_checker()) if workload == "set"
                else ("dirty-read", jes.DirtyReadChecker()))
    assert normalise(res[part]) == normalise(jc.check({}, to_jax(hist),
                                                      {}))


# ---------------------------------------------------------------------------
# each workload on the recipe

def jax_checker(workload):
    part = {"register": jchecker.linearizable(),
            "set": jchecker.set_checker(),
            "dirty-read": jes.DirtyReadChecker()}[workload]
    name = {"register": "linear"}.get(workload, workload)
    return jchecker.compose({"perf": jchecker.perf_checker(), name: part})


def stored(sd: str) -> tuple:
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, "*", "latest"))]
    name = os.path.basename(os.path.dirname(run_dir))
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    hist = store.load_history({"name": name,
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    return run_dir, name, res, hist


def held(tmp_path, workload, res, hist) -> None:
    want = jax_checker(workload).check(
        {"model": jmodels.CASRegister(), "store_dir": str(tmp_path / "j"),
         "name": "j", "start_time": "x"}, to_jax(hist), {})
    assert res == normalise(want)
    assert res["valid"] is True, res


def test_recipe_register_matches_the_jax_checker(tmp_path, monkeypatch):
    """The register at its defaults through the recipe's CLI (its
    nemesis on the no-op network holds the workers 10 s): exit 0, the
    stored history giving the JAX package's results; members load neither
    torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = es_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(es_sim.local_test_fn(c), opt_spec=es._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "4",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu"])
    assert rc == 0
    run_dir, name, res, hist = stored(sd)
    assert name == "elasticsearch register"
    held(tmp_path, "register", res, hist)
    assert sum(o.type == "ok" for o in hist) > 10
    logs = glob.glob(os.path.join(run_dir, "n*", "*es.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


@pytest.mark.parametrize("workload", ["set", "dirty-read"])
def test_recipe_final_read_workloads_match(tmp_path, workload):
    """set and dirty-read through the recipe's constructor at a 0.2-s
    quiesce (the CLI has no --quiesce; the suite's default is 10 s): the
    nemesis's stop, the quiesce, the readiness-gated final reads, the
    stored history giving the JAX package's results."""
    c = es_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    t = es_sim.local_test_fn(c)({
        "nodes": NODES, "concurrency": 4, "time_limit": 2, "quiesce": 0.2,
        "workload": workload, "store_dir": sd, "device": "cpu"})
    result = core.run(t)
    _, name, res, hist = stored(sd)
    assert name == f"elasticsearch {workload}"
    assert res == normalise(result["results"])
    held(tmp_path, workload, res, hist)
    finals = {"set": ["read"], "dirty-read": ["refresh", "strong-read"]}
    assert set(finals[workload]) <= {o.f for o in hist if o.type == "ok"}
    assert [o.f for o in hist if o.process == "nemesis"][-2:] == ["stop",
                                                                   "stop"]


def test_recipe_refuses_fs_break(tmp_path):
    c = es_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(es_sim.local_test_fn(c), opt_spec=es._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))


def test_http_error_other_than_a_conflict_raises(sims):
    (_, _), (_, port) = sims
    conn = es.EsConn("127.0.0.1", port)
    with pytest.raises(urllib.error.HTTPError):
        conn.index_doc("a/b", {"x": 1})
