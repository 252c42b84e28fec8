"""The port's hazelcast suite (dbs/hz_sim.py, hazelcast.py) against the
JAX package's, on the cases of tests/test_hazelcast.py: the same HTTP
calls against both packages' simulators give the same statuses and JSON
replies (queue, lock with sessions and reentrancy, atomic long and
reference, the id generator's blocks, maps); the clients' determinacy
taxonomy (a non-owner's release and a lost quorum definite `fail`s, a
refused connection `fail` client-down, a timeout `info`), the workload
registry, the generators and the test maps are the same; the DB's life
cycle on simulated nodes. Then the recipe (`hz_sim.local_test_fn`)
through the CLI with device="cpu": the lock workload's stored history
gives the JAX package's linearizable dict under Mutex(), no JDK is
installed and no apt command reaches a node, fs-break is refused; and
the queue and id workloads' dicts the JAX package's."""

from __future__ import annotations

import glob
import itertools
import json
import os
import socket
import threading
import urllib.request

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import cli as jcli
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import hazelcast as jhz
from jepsen_tpu.dbs import hz_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, models, nemesis
from jepsen_tpu_torch import osdist, store
from jepsen_tpu_torch.control import LocalRemote
from jepsen_tpu_torch.dbs import hazelcast as hz
from jepsen_tpu_torch.dbs import hz_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve_hz(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0
        _id_lock = threading.Lock()
        _id_next = 0
        _id_limit = 0

    httpd = sim.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture
def sims(tmp_path):
    """(suite module, port) of the JAX package's Hazelcast simulator and
    the port's, each on a fresh store."""
    srvs = [serve_hz(jsim, str(tmp_path / "jax.json")),
            serve_hz(hz_sim, str(tmp_path / "port.json"))]
    yield [(jhz, srvs[0].server_address[1]),
           (hz, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# the simulators reply alike

CALLS = [
    ("POST", "/queue/put", {"name": "q", "value": 1}),
    ("POST", "/queue/put", {"name": "q", "value": [2, "x"]}),
    ("POST", "/queue/poll", {"name": "q", "timeout_ms": 1}),
    ("POST", "/queue/poll", {"name": "q", "timeout_ms": 1}),
    ("POST", "/queue/poll", {"name": "q", "timeout_ms": 1}),
    ("POST", "/lock/acquire", {"name": "l", "session": "s1",
                               "timeout_ms": 10}),
    ("POST", "/lock/acquire", {"name": "l", "session": "s2",
                               "timeout_ms": 10}),
    ("POST", "/lock/acquire", {"name": "l", "session": "s1",
                               "timeout_ms": 10}),
    ("POST", "/lock/release", {"name": "l", "session": "s1"}),
    ("POST", "/lock/release", {"name": "l", "session": "s2"}),
    ("POST", "/lock/acquire", {"name": "l", "session": "s2",
                               "timeout_ms": 10}),
    ("POST", "/lock/release", {"name": "l", "session": "s1"}),
    ("POST", "/lock/acquire", {"name": "l", "session": "s2",
                               "timeout_ms": 100}),
    ("POST", "/atomic-long/inc", {"name": "a"}),
    ("POST", "/atomic-long/inc", {"name": "a"}),
    ("POST", "/atomic-ref/get", {"name": "r"}),
    ("POST", "/atomic-ref/cas", {"name": "r", "old": None, "new": 1}),
    ("POST", "/atomic-ref/cas", {"name": "r", "old": 5, "new": 9}),
    ("POST", "/atomic-ref/get", {"name": "r"}),
    ("POST", "/id-gen/new", {}),
    ("POST", "/id-gen/new", {}),
    ("POST", "/map/put-if-absent", {"name": "m", "key": "hi",
                                    "value": [1]}),
    ("POST", "/map/put-if-absent", {"name": "m", "key": "hi",
                                    "value": [9]}),
    ("POST", "/map/replace", {"name": "m", "key": "hi", "old": [1],
                              "new": [1, 2]}),
    ("POST", "/map/replace", {"name": "m", "key": "hi", "old": [1],
                              "new": [1, 3]}),
    ("POST", "/map/get", {"name": "m", "key": "hi"}),
    ("POST", "/nope/verb", {}),
    ("POST", "/too/many/parts", {}),
    ("GET", "/health", None),
    ("GET", "/other", None),
]


def replies(port) -> list:
    out = []
    for method, path, body in CALLS:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                out.append((resp.status, json.load(resp)))
        except urllib.error.HTTPError as e:
            out.append((e.code, json.load(e)))
    return out


def test_simulators_reply_alike(sims):
    (_, jport), (_, tport) = sims
    got = replies(tport)
    assert got == replies(jport)
    bodies = [b for _, b in got]
    assert bodies[2:5] == [{"value": 1}, {"value": [2, "x"]},
                           {"value": None}]
    assert [b.get("acquired") for b in bodies[5:8]] == [True, False, True]
    assert got[9] == (409, {"error": "not-lock-owner", "message":
                            "Current thread is not owner of the lock!"})
    assert bodies[12] == {"acquired": True}
    assert bodies[19]["value"] + 1 == bodies[20]["value"]
    assert bodies[25] == {"value": [1, 2]}
    assert [s for s, _ in got[-4:]] == [404, 404, 200, 404]


def test_raw_bad_json_refused_alike(sims):
    import http.client

    out = []
    for _, port in sims:
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        c.request("POST", "/queue/put", body=b"{{{")
        r = c.getresponse()
        out.append((r.status, r.reason, json.loads(r.read())))
        c.close()
    assert out[0] == out[1] == (400, "Bad Request",
                                {"error": "bad-json", "message": ""})


# ---------------------------------------------------------------------------
# the clients' taxonomy

def cfg(port, node="n1") -> dict:
    return {"hazelcast": {"addr_fn": lambda n: "127.0.0.1",
                          "ports": {node: port}}}


def client_session(mod, op_cls, port, monkeypatch) -> list:
    t = cfg(port)
    out = []

    def run(c, f, v=None):
        r = c.invoke(t, op_cls(0, "invoke", f, v))
        out.append((type(c).__name__, r.type, r.value, r.error))

    q = mod.QueueClient().open(t, "n1")
    run(q, "enqueue", 7)
    run(q, "dequeue")
    run(q, "dequeue")
    for v in (1, 2, 3):
        run(q, "enqueue", v)
    run(q, "drain")
    c1, c2 = mod.LockClient().open(t, "n1"), mod.LockClient().open(t, "n1")
    run(c1, "acquire")
    monkeypatch.setattr(mod, "LOCK_WAIT_MS", 50)
    run(c2, "acquire")
    run(c2, "release")
    run(c1, "release")
    run(c2, "acquire")
    run(c2, "release")
    for cls in (mod.AtomicLongIdClient, mod.AtomicRefIdClient,
                mod.IdGenIdClient):
        c = cls().open(t, "n1")
        run(c, "generate")
        run(c, "generate")
    for crdt in (False, True):
        m = mod.MapClient(crdt=crdt).open(t, "n1")
        run(m, "add", 3)
        run(m, "add", 1)
        run(m, "read")
    return out


def test_clients(sims, monkeypatch):
    (jmod, jport), (tmod, tport) = sims
    got = client_session(tmod, Op, tport, monkeypatch)
    assert got == client_session(jmod, JOp, jport, monkeypatch)
    assert got[:3] == [("QueueClient", "ok", 7, None),
                       ("QueueClient", "ok", 7, None),
                       ("QueueClient", "fail", None, "empty")]
    assert got[6] == ("QueueClient", "ok", [1, 2, 3], None)
    assert [g[1:] for g in got[7:13]] == [
        ("ok", None, None), ("fail", None, None),
        ("fail", None, "not-lock-owner"), ("ok", None, None),
        ("ok", None, None), ("ok", None, None)]
    assert got[-1] == ("MapClient", "ok", [1, 3], None)


class Raising:
    """A connection (or reconnect wrapper) whose every call raises
    `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def call(self, path, body):
        raise self.exc

    def with_conn(self):
        outer = self

        class Ctx:
            def __enter__(self):
                return outer

            def __exit__(self, *a):
                return False

        return Ctx()

    def close(self):
        pass


@pytest.mark.parametrize("kind", ["not-lock-owner", "quorum", "http",
                                  "timeout", "refused", "refused-url",
                                  "reset"])
def test_error_taxonomy(kind, monkeypatch):
    """The lock client's reference taxonomy (hazelcast.clj:260-301):
    not-lock-owner and quorum definite `fail`s, a refused connection
    `fail` client-down, anything else `info`; the other clients `info`
    on every error (a read of the map `fail`)."""
    import time as _time

    monkeypatch.setattr(_time, "sleep", lambda s: None)
    out = []
    for mod, op_cls in ((hz, Op), (jhz, JOp)):
        exc = {"not-lock-owner": mod.HzError("not-lock-owner"),
               "quorum": mod.HzError("quorum"), "http": mod.HzError("http"),
               "timeout": socket.timeout("timed out"),
               "refused": ConnectionRefusedError(111, "refused"),
               "refused-url": urllib.error.URLError(
                   ConnectionRefusedError(111, "refused")),
               "reset": ConnectionResetError(104, "reset")}[kind]
        got = []
        for cls, f, v in (("LockClient", "acquire", None),
                          ("LockClient", "release", None),
                          ("QueueClient", "enqueue", 1),
                          ("AtomicLongIdClient", "generate", None),
                          ("AtomicRefIdClient", "generate", None),
                          ("IdGenIdClient", "generate", None),
                          ("MapClient", "add", 1),
                          ("MapClient", "read", None)):
            c = getattr(mod, cls)(Raising(exc))
            r = c.invoke({}, op_cls(0, "invoke", f, v))
            got.append((cls, f, r.type, r.error))
        out.append(got)
    assert out[0] == out[1]
    lock = {f: (ty, err) for cls, f, ty, err in out[0] if cls == "LockClient"}
    want = {"not-lock-owner": ("fail", "not-lock-owner"),
            "quorum": ("fail", "quorum"),
            "refused": ("fail", "client-down"),
            "refused-url": ("fail", "client-down")}.get(kind)
    if want:
        assert lock["acquire"] == lock["release"] == want
    else:
        assert lock["acquire"][0] == lock["release"][0] == "info"


def test_dead_node_taxonomy():
    t = cfg(free_port())
    for mod, op_cls in ((hz, Op), (jhz, JOp)):
        c = mod.QueueClient().open(t, "n1")
        c.conn.timeout = 0.5
        assert c.invoke(t, op_cls(0, "invoke", "enqueue", 1)).type == "info"
        lc = mod.LockClient().open(t, "n1")
        r = lc.invoke(t, op_cls(0, "invoke", "acquire", None))
        assert (r.type, r.error) == ("fail", "client-down")


# ---------------------------------------------------------------------------
# workloads, generators and test maps

def test_workload_registry_and_generators():
    """The seven workloads (hazelcast.clj:377-399); each process's lock
    ops alternate acquire and release; the queue's enqueues count up."""
    assert sorted(hz.workloads()) == sorted(jhz.workloads()) == sorted([
        "crdt-map", "map", "lock", "queue", "atomic-ref-ids",
        "atomic-long-ids", "id-gen-ids"])
    wl = hz.workloads(device="cpu")["lock"]
    assert wl["checker"].device == "cpu"
    assert isinstance(wl["model"], models.Mutex)
    t = {"nodes": NODES, "concurrency": 2}
    for mod in (hz, jhz):
        g = mod.workloads()["lock"]["generator"]
        assert [g.op(t, p)["f"] for p in (0, 1, 0, 1, 0)] == [
            "acquire", "acquire", "release", "release", "acquire"]
        q = mod.queue_gen().gen
        vals = []
        while len(vals) < 3:
            o = q.op(t, 0)
            if isinstance(o, dict) and o["f"] == "enqueue":
                vals.append(o["value"])
        assert vals == [0, 1, 2]


@pytest.mark.parametrize("workload", sorted(jhz.workloads()))
def test_hazelcast_test_maps_match(workload):
    base = {"nodes": NODES, "time_limit": 5, "workload": workload}
    t = hz.hazelcast_test(dict(base))
    j = jhz.hazelcast_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    assert type(t["client"]).__name__ == type(j["client"]).__name__
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert type(t["model"]).__name__ == type(j["model"]).__name__
    assert sorted(t["checker"].checker_map) == ["perf", "timeline",
                                                "workload"]
    assert type(t["checker"].checker_map["workload"]).__name__ == type(
        j["checker"].checker_map["workload"]).__name__
    assert t["db"].jdk is j["db"].jdk is True
    if workload == "lock":
        assert isinstance(t["model"], models.Mutex)


def test_cli_requires_workload():
    for mod, c in ((hz, cli), (jhz, jcli)):
        rc = c.run_cli(c.single_test_cmd(mod.hazelcast_test,
                                         opt_spec=mod._opt_spec),
                       ["test", "--time-limit", "1"])
        assert rc == 254


# ---------------------------------------------------------------------------
# the DB and the recipe

def test_setup_teardown_cycle(tmp_path):
    """TestDBLifecycle: members of one cluster share state; each writes
    its log."""
    c = hz_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    db = hz.HazelcastDB(archive_url=c["archive_url"], jdk=False)
    test = {"remote": c["remote"], "nodes": NODES,
            "hazelcast": c["hazelcast"]}
    try:
        for n in NODES:
            db.setup(test, n)
        c1 = hz.HzConn("127.0.0.1", c["ports"]["n1"])
        c2 = hz.HzConn("127.0.0.1", c["ports"]["n2"])
        c1.call("/queue/put", {"name": "q", "value": 9})
        assert c2.call("/queue/poll", {"name": "q",
                                       "timeout_ms": 1})["value"] == 9
        for n in NODES:
            (path,) = db.log_files(test, n)
            assert os.path.exists(path)
    finally:
        for n in NODES:
            db.teardown(test, n)


def recording(monkeypatch) -> list:
    ran = []
    real = LocalRemote.exec

    def rec(self, node, argv, *a, **kw):
        ran.append(" ".join(map(str, argv)))
        return real(self, node, argv, *a, **kw)

    monkeypatch.setattr(LocalRemote, "exec", rec)
    return ran


def test_recipe_lock_matches_the_jax_checker(tmp_path, monkeypatch):
    """The lock workload through the recipe (its majority-ring nemesis on
    the no-op network; the workers last the nemesis's first 30-s sleep):
    exit 0, valid, the stored history's linearizable dict under Mutex()
    the JAX package's; no JDK install and no apt command reaches a
    node; members load neither torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    monkeypatch.setattr(osdist, "install_jdk", lambda *a: pytest.fail(
        "the recipe installed a JDK"))
    ran = recording(monkeypatch)
    c = hz_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(hz_sim.local_test_fn(c), opt_spec=hz._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "2",
         "--time-limit", "3", "--workload", "lock", "--store-dir", sd,
         "--device", "cpu"])
    assert rc == 0
    (run_dir,) = [os.path.realpath(d)
                  for d in glob.glob(os.path.join(sd, "*", "latest"))]
    assert os.path.basename(os.path.dirname(run_dir)) == "hazelcast lock"
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    hist = store.load_history({
        "name": "hazelcast lock", "start_time": os.path.basename(run_dir),
        "store_dir": sd})
    assert res["workload"]["valid"] is True, res["workload"]
    assert [o for o in hist if o.f == "acquire" and o.type == "ok"]
    want = jchecker.linearizable().check(
        {"model": jmodels.Mutex()}, to_jax(hist), {})
    assert res["workload"] == normalise(want)
    assert ran and not any("apt" in c or "java" in c for c in ran)
    logs = glob.glob(os.path.join(run_dir, "n*", "*server.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_refuses_fs_break(tmp_path, monkeypatch):
    ran = recording(monkeypatch)
    c = hz_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(hz_sim.local_test_fn(c), opt_spec=hz._opt_spec),
        ["test", "--node", "n1", "--workload", "lock", "--nemesis",
         "fs-break", "--time-limit", "3", "--store-dir",
         str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254 and ran == []
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))


def engine_test(tmp_path, workload, generator):
    c = hz_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    t = hz_sim.local_test_fn(c)({
        "workload": workload, "nodes": NODES, "concurrency": 4,
        "time_limit": 5, "quiesce": 0.2, "device": "cpu"})
    t["nemesis"] = nemesis.noop
    t["generator"] = generator
    return core.run(t)


def test_queue_workload_matches_the_jax_checker(tmp_path):
    """TestFullRuns.test_queue_workload on the recipe's cluster: the
    total-queue dict the JAX package's."""
    result = engine_test(tmp_path, "queue", gen.phases(
        gen.time_limit(3, gen.clients(gen.limit(
            120, gen.stagger(0.01, hz.queue_gen())))),
        gen.clients(gen.each(
            lambda: gen.once({"type": "invoke", "f": "drain"})))))
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert any(o.f == "drain" and o.type == "ok" for o in hist)
    want = jchecker.total_queue().check({}, to_jax(hist), {})
    assert normalise(res["workload"]) == normalise(want)


@pytest.mark.parametrize("workload", ["id-gen-ids", "atomic-long-ids",
                                      "atomic-ref-ids"])
def test_id_workloads_match_the_jax_checker(tmp_path, workload):
    result = engine_test(tmp_path, workload, gen.time_limit(
        2, gen.clients(gen.limit(60, gen.stagger(
            0.01, {"type": "invoke", "f": "generate"})))))
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert len([o for o in hist if o.type == "ok"]) > 10
    want = jchecker.unique_ids().check({}, to_jax(hist), {})
    assert normalise(res["workload"]) == normalise(want)


def test_map_workload_matches_the_jax_checker(tmp_path):
    wl = hz.workloads()["map"]
    counter = itertools.count()
    result = engine_test(tmp_path, "map", gen.phases(
        gen.time_limit(2, gen.clients(gen.limit(40, gen.stagger(
            0.01, lambda test, p: {"type": "invoke", "f": "add",
                                   "value": next(counter)})))),
        gen.clients(wl["final_generator"])))
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    want = jchecker.set_checker().check({}, to_jax(hist), {})
    assert normalise(res["workload"]) == normalise(want)
