"""The port's consul suite (dbs/consul.py, consul_sim.py) and the
archive-DB layer of dbs/common.py against the JAX package's, on the
cases of tests/test_consul_disque_raftis.py's consul tests: the same KV
sequence against both packages' simulators gives the same replies; the
client's taxonomy is the same; a full run on simulated agents with
device="cpu" is valid and its recorded history gives the JAX package's
linearizable dict. Also `ArchiveDB`'s lifecycle (install, start, ready,
kill, restart, pause, resume, teardown), the kill nemeses and the
standard nemesis registry on consul's simulated agents, the recipe
(`consul_sim.local_test_fn`) through the CLI, and agent processes that
load neither torch nor jax."""

from __future__ import annotations

import glob
import json
import os
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import common as jcommon
from jepsen_tpu.dbs import consul as jconsul
from jepsen_tpu.dbs import consul_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, nemesis
from jepsen_tpu_torch.dbs import common, consul, consul_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2", "n3"]


def serve(mod, path):
    class H(mod.Handler):
        store = mod.Store(path)
        mean_latency = 0.0

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sims(tmp_path):
    """(suite module, port) of the JAX package's simulator and the
    port's."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(consul_sim, str(tmp_path / "port.json"))]
    yield [(jconsul, srvs[0].server_address[1]),
           (consul, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def kv_replies(mod, port) -> list:
    """consul.ConsulKV's get/put/cas in a fixed sequence, a stale-index
    CAS and the leader endpoint: every reply."""
    kv = mod.ConsulKV("127.0.0.1", port)
    out = [kv.get(), kv.put(b"1"), kv.get(), kv.cas(b"1", b"2"), kv.get(),
           kv.cas(b"1", b"3"), kv.get()]
    _, index = kv.get()
    out.append(kv.put(b"2"))
    req = urllib.request.Request(f"{kv.base}?cas={index}", data=b"9",
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=2) as resp:
        out.append(resp.read().strip())
    out.append(kv.get())
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/status/leader", timeout=2) as resp:
        out.append((resp.status, resp.read().strip() != b'""'))
    return out


def test_simulators_reply_alike(sims):
    (jmod, jport), (tmod, tport) = sims
    want = kv_replies(jmod, jport)
    assert kv_replies(tmod, tport) == want
    assert want[0] == (None, 0) and want[3] is True and want[5] is False
    assert want[8] == b"false"


def taxonomy(mod, op_cls, port, dead) -> list:
    t = {"consul": {"addr_fn": lambda n: "127.0.0.1",
                    "ports": {"n1": port, "dead": dead}}}
    c = mod.CASClient().open(t, "n1")
    c.setup(t)
    ops = [("write", 4), ("read", None), ("cas", (4, 2)), ("cas", (4, 9)),
           ("read", None)]
    out = [(r.type, r.value) for r in
           (c.invoke(t, op_cls(0, "invoke", f, v)) for f, v in ops)]
    d = mod.CASClient(timeout=0.5).open(t, "dead")
    out += [d.invoke(t, op_cls(0, "invoke", f, v)).type
            for f, v in (("read", None), ("write", 1), ("cas", (1, 2)))]
    return out


def test_client_taxonomy(sims):
    (jmod, jport), (tmod, tport) = sims
    dead = free_port()
    got = taxonomy(tmod, Op, tport, dead)
    assert got == taxonomy(jmod, JOp, jport, dead)
    assert got[-3:] == ["fail", "info", "info"]


def test_suite_surface_matches_the_jax_package():
    for opts in ({"nodes": ["n1"], "nemesis": "start-kill"},
                 {"nodes": ["n1"]}, {"nodes": ["n1"], "nemesis": "none"}):
        j, t = jconsul.consul_test(opts), consul.consul_test(opts)
        assert sorted(j) == sorted(t)
        assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
        assert t["name"] == j["name"] == "consul"
    assert isinstance(consul.consul_test({"nodes": ["n1"], "nemesis":
                                          "start-kill"})["nemesis"],
                      common.StartKillNemesis)
    assert sorted(common.standard_nemeses(consul.ConsulDB())) == sorted(
        jcommon.standard_nemeses(jconsul.ConsulDB()))
    assert sorted(common.standard_nemeses(object())) == [
        "majority-ring", "none", "parts"]
    assert common.NEMESIS_NAMES == jcommon.NEMESIS_NAMES


def test_shared_flag_runs_once():
    flag, calls = common.shared_flag(), []
    threads = [threading.Thread(target=common.once,
                                args=(flag, lambda: calls.append(1)))
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert calls == [1] and flag["created"] is True


# ---------------------------------------------------------------------------
# ArchiveDB and the kill nemeses on simulated agents

@pytest.fixture
def agents(tmp_path):
    """Three consul agents set up through ConsulDB (an ArchiveDB) on
    consul_sim's recipe cluster; torn down after."""
    c = consul_sim.local_cluster(str(tmp_path), NODES)
    database = consul.ConsulDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": NODES, "consul": c["consul"]}
    try:
        for n in NODES:
            database.setup(test, n)
        yield database, test
    finally:
        for n in NODES:
            database.teardown(test, n)
    assert not glob.glob(str(tmp_path / "nodes" / "*" / "opt" / "consul"))


def read_key(test, node):
    return consul.ConsulKV("127.0.0.1", consul.node_port(test, node),
                           timeout=1.0).get()


def test_archive_db_lifecycle(agents):
    database, test = agents
    assert all(database.probe_ready(test, n) for n in NODES)
    assert all(database.alive(test, n) for n in NODES)
    consul.ConsulKV("127.0.0.1", consul.node_port(test, "n1")).put(b"7")
    assert read_key(test, "n3")[0] == b"7"  # one shared store
    database.kill(test, "n2")
    assert not database.alive(test, "n2")
    with pytest.raises(OSError):
        read_key(test, "n2")
    database.start_and_await(test, "n2")
    assert database.alive(test, "n2") and read_key(test, "n2")[0] == b"7"
    database.pause(test, "n3")
    with pytest.raises(OSError):
        read_key(test, "n3")
    database.resume(test, "n3")
    assert read_key(test, "n3")[0] == b"7"
    for n in NODES:
        (path,) = database.log_files(test, n)
        assert os.path.exists(path)
    assert common.poll_until_ready(database, test, NODES, 5.0) == []


def test_start_kill_nemesis(agents):
    database, test = agents
    nem = common.StartKillNemesis(database, 2).setup(test)
    out = nem.invoke(test, Op("nemesis", "info", "start", None))
    killed = sorted(n for n, v in out.value.items() if v == "killed")
    assert len(killed) == 2 and out.f == "start"
    assert [n for n in NODES if not database.alive(test, n)] == killed
    out = nem.invoke(test, Op("nemesis", "info", "stop", None))
    assert out.f == "stop" and out.value == {n: "started" for n in killed}
    assert common.poll_until_ready(database, test, NODES, 10.0) == []
    # nothing died since: a stop restarts nothing
    assert nem.invoke(test, Op("nemesis", "info", "stop", None)).value == {}


def test_archive_kill_nemesis_bounds_the_dead(agents):
    database, test = agents
    nem = common.archive_kill_nemesis(database, max_dead=1)
    out = nem.invoke(test, Op("nemesis", "info", "kill", ["n1", "n2"]))
    assert out.value == {"n1": "killed", "n2": "still-alive"}
    assert not database.alive(test, "n1") and database.alive(test, "n2")
    out = nem.invoke(test, Op("nemesis", "info", "restart", ["n1"]))
    assert out.value == {"n1": "started"}
    with pytest.raises(ValueError):
        nem.invoke(test, Op("nemesis", "info", "frob", ["n1"]))
    assert common.poll_until_ready(database, test, NODES, 10.0) == []


def test_ready_gated_final_waits_for_agents(agents):
    database, test = agents
    database.kill(test, "n1")
    g = common.ready_gated_final(database, {"type": "invoke", "f": "read"},
                                 {"ready_timeout": 10.0})
    threading.Timer(0.5, database.start, args=(test, "n1")).start()
    t0 = time.monotonic()
    op = g.op({**test}, 0)
    assert op["f"] == "read" and time.monotonic() - t0 >= 0.4
    assert database.probe_ready(test, "n1")


# ---------------------------------------------------------------------------
# full runs

def test_full_run_matches_the_jax_checker(tmp_path):
    c = consul_sim.local_cluster(str(tmp_path), NODES[:2])
    t = consul.consul_test({"nodes": NODES[:2], "remote": c["remote"],
                            "archive_url": c["archive_url"],
                            "consul": c["consul"], "concurrency": 4,
                            "time_limit": 5, "device": "cpu"})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    t["generator"] = gen.time_limit(4, gen.clients(gen.stagger(
        0.01, gen.mix([consul.r, consul.w, consul.cas]))))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert sum(o.type == "ok" for o in hist) > 10
    want = jchecker.linearizable().check(
        {"model": jmodels.CASRegister()}, to_jax(hist), {})
    assert normalise(res["linear"]) == normalise(want)


def test_recipe_cli_run_and_members_load_no_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = consul_sim.local_cluster(str(tmp_path / "cluster"), NODES[:2])
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(consul_sim.local_test_fn(c),
                            opt_spec=consul._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "2",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu"])
    assert rc == 0
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, "consul", "latest"))]
    with open(os.path.join(run_dir, "results.json")) as f:
        assert json.load(f)["linear"]["valid"] is True
    logs = glob.glob(os.path.join(run_dir, "n*", "*consul.log"))
    assert len(logs) == 2
    for p in logs:
        mods = {ln.rsplit("|", 1)[1].strip() for ln in open(p)
                if ln.startswith("import time:") and "|" in ln}
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        bad = {m for m in mods
               if m.split(".")[0] in ("jax", "jepsen_tpu", "torch")}
        assert not bad, (p, sorted(bad))


def test_recipe_refuses_fs_break(tmp_path):
    c = consul_sim.local_cluster(str(tmp_path / "cluster"), NODES[:2])
    rc = cli.run_cli(
        cli.single_test_cmd(consul_sim.local_test_fn(c),
                            opt_spec=consul._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--nemesis", "fs-break",
         "--time-limit", "3", "--store-dir", str(tmp_path / "store"),
         "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
