"""The port's chronos suite (dbs/mesos_sim.py, chronos_sim.py,
chronos.py) against the JAX package's, on the cases of
tests/test_mongo_rethink_chronos.py::TestChronosChecker and
::TestChronosEndToEnd: the checker's targets and misses, the simulator
running scheduled jobs whose run files the final read collects, and the
mesosphere stack's role split with the zookeeper gate. Then parity: the
checker's dict on seeded histories, both packages' chronos and mesos
simulators answering the same requests alike, the same job documents and
commands, the same test maps, and the recipe (`chronos_sim.
local_test_fn`) end to end with its stored history giving the JAX
package's checker dict and every job's run files under its node's
directory."""

from __future__ import annotations

import http.client
import json
import os
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from jepsen_tpu.dbs import chronos as jchronos
from jepsen_tpu.dbs import chronos_sim as jsim
from jepsen_tpu.dbs import mesos_sim as jmesos
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import core, nemesis
from jepsen_tpu_torch.dbs import chronos, chronos_sim, mesos_sim
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.util import real_pmap
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


# ---------------------------------------------------------------------------
# the checker (TestChronosChecker)

def history(cls, jobs, runs, read_time_s) -> list:
    hist = []
    i = 0
    for job in jobs:
        hist.append(cls(0, "invoke", "add-job", job, index=i, time=i))
        hist.append(cls(0, "ok", "add-job", job, index=i + 1, time=i + 1))
        i += 2
    hist.append(cls(0, "invoke", "read", None, index=i, time=i))
    hist.append(cls(0, "ok", "read", {"time": read_time_s, "runs": runs},
                    index=i + 1, time=i + 1))
    return hist


def check_both(jobs, runs, read_time_s) -> dict:
    got = chronos.ChronosChecker().check(
        {}, history(Op, jobs, runs, read_time_s), {})
    want = jchronos.ChronosChecker().check(
        {}, history(JOp, jobs, runs, read_time_s), {})
    assert got == want
    return got


JOB = {"name": 1, "start": 100.0, "count": 3, "duration": 1,
       "epsilon": 10, "interval": 30}


def test_all_targets_hit():
    runs = [{"node": "n1", "name": 1, "start": s, "end": s + 1}
            for s in (101.0, 131.0, 161.0)]
    res = check_both([JOB], runs, 300.0)
    assert res["valid"] is True, res


def test_missed_target_detected():
    runs = [{"node": "n1", "name": 1, "start": 101.0, "end": 102.0}]
    res = check_both([JOB], runs, 300.0)
    assert res["valid"] is False
    assert res["jobs"][1]["missed_targets"]


def test_future_targets_not_required():
    job = {**JOB, "count": 99}
    runs = [{"node": "n1", "name": 1, "start": 101.0, "end": 102.0}]
    # read at t=120: only the first target is due
    res = check_both([job], runs, 120.0)
    assert res["valid"] is True, res


@pytest.mark.parametrize("seed", range(6))
def test_checker_matches_on_seeded_histories(seed):
    """Jobs of random schedules, each target run on time, late, twice or
    not at all, read at a random moment: the same dict in both
    packages."""
    rng = random.Random(seed)
    jobs, runs = [], []
    for name in range(1, 2 + rng.randrange(6)):
        job = {"name": name, "start": 1000.0 + rng.randrange(50),
               "count": 1 + rng.randrange(8),
               "duration": rng.randrange(4), "epsilon": 5 + rng.randrange(10),
               "interval": 20 + rng.randrange(30)}
        jobs.append(job)
        for i in range(job["count"]):
            t = job["start"] + i * job["interval"]
            fate = rng.random()
            if fate < 0.15:
                continue
            late = (job["epsilon"] + chronos.EPSILON_FORGIVENESS + 1
                    if fate < 0.3 else rng.uniform(0, job["epsilon"]))
            for _ in range(2 if fate > 0.9 else 1):
                runs.append({"node": rng.choice(NODES), "name": name,
                             "start": t + late,
                             "end": t + late + job["duration"]})
    rng.shuffle(runs)
    check_both(jobs, runs, 1000.0 + rng.randrange(400))


@pytest.mark.parametrize("case", ["no-read", "old-read"])
def test_unknown_without_an_epoch_read(case):
    jobs = [JOB]
    hist = {"no-read": lambda cls: history(cls, jobs, [], 1)[:-2],
            "old-read": lambda cls: history(cls, jobs, [], 1)[:-1] + [
                cls(0, "ok", "read", [], index=3, time=3)]}[case]
    got = chronos.ChronosChecker().check({}, hist(Op), {})
    assert got == jchronos.ChronosChecker().check({}, hist(JOp), {})
    assert got["valid"] == "unknown"


# ---------------------------------------------------------------------------
# the simulators answer alike

def serve_chronos(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0
        zk_port = None

        def log_message(self, fmt, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def serve_mesos(sim, role):
    class H(sim.Handler):
        name = "n9"
        mean_latency = 0.0

        def log_message(self, fmt, *args):
            pass

    H.role = role
    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def exchange(port, calls) -> list:
    out = []
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        for method, path, body in calls:
            data = None if body is None else (
                body if isinstance(body, bytes) else json.dumps(body).encode())
            c.request(method, path, body=data,
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            raw = r.read()
            try:
                out.append((r.status, json.loads(raw) if raw else None))
            except ValueError:
                out.append((r.status, raw))
    finally:
        c.close()
    return out


def test_chronos_simulators_answer_alike(tmp_path):
    """The scheduler API of both packages' simulators, on jobs whose
    command writes into a directory of this test (and the far future, so
    no run starts before the simulators stop)."""
    d = tmp_path / "runs"
    d.mkdir()
    job = {"name": "7", "command": f"touch {d}/x",
           "schedule": "R2/2100-01-01T00:00:00+00:00/PT5S"}
    calls = [("GET", "/scheduler/jobs", None),
             ("POST", "/scheduler/iso8601", job),
             ("POST", "/scheduler/iso8601", {**job, "schedule": "nonsense"}),
             ("POST", "/scheduler/iso8601", b"not json"),
             ("POST", "/scheduler/iso8601", {**job, "name": "8",
                                             "schedule": "R/2100-01-01T00:"
                                             "00:00Z/PT1.5S"}),
             ("GET", "/scheduler/jobs", None),
             ("POST", "/elsewhere", {}),
             ("GET", "/elsewhere", None)]
    srvs = [serve_chronos(jsim, str(tmp_path / "jax.json")),
            serve_chronos(chronos_sim, str(tmp_path / "port.json"))]
    try:
        got, want = [exchange(s.server_address[1], calls) for s in srvs[::-1]]
    finally:
        for s in srvs:
            s.shutdown()
            s.server_close()
    assert got == want
    # an unknown route answers before reading its body, which the next
    # request on the connection then trips over (both packages)
    assert [s for s, _ in got] == [200, 204, 400, 400, 204, 200, 404, 501]
    assert sorted(j["name"] for j in got[5][1]) == ["7", "8"]
    assert not os.listdir(d)


@pytest.mark.parametrize("role", ["master", "slave"])
def test_mesos_simulators_answer_alike(role):
    calls = [("GET", "/state", None), ("GET", "/health", None),
             ("GET", "/state.json", None), ("GET", "/nowhere", None)]
    srvs = [serve_mesos(jmesos, role), serve_mesos(mesos_sim, role)]
    try:
        got, want = [exchange(s.server_address[1], calls) for s in srvs[::-1]]
    finally:
        for s in srvs:
            s.shutdown()
            s.server_close()
    assert got == want
    assert got[0] == (200, {"version": "0.23.0", "hostname": "n9",
                            "role": role, "activated_slaves": 1})
    assert [s for s, _ in got] == [200, 204, 200, 404]


@pytest.mark.parametrize("schedule", [
    "R3/2026-01-01T00:00:00+00:00/PT30S", "R/2026-01-01T00:00:00Z/PT2.5S",
    "R10/2026-10-18T12:34:56.789000+00:00/PT7S", "bad", "R1/x/PT1S"])
def test_schedules_parse_alike(schedule):
    def parse(mod):
        try:
            return mod.parse_iso8601_interval(schedule)
        except ValueError as e:
            return ("error", str(e))

    assert parse(chronos_sim) == parse(jsim)


def test_job_documents_match():
    rng = random.Random(4)
    test = {"chronos": {"job_dir": "/srv/jobs"}}
    for _ in range(20):
        job = {"name": rng.randrange(100), "start": 1.7e9 + rng.random() * 1e6,
               "count": 1 + rng.randrange(99), "duration": rng.randrange(10),
               "epsilon": 10 + rng.randrange(20),
               "interval": 16 + rng.randrange(60)}
        assert chronos.interval_str(job) == jchronos.interval_str(job)
        assert chronos.job_to_json(job, test) == jchronos.job_to_json(job,
                                                                      test)
        assert chronos.job_to_json(job, test, "n1") == \
            jchronos.job_to_json(job, test)
    per_node = {"chronos": {"job_dir": lambda n: f"/nodes/{n}/jobs"}}
    cmd = chronos.command(job, per_node, "n2")
    assert cmd.startswith("MEW=$(mktemp -p /nodes/n2/jobs);")
    assert chronos.job_dir(per_node, "n1") == "/nodes/n1/jobs"


def test_add_job_generators_match():
    g, jg = chronos.add_job_gen(), jchronos.add_job_gen()
    t = {"chronos_head_start": 1, "chronos_max_duration": 3,
         "chronos_max_count": 5}
    random.seed(9)
    got = [g(t, 0) for _ in range(10)]
    random.seed(9)
    want = [jg(t, 0) for _ in range(10)]
    for a, b in zip(got, want):
        assert abs(a["value"].pop("start") - b["value"].pop("start")) < 1
    assert got == want
    assert [o["value"]["name"] for o in got] == list(range(1, 11))


@pytest.mark.parametrize("opts", [{}, {"nemesis": "kill-zk"},
                                  {"nemesis": "kill-mesos-slave"},
                                  {"nemesis": "start-kill"}])
def test_chronos_test_maps_match(opts):
    base = {"nodes": ["n1", "n2", "n3", "n4"], "time_limit": 5, **opts}
    t, j = chronos.chronos_test(dict(base)), jchronos.chronos_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    for k in ("nemesis", "client", "db"):
        assert type(t[k]).__name__ == type(j[k]).__name__, k
    assert getattr(t["nemesis"], "role", None) == getattr(j["nemesis"],
                                                          "role", None)
    assert sorted(t["checker"].checker_map) == sorted(
        j["checker"].checker_map)
    for role in t["db"].ROLES:
        assert t["db"].role_nodes(t, role) == j["db"].role_nodes(j, role)
        for n in base["nodes"]:
            assert t["db"].role_args(t, n, role) == j["db"].role_args(
                j, n, role)


# ---------------------------------------------------------------------------
# end to end (TestChronosEndToEnd)

def test_sim_runs_jobs_and_checker_passes(tmp_path):
    """Fast jobs scheduled against the simulated stack through the
    recipe, their run files collected through the control plane from
    each node's own job directory: the schedule honoured, the stored
    history's ChronosChecker dict the JAX package's."""
    c = chronos_sim.local_cluster(str(tmp_path / "c"), NODES)
    t = chronos_sim.local_test_fn(c)({
        "nodes": NODES, "concurrency": 2, "time_limit": 3, "quiesce": 4,
        # fast jobs: start ~1 s out, tiny durations
        "chronos_head_start": 1, "chronos_max_duration": 1,
        "chronos_max_count": 2, "stagger": 1, "device": "cpu"})
    t["nemesis"] = nemesis.noop
    result = core.run(t)
    res = result["results"]
    assert res["chronos"]["valid"] is True, res
    reads = [o for o in result["history"]
             if o.type == "ok" and o.f == "read"]
    runs = reads[-1].value["runs"]
    assert runs, "no runs recorded"
    want = jchronos.ChronosChecker().check({}, to_jax(result["history"]), {})
    assert normalise(res["chronos"]) == normalise(want)
    assert sum(j["targets"] for j in res["chronos"]["jobs"].values()) > 0
    # each node's runs came from its own job directory, which teardown
    # removed with the node's daemons
    assert {r["node"] for r in runs} <= set(NODES)
    for n in NODES:
        assert not os.path.exists(os.path.join(
            c["remote"].node_dir(n), "jobs"))


def test_stack_topology_and_zk_gate(tmp_path):
    """The mesosphere stack: zk + mesos per node with the master/slave
    split, and killing a node's zookeeper makes ITS chronos answer 500
    while the others keep serving; reviving it brings it back."""
    nodes = ["n1", "n2", "n3", "n4"]
    c = chronos_sim.local_cluster(str(tmp_path / "c"), nodes)
    cfg = c["chronos"]
    t = {"nodes": nodes, "remote": c["remote"], "chronos": cfg,
         "archive_url": c["archive_url"]}
    db_ = chronos.ChronosDB(archive_url=t["archive_url"])
    assert db_.role_nodes(t, "mesos-master") == ["n1", "n2", "n3"]
    assert db_.role_nodes(t, "mesos-slave") == ["n4"]
    real_pmap(lambda n: db_.setup(t, n), nodes)
    try:
        for n, role in (("n1", "master"), ("n4", "slave")):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{cfg['mesos_ports'][n]}/state",
                    timeout=2) as r:
                assert json.load(r)["role"] == role
        db_.stop_component(t, "n1", "zk")
        deadline = time.monotonic() + 10
        gated = False
        while time.monotonic() < deadline and not gated:
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{cfg['ports']['n1']}/scheduler/jobs",
                    timeout=2)
            except urllib.error.HTTPError as e:
                gated = e.code == 500
            time.sleep(0.2)
        assert gated, "chronos never noticed its zk died"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{cfg['ports']['n2']}/scheduler/jobs",
                timeout=2) as r:
            assert r.status == 200
        db_.start_component(t, "n1", "zk")
        deadline = time.monotonic() + 10
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{cfg['ports']['n1']}"
                        "/scheduler/jobs", timeout=2) as r:
                    assert r.status == 200
                    break
            except urllib.error.HTTPError:
                assert time.monotonic() < deadline, "never recovered"
                time.sleep(0.2)
    finally:
        for n in nodes:
            db_.teardown(t, n)
    for n in nodes:
        for role in db_.ROLES:
            assert not db_.component_running(t, n, role), (n, role)
