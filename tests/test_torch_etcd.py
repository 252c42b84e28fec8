"""The port's etcd suite end to end on the CPU (`device="cpu"`): the
simulated cluster over LocalRemote through `core.run` (3 nodes,
concurrency 6, as tests/test_etcd.py) and through the `test`
subcommand (exit code, store layout), the JAX package's `analyze` over
the port's store, a SIGTERM then `resume` in a subprocess (143 then 0),
a node process that loads neither `jepsen_tpu` nor `jax` (nor torch),
and `test` without `--device` on a box without CUDA raising before any
node directory exists. Every member process a test starts is stopped in
a finalizer, and every wait has a timeout."""

from __future__ import annotations

import datetime
import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from jepsen_tpu_torch import cli, core, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent, models, nemesis
from jepsen_tpu_torch.checker import linearizable
from jepsen_tpu_torch.dbs import etcd, etcd_sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES = ["n1", "n2", "n3"]
NODE_ARGS = [a for n in NODES for a in ("--node", n)]
SUITE = {"threads_per_key": 3, "ops_per_key": 30}


def stop_members(root):
    """Kill every simulated member whose pidfile is under root (the
    finalizer of every test that starts one)."""
    for pidfile in glob.glob(os.path.join(root, "nodes", "*", "opt", "etcd",
                                          "etcd.pid")):
        try:
            pid = int(open(pidfile).read().strip())
            os.kill(pid, signal.SIGKILL)
        except (OSError, ValueError):
            pass


@pytest.fixture
def cluster_root(tmp_path):
    root = str(tmp_path / "cluster")
    yield root
    stop_members(root)


def test_engine_run_against_sim_cluster(cluster_root):
    import itertools

    c = etcd_sim.local_cluster(cluster_root, NODES)
    test = {
        "name": "etcd-sim", "nodes": NODES, "remote": c["remote"],
        "etcd": c["etcd"], "device": "cpu",
        "db": etcd.EtcdDB(version="sim", url=c["archive_url"]),
        "client": etcd.EtcdClient(timeout=2.0), "nemesis": nemesis.noop,
        "os": None, "net": None, "concurrency": 6,
        "model": models.CASRegister(),
        "checker": independent.checker(linearizable(device="cpu")),
        "generator": gen.time_limit(8, gen.clients(
            independent.concurrent_generator(3, itertools.count(), lambda k:
                gen.limit(30, gen.stagger(0.005, gen.mix(
                    [etcd.r, etcd.w, etcd.cas])))))),
    }
    t0 = time.monotonic()
    result = core.run(test)
    assert time.monotonic() - t0 < 60
    assert result["results"]["valid"] is True, result["results"]
    hist = result["history"]
    assert len(hist) > 40
    assert {"read", "write", "cas"} <= {o.f for o in hist if o.type == "ok"}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One `test` subcommand run on the CPU (5 s), its member processes
    profiling their imports into their logs (which the run downloads
    into its store before teardown)."""
    base = tmp_path_factory.mktemp("etcd_cli")
    root, sd = str(base / "cluster"), str(base / "store")
    c = etcd_sim.local_cluster(root, NODES)
    remote, cmds = c["remote"], []
    run_cmd = remote.exec

    def exec_(node, cmd, *a, **k):
        cmds.append(cmd if isinstance(cmd, str) else " ".join(map(str, cmd)))
        return run_cmd(node, cmd, *a, **k)

    remote.exec = exec_
    prev = os.environ.get("PYTHONPROFILEIMPORTTIME")
    os.environ["PYTHONPROFILEIMPORTTIME"] = "1"
    try:
        rc = cli.run_cli(
            cli.single_test_cmd(etcd_sim.local_test_fn(c, suite_opts=SUITE),
                                opt_spec=etcd._opt_spec),
            ["test", *NODE_ARGS, "--concurrency", "2n", "--time-limit", "5",
             "--store-dir", sd, "--device", "cpu"])
    finally:
        if prev is None:
            os.environ.pop("PYTHONPROFILEIMPORTTIME", None)
        else:
            os.environ["PYTHONPROFILEIMPORTTIME"] = prev
        stop_members(root)
    run_dir = os.path.realpath(os.path.join(sd, "etcd", "latest"))
    return rc, sd, run_dir, root, cmds


def test_cli_test_exit_code_and_store(cli_run):
    rc, sd, run_dir, _, _ = cli_run
    assert rc == 0
    names = set(os.listdir(run_dir))
    assert {"history.jsonl", "history.txt", "results.json", "test.json",
            "history.wal.jsonl", "run.ckpt.json", "jepsen.log",
            "analysis.ckpt.jsonl", "independent"} <= names
    assert {"n1", "n2", "n3"} <= names  # the members' logs
    results = json.load(open(os.path.join(run_dir, "results.json")))
    assert results["valid"] is True
    assert results["indep"]["valid"] is True and results["perf"]["valid"]
    keys = os.listdir(os.path.join(run_dir, "independent"))
    assert keys and all(os.path.exists(os.path.join(
        run_dir, "independent", k, "results.edn")) for k in keys)
    test_json = json.load(open(os.path.join(run_dir, "test.json")))
    assert test_json["concurrency"] == 6 and test_json["nodes"] == NODES


def test_jax_analyze_reads_port_store(cli_run):
    """The JAX package's `analyze` over the port's store gives the
    port's per-key verdicts (the JAX package's linearizable checker on
    the host search). history.jsonl keeps a keyed value as its
    [key, value] list; the port stamps such an op ``_kv`` and keys it
    again on reading, but the JAX package's reader leaves it a list, so
    its checker keys the ops again first."""
    from jepsen_tpu import checker as jchecker
    from jepsen_tpu import cli as jcli
    from jepsen_tpu import independent as jind
    from jepsen_tpu import models as jmodels
    from jepsen_tpu import store as jstore

    rc, sd, run_dir, _, _ = cli_run
    before = json.load(open(os.path.join(run_dir, "results.json")))

    class Rekeyed(jchecker.Checker):
        def __init__(self, c):
            self.c = c

        def check(self, test, history, opts=None):
            return self.c.check(test, [
                o.with_(value=jind.tuple_(*o.value))
                if isinstance(o.value, list) and len(o.value) == 2 else o
                for o in history], opts)

    def jtest(opts):
        return {"name": "etcd", "model": jmodels.CASRegister(),
                "checker": Rekeyed(jind.checker(jchecker.linearizable(
                    algorithm="host")))}

    assert jcli.run_cli(jcli.single_test_cmd(jtest),
                        ["analyze", "--store-dir", sd]) == 0
    after = jstore.load_results("etcd", os.path.basename(run_dir),
                                store_dir=sd)
    assert after["valid"] is True
    port = {k: r["linear"]["valid"]
            for k, r in before["indep"]["results"].items()}
    assert port and {k: r["valid"] for k, r in after["results"].items()} \
        == port


def test_sim_run_scratch_inside_cluster(cli_run):
    """Every path the run's commands give under /tmp/jepsen (the archive
    install's scratch) lies in a node's own directory, and that scratch
    is gone again: nothing is written to the machine's /tmp/jepsen."""
    import re

    rc, sd, run_dir, root, cmds = cli_run
    used = [m.group(1) for c in cmds
            for m in re.finditer(r"(\S*/tmp/jepsen)\b", c)]
    assert used, "the run installed no archive"
    assert all(u.startswith(os.path.join(root, "nodes") + os.sep)
               for u in used), sorted(set(used))
    for n in NODES:
        scratch = os.path.join(root, "nodes", n, "tmp", "jepsen")
        assert os.path.isdir(scratch) and not os.listdir(scratch)


def test_analyze_planted_store_from_wal_and_jsonl(cli_run, tmp_path):
    """`analyze` with the suite's own checker over a keyed store whose
    history plants a stale read on two keys exits 1 with exactly those
    keys invalid, both from the WAL alone (a run killed before save_1)
    and once save_1 has written history.jsonl: a store's keyed ops come
    back keyed from either file."""
    rc, sd, run_dir, _, _ = cli_run
    hist = store.load_history({"name": "etcd", "store_dir": sd,
                               "start_time": os.path.basename(run_dir)})
    keys, reads = set(), {}
    for i, o in enumerate(hist):
        if o.process != "nemesis":
            assert isinstance(o.value, independent.KVTuple), o
            keys.add(o.value.key)
        if o.type == "ok" and o.f == "read":
            reads.setdefault(o.value.key, i)
    planted = sorted(reads)[:2]
    assert len(planted) == 2
    hist = [o.with_(value=independent.tuple_(o.value.key, -1))
            if i in {reads[k] for k in planted} else o
            for i, o in enumerate(hist)]
    sd2 = str(tmp_path / "store")
    test = {"name": "etcd", "store_dir": sd2, "history": hist,
            "start_time": store.time_str(datetime.datetime.now())}
    wal = store.HistoryWAL(test, fsync="close")
    for o in hist:
        wal.append(o)
    wal.close()
    c = etcd_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    cmd = cli.single_test_cmd(etcd_sim.local_test_fn(c, suite_opts=SUITE),
                              opt_spec=etcd._opt_spec)
    for step in ("wal", "jsonl"):
        if step == "jsonl":
            store.save_1(test)
            os.remove(store.path(test, store.ANALYSIS_CKPT_FILE))
        assert cli.run_cli(cmd, ["analyze", "--store-dir", sd2,
                                 "--device", "cpu"]) == 1, step
        results = store.load_results("etcd", test["start_time"],
                                     store_dir=sd2)
        assert results["valid"] is False
        per_key = results["indep"]["results"]
        assert len(per_key) == len(keys)
        assert sorted(k for k, r in per_key.items()
                      if r["valid"] is False) == sorted(map(str, planted))


def test_member_loads_no_jax(cli_run):
    """Each member process's import profile (PYTHONPROFILEIMPORTTIME,
    in its log) names the port's simulator base and neither the JAX package,
    jax, nor torch."""
    rc, sd, run_dir, _, _ = cli_run
    logs = glob.glob(os.path.join(run_dir, "n*", "*etcd.log"))
    assert len(logs) == len(NODES)
    for p in logs:
        mods = {ln.rsplit("|", 1)[1].strip() for ln in open(p)
                if ln.startswith("import time:") and "|" in ln}
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p  # etcd_sim is __main__
        bad = {m for m in mods
               if m.split(".")[0] in ("jax", "jepsen_tpu", "torch")}
        assert not bad, (p, sorted(bad))


@pytest.mark.parametrize("suite", ["tidb", "chronos"])
def test_multi_daemon_members_load_no_jax(tmp_path, monkeypatch, suite):
    """The member check on nodes that run several daemons: a tidb node
    (pd, tikv, tidb) and the chronos stack's nodes (zookeeper, a mesos
    master or slave, chronos), brought up by their suites' DBs on the
    recipes' clusters; every daemon's import profile names the port's
    dbs package and neither the JAX package, jax, nor torch."""
    from concurrent.futures import ThreadPoolExecutor

    from jepsen_tpu_torch.dbs import chronos, chronos_sim, tidb, tidb_sim

    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    if suite == "tidb":
        nodes = ["n1"]
        c = tidb_sim.local_cluster(str(tmp_path / "c"), nodes)
        db = tidb.TidbDB(archive_url=c["archive_url"])
    else:
        nodes = ["n1", "n2", "n3", "n4"]
        c = chronos_sim.local_cluster(str(tmp_path / "c"), nodes)
        db = chronos.ChronosDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": nodes, suite: c[suite]}
    with ThreadPoolExecutor(len(nodes)) as ex:
        for f in [ex.submit(db.setup, test, n) for n in nodes]:
            f.result()
    try:
        roles = set()
        for n in nodes:
            for role in db.ROLES:
                if n not in db.role_nodes(test, role):
                    continue
                assert db.component_running(test, n, role), (n, role)
                logf, _ = db._role_files(test, n, role)
                mods = {ln.rsplit("|", 1)[1].strip() for ln in open(logf)
                        if ln.startswith("import time:") and "|" in ln}
                assert "jepsen_tpu_torch.dbs" in mods, logf
                bad = {m for m in mods
                       if m.split(".")[0] in ("jax", "jepsen_tpu", "torch")}
                assert not bad, (logf, sorted(bad))
                roles.add(role)
        assert roles == set(db.ROLES)
    finally:
        for n in nodes:
            db.teardown(test, n)


def test_test_without_device_raises_before_provisioning(tmp_path,
                                                        monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "cluster")
    c = etcd_sim.local_cluster(root, NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(etcd_sim.local_test_fn(c, suite_opts=SUITE),
                            opt_spec=etcd._opt_spec),
        ["test", *NODE_ARGS, "--concurrency", "2n", "--time-limit", "5",
         "--store-dir", str(tmp_path / "store")])
    assert rc == 255
    assert not os.path.exists(os.path.join(root, "nodes"))
    assert not os.path.exists(str(tmp_path / "store"))


SCRIPT = textwrap.dedent("""
    import json, sys
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.dbs import etcd, etcd_sim
    cfg = json.load(open(sys.argv[1]))
    c = etcd_sim.local_cluster(cfg["root"], cfg["nodes"], ports=cfg["ports"])
    fn = etcd_sim.local_test_fn(c, suite_opts=cfg["suite"])
    sys.exit(cli.run_cli(cli.single_test_cmd(fn, opt_spec=etcd._opt_spec),
                         sys.argv[2:]))
""")


def test_sigterm_then_resume(tmp_path, cluster_root):
    """A SIGTERM drains the run and exits 143 with its WAL and
    checkpoint saved and the members left running; `resume` continues
    it to its time limit and exits 0, the history holding the first
    session's ops then the second's."""
    sd = str(tmp_path / "store")
    script = tmp_path / "session.py"
    script.write_text(SCRIPT)
    cfg = tmp_path / "cfg.json"
    ports = etcd_sim.local_cluster(cluster_root, NODES)["ports"]
    cfg.write_text(json.dumps({"root": cluster_root, "nodes": NODES,
                               "ports": ports, "suite": SUITE}))
    env = {**os.environ, "PYTHONPATH": REPO}
    # the drain ends with the nemesis's current 5-s sleep (etcd's
    # schedule), so 12 s leave the resumed session at least 2
    args = [*NODE_ARGS, "--concurrency", "2n", "--time-limit", "12",
            "--store-dir", sd, "--device", "cpu"]
    p = subprocess.Popen([sys.executable, str(script), str(cfg), "test",
                          *args], env=env, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        wal = None
        while True:
            assert p.poll() is None, "the run ended before the SIGTERM"
            assert time.monotonic() < deadline, "no ops in 60 s"
            found = glob.glob(os.path.join(sd, "etcd", "*",
                                           "history.wal.jsonl"))
            if found and sum(1 for _ in open(found[0])) >= 40:
                wal = os.path.realpath(found[0])
                break
            time.sleep(0.1)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 143
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=20)
    run_dir = os.path.dirname(wal)
    first = [json.loads(ln) for ln in open(wal)]
    assert os.path.exists(os.path.join(run_dir, "run.ckpt.json"))
    assert not os.path.exists(os.path.join(run_dir, "results.json"))
    assert len(glob.glob(os.path.join(cluster_root, "nodes", "*", "opt",
                                      "etcd", "etcd.pid"))) == len(NODES)
    out = subprocess.run([sys.executable, str(script), str(cfg), "resume",
                          run_dir, *args], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    results = json.load(open(os.path.join(run_dir, "results.json")))
    assert results["valid"] is True
    hist = store.load_history({"name": "etcd",
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    assert len(hist) > len(first)
    assert all(isinstance(o.value, independent.KVTuple) for o in hist
               if o.process != "nemesis")  # keyed again on reading
    strip = ("index", "_epoch", "_kv")
    assert ([{k: v for k, v in json.loads(json.dumps(o.to_dict())).items()
              if k not in strip} for o in hist[:len(first)]]
            == [{k: v for k, v in json.loads(json.dumps(d)).items()
                 if k not in strip} for d in first])
    assert [o.index for o in hist] == list(range(len(hist)))
    epochs = {json.loads(ln).get("_epoch", 0) for ln in open(wal)}
    assert epochs == {0, 1}
    # the resumed run tore the cluster down
    assert not glob.glob(os.path.join(cluster_root, "nodes", "*", "opt",
                                      "etcd", "etcd.pid"))


def test_suite_listing():
    """`python -m jepsen_tpu_torch.dbs` lists the port's suites:
    aerospike, cockroachdb, crate, dgraph, elasticsearch, galera,
    hazelcast, both mongodb flavours, mysql-cluster, percona, rabbitmq,
    rethinkdb and tidb (with their workloads), chronos, consul, disque,
    etcd, logcabin, postgres-rds, raftis, robustirc and zookeeper."""
    out = subprocess.run([sys.executable, "-m", "jepsen_tpu_torch.dbs"],
                         cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "23 per-DB suites" in out.stdout
    for mod in ("aerospike", "chronos", "cockroach_workloads", "consul",
                "crate", "dgraph", "disque", "elasticsearch", "etcd",
                "galera", "hazelcast", "logcabin", "mongodb",
                "mysql_cluster", "percona", "postgres_rds", "rabbitmq",
                "raftis", "rethinkdb", "robustirc", "tidb", "zookeeper"):
        assert f"jepsen_tpu_torch.dbs.{mod}" in out.stdout
    assert out.stdout.count("workloads: bank, dirty-reads, sets") == 2
    assert "workloads: bank, sets\n" in out.stdout
    assert "workloads: bank, register, sets" in out.stdout
    assert "workloads: dirty-read, lost-updates, version-divergence" in \
        out.stdout
    for name in ("mongodb-rocks", "mongodb-smartos"):
        assert f"  {name} " in out.stdout
    assert out.stdout.count("workloads: document-cas, transfer, "
                            "logger-perf") == 2
    assert "workloads: cas, reconfigure" in out.stdout
    assert "workloads: cas-register, counter, set" in out.stdout
    assert "workloads: atomic-long-ids, atomic-ref-ids, crdt-map, " \
        "id-gen-ids, lock, map, queue" in out.stdout
    assert "workloads: queue, mutex" in out.stdout
    assert "workloads: dirty-read, register, set" in out.stdout
    assert "workloads: bank, comments, g2, monotonic, register, " \
        "sequential, sets" in out.stdout
    assert "workloads: set, upsert, bank, delete, sequential, " \
        "linearizable-register, uid-linearizable-register, long-fork, " \
        "types" in out.stdout


def test_readiness_poll_and_gate():
    """dbs.common's readiness poll returns the nodes still down at its
    deadline, and its generator gate polls once before the first op."""
    from jepsen_tpu_torch.dbs import common

    class DB:
        def __init__(self, up_after):
            self.calls, self.up_after = {}, up_after

        def probe_ready(self, test, node):
            self.calls[node] = self.calls.get(node, 0) + 1
            if node == "bad":
                raise OSError("refused")
            return self.calls[node] > self.up_after

    test = {"nodes": ["n1", "n2"], "concurrency": 1}
    assert common.poll_until_ready(DB(2), test, test["nodes"], 10) == []
    assert common.poll_until_ready(DB(0), test, ["n1", "bad"], 0.3) == ["bad"]
    db = DB(1)
    g = common.await_ready_gen(db, gen.limit(2, {"f": "read"}), timeout=10)
    assert [g.op(test, 0)["f"] for _ in range(2)] == ["read", "read"]
    assert g.op(test, 0) is None and db.calls == {"n1": 2, "n2": 2}
