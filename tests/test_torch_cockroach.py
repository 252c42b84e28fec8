"""The port's cockroachdb suite (dbs/cockroach.py, cockroach_workloads.py,
crdb_sim.py, pg_proto.py) against the JAX package's, on the cases of
tests/test_cockroach.py and tests/test_cockroach_nemeses.py: the same
SQL sequence against both packages' simulators gives the same rows, row
counts and SQLSTATEs (40001 on contention included); the client
helpers, the nemesis registry, composition, the split and clock
nemeses and the host checkers give the same results; and every workload
runs end to end on simulated nodes with device="cpu", valid, its
recorded history giving the JAX package's checker's dict. Also the
simulated-cluster recipe (`crdb_sim.local_test_fn`): the CLI run, the
clock nemeses recorded, fs-break refused, and member processes that
load neither torch nor jax."""

from __future__ import annotations

import glob
import os
import threading
import time

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu import nemesis as jnem
from jepsen_tpu.dbs import cockroach as jcr
from jepsen_tpu.dbs import cockroach_workloads as jcrw
from jepsen_tpu.dbs import crdb_sim as jsim
from jepsen_tpu.dbs import pg_proto as jpg
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.workloads import adya as jadya
from jepsen_tpu.workloads import bank as jbank

from jepsen_tpu_torch import cli, core, generator as gen, nemesis
from jepsen_tpu_torch.control import DummyRemote
from jepsen_tpu_torch.dbs import cockroach as cr
from jepsen_tpu_torch.dbs import cockroach_workloads as crw
from jepsen_tpu_torch.dbs import crdb_sim, pg_proto
from jepsen_tpu_torch.history import Op
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve(mod, path, monkeypatch):
    """One package's pgwire simulator in process on an ephemeral port,
    with a short lock timeout so contention surfaces at once."""
    monkeypatch.setattr(mod, "TXN_LOCK_TIMEOUT", 0.2)

    class H(mod.Handler):
        store = mod.Store(path)
        mean_latency = 0.0

    srv = mod.Server(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sims(tmp_path, monkeypatch):
    """(pg module, port) of the JAX package's simulator and the port's."""
    srvs = [serve(jsim, str(tmp_path / "jax.json"), monkeypatch),
            serve(crdb_sim, str(tmp_path / "port.json"), monkeypatch)]
    yield [(jpg, srvs[0].server_address[1]),
           (pg_proto, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def replies(pg, port, script) -> list:
    """Each (connection, statement) of `script` sent on one of two
    connections: ("ok", rows, rowcount, tag) or ("error", SQLSTATE,
    retryable)."""
    conns = [pg.PgConn("127.0.0.1", port, timeout=5.0, connect_timeout=5.0)
             for _ in range(2)]
    out = []
    try:
        for c, sql in script:
            try:
                r = conns[c].query(sql)
                out.append(("ok", sorted(r.rows), r.rowcount, r.tag))
            except pg.PgError as e:
                out.append(("error", e.sqlstate, e.retryable))
    finally:
        for c in conns:
            c.close()
    return out


SCRIPTS = {
    "select_one": [(0, "select 1")],
    "ddl_insert_select": [
        (0, "create table t (id int primary key, val int)"),
        (0, "insert into t values (1, 10), (2, 20)"),
        (1, "select val from t where id = 2"),
        (1, "select id, val from t"),
        (0, "select * from t where id = 1"),
        (0, "delete from t where id = 1"),
        (1, "select id from t"),
        (0, "drop table if exists t"),
        (0, "select id from t")],
    "update_rowcount_cas": [
        (0, "create table t (id int, val int)"),
        (0, "insert into t values (1, 5)"),
        (0, "update t set val = 6 where id = 1 and val = 5"),
        (1, "update t set val = 7 where id = 1 and val = 5"),
        (1, "select val from t where id = 1")],
    "max_and_modulo": [
        (0, "create table m (val int, key int)"),
        (0, "select max(val) as m from m"),
        (0, "insert into m values (3, 1), (9, 1), (4, 2)"),
        (1, "select max(val) as m from m"),
        (1, "select val from m where key = 1 and val % 3 = 0")],
    "duplicate_pkey": [
        (0, "create table t (id int primary key, val int)"),
        (0, "insert into t values (1, 1)"),
        (0, "insert into t values (1, 2)"),
        (0, "select 1")],
    "txn_commit_rollback": [
        (0, "create table t (id int, val int)"),
        (0, "begin"), (0, "insert into t values (1, 1)"), (0, "commit"),
        (1, "select id from t"),
        (0, "begin"), (0, "insert into t values (2, 2)"), (0, "rollback"),
        (1, "select id from t")],
    "contention_40001": [
        (0, "create table t (id int, val int)"),
        (0, "begin"), (0, "insert into t values (1, 1)"),
        (1, "begin"),
        (0, "commit"),
        (1, "begin"), (1, "rollback"),
        (1, "select id from t")],
    "aborted_until_rollback": [
        (0, "create table t (id int primary key, val int)"),
        (0, "insert into t values (1, 1)"),
        (0, "begin"), (0, "insert into t values (1, 9)"),
        (0, "select 1 from t"), (0, "rollback"),
        (0, "select val from t where id = 1")],
    "split": [
        (0, "create table test (id int, val int)"),
        (0, "alter table test split at values (5)"),
        (1, "alter table test split at values (5)")],
    "errors": [
        (0, "select val from missing"),
        (0, "frobnicate the table")],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_simulators_reply_alike(sims, name):
    (jmod, jport), (tmod, tport) = sims
    want = replies(jmod, jport, SCRIPTS[name])
    assert replies(tmod, tport, SCRIPTS[name]) == want
    if name == "contention_40001":
        assert ("error", "40001", True) in want
    if name == "aborted_until_rollback":
        assert ("error", "25P02", False) in want
    if name == "duplicate_pkey":
        assert want[2] == ("error", "23505", False)


def test_cluster_logical_timestamp_monotone(sims):
    for pg, port in sims:
        c = pg.PgConn("127.0.0.1", port, timeout=5.0, connect_timeout=5.0)
        a, b = (float(c.query("select cluster_logical_timestamp()"
                              ).scalars()[0]) for _ in range(2))
        c.close()
        assert b > a


def test_execute_matches_the_jax_engine():
    """The mini SQL engine itself (`execute` on a data map), statement by
    statement: the same (columns, rows, tag) or the same SqlError."""
    script = [sql for _, sql in SCRIPTS["ddl_insert_select"]
              + SCRIPTS["max_and_modulo"] + SCRIPTS["split"]]
    out = []
    for mod in (jsim, crdb_sim):
        data, got = {}, []
        for sql in script:
            try:
                got.append(mod.execute(data, sql))
            except mod.SqlError as e:
                got.append(("error", e.sqlstate, str(e)))
        out.append((got, data))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# client helpers (TestClientHelpers)

def test_txn_retry_retries_40001():
    for mod, pg in ((jcr, jpg), (cr, pg_proto)):
        calls = {"n": 0}

        def body():
            calls["n"] += 1
            if calls["n"] < 3:
                raise pg.PgError("40001", "restart transaction")
            return "done"

        assert mod.txn_retry(body, backoff=0.001) == "done"
        assert calls["n"] == 3

        def other():
            raise pg.PgError("23505", "dup")

        with pytest.raises(pg.PgError):
            mod.txn_retry(other, backoff=0.001)


def taxonomy(mod, pg, op_cls) -> list:
    op = op_cls(process=0, type="invoke", f="read", value=None)
    errs = [pg.PgError("40001", "restart transaction"),
            pg.PgError("23505", "dup"), pg.PgError("XX000", "boom"),
            ConnectionRefusedError(), TimeoutError(), ConnectionResetError(),
            pg.PgProtocolError("bad"), ValueError()]
    out = []
    for e in errs:
        r = mod.exception_to_op(op, e)
        out.append(None if r is None else (r.type, r.error))
    for t, f in (("info", "read"), ("info", "write"), ("ok", "read")):
        r = mod.with_idempotent({"read"}, op_cls(0, t, f, None))
        out.append((r.type, r.f))
    return out


def test_exception_taxonomy_and_idempotence():
    got = taxonomy(cr, pg_proto, Op)
    assert normalise(got) == normalise(taxonomy(jcr, jpg, JOp))
    assert got[0] == ("fail", ("restart-transaction", "restart transaction"))
    assert got[3] == ("fail", "connection-refused")
    assert got[7] is None and got[8] == ("fail", "read")


# ---------------------------------------------------------------------------
# the nemesis registry (TestNemesisRegistry, TestSkewRegistry)

def shape(nem) -> tuple:
    """A nemesis map's name, clocks flag and its client's class chain."""
    chain, c = [], nem["client"]
    while c is not None:
        chain.append(type(c).__name__)
        c = getattr(c, "nem", None)
    return nem["name"], nem["clocks"], chain, sorted(nem)


def test_registry_matches_the_jax_package():
    assert sorted(cr.nemeses()) == sorted(jcr.nemeses())
    for name in cr.nemeses():
        if name.startswith("fs-break"):
            continue  # needs the FUSE layer's opt dir; shape only below
        assert shape(cr.nemeses()[name]()) == shape(jcr.nemeses()[name]())
    assert cr.fs_break()["name"] == jcr.fs_break()["name"] == "fs-break"


def test_resolve_composed_routing():
    for mod in (jcr, cr):
        nem = mod.resolve_nemesis({"nemesis": "parts",
                                   "nemesis2": "majority-ring"})
        assert nem["name"] == "parts+majring"
        comp = nem["client"]
        sub, inner = comp._route(("parts", "start"))
        sub2, inner2 = comp._route(("majring", "stop"))
        assert (inner, inner2) == ("start", "stop") and sub is not sub2
        with pytest.raises(ValueError):
            comp._route(("unknown", "start"))
    assert isinstance(cr.resolve_nemesis({"nemesis": "parts"})["client"],
                      nemesis.Partitioner)


def test_composed_final_emits_named_fs():
    nem = cr.resolve_nemesis({"nemesis": "parts",
                              "nemesis2": "majority-ring"})
    ops = []
    with gen.with_threads(["nemesis"]):
        for _ in range(2):
            op = nem["final"].op({"concurrency": 2}, "nemesis")
            if op is None:
                break
            ops.append(op)
    assert {o["f"] for o in ops} == {("parts", "stop"), ("majring", "stop")}


def test_strobe_skews_has_no_sleeps():
    entry = cr.strobe_skews()
    assert entry["clocks"] is True
    assert isinstance(entry["client"].nem, cr.StrobeTime)
    ops = []
    with gen.with_threads(["nemesis"]):
        t0 = time.monotonic()
        for _ in range(4):
            ops.append(entry["during"].op({}, "nemesis")["f"])
    assert ops == ["start", "stop", "start", "stop"]
    assert time.monotonic() - t0 < 1.0


# ---------------------------------------------------------------------------
# the wrapping and clock nemeses (tests/test_cockroach_nemeses.py)

class Recorder:
    """An inner nemesis recording what reached it (as the JAX package's
    test's _Recorder); `fail_on` raises on that f."""

    def __init__(self, base, fail_on=None):
        self.base, self.fail_on, self.calls = base, fail_on, []

    def make(self):
        rec = self

        class R(self.base):
            def setup(self, test):
                rec.calls.append("setup")
                return self

            def invoke(self, test, op):
                rec.calls.append(op.f)
                if op.f == rec.fail_on:
                    raise RuntimeError("inner failed")
                return op.with_(type="info", value="inner")

            def teardown(self, test):
                rec.calls.append("teardown")

        return R()


class RecordingNet:
    def __init__(self):
        self.calls = []

    def slow(self, test):
        self.calls.append("slow")

    def fast(self, test):
        self.calls.append("fast")


def slowing_trace(mod, nem_mod, op_cls) -> list:
    rec, net = Recorder(nem_mod.Nemesis, fail_on="stop"), RecordingNet()
    test = {"net": net, "nodes": NODES}
    s = mod.Slowing(rec.make(), 0.5)
    s.setup(test)
    out = [s.invoke(test, op_cls("nemesis", "info", "start", None)).value]
    with pytest.raises(RuntimeError):
        s.invoke(test, op_cls("nemesis", "info", "stop", None))
    s.teardown(test)
    return [net.calls, rec.calls, out]


def test_slowing_matches_the_jax_package():
    got = slowing_trace(cr, nemesis, Op)
    assert got == slowing_trace(jcr, jnem, JOp)
    assert got[0] == ["fast", "slow", "fast", "fast"]


def test_restarting_restarts_every_node(monkeypatch):
    for mod, nem_mod, op_cls in ((jcr, jnem, JOp), (cr, nemesis, Op)):
        started = []
        monkeypatch.setattr(mod, "start_node",
                            lambda t, n, s=started: s.append(n))
        rec = Recorder(nem_mod.Nemesis)
        r = mod.Restarting(rec.make())
        test = {"nodes": NODES}
        out = r.invoke(test, op_cls("nemesis", "info", "start", None))
        assert out.value == "inner" and started == []
        out = r.invoke(test, op_cls("nemesis", "info", "stop", None))
        assert sorted(started) == NODES
        assert out.value == ["inner", ["started", "started"]]


def clock_commands(mod, nt, op_cls, monkeypatch) -> list:
    remote = DummyRemote()
    test = {"remote": remote, "nodes": NODES}
    monkeypatch.setattr("random.random", lambda: 0.0)
    monkeypatch.setattr(nt, "install", lambda r, n: None)
    monkeypatch.setattr(nt, "parse_time", lambda s: 0.0)
    bump = mod.BumpTime(0.25)
    vals = [bump.invoke(test, op_cls("nemesis", "info", f, None)).value
            for f in ("start", "stop")]
    strobe = mod.StrobeTime(200, 10, 5)
    vals.append(strobe.invoke(test, op_cls("nemesis", "info", "start",
                                           None)).value)
    return [vals, [c for _, c in remote.commands]]


def test_clock_nemeses_match_the_jax_package(monkeypatch):
    got = clock_commands(cr, cr.nt, Op, monkeypatch)
    assert got == clock_commands(jcr, jcr.nt, JOp, monkeypatch)
    vals, cmds = got
    assert vals == [{"n1": 0.25, "n2": 0.25}, "clocks-reset", "strobed"]
    assert sum("bump-time" in c for c in cmds) == 2
    assert sum("strobe-time" in c for c in cmds) == 2


def test_clock_tools_of_the_test_map_replace_the_native_ones():
    calls = []
    test = {"remote": DummyRemote(), "nodes": NODES,
            "clock_tools": crdb_sim.RecordingClockTools(calls)}
    b = cr.BumpTime(0.1).setup(test)
    b.invoke(test, Op("nemesis", "info", "start", None))
    cr.StrobeTime(200, 10, 5).invoke(test, Op("nemesis", "info", "start",
                                              None))
    b.teardown(test)
    assert test["remote"].commands == []
    assert [c for _, c, _ in calls].count("install") == 2
    assert ("n1", "strobe_time", (200, 10, 5)) in calls


# ---------------------------------------------------------------------------
# the split nemesis and keyrange (TestSplitNemesis)

def test_update_keyrange():
    for mod in (jcr, cr):
        t = {"keyrange": {"lock": threading.Lock(), "keys": {}}}
        mod.update_keyrange(t, "test", 3)
        mod.update_keyrange(t, "test", 3)
        mod.update_keyrange(t, "accounts", 1)
        assert t["keyrange"]["keys"] == {"test": {3}, "accounts": {1}}
        mod.update_keyrange({}, "test", 9)


def test_split_nemesis_without_keys():
    for mod, op_cls in ((jcr, JOp), (cr, Op)):
        s = mod.SplitNemesis()
        op = op_cls("nemesis", "info", "split", None)
        assert s.invoke({}, op).value == "no-keyrange"
        t = {"keyrange": {"lock": threading.Lock(), "keys": {}},
             "nodes": NODES}
        assert s.invoke(t, op).value == "nothing-to-split"


# ---------------------------------------------------------------------------
# the host checkers (TestMonotonicChecker, TestSequentialChecker,
# TestCommentsChecker)

def read_ops(rows, f="read", value=None):
    return [Op(0, "invoke", f, value, index=0, time=0),
            Op(0, "ok", f, rows, index=1, time=1)]


def comments(read_sees):
    return [Op(0, "invoke", "write", (7, 1), index=0, time=0),
            Op(0, "ok", "write", (7, 1), index=1, time=1),
            Op(1, "invoke", "write", (7, 2), index=2, time=2),
            Op(1, "ok", "write", (7, 2), index=3, time=3),
            Op(2, "invoke", "read", (7, None), index=4, time=4),
            Op(2, "ok", "read", (7, read_sees), index=5, time=5)]


CHECKER_CASES = {
    "monotonic_ordered": ("MonotonicChecker", read_ops(
        [(1, "10.0", 0, 0), (2, "11.0", 1, 1), (3, "12.5", 0, 2)])),
    "monotonic_reorder": ("MonotonicChecker", read_ops(
        [(1, "10.0", 0, 0), (3, "11.0", 1, 1), (2, "12.0", 0, 2)])),
    "monotonic_duplicate": ("MonotonicChecker", read_ops(
        [(1, "10.0", 0, 0), (1, "11.0", 1, 1)])),
    "monotonic_never_read": ("MonotonicChecker", [
        Op(0, "invoke", "add", None, index=0)]),
    "sequential_full": ("SequentialChecker", read_ops(
        (1, ["1_2", "1_1", "1_0"]), value=1)),
    "sequential_prefixless": ("SequentialChecker", read_ops(
        (1, [None, "1_1", "1_0"]), value=1)),
    "sequential_gap": ("SequentialChecker", read_ops(
        (1, ["1_2", None, "1_0"]), value=1)),
    "comments_complete": ("CommentsChecker", comments([1, 2])),
    "comments_stale": ("CommentsChecker", comments([2])),
    "comments_neither": ("CommentsChecker", comments([])),
}


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_host_checkers_match(case):
    name, hist = CHECKER_CASES[case]
    got = getattr(crw, name)().check({}, hist, {})
    assert normalise(got) == normalise(
        getattr(jcrw, name)().check({}, to_jax(hist), {}))
    assert got["valid"] is (case.split("_", 1)[1] in (
        "ordered", "full", "prefixless", "complete", "neither")) or (
        case == "monotonic_never_read" and got["valid"] == "unknown")


# ---------------------------------------------------------------------------
# the CLI surface (TestCli)

def test_workload_registry_and_cli():
    assert sorted(crw.workloads()) == sorted(jcrw.workloads())
    rc = cli.run_cli(cli.single_test_cmd(crw.cockroach_test,
                                         opt_spec=crw._opt_spec),
                     ["test", "--time-limit", "1"])
    assert rc == 254
    t = crw.cockroach_test({"workload": "bank", "nodes": ["a"],
                            "nemesis": "parts", "time_limit": 5})
    assert t["name"] == "cockroachdb bank parts"
    assert isinstance(t["client"], crw.BankClient)
    assert t["accounts"] == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# the DB lifecycle and full runs on simulated nodes (TestDBLifecycle,
# TestFullRuns, TestNewWorkloadRuns, TestSplitNemesis's runs)

def test_setup_teardown_cycle(tmp_path):
    c = crdb_sim.local_cluster(str(tmp_path), NODES)
    database = cr.CockroachDB(tarball=c["tarball"])
    test = {"remote": c["remote"], "nodes": NODES,
            "cockroach": c["cockroach"]}
    try:
        for n in NODES:
            database.setup(test, n)
        c1, c2 = (pg_proto.PgConn("127.0.0.1", c["ports"][n], timeout=5.0,
                                  connect_timeout=5.0) for n in NODES)
        c1.query("create table x (id int)")
        c1.query("insert into x values (7)")
        assert c2.query("select id from x").scalars() == ["7"]
        c1.close()
        c2.close()
        for n in NODES:
            (path,) = database.log_files(test, n)
            assert os.path.exists(path)
    finally:
        for n in NODES:
            database.teardown(test, n)
    assert not glob.glob(str(tmp_path / "nodes" / "*" / "opt" / "crdb"))


def engine_test(tmp_path, workload, time_limit=4, **extra) -> dict:
    """The JAX package's _engine_test on the port's recipe cluster,
    device="cpu"."""
    c = crdb_sim.local_cluster(str(tmp_path), NODES)
    opts = {"workload": workload, "nodes": NODES, "remote": c["remote"],
            "cockroach": c["cockroach"], "tarball": c["tarball"],
            "concurrency": 4, "time_limit": time_limit, "quiesce": 0.2,
            "nemesis": "none", "device": "cpu", **extra}
    t = crw.cockroach_test(opts)
    t["os"] = None
    t["net"] = None
    return t


def jax_part(workload, test, hist):
    """The JAX package's checker of `workload`'s own part (the one the
    port's results hold under the same name) on the history."""
    if workload == "register":
        from jepsen_tpu import models as jmodels

        return "details", jind.checker(jchecker.compose({
            "linearizable": jchecker.linearizable()})).check(
                {**test, "model": jmodels.CASRegister()}, hist, {})
    checkers = {"bank": ("bank", jbank.checker()),
                "sets": ("set", jchecker.set_checker()),
                "monotonic": ("monotonic", jcrw.MonotonicChecker()),
                "sequential": ("sequential", jcrw.SequentialChecker()),
                "comments": ("comments", jcrw.CommentsChecker()),
                "g2": ("g2", jadya.g2_checker())}
    part, chk = checkers[workload]
    return part, chk.check(test, hist, {})


RUNS = {
    "register": dict(ops_per_key=20, threads_per_key=2),
    "bank": {},
    "sets": {},
    "monotonic": {},
    "g2": {},
    "sequential": dict(key_count=3, tables=3),
    "comments": dict(keys=2),
}


@pytest.mark.parametrize("workload", sorted(RUNS))
def test_full_run_matches_the_jax_checker(tmp_path, workload):
    t = engine_test(tmp_path, workload, **RUNS[workload])
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert sum(o.type == "ok" for o in hist) > 10
    part, want = jax_part(workload, {k: t[k] for k in (
        "accounts", "total_amount", "max_transfer") if k in t},
        to_jax(hist))
    got = res[part]
    if workload == "register":
        # the port's keys hold the timeline too (valid True); the JAX
        # checker here checks linearizability alone
        got = {**got, "results": {
            k: {"linearizable": r["linearizable"], "valid": r["valid"]}
            for k, r in got["results"].items()}}
    assert normalise(got) == normalise(want)
    if workload == "bank":
        reads = [o for o in hist if o.type == "ok" and o.f == "read"]
        assert reads and all(sum(r.value.values()) == 50 for r in reads)


def test_full_run_register_with_splits(tmp_path):
    t = engine_test(tmp_path, "register", time_limit=6, ops_per_key=20,
                    threads_per_key=2, nemesis="split")
    result = core.run(t)
    assert result["results"]["valid"] is True, result["results"]
    assert [o for o in result["history"] if o.process == "nemesis"
            and o.type == "info" and isinstance(o.value, list)
            and o.value and o.value[0] == "split"]


# ---------------------------------------------------------------------------
# the recipe: the CLI on simulated nodes

def recipe_run(tmp_path, monkeypatch, *extra, suite=None):
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = crdb_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(crdb_sim.local_test_fn(
            c, suite_opts={"threads_per_key": 2, "ops_per_key": 20,
                           "quiesce": 0.2, **(suite or {})}),
            opt_spec=crw._opt_spec),
        ["test", *extra, "--node", "n1", "--node", "n2", "--concurrency",
         "4", "--time-limit", "3", "--store-dir", sd, "--device", "cpu"])
    run_dirs = glob.glob(os.path.join(sd, "*", "latest"))
    return rc, c, [os.path.realpath(d) for d in run_dirs]


def live_processes(marker: str) -> list:
    """Pids of this machine's processes whose command line holds
    `marker`."""
    pids = []
    for d in glob.glob("/proc/[0-9]*/cmdline"):
        try:
            with open(d, "rb") as f:
                if marker.encode() in f.read():
                    pids.append(int(d.split("/")[2]))
        except OSError:
            pass
    return pids


def test_recipe_runs_skews_recorded_and_members_load_no_jax(
        tmp_path, monkeypatch):
    rc, c, (run_dir,) = recipe_run(
        tmp_path, monkeypatch, "--workload", "register", "--nemesis",
        "small-skews")
    assert rc == 0
    # Restarting restarted every live node; teardown leaves none behind
    assert live_processes(str(tmp_path / "cluster" / "nodes")) == []
    calls = [f for _, f, _ in c["clock_calls"]]
    assert calls.count("install") == len(NODES) and "reset_time" in calls
    logs = glob.glob(os.path.join(run_dir, "n*", "*cockroach.log"))
    assert len(logs) == len(NODES)
    for p in logs:
        mods = {ln.rsplit("|", 1)[1].strip() for ln in open(p)
                if ln.startswith("import time:") and "|" in ln}
        assert "jepsen_tpu_torch.dbs.pg_proto" in mods, p
        bad = {m for m in mods
               if m.split(".")[0] in ("jax", "jepsen_tpu", "torch")}
        assert not bad, (p, sorted(bad))


def test_recipe_refuses_fs_break(tmp_path, monkeypatch):
    rc, _, run_dirs = recipe_run(tmp_path, monkeypatch, "--workload", "g2",
                                 "--nemesis", "none", "--nemesis2",
                                 "fs-break")
    assert rc == 254 and run_dirs == []
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
