"""The port's rethinkdb suite (dbs/rethink_proto.py, rethink_sim.py,
rethinkdb.py) against the JAX package's, on the cases of
tests/test_mongo_rethink_chronos.py::TestRethink: ReQL terms built from
seeded values serialise to the same JSON bytes; the same handshake and
query frames against both packages' simulators give the same reply
bytes; the document-CAS client's taxonomy (each read mode), the
reconfigure term and `ReconfigureNemesis`, and the test maps (the
reconfigure workload's read-mode refusal too) are the same; the cas and
reconfigure workloads run end to end on the port's recipe through the CLI
with device="cpu" (and a reconfigure run whose feed is shortened so its
reconfigure ops reach the simulators), and the stored keyed history,
given to the JAX package's per-key checker, gives the port's dict. Also fs-break refused and member processes that load
neither torch nor jax."""

from __future__ import annotations

import glob
import itertools
import json
import os
import random
import socket
import struct

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import rethink_proto as jrp
from jepsen_tpu.dbs import rethink_sim as jsim
from jepsen_tpu.dbs import rethinkdb as jrethink
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, independent
from jepsen_tpu_torch import nemesis, store
from jepsen_tpu_torch.dbs import rethink_proto as rp
from jepsen_tpu_torch.dbs import rethink_sim, rethinkdb
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy, serve
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


# ---------------------------------------------------------------------------
# ReQL terms, byte for byte

def terms(P, seed: int) -> bytes:
    """Every term the suite builds, from seeded values, as the query
    frame's JSON."""
    rng = random.Random(seed)
    key = rng.choice([rng.randrange(1 << 40), "k" + str(rng.random())])
    vals = [rng.choice([None, rng.randrange(-9, 9), [1, (2, "x")],
                        {"a": [rng.random()]}]) for _ in range(3)]
    tbl = P.table(P.db("jepsen"), "cas",
                  read_mode=rng.choice([None, "single", "majority",
                                        "outdated"]))
    row = P.get(tbl, key)
    replicas = {f"n{i}": 1 for i in range(1, 2 + rng.randrange(4))}
    out = [
        P.db_create("jepsen"),
        P.table_create(P.db("jepsen"), "cas",
                       replicas=rng.choice([None, 3, 5])),
        P.default(P.get_field(row, "val"), None),
        P.insert(tbl, {"id": key, "val": vals[0]},
                 conflict=rng.choice([None, "update", "error"])),
        P.update(row, P.func(1, P.branch(
            P.eq(P.get_field(P.var(1), "val"), vals[1]),
            {"val": vals[2]}, P.error("abort")))),
        P.update(row, {"val": vals[1]}),
        P.reconfigure(P.table(P.db("jepsen"), "cas"), shards=1,
                      replicas=replicas,
                      primary_replica_tag=rng.choice(list(replicas))),
        P.datum(vals),
    ]
    return json.dumps([P.START, out, {}]).encode()


@pytest.mark.parametrize("seed", range(8))
def test_reql_terms_byte_equal(seed):
    assert terms(rp, seed) == terms(jrp, seed)


def test_reql_constants_match():
    for name in ("V0_4", "PROTOCOL_JSON", "START", "SUCCESS_ATOM",
                 "SUCCESS_SEQUENCE", "CLIENT_ERROR", "COMPILE_ERROR",
                 "RUNTIME_ERROR", "MAKE_ARRAY", "VAR", "ERROR", "DB",
                 "TABLE", "GET", "EQ", "GET_FIELD", "UPDATE", "INSERT",
                 "DB_CREATE", "TABLE_CREATE", "BRANCH", "FUNC", "DEFAULT",
                 "RECONFIGURE"):
        assert getattr(rp, name) == getattr(jrp, name), name


# ---------------------------------------------------------------------------
# the simulators reply alike

@pytest.fixture
def sims(tmp_path):
    """(suite module, proto module, port) of the JAX package's ReQL
    simulator and the port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(rethink_sim, str(tmp_path / "port.json"))]
    yield [(jrethink, jrp, srvs[0].server_address[1]),
           (rethinkdb, rp, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def queries(P) -> list:
    tbl = P.table(P.db("jepsen"), "cas")
    row = P.get(tbl, 7)

    def cas(old, new):
        return P.update(row, P.func(1, P.branch(
            P.eq(P.get_field(P.var(1), "val"), old), {"val": new},
            P.error("abort"))))

    return [
        [P.START, P.db_create("jepsen"), {}],
        [P.START, P.db_create("jepsen"), {}],
        [P.START, P.table_create(P.db("jepsen"), "cas", replicas=2), {}],
        [P.START, P.default(P.get_field(row, "val"), None), {}],
        [P.START, P.get_field(row, "val"), {}],
        [P.START, P.insert(tbl, {"id": 7, "val": 2}, conflict="update"), {}],
        [P.START, P.insert(tbl, {"id": 7, "val": 3}), {}],
        [P.START, cas(2, 3), {}],
        [P.START, cas(2, 9), {}],
        [P.START, P.update(row, {"val": 3}), {}],
        [P.START, P.default(P.get_field(row, "val"), None), {}],
        [P.START, P.update(tbl, {"seen": True}), {}],
        [P.START, P.reconfigure(tbl, 1, {"n1": 1}, "n1"), {}],
        [P.START, P.reconfigure(tbl, 1, {"n1": 1}, "nope"), {}],
        [P.START, P.table(P.db("jepsen"), "ghost"), {}],
        [P.START, [999, []], {}],
        [2, P.db("jepsen"), {}],
    ]


def raw_replies(P, port, qs) -> list:
    """The handshake's greeting, then each query as a frame (tokens 1, 2,
    ...) and its raw reply frame."""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(struct.pack("<I", P.V0_4) + struct.pack("<I", 3) + b"key"
                  + struct.pack("<I", P.PROTOCOL_JSON))
        out = [s.recv(8, socket.MSG_WAITALL)]
        for i, q in enumerate(qs, 1):
            body = json.dumps(q).encode()
            s.sendall(struct.pack("<q", i) + struct.pack("<I", len(body))
                      + body)
            head = s.recv(12, socket.MSG_WAITALL)
            out.append(head + s.recv(struct.unpack("<I", head[8:])[0],
                                     socket.MSG_WAITALL))
    return out


def test_simulators_reply_alike_byte_for_byte(sims):
    (_, jp, jport), (_, tp, tport) = sims
    assert queries(tp) == queries(jp)
    got = raw_replies(tp, tport, queries(tp))
    assert got == raw_replies(jp, jport, queries(jp))
    assert got[0] == b"SUCCESS\x00"
    replies = [json.loads(r[12:]) for r in got[1:]]
    assert [r["t"] for r in replies] == [1, 18, 1, 1, 18, 1, 1, 1, 1, 1, 1,
                                         1, 1, 18, 18, 17, 16]
    assert replies[7]["r"][0]["replaced"] == 1
    assert replies[8]["r"][0] == {"replaced": 0, "errors": 1,
                                  "unchanged": 0, "skipped": 0,
                                  "first_error": "abort"}
    assert replies[10]["r"] == [3] and "server tag" in replies[13]["r"][0]


def test_bad_magic_refused(sims):
    for _, _, port in sims:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(struct.pack("<I", 7))
            assert s.recv(64) == b"ERROR: bad magic\x00"


# ---------------------------------------------------------------------------
# the client and the reconfigure nemesis

def cfg(port, nodes=("n1",)) -> dict:
    return {"rethinkdb": {"addr_fn": lambda n: "127.0.0.1",
                          "ports": {n: port for n in nodes}},
            "nodes": list(nodes)}


def document_cas(mod, ind, op_cls, port, read_mode) -> list:
    t = cfg(port)
    c = mod.DocumentCasClient(read_mode=read_mode).open(t, "n1")
    k = 7
    out = [(r.type, r.value, r.error) for r in (
        c.invoke(t, op_cls(0, "invoke", f, ind.tuple_(k, v))) for f, v in (
            ("read", None), ("write", 2), ("cas", (2, 3)), ("cas", (2, 9)),
            ("read", None), ("cas", (3, 3)), ("read", None)))]
    c.close(t)
    return out


@pytest.mark.parametrize("read_mode", ["majority", "single", "outdated"])
def test_document_cas_client(sims, read_mode):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = document_cas(tmod, independent, Op, tport, read_mode)
    assert [(a, (v.key, v.value), e) for a, v, e in got] == [
        (a, (v.key, v.value), e) for a, v, e in document_cas(
            jmod, jind, JOp, jport, read_mode)]
    assert [(a, tuple(v)) for a, v, _ in got] == [
        ("ok", (7, None)), ("ok", (7, 2)), ("ok", (7, (2, 3))),
        ("fail", (7, (2, 9))), ("ok", (7, 3)), ("fail", (7, (3, 3))),
        ("ok", (7, 3))]


def test_reconfigure_term_and_nemesis(sims):
    """The reconfigure term through each simulator, a bad primary tag the
    retriable server-tag error, and ReconfigureNemesis applying a random
    topology (rethinkdb.clj:180-231), seeded alike in both packages."""
    out = []
    for mod, P, port in sims:
        c = P.ReqlConn("127.0.0.1", port)
        c.run(P.db_create(mod.DB_NAME))
        c.run(P.table_create(P.db(mod.DB_NAME), mod.TBL))
        tbl = P.table(P.db(mod.DB_NAME), mod.TBL)
        got = [c.run(P.reconfigure(tbl, shards=1, replicas={"n1": 1},
                                   primary_replica_tag="n1"))]
        with pytest.raises(P.ReqlError, match="server tag"):
            c.run(P.reconfigure(tbl, shards=1, replicas={"n1": 1},
                                primary_replica_tag="nope"))
        c.close()
        t = cfg(port, ("n1", "n2", "n3"))
        nem = mod.ReconfigureNemesis().setup(t)
        op_cls = Op if mod is rethinkdb else JOp
        random.seed(11)
        for _ in range(3):
            done = nem.invoke(t, op_cls("nemesis", "info", "reconfigure",
                                        None))
            assert done.value["primary"] in done.value["replicas"]
            got.append(done.value)
        out.append(got)
    assert out[0] == out[1] and out[1][0] == {"reconfigured": 1}


def test_reconfigure_nemesis_gives_up_on_a_dead_cluster():
    from jepsen_tpu_torch.dbs.simbase import free_port

    t = cfg(free_port(), ("n1", "n2"))
    done = rethinkdb.ReconfigureNemesis().invoke(
        t, Op("nemesis", "info", "reconfigure", None))
    assert done.value.startswith("reconfigure-failed")


def test_reconfigure_start_stop_feed():
    for mod in (rethinkdb, jrethink):
        g = mod.reconfigure_start_stop(0.001, 0.001)
        fs = []
        while len(fs) < 6:
            o = g.op({"nodes": NODES}, "nemesis")
            if isinstance(o, dict) and o.get("f"):
                fs.append(o["f"])
        assert fs == ["start", "reconfigure", "stop", "reconfigure",
                      "start", "reconfigure"]


# ---------------------------------------------------------------------------
# the test maps

@pytest.mark.parametrize("opts", [
    {}, {"read_mode": "single"}, {"workload": "reconfigure"},
    {"workload": "reconfigure", "read_mode": "majority"},
    {"nemesis": "start-kill"}, {"nemesis": "none"}])
def test_rethinkdb_test_maps_match(opts):
    base = {"nodes": NODES, "time_limit": 5, **opts}
    t = rethinkdb.rethinkdb_test(dict(base))
    j = jrethink.rethinkdb_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    assert t["client"].read_mode == j["client"].read_mode
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert sorted(t["checker"].checker_map) == ["indep", "perf"]
    for n in NODES:
        assert t["db"].daemon_args(t, n) == j["db"].daemon_args(j, n)


@pytest.mark.parametrize("mode", ["single", "outdated"])
def test_reconfigure_refuses_other_read_modes(mode):
    for mod in (rethinkdb, jrethink):
        with pytest.raises(ValueError, match="pins --read-mode majority"):
            mod.rethinkdb_test({"nodes": NODES, "workload": "reconfigure",
                                "read_mode": mode})


def test_op_generators_match():
    for fn in ("r", "w", "cas"):
        random.seed(3)
        got = [getattr(rethinkdb, fn)({}, 0) for _ in range(10)]
        random.seed(3)
        assert got == [getattr(jrethink, fn)({}, 0) for _ in range(10)]


# ---------------------------------------------------------------------------
# full runs (TestRethink) and the recipe

def jax_indep():
    return jind.checker(jchecker.compose({
        "timeline": jchecker.timeline_html(),
        "linear": jchecker.linearizable()}))


def test_full_run_reconfigure_keeps_the_reconfigure_slot(tmp_path):
    """TestRethink.test_full_run_reconfigure on the port's recipe
    cluster: topology changes mid-run with the partition slot a no-op,
    every key linearizable, the per-key dict the JAX package's."""
    c = rethink_sim.local_cluster(str(tmp_path), NODES)
    t = rethinkdb.rethinkdb_test({
        "nodes": NODES, "remote": c["remote"], "workload": "reconfigure",
        "archive_url": c["archive_url"], "rethinkdb": c["rethinkdb"],
        "concurrency": 4, "time_limit": 5, "device": "cpu"})
    assert t["name"] == "rethinkdb document reconfigure"
    t.update({"os": None, "net": None, "nemesis": nemesis.compose({
        frozenset({"reconfigure"}): rethinkdb.ReconfigureNemesis(),
        frozenset({"start", "stop"}): nemesis.noop})})
    t["generator"] = gen.time_limit(5, gen.nemesis(
        rethinkdb.reconfigure_start_stop(0.5, 0.5),
        independent.concurrent_generator(
            2, itertools.count(),
            lambda k: gen.limit(20, gen.stagger(0.01, gen.mix(
                [rethinkdb.r, rethinkdb.w, rethinkdb.cas]))))))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert [o for o in hist if o.f == "reconfigure"
            and isinstance(o.value, dict)], "no reconfigure ever applied"
    want = jax_indep().check({"model": jmodels.CASRegister()},
                             to_jax(hist), {})
    assert normalise(res["indep"]) == normalise(want)


@pytest.mark.parametrize("workload", ["cas", "reconfigure"])
def test_recipe_workload_matches_the_jax_checker(tmp_path, monkeypatch,
                                                  workload):
    """Each workload at its defaults through the recipe (50 ops a key at
    2 threads a key; the nemesis feed's first sleep holds the workers
    10 s): exit 0, every key True, the stored history's per-key dict the
    JAX package's (reconfigure: writes and cas only); members load
    neither torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = rethink_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(rethink_sim.local_test_fn(c),
                            opt_spec=rethinkdb._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "4",
         "--time-limit", "3", "--workload", workload, "--store-dir", sd,
         "--device", "cpu"])
    assert rc == 0
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, "*", "latest"))]
    name = os.path.basename(os.path.dirname(run_dir))
    assert name == ("rethinkdb document reconfigure"
                    if workload == "reconfigure" else "rethinkdb document-cas")
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    hist = store.load_history({"name": name,
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    keys = res["indep"]["results"]
    assert res["indep"]["valid"] is True and keys
    assert all(r["linear"]["valid"] is True for r in keys.values())
    want = jax_indep().check({"model": jmodels.CASRegister()},
                             to_jax(hist), {})
    assert res["indep"] == normalise(want)
    if workload == "reconfigure":
        assert {o.f for o in hist if o.type == "ok"} <= {"write", "cas"}
    logs = glob.glob(os.path.join(run_dir, "n*", "*rethinkdb.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.rethink_proto" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_refuses_fs_break(tmp_path):
    c = rethink_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(rethink_sim.local_test_fn(c),
                            opt_spec=rethinkdb._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
