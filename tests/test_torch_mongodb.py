"""The port's mongodb suites (dbs/bson.py, mongo_proto.py, mongo_sim.py,
mongodb.py) against the JAX package's, on the cases of
tests/test_mongo_rethink_chronos.py::TestBson and ::TestMongo: seeded
documents encode to the same BSON bytes (type tags, the int32/int64/double
choice, key order) and decode alike; the same OP_MSG frames against both
packages' simulators give the same reply bytes; the clients' taxonomies
and the test maps are the same; each workload (document-cas, transfer,
logger-perf) runs end to end on the port's recipe through the CLI with
device="cpu", and its stored history, given to the JAX package's checker,
gives the port's results dict. Also fs-break refused, composed packages'
clock faults recorded, and member processes that load neither torch nor
jax."""

from __future__ import annotations

import glob
import json
import math
import os
import random
import socket
import struct

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import bson as jbson
from jepsen_tpu.dbs import mongo_proto as jproto
from jepsen_tpu.dbs import mongo_sim as jsim
from jepsen_tpu.dbs import mongodb as jmongo
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, osdist, store
from jepsen_tpu_torch.dbs import bson, mongo_proto, mongo_sim, mongodb
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy, serve
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


# ---------------------------------------------------------------------------
# BSON (TestBson)

EDGES = [0, 1, -1, (1 << 31) - 1, -(1 << 31), 1 << 31, -(1 << 31) - 1,
         (1 << 63) - 1, -(1 << 63), 1 << 40]


def value(rng, depth: int):
    kind = rng.randrange(9 if depth < 3 else 6)
    if kind == 0:
        return rng.choice(EDGES)
    if kind == 1:
        return rng.randrange(-(1 << 63), 1 << 63)
    if kind == 2:
        return rng.choice([0.0, -0.0, 2.5, 1e300, -1e-300, math.inf,
                           rng.uniform(-1e6, 1e6)])
    if kind == 3:
        return "".join(rng.choice("ab é漢\t") for _ in range(rng.randrange(8)))
    if kind == 4:
        return rng.choice([None, True, False])
    if kind == 5:
        return rng.randrange(-(1 << 31), 1 << 31)
    if kind == 6:
        return document(rng, depth + 1)
    if kind == 7:
        return [value(rng, depth + 1) for _ in range(rng.randrange(5))]
    return tuple(value(rng, depth + 1) for _ in range(rng.randrange(4)))


def document(rng, depth: int = 0) -> dict:
    keys = ["".join(rng.choice("xyz_$.1é") for _ in range(rng.randrange(
        1, 6))) for _ in range(rng.randrange(7))]
    return {k: value(rng, depth) for k in keys}


@pytest.mark.parametrize("seed", range(12))
def test_bson_byte_equal(seed):
    doc = document(random.Random(seed))
    got = bson.encode(doc)
    assert got == jbson.encode(doc)
    out, end = bson.decode(got)
    assert (out, end) == jbson.decode(got) and end == len(got)
    assert list(out) == list(doc)
    framed = b"\x07" * 3 + got + b"\x09"
    assert bson.decode(framed, 3) == jbson.decode(framed, 3)


def test_bson_roundtrip_and_tags():
    doc = {"a": 1, "b": "hi", "c": None, "d": True, "e": 2.5,
           "f": {"g": [1, "x", None]}, "big": 1 << 40}
    assert bson.decode(bson.encode(doc)) == jbson.decode(jbson.encode(doc))
    assert bson.decode(bson.encode(doc))[0] == doc
    tags = {k: bson.encode({k: v})[4] for k, v in (
        ("i", (1 << 31) - 1), ("l", 1 << 31), ("t", True), ("d", 1.0),
        ("s", ""), ("n", None), ("o", {}), ("a", ()))}
    assert tags == {"i": 0x10, "l": 0x12, "t": 0x08, "d": 0x01, "s": 0x02,
                    "n": 0x0A, "o": 0x03, "a": 0x04}
    for mod in (bson, jbson):
        with pytest.raises(TypeError):
            mod.encode({"x": object()})
        with pytest.raises(ValueError, match="0x07"):
            mod.decode(b"\x0d\x00\x00\x00\x07k\x00" + b"\x00" * 6)


# ---------------------------------------------------------------------------
# the simulators reply alike

@pytest.fixture
def sims(tmp_path):
    """(suite module, proto module, port) of the JAX package's OP_MSG
    simulator and the port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(mongo_sim, str(tmp_path / "port.json"))]
    yield [(jmongo, jproto, srvs[0].server_address[1]),
           (mongodb, mongo_proto, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


COMMANDS = [
    {"ping": 1, "$db": "admin"},
    {"hello": 1, "$db": "admin"},
    {"replSetInitiate": {"_id": "jepsen", "members": [
        {"_id": 0, "host": "h:1"}]}, "$db": "admin"},
    {"insert": "c", "documents": [{"_id": 1, "value": 5}],
     "writeConcern": {"w": "majority"}, "$db": "db"},
    {"insert": "c", "documents": [{"_id": 1, "value": 6}], "$db": "db"},
    {"find": "c", "filter": {"_id": 1}, "limit": 1, "$db": "db"},
    {"find": "c", "filter": {"_id": 9}, "$db": "db"},
    {"update": "c", "updates": [{"q": {"_id": 1, "value": 5},
                                 "u": {"_id": 1, "value": 6},
                                 "upsert": False}], "$db": "db"},
    {"update": "c", "updates": [{"q": {"_id": 1, "value": 5},
                                 "u": {"_id": 1, "value": 7},
                                 "upsert": False}], "$db": "db"},
    {"update": "c", "updates": [{"q": {"_id": 2}, "u": {"value": 0},
                                 "upsert": True}], "$db": "db"},
    {"insert": "logger", "documents": [
        {"_id": "a", "time": 3}, {"_id": "b", "time": 1}, {"_id": "c"}],
     "$db": "db"},
    {"findAndModify": "logger", "query": {}, "sort": {"time": 1},
     "remove": True, "$db": "db"},
    {"findAndModify": "logger", "query": {}, "sort": {"time": -1},
     "remove": True, "$db": "db"},
    {"findAndModify": "logger", "query": {}, "remove": False, "$db": "db"},
    {"find": "logger", "filter": {}, "$db": "db"},
    {"fly": 1, "$db": "db"},
]


def raw_replies(bson_mod, port, commands) -> list:
    """Each command as an OP_MSG frame (request ids 1, 2, ...); each raw
    reply frame."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for i, cmd in enumerate(commands, 1):
            payload = b"\x00\x00\x00\x00\x00" + bson_mod.encode(cmd)
            s.sendall(struct.pack("<iiii", 16 + len(payload), i, 0, 2013)
                      + payload)
            (n,) = struct.unpack("<i", s.recv(4, socket.MSG_WAITALL))
            out.append(s.recv(n - 4, socket.MSG_WAITALL))
    return out


def test_simulators_reply_alike_byte_for_byte(sims):
    (_, _, jport), (_, _, tport) = sims
    got = raw_replies(bson, tport, COMMANDS)
    assert got == raw_replies(jbson, jport, COMMANDS)
    docs = [bson.decode(r, 17)[0] for r in got]
    assert [d["ok"] for d in docs] == [1] * 13 + [0, 1, 0]
    assert docs[4]["writeErrors"][0]["code"] == 11000
    assert docs[7]["n"] == 1 and docs[8]["n"] == 0 and docs[9]["n"] == 1
    assert docs[11]["value"]["_id"] == "b" and docs[12]["value"]["_id"] == "a"
    assert docs[14]["cursor"]["firstBatch"] == [{"_id": "c"}]
    assert docs[15]["code"] == 59


def conn_calls(P, port) -> list:
    """TestMongo.test_commands through each package's MongoConn."""
    c = P.MongoConn("127.0.0.1", port)
    out = [c.command("admin", {"ping": 1}),
           c.insert("db", "c", [{"_id": 1, "value": 5}]),
           c.find_one("db", "c", {"_id": 1}), c.find_one("db", "c",
                                                         {"_id": 9}),
           c.update("db", "c", {"_id": 1, "value": 5},
                    {"_id": 1, "value": 6}),
           c.update("db", "c", {"_id": 1, "value": 5},
                    {"_id": 1, "value": 7}),
           c.update("db", "c", {"_id": 2}, {"_id": 2, "value": 0},
                    upsert=True),
           c.find_all("db", "c")]
    try:
        c.command("db", {"fly": 1})
    except P.MongoError as e:
        out.append(["error", str(e), e.code])
    c.close()
    return out


def test_mongo_conn_calls_match(sims):
    (_, jp, jport), (_, tp, tport) = sims
    got = conn_calls(tp, tport)
    assert got == conn_calls(jp, jport)
    assert got[1]["n"] == 1 and got[2]["value"] == 5 and got[3] is None
    assert [got[i]["n"] for i in (4, 5, 6)] == [1, 0, 1]
    assert got[-1] == ["error", "no such command: 'fly'", 59]


# ---------------------------------------------------------------------------
# the clients (TestMongo)

def cfg(port) -> dict:
    return {"mongodb": {"addr_fn": lambda n: "127.0.0.1",
                        "ports": {"n1": port}}}


def document_cas(mod, op_cls, port) -> list:
    t = cfg(port)
    c = mod.DocumentCasClient().open(t, "n1")
    out = [(r.type, r.value) for r in (
        c.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("read", None), ("write", 3), ("cas", (3, 4)), ("cas", (3, 9)),
            ("read", None)))]
    with pytest.raises(ValueError):
        c._invoke(op_cls(0, "invoke", "frob", None))
    c.close(t)
    return out


def test_document_cas_client(sims):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = document_cas(tmod, Op, tport)
    assert got == document_cas(jmod, JOp, jport)
    assert got == [("ok", None), ("ok", 3), ("ok", (3, 4)), ("fail", (3, 9)),
                   ("ok", 4)]


def transfer(mod, op_cls, port) -> list:
    t = cfg(port)
    c = mod.TransferClient(n=3).open(t, "n1")
    out = [(r.type, r.value, r.error) for r in (
        c.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("transfer", {"from": 0, "to": 1, "amount": 4}),
            ("read", None),
            ("transfer", {"from": 0, "to": 2, "amount": 7}),
            ("transfer", {"from": 0, "to": 5, "amount": 1}),
            ("read", None)))]
    c.close(t)
    return out


def test_transfer_client_conserves_money(sims):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = transfer(tmod, Op, tport)
    assert got == transfer(jmod, JOp, jport)
    assert got[0][0] == "ok" and got[1][1] == {0: 6, 1: 14, 2: 10}
    assert got[2][2] == "insufficient" and got[3][2] == "missing-account"
    assert sum(got[4][1].values()) == 30


def logger(mod, op_cls, port) -> list:
    t = cfg(port)
    c = mod.LoggerClient().open(t, "n1")
    out = [c.invoke(t, op_cls(0, "invoke", "delete", None)).type]
    for i in range(3):
        out.append(c.invoke(t, op_cls(0, "invoke", "write", f"id-{i}")).type)
    dup = c.invoke(t, op_cls(0, "invoke", "write", "id-1"))
    out.append((dup.type, dup.error))
    for _ in range(4):
        d = c.invoke(t, op_cls(0, "invoke", "delete", None))
        out.append((d.type, d.value))
    c.close(t)
    return out


def test_logger_client(sims):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = logger(tmod, Op, tport)
    assert got == logger(jmod, JOp, jport)
    assert got[:4] == ["fail", "ok", "ok", "ok"] and got[4][0] == "fail"
    assert got[5:] == [("ok", "id-0"), ("ok", "id-1"), ("ok", "id-2"),
                       ("fail", None)]
    assert "-oempa_" in mongodb.logger_write({}, 0)["value"]


@pytest.mark.parametrize("mod", ["port", "jax"])
def test_clients_on_a_dead_node(mod):
    m, cls = (mongodb, Op) if mod == "port" else (jmongo, JOp)
    t = cfg(free_port())
    with pytest.raises(OSError):
        m.DocumentCasClient().open(t, "n1")
    c = m.DocumentCasClient(conn=m.mongo_proto.MongoConn.__new__(
        m.mongo_proto.MongoConn))
    c.conn.sock = socket.socket()
    c.conn.sock.close()
    assert c.invoke(t, cls(0, "invoke", "read", None)).type == "fail"
    assert c.invoke(t, cls(0, "invoke", "write", 1)).type == "info"
    assert c.invoke(t, cls(0, "invoke", "cas", (1, 2))).type == "info"


def test_transfer_totals_checker_matches():
    hist = [Op(0, "ok", "read", {0: 5, 1: 5}, index=0),
            Op(1, "ok", "read", {0: 5, 1: 4}, index=1),
            Op(2, "fail", "read", {0: 1}, index=2)]
    got = mongodb.TransferTotalsChecker(10).check({}, hist)
    assert got == jmongo.TransferTotalsChecker(10).check({}, to_jax(hist))
    assert got["valid"] is False and got["bad_reads"][0]["index"] == 1


# ---------------------------------------------------------------------------
# the test maps

@pytest.mark.parametrize("opts", [
    {}, {"workload": "transfer"}, {"workload": "logger-perf"},
    {"no_read": True}, {"flavor": "smartos"}, {"nemesis": "start-kill"},
    {"nemesis": "kill,partition", "seed": 1}])
def test_mongodb_test_maps_match(opts):
    base = {"nodes": NODES, "time_limit": 5, **opts}
    t, j = mongodb.mongodb_test(dict(base)), jmongo.mongodb_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert sorted(t["checker"].checker_map) == sorted(j["checker"].checker_map)
    assert type(t["client"]).__name__ == type(j["client"]).__name__
    assert t["db"].daemon_args(t, "n1") == j["db"].daemon_args(j, "n1")
    flavor = opts.get("flavor", "rocks")
    assert t["name"].startswith(f"mongodb-{flavor}")
    assert (t["os"] is osdist.smartos) == (flavor == "smartos")


def test_flavor_entry_points():
    assert mongodb.mongodb_rocks_test({"nodes": NODES})["name"] == \
        jmongo.mongodb_rocks_test({"nodes": NODES})["name"]
    t = mongodb.mongodb_smartos_test({"nodes": NODES})
    assert t["name"] == "mongodb-smartos document-cas"
    assert "--storageEngine" not in t["db"].daemon_args(t, "n1")


@pytest.mark.parametrize("no_read", [False, True])
def test_document_cas_mix_matches(monkeypatch, no_read):
    """document-cas's op mix (`--no-read`: writes and cas only,
    document_cas.clj's no-read variant), as each package builds it."""
    got = []
    for mod in (mongodb, jmongo):
        mixes = []
        monkeypatch.setattr(mod.gen, "mix", lambda fs, mixes=mixes: (
            mixes.append([f.__name__ for f in fs]), fs)[1])
        monkeypatch.setattr(mod.gen, "stagger", lambda dt, g: (dt, g))
        got.append((mod.workloads({"no_read": no_read})["document-cas"][
            "during"][0], mixes[0]))
    assert got[0] == got[1] == (0.05, ["w", "cas", "cas"] if no_read
                                else ["r", "w", "cas", "cas"])


def test_op_generators_match():
    for fn in ("r", "w", "cas", "transfer_gen"):
        random.seed(3)
        got = [getattr(mongodb, fn)({}, 0) for _ in range(10)]
        random.seed(3)
        assert got == [getattr(jmongo, fn)({}, 0) for _ in range(10)]


# ---------------------------------------------------------------------------
# each workload on the recipe (TestMongo's full runs)

def jax_checker(workload):
    if workload == "document-cas":
        return jchecker.compose({"perf": jchecker.perf_checker(),
                                 "linear": jchecker.linearizable()})
    if workload == "transfer":
        return jchecker.compose({"perf": jchecker.perf_checker(),
                                 "totals": jmongo.TransferTotalsChecker(40)})
    return jchecker.compose({"perf": jchecker.perf_checker()})


@pytest.mark.parametrize("workload", ["document-cas", "transfer",
                                      "logger-perf"])
def test_recipe_workload_matches_the_jax_checker(tmp_path, monkeypatch,
                                                  workload):
    """Each workload at its defaults through the recipe (its nemesis on
    the no-op network holds the workers 10 s): exit 0 for the registers
    and the logger (transfer's reads see money in flight: the totals
    checker reports it, exit 1); the stored history, given to the JAX
    package's composed checker, gives the port's results; each member
    loads neither torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = mongo_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(mongo_sim.local_test_fn(c),
                            opt_spec=mongodb._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "4",
         "--time-limit", "3", "--workload", workload, "--store-dir", sd,
         "--device", "cpu"])
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, "*", "latest"))]
    assert os.path.basename(os.path.dirname(run_dir)) == \
        f"mongodb-rocks {workload}"
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    hist = store.load_history({
        "name": f"mongodb-rocks {workload}",
        "start_time": os.path.basename(run_dir), "store_dir": sd})
    want = jax_checker(workload).check(
        {"model": jmodels.CASRegister(), "store_dir": str(tmp_path / "j"),
         "name": "j", "start_time": "x"}, to_jax(hist), {})
    assert res == normalise(want)
    oks = [o for o in hist if o.type == "ok"]
    if workload == "transfer":
        assert rc == 1 and res["totals"]["valid"] is False
        assert {"read", "transfer"} <= {o.f for o in oks}
    else:
        assert rc == 0 and res["valid"] is True, res
        assert len(oks) > 10
    logs = glob.glob(os.path.join(run_dir, "n*", "*mongod.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.bson" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_refuses_fs_break(tmp_path):
    c = mongo_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(mongo_sim.local_test_fn(c),
                            opt_spec=mongodb._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break-1pct",
         "--time-limit", "3", "--store-dir", str(tmp_path / "store"),
         "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))


def test_recipe_records_clock_faults(tmp_path):
    """A composed package's clock family on the recipe goes to the
    recording setter (cluster["clock_sets"]), a caller's setter giving
    way: no run on the simulated nodes sets this machine's clock."""
    def must_not_run(test, node, t):
        raise AssertionError("a caller's clock setter ran")

    c = mongo_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    t = mongo_sim.local_test_fn(c)({"nodes": NODES, "nemesis": "clock",
                                    "seed": 1, "device": "cpu",
                                    "set_time_fn": must_not_run})
    assert set(t["fault_families"]) == {"clock"}
    clock = t["nemesis"].nemeses[frozenset({"scramble-clock",
                                            "reset-clock"})]
    next(iter(clock.nemeses.values())).set_time_fn(t, "n2", 2.0)
    assert c["clock_sets"] == [("n2", 2.0)]
    assert t["os"] is None and t["net"] is not None
