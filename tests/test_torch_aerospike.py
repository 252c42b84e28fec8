"""The port's aerospike suite (dbs/aerospike_proto.py, aerospike_sim.py,
aerospike.py) against the JAX package's, on the cases of
tests/test_final_suites.py's TestAerospikeWire, TestAerospikeClients,
TestAerospikeKillNemesis and TestAerospikePause: v2 type-3 messages
and key digests built from seeded keys and bins are byte for byte alike
(the port's own RIPEMD-160 against `hashlib`'s and the JAX package's
digest); the same raw messages against both packages' simulators give
the same reply bytes; the clients' determinacy taxonomy (a read error
`fail`, a write or cas error `info`, result code 3 a definite `fail`),
the workload registry, the op generators and the test maps are the
same; the bounded kill and the pause nemesis act on simulated nodes as
the JAX package's do. Then the recipe (`aerospike_sim.local_test_fn`)
through the CLI with device="cpu": cas-register and set runs whose
stored histories give the JAX package's checkers' dicts, members that
load neither torch nor jax, and `--nemesis pause-net` and fs-break
refused (exit 254) before any node command, `tc` never run."""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import random
import socket
import struct

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import aerospike as jas
from jepsen_tpu.dbs import aerospike_proto as jap
from jepsen_tpu.dbs import aerospike_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import checker, cli, core, independent, nemesis
from jepsen_tpu_torch import store
from jepsen_tpu_torch.control import LocalRemote
from jepsen_tpu_torch.dbs import aerospike, aerospike_proto as ap
from jepsen_tpu_torch.dbs import aerospike_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op, index
from test_torch_raftis_logcabin import import_profile, no_heavy, serve
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


# ---------------------------------------------------------------------------
# the wire, byte for byte

def seeded_keys(seed: int) -> list:
    rng = random.Random(seed)
    return [rng.choice([rng.randrange(-(1 << 62), 1 << 62),
                        rng.randrange(100), "k" + str(rng.random()),
                        ("set", rng.randrange(9)), "jepsen", ""])
            for _ in range(12)]


@pytest.mark.parametrize("seed", range(6))
def test_key_digests_match(seed):
    """The port's pure-Python RIPEMD-160 digest equals the JAX package's
    (`hashlib`'s) for seeded keys of every type, in seeded sets."""
    rng = random.Random(seed)
    for key in seeded_keys(seed):
        set_name = rng.choice(["jepsen", "", "s" * rng.randrange(40)])
        assert ap.key_digest(set_name, key) == jap.key_digest(set_name,
                                                              key)


def test_ripemd160_is_hashlibs():
    """Against the published test vectors, and against `hashlib` on
    seeded messages of every length around the padding boundaries where
    this interpreter's OpenSSL provides RIPEMD-160."""
    vectors = {b"": "9c1185a5c5e9fc54612808977ee8f548b2258d31",
               b"abc": "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc",
               b"message digest": "5d0689ef49d2fae572b881b123a85ffa21595f36",
               b"a" * 1000000: "52783243c1697bdbe16d37f97f68f08325dc1528"}
    for msg, want in vectors.items():
        assert ap.ripemd160(msg).hex() == want
    rng = random.Random(0)
    msgs = [bytes(rng.randrange(256) for _ in range(n))
            for n in [*range(130), 1000, 4097]]
    if "ripemd160" in hashlib.algorithms_available:
        for m in msgs:
            assert ap.ripemd160(m) == hashlib.new("ripemd160", m).digest()
    assert len({ap.ripemd160(m) for m in msgs}) == len(msgs)


def test_key_digest_needs_no_hashlib_ripemd(monkeypatch):
    """The digest is the port's own: with `hashlib.new` refusing
    RIPEMD-160 (OpenSSL 3 without its legacy provider) the port's is
    unchanged, where the JAX package's raises."""
    want = jap.key_digest("jepsen", 7)
    real = hashlib.new

    def refusing(name, *a, **kw):
        if name.lower() == "ripemd160":
            raise ValueError("unsupported hash type ripemd160")
        return real(name, *a, **kw)

    monkeypatch.setattr(hashlib, "new", refusing)
    assert ap.key_digest("jepsen", 7) == want
    with pytest.raises(ValueError, match="unsupported hash type"):
        jap.key_digest("jepsen", 7)


def messages(P, seed: int) -> list:
    """Messages of every kind the clients send, from seeded keys and
    bins."""
    rng = random.Random(seed)
    out = []
    for key in seeded_keys(seed)[:6]:
        fields = [P._field(P.FIELD_NAMESPACE, b"jepsen"),
                  P._field(P.FIELD_SET, b"jepsen"),
                  P._field(P.FIELD_DIGEST, P.key_digest("jepsen", key))]
        bins = {rng.choice(["value", "count", "b"]): rng.choice(
            [rng.randrange(-(1 << 40), 1 << 40), "s" + str(rng.random()),
             f" {rng.randrange(99)}"]) for _ in range(rng.randrange(1, 3))}
        gen_ = rng.randrange(5)
        out += [
            P.build_message(P.INFO1_READ | P.INFO1_GET_ALL, 0, 0, fields,
                            []),
            P.build_message(0, P.INFO2_WRITE, 0, fields,
                            [P._op(P.OP_WRITE, n, v)
                             for n, v in bins.items()]),
            P.build_message(0, P.INFO2_WRITE | P.INFO2_GENERATION, gen_,
                            fields, [P._op(P.OP_WRITE, n, v)
                                     for n, v in bins.items()]),
            P.build_message(0, P.INFO2_WRITE, 0, fields,
                            [P._op(P.OP_APPEND, n, str(v))
                             for n, v in bins.items()]),
        ]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_messages_byte_equal(seed):
    assert messages(ap, seed) == messages(jap, seed)


def test_wire_constants_and_parse_match():
    for name in ("INFO1_READ", "INFO1_GET_ALL", "INFO2_WRITE",
                 "INFO2_GENERATION", "FIELD_NAMESPACE", "FIELD_SET",
                 "FIELD_DIGEST", "OP_READ", "OP_WRITE", "OP_APPEND",
                 "BIN_TYPE_INTEGER", "BIN_TYPE_STRING", "RESULT_OK",
                 "RESULT_NOT_FOUND", "RESULT_GENERATION"):
        assert getattr(ap, name) == getattr(jap, name), name
    for m in messages(ap, 9):
        assert ap.parse_message(m[8:]) == jap.parse_message(m[8:])
    for v in (0, -1, 1 << 62, "x", "", " 7"):
        bt, vb = ap._encode_bin_value(v)
        assert (bt, vb) == jap._encode_bin_value(v)
        assert ap.decode_bin(bt, vb) == jap.decode_bin(bt, vb)


# ---------------------------------------------------------------------------
# the simulators reply alike

@pytest.fixture
def sims(tmp_path):
    """(suite module, proto module, port) of the JAX package's Aerospike
    simulator and the port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(aerospike_sim, str(tmp_path / "port.json"))]
    yield [(jas, jap, srvs[0].server_address[1]),
           (aerospike, ap, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def raw_replies(port, msgs) -> list:
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for m in msgs:
            s.sendall(m)
            head = s.recv(8, socket.MSG_WAITALL)
            out.append(head + s.recv(int.from_bytes(head[2:8], "big"),
                                     socket.MSG_WAITALL))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_simulators_reply_alike_byte_for_byte(sims, seed):
    (_, jp, jport), (_, tp, tport) = sims
    msgs = messages(tp, seed)
    # every message twice: reads of written records, generations moved
    got = raw_replies(tport, msgs + msgs)
    assert got == raw_replies(jport, msgs + msgs)
    results = [tp.parse_message(r[8:])[0] for r in got]
    assert tp.RESULT_GENERATION in results and tp.RESULT_OK in results


def wire_session(P, port) -> list:
    """TestAerospikeWire's calls: get/put with generations, a
    GENERATION_EQUAL write and its lost race, string bins, appends."""
    c = P.AerospikeConn("127.0.0.1", port)
    out = [c.get("k")]
    c.put("k", {"value": 3})
    out.append(c.get("k"))
    c.put("k", {"value": 4})
    out.append(c.get("k"))
    c.put("g", {"value": 1})
    generation, _ = c.get("g")
    c.put("g", {"value": 2}, expected_generation=generation)
    try:
        c.put("g", {"value": 9}, expected_generation=generation)
    except P.AerospikeError as e:
        out.append(("error", e.code))
    out.append(c.get("g"))
    c.put("s", {"name": "hello"})
    out.append(c.get("s"))
    c.append("a", {"value": " 1"})
    c.append("a", {"value": " 2"})
    out.append(c.get("a"))
    c.close()
    return out


def test_wire_session(sims):
    (_, jp, jport), (_, tp, tport) = sims
    got = wire_session(tp, tport)
    assert got == wire_session(jp, jport)
    assert got == [(None, None), (1, {"value": 3}), (2, {"value": 4}),
                   ("error", 3), (2, {"value": 2}), (1, {"name": "hello"}),
                   (2, {"value": " 1 2"})]


# ---------------------------------------------------------------------------
# the clients' taxonomy

def cfg(port, nodes=("n1",)) -> dict:
    return {"aerospike": {"addr_fn": lambda n: "127.0.0.1",
                          "ports": {n: port for n in nodes}},
            "nodes": list(nodes)}


def client_session(mod, ind, op_cls, port) -> list:
    t = cfg(port)
    out = []
    c = mod.CasRegisterClient().open(t, "n1")
    for f, v in (("read", None), ("write", 3), ("cas", (3, 4)),
                 ("cas", (3, 9)), ("read", None)):
        r = c.invoke(t, op_cls(0, "invoke", f, v))
        out.append((r.type, r.value, r.error))
    c.close(t)
    c = mod.CounterClient().open(t, "n1")
    for f, v in [("add", 1)] * 5 + [("read", None)]:
        r = c.invoke(t, op_cls(0, "invoke", f, v))
        out.append((r.type, r.value, r.error))
    c = mod.SetClient().open(t, "n1")
    for f, v in (("add", (7, 3)), ("add", (7, 1)), ("add", (7, 2)),
                 ("read", (7, None)), ("read", (9, None))):
        r = c.invoke(t, op_cls(0, "invoke", f, ind.tuple_(*v)))
        out.append((r.type, tuple(r.value), r.error))
    return out


def test_clients(sims):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = client_session(tmod, independent, Op, tport)
    assert got == client_session(jmod, jind, JOp, jport)
    assert got[:5] == [("ok", None, None), ("ok", 3, None),
                       ("ok", (3, 4), None), ("fail", (3, 9), None),
                       ("ok", 4, None)]
    assert got[10] == ("ok", 5, None)
    assert got[14:] == [("ok", (7, [1, 2, 3]), None), ("ok", (9, []), None)]


class Refusing:
    """A connection whose every call raises AerospikeError(code), or, on
    `put` with an expected generation, code 3 (a lost race)."""

    def __init__(self, P, code):
        self.P, self.code = P, code

    def get(self, key):
        if self.code == "race":
            # a set's bin holds appended strings; the register's an int
            return 1, ({"value": " 3"} if isinstance(key, tuple)
                       else {"value": 3, "count": 0})
        raise self.P.AerospikeError(self.code)

    def put(self, key, bins, expected_generation=None):
        raise self.P.AerospikeError(
            self.P.RESULT_GENERATION if self.code == "race" else self.code)

    append = put

    def close(self):
        pass


@pytest.mark.parametrize("code", [5, 14, "race"])
def test_error_taxonomy(code):
    """A read error is `fail`, a write, cas or add error `info` with
    its code; a lost generation race on cas is a definite `fail`
    generation-mismatch, on add retried until `retries-exhausted`."""
    out = []
    for mod, P, op_cls, ind in ((aerospike, ap, Op, independent),
                                (jas, jap, JOp, jind)):
        got = []
        for cls, f, v in (("CasRegisterClient", "read", None),
                          ("CasRegisterClient", "write", 1),
                          ("CasRegisterClient", "cas", (3, 4)),
                          ("CounterClient", "read", None),
                          ("CounterClient", "add", 1),
                          ("SetClient", "add", ind.tuple_(1, 2)),
                          ("SetClient", "read", ind.tuple_(1, None))):
            c = getattr(mod, cls)(Refusing(P, code))
            r = c.invoke({}, op_cls(0, "invoke", f, v))
            got.append((cls, f, r.type, r.error))
        out.append(got)
    assert out[0] == out[1]
    types = {(cls, f): (ty, err) for cls, f, ty, err in out[0]}
    if code == "race":
        assert types[("CasRegisterClient", "cas")] == (
            "fail", "generation-mismatch")
        assert types[("CounterClient", "add")] == ("fail",
                                                   "retries-exhausted")
    else:
        assert types[("CasRegisterClient", "read")] == ("fail",
                                                        f"code-{code}")
        assert types[("CasRegisterClient", "write")] == ("info",
                                                         f"code-{code}")
        assert types[("CasRegisterClient", "cas")] == ("info",
                                                       f"code-{code}")
        assert types[("SetClient", "read")] == ("fail", f"code-{code}")


def test_dead_node_taxonomy():
    """A node that answers nothing: the client cannot open (both
    packages raise)."""
    t = cfg(free_port())
    for mod in (aerospike, jas):
        with pytest.raises(OSError):
            mod.CasRegisterClient().open(t, "n1")


# ---------------------------------------------------------------------------
# workloads, generators and test maps

def test_workload_registry_and_generators():
    assert sorted(aerospike.workloads({})) == sorted(jas.workloads({})) == [
        "cas-register", "counter", "set"]
    for fn in ("r", "w", "cas", "add"):
        random.seed(5)
        got = [getattr(aerospike, fn)({}, 0) for _ in range(12)]
        random.seed(5)
        assert got == [getattr(jas, fn)({}, 0) for _ in range(12)], fn
    wl = aerospike.workloads({"device": "cpu"})["cas-register"]
    assert isinstance(wl["model"], type(aerospike.models.CASRegister()))
    assert wl["checker"].checker_map["linear"].device == "cpu"


@pytest.mark.parametrize("opts", [
    {}, {"workload": "counter"}, {"workload": "set"},
    {"nemesis": "pause"}, {"nemesis": "pause-net"},
    {"nemesis": "start-kill"}, {"nemesis": "none"}])
def test_aerospike_test_maps_match(opts):
    base = {"nodes": NODES, "time_limit": 5, **opts}
    t = aerospike.aerospike_test(dict(base))
    j = jas.aerospike_test(dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    assert type(t["client"]).__name__ == type(j["client"]).__name__
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert sorted(t["checker"].checker_map) == sorted(
        j["checker"].checker_map)
    assert type(t["model"]).__name__ == type(j["model"]).__name__
    for n in NODES:
        assert t["db"].daemon_args(t, n) == j["db"].daemon_args(j, n)
    if opts.get("nemesis", "").startswith("pause"):
        assert t["nemesis"].mode == j["nemesis"].mode


def test_cas_register_checker_takes_the_device():
    t = aerospike.aerospike_test({"nodes": NODES, "device": "cpu"})
    assert t["checker"].checker_map["linear"].device == "cpu"


def test_pause_nemesis_on_cli_surface():
    p = argparse.ArgumentParser()
    aerospike._opt_spec(p)
    assert p.parse_args(["--nemesis", "pause"]).nemesis == "pause"
    assert p.parse_args([]).workload == "cas-register"


# ---------------------------------------------------------------------------
# the kill and pause nemeses on simulated nodes

def sim_db(tmp_path, nodes):
    remote = LocalRemote(root=str(tmp_path / "nodes"))
    archive = str(tmp_path / "as.tar.gz")
    aerospike_sim.build_archive(archive, str(tmp_path / "s" / "a.json"))
    conf = {"addr_fn": lambda n: "127.0.0.1",
            "ports": {n: free_port() for n in nodes},
            "dir": lambda n: os.path.join(remote.node_dir(n), "opt"),
            "sudo": None}
    db = aerospike.AerospikeDB(archive_url=f"file://{archive}")
    test = {"remote": remote, "nodes": list(nodes), "aerospike": conf}
    for n in nodes:
        db.setup(test, n)
    return db, test, conf


def running(pid: int) -> bool:
    """The process `pid` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_bounded_kill_and_restart(tmp_path):
    """TestAerospikeKillNemesis: two of three die, the survivor answers,
    restart revives everyone. Restarting the live survivor leaves its
    one simulator process in place (its pidfile keeps its pid), so
    teardown stops every node's process."""
    nodes = ["n1", "n2", "n3"]
    db, test, conf = sim_db(tmp_path, nodes)

    def pid(n):
        with open(os.path.join(conf["dir"](n), db.pid_name)) as f:
            return int(f.read())

    try:
        nem = aerospike.kill_nemesis(db, max_dead=2)
        out = nem.invoke(test, Op("nemesis", "invoke", "kill", nodes))
        vals = list(out.value.values())
        assert vals.count("killed") == 2 and vals.count("still-alive") == 1
        (alive,) = [n for n, v in out.value.items() if v == "still-alive"]
        conn = ap.AerospikeConn("127.0.0.1", conf["ports"][alive],
                                timeout=2.0, connect_timeout=2.0)
        conn.get("probe")
        conn.close()
        survivor = pid(alive)
        out = nem.invoke(test, Op("nemesis", "invoke", "restart", nodes))
        assert set(out.value.values()) == {"started"} and not nem.dead
        for n in nodes:
            db.await_ready(test, n)
        assert pid(alive) == survivor and running(survivor)
        pids = [pid(n) for n in nodes]
        out = nem.invoke(test, Op("nemesis", "invoke", "revive", ["n1"]))
        assert out.value == {"n1": "not-running"}  # no asinfo here
    finally:
        for n in nodes:
            db.teardown(test, n)
    assert not any(running(p) for p in pids)


def test_paused_master_goes_info_then_revives(tmp_path):
    """TestAerospikePause: a SIGSTOPped node's op is never `ok`, the
    other node serves, resume revives it, and the history checks the
    same in both packages."""
    db, test, _ = sim_db(tmp_path, NODES)
    nem = aerospike.PauseNemesis(db, "process", masters_limit=1)
    try:
        out = nem.invoke(test, Op("nemesis", "invoke", "pause", None))
        (victim,) = out.value
        assert out.value[victim] == "paused"
        live = next(n for n in NODES if n != victim)
        hist = []
        try:
            cv = aerospike.SetClient().open(test, victim)
            cv.conn.sock.settimeout(1.0)
            r = cv.invoke(test, Op(0, "invoke", "add",
                                   independent.tuple_(0, 1)))
            assert r.type == "info", r
            hist += [Op(0, "invoke", "add", r.value), r]
        except OSError:
            pass  # stopped before accept(): the open itself times out
        cl = aerospike.SetClient().open(test, live)
        inv = Op(1, "invoke", "add", independent.tuple_(0, 2))
        hist += [inv, cl.invoke(test, inv)]
        assert hist[-1].type == "ok"
        out = nem.invoke(test, Op("nemesis", "invoke", "resume", None))
        assert out.value == {victim: "resumed"} and nem.paused == set()
        assert db.probe_ready(test, victim)
        inv = Op(2, "invoke", "read", independent.tuple_(0, None))
        hist += [inv, cl.invoke(test, inv)]
        hist = index(hist)
        got = independent.checker(checker.set_checker()).check({}, hist, {})
        want = jind.checker(jchecker.set_checker()).check(
            {}, to_jax(hist), {})
        assert normalise(got) == normalise(want)
        assert got["valid"] in (True, "unknown"), got
    finally:
        nem.teardown(test)
        for n in NODES:
            db.teardown(test, n)


def test_masters_limit_bounds_concurrent_pauses(tmp_path):
    nodes = ["n1", "n2", "n3"]
    db, test, _ = sim_db(tmp_path, nodes)
    nem = aerospike.PauseNemesis(db, "process", masters_limit=1)
    try:
        out1 = nem.invoke(test, Op("nemesis", "invoke", "pause", None))
        assert len(out1.value) == 1
        out2 = nem.invoke(test, Op("nemesis", "invoke", "pause", None))
        assert out2.value == "at-limit" and len(nem.paused) == 1
    finally:
        nem.teardown(test)
        for n in nodes:
            db.teardown(test, n)


class FakeRemote:
    def __init__(self):
        self.calls = []

    def exec(self, node, argv, sudo=None, check=True):
        self.calls.append((node, argv))


@pytest.mark.parametrize("targets,limit,want", [
    (["n1", "n2"], 2, {"n1": "net-delayed", "n2": "net-delayed"}),
    (["n1", "n2", "n3"], 1, {"n1": "net-delayed"}),
])
def test_net_mode_commands_match(targets, limit, want):
    """The net mode's backgrounded, self-restoring netem chain
    (pause.clj:46-56), command for command the JAX package's; resume
    issues nothing."""
    got = []
    for mod in (aerospike, jas):
        remote = FakeRemote()
        nem = mod.PauseNemesis(mod.AerospikeDB(archive_url="file:///x"),
                               "net", masters_limit=limit,
                               pause_delay=30.0)
        nem.settle_s = 0
        test = {"remote": remote, "nodes": ["n1", "n2", "n3"],
                "aerospike": {"sudo": None}}
        op_cls = Op if mod is aerospike else JOp
        out = nem.invoke(test, op_cls("nemesis", "invoke", "pause",
                                      targets))
        assert out.value == want
        n = len(remote.calls)
        out = nem.invoke(test, op_cls("nemesis", "invoke", "resume", None))
        assert set(out.value.values()) == {"self-restoring"}
        assert len(remote.calls) == n
        got.append(remote.calls)
    assert got[0] == got[1]
    script = got[0][0][1][-1]
    assert "tc qdisc add dev eth0 root netem delay 30000ms" in script
    assert "sleep 31; tc qdisc del dev eth0 root)" in script


# ---------------------------------------------------------------------------
# the recipe through the CLI

def recipe_run(tmp_path, *argv, concurrency="2"):
    c = aerospike_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(aerospike_sim.local_test_fn(c),
                            opt_spec=aerospike._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency",
         concurrency, "--time-limit", "3", "--store-dir", sd,
         "--device", "cpu", *argv])
    runs = [os.path.realpath(d)
            for d in glob.glob(os.path.join(sd, "*", "latest"))]
    return rc, runs


def stored(run_dir: str):
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    name = os.path.basename(os.path.dirname(run_dir))
    return res, store.load_history({
        "name": name, "start_time": os.path.basename(run_dir),
        "store_dir": os.path.dirname(os.path.dirname(run_dir))})


def test_recipe_cas_register_matches_the_jax_checker(tmp_path, monkeypatch):
    """The default workload through the recipe (the suite's nemesis, its
    partitions recorded and healed on the no-op network, holds the
    workers its first 10-s sleep): exit 0, valid, the stored history's
    linearizable dict the JAX package's; members load neither torch nor
    jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    rc, (run_dir,) = recipe_run(tmp_path)
    assert rc == 0
    res, hist = stored(run_dir)
    assert os.path.basename(os.path.dirname(run_dir)) == (
        "aerospike cas-register")
    assert res["linear"]["valid"] is True, res["linear"]
    assert [o for o in hist if o.f == "cas" and o.type == "ok"]
    want = jchecker.linearizable(jmodels.CASRegister()).check(
        {}, to_jax(hist), {})
    assert res["linear"] == normalise(want)
    logs = glob.glob(os.path.join(run_dir, "n*", "*aerospike.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.aerospike_proto" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_set_workload_matches_the_jax_checker(tmp_path):
    """TestAerospikeClients.test_full_run_set on the recipe's cluster:
    appends across keys, the deferred final read of every key, the
    per-key set dict the JAX package's."""
    c = aerospike_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    t = aerospike.aerospike_test({
        "workload": "set", "nodes": NODES, "remote": c["remote"],
        "archive_url": c["archive_url"], "aerospike": c["aerospike"],
        "concurrency": 5, "time_limit": 3, "quiesce": 0.5,
        "stagger": 0.01, "ops_per_key": 40, "device": "cpu"})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    want = jind.checker(jchecker.set_checker()).check({}, to_jax(hist), {})
    assert normalise(res["sets"]) == normalise(want)


@pytest.mark.parametrize("mode", ["pause-net", "fs-break"])
def test_recipe_refuses_before_any_node_command(tmp_path, monkeypatch,
                                                mode):
    """`--nemesis pause-net` (its netem delay would act on this
    machine's eth0) and fs-break exit 254 before any node command: no
    command reaches LocalRemote, no node directory is made."""
    ran = []
    real = LocalRemote.exec

    def recording(self, node, argv, *a, **kw):
        ran.append(argv)
        return real(self, node, argv, *a, **kw)

    monkeypatch.setattr(LocalRemote, "exec", recording)
    rc, runs = recipe_run(tmp_path, "--nemesis", mode)
    assert rc == 254 and runs == [] and ran == []
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))


def test_recipe_pause_is_the_process_mode(tmp_path):
    """`--nemesis pause` through the recipe: SIGSTOP by pidfile on a
    node's one simulator process, the no-op network, no OS (building the
    test map runs nothing on a node)."""
    from jepsen_tpu_torch import net

    c = aerospike_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    t = aerospike_sim.local_test_fn(c)({"nodes": NODES, "nemesis": "pause",
                                        "device": "cpu"})
    assert isinstance(t["nemesis"], aerospike.PauseNemesis)
    assert t["nemesis"].mode == "process"
    assert t["net"] is net.noop and t["os"] is None
    assert t["aerospike"]["sudo"] is None
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
