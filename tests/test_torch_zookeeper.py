"""The port's zookeeper suite (dbs/zk_proto.py, zk_sim.py, zookeeper.py)
against the JAX package's, on the cases of tests/test_zookeeper.py: jute
records from seeded values encode byte for byte alike and decode alike;
the same raw frames and the same client calls against both packages'
simulators give the same replies; the client's determinacy taxonomy, the
packaged DB's command stream, the archive lifecycle and the test map are
the same; a full run on simulated nodes with device="cpu" is valid and
its recorded history gives the JAX package's linearizable dict. Also the
recipe (`zk_sim.local_test_fn`) through the CLI, its stored history
checked by the JAX package's checker, fs-break refused, and member
processes that load neither torch nor jax."""

from __future__ import annotations

import glob
import json
import os
import random
import socket
import struct
import threading

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import zk_proto as jproto
from jepsen_tpu.dbs import zk_sim as jsim
from jepsen_tpu.dbs import zookeeper as jzk
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, models, nemesis
from jepsen_tpu_torch import store
from jepsen_tpu_torch.control import DummyRemote
from jepsen_tpu_torch.dbs import zk_proto, zk_sim, zookeeper
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy, serve
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


@pytest.fixture
def sims(tmp_path):
    """(package, proto module, port) of the JAX package's jute simulator
    and the port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(zk_sim, str(tmp_path / "port.json"))]
    yield [(jzk, jproto, srvs[0].server_address[1]),
           (zookeeper, zk_proto, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# jute records, byte for byte

def records(P, seed: int) -> list:
    """Every record the client writes, from seeded values, and the
    reader's view of a packed stat and of the records' fields."""
    rng = random.Random(seed)
    path = "/" + "".join(rng.choice("abcxyz/_") for _ in range(rng.randrange(
        1, 12)))
    data = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
    version = rng.randrange(-1, 1 << 31)
    stat = {k: rng.randrange(-(1 << 62), 1 << 62) for k in (
        "czxid", "mzxid", "ctime", "mtime", "ephemeralOwner", "pzxid")}
    stat.update({k: rng.randrange(-(1 << 31), 1 << 31) for k in (
        "version", "cversion", "aversion", "dataLength", "numChildren")})
    W = P.Writer
    out = [
        W().int32(0).int64(rng.randrange(1 << 62)).int32(10_000).int64(0)
        .buffer(b"\x00" * 16).bytes_(),
        W().ustring(path).buffer(data).acls(P.OPEN_ACL_UNSAFE).int32(
            rng.randrange(4)).bytes_(),
        W().ustring(path).bool_(rng.random() < 0.5).bytes_(),
        W().ustring(path).buffer(data).int32(version).bytes_(),
        W().ustring(path).int32(version).bytes_(),
        W().buffer(None).ustring(None).ustring("").bytes_(),
        W().int32(rng.randrange(1 << 31)).int32(P.OP_SET_DATA).bytes_(),
        P.pack_stat(stat),
    ]
    r = P.Reader(out[3])
    out.append((r.ustring(), r.buffer(), r.int32()))
    out.append(P.Reader(P.pack_stat(stat)).stat())
    return out


@pytest.mark.parametrize("seed", range(8))
def test_jute_records_byte_equal(seed):
    got = records(zk_proto, seed)
    assert got == records(jproto, seed)
    assert len(got[7]) == zk_proto.STAT_STRUCT.size == 68


def test_jute_constants_and_errors_match():
    for name in ("OP_CREATE", "OP_DELETE", "OP_EXISTS", "OP_GET_DATA",
                 "OP_SET_DATA", "OP_PING", "OP_CLOSE", "XID_PING", "OK",
                 "ERR_UNIMPLEMENTED", "ERR_NO_NODE", "ERR_NODE_EXISTS",
                 "ERR_BAD_VERSION", "OPEN_ACL_UNSAFE"):
        assert getattr(zk_proto, name) == getattr(jproto, name), name
    for code in (-101, -110, -103, -6, 0):
        t, j = zk_proto.err_for(code), jproto.err_for(code)
        assert type(t).__name__ == type(j).__name__ and t.code == j.code
        assert str(t) == str(j)
    with pytest.raises(zk_proto.ZkError, match="short packet"):
        zk_proto.Reader(b"\x00\x00").int32()


# ---------------------------------------------------------------------------
# the simulators reply alike (TestProtocol)

def frame(P, xid, opcode, body=b"") -> bytes:
    return P.Writer().int32(xid).int32(opcode).bytes_() + body


def raw_replies(P, port, frames) -> list:
    """The connect reply without its random session id, then the raw
    reply frame of each request frame; a four-letter `ruok` after."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        P.write_frame(s, P.Writer().int32(0).int64(0).int32(7_000).int64(0)
                      .buffer(b"\x00" * 16).bytes_())
        hello = P.read_frame(s)
        out = [hello[:8] + hello[16:]]
        for f in frames:
            P.write_frame(s, f)
            out.append(P.read_frame(s))
    finally:
        s.close()
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(b"ruok")
        out.append(P._recv_exact(s, 4))
    return out


def protocol_frames(P) -> list:
    W = P.Writer
    create = W().ustring("/r").buffer(b"0").acls(P.OPEN_ACL_UNSAFE).int32(0)
    return [
        frame(P, 1, P.OP_CREATE, create.bytes_()),
        frame(P, 2, P.OP_CREATE, create.bytes_()),
        frame(P, 3, P.OP_GET_DATA, W().ustring("/r").bool_(False).bytes_()),
        frame(P, 4, P.OP_SET_DATA, W().ustring("/r").buffer(b"5").int32(0)
              .bytes_()),
        frame(P, 5, P.OP_SET_DATA, W().ustring("/r").buffer(b"6").int32(0)
              .bytes_()),
        frame(P, 6, P.OP_EXISTS, W().ustring("/r").bool_(False).bytes_()),
        frame(P, 7, P.OP_GET_DATA, W().ustring("/ghost").bool_(False)
              .bytes_()),
        frame(P, 8, P.OP_DELETE, W().ustring("/r").int32(7).bytes_()),
        frame(P, 9, P.OP_DELETE, W().ustring("/r").int32(-1).bytes_()),
        frame(P, 10, P.OP_EXISTS, W().ustring("/r").bool_(False).bytes_()),
        frame(P, P.XID_PING, P.OP_PING),
        frame(P, 11, 99),
        frame(P, 12, P.OP_CLOSE),
    ]


def test_simulators_reply_alike_byte_for_byte(sims):
    (_, jp, jport), (_, tp, tport) = sims
    got = raw_replies(tp, tport, protocol_frames(tp))
    assert protocol_frames(tp) == protocol_frames(jp)
    assert got == raw_replies(jp, jport, protocol_frames(jp))
    errs = [struct.unpack(">i", r[12:16])[0] for r in got[1:-1]]
    assert errs == [0, -110, 0, 0, -103, 0, -101, -103, 0, -101, 0, -6, 0]
    assert got[-1] == b"imok"


def client_calls(P, port) -> list:
    """tests/test_zookeeper.py::TestProtocol's calls through each
    package's ZkConn, two sessions sharing the store."""
    c1, c2 = P.ZkConn("127.0.0.1", port), P.ZkConn("127.0.0.1", port)
    out = [c1.negotiated_timeout > 0]

    def call(fn, *a):
        try:
            out.append(fn(*a))
        except P.ZkError as e:
            out.append(["error", type(e).__name__, e.code])

    call(c1.create, "/r", b"0")
    call(c1.get_data, "/r")
    call(c1.set_data, "/r", b"5", -1)
    call(c2.get_data, "/r")
    call(c1.create, "/r", b"y")
    call(c2.get_data, "/ghost")
    call(c1.set_data, "/r", b"6", 1)
    call(c2.set_data, "/r", b"7", 1)
    call(c1.exists, "/e")
    call(c1.create, "/e", b"x")
    call(c2.exists, "/e")
    call(c1.delete, "/e")
    call(c1.exists, "/e")
    call(c2.delete, "/e")
    call(c1.ping)
    c1.close()
    c2.close()
    return out


def test_client_calls_match(sims):
    (_, jp, jport), (_, tp, tport) = sims
    got = client_calls(tp, tport)
    assert got == client_calls(jp, jport)
    assert got[1] == "/r" and got[2][0] == b"0" and got[2][1]["version"] == 0
    assert got[3]["version"] == 1 and got[4][0] == b"5"
    assert got[5] == ["error", "NodeExists", -110]
    assert got[6] == ["error", "NoNode", -101]
    assert got[8] == ["error", "BadVersion", -103]
    assert got[9] is None and got[11]["version"] == 0 and got[13] is None
    assert got[14] == ["error", "NoNode", -101]


def test_ruok(sims):
    for mod, _, port in sims:
        assert mod.ruok({"zk": {"addr_fn": lambda n: "127.0.0.1",
                                "client_ports": {"n1": port}}}, "n1")
    assert not zookeeper.ruok({"zk": {"addr_fn": lambda n: "127.0.0.1",
                                      "client_ports": {"n1": free_port()}}},
                              "n1", timeout=0.3)


# ---------------------------------------------------------------------------
# the client (TestClient)

def atom_taxonomy(mod, op_cls, port) -> list:
    t = {"zk": {"addr_fn": lambda n: "127.0.0.1",
                "client_ports": {"n1": port}}}
    c = mod.ZkAtomClient().open(t, "n1")
    c.setup(t)
    c2 = mod.ZkAtomClient().open(t, "n1")
    c2.setup(t)  # NodeExists swallowed
    out = [(r.type, r.value, r.error) for r in (
        c.invoke(t, op_cls(0, "invoke", f, v)) for f, v in (
            ("read", None), ("write", 3), ("read", None), ("cas", (3, 4)),
            ("cas", (9, 1)), ("read", None)))]
    with pytest.raises(ValueError):
        c.invoke(t, op_cls(0, "invoke", "frob", None))
    c.close(t)
    c2.close(t)
    return out


def test_atom_client_taxonomy(sims):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = atom_taxonomy(tmod, Op, tport)
    assert got == atom_taxonomy(jmod, JOp, jport)
    assert got == [("ok", 0, None), ("ok", 3, None), ("ok", 3, None),
                   ("ok", (3, 4), None), ("fail", (9, 1), None),
                   ("ok", 4, None)]


def test_dead_server_open_raises():
    t = {"zk": {"addr_fn": lambda n: "127.0.0.1",
                "client_ports": {"n1": free_port()}}}
    for mod in (zookeeper, jzk):
        with pytest.raises(OSError):
            mod.ZkAtomClient(timeout=0.5).open(t, "n1")


def silent_server():
    """A server that answers the handshake, then never a request."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    held = []

    def loop():
        while True:
            try:
                s, _ = srv.accept()
            except OSError:
                return
            (n,) = struct.unpack(">i", zk_proto._recv_exact(s, 4))
            zk_proto._recv_exact(s, n)
            zk_proto.write_frame(s, zk_proto.Writer().int32(0).int32(10_000)
                                 .int64(1).buffer(b"\x00" * 16).bytes_())
            held.append(s)

    threading.Thread(target=loop, daemon=True).start()
    return srv


@pytest.mark.parametrize("f,value", [("read", None), ("write", 1),
                                     ("cas", (0, 1))])
def test_timeout_is_info(f, value):
    srv = silent_server()
    t = {"zk": {"addr_fn": lambda n: "127.0.0.1",
                "client_ports": {"n1": srv.getsockname()[1]}}}
    try:
        got = [(r.type, r.error) for r in (
            mod.ZkAtomClient(timeout=0.3).open(t, "n1").invoke(
                t, cls(0, "invoke", f, value))
            for mod, cls in ((zookeeper, Op), (jzk, JOp)))]
    finally:
        srv.close()
    assert got == [("info", "timeout")] * 2


# ---------------------------------------------------------------------------
# the DB (TestDB) and the test map (TestBundle)

def packaged_commands(mod) -> list:
    remote = DummyRemote()
    test = {"remote": remote, "nodes": ["n1", "n2", "n3"]}
    database = mod.ZookeeperDB(ready_timeout=0)
    with pytest.raises(Exception):
        database.setup(test, "n2")  # ruok cannot succeed on a DummyRemote
    database.teardown(test, "n2")
    assert database.log_files(test, "n2") == [
        "/var/log/zookeeper/zookeeper.log"]
    return remote.commands


def test_packaged_setup_command_stream():
    got = packaged_commands(zookeeper)
    assert got == packaged_commands(jzk)
    cmds = " ;; ".join(c for _, c in got)
    for want in ("apt-get install", "echo 1 > /etc/zookeeper/conf/myid",
                 "tee /etc/zookeeper/conf/zoo.cfg",
                 "service zookeeper restart", "service zookeeper stop"):
        assert want in cmds


def test_zoo_cfg_servers():
    for nodes in (["a", "b"], ["n1", "n2", "n3", "n4", "n5"]):
        test = {"nodes": nodes}
        assert zookeeper.zoo_cfg_servers(test) == jzk.zoo_cfg_servers(test)
        assert zookeeper.zk_node_ids(test) == jzk.zk_node_ids(test)
    assert zookeeper.zoo_cfg_servers({"nodes": ["a", "b"]}) == (
        "server.0=a:2888:3888\nserver.1=b:2888:3888")
    assert zookeeper.ZOO_CFG_BASE == jzk.ZOO_CFG_BASE
    assert (zookeeper.CLIENT_PORT, zookeeper.ZNODE, zookeeper.VERSION) == (
        jzk.CLIENT_PORT, jzk.ZNODE, jzk.VERSION)


def test_archive_lifecycle(tmp_path):
    c = zk_sim.local_cluster(str(tmp_path), NODES)
    test = {"remote": c["remote"], "nodes": NODES, "zk": c["zk"]}
    database = zookeeper.ZookeeperDB(archive_url=c["archive_url"])
    try:
        for n in NODES:
            database.setup(test, n)
        c1 = zk_proto.ZkConn("127.0.0.1", c["ports"]["n1"])
        c2 = zk_proto.ZkConn("127.0.0.1", c["ports"]["n2"])
        c1.create("/x", b"9")
        assert c2.get_data("/x")[0] == b"9"
        c1.close()
        c2.close()
        assert database.log_files(test, "n1") == [os.path.join(
            c["zk"]["dir"]("n1"), "zookeeper.log")]
    finally:
        for n in NODES:
            database.teardown(test, n)
    assert not zookeeper.ruok(test, "n1")
    assert not os.path.exists(c["zk"]["dir"]("n1"))


@pytest.mark.parametrize("opts", [{}, {"nemesis": "none"},
                                  {"nemesis": "majority-ring"},
                                  {"name": "x", "model": None}])
def test_zk_test_bundle(opts):
    base = {"time_limit": 5, "nodes": ["a", "b", "c"], **opts}
    t, j = zookeeper.zk_test(dict(base)), jzk.zk_test(dict(base))
    assert sorted(t) == sorted(j)
    assert t["name"] == j["name"] == "zookeeper"  # the suite's win
    assert isinstance(t["db"], zookeeper.ZookeeperDB)
    assert isinstance(t["client"], zookeeper.ZkAtomClient)
    assert isinstance(t["generator"], gen.Generator)
    assert t["model"] == models.CASRegister(0)
    assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
    assert sorted(t["checker"].checker_map) == ["linear", "perf"]


def test_op_generators_match():
    for fn in ("r", "w", "cas"):
        random.seed(3)
        got = [getattr(zookeeper, fn)({}, 0) for _ in range(20)]
        random.seed(3)
        assert got == [getattr(jzk, fn)({}, 0) for _ in range(20)]


# ---------------------------------------------------------------------------
# full runs (TestFullRun) and the recipe

def test_full_run_matches_the_jax_checker(tmp_path):
    c = zk_sim.local_cluster(str(tmp_path), ["n1", "n2", "n3"])
    t = zookeeper.zk_test({"nodes": ["n1", "n2", "n3"], "remote": c["remote"],
                           "archive_url": c["archive_url"], "zk": c["zk"],
                           "concurrency": 5, "device": "cpu"})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop,
              "client": zookeeper.ZkAtomClient(timeout=2.0),
              "generator": gen.time_limit(4, gen.clients(gen.stagger(
                  0.01, gen.mix([zookeeper.r, zookeeper.w,
                                 zookeeper.cas]))))})
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    oks = [o for o in hist if o.type == "ok"]
    assert len(oks) > 20 and {"read", "write", "cas"} <= {o.f for o in oks}
    want = jchecker.linearizable().check(
        {"model": jmodels.CASRegister(0)}, to_jax(hist), {})
    assert normalise(res["linear"]) == normalise(want)


def stored(sd: str, suite: str) -> tuple:
    """(run dir, results, history) of the newest run in a store."""
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, suite, "latest"))]
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    hist = store.load_history({"name": suite,
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    return run_dir, res, hist


def test_recipe_cli_run_and_members_load_no_jax(tmp_path, monkeypatch):
    """The recipe at the suite's defaults (its partition nemesis on the
    no-op network, first sleep 5 s): exit 0, valid, the stored history
    giving the JAX package's dict; each member's imports free of torch
    and jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = zk_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(zk_sim.local_test_fn(c),
                            opt_spec=zookeeper._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "2",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu"])
    assert rc == 0
    run_dir, res, hist = stored(sd, "zookeeper")
    assert res["linear"]["valid"] is True, res["linear"]
    want = jchecker.linearizable().check(
        {"model": jmodels.CASRegister(0)}, to_jax(hist), {})
    assert res["linear"] == normalise(want)
    logs = glob.glob(os.path.join(run_dir, "n*", "*zookeeper.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_refuses_fs_break(tmp_path):
    c = zk_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(zk_sim.local_test_fn(c),
                            opt_spec=zookeeper._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
