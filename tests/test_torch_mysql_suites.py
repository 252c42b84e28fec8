"""The port's MySQL-wire suites (dbs/mysql_proto.py, mysql_sim.py,
mysql_common.py, role_sim.py, galera.py, percona.py, mysql_cluster*.py,
tidb*.py) against the JAX package's, on the cases of
tests/test_mysql_suites.py: the wire protocol, the shared clients and
their taxonomy, full runs of the four suites on simulated nodes with
device="cpu" (tidb's register under tikv kills too), the bundles, the
standard nemeses, the tidb triple and the NDB roles. Then parity: the
client's and the server's packets byte for byte (handshake response,
scramble, COM_QUERY, OK, ERR, EOF, column and row packets), both
packages' simulators answering the same statements alike, the same op
from `exception_to_op` and from each client for the same error or
session, each stored history giving the JAX package's checker dict
(tidb's register through the card's route too, against the JAX
package's `pallas`), and the recipes (`mysql_sim`, `tidb_sim`,
`mysql_cluster_sim`) through the CLI; the port's SUITES has the JAX
package's keys."""

from __future__ import annotations

import glob
import importlib
import json
import os
import random
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import SUITES as JSUITES
from jepsen_tpu.dbs import galera as jgalera
from jepsen_tpu.dbs import mysql_cluster as jmysql_cluster
from jepsen_tpu.dbs import mysql_common as jmc
from jepsen_tpu.dbs import mysql_proto as jmp
from jepsen_tpu.dbs import mysql_sim as jmysql_sim
from jepsen_tpu.dbs import percona as jpercona
from jepsen_tpu.dbs import tidb as jtidb
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import checker, cli, core, nemesis, store
from jepsen_tpu_torch.dbs import SUITES
from jepsen_tpu_torch.dbs import galera, mysql_cluster, mysql_cluster_sim
from jepsen_tpu_torch.dbs import mysql_common as mc
from jepsen_tpu_torch.dbs import mysql_proto as mp
from jepsen_tpu_torch.dbs import mysql_sim, percona, tidb, tidb_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.models import CASRegister
from test_torch_raftis_logcabin import import_profile, no_heavy
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0

    srv = sim.Server(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sim(tmp_path, monkeypatch):
    monkeypatch.setattr(mysql_sim, "TXN_LOCK_TIMEOUT", 0.3)
    srv = serve(mysql_sim, str(tmp_path / "mysql.json"))
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def sims(tmp_path, monkeypatch):
    """(package's modules, port) of the JAX package's MySQL simulator and
    the port's, each on a fresh store."""
    for m in (mysql_sim, jmysql_sim):
        monkeypatch.setattr(m, "TXN_LOCK_TIMEOUT", 0.3)
    srvs = [serve(jmysql_sim, str(tmp_path / "jax.json")),
            serve(mysql_sim, str(tmp_path / "port.json"))]
    yield [((jmp, jmc, JOp), srvs[0].server_address[1]),
           ((mp, mc, Op), srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


# ---------------------------------------------------------------------------
# the protocol (TestProtocol)

def test_handshake_and_query(sim):
    c = mp.MySqlConn("127.0.0.1", sim, user="jepsen", password="secret")
    c.query("create table t (id int primary key, v int)")
    assert c.query("insert into t values (1, 5)").rowcount == 1
    res = c.query("select id, v from t")
    assert res.columns == ["id", "v"] and res.rows == [("1", "5")]
    c.close()


def test_null_and_error(sim):
    c = mp.MySqlConn("127.0.0.1", sim)
    c.query("create table n (id int primary key, v int)")
    c.query("insert into n (id) values (1)")
    assert c.query("select v from n").rows == [(None,)]
    with pytest.raises(mp.MySqlError) as ei:
        c.query("insert into n (id) values (1)")
    assert ei.value.code == mp.ER_DUP_ENTRY
    # the connection survives errors
    assert c.query("select 1").rows == [("1",)]
    c.close()


def test_deadlock_on_contention(sim):
    c1 = mp.MySqlConn("127.0.0.1", sim)
    c2 = mp.MySqlConn("127.0.0.1", sim)
    c1.query("begin")
    with pytest.raises(mp.MySqlError) as ei:
        c2.query("begin")
    assert ei.value.deadlock
    assert mp.DEADLOCK_MSG in str(ei.value)
    c1.query("rollback")
    c1.close()
    c2.close()


def test_scramble_matches_reference_shape():
    out = mp.scramble_native("pw", b"x" * 20)
    assert len(out) == 20
    assert mp.scramble_native("", b"x" * 20) == b""


# ---------------------------------------------------------------------------
# packets byte for byte

def test_server_packets_byte_for_byte():
    rng = random.Random(20)
    words = ["", "a", "jepsen", "x" * 300, "ü-ñ"]
    for _ in range(200):
        pw = rng.choice(words) + str(rng.randrange(1 << 20))
        nonce = bytes(rng.randrange(1, 256) for _ in range(20))
        assert mp.scramble_native(pw, nonce) == jmp.scramble_native(pw,
                                                                    nonce)
    ns = [0, 1, 250, 251, 252, 0xFFFF, 0x10000, 0xFFFFFF, 0x1000000,
          1 << 40] + [rng.randrange(1 << rng.randrange(1, 63))
                      for _ in range(200)]
    for n in ns:
        enc = mp.lenenc_int(n)
        assert enc == jmp.lenenc_int(n)
        assert mp.read_lenenc_int(b"\x07" + enc, 1) == \
            jmp.read_lenenc_int(b"\x07" + enc, 1) == (n, 1 + len(enc))
        assert mp.ok_packet(n) == jmp.ok_packet(n)
    for code, msg, state in [(1213, mp.DEADLOCK_MSG, "40001"),
                             (1062, "Duplicate entry", "23000"),
                             (1064, "bad sql", "42000"),
                             (1047, "unsupported command 9", "HY000"),
                             (1146, "x", "42S")]:
        pkt = mp.err_packet(code, msg, state)
        assert pkt == jmp.err_packet(code, msg, state)
        e, je = mp.parse_err(pkt), jmp.parse_err(pkt)
        assert (e.code, e.message, e.sqlstate, str(e)) == (
            je.code, je.message, je.sqlstate, str(je))
        assert e.deadlock is je.deadlock is (code == 1213)
    assert mp.eof_packet() == jmp.eof_packet()
    for name in ["id", "val", "_version", "x" * 260, ""]:
        assert mp.column_packet(name) == jmp.column_packet(name)
    for _ in range(100):
        row = [rng.choice([None, rng.randrange(-1 << 40, 1 << 40),
                           "s" * rng.randrange(300), 1.5])
               for _ in range(rng.randrange(1, 6))]
        assert mp.row_packet(row) == jmp.row_packet(row)


class Recorder:
    """A stand-in MySQL server that greets with a fixed handshake,
    records every packet the client sends (its handshake response, its
    COM_QUERY and COM_QUIT) and answers each query with one OK."""

    GREETING = (b"\x0a" + b"recorder\x00" + struct.pack("<I", 7)
                + bytes(range(1, 9)) + b"\x00" + struct.pack("<H", 0xF7FF)
                + b"\x21" + struct.pack("<H", 2) + struct.pack("<H", 0x0F)
                + bytes([21]) + b"\x00" * 10 + bytes(range(9, 21)) + b"\x00"
                + b"mysql_native_password\x00")

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.got: list = []
        self.thread = threading.Thread(target=self.serve, daemon=True)
        self.thread.start()

    def serve(self):
        conn, _ = self.sock.accept()
        io = mp.PacketIO(conn)
        io.write_packet(self.GREETING)
        try:
            while True:
                payload = io.read_packet()
                self.got.append(payload)
                if payload[:1] == b"\x01":
                    return
                io.write_packet(mp.ok_packet(3))
        except ConnectionError:
            return
        finally:
            conn.close()
            self.sock.close()


@pytest.mark.parametrize("user,password,database", [
    ("jepsen", "", "jepsen"), ("root", "secret", ""), ("u", "pw", "db")])
def test_client_packets_byte_for_byte(user, password, database):
    """Each package's MySqlConn against the same fixed greeting sends the
    same handshake response (capabilities, scramble, database, plugin),
    the same COM_QUERY and the same COM_QUIT."""
    got = []
    for proto in (jmp, mp):
        rec = Recorder()
        c = proto.MySqlConn("127.0.0.1", rec.port, user=user,
                            password=password, database=database)
        assert c.query("update t set v = 1").rowcount == 3
        c.close()
        rec.thread.join(5)
        got.append(rec.got)
    assert got[0] == got[1]
    resp, query, quit_ = got[1]
    nonce = bytes(range(1, 21))
    auth = mp.scramble_native(password, nonce)
    assert resp[32:].startswith(user.encode() + b"\x00"
                                + bytes([len(auth)]) + auth)
    assert query == b"\x03update t set v = 1" and quit_ == b"\x01"


# ---------------------------------------------------------------------------
# the simulators answer alike

STATEMENTS = [
    "create table t (id int primary key, v int)",
    "insert into t values (1, 5)",
    "insert into t values (1, 6)",
    "insert into t (id) values (2)",
    "select id, v from t",
    "select v from t where id = 2",
    "update t set v = 7 where id = 1 and v = 5",
    "update t set v = 8 where id = 1 and v = 5",
    "begin",
    "update t set v = 9 where id = 1",
    "rollback",
    "select v from t where id = 1",
    "start transaction",
    "insert into t values (3, 3)",
    "commit",
    "select count(*) from t",
    "set session transaction isolation level serializable",
    "select * from nowhere",
    "frobnicate the table",
    "drop table if exists t",
    "select 1",
]


def answers(proto, port) -> list:
    out = []
    c = proto.MySqlConn("127.0.0.1", port)
    try:
        for sql in STATEMENTS:
            try:
                r = c.query(sql)
                out.append(("ok", r.columns, r.rows, r.affected))
            except proto.MySqlError as e:
                out.append(("err", e.code, e.sqlstate, e.message))
        # a second connection's begin while the first holds the lock
        c2 = proto.MySqlConn("127.0.0.1", port)
        c.query("begin")
        try:
            c2.query("begin")
        except proto.MySqlError as e:
            out.append(("err", e.code, e.sqlstate, e.message))
        c.query("rollback")
        c2.close()
    finally:
        c.close()
    return out


def test_simulators_answer_alike(sims):
    ((jproto, _, _), jport), ((proto, _, _), port) = sims
    got = answers(proto, port)
    assert got == answers(jproto, jport)
    assert got[2][:3] == ("err", mp.ER_DUP_ENTRY, "23000")
    assert got[4] == ("ok", ["id", "v"], [("1", "5"), ("2", None)], 0)
    assert got[6][3] == 1 and got[7][3] == 0
    assert got[11] == ("ok", ["v"], [("7",)], 0)
    assert got[-1] == ("err", mp.ER_LOCK_DEADLOCK, "40001",
                       mp.DEADLOCK_MSG)


# ---------------------------------------------------------------------------
# the shared clients (TestSharedClients)

def suite_map(port, suite):
    return {suite.name: {"addr_fn": lambda n: "127.0.0.1",
                         "ports": {"n1": port}}}


def test_bank_client(sim):
    t = suite_map(sim, galera.suite)
    c = mc.BankClient(galera.suite, n=3).open(t, "n1")
    c.setup(t)
    r = c.invoke(t, Op(0, "invoke", "read", None))
    assert r.type == "ok" and sum(r.value.values()) == 30
    x = c.invoke(t, Op(0, "invoke", "transfer",
                       {"from": 0, "to": 1, "amount": 5}))
    assert x.type == "ok"
    r = c.invoke(t, Op(0, "invoke", "read", None))
    assert r.value[0] == 5 and r.value[1] == 15


def test_register_client(sim):
    t = suite_map(sim, tidb.suite)
    c = mc.RegisterClient(tidb.suite).open(t, "n1")
    c.setup(t)
    assert c.invoke(t, Op(0, "invoke", "read", None)).value is None
    assert c.invoke(t, Op(0, "invoke", "write", 3)).type == "ok"
    assert c.invoke(t, Op(0, "invoke", "cas", (3, 4))).type == "ok"
    assert c.invoke(t, Op(0, "invoke", "cas", (3, 9))).type == "fail"
    assert c.invoke(t, Op(0, "invoke", "read", None)).value == 4


def test_dirty_reads_client_and_checker(sim):
    t = suite_map(sim, galera.suite)
    c = mc.DirtyReadsClient(galera.suite, n=3).open(t, "n1")
    c.setup(t)
    assert c.invoke(t, Op(0, "invoke", "write", 7)).type == "ok"
    r = c.invoke(t, Op(0, "invoke", "read", None))
    assert r.type == "ok" and r.value == [7, 7, 7]
    chk = mc.DirtyReadsChecker()
    clean = [Op(0, "invoke", "write", 7, index=0),
             Op(0, "ok", "write", 7, index=1),
             Op(1, "invoke", "read", None, index=2),
             Op(1, "ok", "read", [7, 7, 7], index=3)]
    assert chk.check({}, clean, {})["valid"] is True
    dirty = [Op(0, "invoke", "write", 9, index=0),
             Op(0, "fail", "write", 9, index=1),
             Op(1, "invoke", "read", None, index=2),
             Op(1, "ok", "read", [9, 9, 9], index=3)]
    res = chk.check({}, dirty, {})
    assert res["valid"] is False and res["dirty_reads"]


def test_dead_node_raises_at_open():
    # the reconnect wrapper connects eagerly; the engine's worker
    # handles open failures by crashing the process (:info)
    t = suite_map(free_port(), galera.suite)
    with pytest.raises(Exception):
        mc.SetClient(galera.suite).open(t, "n1")


def test_mid_run_connection_loss_taxonomy(sim):
    t = suite_map(sim, galera.suite)
    c = mc.SetClient(galera.suite).open(t, "n1")
    c.setup(t)
    c.conn.conn().sock.close()
    assert c.invoke(t, Op(0, "invoke", "add", 1)).type == "info"
    # the wrapper reopened after the failure above: ok, or a definite
    # fail, never info
    assert c.invoke(t, Op(0, "invoke", "read", None)).type in ("ok",
                                                               "fail")


def client_session(pkg, port) -> list:
    """The same ops through each shared client of one package against its
    own simulator: (client, type, value, error)."""
    proto, common, op_cls = pkg
    suites = {"galera": (jgalera if common is jmc else galera).suite,
              "tidb": (jtidb if common is jmc else tidb).suite}
    out = []

    def run(name, client, fs):
        suite = suites["tidb" if name == "register" else "galera"]
        t = suite_map(port, suite)
        c = client(suite).open(t, "n1")
        c.setup(t)
        for f, v in fs:
            r = c.invoke(t, op_cls(0, "invoke", f, v))
            out.append((name, r.type, r.value, r.error))
        c.close(t)

    run("bank", lambda s: common.BankClient(s, n=3), [
        ("read", None), ("transfer", {"from": 0, "to": 1, "amount": 4}),
        ("transfer", {"from": 2, "to": 0, "amount": 11}),
        ("transfer", {"from": 1, "to": 2, "amount": 14}),
        ("read", None)])
    run("sets", common.SetClient, [("add", 1), ("add", 2), ("add", 1),
                                   ("read", None)])
    run("dirty", lambda s: common.DirtyReadsClient(s, n=3), [
        ("read", None), ("write", 4), ("read", None)])
    run("register", common.RegisterClient, [
        ("read", None), ("write", 2), ("cas", (2, 3)), ("cas", (2, 4)),
        ("write", 1), ("read", None)])
    return out


def test_clients_match(sims):
    (jpkg, jport), (pkg, port) = sims
    got = client_session(pkg, port)
    assert got == client_session(jpkg, jport)
    assert [t for _, t, _, _ in got[:5]] == ["ok", "ok", "fail", "ok",
                                             "ok"]
    assert got[4][2] == {0: 6, 1: 0, 2: 24}
    assert got[7][1:] == ("fail", 1, "duplicate-key")
    assert got[8][2] == [1, 2] and got[11][2] == [4, 4, 4]
    assert [t for _, t, _, _ in got[12:]] == ["ok", "ok", "ok", "fail",
                                              "ok", "ok"]


def errors(proto) -> list:
    return [proto.MySqlError(1213, proto.DEADLOCK_MSG, "40001"),
            proto.MySqlError(1062, "Duplicate entry", "23000"),
            proto.MySqlError(1064, "syntax", "42000"),
            proto.MySqlError(1146, "no table", "42S02"),
            socket.timeout("timed out"), TimeoutError("t"),
            ConnectionError("mysql connection closed"),
            ConnectionRefusedError(111, "refused"),
            proto.MySqlProtocolError("expected EOF after columns"),
            OSError(9, "bad fd"), ValueError("not a fault")]


def test_exception_to_op_matches():
    got, want = [], []
    for f in ("read", "write", "cas", "add", "transfer"):
        for e, je in zip(errors(mp), errors(jmp)):
            r = mc.exception_to_op(Op(0, "invoke", f, 1), e)
            jr = jmc.exception_to_op(JOp(0, "invoke", f, 1), je)
            got.append(None if r is None else (r.type, r.error))
            want.append(None if jr is None else (jr.type, jr.error))
    assert got == want
    assert got[:11] == [
        ("fail", ("txn-abort", f"(1213) {mp.DEADLOCK_MSG}")),
        ("fail", "duplicate-key"), ("fail", "(1064) syntax"),
        ("fail", "(1146) no table"), ("fail", "timeout"),
        ("fail", "timeout"), ("fail", "mysql connection closed"),
        ("fail", "[Errno 111] refused"),
        ("fail", "expected EOF after columns"), ("fail", "[Errno 9] bad fd"),
        None]
    assert got[11:22] == [
        ("fail", ("txn-abort", f"(1213) {mp.DEADLOCK_MSG}")),
        ("fail", "duplicate-key"), ("info", "(1064) syntax"),
        ("info", "(1146) no table"), ("info", "timeout"), ("info", "timeout"),
        ("info", "mysql connection closed"), ("info", "[Errno 111] refused"),
        ("info", "expected EOF after columns"), ("info", "[Errno 9] bad fd"),
        None]


def test_txn_retry_matches():
    """txn_retry: deadlocks retried with backoff until they stop or the
    attempts run out; any other error raised at once."""
    for proto, common in ((mp, mc), (jmp, jmc)):
        calls = []

        def body(fail_for, code=1213):
            calls.append(1)
            if len(calls) <= fail_for:
                raise proto.MySqlError(code, "x")
            return "done"

        assert common.txn_retry(lambda: body(3), backoff=0.001) == "done"
        assert len(calls) == 4
        calls.clear()
        with pytest.raises(proto.MySqlError):
            common.txn_retry(lambda: body(9), attempts=2, backoff=0.001)
        assert len(calls) == 3
        calls.clear()
        with pytest.raises(proto.MySqlError):
            common.txn_retry(lambda: body(1, 1062), backoff=0.001)
        assert len(calls) == 1


def dirty_histories(cls) -> dict:
    w = [cls(0, "invoke", "write", 7, index=0),
         cls(0, "ok", "write", 7, index=1),
         cls(1, "invoke", "write", 9, index=2),
         cls(1, "fail", "write", 9, index=3)]
    return {"clean": w + [cls(2, "invoke", "read", None, index=4),
                          cls(2, "ok", "read", [7, 7, 7], index=5)],
            "dirty": w + [cls(2, "invoke", "read", None, index=4),
                          cls(2, "ok", "read", [9, 7, 7], index=5)],
            "none": w}


@pytest.mark.parametrize("case", ["clean", "dirty", "none"])
def test_dirty_reads_checker_matches(case):
    got = mc.DirtyReadsChecker().check({}, dirty_histories(Op)[case], {})
    assert got == jmc.DirtyReadsChecker().check(
        {}, dirty_histories(JOp)[case], {})
    assert got["valid"] is (case != "dirty")
    if case == "dirty":
        assert got["inconsistent_reads"] == [[9, 7, 7]]


# ---------------------------------------------------------------------------
# full runs (TestFullRuns), each history also through the JAX package's
# checker

def sql_cluster(tmp_path, module, nodes):
    """A simulated cluster of `module`'s suite through its recipe."""
    if module is tidb:
        return tidb_sim.local_cluster(str(tmp_path / "c"), nodes)
    if module is mysql_cluster:
        return mysql_cluster_sim.local_cluster(str(tmp_path / "c"), nodes)
    return mysql_sim.local_cluster(str(tmp_path / "c"), nodes,
                                   suite=module.suite.name)


JAX = {galera: jgalera, percona: jpercona, mysql_cluster: jmysql_cluster,
       tidb: jtidb}


def run_suite(tmp_path, module, workload, keep_nemesis=False,
              nodes=NODES, **extra):
    c = sql_cluster(tmp_path, module, nodes)
    name = module.suite.name
    t = getattr(module, f"{name.replace('-', '_')}_test")({
        "workload": workload, "nodes": nodes, "remote": c["remote"],
        "archive_url": c["archive_url"], name: c[name], "concurrency": 4,
        "time_limit": 4, "quiesce": 0.3, "stagger": 0.01,
        "nemesis_interval": 1, "device": "cpu", **extra})
    t.update({"os": None, "net": None})
    if not keep_nemesis:
        t["nemesis"] = nemesis.noop
    result = core.run(t)
    jt = getattr(JAX[module], f"{name.replace('-', '_')}_test")({
        "workload": workload, "nodes": nodes, **extra})
    want = jt["checker"].checker_map["workload"].check(
        {"model": jmodels.CASRegister()}, to_jax(result["history"]), {})
    assert normalise(result["results"]["workload"]) == normalise(want)
    return result


def test_galera_bank(tmp_path):
    result = run_suite(tmp_path, galera, "bank")
    assert result["results"]["valid"] is True, result["results"]


def test_percona_sets(tmp_path):
    result = run_suite(tmp_path, percona, "sets")
    assert result["results"]["valid"] is True, result["results"]


def test_mysql_cluster_bank(tmp_path):
    result = run_suite(tmp_path, mysql_cluster, "bank")
    assert result["results"]["valid"] is True, result["results"]


def test_tidb_register(tmp_path):
    result = run_suite(tmp_path, tidb, "register")
    assert result["results"]["valid"] is True, result["results"]


def component_ops(result, role) -> list:
    return [o for o in result["history"]
            if o.process == "nemesis" and o.type == "info"
            and isinstance(o.value, list) and o.value
            and o.value[0] == role]


def test_tidb_register_under_tikv_kills(tmp_path):
    """kill-tikv takes storage daemons down and back mid-run while tidb
    keeps serving: the run stays valid and the tikv kill ops are in its
    history."""
    result = run_suite(tmp_path, tidb, "register", keep_nemesis=True,
                       nemesis="kill-tikv", nemesis_interval=0.8)
    assert result["results"]["valid"] is True, result["results"]
    ops = component_ops(result, "tikv")
    assert any(o.value[1] == "killed" for o in ops), ops


def test_galera_dirty_reads_and_percona_bank(tmp_path):
    for module, workload in ((galera, "dirty-reads"), (percona, "bank")):
        result = run_suite(tmp_path / workload, module, workload)
        assert result["results"]["valid"] is True, result["results"]


# ---------------------------------------------------------------------------
# the bundles (TestBundles) and the test maps

def test_workload_selection():
    assert set(galera.workloads({})) == {"bank", "sets", "dirty-reads"}
    assert set(percona.workloads({})) == {"bank", "sets", "dirty-reads"}
    assert set(mysql_cluster.workloads({})) == {"bank", "sets"}
    assert set(tidb.workloads({})) == {"register", "bank", "sets"}


def test_bundle_names():
    t = galera.galera_test({"workload": "bank", "nodes": ["a"],
                            "time_limit": 5})
    assert t["name"] == "galera bank"
    t = tidb.tidb_test({"workload": "register", "nodes": ["a"],
                        "time_limit": 5})
    assert t["name"] == "tidb register"


@pytest.mark.parametrize("module,workload,nem", [
    (galera, "bank", None), (galera, "dirty-reads", "start-kill"),
    (percona, "sets", "majority-ring"), (mysql_cluster, "bank", "kill-ndbd"),
    (mysql_cluster, "sets", "kill-mgmd"), (tidb, "register", None),
    (tidb, "bank", "kill-pd"), (tidb, "sets", "start-kill-2")])
def test_test_maps_match(module, workload, nem):
    name = module.suite.name.replace("-", "_")
    opts = {"workload": workload, "nodes": ["n1", "n2", "n3"],
            "time_limit": 5, **({"nemesis": nem} if nem else {})}
    t = getattr(module, f"{name}_test")(dict(opts))
    j = getattr(JAX[module], f"{name}_test")(dict(opts))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    for k in ("client", "nemesis", "db"):
        assert type(t[k]).__name__ == type(j[k]).__name__, k
    assert type(t["model"]).__name__ == type(j["model"]).__name__
    assert sorted(t["checker"].checker_map) == sorted(
        j["checker"].checker_map)
    assert type(t["checker"].checker_map["workload"]).__name__ == type(
        j["checker"].checker_map["workload"]).__name__
    assert (t["db"].daemon_args(t, "n2") == j["db"].daemon_args(j, "n2"))
    if isinstance(t["db"], mysql_cluster.MysqlClusterDB) or isinstance(
            t["db"], tidb.TidbDB):
        for role in t["db"].ROLES:
            assert t["db"].role_args(t, "n2", role) == j["db"].role_args(
                j, "n2", role)
    assert getattr(t["nemesis"], "role", None) == getattr(j["nemesis"],
                                                          "role", None)


def test_register_checker_takes_the_device():
    t = tidb.tidb_test({"workload": "register", "nodes": ["n1"],
                        "device": "cpu"})
    assert t["checker"].checker_map["workload"].device == "cpu"
    t = tidb.tidb_test({"workload": "register", "nodes": ["n1"]})
    assert t["checker"].checker_map["workload"].device is None


def test_suites_match_the_jax_package():
    """The port's SUITES has every suite of the JAX package, each module
    named as the JAX package names its own, and each loads."""
    assert sorted(SUITES) == sorted(JSUITES)
    for name, mod in SUITES.items():
        assert mod == JSUITES[name].replace("jepsen_tpu.",
                                            "jepsen_tpu_torch.", 1)
        assert importlib.import_module(mod).main


# ---------------------------------------------------------------------------
# the standard nemeses (TestStandardNemeses)

def parallel_setup(db, test, nodes):
    """setup on every node at once, as the engine's db cycle runs it: the
    triple's bring-up waits at each stage for every node's ports."""
    with ThreadPoolExecutor(len(nodes)) as ex:
        for f in [ex.submit(db.setup, test, n) for n in nodes]:
            f.result()


def test_registry_shape():
    from jepsen_tpu_torch.dbs.common import standard_nemeses

    db = tidb.TidbDB(archive_url="file:///x")
    reg = standard_nemeses(db)
    assert set(reg) == {"none", "parts", "majority-ring", "start-stop",
                        "start-kill", "start-kill-2"}
    for name, factory in reg.items():
        assert factory() is not None, name


def test_start_kill_adapter_end_to_end(tmp_path):
    """start kills a bounded subset, stop restarts exactly the dead — on
    a live tidb cluster."""
    from jepsen_tpu_torch.dbs.common import StartKillNemesis

    nodes = ["n1", "n2", "n3"]
    c = tidb_sim.local_cluster(str(tmp_path / "c"), nodes)
    db = tidb.TidbDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": nodes, "tidb": c["tidb"]}
    parallel_setup(db, test, nodes)
    try:
        nem = StartKillNemesis(db, n=1)
        out = nem.invoke(test, Op("nemesis", "invoke", "start", None))
        assert out.f == "start"
        assert list(out.value.values()).count("killed") == 1
        dead = next(n for n, v in out.value.items() if v == "killed")
        out = nem.invoke(test, Op("nemesis", "invoke", "stop", None))
        assert out.f == "stop" and out.value == {dead: "started"}
        for n in nodes:
            db.await_ready(test, n)
    finally:
        for n in nodes:
            db.teardown(test, n)


def test_suite_accepts_nemesis_option():
    from jepsen_tpu_torch.dbs.common import StartKillNemesis

    t = galera.galera_test({"workload": "bank", "nodes": ["a"],
                            "nemesis": "start-kill", "time_limit": 5})
    assert isinstance(t["nemesis"], StartKillNemesis)


# ---------------------------------------------------------------------------
# the tidb triple (TestTidbTriple)

def tidb_up(tmp_path, nodes=("n1", "n2")):
    nodes = list(nodes)
    c = tidb_sim.local_cluster(str(tmp_path / "c"), nodes)
    db = tidb.TidbDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": nodes, "tidb": c["tidb"]}
    parallel_setup(db, test, nodes)
    return db, test, nodes


def pid(db, test, node, role) -> int:
    _, pidf = db._role_files(test, node, role)
    return int(open(pidf).read())


def test_setup_brings_up_three_components(tmp_path):
    db, test, nodes = tidb_up(tmp_path)
    try:
        pids = set()
        for n in nodes:
            for role in tidb.ROLES:
                assert db.component_running(test, n, role), (n, role)
                pids.add(pid(db, test, n, role))
        assert len(pids) == 3 * len(nodes)
        logs = db.log_files(test, nodes[0])
        assert len(logs) == 3 and len(set(logs)) == 3
        # starting a component that runs starts nothing: its launcher
        # (which start-stop-daemon runs in the background) puts the live
        # pid back
        before = pid(db, test, "n1", "tikv")
        db.start_component(test, "n1", "tikv")
        deadline = time.monotonic() + 10
        while pid(db, test, "n1", "tikv") != before:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert db.component_running(test, "n1", "tikv")
    finally:
        for n in nodes:
            db.teardown(test, n)


def test_tikv_killed_while_tidb_lives(tmp_path):
    db, test, nodes = tidb_up(tmp_path)
    try:
        nem = tidb.ComponentKiller(db, "tikv")
        out = nem.invoke(test, Op("nemesis", "invoke", "start", None))
        assert out.value[0:2] == ["tikv", "killed"]
        victim = out.value[2]
        assert not db.component_running(test, victim, "tikv")
        assert db.component_running(test, victim, "tidb")
        assert db.component_running(test, victim, "pd")
        assert db.probe_ready(test, victim)  # SQL still served
        out = nem.invoke(test, Op("nemesis", "invoke", "stop", None))
        assert out.value[0:2] == ["tikv", "restarted"]
        assert db.component_running(test, victim, "tikv")
    finally:
        for n in nodes:
            db.teardown(test, n)


def test_teardown_stops_all_components(tmp_path):
    db, test, nodes = tidb_up(tmp_path)
    for n in nodes:
        db.teardown(test, n)
    for n in nodes:
        for role in tidb.ROLES:
            assert not db.component_running(test, n, role), (n, role)


def test_component_nemeses_registered():
    t = tidb.tidb_test({"workload": "register", "nodes": ["a"],
                        "nemesis": "kill-pd", "time_limit": 5})
    assert isinstance(t["nemesis"], tidb.ComponentKiller)
    assert t["nemesis"].role == "pd"


# ---------------------------------------------------------------------------
# the NDB roles (TestNdbRoles)

def ndb_up(tmp_path, nodes):
    c = mysql_cluster_sim.local_cluster(str(tmp_path / "c"), nodes)
    db = mysql_cluster.MysqlClusterDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": nodes,
            "mysql-cluster": c["mysql-cluster"]}
    parallel_setup(db, test, nodes)
    return db, test


def test_node_id_bands():
    db = mysql_cluster.MysqlClusterDB(archive_url="file:///x")
    t = {"nodes": ["n1", "n2", "n3"]}
    assert db.node_id(t, "n1", "mgmd") == 1
    assert db.node_id(t, "n2", "ndbd") == 12
    assert db.node_id(t, "n3", "mysqld") == 23


def test_ndbd_only_on_first_four():
    db = mysql_cluster.MysqlClusterDB(archive_url="file:///x")
    t = {"nodes": [f"n{i}" for i in range(1, 6)]}
    assert db.role_nodes(t, "ndbd") == ["n1", "n2", "n3", "n4"]
    assert db.role_nodes(t, "mysqld") == t["nodes"]


def test_ndbd_killed_while_mysqld_survives(tmp_path):
    nodes = ["n1", "n2"]
    db, test = ndb_up(tmp_path, nodes)
    try:
        for n in nodes:
            for role in mysql_cluster.ROLES:
                assert db.component_running(test, n, role), (n, role)
        nem = mysql_cluster.ComponentKiller(db, "ndbd")
        out = nem.invoke(test, Op("nemesis", "invoke", "start", None))
        assert out.value[0:2] == ["ndbd", "killed"]
        victim = out.value[2]
        assert not db.component_running(test, victim, "ndbd")
        assert db.component_running(test, victim, "mysqld")
        assert db.component_running(test, victim, "mgmd")
        assert db.probe_ready(test, victim)
        nem.invoke(test, Op("nemesis", "invoke", "stop", None))
        assert db.component_running(test, victim, "ndbd")
    finally:
        for n in nodes:
            db.teardown(test, n)


def test_killer_respects_role_hosting():
    db = mysql_cluster.MysqlClusterDB(archive_url="file:///x")
    t = {"nodes": [f"n{i}" for i in range(1, 6)]}
    nem = mysql_cluster.ComponentKiller(db, "ndbd")
    assert nem._hosts(t) == ["n1", "n2", "n3", "n4"]


def test_full_run_bank_under_ndbd_kills(tmp_path):
    result = run_suite(tmp_path, mysql_cluster, "bank", keep_nemesis=True,
                       nemesis="kill-ndbd", nemesis_interval=0.8)
    assert result["results"]["valid"] is True, result["results"]
    ops = component_ops(result, "ndbd")
    assert any(o.value[1] == "killed" for o in ops), ops


def test_ndb_component_nemeses_registered():
    t = mysql_cluster.mysql_cluster_test({
        "workload": "bank", "nodes": ["a"], "nemesis": "kill-ndbd",
        "time_limit": 5})
    assert isinstance(t["nemesis"], mysql_cluster.ComponentKiller)
    assert t["nemesis"].role == "ndbd"


# ---------------------------------------------------------------------------
# the recipes through the CLI

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


def test_recipe_tidb_register_matches_the_jax_checker(tmp_path,
                                                      monkeypatch):
    """tidb's register as the chip cell runs it, through the recipe's
    CLI (1n workers; its nemesis on the no-op network holds the workers
    10 s): exit 0; the stored history gives the JAX package's
    linearizable dict under CASRegister() (native in both, as "auto" is
    without a card) and, through the card's route (K1's plain version),
    the JAX package's `pallas` dict; every node ran pd, tikv and tidb,
    none of which loaded torch or jax."""
    from jepsen_tpu_torch.ops import wgl_vec

    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = tidb_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(tidb_sim.local_test_fn(c),
                            opt_spec=tidb._opt_spec),
        ["test", "--workload", "register", "--node", "n1", "--node", "n2",
         "--concurrency", "1n", "--time-limit", "3", "--store-dir", sd,
         "--device", "cpu"])
    assert rc == 0
    run_dir, name, res, hist = stored(sd)
    assert name == "tidb register"
    jhist = to_jax(hist)
    want = jchecker.linearizable().check(
        {"model": jmodels.CASRegister()}, jhist, {})
    assert res["workload"] == normalise(want)
    assert res["workload"]["valid"] is True
    assert sum(o.type == "ok" for o in hist) > 10
    lin = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
    monkeypatch.setattr(lin, "_card_present", lambda device: True)
    monkeypatch.setattr(lin, "GPU_BATCH_MIN",
                        {k: 1 for k in lin.GPU_BATCH_MIN})
    monkeypatch.setattr(lin.calibrate, "batch_min",
                        lambda device=None: None)
    monkeypatch.setattr(wgl_vec, "CAPTURE", [])
    got = checker.linearizable(CASRegister(), device="cpu").check(
        {}, hist, {})
    assert len(wgl_vec.CAPTURE) == 1
    assert normalise(got) == normalise(jchecker.linearizable(
        jmodels.CASRegister(), algorithm="pallas").check({}, jhist, {}))
    for n in NODES:
        logs = sorted(glob.glob(os.path.join(run_dir, n, "*.log")))
        assert [p.rsplit("_", 1)[1] for p in logs] == [
            "jepsen-db.log", "jepsen-kv.log", "jepsen-pd.log"], logs
        for p in logs:
            mods = import_profile(open(p).read())
            # pd and tikv run role_sim, which needs no simbase
            assert ("jepsen_tpu_torch.dbs.simbase" in mods) is p.endswith(
                "db.log"), p
            assert "jepsen_tpu_torch.dbs" in mods, p
            assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


@pytest.mark.parametrize("suite,workload", [("galera", "sets"),
                                            ("percona", "dirty-reads"),
                                            ("mysql-cluster", "sets")])
def test_recipe_suites_match_the_jax_checker(tmp_path, suite, workload):
    """galera, percona and mysql-cluster through their recipes'
    constructors at a 0.3-s quiesce (no CLI option has it) and a 1-s
    nemesis interval: the stored history gives the JAX package's
    checker's dict."""
    module = {"galera": galera, "percona": percona,
              "mysql-cluster": mysql_cluster}[suite]
    c = sql_cluster(tmp_path, module, NODES)
    fn = (mysql_cluster_sim if module is mysql_cluster
          else mysql_sim).local_test_fn(c)
    sd = str(tmp_path / "store")
    t = fn({"nodes": NODES, "concurrency": 4, "time_limit": 3,
            "quiesce": 0.3, "nemesis_interval": 1, "workload": workload,
            "store_dir": sd, "device": "cpu"})
    core.run(t)
    _, name, res, hist = stored(sd)
    assert name == f"{suite} {workload}"
    jt = getattr(JAX[module], f"{suite.replace('-', '_')}_test")(
        {"workload": workload, "nodes": NODES})
    want = jt["checker"].checker_map["workload"].check({}, to_jax(hist), {})
    assert res["workload"] == normalise(want)
    assert res["valid"] is True, res
    assert [o.f for o in hist if o.process == "nemesis"][-2:] == ["stop",
                                                                   "stop"]


@pytest.mark.parametrize("suite", ["galera", "tidb", "mysql-cluster"])
def test_recipe_refuses_fs_break(tmp_path, suite):
    module = {"galera": galera, "tidb": tidb,
              "mysql-cluster": mysql_cluster}[suite]
    sim_mod = {"galera": mysql_sim, "tidb": tidb_sim,
               "mysql-cluster": mysql_cluster_sim}[suite]
    c = sql_cluster(tmp_path, module, NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(sim_mod.local_test_fn(c),
                            opt_spec=module._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "c" / "nodes"))


def test_recipe_sets_no_sudo_and_role_ports(tmp_path):
    """The recipes' settings: sudo none, every role's port its own, and
    a cluster rebuilt from a cluster's ports gets the same ports."""
    c = tidb_sim.local_cluster(str(tmp_path / "a"), NODES)
    cfg = c["tidb"]
    assert cfg["sudo"] is None and tidb.suite.sudo({"tidb": cfg}) is None
    ports = [cfg["ports"][n] for n in NODES] + [
        cfg[r][n] for r in tidb_sim.ROLE_PORTS for n in NODES]
    assert len(set(ports)) == 4 * len(NODES)
    again = tidb_sim.local_cluster(str(tmp_path / "b"), NODES,
                                   ports=c["ports"],
                                   role_ports=c["role_ports"])
    assert again["tidb"]["ports"] == cfg["ports"]
    assert all(again["tidb"][r] == cfg[r] for r in tidb_sim.ROLE_PORTS)
    nd = mysql_cluster_sim.local_cluster(str(tmp_path / "n"), NODES)
    assert set(mysql_cluster_sim.ROLE_PORTS) <= set(nd["mysql-cluster"])
    g = mysql_sim.local_cluster(str(tmp_path / "g"), NODES, suite="percona")
    assert g["suite"] == "percona" and g["percona"]["sudo"] is None
