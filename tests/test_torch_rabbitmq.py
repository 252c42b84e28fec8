"""The port's rabbitmq suite (codec.py, dbs/amqp_proto.py, amqp_sim.py,
rabbitmq.py) against the JAX package's, on the cases of
tests/test_final_suites.py::TestRabbitMQ: codec round trips from seeded
values give the same bytes; an AMQP 0-9-1 session (handshake, declare,
confirms, publishes, gets with and without auto-ack, reject, purge)
sends the same frames byte for byte and each package's simulator answers
with the same frames; a delivery held unacked is requeued by a reject,
by its connection dying and by a restarted broker; the queue and mutex
clients' taxonomy, the generators and the test maps are the same; the
requeued-semaphore history is refuted by the port's `linearizable(Mutex())`
with the JAX package's dict, through K1's plain version too. Then the
recipe (`amqp_sim.local_test_fn`) through the CLI with device="cpu":
the mutex and queue workloads' stored histories give the JAX package's
checkers' dicts, members load neither torch nor jax, fs-break is
refused."""

from __future__ import annotations

import glob
import json
import os
import random
import time

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import codec as jcodec
from jepsen_tpu import models as jmodels
from jepsen_tpu.dbs import amqp_proto as jaq
from jepsen_tpu.dbs import amqp_sim as jsim
from jepsen_tpu.dbs import rabbitmq as jrmq
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import checker, cli, codec, core, generator as gen
from jepsen_tpu_torch import nemesis, store
from jepsen_tpu_torch.dbs import amqp_proto as aq
from jepsen_tpu_torch.dbs import amqp_sim, rabbitmq
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op, index
from jepsen_tpu_torch.models import Mutex
from test_torch_raftis_logcabin import import_profile, no_heavy, serve
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


# ---------------------------------------------------------------------------
# codec

def seeded_values(seed: int) -> list:
    rng = random.Random(seed)

    def value(depth):
        kind = rng.randrange(7 if depth < 3 else 4)
        if kind == 0:
            return None
        if kind == 1:
            return rng.randrange(-(1 << 60), 1 << 60)
        if kind == 2:
            return rng.choice(["", "é✓", "x" * rng.randrange(9)])
        if kind == 3:
            return rng.random()
        if kind == 4:
            return [value(depth + 1) for _ in range(rng.randrange(4))]
        if kind == 5:
            return tuple(value(depth + 1) for _ in range(rng.randrange(3)))
        return {f"k{i}": value(depth + 1) for i in range(rng.randrange(3))}

    return [value(0) for _ in range(40)]


@pytest.mark.parametrize("seed", range(5))
def test_codec_round_trips_match(seed):
    for v in seeded_values(seed):
        b = codec.encode(v)
        assert b == jcodec.encode(v)
        assert codec.decode(b) == jcodec.decode(b)
        for form in (b, bytearray(b), memoryview(b), b.decode()):
            assert codec.decode(form) == jcodec.decode(form)
    assert codec.encode(None) == b"" and codec.decode(b"") is None
    assert codec.decode(None) is None
    assert codec.decode(codec.encode((1, [2]))) == [1, [2]]


# ---------------------------------------------------------------------------
# AMQP frames, byte for byte, both ways

class Recording:
    """A socket whose bytes, both ways, are appended to `log` as
    ("send", bytes) and ("recv", bytes)."""

    def __init__(self, sock, log):
        self.sock, self.log = sock, log

    def sendall(self, data):
        self.log.append(("send", bytes(data)))
        return self.sock.sendall(data)

    def recv(self, n, *flags):
        data = self.sock.recv(n, *flags)
        self.log.append(("recv", data))
        return data

    def settimeout(self, t):
        self.sock.settimeout(t)

    def close(self):
        self.sock.close()


@pytest.fixture
def sims(tmp_path):
    """(suite module, proto module, port) of the JAX package's AMQP
    broker and the port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(amqp_sim, str(tmp_path / "port.json"))]
    yield [(jrmq, jaq, srvs[0].server_address[1]),
           (rabbitmq, aq, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def session(P, port, monkeypatch) -> tuple:
    """A client session of every method the suite uses: (the results,
    the bytes each way, joined a direction at a time)."""
    import socket as socket_mod

    log = []
    real = socket_mod.create_connection
    monkeypatch.setattr(P.socket, "create_connection",
                        lambda *a, **kw: Recording(real(*a, **kw), log))
    c = P.AmqpConn("127.0.0.1", port)
    c.queue_declare("q", durable=True)
    c.queue_declare("sem", durable=False)
    c.confirm_select()
    out = [c.publish("q", b"one"), c.publish("q", b"two", persistent=False),
           c.publish("q", b""), c.publish("sem", b"tok")]
    out += [c.get("q"), c.get("q"), c.get("q"), c.get("q")]
    tag, body = c.get_unacked("sem")
    out += [(tag, body), c.get_unacked("sem")]
    c.reject(tag, requeue=True)
    for _ in range(50):
        got = c.get_unacked("sem")
        if got is not None:
            break
        time.sleep(0.02)
    out.append(got)
    c.reject(got[0], requeue=False)
    out.append(c.queue_purge("q"))
    c.publish("q", b"x")
    out.append(c.queue_purge("q"))
    c.close()
    monkeypatch.setattr(P.socket, "create_connection", real)
    sent = b"".join(d for way, d in log if way == "send")
    got_b = b"".join(d for way, d in log if way == "recv")
    return out, sent, got_b


def test_session_frames_byte_for_byte(sims, monkeypatch):
    (_, jp, jport), (_, tp, tport) = sims
    got = session(tp, tport, monkeypatch)
    want = session(jp, jport, monkeypatch)
    assert got == want
    out = got[0]
    assert out[:4] == [True, True, True, True]
    assert out[4:8] == [b"one", b"two", b"", None]
    assert out[8][1] == b"tok" and out[9] is None
    assert out[10][1] == b"tok" and out[11:] == [0, 1]
    assert got[1].startswith(b"AMQP\x00\x00\x09\x01")


def test_frame_helpers_match():
    for s in ("", "q", "jepsen.semaphore", "é" * 10):
        assert aq.shortstr(s) == jaq.shortstr(s)
        assert aq.read_shortstr(aq.shortstr(s) + b"z", 0) == \
            jaq.read_shortstr(jaq.shortstr(s) + b"z", 0)
    assert aq.longstr(b"PLAIN") == jaq.longstr(b"PLAIN")
    for name in ("FRAME_METHOD", "FRAME_HEADER", "FRAME_BODY", "FRAME_END",
                 "CONN_START", "CONN_START_OK", "CONN_TUNE", "CONN_TUNE_OK",
                 "CONN_OPEN", "CONN_OPEN_OK", "CONN_CLOSE", "CH_OPEN",
                 "CH_OPEN_OK", "Q_DECLARE", "Q_DECLARE_OK", "Q_PURGE",
                 "Q_PURGE_OK", "BASIC_PUBLISH", "BASIC_GET", "BASIC_GET_OK",
                 "BASIC_GET_EMPTY", "BASIC_ACK", "BASIC_REJECT",
                 "CONFIRM_SELECT", "CONFIRM_SELECT_OK"):
        assert getattr(aq, name) == getattr(jaq, name), name


def test_bad_protocol_header_closes_alike(sims):
    import socket

    for _, _, port in sims:
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(b"AMQP\x00\x00\x08\x00")
            assert s.recv(64) == b""


# ---------------------------------------------------------------------------
# unacked deliveries requeue

def test_unacked_get_reject_requeue(sims):
    """A get without auto-ack holds the message, a reject with requeue
    puts it back, and a dying connection requeues what it held."""
    for _, P, port in sims:
        a = P.AmqpConn("127.0.0.1", port)
        a.queue_declare("sem", durable=True)
        a.confirm_select()
        assert a.publish("sem", b"tok") is True
        tag, body = a.get_unacked("sem")
        assert body == b"tok" and a.get_unacked("sem") is None
        a.reject(tag, requeue=True)
        got = None
        for _ in range(50):
            got = a.get_unacked("sem")
            if got is not None:
                break
            time.sleep(0.02)
        assert got is not None
        a.close()
        b = P.AmqpConn("127.0.0.1", port)
        got = None
        for _ in range(50):
            got = b.get_unacked("sem")
            if got is not None:
                break
            time.sleep(0.05)
        assert got is not None and got[1] == b"tok"
        b.close()


def test_unacked_survives_broker_kill(sims, tmp_path):
    """A held delivery is persisted under a port-prefixed owner token;
    a restarted broker requeues its own orphans (`_recover_unacked`),
    the same store after it as the JAX package's."""
    stores = []
    for (mod, P, port), sim, name in zip(sims, (jsim, amqp_sim),
                                         ("jax.json", "port.json")):
        a = P.AmqpConn("127.0.0.1", port)
        a.queue_declare("sem", durable=True)
        a.confirm_select()
        assert a.publish("sem", b"") is True
        assert a.get_unacked("sem") is not None
        st = sim.Store(str(tmp_path / name))
        data = st.transact(lambda d: (d, None))
        assert [["sem", ""]] in [v for v in data["unacked"].values()]
        assert not data["queues"]["sem"]
        assert sim._recover_unacked(st, port) == 1
        assert sim._recover_unacked(st, port) == 0
        after = st.transact(lambda d: (d, None))
        stores.append((after["queues"], after["unacked"]))
        b = P.AmqpConn("127.0.0.1", port)
        assert b.get_unacked("sem") is not None
        a.close()
        b.close()
    # recovered to the queue's head, before B's get took it again
    assert stores[0] == stores[1] == ({"sem": [""]}, {})


def test_restarting_a_live_broker_keeps_its_held_deliveries(tmp_path):
    """Starting a broker that already runs (the kill nemesis's restart of
    a live node) does nothing: its pid stays, and no second broker's
    start-up recovery requeues the deliveries the live one holds."""
    c = amqp_sim.local_cluster(str(tmp_path / "cluster"), ["n1"])
    db = rabbitmq.RabbitMQDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": ["n1"],
            "rabbitmq": c["rabbitmq"]}
    pidfile = os.path.join(c["rabbitmq"]["dir"]("n1"), db.pid_name)
    db.setup(test, "n1")
    try:
        a = aq.AmqpConn("127.0.0.1", c["ports"]["n1"])
        a.queue_declare("sem")
        a.confirm_select()
        assert a.publish("sem", b"tok") is True
        assert a.get_unacked("sem") is not None
        before = open(pidfile).read()
        db.start(test, "n1")
        time.sleep(1.0)
        db.await_ready(test, "n1")
        assert open(pidfile).read() == before
        b = aq.AmqpConn("127.0.0.1", c["ports"]["n1"])
        assert b.get_unacked("sem") is None  # still held by A
        a.close()
        got = None
        for _ in range(50):
            got = b.get_unacked("sem")
            if got is not None:
                break
            time.sleep(0.05)
        assert got is not None and got[1] == b"tok"
        b.close()
    finally:
        db.teardown(test, "n1")


# ---------------------------------------------------------------------------
# the clients

def cfg(port) -> dict:
    return {"rabbitmq": {"addr_fn": lambda n: "127.0.0.1",
                         "ports": {"n1": port}}}


def client_session(mod, op_cls, port) -> list:
    t = cfg(port)
    out = []
    q = mod.QueueClient().open(t, "n1")
    for f, v in (("enqueue", 5), ("dequeue", None), ("dequeue", None),
                 ("enqueue", [1, "x"]), ("enqueue", 2), ("drain", None)):
        r = q.invoke(t, op_cls(0, "invoke", f, v))
        out.append((r.type, r.value, r.error))
    q.close(t)
    proto = mod.MutexClient()
    a, b = proto.open(t, "n1"), proto.open(t, "n1")
    for c, f in ((a, "acquire"), (a, "acquire"), (b, "acquire"),
                 (b, "release"), (a, "release")):
        r = c.invoke(t, op_cls(0, "invoke", f, None))
        out.append((r.type, r.value, r.error))
    for _ in range(50):
        r = b.invoke(t, op_cls(1, "invoke", "acquire", None))
        if r.type == "ok":
            break
        time.sleep(0.05)
    out.append((r.type, r.value, r.error))
    a.close(t)
    b.close(t)
    return out


def test_clients(sims):
    (jmod, _, jport), (tmod, _, tport) = sims
    got = client_session(tmod, Op, tport)
    assert got == client_session(jmod, JOp, jport)
    assert got[:6] == [("ok", 5, None), ("ok", 5, None),
                       ("fail", None, "exhausted"), ("ok", [1, "x"], None),
                       ("ok", 2, None), ("ok", [[1, "x"], 2], None)]
    assert [g[0] for g in got[6:]] == ["ok", "fail", "fail", "fail", "ok",
                                       "ok"]
    assert got[7][2] == "already-held" and got[8][2] == "empty"
    assert got[9][2] == "not-held"


class Failing:
    """An AMQP connection whose every call but `close` raises `exc`."""

    def __init__(self, exc):
        self.exc = exc

    def close(self):
        pass

    def __getattr__(self, name):
        def fail(*a, **kw):
            raise self.exc
        return fail


@pytest.mark.parametrize("kind", ["amqp", "timeout", "reset"])
def test_error_taxonomy(kind):
    """rabbitmq.clj's taxonomy: every queue op `info` on an error (a
    drain keeps what it had); a mutex acquire that errs `fail` (and
    reconnects), a release `ok` either way (a dead channel requeues)."""
    import socket

    out = []
    for mod, P, op_cls in ((rabbitmq, aq, Op), (jrmq, jaq, JOp)):
        exc = {"amqp": P.AmqpError("connection closed (320): x"),
               "timeout": socket.timeout("timed out"),
               "reset": ConnectionResetError(104, "reset")}[kind]
        got = []
        for f in ("enqueue", "dequeue", "drain"):
            r = mod.QueueClient(Failing(exc)).invoke(
                {}, op_cls(0, "invoke", f, 1))
            got.append((f, r.type, r.value, r.error))
        m = mod.MutexClient(Failing(exc))
        m._addr = ("127.0.0.1", free_port())
        r = m.invoke({}, op_cls(0, "invoke", "acquire", None))
        got.append(("acquire", r.type, r.value, r.error))
        m.tag, m.conn = 3, Failing(exc)
        r = m.invoke({}, op_cls(0, "invoke", "release", None))
        got.append(("release", r.type, r.value, r.error, m.tag))
        out.append(got)
    assert out[0] == out[1]
    types = {g[0]: g[1] for g in out[0]}
    assert types == {"enqueue": "info", "dequeue": "info", "drain": "info",
                     "acquire": "fail", "release": "ok"}
    assert out[0][2][2] == [] and out[0][-1][-1] is None


def test_generators_and_test_maps():
    for mod in (rabbitmq, jrmq):
        g = mod.mutex_gen()
        fs = [g.op({"concurrency": 1, "nodes": NODES}, 0) for _ in range(4)]
        assert [o["f"] for o in fs if isinstance(o, dict)][:2] == [
            "acquire", "release"]
    for opts in ({}, {"workload": "mutex"}, {"workload": "mutex",
                                             "time_limit": 100},
                 {"workload": "mutex", "mutex_delay": 0.5},
                 {"nemesis": "start-kill"}):
        base = {"nodes": NODES, **opts}
        t = rabbitmq.rabbitmq_test(dict(base))
        j = jrmq.rabbitmq_test(dict(base))
        assert sorted(t) == sorted(j) and t["name"] == j["name"]
        assert type(t["client"]).__name__ == type(j["client"]).__name__
        assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
        assert sorted(t["checker"].checker_map) == sorted(
            j["checker"].checker_map)
    t = rabbitmq.rabbitmq_test({"nodes": NODES, "workload": "mutex",
                                "device": "cpu"})
    lin = t["checker"].checker_map["linear"]
    assert lin.device == "cpu" and isinstance(lin.model, Mutex)


# ---------------------------------------------------------------------------
# the requeued semaphore: an invalid Mutex history

def requeued_history(port) -> list:
    """TestRabbitMQ.test_mutex_partition_anomaly_caught's history: A
    acquires, A's connection dies, the broker requeues, B acquires."""
    t = cfg(port)
    proto = rabbitmq.MutexClient()
    a, b = proto.open(t, "n1"), proto.open(t, "n1")
    hist = []

    def record(process, c, f):
        hist.append(Op(process, "invoke", f, None))
        hist.append(c.invoke(t, Op(process, "invoke", f, None)))
        return hist[-1]

    assert record(0, a, "acquire").type == "ok"
    a.conn.close()
    got = None
    for _ in range(50):
        got = b.conn.get_unacked(rabbitmq.SEMAPHORE)
        if got is not None:
            break
        time.sleep(0.05)
    assert got is not None
    b.conn.reject(got[0], requeue=True)
    assert record(1, b, "acquire").type == "ok"
    b.close(t)
    return index(hist)


@pytest.mark.parametrize("card", [False, True])
def test_requeued_semaphore_refuted(sims, monkeypatch, card):
    """The broker's requeue of a dead holder's delivery gives a second
    acquire with no release between: `linearizable(Mutex())` refutes it
    with the JAX package's dict, on the host (against the JAX package's
    "auto") and, with every bar at 1 and the card present, through K1's
    plain version in one launch, as chip_smoke.py's
    suites_rabbitmq_requeued checks it on the card (against the JAX
    package's Pallas engine, K1's twin)."""
    import importlib

    from jepsen_tpu_torch.ops import wgl_vec

    (_, _, _), (_, _, port) = sims
    hist = requeued_history(port)
    if card:
        lin = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
        monkeypatch.setattr(lin, "_card_present", lambda device: True)
        monkeypatch.setattr(lin, "GPU_BATCH_MIN",
                            {k: 1 for k in lin.GPU_BATCH_MIN})
        monkeypatch.setattr(lin.calibrate, "batch_min",
                            lambda device=None: None)
        monkeypatch.setattr(wgl_vec, "CAPTURE", [])
    got = checker.linearizable(Mutex(), device="cpu").check({}, hist, {})
    want = jchecker.linearizable(
        jmodels.Mutex(), algorithm="pallas" if card else "auto").check(
        {}, to_jax(hist), {})
    assert got["valid"] is False and got["op"], got
    assert normalise(got) == normalise(want)
    if card:
        assert len(wgl_vec.CAPTURE) == 1


# ---------------------------------------------------------------------------
# the recipe through the CLI

def recipe_run(tmp_path, *argv):
    c = amqp_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(amqp_sim.local_test_fn(c),
                            opt_spec=rabbitmq._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "2",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu", *argv])
    runs = [os.path.realpath(d)
            for d in glob.glob(os.path.join(sd, "*", "latest"))]
    return rc, runs


def stored(run_dir):
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    return res, store.load_history({
        "name": os.path.basename(os.path.dirname(run_dir)),
        "start_time": os.path.basename(run_dir),
        "store_dir": os.path.dirname(os.path.dirname(run_dir))})


def test_recipe_mutex_matches_the_jax_checker(tmp_path, monkeypatch):
    """The mutex workload through the recipe (partitions recorded and
    healed on the no-op network; the workers last the nemesis's first
    5-s sleep, one op a second each): exit 0, valid, the stored
    history's linearizable dict the JAX package's; members load neither
    torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    rc, (run_dir,) = recipe_run(tmp_path, "--workload", "mutex")
    assert rc == 0
    res, hist = stored(run_dir)
    assert os.path.basename(os.path.dirname(run_dir)) == "rabbitmq mutex"
    assert res["linear"]["valid"] is True, res["linear"]
    assert [o for o in hist if o.f == "acquire" and o.type == "ok"]
    want = jchecker.linearizable(jmodels.Mutex()).check(
        {}, to_jax(hist), {})
    assert res["linear"] == normalise(want)
    logs = glob.glob(os.path.join(run_dir, "n*", "*rabbitmq.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.amqp_proto" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_queue_matches_the_jax_checker(tmp_path):
    """The default (queue) workload through the recipe: confirmed
    publishes, auto-ack gets, the heal, the 10-s quiesce, the drain; the
    stored history's total-queue dict the JAX package's, and the exit
    code its verdict's."""
    rc, (run_dir,) = recipe_run(tmp_path)
    res, hist = stored(run_dir)
    assert os.path.basename(os.path.dirname(run_dir)) == "rabbitmq queue"
    assert any(o.f == "drain" and o.type == "ok" for o in hist)
    want = jchecker.total_queue().check({}, to_jax(hist), {})
    assert res["queue"] == normalise(want)
    assert rc == (1 if res["valid"] is False else 0)


def test_full_run_mutex_without_faults(tmp_path):
    """TestRabbitMQ.test_full_run_mutex on the recipe's cluster: without
    faults the single-token discipline is linearizable, in both
    packages' checkers."""
    c = amqp_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    t = amqp_sim.local_test_fn(c)({
        "nodes": NODES, "workload": "mutex", "mutex_delay": 0.05,
        "concurrency": 4, "time_limit": 6, "device": "cpu"})
    t["nemesis"] = nemesis.noop
    t["generator"] = gen.time_limit(6, gen.clients(
        gen.limit(80, gen.delay(0.02, rabbitmq.mutex_gen()))))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    assert [o for o in hist if o.f == "acquire" and o.type == "ok"]
    want = jchecker.linearizable(jmodels.Mutex()).check(
        {}, to_jax(hist), {})
    assert normalise(res["linear"]) == normalise(want)


def test_recipe_refuses_fs_break(tmp_path):
    rc, runs = recipe_run(tmp_path, "--nemesis", "fs-break")
    assert rc == 254 and runs == []
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
