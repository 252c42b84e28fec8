"""The port's disque suite (dbs/disque.py, on the port's redis_sim.py
and redis_proto.py) against the JAX package's, on the cases of
tests/test_consul_disque_raftis.py::TestDisque: the client's ADDJOB /
GETJOB + ACKJOB session against both packages' simulators gives the same
results; its determinacy taxonomy (an empty poll a definite `fail`,
every connection or protocol error `info`, a drain keeping what it had
acked), the generator and the test maps are the same; the DB joins its
nodes to the primary with CLUSTER MEET. Then the recipe
(`disque.local_test_fn`) through the CLI with device="cpu": the stored
history's total-queue dict the JAX package's, members that load neither
torch nor jax, fs-break refused; and a run bounded by op count valid in
both packages' checkers."""

from __future__ import annotations

import glob
import json
import os
import socket

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu.dbs import disque as jdisque
from jepsen_tpu.dbs import redis_proto as jresp
from jepsen_tpu.dbs import redis_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, generator as gen, nemesis, store
from jepsen_tpu_torch.dbs import disque, redis_proto, redis_sim
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy, serve
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


@pytest.fixture
def sims(tmp_path):
    """(suite module, port) of the JAX package's RESP simulator and the
    port's, each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(redis_sim, str(tmp_path / "port.json"))]
    yield [(jdisque, srvs[0].server_address[1]),
           (disque, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def cfg(port) -> dict:
    return {"disque": {"addr_fn": lambda n: "127.0.0.1",
                       "ports": {"n1": port}}}


def session(mod, op_cls, port) -> list:
    t = cfg(port)
    c = mod.DisqueClient().open(t, "n1")
    out = []
    for f, v in (("enqueue", 1), ("enqueue", 2), ("dequeue", None),
                 ("drain", None), ("dequeue", None), ("enqueue", 3),
                 ("enqueue", 4), ("drain", None), ("drain", None)):
        r = c.invoke(t, op_cls(0, "invoke", f, v))
        out.append((r.type, r.value, r.error))
    c.close(t)
    return out


def test_client_session(sims):
    (jmod, jport), (tmod, tport) = sims
    got = session(tmod, Op, tport)
    assert got == session(jmod, JOp, jport)
    assert got[:2] == [("ok", 1, None), ("ok", 2, None)]
    assert got[2] == ("ok", 1, None) and got[3] == ("ok", [2], None)
    assert got[4] == ("fail", None, "empty")
    assert got[7:] == [("ok", [3, 4], None), ("ok", [], None)]


class Raising:
    """A RESP connection behind a reconnect wrapper whose calls raise
    `exc` from the `after`-th on."""

    def __init__(self, exc, after=0):
        self.exc, self.after, self.n = exc, after, 0

    def call(self, *args):
        self.n += 1
        if self.n > self.after:
            raise self.exc
        if args[0] == "GETJOB":
            return [["jepsen", f"D-{self.n}", str(self.n).encode()]]
        return "OK"

    def with_conn(self):
        outer = self

        class Ctx:
            def __enter__(self):
                return outer

            def __exit__(self, *a):
                return False

        return Ctx()

    def close(self):
        pass


@pytest.mark.parametrize("kind", ["resp", "timeout", "reset", "closed"])
def test_error_taxonomy(kind):
    """disque.clj's taxonomy: enqueue and dequeue `info` on any error;
    a drain that fails part way `info` with the values it had acked."""
    out = []
    for mod, P, op_cls in ((disque, redis_proto, Op),
                           (jdisque, jresp, JOp)):
        exc = {"resp": P.RespError("ERR boom"),
               "timeout": socket.timeout("timed out"),
               "reset": ConnectionResetError(104, "reset"),
               "closed": ConnectionError("resp connection closed")}[kind]
        got = []
        for f in ("enqueue", "dequeue"):
            r = mod.DisqueClient(Raising(exc)).invoke(
                {}, op_cls(0, "invoke", f, 1))
            got.append((r.type, r.value, r.error))
        # two jobs taken and acked (four calls), then the fault
        r = mod.DisqueClient(Raising(exc, after=4)).invoke(
            {}, op_cls(0, "invoke", "drain", None))
        got.append((r.type, r.value, r.error))
        out.append(got)
    assert out[0] == out[1]
    assert [g[0] for g in out[0]] == ["info", "info", "info"]
    assert out[0][2][1] == [1, 3]


def test_generator_and_test_maps():
    for mod in (disque, jdisque):
        g = mod.queue_gen()
        vals = []
        while len(vals) < 3:
            o = g.op({"nodes": NODES, "concurrency": 1}, 0)
            if isinstance(o, dict) and o["f"] == "enqueue":
                vals.append(o["value"])
        assert vals == [0, 1, 2]
    for opts in ({}, {"nemesis": "start-kill"}, {"nemesis": "none"},
                 {"nemesis": "majority-ring"}):
        base = {"nodes": NODES, **opts}
        t = disque.disque_test(dict(base))
        j = jdisque.disque_test(dict(base))
        assert sorted(t) == sorted(j) and t["name"] == j["name"] == "disque"
        assert type(t["nemesis"]).__name__ == type(j["nemesis"]).__name__
        assert sorted(t["checker"].checker_map) == ["perf", "queue"]
        for n in NODES:
            assert t["db"].daemon_args(t, n) == j["db"].daemon_args(j, n)


def test_db_joins_the_primary(tmp_path):
    """DisqueDB's setup through the recipe's cluster: every node up, the
    others CLUSTER MEET the primary, members share the job store."""
    c = disque.local_cluster(str(tmp_path / "cluster"), NODES)
    db = disque.DisqueDB(archive_url=c["archive_url"])
    test = {"remote": c["remote"], "nodes": NODES, "disque": c["disque"]}
    try:
        for n in NODES:
            db.setup(test, n)
        a = redis_proto.RespConn("127.0.0.1", c["ports"]["n1"])
        b = redis_proto.RespConn("127.0.0.1", c["ports"]["n2"])
        a.call("ADDJOB", "q", "7", 100)
        got = b.call("GETJOB", "TIMEOUT", 100, "COUNT", 1, "FROM", "q")
        assert got[0][2] == b"7"
        a.close()
        b.close()
    finally:
        for n in NODES:
            db.teardown(test, n)


def recipe_run(tmp_path, *argv):
    c = disque.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    rc = cli.run_cli(
        cli.single_test_cmd(disque.local_test_fn(c),
                            opt_spec=disque._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "2",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu", *argv])
    runs = [os.path.realpath(d)
            for d in glob.glob(os.path.join(sd, "*", "latest"))]
    return rc, runs


def test_recipe_matches_the_jax_checker(tmp_path, monkeypatch):
    """The suite at its defaults through the recipe (partitions recorded
    and healed on the no-op network, the workers held by the nemesis's
    first 10-s sleep; the heal, the suite's 10-s quiesce, the drain):
    the stored history's total-queue dict the JAX package's and the exit
    code its verdict's; members load neither torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    rc, (run_dir,) = recipe_run(tmp_path)
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    hist = store.load_history({
        "name": "disque", "start_time": os.path.basename(run_dir),
        "store_dir": str(tmp_path / "store")})
    assert any(o.f == "drain" and o.type == "ok" for o in hist)
    assert [o for o in hist if o.f == "enqueue" and o.type == "ok"]
    want = jchecker.total_queue().check({}, to_jax(hist), {})
    assert res["queue"] == normalise(want)
    assert rc == (1 if res["valid"] is False else 0)
    logs = glob.glob(os.path.join(run_dir, "n*", "*disque.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_full_run_bounded_by_op_count(tmp_path):
    """TestDisque.test_full_run on the recipe's cluster: bounded by op
    count (an op in flight at a time limit is abandoned while its
    GETJOB + ACKJOB lands), valid, the total-queue dict the JAX
    package's."""
    c = disque.local_cluster(str(tmp_path / "cluster"), NODES)
    t = disque.local_test_fn(c)({"nodes": NODES, "concurrency": 4,
                                 "time_limit": 4, "device": "cpu"})
    t["nemesis"] = nemesis.noop
    t["generator"] = gen.phases(
        gen.time_limit(8, gen.clients(
            gen.limit(150, gen.stagger(0.01, disque.queue_gen())))),
        gen.sleep(1.5),
        gen.clients(gen.each(
            lambda: gen.once({"type": "invoke", "f": "drain"}))))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    want = jchecker.total_queue().check({}, to_jax(hist), {})
    assert normalise(res["queue"]) == normalise(want)


def test_recipe_refuses_fs_break(tmp_path):
    rc, runs = recipe_run(tmp_path, "--nemesis", "fs-break")
    assert rc == 254 and runs == []
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
