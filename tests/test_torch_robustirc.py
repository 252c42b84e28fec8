"""The port's robustirc suite (dbs/robustirc_sim.py, robustirc.py)
against the JAX package's, on the cases of
tests/test_final_suites.py::TestRobustIrc: sessions and messages, the
per-session at-most-once message ids, the TOPIC set client and a full
run on simulated nodes. Then parity: the same session API calls against
both packages' simulators give the same statuses and bodies (session ids
and auth tokens aside), the topic parsing and the client's taxonomy are
the same, the test maps are the same, and the recipe
(`robustirc_sim.local_test_fn`) through the CLI, its stored history
giving the JAX package's set-checker dict, its members loading neither
torch nor jax."""

from __future__ import annotations

import glob
import http.client
import json
import os
import random
import socket
import threading
import urllib.error
from http.server import ThreadingHTTPServer

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu.dbs import robustirc as jirc
from jepsen_tpu.dbs import robustirc_sim as jsim
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import cli, core, nemesis, store
from jepsen_tpu_torch.dbs import robustirc, robustirc_sim
from jepsen_tpu_torch.dbs.simbase import free_port
from jepsen_tpu_torch.history import Op
from test_torch_raftis_logcabin import import_profile, no_heavy
from test_torch_workloads import normalise, to_jax

NODES = ["n1", "n2"]


def serve(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0

        def log_message(self, fmt, *args):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def irc_port(tmp_path):
    srv = serve(robustirc_sim, str(tmp_path / "irc.json"))
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def sims(tmp_path):
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(robustirc_sim, str(tmp_path / "port.json"))]
    yield [(jirc, JOp, srvs[0].server_address[1]),
           (robustirc, Op, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def irc_map(port) -> dict:
    return {"robustirc": {"addr_fn": lambda n: "127.0.0.1",
                          "ports": {"n1": port}}}


# ---------------------------------------------------------------------------
# TestRobustIrc

def test_session_and_messages(irc_port):
    s = robustirc.RobustSession(irc_map(irc_port), "n1")
    s.post_message("NICK a")
    s.post_message("TOPIC #jepsen :7")
    assert any(m["Data"] == "TOPIC #jepsen :7" for m in s.read_all())


def test_duplicate_message_ids_deduplicated(irc_port):
    s = robustirc.RobustSession(irc_map(irc_port), "n1")
    for _ in range(2):
        s._request("POST", f"/{s.session_id}/message",
                   body={"Data": "TOPIC #jepsen :1", "ClientMessageId": 42},
                   auth=True)
    topics = [m for m in s.read_all() if m["Data"].startswith("TOPIC")]
    assert len(topics) == 1


def test_set_client(irc_port):
    t = irc_map(irc_port)
    c = robustirc.SetClient().open(t, "n1")
    for v in (1, 2, 3):
        assert c.invoke(t, Op(0, "invoke", "add", v)).type == "ok"
    r = c.invoke(t, Op(0, "invoke", "read", None))
    assert r.type == "ok" and r.value == [1, 2, 3]


def test_full_run(tmp_path):
    """The suite at its generator (a set of TOPIC adds, then every
    client's final read) on simulated nodes; the history's set dict the
    JAX package's."""
    c = robustirc_sim.local_cluster(str(tmp_path / "c"), NODES)
    t = robustirc.robustirc_test({
        "nodes": NODES, "remote": c["remote"],
        "archive_url": c["archive_url"], "robustirc": c["robustirc"],
        "concurrency": 2, "time_limit": 3, "quiesce": 0.2, "stagger": 0.02})
    t.update({"os": None, "net": None, "nemesis": nemesis.noop})
    result = core.run(t)
    assert result["results"]["valid"] is True, result["results"]
    want = jchecker.set_checker().check({}, to_jax(result["history"]), {})
    assert normalise(result["results"]["set"]) == normalise(want)


# ---------------------------------------------------------------------------
# parity

def calls(port) -> list:
    """A scripted session against one simulator: (status, body) with each
    session's random id and token replaced by its ordinal."""
    out, sessions = [], []
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=5)

    def call(method, path, body=None, auth=None):
        headers = {"Content-Type": "application/json"}
        if auth is not None:
            headers["X-Session-Auth"] = auth
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        c.request(method, "/robustirc/v1" + path if path[0] == "/" else path,
                  body=data, headers=headers)
        r = c.getresponse()
        got = json.loads(r.read() or b"null")
        if isinstance(got, dict) and "Sessionid" in got:
            sessions.append((got["Sessionid"], got["Sessionauth"]))
            got = {**got, "Sessionid": len(sessions) - 1,
                   "Sessionauth": len(sessions) - 1}
        if isinstance(got, list):
            ids = {s: i for i, (s, _) in enumerate(sessions)}
            got = [{**m, "Session": ids.get(m["Session"])} for m in got]
        out.append((r.status, got))

    try:
        call("POST", "/session", b"")
        call("POST", "/session", b"")
        (a, auth_a), (b, auth_b) = sessions
        call("POST", f"/{a}/message", {"Data": "NICK a",
                                       "ClientMessageId": 1}, auth_a)
        call("POST", f"/{a}/message", {"Data": "TOPIC #jepsen :5",
                                       "ClientMessageId": 2}, auth_a)
        call("POST", f"/{a}/message", {"Data": "TOPIC #jepsen :5",
                                       "ClientMessageId": 2}, auth_a)
        call("POST", f"/{b}/message", {"Data": "TOPIC #jepsen :6",
                                       "ClientMessageId": 2}, auth_b)
        call("POST", f"/{b}/message", {"Data": "TOPIC #jepsen :7"}, auth_b)
        call("POST", f"/{b}/message", {"Data": "x"}, "wrong")
        call("POST", f"/{b}/message", b"{bad", auth_b)
        call("GET", f"/{a}/messages", None, auth_a)
        call("GET", f"/{b}/messages", None, "wrong")
        call("GET", "/nowhere")
        call("POST", "/elsewhere", b"")
    finally:
        c.close()
    return out


def test_simulators_reply_alike(sims):
    (_, _, jport), (_, _, port) = sims
    got = calls(port)
    assert got == calls(jport)
    assert [s for s, _ in got] == [200, 200, 200, 200, 200, 200, 200, 401,
                                   400, 200, 401, 404, 404]
    assert [m["Data"] for m in got[9][1]] == [
        "NICK a", "TOPIC #jepsen :5", "TOPIC #jepsen :6", "TOPIC #jepsen :7"]


def test_topic_parsing_matches():
    rng = random.Random(7)
    datas = ["TOPIC #jepsen :3", ":srv TOPIC #jepsen :12", "NICK n1",
             "TOPIC #jepsen :x", "", "TOPIC", ":a TOPIC #c :-4",
             "PRIVMSG #jepsen :TOPIC 9"]
    datas += [rng.choice(["TOPIC #jepsen :", ":p TOPIC #j :", "JOIN :"])
              + str(rng.randrange(-50, 50)) for _ in range(40)]
    for d in datas + [None]:
        m = {"Data": d}
        assert robustirc.filter_topic(m) == jirc.filter_topic(m)
        assert robustirc.extract_topic(m) == jirc.extract_topic(m)


class Raising:
    def __init__(self, exc):
        self.exc = exc

    def post_message(self, line):
        raise self.exc

    def read_all(self):
        raise self.exc


@pytest.mark.parametrize("kind", ["timeout", "refused", "http"])
def test_client_taxonomy_matches(kind):
    got = []
    for mod, cls in ((robustirc, Op), (jirc, JOp)):
        exc = {"timeout": socket.timeout("timed out"),
               "refused": urllib.error.URLError(
                   ConnectionRefusedError(111, "refused")),
               "http": urllib.error.HTTPError("u", 401, "bad session", {},
                                              None)}[kind]
        c = mod.SetClient(Raising(exc))
        got.append([(r.type, r.error) for r in (
            c.invoke({}, cls(0, "invoke", f, 1)) for f in ("add", "read"))])
    assert got[0] == got[1]
    assert [t for t, _ in got[0]] == ["info", "fail"]


def test_dead_node_refuses_at_open():
    t = irc_map(free_port())
    for mod in (robustirc, jirc):
        with pytest.raises(urllib.error.URLError):
            mod.SetClient().open(t, "n1")


@pytest.mark.parametrize("opts", [{}, {"nemesis": "start-kill"},
                                  {"nemesis": "majority-ring"}])
def test_robustirc_test_maps_match(opts):
    base = {"nodes": ["n1", "n2", "n3"], "time_limit": 5, **opts}
    t, j = robustirc.robustirc_test(dict(base)), jirc.robustirc_test(
        dict(base))
    assert sorted(t) == sorted(j) and t["name"] == j["name"]
    for k in ("nemesis", "client", "db"):
        assert type(t[k]).__name__ == type(j[k]).__name__, k
    for n in base["nodes"]:
        assert t["db"].daemon_args(t, n) == j["db"].daemon_args(j, n)
    assert sorted(t["checker"].checker_map) == sorted(
        j["checker"].checker_map)


def test_recipe_cli_run_and_members_load_no_jax(tmp_path, monkeypatch):
    """The suite at its defaults through the recipe's CLI (its nemesis on
    the no-op network holds the workers 10 s; then a 10-s quiesce and the
    final reads): exit 0, the stored history giving the JAX package's set
    dict; members load neither torch nor jax."""
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    c = robustirc_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    sd = str(tmp_path / "store")
    t = robustirc_sim.local_test_fn(c)({
        "nodes": NODES, "concurrency": 2, "time_limit": 3, "quiesce": 0.2,
        "store_dir": sd, "device": "cpu"})
    core.run(t)
    (run_dir,) = [os.path.realpath(d)
                  for d in glob.glob(os.path.join(sd, "*", "latest"))]
    res = json.load(open(os.path.join(run_dir, "results.json")))
    hist = store.load_history({"name": "robustirc set",
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    want = jchecker.set_checker().check({}, to_jax(hist), {})
    assert res["set"] == normalise(want)
    assert res["set"]["valid"] is True and res["set"]["ok_count"] > 5
    assert [o.f for o in hist if o.process == "nemesis"][-2:] == ["stop",
                                                                   "stop"]
    logs = glob.glob(os.path.join(run_dir, "n*", "*robustirc.log"))
    assert len(logs) == 2
    for p in logs:
        mods = import_profile(open(p).read())
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        assert not no_heavy(mods), (p, sorted(no_heavy(mods)))


def test_recipe_refuses_fs_break(tmp_path):
    c = robustirc_sim.local_cluster(str(tmp_path / "cluster"), NODES)
    rc = cli.run_cli(
        cli.single_test_cmd(robustirc_sim.local_test_fn(c),
                            opt_spec=robustirc._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
