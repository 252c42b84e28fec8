"""The port's dgraph suite (dbs/dgraph.py, dgraph_workloads.py,
dgraph_nemesis.py, dgraph_sim.py) against the JAX package's, on the
cases of tests/test_dgraph_txn.py, tests/test_dgraph_workloads.py,
tests/test_dgraph_nemesis.py and tests/test_final_suites.py::TestDgraph:
the same request sequence against both packages' simulators gives the
same replies (snapshot reads, 409 on write-write and upsert-index
conflicts, /state and /moveTablet); the clients give the same
completions, the checkers the same dicts on the same history, the
nemesis generators the same ops, the tablet mover the same moves under
one seed and the clock skew the same clock calls. Also the recipe
(`dgraph_sim.local_test_fn`) through the CLI with `--tracing`: the span
file, the skew recorded, fs-break refused, and member processes that
load neither torch nor jax. The full runs are in
tests/test_torch_dgraph_runs.py."""

from __future__ import annotations

import glob
import json
import os
import random
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from jepsen_tpu import generator as jgen
from jepsen_tpu.dbs import dgraph as jdgraph
from jepsen_tpu.dbs import dgraph_nemesis as jdn
from jepsen_tpu.dbs import dgraph_sim as jsim
from jepsen_tpu.dbs import dgraph_workloads as jdw
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.nemesis import time as jnt

from jepsen_tpu_torch import cli, generator as gen
from jepsen_tpu_torch import txn as mop
from jepsen_tpu_torch.dbs import dgraph, dgraph_nemesis as dn, dgraph_sim
from jepsen_tpu_torch.dbs import dgraph_workloads as dw
from jepsen_tpu_torch.dbs.simbase import RecordingClockTools
from jepsen_tpu_torch.history import Op
from test_torch_workloads import normalise, to_jax

JAX = {"dgraph": jdgraph, "dw": jdw, "dn": jdn, "sim": jsim, "Op": JOp,
       "gen": jgen}
PORT = {"dgraph": dgraph, "dw": dw, "dn": dn, "sim": dgraph_sim, "Op": Op,
        "gen": gen}


def serve(sim, path):
    class H(sim.Handler):
        store = sim.Store(path)
        mean_latency = 0.0

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sims(tmp_path):
    """(package, port) for the JAX package's simulator and the port's,
    each on a fresh store."""
    srvs = [serve(jsim, str(tmp_path / "jax.json")),
            serve(dgraph_sim, str(tmp_path / "port.json"))]
    yield [(JAX, srvs[0].server_address[1]),
           (PORT, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def both(sims, fn):
    """fn(package, port) on both simulators; the port's result, which
    must equal the JAX package's."""
    (jp, jport), (tp, tport) = sims
    want, got = fn(jp, jport), fn(tp, tport)
    assert normalise(got) == normalise(want)
    return got


def raised(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return "none"


# ---------------------------------------------------------------------------
# the transaction layer (tests/test_dgraph_txn.py's nine cases)

def txn_commit_is_atomic_and_visible(p, conn):
    with p["dgraph"].with_txn(conn) as t:
        t.mutate(sets=[{"key": 1, "value": 10}, {"key": 2, "value": 20}])
    rows = conn.query("{ q(func: has(key)) { uid key value } }")
    assert sorted(r["value"] for r in rows) == [10, 20]
    return rows


def txn_discard_leaves_nothing(p, conn):
    t = conn.txn()
    staged = t.mutate(sets=[{"key": 9, "value": 9}])
    t.discard()
    rows = conn.query("{ q(func: eq(key, 9)) { uid } }")
    assert rows == []
    return [staged, t.start_ts, rows]


def txn_snapshot_reads_stay_at_start_ts(p, conn):
    conn.mutate([{"key": 1, "value": 1}])
    t = conn.txn()
    out = [t.query("{ q(func: eq(key, 1)) { value } }")]
    conn.mutate([{"key": 5, "value": 5}])
    out += [t.query("{ q(func: eq(key, 5)) { value } }"),
            conn.query("{ q(func: eq(key, 5)) { value } }")]
    t.commit()
    assert out == [[{"value": 1}], [], [{"value": 5}]]
    return out + [t.start_ts]


def txn_write_write_conflict(p, conn):
    uid = list(conn.mutate([{"key": 1, "value": 0}]).values())[0]
    t1, t2 = conn.txn(), conn.txn()
    t1.query("{ q(func: eq(key, 1)) { uid value } }")
    t2.query("{ q(func: eq(key, 1)) { uid value } }")
    t1.mutate(sets=[{"uid": uid, "value": 1}])
    t2.mutate(sets=[{"uid": uid, "value": 2}])
    t1.commit()
    err = raised(t2.commit)
    rows = conn.query("{ q(func: eq(key, 1)) { value } }")
    assert err == "TxnConflict" and rows == [{"value": 1}]
    return [uid, err, rows, t1.start_ts, t2.start_ts]


def txn_upsert_index_conflict(p, conn):
    conn.alter("key: int @index(int) @upsert .")
    t1, t2 = conn.txn(), conn.txn()
    t1.mutate(sets=[{"key": 7}])
    t2.mutate(sets=[{"key": 7}])
    t1.commit()
    err = raised(t2.commit)
    rows = conn.query("{ q(func: eq(key, 7)) { uid } }")
    assert err == "TxnConflict" and len(rows) == 1
    return [err, rows]


def txn_disjoint_writes_do_not_conflict(p, conn):
    conn.alter("key: int @index(int) @upsert .")
    u1 = list(conn.mutate([{"key": 1, "value": 3, "type": "x"}]).values())[0]
    u2 = list(conn.mutate([{"key": 2, "value": 3, "type": "x"}]).values())[0]
    t1, t2 = conn.txn(), conn.txn()
    t1.mutate(sets=[{"uid": u1, "value": 9}])
    t2.mutate(sets=[{"uid": u2, "value": 9}])
    t1.commit()
    t2.commit()
    rows = conn.query("{ q(func: has(value)) { value } }")
    assert [r["value"] for r in rows] == [9, 9]
    return [u1, u2, rows]


def txn_delete(p, conn):
    uid = list(conn.mutate([{"key": 3, "value": 3}]).values())[0]
    with p["dgraph"].with_txn(conn) as t:
        t.mutate(dels=[{"uid": uid}])
    rows = conn.query("{ q(func: eq(key, 3)) { uid } }")
    assert rows == []
    return [uid, rows]


def txn_conflict_as_fail(p, conn):
    op = p["Op"](0, "invoke", "write", 5)

    def body():
        raise p["dgraph"].TxnConflict("Transaction has been aborted.")

    done = p["dgraph"].with_conflict_as_fail(op, body)
    assert done.type == "fail" and done.error == "conflict"
    return [done.type, done.error, done.value]


def txn_zero_state_and_move_tablet(p, conn):
    conn.mutate([{"key": 1, "value": 1}])
    with urllib.request.urlopen(conn.base + "/state") as resp:
        before = json.load(resp)
    tablets = [t for g in before["groups"].values()
               for t in g.get("tablets", {})]
    assert set(tablets) >= {"key", "value"}
    req = urllib.request.Request(conn.base + "/moveTablet?tablet=key&group=2",
                                 method="POST", data=b"{}")
    with urllib.request.urlopen(req) as resp:
        moved = json.load(resp)
    assert moved["data"]["code"] == "Success"
    with urllib.request.urlopen(conn.base + "/state") as resp:
        after = json.load(resp)
    assert "key" in after["groups"]["2"]["tablets"]
    with urllib.request.urlopen(conn.base + "/health") as resp:
        health = json.load(resp)
    return [before, moved, after, health]


TXN_CASES = [txn_commit_is_atomic_and_visible, txn_discard_leaves_nothing,
             txn_snapshot_reads_stay_at_start_ts, txn_write_write_conflict,
             txn_upsert_index_conflict, txn_disjoint_writes_do_not_conflict,
             txn_delete, txn_conflict_as_fail,
             txn_zero_state_and_move_tablet]


@pytest.mark.parametrize("case", TXN_CASES, ids=lambda c: c.__name__)
def test_txn_layer_replies_alike(sims, case):
    both(sims, lambda p, port: case(
        p, p["dgraph"].DgraphConn("127.0.0.1", port)))


def raw_replies(p, port) -> list:
    """Raw HTTP replies (status, JSON body) of one request sequence:
    alter, one-shot and staged mutates, an upsert block whose condition
    fails, snapshot and legacy queries, a conflicting commit (409), an
    abort, a bad query (400), bad JSON, unknown routes, /state."""
    base = f"http://127.0.0.1:{port}"

    def call(path, body=None, raw=None):
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        req = urllib.request.Request(base + path, data=data,
                                     method="GET" if data is None
                                     else "POST")
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                return [resp.status, json.load(resp)]
        except urllib.error.HTTPError as e:
            return [e.code, json.load(e)]

    q = "{ q(func: eq(key, 4)) { uid key value } }"
    return [
        call("/alter", {"schema": "key: int @index(int) @upsert ."}),
        call("/mutate", {"set": [{"key": 4, "value": 1}]}),
        call("/query?startTs=0", {"query": q}),
        call("/mutate?startTs=0&commitNow=false",
             {"set": [{"key": 4, "value": 2}]}),
        call("/mutate?startTs=0&commitNow=false",
             {"set": [{"key": 4, "value": 3}]}),
        call("/commit?startTs=4", {}),
        call("/commit?startTs=5", {}),
        call("/query", {"query": q}),
        call("/mutate", {"set": [{"key": 4}],
                         "query": "{ v(func: eq(key, 4)) { uid } }",
                         "cond": "@if(eq(len(v), 0))"}),
        call("/mutate?startTs=0&commitNow=false",
             {"delete": [{"uid": "0x1"}]}),
        call("/commit?startTs=8&abort=true", {}),
        call("/mutate?startTs=0&commitNow=true",
             {"set": [{"big": (1 << 63) - 1}, {"big": 9007199254740993}]}),
        call("/query", {"query": "{ q(func: has(big)) { uid big } }"}),
        call("/query", {"query": "nonsense"}),
        call("/mutate", raw=b"{not json"),
        call("/nowhere", {}),
        call("/nowhere"),
        call("/state"),
        call("/health"),
    ]


def test_simulators_reply_alike_raw(sims):
    got = both(sims, raw_replies)
    assert got[5][0] == 200 and got[6][0] == 409
    assert got[13][0] == 400 and got[14][0] == 400
    assert [r[0] for r in got[15:17]] == [404, 404]


def test_sim_helpers_match():
    for q in ("{ q(func: eq(value, 5)) { uid value } }",
              "{ q(func: has(key_1)) { uid key_1 amount_1 } }",
              '{ q(func: eq(type_0, "account")) { uid } }',
              "{ q(func: uid(0x1f)) { int64 } }"):
        assert dgraph_sim.parse_func(q) == jsim.parse_func(q)
    for v in (0, 42, 1 << 53, (1 << 53) + 1, (1 << 63) - 1, -(1 << 63),
              3 * ((1 << 63) - 1), -3 * ((1 << 63) - 1), 1.5, True, "x"):
        assert dgraph_sim.json_number(v) == jsim.json_number(v)
    assert dgraph_sim.json_number((1 << 63) - 1) == -(1 << 63)
    touched = {"0x1": {"key": 7, "value": 1}, "0x2": None}
    assert dgraph_sim.conflict_keys(touched, {"key"}) == \
        jsim.conflict_keys(touched, {"key"})
    data = {"nodes": {"0x1": [[1, {"a": 1}], [3, {"a": 2}]],
                      "0x2": [[2, {"b": 1}], [4, None]]}}
    for ts in range(6):
        assert dgraph_sim.snapshot(data, ts, {"0x3": {"c": 1}}) == \
            jsim.snapshot(data, ts, {"0x3": {"c": 1}})


# ---------------------------------------------------------------------------
# clients and checkers (tests/test_dgraph_workloads.py,
# tests/test_final_suites.py::TestDgraph)

def tmap(port, **extra):
    return {"dgraph": {"addr_fn": lambda n: "127.0.0.1",
                       "ports": {"n1": port}}, **extra}


def done(op):
    return [op.type, op.value, op.error]


def bank_client(p, port):
    t = tmap(port, accounts=[0, 1, 2], total_amount=30)
    c = p["dw"].BankClient().open(t, "n1")
    c.setup(t)
    Op = p["Op"]
    out = [done(c.invoke(t, Op(0, "invoke", f, v))) for f, v in (
        ("read", None), ("transfer", {"from": 0, "to": 1, "amount": 7}),
        ("read", None), ("transfer", {"from": 2, "to": 0, "amount": 5}),
        ("transfer", {"from": 1, "to": 2, "amount": 7}), ("read", None))]
    assert out[0][0] == "ok" and sum(out[0][1].values()) == 30
    assert out[2][1][1] == 7 and sum(out[2][1].values()) == 30
    assert out[3][:3:2] == ["fail", "insufficient-funds"]
    # account 1 hit zero -> deleted -> absent from the read
    assert out[5][1] == {0: 23, 2: 7}
    return out


def delete_client(p, port):
    t = tmap(port)
    c = p["dw"].DeleteClient().open(t, "n1")
    Op = p["Op"]
    out = [done(c.invoke(t, Op(0, "invoke", f, (3, None))))
           for f in ("read", "upsert", "upsert", "read", "delete",
                     "delete", "read")]
    assert out[1][0] == "ok" and out[2][::2] == ["fail", "present"]
    assert len(out[3][1][1]) == 1 and set(out[3][1][1][0]) == {"uid", "key"}
    assert out[4][0] == "ok" and out[5][::2] == ["fail", "not-found"]
    return out


def sequential_client(p, port):
    t = tmap(port)
    c = p["dw"].SequentialClient().open(t, "n1")
    Op = p["Op"]
    out = [done(c.invoke(t, Op(0, "invoke", f, (1, None))))
           for f in ("read", "inc", "inc", "read")]
    assert [tuple(o[1]) for o in out] == [(1, 0), (1, 1), (1, 2), (1, 2)]
    return out


def lr_client(p, port):
    t = tmap(port)
    c = p["dw"].LrClient().open(t, "n1")
    Op = p["Op"]
    out = [done(c.invoke(t, Op(0, "invoke", f, v))) for f, v in (
        ("read", (5, None)), ("write", (5, 3)), ("read", (5, None)),
        ("cas", (5, (9, 4))), ("cas", (5, (3, 4))), ("read", (5, None)))]
    assert tuple(out[2][1]) == (5, 3) and tuple(out[5][1]) == (5, 4)
    assert out[3][::2] == ["fail", "value-mismatch"] and out[4][0] == "ok"
    return out


def long_fork_client(p, port):
    t = tmap(port)
    c = p["dw"].LongForkClient().open(t, "n1")
    Op = p["Op"]
    w = c.invoke(t, Op(0, "invoke", "write", [[mop.WRITE, 0, 1]]))
    r = c.invoke(t, Op(0, "invoke", "read",
                       [[mop.READ, 0, None], [mop.READ, 1, None]]))
    assert w.type == "ok" and r.type == "ok"
    assert r.value == [[mop.READ, 0, 1], [mop.READ, 1, None]]
    return [done(w), done(r)]


def types_client(p, port):
    t = tmap(port)
    c = p["dw"].TypesClient().open(t, "n1")
    Op = p["Op"]
    out = []
    for v in (42, 9007199254740993, (1 << 63) - 1):
        w = c.invoke(t, Op(0, "invoke", "write", [None, "int64", v]))
        r = c.invoke(t, Op(0, "invoke", "read", [w.value[0], "int64", None]))
        out += [done(w), done(r)]
    assert out[1][1][2] == 42
    # Go-JSON float64 decoding: 2^53 + 1 comes back rounded
    assert out[3][1][2] == int(float(9007199254740993))
    assert out[5][1][2] == -(1 << 63)
    assert c.entities == [(o[1][0], "int64") for o in out[::2]]
    return out


def uid_lr_client(p, port):
    t = tmap(port)
    c = p["dw"].UidLrClient().open(t, "n1")
    Op = p["Op"]
    out = [done(c.invoke(t, Op(0, "invoke", f, v))) for f, v in (
        ("read", (5, None)), ("cas", (5, (1, 2))), ("write", (5, 3)),
        ("read", (5, None)), ("cas", (5, (3, 4))), ("read", (5, None)))]
    assert tuple(out[0][1]) == (5, None)
    assert out[1][::2] == ["fail", "not-found"]
    assert tuple(out[3][1]) == (5, 3) and tuple(out[5][1]) == (5, 4)
    return out


def uid_lr_lost_race(p, port):
    t = tmap(port)
    proto = p["dw"].UidLrClient()
    c1, c2 = proto.open(t, "n1"), proto.open(t, "n1")
    with p["dw"].with_txn(c1.conn) as tx1:
        u1 = next(iter(tx1.mutate(sets=[{"value": 1}]).values()))
    with p["dw"].with_txn(c2.conn) as tx2:
        u2 = next(iter(tx2.mutate(sets=[{"value": 2}]).values()))
    assert proto.uids.setdefault(9, u1) == u1
    assert proto.uids.setdefault(9, u2) == u1
    r = c2.invoke(t, p["Op"](1, "invoke", "read", (9, None)))
    assert tuple(r.value) == (9, 1)
    return [u1, u2, done(r)]


def set_client(p, port):
    t = tmap(port)
    c = p["dgraph"].SetClient().open(t, "n1")
    Op = p["Op"]
    out = [done(c.invoke(t, Op(0, "invoke", "add", v))) for v in (3, 1, 2)]
    r = c.invoke(t, Op(0, "invoke", "read", None))
    assert r.type == "ok" and r.value == [1, 2, 3]
    return out + [done(r)]


def upsert_races_one_winner(p, port):
    t = tmap(port)
    c1 = p["dgraph"].UpsertClient().open(t, "n1")
    c2 = p["dgraph"].UpsertClient().open(t, "n1")
    Op = p["Op"]
    r1 = c1.invoke(t, Op(0, "invoke", "upsert", 7))
    r2 = c2.invoke(t, Op(1, "invoke", "upsert", 7))
    assert sorted([r1.type, r2.type]) == ["fail", "ok"]
    read = c1.invoke(t, Op(0, "invoke", "read", 7))
    k, uids = read.value
    assert k == 7 and len(uids) == 1
    return [done(r1), done(r2), done(read)]


def dead_node_taxonomy(p, port):
    """Every client against a node that answers nothing: reads fail,
    writes are indeterminate."""
    from jepsen_tpu_torch.dbs.simbase import free_port

    t = tmap(port)
    t["dgraph"]["ports"]["dead"] = free_port()
    Op = p["Op"]
    out = []
    for cls, ops in ((p["dw"].LrClient, [("read", (1, None)),
                                         ("write", (1, 2))]),
                     (p["dw"].SequentialClient, [("read", (1, None)),
                                                 ("inc", (1, None))])):
        c = cls(p["dgraph"].DgraphConn(
            "127.0.0.1", t["dgraph"]["ports"]["dead"], timeout=0.5))
        out += [c.invoke(t, Op(0, "invoke", f, v)).type for f, v in ops]
    assert out == ["fail", "info", "fail", "info"]
    return out


CLIENT_CASES = [bank_client, delete_client, sequential_client, lr_client,
                long_fork_client, types_client, uid_lr_client,
                uid_lr_lost_race, set_client, upsert_races_one_winner,
                dead_node_taxonomy]


@pytest.mark.parametrize("case", CLIENT_CASES, ids=lambda c: c.__name__)
def test_clients_complete_alike(sims, case):
    both(sims, case)


def test_acct_row_parser_and_type_cases():
    for row in ({"uid": "0x1", "key_1": 1, "amount_1": 5},
                {"uid": "0x2", "key_0": 3}, {"uid": "0x3"}):
        assert dw._acct_row_to_key_amount(row) == \
            jdw._acct_row_to_key_amount(row)
    with pytest.raises(AssertionError):
        dw._acct_row_to_key_amount({"key_0": 1, "key_1": 2})
    cases = dw.type_cases()
    assert cases == jdw.type_cases()
    values = {v for _, v in cases}
    assert {(1 << 63) - 1, 9007199254740993, 3 * ((1 << 63) - 1)} <= values
    assert {a for a, _ in cases} == {"foo", "int64"}
    assert dw.gen_preds("key") == jdw.gen_preds("key")
    assert dw.gen_pred("amount", 7) == jdw.gen_pred("amount", 7)


def hist(*rows):
    return [Op(p, t, f, v, index=i) for i, (p, t, f, v) in enumerate(rows)]


CHECKS = {
    "delete": (dw.DeleteChecker(), jdw.DeleteChecker(), {"history_key": 3}, [
        hist((0, "ok", "read", (3, [{"uid": "0x1", "key": 3}])),
             (0, "ok", "read", (3, []))),
        hist((0, "ok", "read", (3, [{"uid": "0x1"}]))),
        hist((0, "ok", "read", (3, [{"uid": "0x1", "key": 3},
                                    {"uid": "0x2", "key": 3}])))]),
    "sequential": (dw.SequentialChecker(), jdw.SequentialChecker(), {}, [
        hist((0, "ok", "read", (1, 1)), (0, "ok", "read", (1, 2)),
             (1, "ok", "read", (1, 1))),
        hist((0, "ok", "read", (1, 1)), (0, "ok", "read", (1, 2)),
             (1, "ok", "read", (1, 1)), (0, "ok", "read", (1, 1)))]),
    "types": (dw.TypesChecker(), jdw.TypesChecker(), {}, [
        hist((0, "ok", "write", ["0x1", "foo", 5]),
             (0, "ok", "read", ["0x1", "foo", 5])),
        hist((0, "ok", "write", ["0x1", "foo", 9007199254740993]),
             (0, "ok", "read", ["0x1", "foo", 9007199254740992])),
        hist((0, "ok", "write", ["0x1", "foo", 5])),
        hist((0, "ok", "write", ["0x1", "foo", 5]),
             (0, "ok", "read", ["0x1", "foo", 5]),
             (1, "ok", "read", ["0x1", "foo", 7])),
        hist((0, "ok", "write", ["0x1", "foo", 5]),
             (1, "ok", "write", ["0x1", "foo", 6]),
             (0, "ok", "read", ["0x1", "foo", 5]))]),
    "upsert": (dgraph.UpsertChecker(), jdgraph.UpsertChecker(), {}, [
        hist((0, "invoke", "upsert", 1), (0, "ok", "upsert", 1),
             (1, "invoke", "upsert", 1), (1, "fail", "upsert", 1)),
        hist((0, "invoke", "upsert", 1), (0, "ok", "upsert", 1),
             (1, "invoke", "upsert", 1), (1, "ok", "upsert", 1)),
        hist((0, "ok", "read", (4, ["0x1", "0x2"])))]),
}

WANT_VALID = {"delete": [True, False, False], "sequential": [True, False],
              "types": [True, False, "unknown", False, False],
              "upsert": [True, False, False]}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_checkers_match_the_jax_package(name):
    tc, jc, opts, hists = CHECKS[name]
    valids = []
    for h in hists:
        got = tc.check({}, h, dict(opts))
        assert normalise(got) == normalise(jc.check({}, to_jax(h),
                                                    dict(opts)))
        valids.append(got["valid"])
    assert valids == WANT_VALID[name]


def test_non_monotonic_pairs_match():
    h = hist((0, "ok", "inc", (1, 1)), (1, "ok", "read", (1, 1)),
             (0, "ok", "read", (1, 0)), (1, "ok", "inc", 3),
             (1, "ok", "read", 2), (0, "info", "read", (1, None)))
    assert normalise(dw.non_monotonic_pairs(h)) == normalise(
        jdw.non_monotonic_pairs(to_jax(h)))
    assert len(dw.non_monotonic_pairs(h)) == 2


# ---------------------------------------------------------------------------
# the nemeses (tests/test_dgraph_nemesis.py)

def drain(p, g, n=20):
    out = []
    for _ in range(n):
        o = p["gen"].op(g, {"nodes": ["n1"]}, "nemesis")
        if o is None:
            break
        out.append(o)
    return out


@pytest.mark.parametrize("flags", [
    {"kill_alpha": True, "interval": 0},
    {"move_tablet": True, "interval": 0},
    {"partition_ring": True, "fix_alpha": True, "interval": 0},
    {}])
def test_full_generator_matches(flags):
    random.seed(5)
    want = [] if not jdn.full_generator(flags) else drain(
        JAX, jdn.full_generator(flags), 8)
    random.seed(5)
    g = dn.full_generator(flags)
    got = [] if g is None else drain(PORT, g, 8)
    assert got == want
    if flags.get("kill_alpha"):
        assert [o["f"] for o in got[:4]] == ["kill-alpha", "restart-alpha",
                                              "kill-alpha", "restart-alpha"]
    assert (g is None) == (not flags)


def test_final_generator_and_skews_match():
    flags = {"kill_alpha": True, "partition_ring": True, "skew_clock": True,
             "final_delay": 0}
    got = drain(PORT, dn.final_generator(flags))
    assert got == drain(JAX, jdn.final_generator(flags))
    assert [o["f"] for o in got] == ["stop-partition-ring", "stop-skew",
                                     "restart-alpha"]
    assert dn.final_generator({}) is None
    assert dn.SKEWS == jdn.SKEWS
    assert dn.skew({"skew": "huge"}).dt_ms == 7500
    assert dn.skew({"skew": "tiny"}).dt_ms == 100
    assert dn.skew({}).dt_ms == 0


def test_full_nemesis_routes_match():
    flags = {"kill_alpha": True, "kill_zero": True, "fix_alpha": True,
             "move_tablet": True, "partition_halves": True,
             "partition_ring": True, "skew_clock": True, "skew": "big"}
    tn = dn.full_nemesis(dgraph.DgraphDB(), flags)
    jn = jdn.full_nemesis(jdgraph.DgraphDB(), flags)
    names = [sorted(type(n).__name__ for n in x.nemeses.values())
             for x in (tn, jn)]
    assert names[0] == names[1]
    assert [sorted(map(str, k)) for k in tn.nemeses] == [
        sorted(map(str, k)) for k in jn.nemeses]
    assert dn.package(dgraph.DgraphDB(), {}) is None
    pkg = dn.package(dgraph.DgraphDB(), {"move_tablet": True})
    assert sorted(pkg) == ["final_generator", "generator", "nemesis"]


def test_tablet_mover_moves_alike(sims):
    def move(p, port):
        conn = p["dgraph"].DgraphConn("127.0.0.1", port)
        conn.mutate([{"key": 1, "value": 2, "other": 3}])
        test = tmap(port, nodes=["n1"])
        mover = p["dn"].TabletMover(p["dgraph"]._suite)
        random.seed(11)
        moves = []
        for _ in range(6):
            d = mover.invoke(test, p["Op"]("nemesis", "info",
                                           "move-tablet", None))
            assert d.type == "info"
            moves.append(d.value)
        state = mover._get_state(test, "n1")
        for mv in moves:
            for pred, (frm, to) in mv.items():
                assert frm != to, (pred, frm, to)
        return [moves, state]

    got = both(sims, move)
    assert any(got[0]), "nothing moved in 6 invocations"


def test_skew_goes_to_the_clock_tools_as_the_jax_package_calls_nt(
        monkeypatch):
    """BumpTimeSkew's setup, start, stop and teardown: the port's calls on
    the test map's clock tools equal the JAX package's calls of
    nemesis/time.py's functions (stubbed to record), on one node and one
    seed; with no clock tools the port calls nemesis/time.py's."""
    jcalls = []
    monkeypatch.setattr(jnt, "bring_up", lambda test: jcalls.extend(
        (n, "bring_up", ()) for n in test["nodes"]))
    monkeypatch.setattr(jnt, "bump_time", lambda r, n, dt: jcalls.append(
        (n, "bump_time", (dt,))))
    monkeypatch.setattr(jnt, "try_reset", lambda r, n: jcalls.append(
        (n, "try_reset", ())))
    tcalls = []
    runs = []
    for p, test in ((JAX, {"nodes": ["n1"], "remote": None}),
                    (PORT, {"nodes": ["n1"], "remote": None,
                            "clock_tools": RecordingClockTools(tcalls)})):
        random.seed(2)
        nem = p["dn"].BumpTimeSkew(250).setup(test)
        Op_ = p["Op"]
        vals = [nem.invoke(test, Op_("nemesis", "info", f, None)).value
                for f in ("start", "start", "start", "stop")]
        nem.teardown(test)
        runs.append(vals)
    assert runs[0] == runs[1] and tcalls == jcalls
    assert ("n1", "bump_time", (250,)) in tcalls
    with pytest.raises(ValueError):
        dn.BumpTimeSkew(1).invoke({"nodes": [], "remote": None,
                                   "clock_tools": RecordingClockTools([])},
                                  Op("nemesis", "info", "frob", None))
    from jepsen_tpu_torch.nemesis import time as nt

    seen = []
    monkeypatch.setattr(nt, "try_reset", lambda r, n: seen.append(n))
    dn.BumpTimeSkew(1).teardown({"nodes": ["n1", "n2"], "remote": None})
    assert seen == ["n1", "n2"]


def test_suite_surface_matches_the_jax_package():
    for wl in ("set", "upsert", "bank", "delete", "sequential",
               "linearizable-register", "uid-linearizable-register",
               "long-fork", "types"):
        for flags in ({}, {"kill_alpha": True, "move_tablet": True}):
            opts = {"nodes": ["n1", "n2"], "workload": wl, **flags}
            j = jdgraph.dgraph_test(dict(opts))
            t = dgraph.dgraph_test({**opts, "device": "cpu"})
            assert sorted(k for k in j if k != "device") == sorted(
                k for k in t if k != "device"), wl
            assert t["name"] == j["name"] == f"dgraph {wl}"
            assert type(t["client"]).__name__ == type(j["client"]).__name__
            assert type(t["nemesis"]).__name__ == type(
                j["nemesis"]).__name__
    assert sorted(dgraph.workloads({"nodes": ["n1"]})) == sorted(
        jdgraph.workloads({"nodes": ["n1"]}))
    import argparse

    specs = []
    for mod in (dgraph, jdgraph):
        p = argparse.ArgumentParser()
        mod._opt_spec(p)
        specs.append(sorted((a.dest, a.default, tuple(a.choices or ()))
                            for a in p._actions))
    assert specs[0] == specs[1]
    assert sorted(dgraph.main.__code__.co_names) == sorted(
        jdgraph.main.__code__.co_names)


# ---------------------------------------------------------------------------
# the recipe through the CLI

def test_recipe_cli_run_traces_records_skew_and_members_load_no_jax(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    nodes = ["n1", "n2"]
    c = dgraph_sim.local_cluster(str(tmp_path / "cluster"), nodes)
    sd, spans = str(tmp_path / "store"), str(tmp_path / "spans.jsonl")
    rc = cli.run_cli(
        cli.single_test_cmd(dgraph_sim.local_test_fn(c),
                            opt_spec=dgraph._opt_spec),
        ["test", "--node", "n1", "--node", "n2", "--concurrency", "4n",
         "--time-limit", "3", "--store-dir", sd, "--device", "cpu",
         "--workload", "linearizable-register", "--tracing", spans,
         "--skew-clock", "--skew", "tiny", "--interval", "0.5"])
    from jepsen_tpu_torch import trace

    trace.tracing(None)
    assert rc == 0
    (run_dir,) = [os.path.realpath(d) for d in
                  glob.glob(os.path.join(sd, "*", "latest"))]
    with open(os.path.join(run_dir, "results.json")) as f:
        res = json.load(f)
    assert res["register"]["valid"] is True, res["register"]
    lines = [json.loads(ln) for ln in open(spans)]
    ids = {s["spanID"] for s in lines}
    assert all(s["parentSpanID"] is None or s["parentSpanID"] in ids
               for s in lines)
    assert all(list(s) == ["traceID", "spanID", "parentSpanID",
                           "operationName", "startTime", "duration", "logs",
                           "tags", "process"] for s in lines)
    from jepsen_tpu_torch import store

    hist = store.load_history({"name": os.path.basename(
        os.path.dirname(run_dir)), "start_time": os.path.basename(run_dir),
        "store_dir": sd})
    completed = sum(1 for o in hist if isinstance(o.process, int)
                    and o.type != "invoke")
    assert sum(s["operationName"].startswith("dgraph.client/")
               for s in lines) >= completed > 0
    calls = c["clock_calls"]
    assert {n for n, f, _ in calls if f == "bring_up"} == set(nodes)
    # a start-skew bumps each node with probability 1/2 (BumpTimeSkew,
    # nemesis.clj:88-112, as in the JAX package): its completion reports
    # {node: ms} (its invocation, type info too, carries no value); every
    # node a completed one reports bumped has its bump_time(100)
    # recorded, and no other clock bump is recorded
    skews = [o.value for o in hist
             if o.f == "start-skew" and isinstance(o.value, dict)]
    bumped = [n for v in skews for n, dt in sorted(v.items()) if dt]
    recorded = [n for n, f, a in calls if f == "bump_time"]
    assert all(a == (100,) for _, f, a in calls if f == "bump_time"), calls
    assert all(dt in (0, 100) for v in skews for dt in v.values()), skews
    assert all(recorded.count(n) >= bumped.count(n) for n in nodes), (
        skews, calls)
    assert any(f == "try_reset" for _, f, _ in calls)
    logs = glob.glob(os.path.join(run_dir, "n*", "*dgraph.log"))
    assert len(logs) == 2
    for p in logs:
        mods = {ln.rsplit("|", 1)[1].strip() for ln in open(p)
                if ln.startswith("import time:") and "|" in ln}
        assert "jepsen_tpu_torch.dbs.simbase" in mods, p
        bad = {m for m in mods
               if m.split(".")[0] in ("jax", "jepsen_tpu", "torch")}
        assert not bad, (p, sorted(bad))


def test_recipe_refuses_fs_break(tmp_path):
    c = dgraph_sim.local_cluster(str(tmp_path / "cluster"), ["n1"])
    rc = cli.run_cli(
        cli.single_test_cmd(dgraph_sim.local_test_fn(c),
                            opt_spec=dgraph._opt_spec),
        ["test", "--node", "n1", "--nemesis", "fs-break", "--time-limit",
         "3", "--store-dir", str(tmp_path / "store"), "--device", "cpu"])
    assert rc == 254
    assert not os.path.exists(str(tmp_path / "cluster" / "nodes"))
