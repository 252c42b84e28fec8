"""The port's postgres-rds suite (dbs/postgres_rds.py) against the JAX
package's, on the cases of tests/test_rds_elasticsearch.py's RDS tests:
the bank client's replies against a pgwire simulator, the same in both
packages (transfers, overdrafts, in-place arithmetic, row locks); the
bank checker's dicts on the same histories; and a full run against the
port's simulator with device="cpu", valid, its recorded history giving
the JAX package's checker's dict. The suite's bank checker runs on the
host and reaches no kernel."""

from __future__ import annotations

import threading

import pytest

from jepsen_tpu.dbs import crdb_sim as jsim
from jepsen_tpu.dbs import postgres_rds as jrds
from jepsen_tpu.history import Op as JOp

from jepsen_tpu_torch import core
from jepsen_tpu_torch.dbs import crdb_sim
from jepsen_tpu_torch.dbs import postgres_rds as rds
from jepsen_tpu_torch.history import Op
from test_torch_workloads import normalise, to_jax


def serve(mod, path, monkeypatch):
    monkeypatch.setattr(mod, "TXN_LOCK_TIMEOUT", 0.5)

    class H(mod.Handler):
        store = mod.Store(path)
        mean_latency = 0.0

    srv = mod.Server(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture
def sims(tmp_path, monkeypatch):
    """(suite module, Op class, port) for the JAX package's client on
    its simulator and the port's on its own."""
    srvs = [serve(jsim, str(tmp_path / "jax.json"), monkeypatch),
            serve(crdb_sim, str(tmp_path / "port.json"), monkeypatch)]
    yield [(jrds, JOp, srvs[0].server_address[1]),
           (rds, Op, srvs[1].server_address[1])]
    for s in srvs:
        s.shutdown()
        s.server_close()


def opts(port, **extra) -> dict:
    return {"nodes": ["rds-endpoint"], "remote": None,
            "postgres_rds": {"addr_fn": lambda n: "127.0.0.1",
                             "ports": {"rds-endpoint": port}},
            "concurrency": 4, **extra}


def bank_replies(mod, op_cls, port, **client) -> list:
    t = opts(port)
    c = mod.BankClient(**client).open(t, "rds-endpoint")
    c.setup(t)
    seq = [("read", None), ("transfer", {"from": 0, "to": 1, "amount": 3}),
           ("read", None), ("transfer", {"from": 0, "to": 1, "amount": 50}),
           ("transfer", {"from": 1, "to": 0, "amount": 4}), ("read", None)]
    out = [(r.type, r.value, r.error) for r in
           (c.invoke(t, op_cls(0, "invoke", f, v)) for f, v in seq)]
    c.close(t)
    return out


@pytest.mark.parametrize("client", [
    dict(n=4, starting_balance=10), dict(n=2, starting_balance=10,
                                         in_place=True),
    dict(n=3, starting_balance=5, lock_type=" for update")])
def test_bank_client_replies_alike(sims, client):
    (jmod, jop, jport), (tmod, top, tport) = sims
    got = bank_replies(tmod, top, tport, **client)
    assert got == bank_replies(jmod, jop, jport, **client)
    assert got[0] == ("ok", [client["starting_balance"]] * client["n"],
                      None)
    assert got[3][0] == "fail" and got[3][2][0] == "negative"
    assert sum(got[-1][1]) == client["n"] * client["starting_balance"]


def read(index, value):
    return [Op(0, "invoke", "read", None, index=index),
            Op(0, "ok", "read", value, index=index + 1)]


CHECKER_CASES = {
    "good": read(0, [10, 10]),
    "wrong_total": read(0, [10, 11]),
    "wrong_n": read(0, [20]),
    "mixed": read(0, [10, 10]) + read(2, [9, 10]) + read(4, [1, 2, 3]),
}


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_bank_checker_matches(case):
    h = CHECKER_CASES[case]
    got = rds.RdsBankChecker(2, 20).check({}, h, {})
    assert normalise(got) == normalise(
        jrds.RdsBankChecker(2, 20).check({}, to_jax(h), {}))
    assert got["valid"] is (case == "good")


def test_suite_surface_matches_the_jax_package():
    j, t = jrds.rds_test({"nodes": ["x"]}), rds.rds_test({"nodes": ["x"]})
    assert sorted(j) == sorted(t)
    assert t["name"] == j["name"] == "postgres-rds bank"
    assert t["db"] is None and t["os"] is None


def test_full_run_matches_the_jax_checker(sims):
    _, (_, _, port) = sims
    t = rds.rds_test(opts(port, time_limit=4, quiesce=0.2, stagger=0.01,
                          device="cpu"))
    result = core.run(t)
    res, hist = result["results"], result["history"]
    assert res["valid"] is True, res
    reads = [o for o in hist if o.type == "ok" and o.f == "read"]
    assert len(reads) > 2 and all(sum(r.value) == 80 for r in reads)
    assert normalise(res["bank"]) == normalise(
        jrds.RdsBankChecker(8, 80).check({}, to_jax(hist), {}))
