"""The port's test runner (`jepsen_tpu_torch.core.run`/`resume`, its
workers, and `testlib`'s in-process backend) against the JAX package:
the cases of tests/test_core.py through the port's `core.run` on
`testlib.cas_test` (FlakyClient, `algorithm="host"`, `device="cpu"`);
each history the port recorded, checked by the JAX checker and by the
port's, gives the same dict; one worker on the same seeded FlakyClient
gives the same process ids and op types in both packages; and each
package reads the other's store and run checkpoint."""

import importlib
import json
import os
import random
import threading
import time

import pytest

from jepsen_tpu import core as jcore
from jepsen_tpu import generator as jgen
from jepsen_tpu import store as jstore
from jepsen_tpu import testlib as jtl
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable
from jepsen_tpu.history import Op as JOp
from jepsen_tpu_torch import cli, core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import history as hist_mod
from jepsen_tpu_torch import nemesis as nemesis_mod
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import linearizable
from jepsen_tpu_torch.device import CudaUnavailable
from jepsen_tpu_torch.models import cas_register
from jepsen_tpu_torch.testlib import (AtomClient, FlakyClient, SharedAtom,
                                      cas_test, noop_test)


@pytest.fixture(autouse=True)
def _port_store(tmp_path, monkeypatch):
    """The port's store root in the test's tmp dir, beside the JAX
    package's (tests/conftest.py)."""
    monkeypatch.setattr(store, "BASE_DIR", str(tmp_path / "store"))


def normalise(d):
    """A result dict as JSON carries it, less the JAX package's
    supervisor telemetry (the port has no supervisor)."""
    d = json.loads(json.dumps(d, default=str))
    if isinstance(d, dict):
        d.pop("supervision", None)
    return d


def to_jax(history):
    return [JOp(o.process, o.type, o.f, o.value, o.time, o.index, o.error,
                dict(o.extra)) for o in history]


def port_test(**kw):
    """cas_test with the port's checker on the CPU (the host search)."""
    t = cas_test(kw.pop("state", None) or SharedAtom())
    t["checker"] = linearizable(algorithm="host", device="cpu")
    t["device"] = "cpu"
    t.update(kw)
    return t


def same_verdicts(test):
    """The port's results equal a check of its history by the JAX
    package's checker and by a fresh port checker."""
    hist = test["history"]
    j = jlinearizable(jtl.cas_test()["model"], algorithm="host").check(
        {}, to_jax(hist), {})
    t = linearizable(test["model"], algorithm="host", device="cpu").check(
        {}, hist, {})
    assert normalise(t) == normalise(j)
    assert normalise(test["results"]) == normalise(t)


def test_full_engine_run():
    state = SharedAtom()
    test = core.run(port_test(state=state))
    assert test["results"]["valid"] is True, test["results"]
    hist = test["history"]
    assert len(hist) > 50
    assert [o.index for o in hist] == list(range(len(hist)))
    assert any(o.is_invoke for o in hist)
    assert state.value == "done"
    same_verdicts(test)


@pytest.mark.parametrize("crash_p", [0.15, 0.2])
def test_history_valid_under_crashes(crash_p):
    state = SharedAtom()
    test = core.run(port_test(state=state,
                              client=FlakyClient(state, crash_p=crash_p)))
    assert test["results"]["valid"] is True, test["results"]
    hist = test["history"]
    assert [o for o in hist if o.is_info and o.process != "nemesis"]
    procs = {o.process for o in hist if isinstance(o.process, int)}
    assert any(p >= test["concurrency"] for p in procs)
    # no process invokes twice without completing
    hist_mod.pairs([o for o in hist if isinstance(o.process, int)])
    same_verdicts(test)


def _seeded_run(pkg, tl, seed):
    """One worker, one node, the same seeded FlakyClient and op stream."""
    random.seed(seed)
    state = tl.SharedAtom()
    t = tl.cas_test(state, client=tl.FlakyClient(state, crash_p=0.3,
                                                 seed=seed))
    t.update({"nodes": ["n1"], "concurrency": 1, "name": None,
              "generator": pkg.generator.clients(
                  pkg.generator.limit(40, pkg.generator.cas))})
    return [(o.process, o.type, o.f, o.value, o.error)
            for o in pkg.core.run(t)["history"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_seed_same_processes_and_types(seed):
    import jepsen_tpu
    import jepsen_tpu_torch
    from jepsen_tpu_torch import testlib as ttl

    for pkg in (jepsen_tpu, jepsen_tpu_torch):
        importlib.import_module(pkg.__name__ + ".core")
    j = _seeded_run(jepsen_tpu, jtl, seed)
    t = _seeded_run(jepsen_tpu_torch, ttl, seed)
    assert t == j
    assert any(p >= 1 for p, *_ in t), "expected a reincarnated process"


def test_generator_exception_propagates():
    class BoomGen(gen.Generator):
        def op(self, test, process):
            raise RuntimeError("generator boom")

    test = noop_test()
    test.update({"name": None, "generator": gen.clients(BoomGen()),
                 "nodes": ["n1"]})
    with pytest.raises(RuntimeError, match="generator boom"):
        core.run(test)


def test_client_open_failure_records_fail_ops():
    class BrokenClient(AtomClient):
        def __init__(self, state, budget):
            super().__init__(state)
            self.opens = 0
            self.budget = budget
            self.lock = threading.Lock()

        def open(self, test, node):
            with self.lock:
                self.opens += 1
                if self.opens > self.budget:
                    raise RuntimeError("cannot reconnect")
            return self

        def close(self, test):
            pass

        def invoke(self, test, op):
            raise RuntimeError("connection lost")

    state = SharedAtom()
    test = port_test(state=state)
    test["client"] = BrokenClient(state, budget=len(test["nodes"]))
    test["generator"] = gen.clients(gen.limit(10, gen.cas))
    hist = core.run(test)["history"]
    assert [o for o in hist if o.is_fail and o.error]
    assert [o for o in hist if o.is_info and isinstance(o.process, int)]


def test_nemesis_ops_in_history():
    class CountingNemesis(nemesis_mod.Nemesis):
        def invoke(self, test, op):
            return op.with_(type="info", value="did-something")

    test = port_test()
    test["nemesis"] = CountingNemesis()
    test["generator"] = gen.nemesis(gen.limit(3, {"f": "poke", "type": "info"}),
                                    gen.limit(20, gen.cas))
    test = core.run(test)
    assert len([o for o in test["history"] if o.process == "nemesis"]) == 6
    assert test["results"]["valid"] is True
    same_verdicts(test)


def test_failed_ops_recorded_as_fail():
    test = port_test()
    test["generator"] = gen.clients(
        gen.limit(30, {"f": "cas", "value": (3, 4), "type": "invoke"}))
    test = core.run(test)
    assert [o for o in test["history"] if o.is_fail]
    assert test["results"]["valid"] is True
    same_verdicts(test)


class HangingClient:
    """invoke blocks until released (or an hour passes)."""

    def __init__(self, hang=3600.0):
        self.hang = hang
        self.release = threading.Event()

    def open(self, test, node):
        return HangingClient(self.hang)

    def setup(self, test):
        pass

    def invoke(self, test, op):
        self.release.wait(self.hang)
        return op.with_(type="ok")

    def teardown(self, test):
        pass

    def close(self, test):
        pass


def test_time_limit_bounds_hung_client():
    test = port_test(client=HangingClient(),
                     generator=gen.clients(
                         gen.time_limit(1.0, {"f": "write", "value": 1})))
    t0 = time.monotonic()
    test = core.run(test)
    assert time.monotonic() - t0 < 10.0
    infos = [o for o in test["history"]
             if o.is_info and isinstance(o.process, int)]
    assert any(o.error == "op timed out" for o in infos)


@pytest.mark.parametrize("concurrency", [None, 1])
def test_op_timeout_reincarnates(concurrency):
    test = port_test(client=HangingClient(), op_timeout=0.1,
                     generator=gen.clients(gen.limit(3, {"f": "write",
                                                         "value": 1})))
    if concurrency:
        test["concurrency"] = concurrency
    hist = core.run(test)["history"]
    infos = [o for o in hist if o.is_info and isinstance(o.process, int)]
    assert len(infos) == 3 and len({o.process for o in infos}) == 3
    assert all(o.error == "op timed out" for o in infos)
    assert len(hist_mod.crashed_invokes(hist)) == 3
    assert not any(o.is_fail for o in hist)


def test_fast_ops_unaffected_by_op_timeout():
    test = core.run(port_test(op_timeout=5.0))
    assert test["results"]["valid"] is True
    assert not any(o.error == "op timed out" for o in test["history"])


def test_deadline_stripped_from_history():
    test = core.run(port_test(generator=gen.clients(
        gen.time_limit(5.0, gen.limit(5, gen.cas)))))
    for o in test["history"]:
        assert gen.DEADLINE_KEY not in (o.extra or {})


def test_run_without_cuda_raises_before_setup(monkeypatch):
    """A test map whose device is the card (None) fails in prepare, on a
    box without CUDA, before the DB is set up."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = SharedAtom(value="untouched")
    test = port_test(state=state)
    test["device"] = None
    with pytest.raises(CudaUnavailable):
        core.run(test)
    assert state.value == "untouched"


# ---------------------------------------------------------------------------
# stores and checkpoints across packages

def test_port_store_read_by_jax(tmp_path):
    sd = str(tmp_path / "shared")
    test = core.run(port_test(store_dir=sd, name="cas-atom"))
    time_s = store.time_str(test["start_time"])
    j = jstore.load("cas-atom", time_s, store_dir=sd)
    assert [o.to_dict() for o in j["history"]] == [
        json.loads(json.dumps(o.to_dict())) for o in test["history"]]
    assert (jstore.load_results("cas-atom", time_s, store_dir=sd)
            == normalise(test["results"]))
    # the run checkpoint the port wrote, read by the JAX package
    ck = jstore.load_checkpoint({"name": "cas-atom", "start_time": time_s,
                                 "store_dir": sd})
    assert ck["v"] == 1 and ck["wal_count"] == len(test["history"])
    assert ck["generator"]["t"] == "Interruptible"
    assert sorted(os.listdir(os.path.dirname(store.path(test, "x")))) == \
        sorted(os.listdir(jstore.path({"name": "cas-atom",
                                       "start_time": time_s,
                                       "store_dir": sd})))


def test_jax_store_analyzed_by_port(tmp_path):
    sd = str(tmp_path / "shared")
    state = jtl.SharedAtom()
    jt = jtl.cas_test(state, client=jtl.FlakyClient(state, crash_p=0.1))
    jt["store_dir"] = sd
    jtest = jcore.run(jt)
    time_s = jstore.time_str(jtest["start_time"])
    # the checkpoint the JAX package wrote, read by the port
    ck = store.load_checkpoint({"name": "cas-atom", "start_time": time_s,
                                "store_dir": sd})
    assert ck["wal_count"] == len(jtest["history"])
    rc = cli.run_cli(cli.single_test_cmd(lambda o: {
        "name": "cas-atom", "model": cas_register(),
        "checker": linearizable(algorithm="host", device="cpu")}),
        ["analyze", "--store-dir", sd, "--device", "cpu"])
    assert rc == 0
    assert (normalise(store.load_results("cas-atom", time_s, store_dir=sd))
            == normalise(jtest["results"]))


def test_generator_snapshot_restores_across_packages(tmp_path):
    """A checkpoint's generator snapshot from one package restores the
    other's generator to the same cursor."""
    t = {"name": "x", "start_time": "20260101T000000.000",
         "store_dir": str(tmp_path), "generator": gen.limit(5, {"f": "r"}),
         "_history": []}
    for _ in range(2):
        t["generator"].op({"concurrency": 1}, 0)
    t["_ckpt"] = store.RunCheckpoint(t)
    core.checkpoint_now(t)
    loaded = jstore.load_checkpoint(t)
    b = jgen.limit(5, {"f": "r"})
    jgen.restore(b, loaded["generator"])
    assert len([1 for _ in iter(lambda: b.op({}, 0), None)]) == 3


@pytest.mark.parametrize("module", ["wgl_vec", "wgl_row", "wgl_search"])
def test_launch_counts_from_many_threads(module):
    """The etcd checker checks one key a thread, each a launch of K1, K5
    or K2: a wrapper's launch count is taken under its lock, so N
    threads counting M launches each count N * M. (The plain path on
    the CPU counts nothing, so the count itself is driven.)"""
    import sys

    mod = importlib.import_module("jepsen_tpu_torch.ops." + module)
    n, m = 2 * (os.cpu_count() or 4), 10_000
    start = mod.LAUNCHES
    barrier = threading.Barrier(n)

    def count():
        barrier.wait()
        for _ in range(m):
            mod._count()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as it can
    try:
        threads = [threading.Thread(target=count) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert mod.LAUNCHES - start == n * m
