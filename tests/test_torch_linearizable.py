"""The port's per-key linearizability check end to end, against the JAX
package: `independent.checker(linearizable(...))` result dicts, the
verdict corpus, the host search, the import boundary and the device
rule. Verdicts and step counts are exact (tolerance zero)."""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable
from jepsen_tpu.ops import wgl_host as jhost

from jepsen_tpu_torch import carry, independent
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable, resolve
from jepsen_tpu_torch.history import entries as make_entries
from jepsen_tpu_torch.ops import wgl_host, wgl_row, wgl_search, wgl_vec
from jepsen_tpu_torch.workloads.register import keyed_history, register_history

from helpers import random_queue_history, random_register_history

# the module (jepsen_tpu_torch.checker's `linearizable` is the function)
lin_mod = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures",
                      "linearizability_corpus.jsonl")
MODELS = {
    "cas-register": (jmodels.CASRegister, tmodels.CASRegister),
    "register": (jmodels.Register, tmodels.Register),
    "mutex": (jmodels.Mutex, tmodels.Mutex),
    "unordered-queue": (jmodels.UnorderedQueue, tmodels.UnorderedQueue),
    "fifo-queue": (jmodels.FIFOQueue, tmodels.FIFOQueue),
}


@pytest.fixture
def card(monkeypatch):
    """Steer "auto" to the card half of its policy on the CPU: the card
    counts as present and every engine's bar is 1, so every group of
    lanes goes to its card engine (`_route`) whole, with no native
    triage (the JAX package's tests steer its policy the same way:
    tests/test_calibrate.py monkeypatches the bar and `_tpu_backend`)."""
    monkeypatch.setattr(lin_mod, "_card_present", lambda device: True)
    monkeypatch.setattr(lin_mod, "GPU_BATCH_MIN",
                        {k: 1 for k in lin_mod.GPU_BATCH_MIN})


def normalise(d):
    """A result dict as JSON would carry it (tuples become lists, int
    keys strings)."""
    return json.loads(json.dumps(d, default=str))


def jax_keyed(hist):
    """The JAX package's keyed history for one of the port's."""
    out = []
    for o in hist:
        v = o.value
        if isinstance(v, independent.KVTuple):
            v = jind.KVTuple(v.key, v.value)
        out.append(jhist.Op.from_dict({**o.to_dict(), "value": v}))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_independent_results_match_jax(seed, card):
    """The slice end to end: the same keyed history through the JAX
    package's independent pallas check and the port's gpu_vec check
    (plain version on the CPU) gives the same result dicts."""
    hist = keyed_history(10, 10, n_process=3, bad_every=3, seed=seed)
    jhist_ = jax_keyed(hist)
    jr = jind.checker(jlinearizable(jmodels.CASRegister(),
                                    algorithm="pallas")).check({}, jhist_, {})
    tr = independent.checker(linearizable(
        tmodels.CASRegister(), algorithm="gpu_vec",
        device="cpu")).check({}, hist, {})
    assert normalise(tr) == normalise(jr)
    # the JAX package's keyed Ops carried back into the port check alike
    back = carry.history_from_dicts([o.to_dict() for o in jhist_])
    assert all(isinstance(o.value, independent.KVTuple) for o in back)
    tb = independent.checker(linearizable(
        tmodels.CASRegister(), algorithm="gpu_vec",
        device="cpu")).check({}, back, {})
    assert normalise(tb) == normalise(jr)
    assert tr["valid"] is False and tr["failures"] == [0, 3, 6, 9]
    for k in tr["failures"]:
        assert tr["results"][k]["op"] and tr["results"][k]["final_paths"]
    # "auto" takes the same engine for an eligible batch
    ta = independent.checker(linearizable(
        tmodels.CASRegister(), device="cpu")).check({}, hist, {})
    assert normalise(ta) == normalise(tr)


def test_independent_late_bad_reads_match_jax():
    """Impossible reads planted at random reads rather than the first:
    the JAX package and the port still give the same result dicts, and
    every planted key is refuted."""
    hist = keyed_history(8, 12, n_process=3, bad_every=2, bad_read="random",
                         seed=2)
    first = keyed_history(8, 12, n_process=3, bad_every=2, seed=2)
    assert [o.to_dict() for o in hist] != [o.to_dict() for o in first]
    jr = jind.checker(jlinearizable(jmodels.CASRegister(),
                                    algorithm="pallas")).check(
        {}, jax_keyed(hist), {})
    tr = independent.checker(linearizable(
        tmodels.CASRegister(), algorithm="gpu_vec",
        device="cpu")).check({}, hist, {})
    assert normalise(tr) == normalise(jr)
    assert tr["failures"] == [0, 2, 4, 6]
    with pytest.raises(ValueError):
        keyed_history(2, 4, bad_every=1, bad_read="last")


def test_batch_kernel_failure_propagates(monkeypatch):
    """Unlike the JAX package, a failing batch check is not re-run per
    key as "unknown" verdicts: the exception reaches the caller."""
    def boom(*a, **kw):
        raise RuntimeError("kernel fault")

    monkeypatch.setattr(wgl_vec, "analysis_batch", boom)
    hist = keyed_history(3, 6, n_process=2, seed=0)
    chk = independent.checker(linearizable(tmodels.CASRegister(),
                                           algorithm="gpu_vec",
                                           device="cpu"))
    with pytest.raises(RuntimeError, match="kernel fault"):
        chk.check({}, hist, {})


def test_subhistory_split_matches_jax():
    hist = keyed_history(6, 8, n_process=2, bad_every=2, seed=4)
    jh = jax_keyed(hist)
    ks = sorted(independent.history_keys(hist), key=str)
    assert ks == sorted(jind.history_keys(jh), key=str)
    subs = independent._split(hist, ks)
    for k in ks:
        a = [o.to_dict() for o in subs[k]]
        assert a == [o.to_dict() for o in independent.subhistory(k, hist)]
        assert a == [o.to_dict() for o in jind.subhistory(k, jh)]


CORPUS_CASES = [
    "cas-2p-8ops-c0.0", "cas-2p-8ops-c0.15", "cas-2p-8ops-c0.3",
    "cas-3p-10ops-c0.0", "cas-3p-10ops-c0.15", "cas-3p-10ops-c0.3",
    "cas-3p-16ops-c0.0", "cas-3p-16ops-c0.15", "cas-4p-24ops-c0.3",
    "cas-4p-40ops-c0.15", "cas-4p-40ops-c0.3", "cas-5p-60ops-c0.3",
    "cas-5p-80ops-c0.15", "cas-5p-80ops-c0.3", "register-0", "register-1",
    "register-3", "register-5", "mutex-0", "mutex-2", "mutex-1", "mutex-5",
    "queue-0", "queue-2", "queue-1", "queue-3", "fifo-0", "fifo-2",
    "fifo-1", "fifo-5",
]


def _corpus():
    with open(CORPUS) as fh:
        cases = {c["name"]: c for c in map(json.loads, fh)}
    return [cases[n] for n in CORPUS_CASES]


@pytest.mark.parametrize("case", _corpus(), ids=CORPUS_CASES)
def test_corpus_verdicts(case):
    """A 30-case subset of the recorded verdict corpus, every model
    family and both verdicts, through the port's auto route."""
    model = MODELS[case["model"]][1]()
    hist = carry.history_from_dicts(case["history"])
    r = linearizable(model, device="cpu").check({}, hist, {})
    assert r["valid"] == case["expected"], case["name"]


@pytest.mark.parametrize("seed", range(4))
def test_host_search_matches_jax(seed):
    for name, hist in [
            ("cas-register", random_register_history(
                n_process=4, n_ops=14, corrupt=0.3, seed=300 + seed)),
            ("unordered-queue", random_queue_history(
                n_process=3, n_ops=12, corrupt=0.3, seed=30 + seed))]:
        jm, tm = (c() for c in MODELS[name])
        jr = jhost.analysis(jm, hist)
        tr = wgl_host.analysis(tm, carry.history_from_dicts(
            [o.to_dict() for o in hist]))
        assert normalise(tr.to_dict()) == normalise(jr.to_dict())
        td = linearizable(tm, algorithm="host").check(
            {}, carry.history_from_dicts([o.to_dict() for o in hist]), {})
        jd = jlinearizable(jm, algorithm="host").check({}, hist, {})
        assert normalise(td) == normalise(jd)


def test_auto_routes_ineligible_lanes_to_host(card):
    """A payload with no int32 encoding makes the batch ineligible:
    "auto" takes the host search (decided before any launch) and still
    gets the verdicts right; "gpu_vec" refuses it."""
    big = 2**40
    good = carry.history_from_dicts([
        {"process": 0, "type": "invoke", "f": "write", "value": big},
        {"process": 0, "type": "ok", "f": "write", "value": big},
        {"process": 1, "type": "invoke", "f": "read", "value": None},
        {"process": 1, "type": "ok", "f": "read", "value": big}])
    chk = linearizable(tmodels.CASRegister(), device="cpu")
    assert chk._route(tmodels.CASRegister(), [wgl_vec.make_entries(good)]) \
        == ["host"]
    assert chk.check({}, good, {})["valid"] is True
    with pytest.raises(ValueError):
        linearizable(tmodels.CASRegister(), algorithm="gpu_vec",
                     device="cpu").check({}, good, {})


def mixed_history(seed):
    """Four short keys (10 invocations) and two long ones (1300, past
    wgl_vec's 1024 entries); keys 0, 2 and 4 carry an impossible read."""
    return keyed_history(6, [10] * 4 + [1300] * 2, n_process=3, bad_every=2,
                         seed=seed)


def test_auto_routes_each_lane(card):
    """"auto" decides per lane for the scalar models, before anything
    launches: gpu_vec up to 1024 entries, gpu_row up to 4064, gpu_search
    past that, the host without an int32 encoding. The queue models keep
    the whole-batch rule."""
    short = make_entries(register_history(n_process=3, n_ops=10, seed=0))
    long = make_entries(register_history(n_process=3, n_ops=1300, seed=1))
    huge = make_entries(register_history(n_process=5, n_ops=4100, cas=False,
                                         seed=2))
    big = make_entries(carry.history_from_dicts([
        {"process": 0, "type": "invoke", "f": "write", "value": 2**40},
        {"process": 0, "type": "ok", "f": "write", "value": 2**40}]))
    assert len(short) <= 1024 < len(long) <= 4064 < len(huge)
    chk = linearizable(tmodels.CASRegister(), device="cpu")
    assert chk._route(tmodels.Register(), [short, long, huge, big]) == [
        "gpu_vec", "gpu_row", "gpu_search", "host"]
    q = make_entries(random_queue_history(n_process=2, n_ops=6, seed=0))
    assert linearizable(tmodels.UnorderedQueue(), device="cpu")._route(
        tmodels.UnorderedQueue(), [q, q]) == ["gpu_vec", "gpu_vec"]
    assert linearizable(tmodels.CASRegister(), algorithm="host")._route(
        tmodels.CASRegister(), [short, long]) == ["host", "host"]


@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_keys_match_jax_host(seed, card):
    """Short and long keys in one keyed history: the port's auto check
    (gpu_vec and gpu_row, plain versions on the CPU) gives the JAX
    package's host check's verdicts and counterexamples, and the short
    keys' result dicts are those of the short keys checked alone."""
    hist = mixed_history(seed)
    wgl_vec.CAPTURE, wgl_row.CAPTURE = [], []
    try:
        tr = independent.checker(linearizable(
            tmodels.CASRegister(), device="cpu")).check({}, hist, {})
        vec, row = wgl_vec.CAPTURE, wgl_row.CAPTURE
    finally:
        wgl_vec.CAPTURE = wgl_row.CAPTURE = None
    assert len(vec) == 1 and vec[0][0].shape[1] == wgl_vec.LANES
    assert len(row) == 1 and row[0][0].shape[0] == 2
    jr = jind.checker(jlinearizable(jmodels.CASRegister(),
                                    algorithm="host")).check(
        {}, jax_keyed(hist), {})
    assert tr["valid"] is False and tr["failures"] == jr["failures"] \
        == [0, 2, 4]
    for k, r in normalise(tr["results"]).items():
        j = normalise(jr["results"])[k]
        assert {x: r.get(x) for x in ("valid", "op", "final_paths")} \
            == {x: j.get(x) for x in ("valid", "op", "final_paths")}, k
    short = [o for o in hist if o.value.key < 4]
    alone = independent.checker(linearizable(
        tmodels.CASRegister(), device="cpu")).check({}, short, {})
    for k in range(4):
        assert tr["results"][k] == alone["results"][k]


def test_single_long_history_routes_to_gpu_row(card):
    hist = register_history(n_process=5, n_ops=1500, seed=3)
    assert 1024 < len(make_entries(hist)) <= wgl_row.MAX_PAD
    wgl_row.CAPTURE = []
    try:
        r = linearizable(tmodels.CASRegister(), device="cpu").check(
            {}, hist, {})
        launches = wgl_row.CAPTURE
    finally:
        wgl_row.CAPTURE = None
    assert len(launches) == 1 and launches[0][3] == 2048
    assert r["valid"] is True
    assert r == linearizable(tmodels.CASRegister(), algorithm="gpu_row",
                             device="cpu").check({}, hist, {})
    assert wgl_host.analysis(tmodels.CASRegister(), hist).valid is True


def test_row_kernel_failure_propagates(monkeypatch, card):
    """A failing gpu_row engine raises through the check: its lanes do
    not fall back to the host search."""
    def boom(*a, **kw):
        raise RuntimeError("row kernel fault")

    monkeypatch.setattr(wgl_row, "analysis_batch", boom)
    with pytest.raises(RuntimeError, match="row kernel fault"):
        independent.checker(linearizable(
            tmodels.CASRegister(), device="cpu")).check(
            {}, mixed_history(0), {})


def test_default_device_is_cuda():
    """device=None means CUDA: it raises when CUDA is absent, and the
    entry points pass it on unchanged."""
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
        return
    with pytest.raises(CudaUnavailable):
        resolve(None)
    hist = random_register_history(n_process=2, n_ops=4, seed=0)
    with pytest.raises(CudaUnavailable):
        wgl_vec.analysis_batch(tmodels.CASRegister(), [
            carry.history_from_dicts([o.to_dict() for o in hist])])
    with pytest.raises(CudaUnavailable):
        linearizable(tmodels.CASRegister()).check(
            {}, carry.history_from_dicts([o.to_dict() for o in hist]), {})
    assert resolve("cpu").type == "cpu"


def test_port_imports_no_jax():
    """CPU checks through jepsen_tpu_torch (linearizable on native and
    under "auto", on gpu_vec, gpu_row, gpu_search and the
    P-compositional split with "auto" steered to the card engines, under
    "linear" and "competition", and cycle; the fuzz simulator and its
    scoring; the store, the analysis journal and the artifacts of both
    checkers, the fuzz loop; the online frontiers and a stream session,
    the registry, the bundle's warm pass and the verdict daemon; the
    multi-device engines dealt over CPU entries, the mesh crossover's
    bars and the doctor; every registered checker, the host checkers,
    the bank, adya, long_fork and causal checkers, core.analyze, and the
    analyze and fuzz subcommands; the test runner's modules (generator,
    client, db, osenv, net, osdist, control, nemesis, testlib, the etcd
    suite and its simulator) and a core.run of testlib's cas test; the
    fault layer (combined's schedule documents, fsfault, the clock
    nemesis, faketime, the fuzz documents, the etcd suite's fault
    packages and fs-break wiring), reconnect and the register workload;
    and every module of those) load neither jax
    nor any module of the JAX package (jepsen_tpu_torch's own name shares
    the jepsen_tpu prefix, so match whole package names)."""
    code = textwrap.dedent("""
        import sys
        from jepsen_tpu_torch import independent
        import importlib
        from jepsen_tpu_torch.checker.linearizable import linearizable
        lin_mod = importlib.import_module(
            "jepsen_tpu_torch.checker.linearizable")
        from jepsen_tpu_torch.models import CASRegister
        from jepsen_tpu_torch.ops import wgl_native
        from jepsen_tpu_torch.workloads.register import keyed_history
        h = keyed_history(4, 6, n_process=2, bad_every=2, seed=0)
        for alg in ("auto", "native"):
            r = independent.checker(linearizable(
                CASRegister(), algorithm=alg, device="cpu")).check({}, h, {})
            assert r["valid"] is False, r
        from jepsen_tpu_torch.fuzz import (random_schedule, score_batch,
                                           simulate_batch)
        res = simulate_batch([random_schedule(i) for i in range(4)],
                             list(range(4)), device="cpu")
        assert len(score_batch(res, engine="host")) == 4
        lin_mod._card_present = lambda device: True
        lin_mod.GPU_BATCH_MIN = {k: 1 for k in lin_mod.GPU_BATCH_MIN}
        from jepsen_tpu_torch.ops import wgl_row
        from jepsen_tpu_torch.workloads.register import register_history
        wgl_row.CAPTURE = []
        r = linearizable(CASRegister(), device="cpu").check(
            {}, register_history(n_process=3, n_ops=1300, seed=1), {})
        assert r["valid"] is True and len(wgl_row.CAPTURE) == 1, r
        from jepsen_tpu_torch.models import FIFOQueue, UnorderedQueue
        from jepsen_tpu_torch.ops import wgl_search
        from jepsen_tpu_torch.workloads.queue import queue_history
        wgl_search.CAPTURE = []
        r = linearizable(FIFOQueue(), algorithm="gpu_search",
                         device="cpu").check(
            {}, queue_history(n_process=3, n_ops=30, fifo=True, seed=2), {})
        assert r["valid"] in (True, False) and len(wgl_search.CAPTURE) == 1
        from jepsen_tpu_torch.ops import wgl_vec
        wgl_vec.CAPTURE = []
        r = linearizable(UnorderedQueue(), device="cpu").check(
            {}, queue_history(n_process=3, n_ops=80, n_values=20, seed=3),
            {})
        assert r["valid"] is True and len(wgl_vec.CAPTURE) == 1, r
        from jepsen_tpu_torch.checker import cycle
        from jepsen_tpu_torch.workloads import list_append
        r = cycle.checker(device="cpu").check(
            {}, list_append.simulate(400, seed=0), {})
        assert r["anomaly-types"] == ["G1c", "G-single"], r
        import tempfile
        from jepsen_tpu_torch import store
        from jepsen_tpu_torch.checker import linear_report, perf, timeline
        from jepsen_tpu_torch.fuzz import loop
        from jepsen_tpu_torch.models import GrowOnlySet, NoOp
        from jepsen_tpu_torch.ops import linear
        for alg in ("linear", "competition"):
            r = independent.checker(linearizable(
                CASRegister(), algorithm=alg, device="cpu")).check({}, h, {})
            assert r["valid"] is False, r
        assert lin_mod._drain_racers() is None
        with tempfile.TemporaryDirectory() as td:
            t = {"name": "nojax", "start_time": "20260101T000000.000",
                 "store_dir": td}
            t["_analysis_journal"] = store.AnalysisJournal(t)
            r = independent.checker(linearizable(
                CASRegister(), device="cpu")).check(t, h, {})
            assert r["valid"] is False and len(t["_analysis_journal"]) == 4
            r = cycle.checker(device="cpu").check(
                t, list_append.simulate(200, seed=1), {})
            assert r["valid"] is False
            assert loop.FuzzLoop(td + "/fz", clusters=4, device="cpu").run(
                1)["clusters-run"] == 4
        from jepsen_tpu_torch import cli, core, web
        from jepsen_tpu_torch.online import (CycleFrontier, StreamSession,
                                             WGLFrontier, client, ingest,
                                             monitor, watch)
        from jepsen_tpu_torch.serve import (bundle, daemon, queue, registry,
                                            sacrifice)
        s = StreamSession(iter(list_append.simulate(200, seed=1)),
                          CycleFrontier(cycle.checker(device="cpu")),
                          window=64, abort_on_invalid=True)
        assert s.run()["valid"] is False and s.aborted
        wf = WGLFrontier(registry.WORKLOAD_FACTORIES["register"](
            device="cpu")["checker"])
        wf.extend(h)
        assert wf.advance()["valid"] is False
        with tempfile.TemporaryDirectory() as td:
            reg = registry.EngineRegistry(
                bundle.EngineBundle(td + "/b", device="cpu"), device="cpu")
            assert reg.warm()["warm"] is False
            q = queue.DurableQueue(td + "/q")
            dm = daemon.VerdictDaemon(q, reg)
            dm.start()
            jid = q.submit("c", "register", [o.to_dict() for o in h])
            assert q.wait_for_verdict(jid, timeout=120)["valid"] is False
            dm.draining.set()
            dm.join(timeout=10)
        import numpy as np
        from jepsen_tpu_torch import doctor
        from jepsen_tpu_torch.checker import calibrate
        from jepsen_tpu_torch.ops import closure
        assert calibrate.mesh_min_n() >= 1 and calibrate.mesh_lanes_min() >= 1
        assert wgl_search.probe_mesh(["cpu"] * 2)
        assert closure.probe_mesh(["cpu"] * 2)
        assert closure.reach_batch_mesh([np.eye(3, k=1, dtype=bool)],
                                        devices=["cpu"] * 2)[0].sum() == 3
        lanes = [register_history(n_process=2, n_ops=6, seed=s)
                 for s in range(3)]
        assert all(r.valid is True for r in wgl_vec.analysis_batch(
            CASRegister(), lanes, devices=["cpu"] * 2))
        r = cycle.checker(engine="mesh", devices=["cpu"] * 2).check(
            {}, list_append.simulate(200, seed=1), {})
        assert r["valid"] is False
        assert doctor.diagnose(devices=["cpu"] * 2)["ok"]
        from jepsen_tpu_torch import util
        from jepsen_tpu_torch.checker import (REGISTRY, basic, clock,
                                              compose, perf, resolve)
        from jepsen_tpu_torch.history import Op
        from jepsen_tpu_torch.workloads import adya, bank, causal, long_fork
        importlib.import_module("jepsen_tpu_torch.checker.recovery")
        for name in REGISTRY:
            assert resolve(name, device="cpu").check(
                {"model": CASRegister()}, h, {})["valid"] is not None
        tup = independent.tuple_
        r = adya.g2_checker(device="cpu").check({}, [
            Op(0, "ok", "insert", tup(0, (None, 1)), index=0),
            Op(1, "ok", "insert", tup(0, (2, None)), index=1)], {})
        assert r["anomaly-types"] == ["G2"], r
        r = long_fork.checker(2, device="cpu").check({}, [
            Op(0, "ok", "write", [["w", 0, 1]], index=0),
            Op(1, "ok", "write", [["w", 1, 1]], index=1),
            Op(2, "ok", "read", [["r", 0, 1], ["r", 1, None]], index=2),
            Op(3, "ok", "read", [["r", 0, None], ["r", 1, 1]], index=3)])
        assert r["valid"] is False and r["forks"], r
        steps = [("read-init", 0, 1, "init"), ("write", 1, 2, 1),
                 ("read", 0, 3, 2)]
        r = causal.checker(device="cpu").check({}, [
            Op(0, "ok", f, tup(0, v), index=i,
               extra={"position": p, "link": ln})
            for i, (f, v, p, ln) in enumerate(steps)])
        assert r["failures"] == [0], r
        r = bank.test(device="cpu")["checker"].check(
            {"accounts": list(range(8)), "total_amount": 100,
             "nodes": ["n1"]},
            [Op(0, "ok", "read", {a: 100 if a == 0 else 0
                                  for a in range(8)}, index=0)], {})
        assert r["SI"]["valid"] is True, r
        assert compose({"set": basic.set_full()}).check({}, [], {})[
            "valid"] == "unknown"
        with tempfile.TemporaryDirectory() as td:
            t = {"name": "nojax", "start_time": "20260101T000000.000",
                 "store_dir": td, "history": register_history(seed=4),
                 "checker": linearizable(CASRegister(), device="cpu")}
            store.save_1(t)
            assert core.analyze(t)["results"]["valid"] is True
            assert cli.run_cli(cli.single_test_cmd(
                lambda o: {"name": "nojax", "checker": t["checker"]}),
                ["analyze", "--store-dir", td, "--device", "cpu"]) == 0
            assert cli.run_cli(cli.fuzz_cmd(), [
                "fuzz", "--corpus-dir", td + "/fz2", "--rounds", "1",
                "--clusters", "4", "--device", "cpu"]) == 0
        from jepsen_tpu_torch import (client, db, generator, net, osdist,
                                      osenv, testlib)
        from jepsen_tpu_torch import nemesis as nem
        from jepsen_tpu_torch.control import net as cnet, util as cutil
        from jepsen_tpu_torch.dbs import common, etcd, etcd_sim, simbase
        importlib.import_module("jepsen_tpu_torch.dbs.__main__")
        t = testlib.cas_test(name=None, device="cpu",
                             checker=linearizable(algorithm="host",
                                                  device="cpu"))
        assert core.run(t)["results"]["valid"] is True
        assert etcd.etcd_test({"nodes": ["n1"], "device": "cpu"})[
            "name"] == "etcd"
        from jepsen_tpu_torch import faketime, reconnect
        from jepsen_tpu_torch.fuzz.schedule import to_nemesis_doc
        from jepsen_tpu_torch.nemesis import combined, fsfault
        from jepsen_tpu_torch.nemesis import time as ntime
        from jepsen_tpu_torch.workloads import linearizable_register
        doc = combined.materialize_schedule(
            faults=list(combined.FAULT_FAMILIES), seed=0, fault_ops=8)
        assert combined.schedule_to_json(combined.schedule_from_json(
            doc, db=combined._ScheduleDB(), pace=False)) == \\
            combined.schedule_to_json(doc)
        assert to_nemesis_doc(random_schedule(3))["version"] == 1
        t = etcd.etcd_test({"nodes": ["n1"], "nemesis": "kill,clock",
                            "set_time_fn": lambda t, n, at: None})
        assert set(t["fault_families"]) == {"kill", "clock"}
        t = etcd.etcd_test({"nodes": ["n1"], "nemesis": "fs-break"})
        assert isinstance(t["db"], fsfault.FaultFsDB)
        assert faketime.script("/x", 1, 2.0).startswith("#!")
        assert ntime.clock_gen() is not None
        w = reconnect.wrapper(lambda: object(), lambda c: None).open()
        assert w.conn() is not None
        assert linearizable_register.test({"nodes": ["n1"], "device": "cpu"})[
            "model"] is not None
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "jepsen_tpu" or m.startswith("jepsen_tpu."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def imported_modules(stderr: str) -> set:
    """Every module a `python -X importtime` run imported."""
    return {ln.rsplit("|", 1)[1].strip() for ln in stderr.splitlines()
            if ln.startswith("import time:") and "|" in ln}


@pytest.mark.parametrize("entry", ["watch", "sacrifice"])
def test_entry_points_load_no_jax(tmp_path, entry):
    """`python -m jepsen_tpu_torch watch <fixture> --device cpu` and
    `python -m jepsen_tpu_torch.serve.sacrifice <queue> <id> --device cpu`
    run to their verdicts and import neither jax nor any module of the
    JAX package (every import of the run, from -X importtime)."""
    from jepsen_tpu_torch.serve.queue import DurableQueue

    if entry == "watch":
        args = ["-m", "jepsen_tpu_torch", "watch",
                os.path.join(REPO, "tests", "fixtures", "edn",
                             "list_append_g1c.edn"),
                "--window", "16", "--device", "cpu"]
        want = 1
    else:
        q = DurableQueue(str(tmp_path / "q"))
        jid = q.submit("c", "register", [
            {"process": 0, "type": "invoke", "f": "write",
             "value": ["k", 1]},
            {"process": 0, "type": "ok", "f": "write", "value": ["k", 1]},
            {"process": 1, "type": "invoke", "f": "read",
             "value": ["k", None]},
            {"process": 1, "type": "ok", "f": "read", "value": ["k", 2]}])
        args = ["-m", "jepsen_tpu_torch.serve.sacrifice", q.root, jid,
                "--device", "cpu"]
        want = 0
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-X", "importtime", *args],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == want, out.stdout + out.stderr[-3000:]
    mods = imported_modules(out.stderr)
    assert "jepsen_tpu_torch.serve.registry" in mods
    assert sorted(m for m in mods
                  if m.split(".")[0] in ("jax", "jepsen_tpu")) == []
    if entry == "watch":
        assert "jepsen_tpu_torch.online.frontier" in mods
        assert '"anomaly-types": ["G1c"]' in out.stdout
    else:
        assert DurableQueue(q.root).verdict(jid)["valid"] is False


def capture(*mods):
    """Set CAPTURE = [] on each engine module; restore None after."""
    class _Cap:
        def __enter__(self):
            for m in mods:
                m.CAPTURE = []
            return self

        def __exit__(self, *exc):
            self.got = [m.CAPTURE for m in mods]
            for m in mods:
                m.CAPTURE = None
    return _Cap()


def same_result(tr, jr):
    keys = ("valid", "op", "final_paths")
    assert {k: normalise(tr).get(k) for k in keys} == \
        {k: normalise(jr).get(k) for k in keys}


def queue_like(name, seed, n_ops, corrupt=0.0, **kw):
    return random_queue_history(n_process=3, n_ops=n_ops, corrupt=corrupt,
                                seed=seed, fifo=name == "fifo-queue", **kw)


def register_like(name, seed, n_ops, corrupt=0.0):
    if name == "mutex":
        from jepsen_tpu_torch.workloads.queue import mutex_history
        return [jhist.Op.from_dict(o.to_dict()) for o in mutex_history(
            n_process=3, n_ops=n_ops, corrupt=corrupt, seed=seed)]
    return random_register_history(n_process=3, n_ops=n_ops, corrupt=corrupt,
                                   cas=name == "cas-register", seed=seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_gpu_search_matches_jax_tpu(name, seed):
    """algorithm="gpu_search" against the JAX package's "tpu" (K2), one
    history at a time and as a keyed batch: valid, op and final_paths
    equal; the whole batch goes to wgl_search in one search."""
    make = queue_like if name.endswith("queue") else register_like
    jm, tm = MODELS[name]
    for corrupt in (0.0, 0.3):
        jh = make(name, seed, 20, corrupt)
        with capture(wgl_search) as cap:
            tr = linearizable(tm(), algorithm="gpu_search",
                              device="cpu").check({}, to_port(jh), {})
        assert len(cap.got[0]) == 1
        jr = jlinearizable(jm(), algorithm="tpu").check({}, jh, {})
        same_result(tr, jr)
    items = [(to_port(make(name, seed + 10 * i, 16, 0.3 * (i % 2))), {})
             for i in range(4)]
    with capture(wgl_search) as cap:
        trs = linearizable(tm(), algorithm="gpu_search",
                           device="cpu").check_batch({}, items)
    assert len(cap.got[0]) == 1 and cap.got[0][0][0].shape[0] == 4
    jrs = jlinearizable(jm(), algorithm="tpu").check_batch(
        {}, [([jhist.Op.from_dict(o.to_dict()) for o in h], o)
             for h, o in items])
    for t, j in zip(trs, jrs):
        same_result(t, j)


def to_port(hist):
    return carry.history_from_dicts([o.to_dict() for o in hist])


def test_auto_sends_long_scalar_lanes_to_gpu_search(card):
    """One cas-register history of ~4,600 entries (past wgl_row's 4064)
    under "auto": one wgl_search launch, nothing else; the verdict and
    counterexample are the JAX package's K2 check's, also with an
    impossible read planted at the first read."""
    jh = random_register_history(n_process=5, n_ops=5600, seed=11)
    assert len(make_entries(to_port(jh))) > wgl_row.MAX_PAD
    reads = [i for i, o in enumerate(jh) if o.type == "ok" and o.f == "read"]
    bad = list(jh)
    bad[reads[0]] = bad[reads[0]].with_(value=99)
    for h in (jh, bad):
        with capture(wgl_vec, wgl_row, wgl_search) as cap:
            tr = linearizable(tmodels.CASRegister(), device="cpu").check(
                {}, to_port(h), {})
        assert [len(c) for c in cap.got] == [0, 0, 1]
        jr = jlinearizable(jmodels.CASRegister(), algorithm="tpu").check(
            {}, h, {})
        same_result(tr, jr)
    assert tr["valid"] is False


def test_auto_sends_wide_fifo_rings_to_gpu_search(card):
    """A fifo-queue batch with a lane of more than 64 enqueues (past
    wgl_vec's ring) goes to wgl_search whole under "auto", with the
    verdicts of the JAX package's K2 check."""
    hists = [queue_like("fifo-queue", s, n) for s, n in
             ((1, 12), (2, 180), (3, 20))]
    assert sum(o.f == "enqueue" and o.type == "invoke"
               for o in hists[1]) > 64
    items = [(to_port(h), {}) for h in hists]
    with capture(wgl_vec, wgl_search) as cap:
        trs = linearizable(tmodels.FIFOQueue(), device="cpu").check_batch(
            {}, items)
    assert len(cap.got[0]) == 0 and len(cap.got[1]) == 1
    assert linearizable(tmodels.FIFOQueue())._route(
        tmodels.FIFOQueue(), [make_entries(h) for h, _ in items]) == \
        ["gpu_search"] * 3
    jrs = jlinearizable(jmodels.FIFOQueue(), algorithm="tpu").check_batch(
        {}, [(h, {}) for h in hists])
    for t, j in zip(trs, jrs):
        same_result(t, j)


@pytest.mark.parametrize("corrupt", [0.0, 0.1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcomp_queue_matches_jax(seed, corrupt, card):
    """One unordered-queue history of 300 invocations over 60 values
    under "auto": split by value into micro-lanes that all run in one
    wgl_vec search (no host route), with the JAX package's auto
    verdict, op and final_paths."""
    jh = random_queue_history(n_process=5, n_ops=300, n_values=60,
                              corrupt=corrupt, seed=seed)
    with capture(wgl_vec, wgl_row, wgl_search) as cap:
        tr = linearizable(tmodels.UnorderedQueue(), device="cpu").check(
            {}, to_port(jh), {})
    assert [len(c) for c in cap.got] == [1, 0, 0]
    assert cap.got[0][0][0].shape[1] >= 40  # lanes: one a value
    jr = jlinearizable(jmodels.UnorderedQueue()).check({}, jh, {})
    same_result(tr, jr)
    if not corrupt:
        assert tr["valid"] is True


def test_pcomp_batch_flattens_every_item(card):
    """independent.checker over keyed queue histories: every key's
    micro-lanes in one wgl_vec search, each key's verdict recombined from
    its own lanes; the dicts' verdicts, ops and final paths equal the JAX
    package's."""
    per_key = [random_queue_history(n_process=3, n_ops=60, n_values=15,
                                    corrupt=0.15 * (k % 2), seed=40 + k)
               for k in range(4)]
    hist = []
    for k, h in enumerate(per_key):
        for o in h:
            hist.append(o.with_(process=o.process + 10 * k,
                                value=jind.KVTuple(k, o.value)))
    for i, o in enumerate(hist):
        o.index = i
    with capture(wgl_vec) as cap:
        tr = independent.checker(linearizable(
            tmodels.UnorderedQueue(), device="cpu")).check(
                {}, to_port(hist), {})
    assert len(cap.got[0]) == 1
    jr = jind.checker(jlinearizable(jmodels.UnorderedQueue())).check(
        {}, hist, {})
    assert tr["failures"] == jr["failures"] and tr["valid"] == jr["valid"]
    for k in range(4):
        same_result(tr["results"][k], jr["results"][k])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pcomp_multi_register_matches_jax(seed, card):
    """Single-key multi-register txns under "auto": split by key into
    Register lanes on wgl_vec; the JAX package's auto verdict. A history
    with a two-key txn does not split: the host search, in both."""
    import random as _random
    rng = _random.Random(seed)
    dicts, regs = [], {}
    for i in range(30):
        k = rng.choice("xyz")
        if rng.random() < 0.5:
            v = rng.randrange(4)
            regs[k] = v
            micros = [["w", k, v]]
        else:
            v = regs.get(k)
            if v is not None and rng.random() < 0.15:
                v += 1
            micros = [["r", k, v]]
        for kind in ("invoke", "ok"):
            dicts.append({"process": i % 3, "type": kind, "f": "txn",
                          "value": micros, "index": len(dicts),
                          "time": len(dicts)})
    jh = [jhist.Op.from_dict(d) for d in dicts]
    with capture(wgl_vec) as cap:
        tr = linearizable(tmodels.MultiRegister(), device="cpu").check(
            {}, to_port(jh), {})
    assert len(cap.got[0]) == 1
    same_result(tr, jlinearizable(jmodels.MultiRegister()).check({}, jh, {}))
    dicts[0]["value"] = dicts[1]["value"] = [["w", "x", 0], ["w", "y", 0]]
    jh = [jhist.Op.from_dict(d) for d in dicts]
    with capture(wgl_vec) as cap:
        tr = linearizable(tmodels.MultiRegister(), device="cpu").check(
            {}, to_port(jh), {})
    assert cap.got == [[]]
    same_result(tr, jlinearizable(jmodels.MultiRegister()).check({}, jh, {}))
