"""The port's transactional cycle checker (jepsen_tpu_torch.checker.cycle)
against the JAX package's (jepsen_tpu.checker.cycle) on the same
histories: dependency graphs (deps.extract), Adya classification and
CycleChecker / IndependentChecker result dicts, with realtime off and
on, the closure on the CPU (the kernels' plain versions) beside the JAX
package's XLA closure, and the host engines of both. Every comparison is
exact: identical adjacency matrices, identical dicts with ops compared
by `to_dict`. Also: the device rule, deadlines, and kernel faults that
must propagate through `check_safe`."""

import json
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu.checker import cycle as jcycle
from jepsen_tpu.checker.cycle import anomalies as janomalies
from jepsen_tpu.checker.cycle import deps as jdeps
from jepsen_tpu.workloads import list_append as jla

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import independent
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import check_safe, cycle, is_fault
from jepsen_tpu_torch.checker.cycle import anomalies, deps
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable, KernelError
from jepsen_tpu_torch.ops import closure, wgl_vec
from jepsen_tpu_torch.ops._build import BuildError
from jepsen_tpu_torch.workloads import list_append
from jepsen_tpu_torch.workloads.register import keyed_history


def normalise(d):
    """A result dict as JSON carries it, ops by `to_dict`, without the
    JAX package's supervision telemetry (the port has no supervisor)."""
    d = {k: v for k, v in d.items() if k != "supervision"}

    def default(o):
        if hasattr(o, "to_dict"):
            return o.to_dict()
        return str(o)
    return json.loads(json.dumps(d, default=default))


def both(ops):
    """The same fixture ops in both packages: (JAX Ops, port Ops)."""
    return ([jhist.Op(**o) for o in ops], [thist.Op(**o) for o in ops])


def ok_txns(values):
    return both([{"process": 0, "type": "ok", "f": "txn", "value": v,
                  "time": i, "index": i} for i, v in enumerate(values)])


def sims(n, seed=0, **kw):
    jh = jla.simulate(n, seed=seed, **kw)
    th = list_append.simulate(n, seed=seed, **kw)
    assert [o.to_dict() for o in jh] == [o.to_dict() for o in th]
    return jh, th


# ---------------------------------------------------------------------------
# Dependency inference

APPEND = [[["append", "x", 1]], [["append", "x", 2]], [["r", "x", [1]]],
          [["r", "x", []]], [["r", "x", [1, 2]]]]
REGISTER_WRITE_ONCE = [[["w", "k", 1]], [["r", "k", 1]], [["r", "k", None]]]
REGISTER_VALUE = [[["w", "k", 2]], [["w", "k", 1]], [["r", "k", 1]]]


@pytest.mark.parametrize("values,kw", [
    (APPEND, {}),
    (APPEND[:2], {}),  # no reads: unobserved appends get no edges
    (REGISTER_WRITE_ONCE, {"version_order": "write-once"}),
    (REGISTER_VALUE, {"version_order": "value"}),
    ([[["r", "k", 0]]], {"init_values": (0,)}),
    ([[["w", "a", 1], ["append", "b", 1]], [["r", "a", 1], ["r", "b", [1]]],
      [["r", "a", None]]], {"realtime": True}),
], ids=["append", "unobserved", "write-once", "value", "init", "mixed-rt"])
def test_extract_matches_jax(values, kw):
    jh, th = ok_txns(values)
    jg, tg = jdeps.extract(jh, **kw), deps.extract(th, **kw)
    assert sorted(jg.adj) == sorted(tg.adj)
    for r in jg.adj:
        assert np.array_equal(jg.adj[r], tg.adj[r]), r
    assert [o.to_dict() for o in jg.ops] == [o.to_dict() for o in tg.ops]


@pytest.mark.parametrize("realtime", [False, True])
def test_extract_simulated_matches_jax(realtime):
    jh, th = sims(600)
    jg = jdeps.extract(jh, realtime=realtime)
    tg = deps.extract(th, realtime=realtime)
    assert sorted(jg.adj) == sorted(tg.adj)
    for r in jg.adj:
        assert np.array_equal(jg.adj[r], tg.adj[r]), r


@pytest.mark.parametrize("values,kw", [
    ([[["append", "x", 1]], [["append", "x", 2]], [["r", "x", [1]]],
      [["r", "x", [2]]]], {}),  # non-prefix read
    ([[["append", "x", 1]], [["append", "x", 1]]], {}),  # duplicate append
    ([[["r", "x", [7]]]], {}),  # phantom list element
    ([[["r", "k", 9]]], {}),  # phantom register value
    ([[["w", "k", 1]], [["w", "k", 1]]], {"version_order": "value"}),
    ([[["w", "k", 1]], [["w", "k", 2]]], {}),  # write-once, written twice
    ([[["w", "k", 1]], [["append", "k", 2]]], {}),  # append and write
], ids=["non-prefix", "dup-append", "phantom-list", "phantom", "dup-write",
        "write-once", "both-modes"])
def test_illegal_inference_matches_jax(values, kw):
    jh, th = ok_txns(values)
    with pytest.raises(jdeps.IllegalInference) as je:
        jdeps.extract(jh, **kw)
    with pytest.raises(deps.IllegalInference) as te:
        deps.extract(th, **kw)
    assert te.value.info == je.value.info
    assert str(te.value) == str(je.value)
    jr = jcycle.checker(engine="tpu", **kw).check({}, jh, {})
    tr = cycle.checker(device="cpu", **kw).check({}, th, {})
    assert tr == jr and tr["valid"] == "unknown"


def test_components_match_jax():
    rng = np.random.default_rng(5)
    for t in range(30):
        n = int(rng.integers(1, 120))
        full = rng.random((n, n)) < float(rng.random()) * 0.05
        if t % 5 == 0:
            full |= rng.random((n, n)) < 0.5  # dense, as with realtime
        jc, tc = janomalies.components(full), anomalies.components(full)
        assert len(jc) == len(tc)
        assert all(np.array_equal(a, b) for a, b in zip(jc, tc))


# ---------------------------------------------------------------------------
# Classification and the checker

def fixture_graph(edges, n):
    """A DepGraph in each package over n fixture ops with `edges`
    {rel: [(i, j), ...]}."""
    jops, tops = both([{"process": 0, "type": "ok", "f": "txn",
                        "value": None, "time": i, "index": i}
                       for i in range(n)])
    adj = {r: np.zeros((n, n), dtype=bool) for r in deps.RELATIONS}
    for r, es in edges.items():
        for i, j in es:
            adj[r][i, j] = True
    return (jdeps.DepGraph(ops=jops, adj={r: a.copy() for r, a in adj.items()}),
            deps.DepGraph(ops=tops, adj=adj))


@pytest.mark.parametrize("edges,n,request_,types", [
    ({"ww": [(0, 1), (1, 0)]}, 2, jcycle.ANOMALIES, ["G0"]),
    # two rw edges and a wr: G2, not G-single
    ({"rw": [(0, 1), (1, 2)], "wr": [(2, 0)]}, 3, jcycle.ANOMALIES, ["G2"]),
    # no cycle at all
    ({"rw": [(0, 1)], "wr": [(1, 2)], "ww": [(0, 2)]}, 3, jcycle.ANOMALIES,
     []),
    ({"rw": [(0, 1), (1, 0)]}, 2, jcycle.ANOMALIES, ["G2"]),
    ({"rw": [(0, 1), (2, 3)], "wr": [(1, 2), (3, 0)]}, 4, ("G2",), ["G2"]),
    ({"rw": [(0, 1)], "wr": [(1, 0)]}, 2, jcycle.ANOMALIES, ["G-single"]),
    ({"rw": [(0, 1)], "wr": [(1, 0)]}, 2, ("G2",), ["G2"]),
    # 40 nodes: the pad-64 bucket through the squaring path
    ({"ww": [(i, i + 1) for i in range(39)] + [(39, 0)],
      "wr": [(5, 17)], "rw": [(30, 2)]}, 40, jcycle.ANOMALIES,
     ["G0", "G1c", "G-single"]),
], ids=["G0", "two-rw", "acyclic", "G2", "G2-only", "G-single", "G2-broad",
        "ring40"])
def test_classify_matches_jax(edges, n, request_, types):
    jg, tg = fixture_graph(edges, n)
    jr = jcycle.classify(jg, request_, engine="tpu")
    tr = cycle.classify(tg, request_, device="cpu")
    assert normalise(tr) == normalise(jr)
    assert tr["anomaly-types"] == types
    assert normalise(cycle.classify(tg, request_, engine="host")) \
        == normalise(jcycle.classify(jg, request_, engine="host"))


@pytest.mark.parametrize("n,realtime", [(600, False), (600, True),
                                        (2000, False), (2000, True)])
def test_checker_matches_jax(n, realtime):
    """simulate() with injected G1c and G-single: the port's closure on
    the CPU gives the JAX package's XLA closure's dict."""
    jh, th = sims(n)
    jr = jcycle.checker(realtime=realtime, engine="tpu").check({}, jh, {})
    tr = cycle.checker(realtime=realtime, device="cpu").check({}, th, {})
    assert normalise(tr) == normalise(jr)
    assert tr["valid"] is False
    assert tr["anomaly-types"] == ["G1c", "G-single"]
    assert tr["component-count"] == (1 if realtime else 3)


@pytest.mark.parametrize("realtime", [False, True])
def test_host_engine_matches_jax(realtime):
    jh, th = sims(600, seed=3)
    jr = jcycle.checker(realtime=realtime, engine="host").check({}, jh, {})
    tr = cycle.checker(realtime=realtime, engine="host").check({}, th, {})
    assert normalise(tr) == normalise(jr)
    dev = cycle.checker(realtime=realtime, device="cpu").check({}, th, {})
    assert normalise(dev) == normalise(tr)


def test_clean_history_is_valid():
    jh, th = sims(400, seed=1, inject=())
    jr = jcycle.checker(engine="tpu").check({}, jh, {})
    tr = cycle.checker(device="cpu").check({}, th, {})
    assert normalise(tr) == normalise(jr)
    assert tr["valid"] is True and tr["cycle-count"] == 0


@pytest.mark.parametrize("max_witnesses", [0, 1, 2])
def test_max_witnesses_matches_jax(max_witnesses):
    jh, th = sims(600, seed=2, inject=("G1c", "G-single", "G1c"))
    kw = {"anomalies": ("G1c", "G-single"), "max_witnesses": max_witnesses}
    jr = jcycle.checker(engine="tpu", **kw).check({}, jh, {})
    tr = cycle.checker(device="cpu", **kw).check({}, th, {})
    assert normalise(tr) == normalise(jr)
    # two G1c injections give 4 hits, one G-single 1
    assert len(tr["anomalies"]["G1c"]) == max_witnesses
    assert len(tr["anomalies"]["G-single"]) == min(1, max_witnesses)


def keyed(n_keys, seed=0):
    """A keyed list-append history in each package: key k holds a
    simulated history of its own (G1c and G-single injected on odd
    keys), the keys' invoke/ok pairs dealt round-robin."""
    per_key = []
    for k in range(n_keys):
        inject = ("G1c", "G-single") if k % 2 else ()
        h = list_append.simulate(60, seed=seed + k, inject=inject)
        per_key.append([(h[i], h[i + 1]) for i in range(0, len(h), 2)])
    dicts = []
    for i in range(max(len(p) for p in per_key)):
        for k, pairs in enumerate(per_key):
            if i < len(pairs):
                for o in pairs[i]:
                    dicts.append({**o.to_dict(), "process": k * 10
                                  + o.process, "value": (k, o.value)})
    j = [jhist.Op(**{**d, "value": jind.tuple_(*d["value"])}) for d in dicts]
    t = [thist.Op(**{**d, "value": independent.tuple_(*d["value"])})
         for d in dicts]
    return jhist.index(j), thist.index(t)


def test_independent_matches_jax():
    """independent.checker(cycle.checker(...)) over a keyed txn
    history: the same dict as the JAX package's, the anomaly types of
    the keys unioned at the top."""
    jh, th = keyed(6)
    jr = jind.checker(jcycle.checker(engine="tpu")).check({}, jh, {})
    tr = independent.checker(cycle.checker(device="cpu")).check({}, th, {})
    assert normalise(tr) == normalise(jr)
    assert tr["valid"] is False and tr["failures"] == [1, 3, 5]
    assert tr["anomaly-types"] == ["G-single", "G1c"]


def test_unwrap_keyed_history_matches_jax():
    """A keyed history checked whole: micro-op keys namespaced by the
    tuple key, as the JAX package's `_unwrap` does."""
    jh, th = keyed(3, seed=10)
    jr = jcycle.checker(engine="tpu").check({}, jh, {})
    tr = cycle.checker(device="cpu").check({}, th, {})
    assert normalise(tr) == normalise(jr)
    assert tr["anomaly-types"] == ["G1c", "G-single"]


def test_expired_deadline_is_unknown():
    _, th = sims(600)
    test = {"deadline": time.monotonic() - 1}
    for kw in ({"device": "cpu"}, {"engine": "host"}):
        assert cycle.checker(**kw).check(test, th, {}) == {
            "valid": "unknown", "error": "deadline"}
    # a history with no edges has nothing to close: no deadline check
    _, clean = ok_txns([[["append", "x", 1]], [["append", "y", 1]]])
    r = cycle.checker(device="cpu").check(test, clean, {})
    assert r["valid"] is True
    roomy = {"deadline": time.monotonic() + 600}
    assert cycle.checker(device="cpu").check(roomy, th, {})["valid"] is False


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    _, th = sims(200)
    with pytest.raises(CudaUnavailable):
        cycle.checker().check({}, th, {})
    with pytest.raises(ValueError):
        cycle.checker(engine="tpu")


# ---------------------------------------------------------------------------
# Kernel faults propagate: check_safe re-raises them

def fault(*a, **kw):
    raise KernelError("closure kernel launch failed: cudaError 98")


def test_cycle_kernel_fault_propagates_with_several_keys(monkeypatch):
    """Several keys under independent.checker(cycle.checker()): each key
    goes through check_safe, and a failing launch raises out of the
    check instead of becoming an "unknown" verdict."""
    monkeypatch.setattr(closure, "closure_word", fault)
    monkeypatch.setattr(closure, "unpack", fault)
    _, th = keyed(4)
    chk = independent.checker(cycle.checker(device="cpu"))
    with pytest.raises(KernelError, match="cudaError 98"):
        chk.check({}, th, {})


def test_linearizable_kernel_fault_propagates_with_one_key(monkeypatch):
    """One key: the independent checker takes the per-key path under
    check_safe, and the failing launch still raises."""
    def search(*a, **kw):
        raise KernelError("wgl_vec kernel launch failed: cudaError 700")

    monkeypatch.setattr(wgl_vec, "search", search)
    hist = keyed_history(1, 8, n_process=2, seed=0)
    chk = independent.checker(linearizable(
        tmodels.CASRegister(), algorithm="gpu_vec", device="cpu"))
    with pytest.raises(KernelError, match="cudaError 700"):
        chk.check({}, hist, {})


#: faults of the card as torch raises them: a CUDA error that surfaces
#: at a later sync (AcceleratorError where torch has it, else a
#: RuntimeError that names it), a failed cuBLAS call, out of memory
TORCH_CARD_FAULTS = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when "
                 "calling `cublasGemmEx(...)`"),
    torch.OutOfMemoryError("CUDA out of memory"),
    *([torch.AcceleratorError("CUDA error: device-side assert triggered")]
      if hasattr(torch, "AcceleratorError") else []),
]


@pytest.mark.parametrize("exc", [
    KernelError("launch"), BuildError("nvcc"), CudaUnavailable("no card"),
    *TORCH_CARD_FAULTS])
def test_check_safe_reraises_card_faults(exc):
    class Failing:
        def check(self, test, history, opts=None):
            raise exc

    with pytest.raises(type(exc)):
        check_safe(Failing(), {}, [])


def test_check_safe_keeps_other_errors_unknown():
    class Failing:
        def check(self, test, history, opts=None):
            raise ValueError("a model bug")

    r = check_safe(Failing(), {}, [])
    assert r["valid"] == "unknown" and "a model bug" in r["error"]


@pytest.mark.parametrize("exc,fault", [
    *((e, True) for e in TORCH_CARD_FAULTS),
    (KernelError("launch"), True),
    (RuntimeError("shape '[4]' is invalid for input of size 3"), False),
    (RuntimeError("the CUDA errors log is empty"), False),
    (ValueError("CUDA error: not a torch error"), False),
])
def test_is_fault_tells_card_faults_from_ordinary_errors(exc, fault):
    """is_fault, which every except clause of the port asks before it
    reads an exception as "unknown": faults of the card and of a build
    are faults, an ordinary RuntimeError of torch is not."""
    assert is_fault(exc) is fault


def test_list_append_generator_matches_jax():
    """The live generator draws the JAX package's txns from a seed, and
    the workload's checker is the cycle checker."""
    jg = jla.ListAppendGen(keys=4, seed=7)
    tg = list_append.ListAppendGen(keys=4, seed=7)
    assert [tg.op({}, 0) for _ in range(60)] == [jg.op({}, 0)
                                                 for _ in range(60)]
    chk = list_append.checker(("G1c",), device="cpu")
    assert isinstance(chk, cycle.CycleChecker)
    assert chk.anomalies == ("G1c",) and chk.device == "cpu"
