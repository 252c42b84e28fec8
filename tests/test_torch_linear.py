"""The port's `linear` algorithm (ops/linear.py, knossos.linear) and the
`competition` race, against the JAX package: `linear.analysis` field for
field (valid, op, configs, cache_size, steps) on the verdict corpus, the
host-only models NoOp and GrowOnlySet, the checker's "linear" dicts
through `check` and `check_batch`, and "competition" with each entrant
forced to win in both packages. Exact (tolerance zero)."""

import importlib
import json
import os
import threading

import pytest
import torch

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable
from jepsen_tpu.ops import linear as jlinear
from jepsen_tpu.ops import wgl_tpu as jwgl_tpu

from jepsen_tpu_torch import carry
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable, KernelError
from jepsen_tpu_torch.ops import linear, wgl_host, wgl_search

from helpers import random_register_history

lin_mod = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
jlin_mod = importlib.import_module("jepsen_tpu.checker.linearizable")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "fixtures",
                      "linearizability_corpus.jsonl")
MODELS = {
    "cas-register": (jmodels.CASRegister, tmodels.CASRegister),
    "register": (jmodels.Register, tmodels.Register),
    "mutex": (jmodels.Mutex, tmodels.Mutex),
    "unordered-queue": (jmodels.UnorderedQueue, tmodels.UnorderedQueue),
    "fifo-queue": (jmodels.FIFOQueue, tmodels.FIFOQueue),
    "multi-register": (jmodels.MultiRegister, tmodels.MultiRegister),
}
with open(CORPUS) as _fh:
    CASES = [json.loads(line) for line in _fh if line.strip()]

#: corpus cases the JAX package's linear does not finish within 1 s on a
#: CPU core (deep configuration sets); left out of the parity test
SLOW = {
    "crash-heavy-3",
    "crash-heavy-6",
    "crash-heavy-7",
    "large-cas-512ev-0",
    "large-cas-600ev-1",
    "large-cas-768ev-3",
    "large-cas-640ev-4",
    "large-cas-1024ev-5",
    "large-cas-896ev-7",
    "large-cas-1024ev-8",
    "large-register-0",
    "large-register-1",
    "large-register-2",
    "large-register-3",
    "fifo-queue-r3-26",
}
FAST = [c for c in CASES if c["name"] not in SLOW]


def both(op_dicts):
    """The same history as the JAX package's Ops and the port's."""
    return ([jhist.Op.from_dict(dict(d)) for d in op_dicts],
            carry.history_from_dicts(op_dicts))


def normalise(d):
    """A result dict as JSON carries it, without the JAX package's
    supervision telemetry (the port has no supervisor)."""
    d = json.loads(json.dumps(d, default=str))
    if isinstance(d, dict):
        d.pop("supervision", None)
    return d


def fields(r) -> dict:
    return {"valid": r.valid,
            "op": None if r.op is None else r.op.to_dict(),
            "configs": r.configs, "cache_size": r.cache_size,
            "steps": r.steps, "best_linearization": r.best_linearization}


def test_slow_cases_are_named():
    names = {c["name"] for c in CASES}
    assert SLOW <= names
    assert len(FAST) >= 200


@pytest.mark.parametrize("case", FAST, ids=[c["name"] for c in FAST])
def test_linear_matches_jax(case):
    """The same sweep on the same history, under the case's own
    `params.budget` (max_configs) where it has one: every field equal,
    `configs` in the same order (the configuration sets iterate alike:
    the models hash and print as the JAX package's)."""
    jm, tm = (c() for c in MODELS[case["model"]])
    jh, th = both(case["history"])
    budget = case["params"].get("budget")
    kw = {"max_configs": budget["max_configs"]} if budget else {}
    jr = jlinear.analysis(jm, jh, **kw)
    tr = linear.analysis(tm, th, **kw)
    assert fields(tr) == fields(jr)
    assert normalise(tr.to_dict()) == normalise(jr.to_dict())
    if budget:
        assert tr.valid == "unknown"


def test_constants_match_jax():
    assert linear.MAX_CONFIGS_REPORTED == jlinear.MAX_CONFIGS_REPORTED == 10
    assert linear.DEFAULT_MAX_CONFIGS == jlinear.DEFAULT_MAX_CONFIGS


# -- NoOp and GrowOnlySet --------------------------------------------------

def _h(*specs):
    """Ops from (process, type, f, value) tuples, indexed."""
    return [{"process": p, "type": t, "f": f, "value": v, "time": i,
             "index": i} for i, (p, t, f, v) in enumerate(specs)]


SET_HISTORIES = {
    "adds_then_read": _h((0, "invoke", "add", 1), (0, "ok", "add", 1),
                         (1, "invoke", "add", 2), (1, "ok", "add", 2),
                         (0, "invoke", "read", None),
                         (0, "ok", "read", [1, 2])),
    "concurrent_read": _h((0, "invoke", "add", 1), (1, "invoke", "read", None),
                          (1, "ok", "read", []), (0, "ok", "add", 1)),
    "lost_add": _h((0, "invoke", "add", 1), (0, "ok", "add", 1),
                   (1, "invoke", "read", None), (1, "ok", "read", [])),
    "crashed_add": _h((0, "invoke", "add", 3), (0, "info", "add", 3),
                      (1, "invoke", "read", None), (1, "ok", "read", [3]),
                      (1, "invoke", "read", None), (1, "ok", "read", [3])),
    "unknown_op": _h((0, "invoke", "remove", 1), (0, "ok", "remove", 1)),
}


@pytest.mark.parametrize("name", sorted(SET_HISTORIES))
def test_grow_only_set_matches_jax(name):
    jh, th = both(SET_HISTORIES[name])
    jr = jlinear.analysis(jmodels.GrowOnlySet(), jh)
    tr = linear.analysis(tmodels.GrowOnlySet(), th)
    assert fields(tr) == fields(jr)
    jw = jlin_mod.wgl_host.analysis(jmodels.GrowOnlySet(), jh)
    tw = wgl_host.analysis(tmodels.GrowOnlySet(), th)
    assert (tw.valid, tw.steps) == (jw.valid, jw.steps)
    assert tmodels.GrowOnlySet().step("add", 1) == tmodels.GrowOnlySet(
        frozenset({1}))
    assert str(tmodels.GrowOnlySet(frozenset({1}))) == str(
        jmodels.GrowOnlySet(frozenset({1})))


@pytest.mark.parametrize("seed", range(6))
def test_noop_matches_jax(seed):
    """NoOp accepts every history of tests/test_linear.py's generator,
    corrupt reads included, in both packages alike."""
    hist = random_register_history(n_process=3, n_ops=10, seed=seed,
                                   corrupt=0.3)
    jh, th = both([o.to_dict() for o in hist])
    jr = jlinear.analysis(jmodels.NoOp(), jh)
    tr = linear.analysis(tmodels.noop(), th)
    assert fields(tr) == fields(jr)
    assert tr.valid is True
    assert str(tmodels.NoOp()) == str(jmodels.noop())
    from jepsen_tpu_torch.models import jit as tjit
    assert tjit.for_model(tmodels.NoOp()) is None
    assert tjit.for_model(tmodels.GrowOnlySet()) is None


# -- the checker under "linear" ---------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_linear_checker_matches_jax(seed):
    """`check` and `check_batch` under "linear": the JAX package's dicts
    (configs truncated to TRUNCATE), and check_batch item by item equal
    to check."""
    hists = [random_register_history(n_process=3, n_ops=14, seed=seed * 10 + i,
                                     corrupt=0.3 * (i % 2)) for i in range(3)]
    pairs = [both([o.to_dict() for o in h]) for h in hists]
    tc = linearizable(tmodels.CASRegister(), algorithm="linear")
    jc = jlinearizable(jmodels.CASRegister(), algorithm="linear")
    for jh, th in pairs:
        assert normalise(tc.check({}, th, {})) == normalise(
            jc.check({}, jh, {}))
    tb = tc.check_batch({}, [(th, {}) for _, th in pairs])
    jb = jc.check_batch({}, [(jh, {}) for jh, _ in pairs])
    assert normalise(tb) == normalise(jb)


def test_linear_checker_truncates_configs():
    """More than TRUNCATE surviving configurations: both keep the first
    TRUNCATE (linear reports at most MAX_CONFIGS_REPORTED anyway)."""
    ops = []
    for p in range(12):
        ops += [(p, "invoke", "write", p)]
    for p in range(12):
        ops += [(p, "info", "write", p)]
    ops += [(20, "invoke", "read", None), (20, "ok", "read", 3)]
    jh, th = both(_h(*ops))
    td = linearizable(tmodels.CASRegister(), algorithm="linear").check(
        {}, th, {})
    jd = jlinearizable(jmodels.CASRegister(), algorithm="linear").check(
        {}, jh, {})
    assert normalise(td) == normalise(jd)
    assert len(td["configs"]) == lin_mod.TRUNCATE


# -- "competition" ----------------------------------------------------------

#: small corpus cases (one n_pad, so the JAX package's search compiles
#: once a model)
COMPETITION_CASES = ["cas-2p-8ops-c0.0", "cas-2p-8ops-c0.3",
                     "cas-3p-10ops-c0.15", "cas-3p-10ops-c0.3",
                     "cas-3p-16ops-c0.3"]


class Blocked:
    """An entrant that waits until released, then reads "unknown"."""

    def __init__(self, result):
        self.release = threading.Event()
        self.result = result
        self.calls = 0

    def __call__(self, *a, **kw):
        self.calls += 1
        self.release.wait(60)
        return self.result


def _drain(*blocks):
    for b in blocks:
        b.release.set()
    lin_mod._drain_racers()
    jlin_mod._drain_racers()


@pytest.mark.parametrize("winner", ["linear", "wgl"])
@pytest.mark.parametrize("name", COMPETITION_CASES)
def test_competition_forced_winner_matches_jax(monkeypatch, name, winner):
    """Each entrant forced to win in both packages (the other blocks):
    the port's dict equals the JAX package's forced dict, and the
    forced winner's entrant is the card's search (wgl_search, K2's
    counterpart, on the CPU) where the JAX package's is its wgl_tpu."""
    (case,) = [c for c in CASES if c["name"] == name]
    jh, th = both(case["history"])
    if winner == "linear":
        tb = Blocked(wgl_host.WGLResult(valid="unknown"))
        jb = Blocked(jlin_mod.wgl_host.WGLResult(valid="unknown"))
        monkeypatch.setattr(wgl_search, "analysis", tb)
        monkeypatch.setattr(jwgl_tpu, "analysis", jb)
    else:
        tb = Blocked(linear.LinearResult(valid="unknown"))
        jb = Blocked(jlinear.LinearResult(valid="unknown"))
        monkeypatch.setattr(linear, "analysis", tb)
        monkeypatch.setattr(jlinear, "analysis", jb)
    wins = dict(lin_mod.COMPETITION_WINS)
    try:
        td = linearizable(tmodels.CASRegister(), algorithm="competition",
                          device="cpu").check({}, th, {})
        jd = jlinearizable(jmodels.CASRegister(),
                           algorithm="competition").check({}, jh, {})
    finally:
        _drain(tb, jb)
    assert tb.calls == 1 and jb.calls == 1
    assert normalise(td) == normalise(jd)
    assert td["valid"] == case["expected"]
    won = "linear" if winner == "linear" else "wgl_search"
    assert lin_mod.COMPETITION_WINS[won] == wins[won] + 1


def test_competition_without_encoding_races_native_or_host():
    """A model without a kernel encoding (GrowOnlySet) races linear
    against the host search; both packages agree."""
    jh, th = both(SET_HISTORIES["lost_add"])
    td = linearizable(tmodels.GrowOnlySet(), algorithm="competition",
                      device="cpu").check({}, th, {})
    jd = jlinearizable(jmodels.GrowOnlySet(),
                       algorithm="competition").check({}, jh, {})
    assert td["valid"] is False and jd["valid"] is False
    name, _ = lin_mod.Linearizable(
        tmodels.GrowOnlySet(), "competition")._wgl_entrant(
        tmodels.GrowOnlySet(), lin_mod.make_entries(th))
    assert name == "host"


#: errors of the card's search: a failed launch, and the torch errors a
#: launch can surface as (an illegal address at a later sync, a scratch
#: allocation that does not fit)
CARD_ERRORS = [
    KernelError("wgl_search launch failed: an illegal address"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
]


@pytest.mark.parametrize("error", CARD_ERRORS,
                         ids=lambda e: type(e).__name__)
def test_competition_reraises_kernel_error(monkeypatch, error):
    """A WGL entrant on the card that raises before the race is decided:
    `check` raises its error, whatever its type (the JAX package would
    read "unknown")."""
    blocked = Blocked(linear.LinearResult(valid="unknown"))

    def broken(*a, **kw):
        raise error

    monkeypatch.setattr(linear, "analysis", blocked)
    monkeypatch.setattr(wgl_search, "analysis", broken)
    (case,) = [c for c in CASES if c["name"] == COMPETITION_CASES[0]]
    _, th = both(case["history"])
    try:
        with pytest.raises(type(error)):
            linearizable(tmodels.CASRegister(), algorithm="competition",
                         device="cpu").check({}, th, {})
    finally:
        _drain(blocked)


@pytest.mark.parametrize("error", CARD_ERRORS[:2],
                         ids=lambda e: type(e).__name__)
def test_abandoned_loser_fault_raised_by_drain(monkeypatch, error):
    """An error an abandoned card search meets after linear won is kept
    and raised by `_drain_racers`, once."""
    late = threading.Event()

    def broken_late(*a, **kw):
        late.wait(60)
        raise error

    monkeypatch.setattr(wgl_search, "analysis", broken_late)
    (case,) = [c for c in CASES if c["name"] == COMPETITION_CASES[1]]
    _, th = both(case["history"])
    d = linearizable(tmodels.CASRegister(), algorithm="competition",
                     device="cpu").check({}, th, {})
    assert d["valid"] == case["expected"]
    late.set()
    with pytest.raises(type(error)):
        lin_mod._drain_racers()
    lin_mod._drain_racers()  # raised once, then cleared
    assert not lin_mod._abandoned_racers


def test_competition_missing_card_raises_before_race(monkeypatch):
    """device=None on a host without CUDA: `check` raises
    CudaUnavailable before any entrant runs, so the outcome does not
    depend on how fast linear decides the history."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(linear, "analysis",
                        lambda *a, **kw: calls.append(1))
    (case,) = [c for c in CASES if c["name"] == COMPETITION_CASES[0]]
    _, th = both(case["history"])
    with pytest.raises(CudaUnavailable):
        linearizable(tmodels.CASRegister(),
                     algorithm="competition").check({}, th, {})
    assert calls == []
    lin_mod._drain_racers()


def test_competition_host_entrant_error_reads_unknown(monkeypatch):
    """A host entrant's error is no card fault: it reads "unknown", as
    in the JAX package, and linear's definite verdict wins."""

    def broken(*a, **kw):
        raise RuntimeError("host search failed")

    monkeypatch.setattr(wgl_host, "analysis", broken)
    _, th = both(SET_HISTORIES["lost_add"])
    d = linearizable(tmodels.GrowOnlySet(), algorithm="competition",
                     device="cpu").check({}, th, {})
    assert d["valid"] is False
    lin_mod._drain_racers()
