"""The port's checker combinators, registry and host checkers
(jepsen_tpu_torch.checker: compose, concurrency_limit,
unbridled_optimism, REGISTRY/resolve; checker/basic.py: queue, set,
set-full, total-queue, unique-ids, counter) against the JAX package's
on every input of tests/test_checker.py's TestMergeValid, TestCompose,
TestSetChecker, TestSetFull, TestQueueCheckers, TestUniqueIds and
TestCounter, and every registered checker on the same history. Result
dicts must be equal, with ops compared by `to_dict`. Also: a fault of
the card raises through compose (it never reads "unknown")."""

import json
import threading
import time

import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels

from jepsen_tpu_torch import checker
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.device import KernelError


def normalise(d):
    """A result dict as JSON carries it, ops by `to_dict`, models by
    str, without the JAX package's supervision telemetry (the port has
    no supervisor)."""
    if isinstance(d, dict):
        d = {k: v for k, v in d.items() if k != "supervision"}

    def default(o):
        if hasattr(o, "to_dict"):
            return o.to_dict()
        if isinstance(o, (set, frozenset)):
            return sorted(o, key=repr)
        return str(o)
    return json.loads(json.dumps(d, default=default))


def hists(*specs):
    """The same history in both packages, indexed: each spec is
    (type, process, f, value[, time])."""
    out = []
    for mod in (jhist, thist):
        ops = []
        for spec in specs:
            typ, p, f, v = spec[:4]
            kw = {"time": spec[4]} if len(spec) > 4 else {}
            ops.append(mod.Op(p, typ, f, v, **kw))
        out.append(mod.index(ops))
    return out


def same(jc, tc, specs, test=None):
    """Both checkers on the same history; their dicts equal. Returns
    the port's dict."""
    jh, th = hists(*specs)
    jr = jc.check(dict(test or {}), jh, {})
    tr = tc.check(dict(test or {}), th, {})
    assert normalise(tr) == normalise(jr)
    return tr


def test_merge_valid_dominance():
    for vs in ([], [True, True], [True, "unknown"], [False, "unknown", True],
               ["unknown"], [False]):
        assert checker.merge_valid(vs) == jchecker.merge_valid(vs)
    with pytest.raises(ValueError):
        checker.merge_valid(["maybe"])


ADD_1 = [("invoke", 0, "add", 1), ("ok", 0, "add", 1)]


def test_compose():
    r = same(jchecker.compose({"opt": jchecker.unbridled_optimism(),
                               "set": jchecker.set_checker()}),
             checker.compose({"opt": checker.unbridled_optimism(),
                              "set": checker.set_checker()}), ADD_1)
    assert r["valid"] == "unknown" and r["opt"]["valid"] is True


def test_check_safe_wraps_errors():
    class JBoom(jchecker.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("boom")

    class TBoom(checker.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("boom")

    jr = jchecker.check_safe(JBoom(), {}, [], {})
    tr = checker.check_safe(TBoom(), {}, [], {})
    assert tr["valid"] == jr["valid"] == "unknown"
    assert "boom" in tr["error"] and "boom" in jr["error"]
    # composed: the same unknown, the error beside it
    r = checker.compose({"boom": TBoom()}).check({}, [], {})
    assert r["valid"] == "unknown" and "boom" in r["boom"]["error"]


def test_compose_raises_card_faults():
    """A fault of the card in one composed checker raises; it never
    reads as that checker's "unknown" (the JAX package's compose reads
    every exception as unknown)."""
    class Fault(checker.Checker):
        def check(self, test, history, opts=None):
            raise KernelError("launch failed")

    with pytest.raises(KernelError):
        checker.compose({"ok": checker.unbridled_optimism(),
                         "card": Fault()}).check({}, [], {})


def test_concurrency_limit_bounds_concurrent_checks():
    live, peak, lock = [0], [0], threading.Lock()

    class Slow(checker.Checker):
        def check(self, test, history, opts=None):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.02)
            with lock:
                live[0] -= 1
            return {"valid": True}

    lim = checker.concurrency_limit(2, Slow())
    r = checker.compose({str(i): lim for i in range(6)}).check({}, [], {})
    assert r["valid"] is True and peak[0] == 2


SET_CASES = {
    "ok": [("invoke", 0, "add", 1), ("ok", 0, "add", 1),
           ("invoke", 0, "add", 2), ("ok", 0, "add", 2),
           ("invoke", 1, "read", None), ("ok", 1, "read", [1, 2])],
    "lost_and_unexpected": [
        ("invoke", 0, "add", 1), ("ok", 0, "add", 1),
        ("invoke", 0, "add", 2), ("ok", 0, "add", 2),
        ("invoke", 1, "read", None), ("ok", 1, "read", [2, 99])],
    "recovered": [("invoke", 0, "add", 1), ("info", 0, "add", 1),
                  ("invoke", 1, "read", None), ("ok", 1, "read", [1])],
    "never_read": ADD_1,
}


@pytest.mark.parametrize("case", sorted(SET_CASES))
def test_set_checker(case):
    same(jchecker.set_checker(), checker.set_checker(), SET_CASES[case])


SET_FULL_CASES = {
    "stable": [("invoke", 0, "add", 1, 0), ("ok", 0, "add", 1, 1),
               ("invoke", 1, "read", None, 2), ("ok", 1, "read", {1}, 3)],
    "lost": [("invoke", 0, "add", 1, 0), ("ok", 0, "add", 1, 1),
             ("invoke", 1, "read", None, 2), ("ok", 1, "read", {1}, 3),
             ("invoke", 1, "read", None, 4), ("ok", 1, "read", set(), 5)],
    "stale": [("invoke", 0, "add", 1, 0), ("ok", 0, "add", 1, 1_000_000),
              ("invoke", 1, "read", None, 2_000_000),
              ("ok", 1, "read", set(), 3_000_000),
              ("invoke", 1, "read", None, 4_000_000),
              ("ok", 1, "read", {1}, 5_000_000)],
    "no_stable": [("invoke", 0, "add", 1), ("info", 0, "add", 1)],
    "never_read_concurrent": [
        ("invoke", 1, "read", None, 0), ("invoke", 0, "add", 1, 1),
        ("ok", 1, "read", set(), 2), ("ok", 0, "add", 1, 3)],
}


@pytest.mark.parametrize("linearizable", [False, True])
@pytest.mark.parametrize("case", sorted(SET_FULL_CASES))
def test_set_full(case, linearizable):
    same(jchecker.set_full(linearizable=linearizable),
         checker.set_full(linearizable=linearizable), SET_FULL_CASES[case])


QUEUE_CASES = {
    "fold_ok": [("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
                ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 1)],
    "fold_bad": [("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 3)],
}

TOTAL_QUEUE_CASES = {
    "lost": [("invoke", 0, "enqueue", 1), ("ok", 0, "enqueue", 1),
             ("invoke", 0, "enqueue", 2), ("ok", 0, "enqueue", 2),
             ("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 1)],
    "drain_and_recovered": [
        ("invoke", 0, "enqueue", 1), ("info", 0, "enqueue", 1),
        ("invoke", 1, "drain", None), ("ok", 1, "drain", [1])],
    "unexpected": [("invoke", 1, "dequeue", None), ("ok", 1, "dequeue", 42)],
}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_queue_model_fold(case):
    r = same(jchecker.queue(jmodels.UnorderedQueue()),
             checker.queue(tmodels.UnorderedQueue()), QUEUE_CASES[case])
    assert r["valid"] is (case == "fold_ok")


@pytest.mark.parametrize("case", sorted(TOTAL_QUEUE_CASES))
def test_total_queue(case):
    same(jchecker.total_queue(), checker.total_queue(),
         TOTAL_QUEUE_CASES[case])


def test_total_queue_crashed_empty_drain_raises():
    """A crashed drain with no value cannot be expanded, in both."""
    specs = [("invoke", 1, "drain", None), ("info", 1, "drain", None)]
    jh, th = hists(*specs)
    with pytest.raises(ValueError):
        jchecker.total_queue().check({}, jh, {})
    with pytest.raises(ValueError):
        checker.total_queue().check({}, th, {})


UNIQUE_CASES = {
    "unique": [("invoke", 0, "generate", None), ("ok", 0, "generate", 1),
               ("invoke", 0, "generate", None), ("ok", 0, "generate", 2)],
    "duplicates": [("invoke", 0, "generate", None), ("ok", 0, "generate", 1),
                   ("invoke", 0, "generate", None), ("ok", 0, "generate", 1)],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(UNIQUE_CASES))
def test_unique_ids(case):
    same(jchecker.unique_ids(), checker.unique_ids(), UNIQUE_CASES[case])


COUNTER_CASES = {
    "within_bounds": [("invoke", 0, "add", 1), ("ok", 0, "add", 1),
                      ("invoke", 1, "read", None), ("ok", 1, "read", 1),
                      ("invoke", 0, "add", 2),
                      ("invoke", 1, "read", None), ("ok", 1, "read", 3)],
    "out_of_bounds": [("invoke", 0, "add", 1), ("ok", 0, "add", 1),
                      ("invoke", 1, "read", None), ("ok", 1, "read", 5)],
    "acknowledged_lower_bound": [
        ("invoke", 1, "read", None), ("invoke", 0, "add", 1),
        ("ok", 0, "add", 1), ("ok", 1, "read", 0)],
}


@pytest.mark.parametrize("case", sorted(COUNTER_CASES))
def test_counter(case):
    same(jchecker.counter(), checker.counter(), COUNTER_CASES[case])


REGISTER = [("invoke", 0, "write", 1, 0), ("ok", 0, "write", 1, 10),
            ("invoke", 1, "read", None, 20), ("ok", 1, "read", 2, 30),
            ("invoke", 2, "cas", [1, 3], 40), ("fail", 2, "cas", [1, 3], 50)]


def test_registry_names():
    assert sorted(checker.REGISTRY) == sorted(jchecker.REGISTRY)
    with pytest.raises(ValueError):
        checker.resolve("nope")


@pytest.mark.parametrize("name", sorted(jchecker.REGISTRY))
def test_resolve_every_registered_checker(name):
    """resolve(name, device="cpu") gives the JAX package's checker of
    that name: the same class name and, on the same register history
    (with the model on the test map), the same dict."""
    tc = checker.resolve(name, device="cpu")
    jc = jchecker.resolve(name)
    assert type(tc).__name__ == type(jc).__name__
    jh, th = hists(*REGISTER)
    jr = jc.check({"model": jmodels.CASRegister()}, jh, {})
    tr = tc.check({"model": tmodels.CASRegister()}, th, {})
    assert normalise(tr) == normalise(jr)
    if name == "linearizable":
        assert tr["valid"] is False


@pytest.mark.parametrize("name", ["linearizable", "cycle"])
def test_resolve_passes_device(name):
    assert checker.resolve(name, device="cpu").device == "cpu"
    assert checker.resolve(name).device is None
