"""The port's native engine and its "auto" policy, against the JAX
package: `ops/wgl_native` field for field on the verdict corpus, the
batched "auto" (native triage and finish, the card half steered on the
CPU) result dicts, the native finish of card unknowns, deadlines, and
counterexample recovery. Verdicts, step counts and counterexamples are
exact (tolerance zero)."""

import importlib
import json
import os
import time

import pytest

from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable
from jepsen_tpu.ops import wgl_native as jnative

from jepsen_tpu_torch import carry, independent
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.history import entries as make_entries
from jepsen_tpu_torch.ops import _build, wgl_host, wgl_native, wgl_vec
from jepsen_tpu_torch.workloads.register import keyed_history

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


def normalise(d):
    """A result dict as JSON carries it, without the JAX package's
    supervision telemetry (the port has no supervisor)."""
    d = json.loads(json.dumps(d, default=str))
    if isinstance(d, dict):
        d.pop("supervision", None)
    return d


def _native_cases():
    """Every corpus case the JAX package's native engine takes (263 in
    PARITY.json)."""
    out = []
    with open(CORPUS) as fh:
        for case in map(json.loads, fh):
            jm = MODELS[case["model"]][0]()
            hist = [jhist.Op.from_dict(d) for d in case["history"]]
            if jnative.eligible(jm, jhist.entries(hist)):
                out.append(case)
    return out


NATIVE_CASES = _native_cases()


def test_native_takes_the_reference_count():
    assert len(NATIVE_CASES) == 263


@pytest.mark.parametrize("case", NATIVE_CASES,
                         ids=[c["name"] for c in NATIVE_CASES])
def test_native_matches_jax_native(case):
    """The same search on the same lane: valid, steps, cache_size, op and
    best_linearization identical; the verdict is the corpus's (an
    "unknown" case under its recorded step budget)."""
    jm, tm = (c() for c in MODELS[case["model"]])
    hist = carry.history_from_dicts(case["history"])
    assert wgl_native.eligible(tm, make_entries(hist))
    kw = {"max_steps": (case["params"]["budget"]["max_steps"]
                        if case["expected"] == "unknown" else 5_000_000)}
    jr = jnative.analysis(jm, [jhist.Op.from_dict(d)
                               for d in case["history"]], **kw)
    tr = wgl_native.analysis(tm, hist, **kw)
    assert normalise(tr.to_dict()) == normalise(jr.to_dict())
    assert tr.valid == case["expected"] or (
        tr.valid == "unknown" and "linear" in case["oracle"])


def jax_keyed(hist):
    out = []
    for o in hist:
        v = o.value
        if isinstance(v, independent.KVTuple):
            v = jind.KVTuple(v.key, v.value)
        out.append(jhist.Op.from_dict({**o.to_dict(), "value": v}))
    return out


KEYED = [
    ("seed0", dict(n_keys=10, n_ops=10, n_process=3, bad_every=3, seed=0)),
    ("seed1", dict(n_keys=10, n_ops=10, n_process=3, bad_every=3, seed=1)),
    ("late", dict(n_keys=8, n_ops=12, n_process=3, bad_every=2,
                  bad_read="random", seed=2)),
    ("late_deep", dict(n_keys=6, n_ops=60, n_process=5, bad_every=2,
                       bad_read="random", seed=3)),
]


@pytest.mark.parametrize("kw", [k for _, k in KEYED],
                         ids=[n for n, _ in KEYED])
def test_auto_matches_jax_auto(kw):
    """Without a card ("cpu") the port's "auto" is the JAX package's
    "auto" on a host without a TPU: native triage, then native finish.
    The keyed result dicts are identical, and no kernel launches."""
    n_keys = kw.pop("n_keys")
    n_ops = kw.pop("n_ops")
    hist = keyed_history(n_keys, n_ops, **kw)
    wgl_vec.CAPTURE = []
    try:
        tr = independent.checker(linearizable(
            tmodels.CASRegister(), device="cpu")).check({}, hist, {})
        assert wgl_vec.CAPTURE == []
    finally:
        wgl_vec.CAPTURE = None
    jr = jind.checker(jlinearizable(jmodels.CASRegister())).check(
        {}, jax_keyed(hist), {})
    assert normalise(tr) == normalise(jr)
    assert tr["valid"] is False


def test_single_history_auto_matches_jax_auto():
    """A single check is a batch of one: the JAX package's native-first
    choice, the same dict."""
    hist = keyed_history(1, 40, n_process=4, bad_every=1, bad_read="random",
                         seed=5)
    sub = [o.with_(value=o.value.value) for o in hist]
    tr = linearizable(tmodels.CASRegister(), device="cpu").check({}, sub, {})
    jr = jlinearizable(jmodels.CASRegister()).check(
        {}, [jhist.Op.from_dict(o.to_dict()) for o in sub], {})
    assert normalise(tr) == normalise(jr)
    assert tr["valid"] is False


def test_card_unknowns_finished_by_native(monkeypatch):
    """A bar of 1 sends every lane to gpu_vec with no triage; at a
    2,000-step card budget its bounded memo leaves late refutations
    "unknown", and native finishes every such lane: no unknown is left,
    every verdict is native's own, and NATIVE_FINISH counts the lanes."""
    monkeypatch.setattr(lin_mod, "_card_present", lambda device: True)
    monkeypatch.setattr(lin_mod, "GPU_BATCH_MIN",
                        {k: 1 for k in lin_mod.GPU_BATCH_MIN})
    monkeypatch.setattr(lin_mod.Linearizable, "_max_steps",
                        lambda self: 2000)
    hist = keyed_history(6, 60, n_process=5, bad_every=2, bad_read="random",
                         seed=3)
    before = lin_mod.NATIVE_FINISH
    wgl_vec.CAPTURE = []
    try:
        card = independent.checker(linearizable(
            tmodels.CASRegister(), device="cpu")).check({}, hist, {})
        launches = wgl_vec.CAPTURE
    finally:
        wgl_vec.CAPTURE = None
    assert launches, "the batch did not go to gpu_vec"
    subs = independent._split(hist, list(range(6)))
    alone = wgl_vec.analysis_batch(
        tmodels.CASRegister(), [make_entries(subs[k]) for k in range(6)],
        max_steps=2000, device="cpu")
    unknown_on_card = [k for k, r in enumerate(alone) if r.valid == "unknown"]
    assert unknown_on_card, "no lane ran out of the card's budget"
    assert lin_mod.NATIVE_FINISH - before == len(unknown_on_card)
    for k, r in card["results"].items():
        assert r["valid"] != "unknown", k
        nr = wgl_native.analysis(tmodels.CASRegister(), subs[k])
        assert r["valid"] == nr.valid, k
        if k in unknown_on_card:
            assert normalise(r) == normalise(
                lin_mod.Linearizable()._result(nr)), k
    assert card["failures"] == [0, 2, 4]


@pytest.mark.parametrize("kind", ["scalar", "fifo-queue"])
def test_bar_is_read_per_model_kind(monkeypatch, kind):
    """GPU_BATCH_MIN is keyed by (card engine, model kind): a bar of 1 for
    gpu_vec on one kind sends that kind's batch to gpu_vec whole, while a
    batch of the other kind, whose bar is None, takes native with no
    launch; the verdicts are native's either way."""
    from jepsen_tpu_torch.workloads.queue import queue_history

    monkeypatch.setattr(lin_mod, "_card_present", lambda device: True)
    monkeypatch.setattr(lin_mod, "GPU_BATCH_MIN",
                        {k: 1 if k == ("gpu_vec", kind) else None
                         for k in lin_mod.GPU_BATCH_MIN})
    assert set(lin_mod.GPU_BATCH_MIN) >= {("gpu_vec", "scalar"),
                                          ("gpu_vec", "fifo-queue")}
    cases = {"scalar": (tmodels.CASRegister(), [
                 make_entries([o.with_(value=o.value.value) for o in
                               keyed_history(1, 20, n_process=3,
                                             bad_every=1, seed=s)])
                 for s in range(3)]),
             "fifo-queue": (tmodels.FIFOQueue(), [
                 make_entries(queue_history(n_process=3, n_ops=16,
                                            fifo=True, seed=s))
                 for s in range(3)])}
    for k, (model, ess) in cases.items():
        assert lin_mod.bar_kind(model) == k
        wgl_vec.CAPTURE = []
        try:
            rs = linearizable(model, device="cpu")._results(model, ess)
            launched = bool(wgl_vec.CAPTURE)
        finally:
            wgl_vec.CAPTURE = None
        assert launched == (k == kind), (k, kind)
        assert [r.valid for r in rs] == [
            r.valid for r in wgl_native.analysis_batch(model, ess)], k


TWO_OPS = [
    {"process": 0, "type": "invoke", "f": "write", "value": 1},
    {"process": 0, "type": "ok", "f": "write", "value": 1},
    {"process": 0, "type": "invoke", "f": "read", "value": None},
    {"process": 0, "type": "ok", "f": "read", "value": 2},
]


def _indexed(dicts):
    return [{**d, "time": i, "index": i} for i, d in enumerate(dicts)]


@pytest.mark.parametrize("algorithm", ["host", "native", "auto"])
def test_deadline_matches_jax(algorithm):
    """Faults 2 and 4: a budget already spent gives the JAX package's
    {"valid": "unknown", "error": "deadline", ...} for one history; a
    batch gives the JAX package's own `check_batch` dicts (under "auto"
    its native triage ignores the budget and refutes the easy lanes,
    elsewhere every item is unknown); without the budget the history is
    refuted."""
    dicts = _indexed(TWO_OPS)
    hist = carry.history_from_dicts(dicts)
    jh = [jhist.Op.from_dict(d) for d in dicts]
    test = {"deadline": time.monotonic() - 1}
    chk = linearizable(tmodels.CASRegister(), algorithm=algorithm,
                       device="cpu")
    jchk = jlinearizable(jmodels.CASRegister(), algorithm=algorithm)
    tr = chk.check(test, hist, {})
    jr = jchk.check(test, jh, {})
    assert normalise(tr) == normalise(jr) == {
        "valid": "unknown", "error": "deadline", "cache_size": 0,
        "steps": 0}
    tb = chk.check_batch(test, [(hist, {}), (hist, {})])
    jb = jchk.check_batch(test, [(jh, {}), (jh, {})])
    assert [normalise(d) for d in tb] == [normalise(d) for d in jb]
    assert [d["valid"] for d in tb] == (
        [False, False] if algorithm == "auto" else ["unknown", "unknown"])
    assert chk.check({}, hist, {})["valid"] is False


def test_deadline_through_pcomp_split():
    """Fault 4: the same budget through a P-compositional split
    (single-key multi-register txns, split by key). The micro-lanes go
    through "auto"'s native triage, which ignores the budget in both
    packages, so `check` and `check_batch` give the JAX package's own
    MultiRegister dicts: the easy lane is refuted."""
    dicts = _indexed([{**d, "f": "txn", "value": [
        ["w" if d["f"] == "write" else "r", "x", d["value"]]]}
        for d in TWO_OPS])
    hist = carry.history_from_dicts(dicts)
    jh = [jhist.Op.from_dict(d) for d in dicts]
    chk = linearizable(tmodels.MultiRegister(), device="cpu")
    jchk = jlinearizable(jmodels.MultiRegister(), algorithm="auto")
    assert chk._split(tmodels.MultiRegister(), [make_entries(hist)])
    test = {"deadline": time.monotonic() - 1}
    tr = chk.check(test, hist, {})
    assert normalise(tr) == normalise(jchk.check(test, jh, {}))
    assert tr["valid"] is False
    assert [normalise(d) for d in chk.check_batch(test, [(hist, {})])] == [
        normalise(d) for d in jchk.check_batch(test, [(jh, {})])]
    assert chk.check({}, hist, {}) == tr


def test_pcomp_lanes_share_one_deadline(monkeypatch):
    """Fault 4: "auto"'s native triage takes no time limit in either
    package (only TRIAGE_MAX_STEPS); the native finish of the
    micro-lanes of one check gets the remainder of ONE time_limit, less
    than the whole limit, in both."""
    limits, jlimits = [], []
    real, jreal = wgl_native.analysis_batch, jnative.analysis

    def spy(model, ess, max_steps=None, time_limit=None, **kw):
        limits.append(time_limit)
        return real(model, ess, max_steps=max_steps, time_limit=time_limit,
                    **kw)

    def jspy(model, es, time_limit=None, **kw):
        jlimits.append(time_limit)
        return jreal(model, es, time_limit=time_limit, **kw)

    monkeypatch.setattr(wgl_native, "analysis_batch", spy)
    monkeypatch.setattr(jnative, "analysis", jspy)
    dicts = _indexed([{**d, "f": "txn", "value": [
        ["w" if d["f"] == "write" else "r", k,
         1 if d["type"] == "ok" else d["value"]]]}
        for k in "xy" for d in TWO_OPS])
    hist = carry.history_from_dicts(dicts)
    jh = [jhist.Op.from_dict(d) for d in dicts]
    chk = linearizable(tmodels.MultiRegister(), time_limit=100.0,
                       device="cpu")
    jchk = jlinearizable(jmodels.MultiRegister(), algorithm="auto",
                         time_limit=100.0)
    assert chk.check({}, hist, {})["valid"] is True
    assert jchk.check({}, jh, {})["valid"] is True
    # the triage resolved every lane: one call here, one a lane there
    assert limits == [None] and jlimits == [None, None]
    monkeypatch.setattr(lin_mod, "TRIAGE_MAX_STEPS", 1)
    monkeypatch.setattr(jlin_mod, "TRIAGE_MAX_STEPS", 1)
    limits.clear()
    jlimits.clear()
    assert chk.check({}, hist, {})["valid"] is True
    assert jchk.check({}, jh, {})["valid"] is True
    assert limits[0] is None and jlimits[:2] == [None, None]
    assert len(limits) == 2 and 0 < limits[1] < 100.0
    assert len(jlimits) > 2 and all(0 < t < 100.0 for t in jlimits[2:])


def test_recover_invalid_takes_native(monkeypatch):
    """Lanes native takes recover their counterexample there (the same
    one as the Python search's); others take the Python search."""
    calls = []
    real = wgl_native.analysis_batch

    def spy(model, ess, **kw):
        calls.extend(len(es) for es in ess)
        return real(model, ess, **kw)

    monkeypatch.setattr(wgl_native, "analysis_batch", spy)
    hist = keyed_history(1, 20, n_process=3, bad_every=1, seed=1)
    es = make_entries([o.with_(value=o.value.value) for o in hist])
    r = wgl_host.recover_invalid(tmodels.CASRegister(), es)
    assert calls == [len(es)] and r.valid is False
    assert r.to_dict() == wgl_host.analysis(tmodels.CASRegister(),
                                            es).to_dict()
    big = make_entries(carry.history_from_dicts(_indexed([
        {"process": 0, "type": "invoke", "f": "write", "value": 2**40},
        {"process": 0, "type": "ok", "f": "write", "value": 2**40},
        {"process": 0, "type": "invoke", "f": "read", "value": None},
        {"process": 0, "type": "ok", "f": "read", "value": 1}])))
    assert not wgl_native.eligible(tmodels.CASRegister(), big)
    assert wgl_host.recover_invalid(tmodels.CASRegister(),
                                    big).valid is False
    assert calls == [len(es)]


def test_native_build_failure_raises(monkeypatch):
    """A native library that does not build raises NativeUnavailable,
    through "auto" too: nothing falls back to the Python search."""
    def fail(name, signatures):
        raise _build.BuildError("g++ failed")

    monkeypatch.setattr(_build, "load_host", fail)
    with pytest.raises(wgl_native.NativeUnavailable):
        wgl_native.build()
    hist = carry.history_from_dicts(_indexed(TWO_OPS))
    with pytest.raises(wgl_native.NativeUnavailable):
        linearizable(tmodels.CASRegister(), device="cpu").check({}, hist, {})
    with pytest.raises(wgl_native.NativeUnavailable):
        independent.checker(linearizable(
            tmodels.CASRegister(), device="cpu")).check(
            {}, keyed_history(1, 4, n_process=2, seed=0), {})


def test_native_build_is_cached():
    """The g++ route shares the digest-keyed cache: a second build
    returns the loaded library."""
    lib = wgl_native.build()
    assert wgl_native.build() is lib
    assert any(f.startswith("wgl_native-") and f.endswith(".so")
               for f in os.listdir(_build.BUILD_DIR))
    with pytest.raises(wgl_native.NativeUnavailable):
        wgl_native.analysis(tmodels.CASRegister(), make_entries(
            carry.history_from_dicts(_indexed([
                {"process": 0, "type": "invoke", "f": "write",
                 "value": 2**40},
                {"process": 0, "type": "ok", "f": "write",
                 "value": 2**40}]))))


def test_loaded_library_skips_source(monkeypatch, tmp_path):
    """A library loaded once is handed back without its source being
    read again (every launch looks its library up); with the process's
    cache cleared the source is read and hashed anew."""
    lib = wgl_native.build()
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    assert wgl_native.build() is lib
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(FileNotFoundError):
        wgl_native.build()


def test_native_batch_pool_matches_single():
    """analysis_batch over the thread pool returns each lane's own
    analysis."""
    hist = keyed_history(12, 16, n_process=3, bad_every=3, bad_read="random",
                         seed=7)
    subs = independent._split(hist, list(range(12)))
    ess = [make_entries(subs[k]) for k in range(12)]
    batch = wgl_native.analysis_batch(tmodels.CASRegister(), ess)
    for es, r in zip(ess, batch):
        assert r.to_dict() == wgl_native.analysis(
            tmodels.CASRegister(), es).to_dict()
