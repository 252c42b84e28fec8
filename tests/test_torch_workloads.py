"""The port's workload checkers (workloads/bank.py, causal.py,
long_fork.py, adya.py) and generators (those and list_append.py's)
against the JAX package's on the inputs of
tests/test_workloads.py and tests/test_cycle_closure.py's adya cases,
and on seeded histories of 256 keys from chip_smoke.py's makers (the
shapes of the JAX package's g2_gen, LongForkGen and causal generator,
with planted anomalies), the cycle checker on the CPU (the kernels'
plain versions). Result dicts must be equal, with ops compared by
`to_dict`. Also: the legacy paths agree with the cycle paths, and the
checkers that reach the card raise without CUDA when no device is
given."""

import json
import os
import random
import time

import pytest
import torch

import chip_smoke
from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu import txn as jmop
from jepsen_tpu.workloads import adya as jadya
from jepsen_tpu.workloads import bank as jbank
from jepsen_tpu.workloads import causal as jcausal
from jepsen_tpu.workloads import long_fork as jlf

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import independent as tind
from jepsen_tpu_torch import txn as tmop
from jepsen_tpu_torch.device import CudaUnavailable
from jepsen_tpu_torch.workloads import adya, bank, causal, long_fork


def normalise(d):
    """A result dict as JSON carries it, ops by `to_dict`, without the
    JAX package's supervision telemetry (the port has no supervisor)."""
    if isinstance(d, dict):
        d = {k: v for k, v in d.items() if k != "supervision"}
    return json.loads(json.dumps(
        d, default=lambda o: o.to_dict() if hasattr(o, "to_dict")
        else str(o)))


def to_jax(history) -> list:
    """A port history as the JAX package's Ops (KVTuples too)."""
    out = []
    for o in history:
        v = o.value
        if tind.is_tuple(v):
            v = jind.tuple_(v.key, v.value)
        out.append(jhist.Op(o.process, o.type, o.f, v, time=o.time,
                            index=o.index, error=o.error,
                            extra=dict(o.extra)))
    return out


def same(jc, tc, history, test=None):
    """Both checkers on the same (port) history; their dicts equal.
    Returns the port's dict."""
    tr = tc.check(dict(test or {}), history, {})
    jr = jc.check(dict(test or {}), to_jax(history), {})
    assert normalise(tr) == normalise(jr)
    return tr


# ---------------------------------------------------------------------------
# bank

def bank_read(v, index=1, type="ok"):
    return [thist.Op(0, "invoke", "read", None, index=index - 1),
            thist.Op(0, type, "read", v, index=index)]


def balances(**over):
    v = {a: 0 for a in range(8)}
    v[0] = 100
    v.update({int(k[1:]): x for k, x in over.items()})
    return v


BANK_CASES = {
    "valid": bank_read(balances()),
    "wrong_total": bank_read({a: 0 for a in range(8)}),
    "negative_value": bank_read(balances(a0=105, a1=-5)),
    "nil_balance": bank_read(balances(a3=None)),
    "unexpected_key": bank_read({a: 100 if a == 0 else 0
                                 for a in range(9)}),
    "worst_by_badness": (bank_read(balances(a0=99), index=1)
                         + bank_read(balances(a0=0), index=3)),
    "failed_read_ignored": bank_read(None, type="fail"),
}


@pytest.mark.parametrize("case", sorted(BANK_CASES))
def test_bank_checker(case):
    test = {k: v for k, v in jbank.test().items()
            if k in ("accounts", "total_amount", "max_transfer")}
    r = same(jbank.checker(), bank.checker(), BANK_CASES[case], test)
    assert r["valid"] is (case in ("valid", "failed_read_ignored"))


def test_bank_err_badness():
    test = {"total_amount": 100}
    for err in ({"type": "unexpected-key", "unexpected": [9, 10]},
                {"type": "nil-balance", "nils": {3: None}},
                {"type": "wrong-total", "total": 50},
                {"type": "negative-value", "negative": [-3, -4]},
                {"type": "other"}):
        assert bank.err_badness(test, err) == jbank.err_badness(test, err)


def bank_timeline(n=20):
    h = []
    for i in range(n):
        h += [thist.Op(i % 3, "invoke", "read", None, time=i * 10**9,
                       index=2 * i),
              thist.Op(i % 3, "ok", "read", balances(), time=i * 10**9 + 100,
                       index=2 * i + 1)]
    return h


def test_bank_points_and_by_node():
    h = bank_timeline()
    test = {"nodes": ["n1", "n2"]}
    assert bank.points(h) == jbank.points(to_jax(h))
    got = {n: [o.to_dict() for o in os_]
           for n, os_ in bank.by_node(test, h).items()}
    want = {n: [o.to_dict() for o in os_]
            for n, os_ in jbank.by_node(test, to_jax(h)).items()}
    assert got == want


def test_bank_plotter(tmp_path):
    """bank.png where the JAX package writes it, the same dict."""
    def test(root):
        return {"name": "bank-plot", "start_time": "20260101T000000.000",
                "store_dir": str(root), "nodes": ["n1", "n2", "n3"]}

    h = bank_timeline()
    jr = jbank.plotter().check(test(tmp_path / "jax"), to_jax(h))
    tr = bank.plotter().check(test(tmp_path / "port"), h)
    assert tr == jr == {"valid": True}
    for root in ("jax", "port"):
        p = os.path.join(str(tmp_path / root), "bank-plot",
                         "20260101T000000.000", "bank.png")
        assert os.path.getsize(p) > 1000


def test_bank_bundle():
    """test()'s defaults and its composed checker (SI, plot, cycle) give
    the JAX package's test()'s dict on the bank-setfull history."""
    hist, _, _ = chip_smoke.bank_setfull_histories()
    jt, tt = jbank.test(), bank.test(device="cpu")
    assert {k: tt[k] for k in ("max_transfer", "total_amount", "accounts")} \
        == {k: jt[k] for k in ("max_transfer", "total_amount", "accounts")}
    assert isinstance(tt["generator"], type(bank.generator()))
    test = {"accounts": list(range(8)), "total_amount": 80,
            "nodes": ["n1", "n2"]}
    r = same(jt["checker"], tt["checker"], hist, test)
    assert r["valid"] is True and r["cycle"]["node-count"] == 0


# ---------------------------------------------------------------------------
# causal

def causal_ops(*steps):
    """(f, value, position, link) ok ops of process 0."""
    return [thist.Op(0, "ok", f, v, extra={"position": p, "link": ln})
            for f, v, p, ln in steps]


CAUSAL_CASES = {
    "valid_order": causal_ops(("read-init", 0, 1, "init"),
                              ("write", 1, 2, 1), ("read", 1, 3, 2),
                              ("write", 2, 4, 3), ("read", 2, 5, 4)),
    "broken_link": causal_ops(("read-init", 0, 1, "init"),
                              ("write", 1, 2, 99)),
    "stale_read": causal_ops(("read-init", 0, 1, "init"),
                             ("write", 1, 2, 1), ("read", 0, 3, 2)),
    "write_not_counter": causal_ops(("write", 5, 1, "init")),
    "read_init_nonzero": causal_ops(("read-init", 7, 1, "init")),
    "read_init_none": causal_ops(("read-init", None, 1, "init")),
}


@pytest.mark.parametrize("case", sorted(CAUSAL_CASES))
def test_causal_check(case):
    r = same(jcausal.check(), causal.check(), CAUSAL_CASES[case],
             {"model": None})
    assert r["valid"] is (case == "valid_order")
    assert (str(causal.causal_register().step(CAUSAL_CASES[case][0]))
            == str(jcausal.causal_register().step(
                to_jax(CAUSAL_CASES[case])[0])))


@pytest.mark.parametrize("case", sorted(CAUSAL_CASES))
def test_causal_bundle_checker(case):
    """checker(device="cpu") — the causal replay beside the value-order
    cycle checker, per key — gives the JAX package's test()'s checker's
    dict on each case as key 0."""
    h = [o.with_(value=tind.tuple_(0, o.value), index=i)
         for i, o in enumerate(CAUSAL_CASES[case])]
    same(jcausal.test({})["checker"], causal.checker(device="cpu"), h)


# ---------------------------------------------------------------------------
# long_fork

def lf_read(process, kvs, type="ok", index=0):
    return thist.Op(process, type, "read",
                    [[tmop.READ, k, v] for k, v in kvs], index=index)


def lf_write(process, k, type="invoke", index=0):
    return thist.Op(process, type, "write", [[tmop.WRITE, k, 1]],
                    index=index)


FORK = [lf_write(0, 0, "invoke", 0), lf_write(0, 0, "ok", 1),
        lf_write(1, 1, "invoke", 2), lf_write(1, 1, "ok", 3),
        lf_read(2, [(0, 1), (1, None)], index=4),
        lf_read(3, [(0, None), (1, 1)], index=5)]

LONG_FORK_CASES = {
    "fork": FORK,
    "no_fork": FORK[:5],
    "valid": [lf_write(0, 0, "invoke", 0), lf_write(0, 0, "ok", 1),
              lf_read(2, [(0, 1), (1, None)], index=2),
              lf_read(3, [(0, 1), (1, None)], index=3)],
    "multiple_writes": [lf_write(0, 0, "invoke"), lf_write(1, 0, "invoke")],
    "early_late_reads": [lf_read(0, [(0, None), (1, None)]),
                         lf_read(1, [(0, 1), (1, 1)]),
                         lf_read(2, [(0, 1), (1, None)])],
    "mismatched_group_size": [lf_read(0, [(0, 1)])],
}


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("case", sorted(LONG_FORK_CASES))
def test_long_fork_checker(case, legacy):
    r = same(jlf.checker(2, legacy=legacy),
             long_fork.checker(2, legacy=legacy, device="cpu"),
             LONG_FORK_CASES[case])
    want = {"fork": False, "no_fork": True, "valid": True,
            "multiple_writes": "unknown", "mismatched_group_size": "unknown"}
    if case in want:
        assert r["valid"] == want[case]


def test_long_fork_groups_and_reads():
    for n, k in ((2, 0), (2, 5), (3, 7)):
        assert list(long_fork.group_for(n, k)) == list(jlf.group_for(n, k))
    random.seed(3)
    t = long_fork.read_txn_for(3, 4)
    random.seed(3)
    assert t == jlf.read_txn_for(3, 4)
    t3 = lf_read(0, [(0, 1), (1, None)])
    t4 = lf_read(1, [(0, None), (1, 1)])
    r0 = lf_read(2, [(0, None), (1, None)])
    for rs in ([r0, t3, t4], [r0, lf_read(1, [(0, 1), (1, None)]),
                              lf_read(2, [(0, 1), (1, 1)])]):
        got = [[o.to_dict() for o in f] for f in long_fork.find_forks(rs)]
        want = [[o.to_dict() for o in f]
                for f in jlf.find_forks(to_jax(rs))]
        assert got == want
    assert len(long_fork.find_forks([r0, t3, t4])) == 1
    rs = [t3, t4, r0]
    assert long_fork.early_reads(rs) == jlf.early_reads(to_jax(rs))
    assert long_fork.late_reads(rs) == jlf.late_reads(to_jax(rs))
    with pytest.raises(long_fork.IllegalHistory):
        long_fork.find_forks([t3, lf_read(1, [(0, 2), (1, None)])])
    assert long_fork.is_legal_txn([[tmop.WRITE, 1, 1]])
    assert not long_fork.is_legal_txn([[tmop.WRITE, 1, 1],
                                       [tmop.READ, 1, 1]])
    assert jmop.READ == tmop.READ


# ---------------------------------------------------------------------------
# adya

def inserts(*steps):
    """(process, type, key, (a_id, b_id)) insert ops, indexed."""
    return [thist.Op(p, typ, "insert", tind.tuple_(k, v), index=i)
            for i, (p, typ, k, v) in enumerate(steps)]


ADYA_CASES = {
    "valid": inserts((0, "invoke", 0, (None, 1)), (0, "ok", 0, (None, 1)),
                     (1, "invoke", 0, (2, None)), (1, "fail", 0, (2, None))),
    "illegal_double_insert": inserts((0, "ok", 5, (None, 1)),
                                     (1, "ok", 5, (2, None))),
    "double_insert_is_g2": inserts(
        (0, "invoke", 0, (None, 1)), (0, "ok", 0, (None, 1)),
        (1, "invoke", 0, (2, None)), (1, "ok", 0, (2, None))),
    "single_insert_ok": inserts(
        (0, "invoke", 0, (None, 1)), (0, "ok", 0, (None, 1)),
        (1, "invoke", 0, (2, None)), (1, "fail", 0, (2, None))),
    "no_inserts": [],
}


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("case", sorted(ADYA_CASES))
def test_adya_g2_checker(case, legacy):
    r = same(jadya.g2_checker(legacy=legacy),
             adya.g2_checker(legacy=legacy, device="cpu"), ADYA_CASES[case])
    bad = case in ("illegal_double_insert", "double_insert_is_g2")
    assert r["valid"] is (not bad)
    if bad and not legacy:
        assert r["anomaly-types"] == ["G2"] and r["illegal-count"] == 1


# ---------------------------------------------------------------------------
# seeded histories of 256 keys

SEEDED_KEYS = 256


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_adya(seed):
    h = chip_smoke.adya_history(SEEDED_KEYS, seed)
    r = same(jadya.g2_checker(), adya.g2_checker(device="cpu"), h)
    planted = SEEDED_KEYS // chip_smoke.PLANT_EVERY
    assert r["valid"] is False and r["illegal-count"] == planted
    assert r["anomaly-types"] == ["G2"]
    legacy = same(jadya.g2_checker(legacy=True),
                  adya.g2_checker(legacy=True), h)
    assert {k: legacy[k] for k in ("key-count", "legal-count",
                                   "illegal-count", "illegal")} \
        == {k: r[k] for k in ("key-count", "legal-count", "illegal-count",
                              "illegal")}


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_long_fork(seed):
    h = chip_smoke.long_fork_history(SEEDED_KEYS, seed)
    r = same(jlf.checker(2), long_fork.checker(2, device="cpu"), h)
    assert r["valid"] is False and r["forks"]
    legacy = same(jlf.checker(2, legacy=True),
                  long_fork.checker(2, legacy=True), h)
    assert legacy["valid"] is r["valid"]
    # the history without its planted forks is valid on both paths
    clean = [o for o in h if o.index < len(h) - 4 * len(range(
        0, SEEDED_KEYS // 2, chip_smoke.PLANT_EVERY))]
    assert long_fork.checker(2, device="cpu").check({}, clean)["valid"] \
        is long_fork.checker(2, legacy=True).check({}, clean)["valid"] \
        is True


@pytest.mark.parametrize("seed", [1])
def test_seeded_causal(seed):
    h = chip_smoke.causal_history(SEEDED_KEYS, seed)
    r = same(jcausal.test({})["checker"], causal.checker(device="cpu"), h)
    assert sorted(r["failures"]) == list(range(0, SEEDED_KEYS,
                                               chip_smoke.PLANT_EVERY))


def test_causal_keys_share_word_launches(monkeypatch):
    """causal's checker checks a key a thread: with each closure_word
    launch held 10 ms, the keys that submit their one-word buckets
    meanwhile share the next launch (fewer launches than buckets, every
    matrix in one), and the dict is still the JAX package's."""
    from jepsen_tpu_torch.ops import closure

    real, real_close, sizes, subs = (closure.closure_word,
                                     closure.close_words, [], [])

    def slow(words, rounds, **kw):
        sizes.append(words.shape[0])
        time.sleep(0.01)
        return real(words, rounds, **kw)

    def counted(words, device=None):
        subs.append(len(words))
        return real_close(words, device)

    monkeypatch.setattr(closure, "closure_word", slow)
    monkeypatch.setattr(closure, "close_words", counted)
    h = chip_smoke.causal_history(32, 2)
    r = same(jcausal.test({})["checker"], causal.checker(device="cpu"), h)
    assert sorted(r["failures"]) == [0]
    assert sum(sizes) == sum(subs) and 0 < len(sizes) < len(subs)


# ---------------------------------------------------------------------------
# the device rule

@pytest.mark.parametrize("make,history", [
    (lambda: adya.g2_checker(), ADYA_CASES["double_insert_is_g2"]),
    (lambda: long_fork.checker(2), FORK),
    (lambda: causal.checker(),
     [o.with_(value=tind.tuple_(0, o.value), index=i)
      for i, o in enumerate(CAUSAL_CASES["valid_order"])]),
    (lambda: bank.test()["checker"],
     [thist.Op(0, "ok", "txn", [["w", "x", 1]], index=0),
      thist.Op(1, "ok", "txn", [["r", "x", 1]], index=1)]),
], ids=["adya", "long_fork", "causal", "bank"])
def test_card_checkers_raise_without_cuda(monkeypatch, make, history):
    """With no device given, the checkers that reach the card raise
    CudaUnavailable on a host without CUDA; nothing reads "unknown" and
    nothing falls back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    test = {"accounts": ["x"], "total_amount": 1}
    with pytest.raises(CudaUnavailable):
        make().check(test, history, {})


# ---------------------------------------------------------------------------
# linearizable_register

def register_run(lr_mod, gen_mod, ind_mod, hist_mod, seed, n_ops=300,
                 bad_keys=()):
    """Package `lr_mod`'s register test map after random.seed(seed): its
    generator's first n_ops ops drawn by 2n worker threads in turn, each
    applied at once to a per-key register (so the history is
    linearizable), one read on each key of `bad_keys` answering a value
    the register never held. Returns (test map, drawn op dicts,
    history)."""
    random.seed(seed)
    opts = {"nodes": ["n1", "n2", "n3"], "per_key_limit": 12,
            "device": "cpu"}
    t = lr_mod.test(opts)
    g = t["generator"]
    procs = list(range(2 * len(opts["nodes"])))
    drawn, hist, regs, planted = [], [], {}, set()
    with gen_mod.with_threads(procs):
        for i in range(n_ops):
            p = procs[i % len(procs)]
            o = gen_mod.op(g, {"nodes": opts["nodes"],
                               "concurrency": len(procs)}, p)
            if o is None:
                break
            k, v = o["value"]
            drawn.append((p, o["f"], k, v))
            cur = regs.get(k)
            typ, out = "ok", v
            if o["f"] == "read":
                out = cur
                if k in bad_keys and k not in planted and cur is not None:
                    out, _ = 99, planted.add(k)
            elif o["f"] == "write":
                regs[k] = v
            elif cur == v[0]:
                regs[k] = v[1]
            else:
                typ = "fail"
            n = len(hist)
            hist.append(hist_mod.Op(p, "invoke", o["f"],
                                    ind_mod.tuple_(k, v), index=n))
            hist.append(hist_mod.Op(p, typ, o["f"],
                                    ind_mod.tuple_(k, out), index=n + 1))
    return t, drawn, hist


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_register_generator_equal(seed):
    from jepsen_tpu import generator as jgen
    from jepsen_tpu.workloads import linearizable_register as jlr
    from jepsen_tpu_torch import generator as tgen
    from jepsen_tpu_torch.workloads import linearizable_register as tlr

    _, tdrawn, _ = register_run(tlr, tgen, tind, thist, seed)
    _, jdrawn, _ = register_run(jlr, jgen, jind, jhist, seed)
    assert tdrawn == jdrawn
    assert {f for _, f, _, _ in tdrawn} == {"read", "write", "cas"}


@pytest.mark.parametrize("bad_keys", [(), (1, 3)])
def test_register_checker_equal(bad_keys):
    from jepsen_tpu import generator as jgen
    from jepsen_tpu.workloads import linearizable_register as jlr
    from jepsen_tpu_torch import generator as tgen
    from jepsen_tpu_torch.workloads import linearizable_register as tlr

    tt, _, hist = register_run(tlr, tgen, tind, thist, 4, bad_keys=bad_keys)
    jt, _, _ = register_run(jlr, jgen, jind, jhist, 4)
    tr = tt["checker"].check({"model": tt["model"]}, hist, {})
    jr = jt["checker"].check({"model": jt["model"]}, to_jax(hist), {})
    keys = lambda r: {str(k): (v["valid"], v["linearizable"]["valid"])
                      for k, v in r["results"].items()}
    assert keys(tr) == keys(jr)
    assert tr["valid"] == jr["valid"] == (not bad_keys)
    assert sorted(map(str, tr.get("failures", []))) == sorted(
        map(str, jr.get("failures", [])))
    assert normalise(tr["results"]) == normalise(jr["results"])


def test_register_checker_takes_the_device():
    """`opts["device"]` reaches the linearizability checker (None, the
    card, by default), as the port's other workload checkers take it."""
    from jepsen_tpu_torch.workloads import linearizable_register as tlr

    for opts, want in (({}, None), ({"device": "cpu"}, "cpu"),
                       ({"device": "cuda:1"}, "cuda:1")):
        t = tlr.test({"nodes": ["n1"], **opts})
        lin = t["checker"].checker.checker_map["linearizable"]
        assert (lin.device, lin.algorithm) == (want, "auto")


# ---------------------------------------------------------------------------
# generators: under one random.seed, each bundle's op stream equals the
# JAX package's op for op (tests/test_workloads.py's generator cases)

def draw(gen_mod, g, seed, n, threads=4, **test):
    """The first n ops of generator g (anything with `op`, as
    list_append's generator) drawn by `threads` worker threads in turn
    after random.seed(seed), as JSON carries them."""
    random.seed(seed)
    t = {"concurrency": threads, "nodes": ["n1", "n2"], **test}
    out = []
    with gen_mod.with_threads(list(range(threads))):
        for i in range(n):
            o = g.op(t, i % threads)
            if o is None:
                break
            out.append(o)
    return normalise(out)


def generators():
    """(name, the JAX package's generator maker, the port's, the test
    map's extra fields) for each bundle generator."""
    from jepsen_tpu import generator as jgen
    from jepsen_tpu.workloads import list_append as jla

    from jepsen_tpu_torch import generator as tgen
    from jepsen_tpu_torch.workloads import list_append

    bank_t = {"accounts": list(range(8)), "max_transfer": 5}
    return {
        "bank_generator": (jgen, jbank.generator, tgen, bank.generator,
                           bank_t),
        "bank_diff_transfer": (jgen, jbank.diff_transfer, tgen,
                               bank.diff_transfer, bank_t),
        "adya_g2_gen": (jgen, jadya.g2_gen, tgen, adya.g2_gen, {}),
        "long_fork_2": (jgen, lambda: jlf.generator(2), tgen,
                        lambda: long_fork.generator(2), {}),
        "long_fork_3": (jgen, lambda: jlf.workload(3)["generator"], tgen,
                        lambda: long_fork.workload(3, device="cpu")[
                            "generator"], {}),
        "list_append": (jgen, lambda: jla.generator(8, seed=3), tgen,
                        lambda: list_append.generator(8, seed=3), {}),
        "causal_per_key": (
            jgen, lambda: jind.concurrent_generator(
                1, iter(range(10 ** 6)), lambda k: jgen.seq(
                    [jcausal.ri, jcausal.cw1, jcausal.r, jcausal.cw2,
                     jcausal.r])),
            tgen, lambda: tind.concurrent_generator(
                1, iter(range(10 ** 6)), lambda k: tgen.seq(
                    [causal.ri, causal.cw1, causal.r, causal.cw2,
                     causal.r])), {}),
    }


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(generators()))
def test_generator_streams_equal(name, seed):
    jgen, jmake, tgen, tmake, extra = generators()[name]
    want = draw(jgen, jmake(), seed, 120, **extra)
    got = draw(tgen, tmake(), seed, 120, **extra)
    assert len(got) >= 40 and got == want


def test_bank_generator_never_self_transfers():
    from jepsen_tpu_torch import generator as tgen

    ops = draw(tgen, bank.diff_transfer(), 0, 50,
               accounts=list(range(8)), max_transfer=5)
    assert len(ops) == 50
    assert all(o["value"]["from"] != o["value"]["to"] for o in ops)


def test_adya_gen_unique_ids_and_pairing():
    from collections import Counter

    from jepsen_tpu_torch import generator as tgen

    ops = draw(tgen, adya.g2_gen(), 0, 16)
    ids = [a if a is not None else b for _, (a, b) in
           (o["value"] for o in ops)]
    assert len(ids) == len(set(ids))
    assert all(c == 2 for c in Counter(o["value"][0] for o in ops).values())


def test_long_fork_generator_write_then_group_read():
    from jepsen_tpu_torch import generator as tgen

    g = long_fork.generator(2)
    with tgen.with_threads([0, 1]):
        t = {"concurrency": 2}
        o1 = tgen.op(g, t, 0)
        k = tmop.key(o1["value"][0])
        o2 = tgen.op(g, t, 0)
    assert o1["f"] == "write" and o2["f"] == "read"
    assert sorted(tmop.key(m) for m in o2["value"]) == sorted(
        long_fork.group_for(2, k))


def test_bundles_match_the_jax_package():
    """The bundles' shapes: the same keys as the JAX package's, the
    checkers of the same kinds, causal's model and time limit."""
    from jepsen_tpu.workloads import list_append as jla

    from jepsen_tpu_torch.workloads import list_append

    pairs = [(jadya.workload(), adya.workload(device="cpu")),
             (jlf.workload(2), long_fork.workload(2, device="cpu")),
             (jla.workload(8), list_append.workload(8, device="cpu")),
             (jcausal.test({"time_limit": 5}),
              causal.test({"time_limit": 5, "device": "cpu"})),
             (jbank.test(), bank.test(device="cpu"))]
    for j, t in pairs:
        assert sorted(j) == sorted(t)
        assert type(t["checker"]).__name__ == type(j["checker"]).__name__
        assert type(t["generator"]).__name__ == type(
            j["generator"]).__name__
    assert causal.test({})["generator"].dt == 60
    assert type(causal.test({})["model"]).__name__ == "CausalRegister"


def test_workloads_package_is_lazy():
    """`jepsen_tpu_torch.workloads` names the JAX package's bundle
    modules and loads each on first use, so a simulated node that
    imports the package loads no checker (nor torch)."""
    import subprocess
    import sys

    from jepsen_tpu_torch import workloads

    assert workloads.bank is bank and workloads.adya is adya
    assert sorted(workloads.__all__) == sorted(
        ["adya", "bank", "causal", "linearizable_register", "list_append",
         "long_fork"])
    code = ("import sys, jepsen_tpu_torch.workloads; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jepsen_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"
