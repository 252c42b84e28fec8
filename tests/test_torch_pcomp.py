"""jepsen_tpu_torch.ops.pcomp against the JAX package's
(jepsen_tpu/ops/pcomp.py): the same histories split into the same lanes,
lane for lane — sub-model, f, value_in, value_out, crashed, call and
return positions and the invokes' indices — for unordered-queue
histories (by value) and multi-register histories (by key, rewritten to
register ops), and both refuse the same histories (multi-micro txns,
unhashable payloads, the fifo queue). The split's verdicts through the
port's checker are held against the JAX package's in
tests/test_torch_linearizable.py."""

import random

import numpy as np
import pytest

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.ops import pcomp as jpcomp

from jepsen_tpu_torch import carry
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.ops import pcomp

from helpers import random_queue_history


def to_port(hist):
    return carry.history_from_dicts([o.to_dict() for o in hist])


def pair(p, f, value, kind="ok"):
    """An invoke and its completion, as op dicts."""
    return [{"process": p, "type": "invoke", "f": f, "value": value},
            {"process": p, "type": kind, "f": f, "value": value}]


def from_dicts(dicts):
    """The same history in both packages' Op types, indexed."""
    for i, d in enumerate(dicts):
        d["index"] = d["time"] = i
    return ([jhist.Op.from_dict(d) for d in dicts],
            carry.history_from_dicts(dicts))


def multi_register_history(seed, n=24, multi=False, crash=0.15):
    """Random single-key txns on keys x/y/z (one two-key txn when
    `multi`), some crashed, some reads corrupted."""
    rng = random.Random(seed)
    regs: dict = {}
    dicts: list = []
    for i in range(n):
        p = i % 3
        k = rng.choice("xyz")
        kind = "info" if rng.random() < crash else "ok"
        if rng.random() < 0.5:
            v = rng.randrange(4)
            micros = [["w", k, v]]
            if kind == "ok":
                regs[k] = v
        else:
            v = regs.get(k)
            if v is not None and rng.random() < 0.2:
                v += 1
            micros = [["r", k, v]]
        if multi and i == n // 2:
            micros = micros + [["r", "q", None]]
        value = None if kind == "info" and rng.random() < 0.5 else micros
        dicts += pair(p, "txn", micros, kind)
        dicts[-1]["value"] = value
    return from_dicts(dicts)


def lane_view(model, es):
    return (type(model).__name__, getattr(model, "value", None), es.f,
            es.value_in, es.value_out, es.crashed.tolist(),
            np.asarray(es.call_pos).tolist(), np.asarray(es.ret_pos).tolist(),
            [o.index for o in es.invokes])


def assert_same_split(jmodel, tmodel, jh, th):
    jl = jpcomp.split(jmodel, jhist.entries(jh))
    tl = pcomp.split(tmodel, thist.entries(th))
    assert (jl is None) == (tl is None)
    if jl is None:
        return None
    assert len(tl) == len(jl)
    for (jm, jes), (tm, tes) in zip(jl, tl):
        assert lane_view(tm, tes) == lane_view(jm, jes)
    jg = jpcomp.group_lanes(jl)
    tg = pcomp.group_lanes(tl)
    assert list(tg.values()) == list(jg.values())
    return tl


@pytest.mark.parametrize("corrupt", [0.0, 0.2])
@pytest.mark.parametrize("seed", range(4))
def test_queue_split_matches_jax(seed, corrupt):
    jh = random_queue_history(n_process=4, n_ops=60, n_values=12,
                              corrupt=corrupt, seed=seed)
    lanes = assert_same_split(jmodels.UnorderedQueue(),
                              tmodels.UnorderedQueue(), jh, to_port(jh))
    assert len(lanes) > 1
    assert all(m == tmodels.UnorderedQueue() for m, _ in lanes)


def test_big_queue_split_matches_jax():
    """BASELINE config 4's shape at a tenth of its size: 500 invocations
    over 200 values."""
    jh = random_queue_history(n_process=5, n_ops=500, n_values=200, seed=7)
    lanes = assert_same_split(jmodels.UnorderedQueue(),
                              tmodels.UnorderedQueue(), jh, to_port(jh))
    assert len(lanes) > 100


@pytest.mark.parametrize("seed", range(6))
def test_multi_register_split_matches_jax(seed):
    jh, th = multi_register_history(seed)
    lanes = assert_same_split(jmodels.MultiRegister(),
                              tmodels.MultiRegister(), jh, th)
    assert lanes and all(m == tmodels.Register() for m, _ in lanes)
    assert {f for _, es in lanes for f in es.f} <= {"read", "write"}


def test_multi_register_initial_values_match_jax():
    jh, th = multi_register_history(3)
    regs = (("x", 7), ("y", 1))
    lanes = assert_same_split(jmodels.MultiRegister(registers=regs),
                              tmodels.MultiRegister(registers=regs), jh, th)
    assert {m.value for m, _ in lanes} <= {7, 1, None}


@pytest.mark.parametrize("case", ["multi_micro", "unhashable", "malformed",
                                  "fifo"])
def test_no_split_matches_jax(case):
    """Histories that do not decompose: both packages refuse them."""
    if case == "multi_micro":
        jh, th = multi_register_history(1, multi=True)
        models = (jmodels.MultiRegister(), tmodels.MultiRegister())
    elif case == "unhashable":
        jh, th = from_dicts(pair(0, "enqueue", {"k": 1}))
        models = (jmodels.UnorderedQueue(), tmodels.UnorderedQueue())
    elif case == "malformed":
        jh, th = from_dicts(pair(0, "txn", 5))
        models = (jmodels.MultiRegister(), tmodels.MultiRegister())
    else:
        jh = random_queue_history(n_process=3, n_ops=20, fifo=True, seed=1)
        th = to_port(jh)
        assert not pcomp.eligible(tmodels.FIFOQueue())
        assert not jpcomp.eligible(jmodels.FIFOQueue())
        models = (jmodels.FIFOQueue(), tmodels.FIFOQueue())
    assert assert_same_split(*models, jh, th) is None


def test_crashed_valueless_ops_drop():
    """A crashed dequeue (or txn) that recorded no value can never
    linearize and is optional: it is in no lane, in both packages."""
    d = (pair(0, "enqueue", 1) + pair(1, "dequeue", None, "info")
         + pair(2, "enqueue", 2))
    jh, th = from_dicts(d)
    lanes = assert_same_split(jmodels.UnorderedQueue(),
                              tmodels.UnorderedQueue(), jh, th)
    assert sorted(len(es) for _, es in lanes) == [1, 1]


def test_eligible_follows_the_hook():
    assert pcomp.eligible(tmodels.UnorderedQueue())
    assert pcomp.eligible(tmodels.MultiRegister())
    for m in (tmodels.FIFOQueue(), tmodels.Register(), tmodels.CASRegister(),
              tmodels.Mutex()):
        assert not pcomp.eligible(m)
