"""jepsen_tpu_torch's models, encodings and history entries, held
against jepsen_tpu's on the same inputs. Every output is an int32 or a
bool, so every comparison is exact (tolerance zero)."""

import itertools
import random

import numpy as np
import pytest
import torch

import jax

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.models import jit as jjit

from jepsen_tpu_torch import carry
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.models import jit as tjit

from helpers import random_queue_history, random_register_history

NIL = int(jjit.NIL32)
SCALAR = ["cas-register", "register", "mutex"]


def both_entries(hist):
    """(jax Entries, port Entries) of one history, the port's built from
    the JAX package's Op dicts."""
    return (jhist.entries(hist),
            thist.entries(carry.history_from_dicts(
                [o.to_dict() for o in hist])))


def test_constants_match():
    assert int(tjit.NIL32) == NIL
    for name in jjit.BY_NAME:
        j, t = jjit.BY_NAME[name], tjit.BY_NAME[name]
        assert (t.name, t.fs) == (j.name, j.fs)
        assert (t.state_in_key, t.has_unstep) == (j.state_in_key,
                                                  j.has_unstep)
        if name in SCALAR:
            assert t.init_state == j.init_state


@pytest.mark.parametrize("name", SCALAR)
def test_scalar_step_matches_jax(name):
    """The exhaustive small domain of tests/test_models.py, through the
    JAX step (vmapped) and the port's torch step."""
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    if name == "mutex":
        states, vs = [0, 1], [NIL]
    else:
        states, vs = [NIL, 0, 1, 2], [NIL, 0, 1, 2]
    fcodes = list(range(-1, len(jm.fs) + 1))  # unknown codes included
    arr = np.array(list(itertools.product(states, fcodes, vs, vs)),
                   np.int32)
    js, jok = jax.jit(jax.vmap(jm.step))(*(arr[:, i] for i in range(4)))
    ts, tok = tm.step(*(torch.from_numpy(arr[:, i].copy())
                        for i in range(4)))
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())


def test_scalar_vec_step_matches_jax():
    for name in SCALAR:
        jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
        for s, f, v1, v2 in itertools.product([NIL, 0, 1], [0, 1, 2],
                                              [NIL, 0, 1], [NIL, 1]):
            js, jok = jm.vec_step(jax.numpy.asarray([s], np.int32),
                                  f, v1, v2)
            ts, tok = tm.vec_step(torch.tensor([s], dtype=torch.int32),
                                  f, v1, v2)
            assert np.asarray(js).tolist() == ts.tolist()
            assert bool(jok) == bool(tok)


@pytest.mark.parametrize("name", ["unordered-queue", "fifo-queue"])
def test_queue_step_unstep_canon_match_jax(name):
    """Random states and ops through vec_step / vec_unstep / vec_canon of
    both packages."""
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    rng = np.random.default_rng(7)
    w = 6
    for _ in range(150):
        if name == "fifo-queue":
            head = int(rng.integers(0, w + 1))
            tail = int(rng.integers(head, w + 1))
            state = np.concatenate([rng.integers(0, 4, w),
                                    [head, tail]]).astype(np.int32)
        else:
            state = rng.integers(0, 3, w + 2).astype(np.int32)
        f = int(rng.integers(-1, 2))
        v1 = int(rng.integers(0, 4))
        js, jok = jm.vec_step(jax.numpy.asarray(state), f, v1, NIL)
        ts, tok = tm.vec_step(torch.from_numpy(state.copy()), f, v1, NIL)
        assert np.asarray(js).tolist() == ts.tolist()
        assert bool(jok) == bool(tok)
        if bool(jok) and f in (0, 1):
            ju = jm.vec_unstep(js, f, v1, NIL)
            tu = tm.vec_unstep(ts, f, v1, NIL)
            assert np.asarray(ju).tolist() == tu.tolist()
        if name == "fifo-queue":
            assert (np.asarray(jm.vec_canon(jax.numpy.asarray(state)))
                    .tolist()
                    == tm.vec_canon(torch.from_numpy(state.copy())).tolist())


def test_encode_value_matches_jax():
    for v in [0, 1, -5, 2**30 - 1, -(2**30) + 1, None, np.int64(12),
              True]:
        assert tjit.encode_value(v) == jjit.encode_value(v)
    for v in [2**30, -(2**30), 2**40, 1.5, "x", (1,)]:
        with pytest.raises((OverflowError, TypeError)):
            jjit.encode_value(v)
        with pytest.raises((OverflowError, TypeError)):
            tjit.encode_value(v)


def _histories():
    out = [("cas-register", random_register_history(
        n_process=4, n_ops=20, corrupt=0.3, seed=s)) for s in range(6)]
    out += [("register", random_register_history(
        n_process=3, n_ops=16, cas=False, seed=40 + s)) for s in range(3)]
    out += [("unordered-queue", random_queue_history(
        n_process=4, n_ops=18, n_values=5, corrupt=0.3, seed=70 + s))
        for s in range(4)]
    out += [("fifo-queue", random_queue_history(
        n_process=3, n_ops=16, fifo=True, seed=90 + s)) for s in range(4)]
    return out


@pytest.mark.parametrize("idx", range(17))
def test_entries_and_lane_encoding_match_jax(idx):
    """history.entries and every lane encoding (encode_lane, and
    encode_batch for the scalar models) agree with the JAX package."""
    name, hist = _histories()[idx]
    je, te = both_entries(hist)
    assert len(je) == len(te)
    assert te.f == je.f and te.value_out == je.value_out
    np.testing.assert_array_equal(te.crashed, je.crashed)
    np.testing.assert_array_equal(te.call_pos, je.call_pos)
    np.testing.assert_array_equal(te.ret_pos, je.ret_pos)
    assert te.n_completed == je.n_completed
    assert [o.index for o in te.invokes] == [o.index for o in je.invokes]
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    assert tm.lane_eligible(te) == jm.lane_eligible(je)
    assert tm.lane_width(te) == jm.lane_width(je)
    for a, b in zip(jm.encode_lane(je), tm.encode_lane(te)):
        np.testing.assert_array_equal(a, b)
    if name in SCALAR:
        for a, b in zip(jm.encode_batch([je, je], 2 * len(je)),
                        tm.encode_batch([te, te], 2 * len(te))):
            np.testing.assert_array_equal(a, b)


def test_for_model_mapping():
    cases = [(tmodels.CASRegister(), "cas-register"),
             (tmodels.Register(), "register"), (tmodels.Mutex(), "mutex"),
             (tmodels.UnorderedQueue(), "unordered-queue"),
             (tmodels.FIFOQueue(), "fifo-queue")]
    for m, name in cases:
        assert tjit.for_model(m) is tjit.BY_NAME[name]
    assert tjit.for_model(tmodels.CASRegister(3)) is None
    assert tjit.for_model(tmodels.UnorderedQueue((1,))) is None
    assert tjit.for_model(tmodels.Mutex(True)) is None


def test_host_models_step_like_jax():
    """The port's host models (the oracle the search is checked against)
    step exactly like the JAX package's over random op sequences."""
    rng = random.Random(3)
    reg, q = ["read", "write", "cas"], ["enqueue", "dequeue"]
    cases = [(jmodels.CASRegister(), tmodels.CASRegister(), reg),
             (jmodels.Register(), tmodels.Register(), reg[:2]),
             (jmodels.Mutex(), tmodels.Mutex(), ["acquire", "release"]),
             (jmodels.UnorderedQueue(), tmodels.UnorderedQueue(), q),
             (jmodels.FIFOQueue(), tmodels.FIFOQueue(), q)]
    for js, ts, fs in cases:
        for _ in range(200):
            f = rng.choice(fs + ["bogus"])
            v = (rng.randrange(3), rng.randrange(3)) if f == "cas" \
                else rng.choice([None, 0, 1, 2])
            jn, tn = js.step(f, v), ts.step(f, v)
            assert jmodels.inconsistent(jn) == tmodels.inconsistent(tn)
            if not tmodels.inconsistent(tn):
                assert repr(jn) == repr(tn)
                js, ts = jn, tn
