"""jepsen_tpu_torch.ops.wgl_vec against the JAX package's Pallas WGL
kernel (jepsen_tpu/ops/wgl_pallas_vec.py, run in interpret mode as
tests/test_wgl_pallas_vec.py runs it).

Both packages lay a batch out into the same packed buffer (asserted
byte for byte); that buffer goes through the Pallas kernel and through
the port's search on CPU tensors (its plain version). Every output is
an int32, so the comparison is exact: verdict, steps, depth, best
depth, stuck entry, and the best stack's rows below the best depth (the
Pallas kernel's rows above it are whatever its uninitialized scratch
held; the port's are zero). Shapes stay at n_pad 32 and 64."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (beside torch, on the CPU: conftest pins it)

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.models import jit as jjit
from jepsen_tpu.ops import wgl_pallas_vec as K1

from jepsen_tpu_torch import carry
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.models import jit as tjit
from jepsen_tpu_torch.ops import wgl_vec
from jepsen_tpu_torch.workloads.queue import mutex_history

from helpers import random_queue_history, random_register_history

MODELS = {
    "cas-register": (jmodels.CASRegister, tmodels.CASRegister),
    "register": (jmodels.Register, tmodels.Register),
    "mutex": (jmodels.Mutex, tmodels.Mutex),
    "unordered-queue": (jmodels.UnorderedQueue, tmodels.UnorderedQueue),
    "fifo-queue": (jmodels.FIFOQueue, tmodels.FIFOQueue),
}


def to_jax(hist):
    """The JAX package's Ops for a history of either package."""
    return [jhist.Op.from_dict(o.to_dict()) for o in hist]


def to_port(hist):
    return carry.history_from_dicts([o.to_dict() for o in hist])


def histories(case):
    """(model name, histories, step cap) for each parity case."""
    if case == "cas-register":
        return "cas-register", [random_register_history(
            n_process=4, n_ops=16, corrupt=0.35, seed=4200 + s)
            for s in range(10)], 3000
    if case == "cas-register-v32":  # payloads outside int16
        hs = [random_register_history(n_process=3, n_ops=12, corrupt=0.3,
                                      seed=60 + s) for s in range(4)]
        for h in hs:
            for o in h:
                if isinstance(o.value, int):
                    o.value = o.value + 2**20
        return "cas-register", hs, 3000
    if case == "register":
        return "register", [random_register_history(
            n_process=3, n_ops=14, cas=False, corrupt=0.2, seed=10 + s)
            for s in range(8)], 3000
    if case == "mutex":
        return "mutex", [to_jax(mutex_history(
            n_process=4, n_ops=14, corrupt=0.2 if s % 2 else 0.0, seed=s))
            for s in range(8)], 3000
    if case == "unordered-queue":
        return "unordered-queue", [random_queue_history(
            n_process=4, n_ops=16, n_values=5, corrupt=0.3, seed=900 + s)
            for s in range(8)], 3000
    if case == "fifo-queue":
        return "fifo-queue", [random_queue_history(
            n_process=3, n_ops=14, fifo=True, corrupt=0.2 if s % 2 else 0,
            seed=50 + s) for s in range(8)], 3000
    if case == "fifo-queue-shrink":
        # a lane with 17+ enqueues: ring 32, so the memo shrinks to 64 slots
        hs = [random_queue_history(n_process=2, n_ops=36, fifo=True,
                                   seed=s) for s in (0, 1, 3)]
        return "fifo-queue", hs, 1500
    raise KeyError(case)


def k1_run(jm, ess, cap, slots):
    """The JAX package's packed buffer for `ess` and its Pallas kernel's
    (small, best) over it, in interpret mode."""
    n_pad = K1._pad_size(max(len(es) for es in ess))
    n_state = K1._state_pad(jm, ess)
    flats = K1._encode_flats(ess, jm, n_pad)
    buf, n_blocks = K1._layout(flats, None, n_pad)
    run = K1._launcher(jm, n_pad, True, n_blocks, n_state, slots)
    small, best = run(buf, np.full((1, n_blocks * K1.LANES), cap, np.int32))
    return buf, n_pad, n_state, np.asarray(small), np.asarray(best)


CASES = ["cas-register", "cas-register-v32", "register", "mutex",
         "unordered-queue", "fifo-queue", "fifo-queue-shrink"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_search_matches_pallas(case):
    name, hists, cap = histories(case)
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    jess = [jhist.entries(h) for h in hists]
    tess = [thist.entries(to_port(h)) for h in hists]
    n_pad = wgl_vec._pad_size(max(len(es) for es in tess))
    n_state = wgl_vec._state_pad(tm, tess)
    slots = wgl_vec._cache_slots(tm, n_pad, n_state)
    if case == "fifo-queue-shrink":
        assert slots < wgl_vec.CACHE_SLOTS
    buf, j_pad, j_state, small, best = k1_run(jm, jess, cap, slots)
    assert (n_pad, n_state) == (j_pad, j_state)

    # one byte-identical packed buffer from both packages
    tbuf, _ = wgl_vec._layout(wgl_vec._encode_flats(tess, tm, n_pad),
                              None, n_pad)
    assert tbuf.dtype == buf.dtype and tbuf.shape == buf.shape
    assert tbuf.tobytes() == buf.tobytes()
    if case == "cas-register-v32":
        assert buf.shape[0] == 3 * n_pad + 1

    packed, msteps = carry.packed_from_numpy(buf, cap, device="cpu")
    launches = wgl_vec.LAUNCHES
    tsmall, tbest = wgl_vec.search(packed, msteps, tm, n_pad, n_state, slots)
    assert wgl_vec.LAUNCHES == launches  # CPU tensors launch nothing
    tsmall, tbest = tsmall.numpy(), tbest.numpy()
    np.testing.assert_array_equal(tsmall, small)
    n = len(hists)
    for lane in range(tsmall.shape[1]):
        bd = max(0, int(small[3, lane]))
        np.testing.assert_array_equal(tbest[:bd, lane], best[:bd, lane])
        assert not tbest[bd:, lane].any()
    assert set(small[0, :n].tolist()) <= {1, 2, 3}
    if case in ("cas-register", "mutex", "unordered-queue", "fifo-queue"):
        # the cases exercise both verdicts
        assert {1, 2} <= set(small[0, :n].tolist())


def _lane_view(r):
    return (r.valid, r.steps,
            None if r.op is None else r.op.index,
            None if r.best_linearization is None
            else [o.index for o in r.best_linearization])


@pytest.mark.parametrize("case", ["cas-register", "unordered-queue",
                                  "fifo-queue", "fifo-queue-shrink"])
def test_analysis_batch_matches_pallas(case):
    name, hists, cap = histories(case)
    jmodel, tmodel = (c() for c in MODELS[name])
    jr = K1.analysis_batch(jmodel, [jhist.entries(h) for h in hists],
                           max_steps=cap)
    tr = wgl_vec.analysis_batch(tmodel, [to_port(h) for h in hists],
                                max_steps=cap, device="cpu")
    assert [_lane_view(r) for r in tr] == [_lane_view(r) for r in jr]


def test_analysis_batch_two_pass_matches_pallas():
    """More than 128 lanes and a budget above 8 * PASS1_CAP: every lane
    runs under PASS1_CAP first, survivors re-run with the full budget
    and report the steps of both passes."""
    hists = [random_register_history(n_process=3, n_ops=8, seed=700 + s,
                                     corrupt=0.3 if s % 5 == 0 else 0.0)
             for s in range(130)]
    hard = [random_register_history(n_process=5, n_ops=30, corrupt=0.2,
                                    seed=37)]  # needs > PASS1_CAP steps
    hists[7:8] = hard
    max_steps = 4200
    assert max_steps > 8 * wgl_vec.PASS1_CAP
    jr = K1.analysis_batch(jmodels.CASRegister(),
                           [jhist.entries(h) for h in hists],
                           max_steps=max_steps)
    tr = wgl_vec.analysis_batch(tmodels.CASRegister(),
                                [to_port(h) for h in hists],
                                max_steps=max_steps, device="cpu")
    assert [_lane_view(r) for r in tr] == [_lane_view(r) for r in jr]
    assert tr[7].steps > wgl_vec.PASS1_CAP  # the second pass ran
    assert {r.valid for r in tr} == {True, False}


def test_capture_records_each_search():
    """wgl_vec.CAPTURE records the arguments of every search a batch
    check ran (both passes here), and replaying them gives the same
    result blocks."""
    hists = [random_register_history(n_process=3, n_ops=8, seed=700 + s)
             for s in range(130)]
    hists[7] = random_register_history(n_process=5, n_ops=30, corrupt=0.2,
                                       seed=37)
    wgl_vec.CAPTURE = []
    try:
        tr = wgl_vec.analysis_batch(tmodels.CASRegister(),
                                    [to_port(h) for h in hists],
                                    max_steps=4200, device="cpu")
        launches = wgl_vec.CAPTURE
    finally:
        wgl_vec.CAPTURE = None
    assert [int(lc[1].max()) for lc in launches] == [wgl_vec.PASS1_CAP, 4200]
    assert [lc[0].shape[1] for lc in launches] == [256, 128]
    first, second = (wgl_vec.search(*lc)[0] for lc in launches)
    assert int(second[1, 0]) + int(first[1, 7]) == tr[7].steps
    assert int(first[1, 0]) == tr[0].steps


def test_wrapper_rejects_bad_inputs():
    hists = [thist.entries(to_port(random_register_history(seed=1)))]
    jm = tjit.cas_register
    buf, _ = wgl_vec._layout(wgl_vec._encode_flats(hists, jm, 32), None, 32)
    packed, msteps = carry.packed_from_numpy(buf, 100, device="cpu")
    with pytest.raises(TypeError):
        wgl_vec.search(packed.to(torch.int64), msteps, jm, 32)
    with pytest.raises(ValueError):
        wgl_vec.search(packed[:-1], msteps, jm, 32)  # wrong row count
    with pytest.raises(ValueError):
        wgl_vec.search(packed, msteps[:-1], jm, 32)  # width mismatch
    with pytest.raises(ValueError):
        wgl_vec.search(packed.t().contiguous().t(), msteps, jm, 32)
    with pytest.raises(ValueError):
        wgl_vec.search(packed, msteps, jm, 32, cache_slots=100)
    with pytest.raises(ValueError):
        carry.packed_from_numpy(buf, [1, 2, 3], device="cpu")


def test_duplicate_node_positions_rejected():
    es = thist.entries(to_port(random_register_history(seed=2)))
    es.ret_pos[0] = es.call_pos[1]
    with pytest.raises(AssertionError, match="duplicate"):
        wgl_vec._encode_flats([es], tjit.cas_register, 32)


def test_pallas_idle_row0_write_is_a_noop():
    """The Pallas kernel writes nxt/prv row 0 on every step, also for a
    lane that neither lifts nor pops (wgl_pallas_vec.py:465-494); the
    port skips that write. Transcribed for such a lane, the algebra
    writes back the value row 0 already holds."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        nxt = rng.integers(0, 64, 72)
        prv = rng.integers(0, 64, 72)
        posA_n, valA_n, posA_p, valA_p = 0, nxt[0], 0, prv[0]
        posB_n = 0
        valB_n = valA_n if posA_n == 0 else nxt[0]   # rd_n1(0, nxt_0)
        posB_p = 0
        valB_p = valA_p if posA_p == 0 else prv[0]   # rd_p1(0, prv_0)
        n2, p2 = nxt.copy(), prv.copy()
        n2[posA_n], p2[posA_p] = valA_n, valA_p
        n2[posB_n], p2[posB_p] = valB_n, valB_p
        np.testing.assert_array_equal(n2, nxt)
        np.testing.assert_array_equal(p2, prv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CASES)
def test_cuda_kernel_matches_plain(cuda, case):
    """On the card: the CUDA kernel and the plain version give the same
    result block and best stack, bit for bit."""
    name, hists, cap = histories(case)
    tm = tjit.BY_NAME[name]
    tess = [thist.entries(to_port(h)) for h in hists]
    n_pad = wgl_vec._pad_size(max(len(es) for es in tess))
    n_state = wgl_vec._state_pad(tm, tess)
    slots = wgl_vec._cache_slots(tm, n_pad, n_state)
    buf, _ = wgl_vec._layout(wgl_vec._encode_flats(tess, tm, n_pad),
                             None, n_pad)
    packed, msteps = carry.packed_from_numpy(buf, cap, device=cuda)
    launches = wgl_vec.LAUNCHES
    small, best = wgl_vec.search(packed, msteps, tm, n_pad, n_state, slots)
    torch.cuda.synchronize()
    assert wgl_vec.LAUNCHES == launches + 1
    psmall, pbest = wgl_vec.search_plain(packed, msteps, tm, n_pad,
                                         n_state, slots)
    assert torch.equal(small, psmall) and torch.equal(best, pbest)
