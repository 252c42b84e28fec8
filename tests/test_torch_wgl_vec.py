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
from jepsen_tpu_torch.workloads.queue import mutex_history, queue_history
from jepsen_tpu_torch.workloads.register import register_history

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


def plan_states(name, n_pad):
    """The n_state values a batch of `name` lanes at `n_pad` can have:
    1 for the scalar models; the unordered queue's value count (8 up to
    n_pad); the fifo ring (8 to FIFO_MAX_RING rows) + 8."""
    if name == "unordered-queue":
        return [8, n_pad]
    if name == "fifo-queue":
        return [8 + r for r in (8, 16, 32, wgl_vec.FIFO_MAX_RING)]
    return [1]


@pytest.mark.parametrize("n_pad", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_smem_plan_fits_every_eligible_shape(name, n_pad):
    """Every shape batch_eligible admits: the block's shared bytes (the
    zmix table, then its lanes, memo keys included) fit the H100's
    opt-in limit, and one warp holds as many lanes as fit, at most 32
    and never fewer than 4."""
    jm = tjit.BY_NAME[name]
    assert wgl_vec.eligible(jm, n_pad)
    for n_state in plan_states(name, n_pad):
        slots = wgl_vec._cache_slots(jm, n_pad, n_state)
        plan = wgl_vec._smem_plan(jm, n_pad, n_state, slots)
        assert 4 <= plan.lanes <= wgl_vec.WARP == 32
        assert plan.bytes == 4 * n_pad + plan.lanes * plan.lane_bytes
        assert plan.bytes <= wgl_vec.SMEM_MAX == 232448
        assert (plan.lanes == 32
                or plan.bytes + plan.lane_bytes > wgl_vec.SMEM_MAX)
        kw = wgl_vec._key_words(jm, n_pad, n_state)
        assert plan.lane_bytes == wgl_vec._lane_bytes(jm, n_pad, n_state,
                                                      slots)
        assert plan.lane_bytes > 4 * slots * (1 + kw)  # keys, fingerprints
        few = wgl_vec._smem_plan(jm, n_pad, n_state, slots, most=1)
        assert (few.lanes, few.bytes) == (1, 4 * n_pad + plan.lane_bytes)


@pytest.mark.parametrize("width,lanes", [
    (128, 1), (512, 1), (2112, 1), (2113, 2), (4096, 2), (16384, 8),
    (67584, 32), (1 << 20, 32)])
def test_smem_plan_fills_the_card_before_packing_warps(width, lanes):
    """A launch of `width` lanes on 132 SMs packs lanes into a warp only
    past WARPS_PER_SM warps an SM, and never past what fits or a warp."""
    jm = tjit.cas_register
    full = wgl_vec._smem_plan(jm, 64, 1, 128)
    plan = wgl_vec._smem_plan(jm, 64, 1, 128, wgl_vec._warp_lanes(width, 132))
    assert plan.lanes == min(lanes, full.lanes)
    assert plan.lane_bytes == full.lane_bytes
    assert plan.bytes == 4 * 64 + plan.lanes * plan.lane_bytes
    wide = wgl_vec._smem_plan(jm, 1024, 1, 128,
                              wgl_vec._warp_lanes(1 << 20, 132))
    assert wide.lanes == wgl_vec._smem_plan(jm, 1024, 1, 128).lanes == 4


@pytest.mark.parametrize("name,n_pad,n_state,lanes", [
    ("cas-register", 64, 1, 32),        # register cells: 32 lanes fit
    ("cas-register", 1024, 1, 4),       # widest
    ("unordered-queue", 1024, 1024, 4),
    ("fifo-queue", 64, 72, 21),         # ring 64: the shrunk memo
    ("fifo-queue", 1024, 72, 5),
])
def test_smem_plan_boundary_shapes(name, n_pad, n_state, lanes):
    jm = tjit.BY_NAME[name]
    slots = wgl_vec._cache_slots(jm, n_pad, n_state)
    plan = wgl_vec._smem_plan(jm, n_pad, n_state, slots)
    assert plan.lanes == lanes
    # a device that offers less shared memory takes fewer lanes a block
    small = wgl_vec._smem_plan(jm, n_pad, n_state, slots,
                               smem_max=plan.bytes - 1)
    assert small.lanes == lanes - 1


def test_scratch_rows_shrink_to_the_keys():
    """The device-memory scratch held every per-lane table (list, node
    map, stacks, memo, bitset, queue state); now there is none: the
    lane's shared bytes hold each of those tables (the list, node map and
    undo stack's entries as int16), the memo keys included, beside the
    decoded meta, v1 and v2 and the best stack."""
    jm = tjit.cas_register
    for n_pad in (32, 64, 1024):
        m_pad = wgl_vec._m_pad(n_pad)
        kw = wgl_vec._key_words(jm, n_pad, 1)
        old = (3 * m_pad + 2 * n_pad + 128 * kw + 128 + wgl_vec._nw(n_pad)
               + 1)
        int32_tables = old - 3 * m_pad - 2 * n_pad   # memo, bitset, state
        assert wgl_vec._lane_bytes(jm, n_pad, 1, 128) == (
            4 * int32_tables + 4 * n_pad          # + the undo stack's states
            + 2 * (3 * m_pad + n_pad)             # list, node map, entries
            + 4 * 3 * n_pad + 2 * n_pad)          # meta, v1, v2; best
    assert not hasattr(wgl_vec, "_scratch_rows")
    with pytest.raises(ValueError, match="shared memory"):
        wgl_vec._smem_plan(jm, 1 << 16, 1, 128)


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


def edge_case(case):
    """(model name, histories, cap, lanes a block) at the edges of the
    shared-memory plan: n_pad 1024 at the four lanes a block that fit
    (four histories, 32 times over), and n_pad 64 with a fifo ring of 64
    rows (the shrunk memo) at the plan's lanes a block."""
    if case == "n1024-four-lanes-a-block":
        return "cas-register", [to_jax(register_history(
            n_process=5, n_ops=n, corrupt=c, seed=30 + s))
            for s, (n, c) in enumerate([(1000, 0.0), (900, 0.01),
                                        (300, 0.1), (50, 0.3)])] * 32, \
            20000, 4
    return "fifo-queue", [to_jax(queue_history(
        n_process=3, n_ops=62, fifo=True,
        corrupt=0.1 if s % 3 == 0 else 0.0, seed=40 + s))
        for s in range(40)], 20000, None


@pytest.mark.parametrize("case", ["n1024-four-lanes-a-block", "n64-fifo-64"])
def test_cuda_edge_shapes_match_plain(cuda, case):
    """On the card, at the plan's edges: the kernel and the plain
    version give the same result block and best stack, bit for bit."""
    name, hists, cap, lanes = edge_case(case)
    tm = tjit.BY_NAME[name]
    tess = [thist.entries(to_port(h)) for h in hists]
    n_pad = wgl_vec._pad_size(max(len(es) for es in tess))
    n_state = wgl_vec._state_pad(tm, tess)
    slots = wgl_vec._cache_slots(tm, n_pad, n_state)
    buf, _ = wgl_vec._layout(wgl_vec._encode_flats(tess, tm, n_pad),
                             None, n_pad)
    packed, msteps = carry.packed_from_numpy(buf, cap, device=cuda)
    plan = wgl_vec.launch_plan(packed, tm, n_pad, n_state, slots, lanes)
    if lanes:
        assert (n_pad, plan.lanes) == (1024, lanes)
    else:
        assert (n_pad, n_state) == (64, 72)
    small, best = wgl_vec.search(packed, msteps, tm, n_pad, n_state, slots,
                                 lanes)
    torch.cuda.synchronize()
    psmall, pbest = wgl_vec.search_plain(packed, msteps, tm, n_pad,
                                         n_state, slots)
    assert torch.equal(small, psmall) and torch.equal(best, pbest)
