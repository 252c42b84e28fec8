"""jepsen_tpu_torch.ops.wgl_row against the JAX package's K5 Pallas
kernel (jepsen_tpu/ops/wgl_pallas.py, in interpret mode as
tests/test_wgl_pallas.py runs it) and its K2 search
(jepsen_tpu/ops/wgl_tpu.py).

The same histories go through both packages. Both pack a batch into the
same columns (asserted byte for byte); the Pallas kernel and the port's
search on CPU tensors (its plain version) then give the same verdict,
steps and depth per lane, exactly. An invalid lane's counterexample is
the JAX package's host search's. Lanes run up to n_pad 4064, two of them
over 1024 entries and one over 2048."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (beside torch, on the CPU: conftest pins it)

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.history import fail_op, index, info_op, invoke_op, ok_op
from jepsen_tpu.models import jit as jjit
from jepsen_tpu.ops import wgl_host as jhost
from jepsen_tpu.ops import wgl_pallas as K5
from jepsen_tpu.ops import wgl_tpu as K2

from jepsen_tpu_torch import carry
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.models import jit as tjit
from jepsen_tpu_torch.ops import wgl_host, wgl_row, wgl_search
from jepsen_tpu_torch.workloads.queue import mutex_history
from jepsen_tpu_torch.workloads.register import register_history

from helpers import random_queue_history, random_register_history

MODELS = {
    "cas-register": (jmodels.CASRegister, tmodels.CASRegister),
    "register": (jmodels.Register, tmodels.Register),
    "mutex": (jmodels.Mutex, tmodels.Mutex),
}


def to_jax(hist):
    return [jhist.Op.from_dict(o.to_dict()) for o in hist]


def to_port(hist):
    return carry.history_from_dicts([o.to_dict() for o in hist])


def k5_pad(jess) -> int:
    """K5's n_pad rule (wgl_pallas.analysis_batch)."""
    n_pad = max(K5._next_pow2(max(len(es) for es in jess)), 8)
    return min(n_pad, K5.MAX_PAD)


def k5_search(jm, jess, max_steps):
    """K5's packed columns for `jess` and its (verdict, steps, depth)
    rows over them, in interpret mode."""
    n_pad = k5_pad(jess)
    packed = K5._pack(jess, jm, n_pad)
    out = K5._launcher(jm, n_pad, max_steps, True)(packed)
    return n_pad, packed, np.stack(
        [np.asarray(a).reshape(-1) for a in out]).astype(np.int32)


def port_search(tm, tess, n_pad, max_steps, cache_bits=wgl_row.CACHE_BITS):
    buf = wgl_row._pack(tess, tm, n_pad)
    packed = torch.from_numpy(buf)
    msteps = torch.full((len(tess),), max_steps, dtype=torch.int32)
    launches = wgl_row.LAUNCHES
    out = wgl_row.search(packed, msteps, tm, n_pad, cache_bits)
    assert wgl_row.LAUNCHES == launches  # CPU tensors launch nothing
    return buf, out.numpy()


def lane_view(r):
    return (r.valid, r.steps,
            None if r.op is None else r.op.index,
            None if r.best_linearization is None
            else [o.index for o in r.best_linearization])


def check_parity(name, hists, max_steps=K5.DEFAULT_MAX_STEPS):
    """`hists` (JAX Ops) through K5 and the port, at the search and at
    analysis_batch: equal packed columns, equal (verdict, steps, depth),
    equal results; invalid lanes' op and best linearization equal the
    JAX host search's. Returns the search rows."""
    jmodel, tmodel = (c() for c in MODELS[name])
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    jess = [jhist.entries(h) for h in hists]
    tess = [thist.entries(to_port(h)) for h in hists]
    n_pad, kpacked, ref = k5_search(jm, jess, max_steps)
    assert n_pad == wgl_row.pad_size(max(len(es) for es in tess))
    buf, out = port_search(tm, tess, n_pad, max_steps)
    cols = np.concatenate(
        [kpacked[k][:, :, 0] for k in wgl_row._COLS + wgl_row._NODE_COLS]
        + [kpacked["n_completed"][:, :, 0]], 1)
    assert cols.dtype == buf.dtype and cols.tobytes() == buf.tobytes()
    np.testing.assert_array_equal(out, ref)

    jr = K5.analysis_batch(jmodel, jess, max_steps=max_steps)
    tr = wgl_row.analysis_batch(tmodel, tess, max_steps=max_steps,
                                device="cpu")
    for j, t, es in zip(jr, tr, jess):
        assert t.valid == j.valid
        if t.valid is False:
            h = jhost.analysis(jmodel, es)
            assert lane_view(t)[2:] == lane_view(h)[2:]
        else:
            assert lane_view(t) == lane_view(j)
    return out


def h(*ops):
    return index(list(ops))


LITERAL = {
    "sequential_ok": ("cas-register", [h(
        invoke_op(0, "write", 1), ok_op(0, "write", 1),
        invoke_op(0, "read"), ok_op(0, "read", 1),
        invoke_op(0, "cas", (1, 2)), ok_op(0, "cas", (1, 2)))]),
    "bad_read": ("cas-register", [h(
        invoke_op(0, "write", 1), ok_op(0, "write", 1),
        invoke_op(0, "read"), ok_op(0, "read", 2))]),
    "crash_semantics": ("cas-register", [h(
        invoke_op(0, "write", 1), info_op(0, "write", 1),
        invoke_op(1, "read"), ok_op(1, "read", 1)), h(
        invoke_op(0, "write", 1), fail_op(0, "write", 1),
        invoke_op(1, "read"), ok_op(1, "read", 1))]),
    "mutex": ("mutex", [h(
        invoke_op(0, "acquire"), ok_op(0, "acquire"),
        invoke_op(1, "acquire"), ok_op(1, "acquire"))]),
    "register": ("register", [h(
        invoke_op(0, "write", 7), ok_op(0, "write", 7),
        invoke_op(1, "read"), ok_op(1, "read", 7))]),
    "empty_and_all_crashed": ("cas-register", [[], h(
        invoke_op(0, "write", 1), invoke_op(1, "cas", (5, 6)))]),
}
EXPECTED = {"sequential_ok": [1], "bad_read": [2], "crash_semantics": [1, 2],
            "mutex": [2], "register": [1], "empty_and_all_crashed": [1, 1]}


@pytest.mark.parametrize("case", sorted(LITERAL))
def test_literal_cases_match_pallas(case):
    """tests/test_wgl_pallas.py's literal histories."""
    name, hists = LITERAL[case]
    out = check_parity(name, hists)
    assert out[0].tolist() == EXPECTED[case]


def test_empty_lane_is_valid_before_any_step():
    out = check_parity("cas-register", [[]])
    assert out.ravel().tolist() == [wgl_row.VALID, 0, 0]


def test_budget_cut_is_unknown():
    hist = random_register_history(n_process=4, n_ops=40, seed=7)
    out = check_parity("cas-register", [hist], max_steps=1)
    assert out.ravel().tolist()[:2] == [wgl_row.UNKNOWN, 1]
    out = check_parity("cas-register", [hist], max_steps=25)
    assert out[0, 0] == wgl_row.UNKNOWN and out[1, 0] == 25


@pytest.mark.parametrize("corrupt", [0.0, 0.4])
def test_random_cas_register_matches_pallas(corrupt):
    hists = [random_register_history(n_process=3, n_ops=14, seed=s,
                                     corrupt=corrupt) for s in range(15)]
    out = check_parity("cas-register", hists)
    if corrupt:
        assert {1, 2} <= set(out[0].tolist())


def test_register_and_mutex_lanes_match_pallas():
    regs = [random_register_history(n_process=3, n_ops=16, cas=False,
                                    corrupt=0.5, seed=10 + s)
            for s in range(8)]
    out = check_parity("register", regs)
    assert {1, 2} <= set(out[0].tolist())
    mutexes = [to_jax(mutex_history(n_process=4, n_ops=14,
                                    corrupt=0.2 if s % 2 else 0.0, seed=s))
               for s in range(8)]
    out = check_parity("mutex", mutexes)
    assert {1, 2} <= set(out[0].tolist())


def planted(hist):
    """`hist` with its first :ok read returning a value never written."""
    hist = list(hist)
    i = next(i for i, o in enumerate(hist) if o.type == "ok" and o.f == "read")
    hist[i] = hist[i].with_(value=99)
    return hist


LONG = {
    # (model, register_history kwargs, planted impossible read)
    "cas-1156": ("cas-register", dict(n_ops=1400, seed=1), False),
    "cas-2175": ("cas-register", dict(n_ops=2600, seed=2), False),
    "register-1500-planted": ("register", dict(n_ops=1500, cas=False,
                                               seed=3), True),
}


@pytest.mark.parametrize("case", sorted(LONG))
def test_long_lanes_match_pallas(case):
    """Lanes past wgl_vec's 1024 entries, one past 2048 (n_pad 4064):
    the port stores ceil(n_pad/32) + 1 key words, fewer than K5's 128."""
    name, kw, plant = LONG[case]
    hist = register_history(n_process=5, **kw)
    if plant:
        hist = planted(hist)
    n = len(thist.entries(hist))
    assert n > 1024
    out = check_parity(name, [to_jax(hist)])
    n_pad = wgl_row.pad_size(n)
    assert wgl_row.key_words(n_pad) <= wgl_row.ROW
    if n_pad < wgl_row.MAX_PAD:
        assert wgl_row.key_words(n_pad) < wgl_row.ROW - 1
    assert out[0, 0] == (wgl_row.INVALID if plant else wgl_row.VALID)


def test_memo_evictions_match_pallas(monkeypatch):
    """A memo of 8 rows (one probe window): inserts overwrite the last
    probe and keys are lost, and the step counts still match K5 built
    with the same memo."""
    monkeypatch.setattr(K5, "CACHE_BITS", 3)
    monkeypatch.setattr(K5, "_kernel_cache", {})
    hists = [random_register_history(n_process=4, n_ops=16, seed=40 + s,
                                     corrupt=0.3) for s in range(6)]
    jm, tm = jjit.cas_register, tjit.cas_register
    jess = [jhist.entries(x) for x in hists]
    n_pad, _, ref = k5_search(jm, jess, 4000)
    _, out = port_search(tm, [thist.entries(to_port(x)) for x in hists],
                         n_pad, 4000, cache_bits=3)
    np.testing.assert_array_equal(out, ref)
    _, full = port_search(tm, [thist.entries(to_port(x)) for x in hists],
                          n_pad, 4000)
    assert (out[1] >= full[1]).all() and (out[1] > full[1]).any()


@pytest.mark.parametrize("name", ["cas-register", "register", "mutex"])
def test_cache_bits_13_is_k2(name):
    """At cache_bits 13 the search is the JAX package's scalar K2
    search: the same verdicts, step counts and depths as
    wgl_tpu's kernel."""
    if name == "mutex":
        hists = [to_jax(mutex_history(n_process=4, n_ops=14,
                                      corrupt=0.2 if s % 2 else 0.0,
                                      seed=s)) for s in range(6)]
    else:
        hists = [random_register_history(n_process=4, n_ops=16,
                                         cas=name == "cas-register",
                                         corrupt=0.3, seed=70 + s)
                 for s in range(6)]
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    jess = [jhist.entries(x) for x in hists]
    k2_pad = K2._pad_size(max(len(es) for es in jess))
    ents = [K2.encode_entries(es, jm, k2_pad) for es in jess]
    for e in ents:
        e["max_steps"] = np.int32(5000)
    kernel = K2._kernel_for(jm, k2_pad, 1, wgl_search.DEFAULT_CACHE_BITS,
                            unroll=1)
    ref = np.stack([np.asarray(a) for a in kernel(K2._stack(ents))])
    tess = [thist.entries(to_port(x)) for x in hists]
    n_pad = wgl_row.pad_size(max(len(es) for es in tess))
    _, out = port_search(tm, tess, n_pad, 5000,
                         cache_bits=wgl_search.DEFAULT_CACHE_BITS)
    np.testing.assert_array_equal(out, ref.astype(np.int32))
    assert {1, 2} <= set(out[0].tolist())


@pytest.mark.parametrize("n_pad", [8, 64, 2048, 4064])
def test_encodings_byte_equal_to_jax(n_pad):
    """encode_entries and _zobrist_table are byte-identical to
    wgl_tpu's."""
    hist = random_register_history(n_process=3, n_ops=6, corrupt=0.3,
                                   seed=n_pad)
    jes = jhist.entries(hist)
    tes = thist.entries(to_port(hist))
    a = K2.encode_entries(jes, jjit.cas_register, n_pad)
    b = wgl_search.encode_entries(tes, tjit.cas_register, n_pad)
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    za, zb = K2._zobrist_table(n_pad), wgl_search._zobrist_table(n_pad)
    assert za.dtype == zb.dtype and za.tobytes() == zb.tobytes()
    assert (wgl_search.RUNNING, wgl_search.VALID, wgl_search.INVALID,
            wgl_search.UNKNOWN) == (K2.RUNNING, K2.VALID, K2.INVALID,
                                    K2.UNKNOWN)
    assert (wgl_search.DEFAULT_MAX_STEPS, wgl_search.DEFAULT_CACHE_BITS,
            wgl_search.N_PROBES) == (K2.DEFAULT_MAX_STEPS,
                                     K2.DEFAULT_CACHE_BITS, K2.N_PROBES)
    assert (wgl_row.CACHE_BITS, wgl_row.MAX_PAD) == (K5.CACHE_BITS,
                                                     K5.MAX_PAD)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 1025, 2048, 2049, 4064])
def test_pad_rule_matches_pallas(n):
    ref = max(K5._next_pow2(n), 8)
    ref = min(ref, K5.MAX_PAD)
    assert wgl_row.pad_size(n) == ref
    assert wgl_row._m_pad(ref) == K5._m_pad(ref)


def test_eligibility():
    assert wgl_row.eligible(tjit.cas_register, wgl_row.MAX_PAD)
    assert not wgl_row.eligible(tjit.cas_register, wgl_row.MAX_PAD * 2)
    assert not wgl_row.eligible(tjit.unordered_queue, 64)
    assert not wgl_row.eligible(tjit.fifo_queue, 64)
    assert wgl_row.analysis_batch(tmodels.CASRegister(), [],
                                  device="cpu") == []
    q = to_port(random_queue_history(n_process=2, n_ops=4, seed=0))
    with pytest.raises(ValueError):
        wgl_row.analysis_batch(tmodels.UnorderedQueue(), [q], device="cpu")
    with pytest.raises(ValueError):
        wgl_row.analysis_batch(tmodels.FIFOQueue(), [q], device="cpu")
    long = register_history(n_process=5, n_ops=4100, cas=False, seed=0)
    tes = thist.entries(long)
    assert len(tes) > wgl_row.MAX_PAD
    assert not wgl_row.batch_eligible(tjit.register, [tes])
    with pytest.raises(ValueError):
        wgl_row.analysis_batch(tmodels.Register(), [tes], device="cpu")
    big = carry.history_from_dicts([
        {"process": 0, "type": "invoke", "f": "write", "value": 2**40},
        {"process": 0, "type": "ok", "f": "write", "value": 2**40}])
    assert not wgl_row.batch_eligible(tjit.cas_register,
                                      [thist.entries(big)])
    with pytest.raises(ValueError):
        wgl_row.analysis_batch(tmodels.CASRegister(), [big], device="cpu")


def test_recover_invalid_is_the_host_search():
    hist = to_port(planted(to_jax(register_history(n_process=3, n_ops=30,
                                                   seed=5))))
    es = thist.entries(hist)
    r = wgl_host.recover_invalid(tmodels.CASRegister(), es)
    assert r.valid is False
    assert r.to_dict() == wgl_host.analysis(tmodels.CASRegister(),
                                            es).to_dict()


def test_capture_records_each_search():
    hists = [to_port(random_register_history(n_process=3, n_ops=10,
                                             corrupt=0.3, seed=s))
             for s in range(4)]
    wgl_row.CAPTURE = []
    try:
        tr = wgl_row.analysis_batch(tmodels.CASRegister(), hists,
                                    max_steps=3000, device="cpu")
        launches = wgl_row.CAPTURE
    finally:
        wgl_row.CAPTURE = None
    assert len(launches) == 1
    out = wgl_row.search(*launches[0])
    assert {r.valid for r in tr} == {True, False}
    for r, v, s in zip(tr, out[0].tolist(), out[1].tolist()):
        assert r.valid == {1: True, 2: False, 3: "unknown"}[v]
        if r.valid is not False:
            assert r.steps == s


def test_wrapper_rejects_bad_inputs():
    tes = [thist.entries(to_port(random_register_history(seed=1)))]
    jm = tjit.cas_register
    buf = torch.from_numpy(wgl_row._pack(tes, jm, 32))
    ms = torch.full((1,), 100, dtype=torch.int32)
    with pytest.raises(TypeError):
        wgl_row.search(buf.to(torch.int64), ms, jm, 32)
    with pytest.raises(ValueError):
        wgl_row.search(buf[:, :-1].contiguous(), ms, jm, 32)  # wrong rows
    with pytest.raises(ValueError):
        wgl_row.search(buf, torch.full((2,), 100, dtype=torch.int32), jm, 32)
    with pytest.raises(ValueError):
        wgl_row.search(buf, ms, tjit.unordered_queue, 32)
    with pytest.raises(ValueError):
        wgl_row.search(buf, ms, jm, 32, cache_bits=2)  # fewer than 8 rows
    two = torch.from_numpy(wgl_row._pack(tes * 2, jm, 32))
    with pytest.raises(ValueError):
        wgl_row.search(two.t().contiguous().t(), ms.repeat(2), jm, 32)


def test_duplicate_node_positions_rejected():
    es = thist.entries(to_port(random_register_history(seed=2)))
    es.ret_pos[0] = es.call_pos[1]
    with pytest.raises(AssertionError, match="duplicate"):
        wgl_row._pack([es], tjit.cas_register, 32)


ROW_PADS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4064]


@pytest.mark.parametrize("cache_bits", [11, 13])
@pytest.mark.parametrize("n_pad", ROW_PADS)
def test_smem_plan_fits_every_routed_shape(n_pad, cache_bits):
    """Every n_pad the router sends to wgl_row, at K5's memo and K2's:
    the block's shared bytes fit the H100's opt-in limit, and they are
    the kernel's layout — the Zobrist table once, then `lanes` lanes of
    facts, v1, v2, stack states, fingerprints (int32) and list, node map
    and stack entries (int16)."""
    plan = wgl_row._smem_plan(n_pad, cache_bits)
    m_pad = wgl_row._m_pad(n_pad)
    assert 1 <= plan.lanes <= wgl_row.MAX_LANES_PER_BLOCK
    assert plan.bytes <= wgl_row.SMEM_MAX == 232448
    assert plan.lane_bytes == (4 * (4 * n_pad + (1 << cache_bits))
                               + 2 * (3 * m_pad + n_pad))
    assert plan.bytes == 4 * n_pad + plan.lanes * plan.lane_bytes
    assert plan.lane_bytes % 16 == 0
    # as many lanes as fit, up to the cap
    assert (plan.lanes == wgl_row.MAX_LANES_PER_BLOCK
            or plan.bytes + plan.lane_bytes > wgl_row.SMEM_MAX)
    if n_pad == wgl_row.MAX_PAD:
        assert plan.lanes == 1           # one lane a block at the top
    elif n_pad <= 2048 and cache_bits == wgl_row.CACHE_BITS:
        assert plan.lanes >= 3           # several warps share a block
    # a launch of fewer lanes takes only what it needs
    one = wgl_row._smem_plan(n_pad, cache_bits, lanes=1)
    assert one.lanes == 1 and one.bytes == 4 * n_pad + one.lane_bytes


def test_smem_plan_raises_when_a_lane_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        wgl_row._smem_plan(wgl_row.MAX_PAD, wgl_row.MAX_CACHE_BITS)
    with pytest.raises(ValueError, match="shared memory"):
        wgl_row._smem_plan(8, 16)   # 64k fingerprints alone: 256 KiB
    # a device that offers less than the H100 takes fewer lanes a block
    plan = wgl_row._smem_plan(2048, 11)
    assert wgl_row._smem_plan(2048, 11, smem_max=plan.bytes - 1).lanes \
        == plan.lanes - 1
    with pytest.raises(ValueError, match="over 100000"):
        wgl_row._smem_plan(4064, 11, smem_max=100000)


@pytest.mark.parametrize("cache_bits", [3, 11, 13])
@pytest.mark.parametrize("n_pad", [8, 1024, 4064])
def test_scratch_rows_are_the_key_rows_only(n_pad, cache_bits):
    """The device-memory scratch holds only the memo key rows: no used
    flags, list or stacks (those live in shared memory)."""
    slots = 1 << cache_bits
    rows = wgl_row._scratch_rows(n_pad, cache_bits)
    assert rows == slots * wgl_row.key_words(n_pad)
    old = (slots * wgl_row.key_words(n_pad) + slots
           + 2 * wgl_row._m_pad(n_pad) + 2 * n_pad)
    assert rows < old
    if n_pad == wgl_row.MAX_PAD and cache_bits == wgl_row.CACHE_BITS:
        assert rows * 4 == 1 << 20      # 1 MiB a lane at the top


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["cas-register", "register", "mutex"])
def test_cuda_kernel_matches_plain(cuda, name):
    """On the card: the CUDA kernel and the plain version give the same
    verdict, steps and depth, bit for bit, at n_pad 2048."""
    tm = tjit.BY_NAME[name]
    if name == "mutex":
        hists = [mutex_history(n_process=4, n_ops=n, corrupt=c, seed=s)
                 for s, (n, c) in enumerate([(14, 0.2), (300, 0.0),
                                             (1100, 0.0)])]
    else:
        hists = [register_history(n_process=4, n_ops=n, corrupt=c,
                                  cas=name == "cas-register", seed=s)
                 for s, (n, c) in enumerate([(14, 0.3), (300, 0.0),
                                             (1300, 0.0)])]
    tess = [thist.entries(x) for x in hists]
    n_pad = wgl_row.pad_size(max(len(es) for es in tess))
    packed = torch.from_numpy(wgl_row._pack(tess, tm, n_pad)).to(cuda)
    msteps = torch.full((len(tess),), 20000, dtype=torch.int32, device=cuda)
    launches = wgl_row.LAUNCHES
    small = wgl_row.search(packed, msteps, tm, n_pad)
    torch.cuda.synchronize()
    assert wgl_row.LAUNCHES == launches + 1
    assert torch.equal(small, wgl_row.search_plain(packed, msteps, tm, n_pad))


def test_cuda_kernel_matches_plain_at_n_pad_4064(cuda):
    """On the card, at the top of the plan: n_pad 4064, one lane a
    block (the launch's 4 lanes take 4 blocks), K5's memo and K2's."""
    tm = tjit.cas_register
    hists = [register_history(n_process=5, n_ops=n, corrupt=c, seed=s)
             for s, (n, c) in enumerate([(3000, 0.0), (2600, 0.0),
                                         (400, 0.2), (60, 0.3)])]
    tess = [thist.entries(x) for x in hists]
    n_pad = wgl_row.pad_size(max(len(es) for es in tess))
    assert n_pad == wgl_row.MAX_PAD
    packed = torch.from_numpy(wgl_row._pack(tess, tm, n_pad)).to(cuda)
    msteps = torch.full((len(tess),), 20000, dtype=torch.int32, device=cuda)
    for cache_bits in (wgl_row.CACHE_BITS, wgl_search.DEFAULT_CACHE_BITS):
        assert wgl_row._smem_plan(n_pad, cache_bits, len(tess)).lanes == 1
        small = wgl_row.search(packed, msteps, tm, n_pad, cache_bits)
        torch.cuda.synchronize()
        assert torch.equal(small, wgl_row.search_plain(
            packed, msteps, tm, n_pad, cache_bits))
