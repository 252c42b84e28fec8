"""jepsen_tpu_torch.ops.wgl_search against the JAX package's K2 engine
(jepsen_tpu/ops/wgl_tpu.py, its XLA search on the CPU as
tests/test_wgl_tpu.py runs it).

The same histories go through both packages: the port packs them with
the same encodings, and its search on CPU tensors (the plain version)
gives wgl_tpu's verdict, steps and depth per lane, exactly, for all five
kernel models — valid and corrupted histories, small step budgets, a
memo of 8 slots (cache_bits 3, forcing evictions), a lane at n_pad 8192
(keys of 257 words), and lanes at the port's n_pad 8 and 16 beside
wgl_tpu's floor of 32. On the scalar models it also equals wgl_row's
plain version at cache_bits 13. The CUDA kernel is held against the
plain version in the tests that need a card (skipped without one) and
on the H100 by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (beside torch, on the CPU: conftest pins it)

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.models import jit as jjit
from jepsen_tpu.ops import wgl_tpu as K2

from jepsen_tpu_torch import carry
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.device import CudaUnavailable
from jepsen_tpu_torch.models import jit as tjit
from jepsen_tpu_torch.ops import wgl_row, wgl_search
from jepsen_tpu_torch.workloads.queue import mutex_history

from helpers import random_queue_history, random_register_history

MODELS = {
    "cas-register": (jmodels.CASRegister, tmodels.CASRegister),
    "register": (jmodels.Register, tmodels.Register),
    "mutex": (jmodels.Mutex, tmodels.Mutex),
    "unordered-queue": (jmodels.UnorderedQueue, tmodels.UnorderedQueue),
    "fifo-queue": (jmodels.FIFOQueue, tmodels.FIFOQueue),
}


def to_port(hist):
    return carry.history_from_dicts([o.to_dict() for o in hist])


def histories(name, n, n_ops=16, seed=0, corrupt=0.3):
    """`n` seeded JAX-package histories of model `name`, every other one
    corrupted (a random read or dequeue result)."""
    out = []
    for s in range(n):
        c = corrupt if s % 2 else 0.0
        if name == "mutex":
            h = mutex_history(n_process=4, n_ops=n_ops, corrupt=c,
                              seed=seed + s)
            out.append([jhist.Op.from_dict(o.to_dict()) for o in h])
        elif name.endswith("queue"):
            out.append(random_queue_history(
                n_process=3, n_ops=n_ops, corrupt=c, seed=seed + s,
                fifo=name == "fifo-queue"))
        else:
            out.append(random_register_history(
                n_process=4, n_ops=n_ops, cas=name == "cas-register",
                corrupt=c, seed=seed + s))
    return out


def k2_search(jm, jess, max_steps, cache_bits=wgl_search.DEFAULT_CACHE_BITS):
    """wgl_tpu's (verdict, steps, depth) rows for `jess`, and its
    n_state."""
    n_pad = K2._pad_size(max(len(es) for es in jess))
    n_state = max(jm.lane_width(es) for es in jess)
    n_state = 1 if n_state <= 1 else K2._next_pow2(n_state)
    ents = [K2.encode_entries(es, jm, n_pad) for es in jess]
    for e in ents:
        e["max_steps"] = np.int32(max_steps)
    kernel = K2._kernel_for(jm, n_pad, n_state, cache_bits, unroll=1)
    out = np.stack([np.asarray(a) for a in kernel(K2._stack(ents))])
    return out.astype(np.int32), n_state


def port_search(tm, tess, max_steps, cache_bits=wgl_search.DEFAULT_CACHE_BITS):
    """The port's rows for `tess` on CPU tensors (the plain version), its
    packed buffer and its n_state."""
    n_pad = wgl_search.pad_size(max(len(es) for es in tess))
    n_state = wgl_search.state_width(tm, tess)
    buf = wgl_search._pack(tess, tm, n_pad)
    msteps = torch.full((len(tess),), max_steps, dtype=torch.int32)
    launches = wgl_search.LAUNCHES
    out = wgl_search.search(torch.from_numpy(buf), msteps, tm, n_pad,
                            n_state, cache_bits)
    assert wgl_search.LAUNCHES == launches  # CPU tensors launch nothing
    return out.numpy(), buf, n_state


def both(name, hists, max_steps, cache_bits=wgl_search.DEFAULT_CACHE_BITS):
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    jess = [jhist.entries(h) for h in hists]
    tess = [thist.entries(to_port(h)) for h in hists]
    ref, js = k2_search(jm, jess, max_steps, cache_bits)
    out, _, ts = port_search(tm, tess, max_steps, cache_bits)
    assert js == ts
    return ref, out


@pytest.mark.parametrize("cache_bits", [13, 3])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_plain_matches_k2(name, cache_bits):
    """Verdict, steps and depth equal wgl_tpu's on valid and corrupted
    lanes of every model, at K2's memo and at 8 slots (evictions)."""
    ref, out = both(name, histories(name, 8, seed=40), 5000, cache_bits)
    np.testing.assert_array_equal(out, ref)
    assert 2 in set(out[0].tolist())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_small_budgets_match_k2(name):
    """A lane cut by its step budget is UNKNOWN at the same step count."""
    hists = histories(name, 6, n_ops=24, seed=90)
    for max_steps in (0, 1, 7):
        ref, out = both(name, hists, max_steps)
        np.testing.assert_array_equal(out, ref)
    assert 3 in set(out[0].tolist())


@pytest.mark.parametrize("name", ["unordered-queue", "fifo-queue"])
def test_wide_queue_state_matches_k2(name):
    """Queue lanes of 60-120 invocations: n_state 64 (the unordered
    queue's value slots) or 64-128 (the fifo ring), narrower lanes beside
    the widest in one batch."""
    hists = [random_queue_history(n_process=4, n_ops=n, fifo=name
                                  == "fifo-queue", seed=300 + n)
             for n in (12, 60, 120)]
    ref, out = both(name, hists, 20000)
    np.testing.assert_array_equal(out, ref)


def test_n_pad_8192_matches_k2():
    """One cas-register lane of ~4,600 entries (n_pad 8192: memo keys of
    256 bitset words and the state, wider than wgl_row's 128-word rows)
    and a short lane beside it."""
    hists = [random_register_history(n_process=5, n_ops=5600, seed=11),
             random_register_history(n_process=3, n_ops=20, corrupt=0.3,
                                     seed=3)]
    jess = [jhist.entries(h) for h in hists]
    assert 4096 < len(jess[0]) <= 8192
    ref, out = both("cas-register", hists, 20000)
    np.testing.assert_array_equal(out, ref)
    assert out[0].tolist() == [1, 2]


@pytest.mark.parametrize("n_ops", [3, 7])
@pytest.mark.parametrize("name", ["cas-register", "fifo-queue"])
def test_n_pad_floor_does_not_matter(name, n_ops):
    """The port pads a batch of short lanes to n_pad 8 or 16, wgl_tpu to
    32: the Zobrist words depend on the entry index only and the bitset
    is one word either way, so the search is the same."""
    hists = histories(name, 4, n_ops=n_ops, seed=7)
    tess = [thist.entries(to_port(h)) for h in hists]
    assert wgl_search.pad_size(max(len(es) for es in tess)) in (8, 16)
    ref, out = both(name, hists, 5000)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", ["cas-register", "register", "mutex"])
def test_scalar_equals_wgl_row_at_cache_bits_13(name):
    """On scalar lanes of up to 4064 entries the search is wgl_row's at
    cache_bits 13 (K2's memo), one lane over 1024 entries."""
    hists = [to_port(h) for h in histories(name, 5, seed=500)]
    if name != "mutex":
        hists.append(to_port(random_register_history(
            n_process=4, n_ops=1300, cas=name == "cas-register", seed=3)))
    tm = tjit.BY_NAME[name]
    tess = [thist.entries(h) for h in hists]
    n_pad = wgl_row.pad_size(max(len(es) for es in tess))
    packed = torch.from_numpy(wgl_search._pack(tess, tm, n_pad))
    msteps = torch.full((len(tess),), 20000, dtype=torch.int32)
    row = wgl_row.search_plain(packed, msteps, tm, n_pad,
                               wgl_search.DEFAULT_CACHE_BITS)
    out = wgl_search.search_plain(packed, msteps, tm, n_pad, 1)
    assert torch.equal(out, row)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_columns_equal_jax_encoding(name):
    """`_pack` lays out wgl_tpu's own encode_entries columns (per-lane
    value codecs for the queues), and state_width is its n_state."""
    hists = histories(name, 3, seed=21)
    jm, tm = jjit.BY_NAME[name], tjit.BY_NAME[name]
    jess = [jhist.entries(h) for h in hists]
    tess = [thist.entries(to_port(h)) for h in hists]
    n_pad = 64
    buf = wgl_search._pack(tess, tm, n_pad)
    m_pad = wgl_search._m_pad(n_pad)
    for i, es in enumerate(jess):
        enc = K2.encode_entries(es, jm, n_pad)
        pos = 0
        for key in wgl_search._COLS:
            np.testing.assert_array_equal(buf[i, pos:pos + n_pad],
                                          enc[key].astype(np.int32))
            pos += n_pad
        for key in wgl_search._NODE_COLS:
            a = enc[key].astype(np.int32)
            np.testing.assert_array_equal(buf[i, pos:pos + len(a)], a)
            pos += m_pad
        assert buf[i, pos] == enc["n_completed"]
    _, js = k2_search(jm, jess, 0)
    assert wgl_search.state_width(tm, tess) == js


@pytest.mark.parametrize("name", sorted(MODELS))
def test_analysis_batch_matches_k2(name):
    """analysis_batch on the CPU against wgl_tpu.analysis_batch: the same
    verdicts and steps, and an invalid lane's counterexample op."""
    hists = histories(name, 6, n_ops=20, seed=60)
    jm_model, tm_model = MODELS[name]
    jr = K2.analysis_batch(jm_model(), [jhist.entries(h) for h in hists])
    tr = wgl_search.analysis_batch(
        tm_model(), [to_port(h) for h in hists], device="cpu")
    for j, t in zip(jr, tr):
        assert t.valid == j.valid
        if t.valid is False:
            assert t.op.index == j.op.index
            assert [o.index for o in t.best_linearization] == \
                [o.index for o in j.best_linearization]
        else:
            assert t.steps == j.steps
    assert {True, False} <= {t.valid for t in tr}


def test_split_into_launches_by_scratch_budget(monkeypatch):
    """A batch over the scratch budget goes out as several searches of
    at most `lanes_per_launch` lanes; the results are those of one."""
    hists = [to_port(h) for h in histories("unordered-queue", 7, seed=5)]
    one = wgl_search.analysis_batch(tmodels.UnorderedQueue(), hists,
                                    device="cpu")
    tm = tjit.unordered_queue
    tess = [thist.entries(h) for h in hists]
    lay = wgl_search._layout(tm, wgl_search.pad_size(
        max(len(es) for es in tess)), wgl_search.state_width(tm, tess), 13)
    monkeypatch.setattr(wgl_search, "SCRATCH_BUDGET", 3 * 4 * lay.words)
    monkeypatch.setattr(wgl_search, "CAPTURE", [])
    split = wgl_search.analysis_batch(tmodels.UnorderedQueue(), hists,
                                      device="cpu")
    assert [c[0].shape[0] for c in wgl_search.CAPTURE] == [3, 3, 1]
    assert [(r.valid, r.steps) for r in split] == \
        [(r.valid, r.steps) for r in one]


def test_lane_over_budget_raises(monkeypatch):
    tm = tjit.cas_register
    words = wgl_search._layout(tm, 32768, 1, 13).words
    # ~33.6 MB of key rows a lane at n_pad 32768: 8192 slots x 1025 words
    assert 8192 * 1025 * 4 < 4 * words < 8192 * 1025 * 4 + 2 ** 20
    assert wgl_search.lanes_per_launch(tm, 32768, 1, 13) == \
        wgl_search.SCRATCH_BUDGET // (4 * words)
    monkeypatch.setattr(wgl_search, "SCRATCH_BUDGET", 4 * words - 1)
    with pytest.raises(ValueError, match="budget"):
        wgl_search.lanes_per_launch(tm, 32768, 1, 13)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_layout_offsets(name):
    """The layout the launch is given: the tables the plan puts in
    shared memory at 16-byte aligned offsets in rank order, the others
    (v1 and v2 excepted: read in place) likewise in the lane's scratch,
    then the key rows — the bitset words plus the state when it is
    keyed — and `words` the whole scratch."""
    tm = tjit.BY_NAME[name]
    n_state = 1 if not tm.has_unstep else 256
    for n_pad in (2048, 32768):
        sizes = wgl_search._table_bytes(tm, n_pad, n_state, 13)
        lay = wgl_search._layout(tm, n_pad, n_state, 13)
        for where in (lay.smem, lay.scratch):
            names = list(where)
            assert names == [t for t in wgl_search.TABLES if t in where]
            offs = [0]
            for t in names:
                offs.append(offs[-1] + sizes[t])
            assert list(where.values()) == offs[:-1]
            assert all(o % 16 == 0 for o in offs)
        assert not {"v1", "v2"} & set(lay.scratch)
        assert set(lay.smem) | set(lay.scratch) | {"v1", "v2"} >= {
            t for t in wgl_search.TABLES if sizes[t]}
        assert lay.keys == sum(sizes[t] for t in lay.scratch)
        assert 4 * lay.words == lay.keys + 4 * 8192 * wgl_search.key_words(
            tm, n_pad, n_state)
    assert wgl_search.key_words(tm, 2048, n_state) == \
        64 + (n_state if tm.state_in_key else 0)


def _state_widths(tm, n_pad):
    """Every n_state `state_width` can give a lane of at most n_pad
    entries of model tm."""
    if not tm.has_unstep:
        return [1]
    most = wgl_search.next_pow2(n_pad + 2 if tm.name == "fifo-queue"
                                else n_pad)
    return [1] + [1 << k for k in range(1, most.bit_length())]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_smem_plan_places_every_shape(name):
    """Every shape K2 takes — n_pad 8 to 32768, every n_state
    `state_width` gives, cache_bits 3 to 20 — has a plan within SMEM_MAX:
    the bitset in shared memory, each other table there iff it still fit
    when its rank came, the fingerprints (uint16) out from cache_bits 17
    (256 KB); and
    `lanes_per_launch` divides SCRATCH_BUDGET by `_layout`'s scratch."""
    tm = tjit.BY_NAME[name]
    for k in range(3, 16):
        n_pad = 1 << k
        for n_state in _state_widths(tm, n_pad):
            for cb in range(3, 21):
                sizes = wgl_search._table_bytes(tm, n_pad, n_state, cb)
                plan = wgl_search._smem_plan(tm, n_pad, n_state, cb)
                assert plan.bytes <= wgl_search.SMEM_MAX
                assert "lin" in plan.smem and ("fp" in plan.smem) == (cb < 17)
                used = 0
                for i, t in enumerate(wgl_search.TABLES):
                    placed = t in plan.smem
                    assert placed == bool(plan.mask >> i & 1)
                    if placed:
                        used += sizes[t]
                    elif sizes[t]:
                        assert used + sizes[t] > wgl_search.SMEM_MAX
                assert used == plan.bytes
                words = wgl_search._layout(tm, n_pad, n_state, cb).words
                if 4 * words > wgl_search.SCRATCH_BUDGET:
                    with pytest.raises(ValueError, match="budget"):
                        wgl_search.lanes_per_launch(tm, n_pad, n_state, cb)
                else:
                    assert wgl_search.lanes_per_launch(
                        tm, n_pad, n_state, cb) == \
                        wgl_search.SCRATCH_BUDGET // (4 * words)


# (model, n_pad, n_state, cache_bits) -> (shared bytes a lane, the
# tables left in device memory, scratch bytes a lane), counted
# by hand from the table sizes (m_pad = roundup8(2 n_pad + 1); node ids
# and the node map uint16 below n_pad 32768, node ids uint32 there):
PLANS_BY_HAND = {
    # every table: lin 16, fp 16384, nmap/nxt/prv 48 each, fact, v1, v2,
    # stack_s 32 each, stack 16; keys 8192 x 2 words
    ("cas-register", 8, 1, 13): (16688, (), 65536),
    # lin 1024, fp 16384, nmap/nxt/prv 32784 each, fact/v1/v2 32768 each,
    # stack 16384; stack_s 32768 and keys 8192 x 257 words in scratch
    ("cas-register", 8192, 1, 13): (230448, ("stack_s",),
                                    32768 + 8192 * 257 * 4),
    # lin 4096, fp 16384, nmap 131088; nxt and prv 262176 each, fact and
    # the stack's states 131072 each, the stack 131072 (uint32 nodes)
    ("cas-register", 32768, 1, 13): (
        151568, ("nxt", "fact", "prv", "stack", "stack_s"),
        2 * 262176 + 3 * 131072 + 8192 * 1025 * 4),
    # lin 2048, fp 16384, nmap/nxt 65552 each, fact 65536; prv 65552,
    # stack 32768, stack_s 65536 in scratch, v1 read in place
    ("register", 16384, 1, 13): (215072, ("prv", "stack", "stack_s"),
                                 65552 + 32768 + 65536 + 8192 * 513 * 4),
    # main_fifo_long's shape: lin 256, fp 16384, state 4096, nmap/nxt/prv
    # 8208 each, fact/v1 8192 each, stack 4096
    ("fifo-queue", 2048, 1024, 13): (65840, (), 8192 * 1088 * 4),
    # fp 131072 at cache_bits 16 still fits beside a short lane
    ("unordered-queue", 1024, 512, 16): (155824, (), 65536 * 32 * 4),
    # cache_bits 20: the fingerprints (2 MiB) in device memory
    ("mutex", 4096, 1, 20): (107056, ("fp",),
                             2 ** 21 + 2 ** 20 * 129 * 4),
}


@pytest.mark.parametrize("shape", sorted(PLANS_BY_HAND))
def test_smem_plan_by_hand(shape):
    name, n_pad, n_state, cb = shape
    lane_bytes, out, scratch = PLANS_BY_HAND[shape]
    tm = tjit.BY_NAME[name]
    plan = wgl_search._smem_plan(tm, n_pad, n_state, cb)
    lay = wgl_search._layout(tm, n_pad, n_state, cb)
    assert plan.bytes == lane_bytes
    assert tuple(lay.scratch) == out
    assert 4 * lay.words == scratch


def test_launch_plan_spreads_lanes(monkeypatch):
    """`launch_plan` gives every lane a block of its own, however many
    lanes there are, and takes the device's own shared-memory limit."""
    tm = tjit.fifo_queue

    def plan(n, n_pad, n_state):
        buf = torch.zeros((n, wgl_search._rows(n_pad)), dtype=torch.int32)
        return wgl_search.launch_plan(buf, tm, n_pad, n_state, 13)

    assert plan(16, 2048, 1024) == plan(4000, 2048, 1024) == \
        wgl_search._smem_plan(tm, 2048, 1024, 13)
    assert plan(16, 2048, 1024).bytes == 65840
    monkeypatch.setattr(wgl_search, "_smem_max", lambda dev: 40_000)
    assert plan(400, 2048, 1024) == wgl_search._smem_plan(
        tm, 2048, 1024, 13, 40_000)
    assert plan(400, 2048, 1024).bytes <= 40_000


def test_plan_words():
    """The plan as the launch takes it: the mask, each table's offset
    (shared, scratch or -1), the lane's shared bytes, the key rows'
    offset, the scratch words, the two widths."""
    tm = tjit.cas_register
    for n_pad, widths in ((8192, (2, 2)), (32768, (2, 4)),
                          (65536, (4, 4))):
        plan = wgl_search._smem_plan(tm, n_pad, 1, 13)
        lay = wgl_search._layout(tm, n_pad, 1, 13)
        words = list(wgl_search._plan_words(n_pad, plan, lay))
        k = len(wgl_search.TABLES)
        assert words[0] == plan.mask
        for i, t in enumerate(wgl_search.TABLES):
            where = lay.smem if plan.mask >> i & 1 else lay.scratch
            assert words[1 + i] == where.get(t, -1)
        assert words[1 + k:] == [plan.bytes, lay.keys, lay.words, *widths]
        assert wgl_search._widths(n_pad) == widths


def test_eligibility():
    ok = thist.entries(to_port(random_register_history(n_process=2,
                                                       n_ops=4, seed=0)))
    big = thist.entries(carry.history_from_dicts([
        {"process": 0, "type": "invoke", "f": "write", "value": 2**40},
        {"process": 0, "type": "ok", "f": "write", "value": 2**40}]))
    assert wgl_search.batch_eligible(tjit.cas_register, [ok])
    assert not wgl_search.batch_eligible(tjit.cas_register, [ok, big])
    assert not wgl_search.batch_eligible(tjit.cas_register, [])
    assert not wgl_search.eligible(None)
    with pytest.raises(ValueError):
        wgl_search.analysis_batch(tmodels.CASRegister(), [big],
                                  device="cpu")
    with pytest.raises(ValueError):
        wgl_search.analysis_batch(tmodels.CASRegister(5), [ok],
                                  device="cpu")


def test_inputs_checked():
    tm = tjit.fifo_queue
    buf = torch.zeros((1, wgl_search._rows(8)), dtype=torch.int32)
    ms = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_state"):
        wgl_search.search(buf, ms, tm, 8, 2)
    with pytest.raises(ValueError, match="n_state"):
        wgl_search.search(buf, ms, tjit.register, 8, 4)
    with pytest.raises(ValueError, match="rows"):
        wgl_search.search(buf, ms, tm, 16, 4)
    with pytest.raises(TypeError):
        wgl_search.search(buf.long(), ms, tm, 8, 4)
    out = wgl_search.search(buf, ms, tm, 8, 4)  # an empty lane is valid
    assert out[:, 0].tolist() == [wgl_search.VALID, 0, 0]


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    h = to_port(random_register_history(n_process=2, n_ops=4, seed=0))
    with pytest.raises(CudaUnavailable):
        wgl_search.analysis_batch(tmodels.CASRegister(), [h])


def test_analysis_single_history():
    """`analysis` is one lane of analysis_batch; a time limit becomes a
    step budget (at least 1000 steps)."""
    h = random_register_history(n_process=3, n_ops=30, corrupt=0.3, seed=9)
    r = wgl_search.analysis(tmodels.CASRegister(), to_port(h), device="cpu")
    j = K2.analysis(jmodels.CASRegister(), h)
    assert (r.valid, r.op.index if r.op else None) == \
        (j.valid, j.op.index if j.op else None)
    r = wgl_search.analysis(tmodels.CASRegister(), to_port(h),
                            time_limit=1e-9, device="cpu")
    assert r.valid in (True, False, "unknown")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cuda_kernel_matches_plain(cuda, name):
    """The kernel and the plain version, both on the card, bit for bit."""
    tm = tjit.BY_NAME[name]
    tess = [thist.entries(to_port(h))
            for h in histories(name, 16, n_ops=40, seed=800)]
    n_pad = wgl_search.pad_size(max(len(es) for es in tess))
    n_state = wgl_search.state_width(tm, tess)
    packed = torch.from_numpy(wgl_search._pack(tess, tm, n_pad)).to(cuda)
    for cb in (13, 3):
        msteps = torch.full((len(tess),), 20000, dtype=torch.int32,
                            device=cuda)
        got = wgl_search.search(packed, msteps, tm, n_pad, n_state, cb)
        want = wgl_search.search_plain(packed, msteps, tm, n_pad, n_state,
                                       cb)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("n_pad", [4096, 8192, 16384, 32768, 65536])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_cuda_kernel_matches_plain_per_tier(cuda, name, n_pad):
    """Small lanes packed at an n_pad of each tier of the shared-memory
    plan (the tables it puts in device memory grow with n_pad): the
    kernel and the plain version bit for bit, at cache_bits 13 and 3, and
    up to n_pad 16384 at 17 (the fingerprints in device memory)."""
    tm = tjit.BY_NAME[name]
    tess = [thist.entries(to_port(h))
            for h in histories(name, 4, n_ops=20, seed=900)]
    n_state = wgl_search.state_width(tm, tess)
    packed = torch.from_numpy(wgl_search._pack(tess, tm, n_pad)).to(cuda)
    msteps = torch.full((len(tess),), 20000, dtype=torch.int32, device=cuda)
    for cb in (13, 3, 17) if n_pad <= 16384 else (13, 3):
        got = wgl_search.search(packed, msteps, tm, n_pad, n_state, cb)
        want = wgl_search.search_plain(packed, msteps, tm, n_pad, n_state,
                                       cb)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_cuda_kernel_matches_plain_at_n_pad_8192(cuda):
    tm = tjit.cas_register
    tess = [thist.entries(to_port(random_register_history(
        n_process=5, n_ops=5600, seed=11)))]
    packed = torch.from_numpy(wgl_search._pack(tess, tm, 8192)).to(cuda)
    msteps = torch.full((1,), 20000, dtype=torch.int32, device=cuda)
    got = wgl_search.search(packed, msteps, tm, 8192, 1)
    want = wgl_search.search_plain(packed, msteps, tm, 8192, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got[0, 0]) == wgl_search.VALID
