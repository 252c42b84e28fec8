"""The port's closure engine (jepsen_tpu_torch/ops/closure.py, K3's
counterpart, and ops/closure_host.py) against the JAX package's
(jepsen_tpu/ops/closure_tpu.py on XLA's CPU backend, ops/closure_host.py)
and a Floyd–Warshall reference, on the same numpy-seeded digraphs. On
the CPU the wrappers run the plain PyTorch versions; every comparison
is exact (bool matrices and packed words, tolerance zero)."""

import time

import numpy as np
import pytest
import torch

from jepsen_tpu.ops import closure_host as jclosure_host
from jepsen_tpu.ops import closure_tpu

from jepsen_tpu_torch.device import CudaUnavailable
from jepsen_tpu_torch.ops import closure, closure_host

# the JAX package's closure test set (tests/test_cycle_closure.py SMALL)
SMALL = [(1, 0.5, 0), (2, 1.0, 1), (5, 0.3, 2), (17, 0.15, 3),
         (33, 0.12, 4), (64, 0.06, 5), (128, 0.02, 6), (128, 0.2, 7)]


def digraph(n: int, density: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < density
    np.fill_diagonal(a, False)
    return a


def warshall(a: np.ndarray) -> np.ndarray:
    """Independent reference closure (paths of length >= 1)."""
    r = np.array(a, dtype=bool)
    for k in range(r.shape[0]):
        r |= np.outer(r[:, k], r[k, :])
    return r


def complete(n: int) -> np.ndarray:
    a = np.ones((n, n), dtype=bool)
    np.fill_diagonal(a, False)
    return a


@pytest.mark.parametrize("n,density,seed", SMALL)
def test_reach_matches_jax_and_warshall(n, density, seed):
    a = digraph(n, density, seed)
    ref = warshall(a)
    port = closure.reach(a, device="cpu")
    assert np.array_equal(port, ref)
    assert np.array_equal(port, closure_tpu.reach(a))
    assert np.array_equal(closure_host.reach(a), jclosure_host.reach(a))
    assert np.array_equal(closure.reach_batch_plain([a])[0], ref)
    assert np.array_equal(closure_host.same_scc(port),
                          jclosure_host.same_scc(ref))
    assert np.array_equal(closure_host.cyclic_nodes(port),
                          jclosure_host.cyclic_nodes(ref))


def test_batch_mixed_sizes_stays_aligned():
    """Pad buckets 32 and 64 in one call, an empty matrix among them:
    results come back in input order, equal to the JAX package's."""
    mats = [digraph(7, 0.4, 20), np.zeros((0, 0), dtype=bool),
            digraph(40, 0.1, 21), digraph(3, 0.9, 22),
            digraph(40, 0.2, 23)]
    port = closure.reach_batch(mats, device="cpu")
    jax = closure_tpu.reach_batch(mats)
    for a, p, j in zip(mats, port, jax):
        assert p.shape == j.shape == a.shape
        assert np.array_equal(p, j)
        assert np.array_equal(p, warshall(a))


def test_non_square_rejected():
    with pytest.raises(ValueError):
        closure.reach_batch([np.zeros((3, 4), dtype=bool)], device="cpu")
    with pytest.raises(ValueError):
        closure_host.reach(np.zeros((3, 4), dtype=bool))


def test_probe():
    assert closure.probe("cpu") is True
    assert closure_tpu.probe() is True


def test_complete_600_counts_past_bf16_integers():
    """A complete 600-node digraph (pad 1024): every product entry
    counts 598 or 599 two-step paths, past the 256 bf16 holds exactly;
    rounded, each stays positive, so the closure is exact."""
    a = complete(600)
    m = closure.unpack(torch.from_numpy(closure._pack([a], 1024)), 1024)
    prod = closure.matmul(m)
    assert prod.dtype == torch.bfloat16
    assert float(prod[0, 0, 1]) != 598.0  # rounded, not exact ...
    assert float(prod[0, :600, :600].min()) > 256  # ... and positive
    port = closure.reach(a, device="cpu")
    assert port.all()
    assert np.array_equal(port, warshall(a))
    assert np.array_equal(port, closure_tpu.reach(a))


def test_pack_matches_jax():
    """The host packing is the JAX package's `_pack` layout, word for
    word (uint32 bits as int32), and round-trips."""
    mats = [digraph(5, 0.5, 30), digraph(32, 0.3, 31), digraph(20, 0.6, 32)]
    words = closure._pack(mats, 32)
    batch = np.zeros((3, 32, 32), dtype=np.float32)
    for j, a in enumerate(mats):
        batch[j, :a.shape[0], :a.shape[0]] = a
    jw = np.array(closure_tpu._pack(batch)).view(np.int32)
    assert np.array_equal(words, jw)
    for j, a in enumerate(mats):
        assert np.array_equal(closure._unpack(words[j], a.shape[0]), a)
    t = torch.from_numpy(batch).bool()
    assert torch.equal(closure.pack_bits(t), torch.from_numpy(jw))


def test_unpack_and_pack_plain_match_jax():
    a = digraph(64, 0.3, 40)
    a[:, 31] = a[:, 63] = True  # bit 31: the sign bit of an int32 word
    words = closure._pack([a], 64)
    m = closure.unpack_plain(torch.from_numpy(words), 64)
    jm = np.asarray(closure_tpu._unpack(words.view(np.uint32), 64))
    assert m.dtype == torch.bfloat16
    assert np.array_equal(m.float().numpy(), jm)
    assert torch.equal(closure.pack_bits(m > 0), torch.from_numpy(words))


def test_or_threshold_pack_plain():
    """words | pack(prod > 0), and the flag: raised on a change, left as
    it was otherwise (the kernel writes only 1s)."""
    rng = np.random.default_rng(41)
    words = torch.from_numpy(closure._pack([digraph(64, 0.1, 42)], 64))
    prod = torch.from_numpy(rng.integers(0, 3, (1, 64, 64))
                            * (rng.random((1, 64, 64)) < 0.1)).bfloat16()
    prod[0, 5, 31] = 300.0  # a rounded count, positive
    flag = torch.zeros(1, dtype=torch.int32)
    new = closure.or_threshold_pack(prod, words, flag)
    ref = words | closure.pack_bits(prod > 0)
    assert torch.equal(new, ref) and int(flag) == 1
    flag.zero_()
    same = closure.or_threshold_pack_plain(prod, new, flag, out=new.clone())
    assert torch.equal(same, new) and int(flag) == 0
    flag.fill_(1)
    closure.or_threshold_pack_plain(prod, new, flag, out=new)
    assert int(flag) == 1
    with pytest.raises(ValueError):
        closure.or_threshold_pack(prod.float(), words, flag)
    # with the operand the product read: refreshed to unpack(new words)
    operand = closure.unpack_plain(words, 64)
    flag.zero_()
    got = closure.or_threshold_pack(prod, words, flag, operand=operand)
    assert torch.equal(got, ref) and int(flag) == 1
    assert torch.equal(operand, closure.unpack_plain(ref, 64))
    # ... and only under the bytes that gained bits: a garbage operand
    # keeps its values elsewhere
    garbage = torch.from_numpy(rng.standard_normal((1, 64, 64))
                               .astype(np.float32)).bfloat16()
    operand = garbage.clone()
    closure.or_threshold_pack_plain(prod, words, flag, operand=operand)
    gained = (words.numpy().view(np.uint8)
              != ref.numpy().view(np.uint8)).reshape(1, 64, 8, 1)
    want = np.where(gained, closure.unpack_plain(ref, 64).float().numpy()
                    .reshape(1, 64, 8, 8),
                    garbage.float().numpy().reshape(1, 64, 8, 8))
    assert 0 < gained.sum() < gained.size
    assert np.array_equal(operand.float().numpy().reshape(want.shape), want)
    # nothing gained: not one operand value is written
    kept = garbage.clone()
    flag.zero_()
    closure.or_threshold_pack_plain(prod, ref, flag, out=ref.clone(),
                                    operand=garbage)
    assert int(flag) == 0
    assert torch.equal(garbage.view(torch.int16), kept.view(torch.int16))
    with pytest.raises(ValueError):
        closure.or_threshold_pack(prod, words, flag, operand=prod)
    with pytest.raises(ValueError):
        closure.or_threshold_pack(prod, words, flag,
                                  operand=operand.float())


@pytest.mark.parametrize("case", ["p64", "p128", "complete300"])
def test_rounds_with_operand_match_jax(case):
    """The port's plain fixpoint, one round at a time (the product, then
    the threshold pass refreshing the operand in place), against the JAX
    package's `_closure_packed(words, n, rounds=t)` for t = 1, 2, ...:
    equal words after every round, the operand equal to
    unpack_plain(words) after every round, and the same rounds (JAX's:
    the first round that changes nothing, or the cap)."""
    if case == "complete300":
        mats = [complete(300)]
    else:
        n = int(case[1:])
        mats = [digraph(n, 1.5 / n, n + 1), digraph(n - 9, 2.5 / n, n + 2)]
    p = closure.pad_size(max(a.shape[0] for a in mats))
    cap = closure.rounds_for(p)
    words0 = closure._pack(mats, p)
    words = torch.from_numpy(words0.copy())
    operand = closure.unpack_plain(words, p)
    flag = torch.zeros(1, dtype=torch.int32)
    prev = words0
    port_rounds = jax_rounds = cap
    for t in range(1, cap + 1):
        prod = closure.matmul(operand)
        flag.zero_()
        closure.or_threshold_pack_plain(prod, words, flag, out=words,
                                        operand=operand)
        jw = np.asarray(closure_tpu._closure_packed(
            words0.view(np.uint32), p, rounds=t)).view(np.int32)
        assert np.array_equal(words.numpy(), jw), t
        assert torch.equal(operand, closure.unpack_plain(words, p)), t
        if not int(flag) and port_rounds == cap:
            port_rounds = t
        if np.array_equal(jw, prev):
            jax_rounds = t
            break
        prev = jw
    assert port_rounds == jax_rounds
    closed, ran = closure.closure_block_plain(torch.from_numpy(words0), p)
    assert ran == jax_rounds and torch.equal(closed, words)
    if case == "complete300":
        assert ran == 2
    else:
        assert ran > 3
    for j, a in enumerate(mats):
        assert np.array_equal(closure._unpack(closed[j].numpy(), a.shape[0]),
                              warshall(a))


def test_closure_word_plain_matches_jax():
    """The one-word bucket: 64 matrices of 2-32 nodes, edges into
    column 31 (the sign bit) in each, against `_closure_packed_word`
    word for word, with the rounds each matrix ran."""
    rng = np.random.default_rng(50)
    mats = []
    for i in range(64):
        n = int(rng.integers(2, 33))
        a = digraph(n, float(rng.random()) * 0.3, 100 + i)
        if n == 32:
            a[rng.integers(32), 31] = True
        mats.append(a)
    mats.append(np.eye(32, k=1, dtype=bool))  # a 32-node path
    words = closure._pack(mats, 32)[..., 0]
    rounds = closure.rounds_for(32)
    out, taken = closure.closure_word(torch.from_numpy(words), rounds)
    jw = closure_tpu._closure_packed_word(words.view(np.uint32), rounds)
    assert np.array_equal(out.numpy(), np.asarray(jw).view(np.int32))
    assert bool((out.numpy() < 0).any())  # the bit-31 column was set
    for j, a in enumerate(mats):
        got = closure._unpack(out.numpy()[j][:, None], a.shape[0])
        assert np.array_equal(got, warshall(a))
    # rounds: until the first round that changes nothing, capped
    assert taken.tolist()[-1] == 6  # the path: 1, 2, 4, 8, 16, then none
    zero = torch.zeros((1, 32), dtype=torch.int32)
    assert closure.closure_word(zero, rounds)[1].tolist() == [1]
    assert int(taken.max()) <= rounds


def test_capture_replays_through_the_plain_block():
    """CAPTURE holds each bucket's input: replayed through
    closure_block_plain it gives the closure reach_batch returned."""
    mats = [digraph(20, 0.2, 60), digraph(50, 0.05, 61),
            digraph(70, 0.04, 62)]
    closure.CAPTURE = []
    try:
        out = closure.reach_batch(mats, device="cpu")
        captured = closure.CAPTURE
    finally:
        closure.CAPTURE = None
    assert [(w.shape, p, r) for w, p, r in captured] == [
        ((1, 32, 1), 32, 6), ((1, 64, 2), 64, 7), ((1, 128, 4), 128, 8)]
    for (w, p, _), a in zip(captured, mats):
        words, ran = closure.closure_block_plain(w, p)
        assert np.array_equal(closure._unpack(words[0].numpy(),
                                              a.shape[0]), warshall(a))
    assert all(np.array_equal(o, warshall(a)) for o, a in zip(out, mats))


def test_deadline_checked_before_each_bucket():
    mats = [digraph(10, 0.3, 70), digraph(40, 0.1, 71)]
    with pytest.raises(closure.DeadlineExpired):
        closure.reach_batch(mats, device="cpu",
                            budget=time.monotonic() - 1)
    assert closure.reach_batch([], device="cpu",
                               budget=time.monotonic() - 1) == []
    far = time.monotonic() + 600
    out = closure.reach_batch(mats, device="cpu", budget=far)
    assert all(np.array_equal(o, warshall(a)) for o, a in zip(out, mats))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device resolves")
    with pytest.raises(CudaUnavailable):
        closure.reach_batch([digraph(5, 0.3, 80)])
    with pytest.raises(CudaUnavailable):
        closure.probe()


def test_shortest_cycle_path_matches_jax():
    """The level-at-a-time BFS picks the JAX package's paths, on sparse
    and dense graphs, cycles (start == goal) and unreachable goals."""
    rng = np.random.default_rng(90)
    for t in range(200):
        n = int(rng.integers(1, 80))
        a = rng.random((n, n)) < float(rng.random()) * 0.4
        s, g = int(rng.integers(n)), int(rng.integers(n))
        if t % 3 == 0:
            g = s
        assert (closure_host.shortest_cycle_path(a, s, g)
                == jclosure_host.shortest_cycle_path(a, s, g))


# ---------------------------------------------------------------------------
# One-word buckets of concurrent callers: one shared launch (close_words)

def word_bucket(seed: int) -> list:
    """1-4 seeded matrices of 1-32 nodes, and a 32-node one with edges
    into column 31 (the sign bit of a word)."""
    rng = np.random.default_rng(seed)
    mats = [digraph(int(rng.integers(1, 33)), float(rng.random()) * 0.3,
                    seed * 10 + j) for j in range(int(rng.integers(1, 5)))]
    a = digraph(32, 0.08, seed * 10 + 9)
    a[rng.integers(32, size=3), 31] = True
    return mats + [a]


def old_pack(mats, p: int) -> np.ndarray:
    """The host packing as it was: one np.packbits a matrix."""
    out = np.zeros((len(mats), p, p // 8), dtype=np.uint8)
    for j, a in enumerate(mats):
        if a.shape[0]:
            bits = np.packbits(a, axis=1, bitorder="little")
            out[j, :a.shape[0], :bits.shape[1]] = bits
    return out.view("<i4")


def old_unpack(words: np.ndarray, n: int) -> np.ndarray:
    by = np.ascontiguousarray(words[:n]).view(np.uint8)
    return np.unpackbits(by, axis=1, count=n, bitorder="little").astype(bool)


class Launches:
    """closure.closure_word wrapped: counts the calls (each one launch,
    on the card) and their batch sizes; the first call waits until
    `hold` more buckets are pending on the CPU's queue (so they arrive
    while it is in flight); `fail` maps a call number to the exception
    that call raises."""

    def __init__(self, monkeypatch, hold: int = 0, fail=None):
        self.real, self.sizes, self.hold = closure.closure_word, [], hold
        self.fail = fail or {}
        self.queue = closure._word_queue(torch.device("cpu"))
        monkeypatch.setattr(closure, "closure_word", self)

    def __call__(self, words, rounds, **kw):
        self.sizes.append(words.shape[0])
        if len(self.sizes) == 1:
            t_end = time.monotonic() + 30
            while len(self.queue.pending) < self.hold:
                assert time.monotonic() < t_end, "callers never queued"
                time.sleep(0.001)
        if len(self.sizes) in self.fail:
            raise self.fail[len(self.sizes)]
        return self.real(words, rounds, **kw)


def burst(n: int, fn) -> list:
    """fn(i) in n threads released together by a barrier: each one's
    result or exception."""
    import threading

    gate, out = threading.Barrier(n), [None] * n

    def run(i):
        gate.wait()
        try:
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001
            out[i] = e

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return out


@pytest.mark.parametrize("entry", ["close_words", "reach_batch"])
def test_concurrent_word_buckets_share_a_launch(monkeypatch, entry):
    """Eight callers released together: the first leads alone, the seven
    that arrive while its launch is in flight share the next one (two
    launches). Each caller gets the closed words and per-matrix rounds
    of closure_word_plain on its own bucket, and the closures of the JAX
    package's reach_batch on its matrices."""
    n = 8
    buckets = [word_bucket(200 + i) for i in range(n)]
    words = [closure._pack(m, 32)[..., 0] for m in buckets]
    calls = Launches(monkeypatch, hold=n - 1)
    if entry == "close_words":
        got = burst(n, lambda i: closure.close_words(words[i], "cpu"))
    else:
        got = burst(n, lambda i: closure.reach_batch(buckets[i], "cpu"))
    assert len(calls.sizes) == 2
    assert calls.sizes[0] in {len(m) for m in buckets}
    assert sum(calls.sizes) == sum(len(m) for m in buckets)
    for i in range(n):
        assert not isinstance(got[i], BaseException), got[i]
        if entry == "close_words":
            w, t = closure.closure_word_plain(torch.from_numpy(words[i]), 6)
            assert np.array_equal(got[i][0], w.numpy())
            assert np.array_equal(got[i][1], t.numpy())
        else:
            for g, j, a in zip(got[i], closure_tpu.reach_batch(buckets[i]),
                               buckets[i]):
                assert np.array_equal(g, j) and np.array_equal(g, warshall(a))
    assert not calls.queue.pending and not calls.queue.busy


@pytest.mark.parametrize("fault", ["kernel", "cuda_runtime"])
def test_fault_of_a_merged_launch_reaches_every_caller(monkeypatch, fault):
    """The second launch carries seven callers' buckets and fails: each
    of the seven raises that fault (a card fault by checker.is_fault),
    none is retried alone (two launches in all), and the first caller,
    whose launch ran, has its closures."""
    from jepsen_tpu_torch.checker import is_fault
    from jepsen_tpu_torch.device import KernelError

    err = (KernelError("closure_word kernel launch failed: cudaError 700")
           if fault == "kernel" else
           RuntimeError("CUDA error: an illegal memory access was "
                         "encountered"))
    n = 8
    buckets = [word_bucket(300 + i) for i in range(n)]
    calls = Launches(monkeypatch, hold=n - 1, fail={2: err})
    got = burst(n, lambda i: closure.reach_batch(buckets[i], "cpu"))
    assert len(calls.sizes) == 2
    ok = [i for i in range(n) if not isinstance(got[i], BaseException)]
    assert len(ok) == 1 and calls.sizes[0] == len(buckets[ok[0]])
    assert all(np.array_equal(g, warshall(a))
               for g, a in zip(got[ok[0]], buckets[ok[0]]))
    for i in set(range(n)) - set(ok):
        assert got[i] is err and is_fault(got[i])
    assert not calls.queue.pending and not calls.queue.busy


def test_lone_caller_launches_once_and_never_waits(monkeypatch):
    """A caller alone leads at once: one launch, no wait on the queue."""
    import threading

    calls = Launches(monkeypatch)
    waits = []

    class Cond(type(threading.Condition())):
        def wait(self, timeout=None):
            waits.append(timeout)
            return super().wait(timeout)

    monkeypatch.setattr(calls.queue, "cond", Cond())
    mats = word_bucket(400)
    out = closure.reach_batch(mats, device="cpu")
    assert calls.sizes == [len(mats)] and waits == []
    assert all(np.array_equal(o, warshall(a)) for o, a in zip(out, mats))


def test_deadline_raises_before_anything_is_submitted(monkeypatch):
    monkeypatch.setattr(closure, "close_words", lambda *a: pytest.fail(
        "a bucket was submitted past the deadline"))
    with pytest.raises(closure.DeadlineExpired):
        closure.reach_batch(word_bucket(500), device="cpu",
                            budget=time.monotonic() - 1)


@pytest.mark.parametrize("p", [32, 64, 128, 512, 1024])
def test_one_pass_pack_matches_old_and_jax(p):
    """_pack (one np.packbits a bucket) is byte-identical to the packing
    one matrix at a time and to the JAX package's `_pack`, at every pad
    size this file tests, over buckets of mixed sizes (a lone matrix,
    an empty one among them); _unpack_bucket (one np.unpackbits a
    bucket) gives each matrix as the old unpacking did."""
    rng = np.random.default_rng(p)
    lo = p // 2 + 1 if p > 32 else 1
    mats = [digraph(int(rng.integers(lo, p + 1)), 0.1, p + j)
            for j in range(3)]
    mats[0][:, -1] = True  # the last column: bit 31 of a word at p 32
    for bucket in (mats, mats[:1], [np.zeros((0, 0), dtype=bool)] + mats):
        words = closure._pack(bucket, p)
        old = old_pack(bucket, p)
        assert words.dtype == old.dtype and words.tobytes() == old.tobytes()
        batch = np.zeros((len(bucket), p, p), dtype=np.float32)
        for j, a in enumerate(bucket):
            batch[j, :a.shape[0], :a.shape[0]] = a
        jw = np.array(closure_tpu._pack(batch)).view(np.int32)
        assert words.tobytes() == jw.tobytes()
        ns = [a.shape[0] for a in bucket]
        for got, w, a in zip(closure._unpack_bucket(words, ns), words,
                             bucket):
            assert np.array_equal(got, old_unpack(w, a.shape[0]))
            assert np.array_equal(got, a)


# ---------------------------------------------------------------------------
# On the card (skipped without CUDA: the kernels have no CPU build)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


def test_cuda_kernels_match_plain(cuda):
    mats = [digraph(n, 4.0 / n, n) for n in (7, 33, 100, 700)]
    mats.append(complete(300))
    got = closure.reach_batch(mats, device=cuda)
    plain = closure.reach_batch_plain(mats, device=cuda)
    for g, p, a in zip(got, plain, mats):
        assert np.array_equal(g, p)
        assert np.array_equal(g, closure_host.reach(a))
    words = torch.from_numpy(closure._pack(
        [digraph(32, 0.1, i) for i in range(100)], 32)[..., 0]).to(cuda)
    k, kt = closure.closure_word(words, 6)
    p, pt = closure.closure_word_plain(words, 6)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and torch.equal(kt, pt)
    # unpack, and the threshold pass (which takes the operand on the card)
    words = torch.from_numpy(closure._pack(
        [digraph(300, 4.0 / 300, i) for i in range(3)], 512)).to(cuda)
    m = closure.unpack(words, 512)
    assert torch.equal(m, closure.unpack_plain(words, 512))
    prod = closure.matmul(m)
    flags = [torch.zeros(1, dtype=torch.int32, device=cuda)
             for _ in range(2)]
    with pytest.raises(ValueError):
        closure.or_threshold_pack(prod, words, flags[0])
    ops = [m.clone(), m.clone()]
    k = closure.or_threshold_pack(prod, words, flags[0], operand=ops[0])
    p = closure.or_threshold_pack_plain(prod, words, flags[1],
                                        operand=ops[1])
    torch.cuda.synchronize()
    assert torch.equal(k, p) and int(flags[0]) == int(flags[1]) == 1
    assert torch.equal(ops[0], ops[1])
    assert torch.equal(ops[0], closure.unpack_plain(k, 512))


def test_cuda_shared_launches_match_plain(cuda):
    """Callers released together on the card share closure_word
    launches (fewer than callers, through the pinned staging pair), and
    each gets closure_word_plain's words and rounds on its own bucket."""
    n = 16
    words = [closure._pack(word_bucket(600 + i), 32)[..., 0]
             for i in range(n)]
    before = closure.LAUNCHES["closure_word"]
    got = burst(n, lambda i: closure.close_words(words[i], cuda))
    assert 0 < closure.LAUNCHES["closure_word"] - before < n
    for w, g in zip(words, got):
        pw, pt = closure.closure_word_plain(torch.from_numpy(w), 6)
        assert np.array_equal(g[0], pw.numpy())
        assert np.array_equal(g[1], pt.numpy())


def test_launch_count_under_threads():
    """Checkers launch K3 from many threads at once (one a key under
    independent.checker, each composed checker in its own): the launch
    count is a read-modify-write under a lock, so none is lost with
    more threads than cores and a short switch interval."""
    import sys
    import threading

    saved, interval = dict(closure.LAUNCHES), sys.getswitchinterval()
    n_threads, each = 16, 5000
    sys.setswitchinterval(1e-6)
    try:
        closure.LAUNCHES["closure_word"] = 0
        ts = [threading.Thread(
            target=lambda: [closure._count("closure_word")
                            for _ in range(each)]) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        assert closure.LAUNCHES["closure_word"] == n_threads * each
    finally:
        sys.setswitchinterval(interval)
        closure.LAUNCHES.update(saved)
