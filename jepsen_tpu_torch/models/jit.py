"""Int-encoded model step functions on torch int32 tensors.

The kernel search can't step Python objects: it needs each model as a
branchless int32 transition function. Each kernel model packs a host
model's state into a fixed int32 vector and mirrors its semantics
exactly; tests/test_torch_models.py holds the encodings and step
results against `jepsen_tpu.models.jit`.

Two families:

- Scalar models (register / cas-register / mutex): state is one int32,
  values are encoded globally via `encode_value` (ints only), and the
  memo key is (bitset, state).
- The queue models: the unordered queue's state is a COUNT VECTOR over
  the lane's distinct values (memo key: the bitset alone; backtracking
  applies the exact inverse step), the fifo queue's a ring of value
  ids plus head/tail cursors.

Value sentinel: NIL32 marks "unknown/absent" (a crashed read's value,
an unset register). Scalar payloads must fit in int32 below NIL32 —
`lane_eligible` enforces this and the checker uses the host search
otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

NIL32 = np.int32(2**30)

# (f, value) -> (f_code, v1, v2) per scalar model, shared across lanes
# and batches (histories repeat a small value universe heavily)
_ENCODE_CACHE: dict = {}


@dataclass(frozen=True)
class JitModel:
    """A model expressed as an int32 scalar transition function.

    fs: f-name -> code mapping used by the encoder. `step(state, f, v1,
    v2) -> (state', ok)` works elementwise on int32 tensors of one
    shape (or Python ints broadcast against them)."""

    name: str
    fs: tuple
    init_state: int
    step: Callable  # (state, f, v1, v2) -> (state', ok)

    # memo key is (bitset, state); no inverse step (writes destroy state)
    state_in_key = True
    has_unstep = False

    def f_code(self, f) -> int:
        return self.fs.index(f)

    def lane_width(self, es) -> int:
        return 1

    def lane_codec(self, es) -> Callable:
        return encode_value

    def lane_eligible(self, es) -> bool:
        """Every payload in `es` has an int32 encoding. Memoized on the
        Entries instance: routing probes it once and the engine
        re-checks before packing."""
        cached = getattr(es, "_lane_elig", None)
        if cached is not None and cached[0] == self.name:
            return cached[1]
        ok = self._lane_eligible(es)
        try:
            es._lane_elig = (self.name, ok)
        except AttributeError:  # not an Entries (e.g. a test stub)
            pass
        return ok

    def _lane_eligible(self, es) -> bool:
        for f, v in zip(es.f, es.value_out):
            if f not in self.fs:
                continue  # encoded as never-linearizable, value unused
            try:
                if isinstance(v, (tuple, list)):
                    for x in v:
                        encode_value(x)
                else:
                    encode_value(v)
            except (OverflowError, TypeError, ValueError):
                return False
        return True

    def init_vec(self, width: int) -> np.ndarray:
        """The initial state as a vector of `width` int32 words (the
        scalar models use word 0)."""
        assert width >= 1
        out = np.zeros(width, np.int32)
        out[0] = self.init_state
        return out

    def encode_entry(self, fname, val, codec) -> tuple:
        """-> (f_code, v1, v2) for one entry. Ops the host model can
        NEVER linearize (unknown :f, or a cas with unknown arguments)
        encode as f = -1, which every step maps to ok=False."""
        if fname not in self.fs or (fname == "cas" and val is None):
            return -1, int(NIL32), int(NIL32)
        if isinstance(val, (tuple, list)):
            v1 = codec(val[0] if len(val) > 0 else None)
            v2 = codec(val[1] if len(val) > 1 else None)
        else:
            v1, v2 = codec(val), int(NIL32)
        return self.f_code(fname), v1, v2

    def vec_step(self, state, f, v1, v2):
        (state,) = _args(state)
        s, ok = self.step(state[0], f, v1, v2)
        return torch.cat([s.reshape(1), state[1:]]), ok

    def encode_lane(self, es) -> tuple:
        """(f, v1, v2) int32 arrays for a whole lane in one pass, through
        the module-level (f, value) cache. Unhashable payloads fall
        through to the uncached path."""
        n = len(es)
        f = np.empty(n, np.int32)
        v1 = np.empty(n, np.int32)
        v2 = np.empty(n, np.int32)
        cache = _ENCODE_CACHE.setdefault(self.name, {})
        enc = self.encode_entry
        for e, (fn, val) in enumerate(zip(es.f, es.value_out)):
            try:
                key = (fn, val) if not isinstance(val, list) \
                    else (fn, tuple(val))
                t = cache.get(key)
                if t is None:
                    t = enc(fn, val, encode_value)
                    cache[key] = t
            except TypeError:  # unhashable payload
                t = enc(fn, val, encode_value)
            f[e], v1[e], v2[e] = t
        return f, v1, v2

    def encode_batch(self, entries_list, total: int) -> tuple:
        """Flat (f, v1, v2) arrays over a whole batch of lanes, interning
        distinct (f, value) pairs so each is encoded once and the
        expansion is one table gather. Raises TypeError on unhashable
        payloads — callers fall back to encode_lane per lane."""
        keymap: dict = {}
        firsts: list = []

        def kid(fn, val):
            k = (fn, tuple(val)) if type(val) is list else (fn, val)
            i = keymap.get(k)
            if i is None:
                i = len(keymap)
                keymap[k] = i
                firsts.append((fn, val))
            return i

        ids = np.fromiter(
            (kid(fn, val) for es in entries_list
             for fn, val in zip(es.f, es.value_out)),
            np.int64, total)
        cache = _ENCODE_CACHE.setdefault(self.name, {})
        enc = self.encode_entry

        def one(fn, val):
            k = (fn, tuple(val)) if type(val) is list else (fn, val)
            t = cache.get(k)
            if t is None:
                t = enc(fn, val, encode_value)
                cache[k] = t
            return t

        table = np.array(
            [one(fn, val) for fn, val in firsts],
            np.int32).reshape(len(firsts), 3)
        t = table[ids]
        return (np.ascontiguousarray(t[:, 0]),
                np.ascontiguousarray(t[:, 1]),
                np.ascontiguousarray(t[:, 2]))


def _args(state, *xs):
    """`state` and the op fields as int32 tensors on state's device
    (Python ints and numpy scalars included)."""
    state = torch.as_tensor(state, dtype=torch.int32)
    return (state,) + tuple(
        torch.as_tensor(x, dtype=torch.int32, device=state.device)
        for x in xs)


def _cas_register_step(state, f, v1, v2):
    # f: 0=read 1=write 2=cas; f == -1 (unknown/malformed op) falls
    # through every branch to ok=False
    state, f, v1, v2 = _args(state, f, v1, v2)
    is_read = f == 0
    is_write = f == 1
    is_cas = f == 2
    match = state == v1
    ok = (is_read & ((v1 == int(NIL32)) | match)) | is_write | (is_cas & match)
    new_state = torch.where(is_write, v1,
                            torch.where(is_cas & match, v2, state))
    return new_state, ok


cas_register = JitModel(
    name="cas-register",
    fs=("read", "write", "cas"),
    init_state=int(NIL32),  # unset
    step=_cas_register_step,
)


def _register_step(state, f, v1, v2):
    # f: 0=read 1=write; f == -1 (unknown/malformed op) is never ok
    state, f, v1 = _args(state, f, v1)
    is_read = f == 0
    is_write = f == 1
    ok = is_write | (is_read & ((v1 == int(NIL32)) | (state == v1)))
    new_state = torch.where(is_write, v1, state)
    return new_state, ok


register = JitModel(
    name="register",
    fs=("read", "write"),
    init_state=int(NIL32),
    step=_register_step,
)


def _mutex_step(state, f, v1, v2):
    # f: 0=acquire 1=release; state: 0=free 1=held; f == -1 never ok
    state, f = _args(state, f)
    is_acquire = f == 0
    is_release = f == 1
    ok = (is_acquire & (state == 0)) | (is_release & (state == 1))
    new_state = torch.where(
        ok, is_acquire.to(torch.int32), state)
    return new_state, ok


mutex = JitModel(
    name="mutex",
    fs=("acquire", "release"),
    init_state=0,
    step=_mutex_step,
)


@dataclass(frozen=True)
class QueueJitModel:
    """knossos.model/unordered-queue as a count-vector kernel model.

    State is int32[width] where slot i counts the pending copies of the
    lane's i-th distinct value (per-lane value -> slot map, so any
    hashable payload works). state_in_key=False: the multiset is a
    function of WHICH entries are linearized, so the bitset alone is a
    complete memo key. has_unstep=True: backtracking applies the exact
    inverse step instead of restoring a snapshot."""

    name: str = "unordered-queue"
    fs: tuple = ("enqueue", "dequeue")

    state_in_key = False
    has_unstep = True

    def f_code(self, f) -> int:
        return self.fs.index(f)

    def _universe(self, es) -> dict:
        """value -> slot over every enqueue/dequeue payload in the lane
        (insertion order), memoized on the Entries instance."""
        cached = getattr(es, "_q_universe", None)
        if cached is not None:
            return cached
        m: dict = {}
        for f, v in zip(es.f, es.value_out):
            if f in self.fs and v not in m:
                m[v] = len(m)
        try:
            es._q_universe = m
        except AttributeError:  # not an Entries (e.g. a test stub)
            pass
        return m

    def lane_width(self, es) -> int:
        return max(1, len(self._universe(es)))

    def lane_codec(self, es) -> Callable:
        m = self._universe(es)
        return lambda v: m[v]

    def lane_eligible(self, es) -> bool:
        """Eligible iff every queue payload is hashable (memoized)."""
        cached = getattr(es, "_lane_elig", None)
        if cached is not None and cached[0] == self.name:
            return cached[1]
        try:
            self._universe(es)
            ok = True
        except TypeError:
            ok = False
        try:
            es._lane_elig = (self.name, ok)
        except AttributeError:
            pass
        return ok

    def init_vec(self, width: int) -> np.ndarray:
        return np.zeros(width, np.int32)

    def encode_entry(self, fname, val, codec) -> tuple:
        if fname not in self.fs:
            return -1, int(NIL32), int(NIL32)
        return self.f_code(fname), codec(val), int(NIL32)

    def encode_lane(self, es) -> tuple:
        """(f, v1, v2) int32 arrays for a whole lane (per-lane codec)."""
        n = len(es)
        f = np.empty(n, np.int32)
        v1 = np.empty(n, np.int32)
        v2 = np.empty(n, np.int32)
        codec = self.lane_codec(es)
        for e, (fn, val) in enumerate(zip(es.f, es.value_out)):
            f[e], v1[e], v2[e] = self.encode_entry(fn, val, codec)
        return f, v1, v2

    def vec_step(self, state, f, v1, v2):
        # f: 0=enqueue 1=dequeue; v1 = slot index. f == -1 never ok.
        state, f, v1 = _args(state, f, v1)
        is_enq = f == 0
        is_deq = f == 1
        slot = v1.clamp(0, state.shape[0] - 1)
        ok = is_enq | (is_deq & (state[slot] > 0))
        delta = (ok & is_enq).to(torch.int32) - (ok & is_deq).to(torch.int32)
        return state.index_add(0, slot.reshape(1), delta.reshape(1)), ok

    def vec_unstep(self, state, f, v1, v2):
        # exact inverse of an APPLIED (ok) transition
        state, f, v1 = _args(state, f, v1)
        slot = v1.clamp(0, state.shape[0] - 1)
        delta = torch.where(f == 0, -1, 1).to(torch.int32)
        return state.index_add(0, slot.reshape(1), delta.reshape(1))


unordered_queue = QueueJitModel()


@dataclass(frozen=True)
class FifoQueueJitModel(QueueJitModel):
    """knossos.model/fifo-queue as a ring-buffer kernel model.

    State is int32[W+2]: W buffer slots holding encoded value ids in
    enqueue order, then head and tail cursors (W = the lane's enqueue
    count). Enqueue writes buf[tail], tail+=1; dequeue is ok iff
    head<tail and buf[head] == v, head+=1. Order matters, so the memo
    key includes the (canonicalized) state; both transitions are
    exactly invertible."""

    name: str = "fifo-queue"

    state_in_key = True
    has_unstep = True

    def lane_width(self, es) -> int:
        n_enq = sum(1 for f in es.f if f == "enqueue")
        return max(1, n_enq) + 2

    def vec_step(self, state, f, v1, v2):
        state, f, v1 = _args(state, f, v1)
        w = state.shape[0] - 2
        head, tail = state[w], state[w + 1]
        is_enq = f == 0
        is_deq = f == 1
        front = state[head.clamp(0, w - 1)]
        enq_ok = is_enq & (tail < w)
        deq_ok = is_deq & (head < tail) & (front == v1)
        slot = tail.clamp(0, w - 1)
        out = state.clone()
        out[slot] = torch.where(enq_ok, v1, state[slot])
        out[w] = head + deq_ok.to(torch.int32)
        out[w + 1] = tail + enq_ok.to(torch.int32)
        return out, enq_ok | deq_ok

    def vec_unstep(self, state, f, v1, v2):
        # exact inverse of an APPLIED (ok) transition
        state, f = _args(state, f)
        w = state.shape[0] - 2
        out = state.clone()
        out[w] = state[w] - (f == 1).to(torch.int32)
        out[w + 1] = state[w + 1] - (f == 0).to(torch.int32)
        return out

    def vec_canon(self, state):
        """The LOGICAL queue: live window shifted to offset 0, dead
        slots zeroed, cursors (count, 0)."""
        (state,) = _args(state)
        w = state.shape[0] - 2
        head, tail = state[w], state[w + 1]
        count = tail - head
        idx = (torch.arange(w, device=state.device) + head) % w
        live = torch.arange(w, device=state.device) < count
        buf = torch.where(live, state[:w][idx], 0).to(torch.int32)
        return torch.cat([buf, torch.stack([count, torch.zeros_like(count)])])


fifo_queue = FifoQueueJitModel()


BY_NAME = {
    m.name: m
    for m in (cas_register, register, mutex, unordered_queue, fifo_queue)
}


def for_model(model):
    """The kernel-model equivalent of a host model instance (fresh state
    only), or None if the model has no kernel encoding."""
    from . import CASRegister, FIFOQueue, Mutex, Register, UnorderedQueue

    if isinstance(model, CASRegister) and model.value is None:
        return cas_register
    if isinstance(model, Register) and model.value is None:
        return register
    if isinstance(model, Mutex) and not model.locked:
        return mutex
    if isinstance(model, UnorderedQueue) and not model.pending:
        return unordered_queue
    if isinstance(model, FIFOQueue) and not model.items:
        return fifo_queue
    return None


def encode_value(v) -> int:
    """Encode one payload scalar for the kernel; None -> NIL32. Only true
    integers are encodable — floats/strings raise instead of being
    coerced (the checker then uses the host search)."""
    if type(v) is int:
        if -1073741824 < v < 1073741824:  # +-2**30
            return v
        raise OverflowError(
            f"value {v} does not fit the int32 kernel encoding")
    if v is None:
        return int(NIL32)
    import numbers

    if not isinstance(v, numbers.Integral):
        raise TypeError(f"value {v!r} has no int32 kernel encoding")
    v = int(v)
    if not (-(2**30) < v < 2**30):
        raise OverflowError(f"value {v} does not fit the int32 kernel encoding")
    return v
