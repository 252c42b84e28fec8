"""The WGL batch search with a probed memo, any power-of-two n_pad and a
vector model state: the port of the JAX package's K2 engine,
`jepsen_tpu/ops/wgl_tpu.py` (`_search_one`, `analysis_batch`), one CUDA
warp per lane (csrc/wgl_search.cu).

Host side, shared with `ops/wgl_row.py` (K5's counterpart):
- the verdict codes and default budgets (from `ops.common`), the memo
  size and its probe count;
- `encode_entries`: one lane's fixed-shape int32 arrays — node ids
  (0 is the head sentinel, the event at position p is node p+1), the
  node -> entry map and the initial linked list (byte-identical to
  wgl_tpu's);
- `_zobrist_table`: one uint32 per entry, XOR-ed into the bitset hash as
  the entry linearizes and out as it backtracks;
- `pad_size`: the pow2 bucket (floor 8) a batch pads to. wgl_tpu's floor
  is 32; a lane's search does not depend on it (the Zobrist constants
  depend on the entry index only, and n_pad <= 32 is one bitset word);
- `_pack`: the lanes lane-major in one int32 array of rows

    f, v1, v2, crashed, call_node, ret_node   (n_pad each)
    node_entry, node_is_call, nxt0, prv0      (m_pad each)
    n_completed                               (1)

  with m_pad = roundup8(2*n_pad + 1).

The search (K2): every model of `models/jit.py` — the scalar models
(state one int32, undone from a snapshot stack), the unordered queue (a
count vector of `n_state` words, not in the memo key, undone by the
inverse step) and the fifo queue (a ring of n_state-2 value ids plus
head and tail, its canonical live window in the key, undone by the
inverse step). `n_state` is the batch's widest `jm.lane_width`,
bucketed to a power of two as wgl_tpu does; narrower lanes never touch
the words past their own width. The memo is 2^cache_bits slots
(default 13), each an exact key — the ceil(n_pad/32) bitset words, then
the canonical state when `jm.state_in_key` — probed at N_PROBES
consecutive slots from the key's hash: found iff some used probe holds
the key whole, inserted at the first unused probe, else the last. The
hash is wgl_tpu's: the incremental Zobrist bitset hash (from the FNV
basis), the FNV fold of the canonical state words when they are in the
key, an avalanche.

`search` is the kernel's wrapper: one launch over the lanes of a packed
tensor, one block (one warp) a lane. Each lane's tables sit where
`_smem_plan` puts them: ranked by the reads a search step makes of them
(TABLES), each goes into the lane's dynamic shared memory while the
block's budget lasts, and the rest into the lane's slice of one scratch
tensor in device memory, after which come
the memo's key rows (`_layout`; v1 and v2 are read from the packed
input in place when they are not in shared memory). The plan is a pure
function of (model, n_pad, n_state, cache_bits) and the device's
shared-memory limit, decided here before the launch and passed to it
whole (`_plan_words`); the launch checks its bounds and alignment.
`lanes_per_launch` keeps a launch's scratch under SCRATCH_BUDGET bytes,
and `analysis_batch` splits a batch into launches of that many lanes
(the lanes are independent, so the results are the same). On a CPU
tensor `search` runs `search_plain`, a lockstep PyTorch version of the
same search over all lanes. Both return, per lane, wgl_tpu's verdict,
steps and depth.

Over several devices (`analysis_batch(..., devices=[...])`, the port of
wgl_tpu.analysis_batch's mesh path): `deal` sorts the lanes longest-first
by entry count and deals them round-robin into one contiguous chunk per
device, padded to equal length with empty lanes (n_completed 0: VALID
before any step, no steps); every chunk is packed, copied to its device
and launched (split by `lanes_per_launch` there) before any result is
read back, and the rows map back to lanes through `row_to_lane`. A
device may repeat in the list: the deal, the launches and the gather are
the same, and every lane's search does not depend on its chunk, so the
results equal one device's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from ..device import KernelError, resolve
from ..history import Entries, entries as make_entries
from ..models import jit as mjit
from . import next_pow2
from .common import (DEFAULT_MAX_STEPS, INVALID, RUNNING,  # noqa: F401
                     STEPS_PER_SEC_ESTIMATE, UNKNOWN, VALID)
from .wgl_host import WGLResult, recover_invalid

DEFAULT_CACHE_BITS = 13  # K2's memo: 8192 slots per lane
N_PROBES = 8             # linear probes per memo lookup
MIN_PAD = 8              # the smallest bucket a lane pads to
MAX_CACHE_BITS = 20
FNV_BASIS = 2166136261   # the bitset hash before any entry
FNV_PRIME = 16777619
SCRATCH_BUDGET = 4 << 30  # device bytes of scratch one launch may take
PLAIN_CHUNK = 256        # graph replays of search_plain per check

MODEL_IDS = {"cas-register": 0, "register": 1, "mutex": 2,
             "unordered-queue": 3, "fifo-queue": 4}

#: kernel launches so far (one per `search` call on a CUDA tensor)
LAUNCHES = 0
#: when a list, every launch appends its (start, end) CUDA events
TIMED: list | None = None
#: when a list, every `search` call appends its arguments (packed,
#: msteps, jm, n_pad, n_state, cache_bits), so a caller can replay
#: exactly the searches a check ran
CAPTURE: list | None = None

_COLS = ("f", "v1", "v2", "crashed", "call_node", "ret_node")
_NODE_COLS = ("node_entry", "node_is_call", "nxt0", "prv0")


def pad_size(n: int) -> int:
    """Entries a batch whose longest lane has `n` pads to: a power of
    two, at least MIN_PAD."""
    return max(next_pow2(n), MIN_PAD)


def encode_entries(es, jm, n_pad: int) -> dict:
    """Pack one lane's Entries into fixed-shape arrays of `n_pad`
    entries and 2*n_pad+1 nodes. Padded entries never appear in the
    linked list. Payloads go through the kernel model's encoder."""
    n = len(es)
    assert n <= n_pad
    m = 2 * n_pad + 1
    f = np.zeros(n_pad, np.int32)
    v1 = np.full(n_pad, mjit.NIL32, np.int32)
    v2 = np.full(n_pad, mjit.NIL32, np.int32)
    if n > 0:
        f[:n], v1[:n], v2[:n] = jm.encode_lane(es)
    crashed = np.zeros(n_pad, bool)
    call_node = np.zeros(n_pad, np.int32)
    ret_node = np.zeros(n_pad, np.int32)
    node_entry = np.zeros(m, np.int32)
    node_is_call = np.zeros(m, bool)
    if n > 0:
        crashed[:n] = es.crashed
        cp = np.asarray(es.call_pos, np.int32) + 1
        rp = np.asarray(es.ret_pos, np.int32) + 1
        call_node[:n] = cp
        ret_node[:n] = rp
        # a fancy-index write with duplicate targets has no defined
        # order, so a collision would corrupt node_entry silently
        both = np.concatenate([cp, rp])
        assert len(np.unique(both)) == len(both), \
            "duplicate call/ret node positions in Entries"
        idx = np.arange(n, dtype=np.int32)
        node_entry[cp] = idx
        node_entry[rp] = idx
        node_is_call[cp] = True
    # the initial list: nodes 1..2n in order, the last pointing at 0
    nxt = np.zeros(m, np.int32)
    prv = np.zeros(m, np.int32)
    if n > 0:
        nxt[: 2 * n] = np.arange(1, 2 * n + 1, dtype=np.int32)
        nxt[2 * n] = 0
        prv[1: 2 * n + 1] = np.arange(0, 2 * n, dtype=np.int32)
    return {
        "f": f,
        "v1": v1,
        "v2": v2,
        "crashed": crashed,
        "call_node": call_node,
        "ret_node": ret_node,
        "node_entry": node_entry,
        "node_is_call": node_is_call,
        "nxt0": nxt,
        "prv0": prv,
        "n": np.int32(n),
        "n_completed": np.int32(es.n_completed),
    }


def _zobrist_table(n_pad: int) -> np.ndarray:
    """One splitmix-style uint32 per entry (deterministic). The search
    keeps the bitset's hash incrementally with it; the exact key compare,
    not this hash, is what makes the memo sound."""
    x = np.arange(1, n_pad + 1, dtype=np.uint64) * np.uint64(
        0x9E3779B97F4A7C15)
    x = (x ^ (x >> 30)) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * np.uint64(0x94D049BB133111EB)
    return ((x ^ (x >> 31)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _m_pad(n_pad: int) -> int:
    """Node rows (2*n_pad+1) padded to 8."""
    return ((2 * n_pad + 1 + 7) // 8) * 8


def _nw(n_pad: int) -> int:
    """Bitset words of a lane of n_pad entries."""
    return (n_pad + 31) // 32


def _rows(n_pad: int) -> int:
    return 6 * n_pad + 4 * _m_pad(n_pad) + 1


def _pack(entries_list, jm, n_pad: int) -> np.ndarray:
    """The lanes as one (lanes, rows) int32 array, lane-major (layout in
    the module docstring)."""
    m_pad = _m_pad(n_pad)
    out = np.zeros((len(entries_list), _rows(n_pad)), np.int32)
    for i, es in enumerate(entries_list):
        enc = encode_entries(es, jm, n_pad)
        pos = 0
        for key in _COLS:
            out[i, pos:pos + n_pad] = enc[key]
            pos += n_pad
        for key in _NODE_COLS:
            a = enc[key]
            out[i, pos:pos + len(a)] = a
            pos += m_pad
        out[i, pos] = enc["n_completed"]
    return out


def eligible(jm) -> bool:
    """The search takes every model with a kernel encoding."""
    return jm is not None and jm.name in MODEL_IDS


def batch_eligible(jm, entries_list) -> bool:
    """Routing probe for a concrete batch: the model has a kernel
    encoding and every lane's payloads encode (int32 values for the
    scalar models, hashable ones for the queues)."""
    return (bool(entries_list) and eligible(jm)
            and all(jm.lane_eligible(es) for es in entries_list))


def state_width(jm, entries_list) -> int:
    """n_state of a batch: its widest lane's `jm.lane_width`, 1 or a
    power of two (wgl_tpu.analysis_batch's bucket)."""
    n = max(jm.lane_width(es) for es in entries_list)
    return 1 if n <= 1 else next_pow2(n)


def key_words(jm, n_pad: int, n_state: int) -> int:
    """Words of one memo key: the bitset, then the canonical state when
    the model keys on it."""
    return _nw(n_pad) + (n_state if jm.state_in_key else 0)


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _round16(x: int) -> int:
    return (x + 15) & ~15


SMEM_MAX = 232448        # shared bytes a block may opt into on an H100:
#                          the plan's limit off the card

#: one lane's tables, ranked by the reads a search step makes of them (as
#: wgl_search.cu's `Table`): the bitset (every key built or compared, and
#: always in shared memory), the memo fingerprints (8 a lift), the queue
#: state (the fifo's fold reads its whole live window), the node map and
#: nxt (every step), the entries' facts and v1 (every call), prv (every
#: lift and pop), v2 (a matching CAS), the undo stack's call nodes and
#: its states (a pop's refill of the top, which the kernel keeps in
#: registers)
TABLES = ("lin", "fp", "state", "nmap", "nxt", "fact", "v1", "prv", "v2",
          "stack", "stack_s")


def _widths(n_pad: int) -> tuple:
    """Bytes of a node map word (entry << 1 | is_call) and of a node id:
    2 while they fit 16 bits, else 4. The kernel is instantiated for the
    pair the launch passes."""
    return (2 if n_pad <= 32768 else 4, 2 if _m_pad(n_pad) <= 65536 else 4)


def _table_bytes(jm, n_pad: int, n_state: int, cache_bits: int) -> dict:
    """Bytes of each of a lane's tables (0: the model has none), each a
    multiple of 16: the bitset as uint32 words, one uint16 fingerprint a
    memo slot, the queue state as int32, the node map (entry << 1 |
    is_call) uint16 up to n_pad 32768, nxt, prv and the stack's call
    nodes uint16 while node ids fit (m_pad <= 65536), else uint32; facts
    (f | crashed << 2 | ret node << 3), v1, v2 (cas-register) and the
    stack's states (the scalar models) int32 a row."""
    m_pad = _m_pad(n_pad)
    ent, node = _widths(n_pad)
    scalar = not jm.has_unstep
    return {
        "lin": 4 * _round4(_nw(n_pad)),
        "fp": _round16(2 << cache_bits),
        "state": 0 if scalar else 4 * _round4(n_state),
        "nmap": _round16(ent * m_pad),
        "nxt": _round16(node * m_pad),
        "fact": _round16(4 * n_pad),
        "v1": _round16(4 * n_pad),
        "prv": _round16(node * m_pad),
        "v2": _round16(4 * n_pad) if jm.name == "cas-register" else 0,
        "stack": _round16(node * n_pad),
        "stack_s": _round16(4 * n_pad) if scalar else 0,
    }


class SmemPlan(NamedTuple):
    """A launch's shared memory: `bytes` of tables a block (one lane);
    `smem` names the tables in shared memory (in rank order) and `mask`
    has bit k set for TABLES[k] among them."""
    bytes: int
    smem: tuple
    mask: int


def _smem_plan(jm, n_pad: int, n_state: int, cache_bits: int,
               smem_max: int = SMEM_MAX) -> SmemPlan:
    """The shared-memory plan of a launch: TABLES in rank order, each
    placed in the lane's shared memory when it still fits `smem_max`
    bytes (else it stays in device memory, and the next one is tried).
    Raises ValueError when not even the bitset fits."""
    sizes = _table_bytes(jm, n_pad, n_state, cache_bits)
    if sizes["lin"] > smem_max:
        raise ValueError(
            f"wgl_search: n_pad {n_pad} needs {sizes['lin']} bytes of "
            f"shared memory for its bitset, over {smem_max}")
    used, placed, mask = 0, [], 0
    for k, name in enumerate(TABLES):
        b = sizes[name]
        if b and used + b <= smem_max:
            used += b
            placed.append(name)
            mask |= 1 << k
    return SmemPlan(used, tuple(placed), mask)


class Layout(NamedTuple):
    """Where one lane's tables live: `smem` maps each table in shared
    memory to its byte offset in the lane's shared block, `scratch` each
    table left in device memory to its byte offset in the lane's scratch
    (v1 and v2 are read in place from the packed input instead, so they
    are in neither), `keys` the byte offset of the memo key rows
    (2^cache_bits rows of `key_words`), `words` the lane's scratch in
    int32 words."""
    smem: dict
    scratch: dict
    keys: int
    words: int


def _layout(jm, n_pad: int, n_state: int, cache_bits: int,
            smem_max: int = SMEM_MAX) -> Layout:
    sizes = _table_bytes(jm, n_pad, n_state, cache_bits)
    plan = _smem_plan(jm, n_pad, n_state, cache_bits, smem_max)
    smem, scratch, s_off, g_off = {}, {}, 0, 0
    for name in TABLES:
        b = sizes[name]
        if not b:
            continue
        if name in plan.smem:
            smem[name] = s_off
            s_off += b
        elif name not in ("v1", "v2"):
            scratch[name] = g_off
            g_off += b
    keys = 4 * (1 << cache_bits) * key_words(jm, n_pad, n_state)
    return Layout(smem, scratch, g_off, _round4((g_off + keys) // 4))


def lanes_per_launch(jm, n_pad: int, n_state: int, cache_bits: int,
                     smem_max: int = SMEM_MAX) -> int:
    """Lanes one launch takes under SCRATCH_BUDGET bytes of scratch;
    raises ValueError when one lane alone needs more."""
    budget = SCRATCH_BUDGET
    lane = 4 * _layout(jm, n_pad, n_state, cache_bits, smem_max).words
    if lane > budget:
        raise ValueError(
            f"wgl_search: one lane at n_pad {n_pad}, n_state {n_state}, "
            f"cache_bits {cache_bits} needs {lane} bytes of scratch, over "
            f"the {budget}-byte budget")
    return budget // lane


def _smem_max(dev) -> int:
    """The shared bytes a block may opt into on `dev` (SMEM_MAX off the
    card)."""
    if dev.type != "cuda":
        return SMEM_MAX
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def launch_plan(packed: torch.Tensor, jm, n_pad: int, n_state: int,
                cache_bits: int) -> SmemPlan:
    """The plan `search` launches `packed` (on a CUDA device) with: the
    one for the device's own shared-memory limit."""
    return _smem_plan(jm, n_pad, n_state, cache_bits,
                      _smem_max(packed.device))


def _check_inputs(packed, msteps, jm, n_pad: int, n_state: int,
                  cache_bits: int) -> None:
    if packed.dtype != torch.int32 or msteps.dtype != torch.int32:
        raise TypeError("packed and msteps must be int32")
    if packed.dim() != 2 or msteps.dim() != 1:
        raise ValueError("packed is (lanes, rows), msteps is (lanes,)")
    lanes, rows = packed.shape
    if rows != _rows(n_pad):
        raise ValueError(f"packed has {rows} rows; n_pad={n_pad} needs "
                         f"{_rows(n_pad)}")
    if msteps.shape[0] != lanes:
        raise ValueError(f"{msteps.shape[0]} step budgets for {lanes} lanes")
    if packed.device != msteps.device:
        raise ValueError("packed and msteps on different devices")
    if not (packed.is_contiguous() and msteps.is_contiguous()):
        raise ValueError("packed and msteps must be contiguous")
    if not eligible(jm):
        raise ValueError(f"wgl_search ineligible: model {jm!r}")
    if n_pad < 1:
        raise ValueError(f"n_pad {n_pad} < 1")
    if n_state < (3 if jm.name == "fifo-queue" else 1) or (
            not jm.has_unstep and n_state != 1):
        raise ValueError(f"n_state {n_state} does not fit {jm.name}")
    if not N_PROBES <= 1 << cache_bits <= 1 << MAX_CACHE_BITS:
        raise ValueError(f"cache_bits {cache_bits} out of range")


_SIG = {"wgl_search_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p],
    ctypes.c_int)}


def _plan_words(n_pad: int, plan: SmemPlan, lay: Layout):
    """The plan as the kernel's launch takes it (wgl_search.cu's `Plan`
    words), one int64 each: the shared-memory mask; the byte offset of
    each of TABLES (in the lane's shared block where the mask has its
    bit, else in the lane's scratch; -1 for a table the model lacks or
    v1/v2 read in place); shared bytes a lane; the key rows' offset in
    the scratch; the lane's scratch words; the node map's and node ids'
    bytes (`_widths`). The launch checks their bounds and alignment."""
    offs = [lay.smem.get(t, lay.scratch.get(t, -1)) for t in TABLES]
    words = [plan.mask, *offs, plan.bytes, lay.keys, lay.words,
             *_widths(n_pad)]
    return (ctypes.c_longlong * len(words))(*words)


def build(device=None):
    """The kernel's library for `device` (None = the current CUDA
    device), built from csrc/wgl_search.cu at first use; raises
    _build.BuildError with nvcc's stderr when the build fails."""
    from . import _build

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the wgl_search kernel builds for a CUDA device")
    return _build.load("wgl_search", torch.cuda.get_device_capability(dev),
                       _SIG)


def _ztab(n_pad: int, dev) -> torch.Tensor:
    """The Zobrist table as int32 (the uint32 bits) on `dev`."""
    return torch.from_numpy(_zobrist_table(n_pad).view(np.int32)).to(dev)


def _init_state(jm) -> int:
    return int(jm.init_state) if not jm.has_unstep else 0


def _launch(lib, packed, msteps, small, scratch, jm, n_pad: int,
            n_state: int, cache_bits: int, plan: SmemPlan, lay: Layout,
            stream=None) -> int:
    """`lib.wgl_search_launch` over the lanes of `packed` into `small`,
    with `scratch` of `lay.words` int32 a lane and `plan`; its return
    code (0, or the CUDA error)."""
    return lib.wgl_search_launch(
        packed.data_ptr(), msteps.data_ptr(), small.data_ptr(),
        scratch.data_ptr(), packed.shape[0], n_pad, _m_pad(n_pad),
        packed.shape[1], MODEL_IDS[jm.name], n_state, cache_bits, _nw(n_pad),
        _init_state(jm), _plan_words(n_pad, plan, lay), stream)


def search(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
           n_state: int, cache_bits: int = DEFAULT_CACHE_BITS
           ) -> torch.Tensor:
    """One WGL search launch over the lanes of `packed` ((lanes, rows)
    int32, the `_pack` layout) with per-lane step budgets `msteps`
    ((lanes,) int32) and model state of `n_state` words. Returns (3,
    lanes) int32 on packed's device: verdict, steps, depth.

    CUDA tensors launch the kernel (built at first use) on the current
    stream, one block (one warp) a lane, its shared memory as
    `launch_plan` plans it, with a scratch tensor of `_layout` words a
    lane; this raises ValueError when that
    is over SCRATCH_BUDGET bytes (`analysis_batch` splits a batch by
    `lanes_per_launch`), and KernelError when the launch fails (a plan
    over the device's shared memory included). CPU tensors run
    `search_plain`."""
    global LAUNCHES
    _check_inputs(packed, msteps, jm, n_pad, n_state, cache_bits)
    if CAPTURE is not None:
        CAPTURE.append((packed, msteps, jm, n_pad, n_state, cache_bits))
    if packed.device.type == "cpu":
        return search_plain(packed, msteps, jm, n_pad, n_state, cache_bits)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    n = packed.shape[0]
    dev = packed.device
    smem_max = _smem_max(dev)
    if n > lanes_per_launch(jm, n_pad, n_state, cache_bits, smem_max):
        raise ValueError(f"wgl_search: {n} lanes are over one launch's "
                         f"scratch budget ({SCRATCH_BUDGET} bytes)")
    plan = launch_plan(packed, jm, n_pad, n_state, cache_bits)
    lay = _layout(jm, n_pad, n_state, cache_bits, smem_max)
    with torch.cuda.device(dev):
        lib = build(dev)
        small = torch.empty((3, n), dtype=torch.int32, device=dev)
        # scratch is freed when this returns, while the kernel may still
        # run: the caching allocator hands its memory only to work queued
        # after the kernel on this same stream. The kernel fills every
        # table before it reads it (the key rows excepted: a row is read
        # only behind a matching fingerprint), so it starts uninitialised.
        scratch = torch.empty((max(1, n) * lay.words,), dtype=torch.int32,
                              device=dev)
        stream = torch.cuda.current_stream(dev)
        if TIMED is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        rc = _launch(lib, packed, msteps, small, scratch, jm, n_pad,
                     n_state, cache_bits, plan, lay, stream.cuda_stream)
        if rc != 0:
            raise KernelError(
                f"wgl_search kernel launch failed: cudaError {rc}")
        if TIMED is not None:
            ev[1].record(stream)
            TIMED.append(ev)
    LAUNCHES += 1
    return small


_M32 = 0xFFFFFFFF


def _avalanche(x: torch.Tensor) -> torch.Tensor:
    """wgl_tpu's final mix of a hash (int64 holding a uint32); the
    multiplier is taken minus 2^32 so that the int64 product cannot
    overflow."""
    x = ((x ^ (x >> 15)) * (0x85EBCA6B - 2**32)) & _M32
    return x ^ (x >> 13)


def _step_batch(jm, state, f, v1, v2):
    """jm's transition for every lane at once: state (L, n_state) int32,
    the op fields (L,) -> (state', ok)."""
    if not jm.has_unstep:  # the scalar models, n_state 1
        s, ok = jm.step(state[:, 0], f, v1, v2)
        return s.to(torch.int32)[:, None], ok
    S = state.shape[1]
    if jm.name == "unordered-queue":
        slot = v1.clamp(0, S - 1).long()[:, None]
        cur = state.gather(1, slot)[:, 0]
        enq, deq = f == 0, f == 1
        ok = enq | (deq & (cur > 0))
        delta = (ok & enq).to(torch.int32) - (ok & deq).to(torch.int32)
        return state.scatter_add(1, slot, delta[:, None]), ok
    w = S - 2  # fifo: the ring, then head and tail
    head, tail = state[:, w], state[:, w + 1]
    front = state.gather(1, head.clamp(0, w - 1).long()[:, None])[:, 0]
    enq_ok = (f == 0) & (tail < w)
    deq_ok = (f == 1) & (head < tail) & (front == v1)
    slot = tail.clamp(0, w - 1).long()[:, None]
    out = state.scatter(1, slot, torch.where(
        enq_ok, v1, state.gather(1, slot)[:, 0])[:, None])
    out[:, w] = head + deq_ok.to(torch.int32)
    out[:, w + 1] = tail + enq_ok.to(torch.int32)
    return out, enq_ok | deq_ok


def _unstep_batch(jm, state, f, v1):
    """The exact inverse of an applied queue transition, every lane."""
    S = state.shape[1]
    if jm.name == "unordered-queue":
        slot = v1.clamp(0, S - 1).long()[:, None]
        delta = torch.where(f == 0, -1, 1).to(torch.int32)
        return state.scatter_add(1, slot, delta[:, None])
    w = S - 2
    out = state.clone()
    out[:, w] = state[:, w] - (f == 1).to(torch.int32)
    out[:, w + 1] = state[:, w + 1] - (f == 0).to(torch.int32)
    return out


def _canon_batch(jm, state):
    """The state as it enters the memo key: the fifo queue's live window
    shifted to offset 0, dead slots zeroed, cursors (count, 0); the
    scalar state as it is."""
    if jm.name != "fifo-queue":
        return state
    w = state.shape[1] - 2
    head, tail = state[:, w], state[:, w + 1]
    count = tail - head
    i = torch.arange(w, device=state.device)[None, :]
    idx = ((i + head[:, None]) % w).long()
    buf = torch.where(i < count[:, None], state[:, :w].gather(1, idx), 0)
    return torch.cat([buf.to(torch.int32), count[:, None],
                      torch.zeros_like(count)[:, None]], 1)


def search_plain(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
                 n_state: int, cache_bits: int = DEFAULT_CACHE_BITS
                 ) -> torch.Tensor:
    """The plain PyTorch version of the kernel: wgl_tpu's step over
    every lane in lockstep, each data-dependent read a gather and each
    write a scatter, the N_PROBES memo rows compared whole, inactive
    lanes frozen, the state an (L, n_state) tensor stepped by the model's
    transition (`_step_batch`) and, for the queues, undone by its inverse.
    Same outputs as `search`, on packed's device.

    On a CUDA tensor one step is captured into a CUDA graph and
    replayed in chunks of PLAIN_CHUNK steps (a step after every lane has
    finished changes nothing); on the CPU it loops with a check per
    step. Tables stay int32 (the memo is lanes x 2^cache_bits x key
    words); only the hash runs in int64."""
    _check_inputs(packed, msteps, jm, n_pad, n_state, cache_bits)
    dev = packed.device
    i32, i64 = torch.int32, torch.int64
    L = packed.shape[0]
    m_pad = _m_pad(n_pad)
    nw = _nw(n_pad)
    kw = key_words(jm, n_pad, n_state)
    in_key = jm.state_in_key
    c = 1 << cache_bits

    cols = {}
    pos = 0
    for key in _COLS:
        cols[key] = packed[:, pos:pos + n_pad]
        pos += n_pad
    for key in _NODE_COLS:
        cols[key] = packed[:, pos:pos + m_pad]
        pos += m_pad
    ncomp = packed[:, pos]
    ztab = _ztab(n_pad, dev).to(i64) & _M32
    msteps = msteps.to(i32)

    w_cols = torch.arange(nw, device=dev, dtype=i32)[None, :]
    probes = torch.arange(N_PROBES, device=dev, dtype=i64)[None, :]
    nxt = cols["nxt0"].clone()
    prv = cols["prv0"].clone()
    stack_e = torch.zeros((L, n_pad), dtype=i32, device=dev)
    stack_s = None if jm.has_unstep else torch.zeros(
        (L, n_pad), dtype=i32, device=dev)
    memo = torch.zeros((L, c, kw), dtype=i32, device=dev)
    used = torch.zeros((L, c), dtype=torch.bool, device=dev)
    lin = torch.zeros((L, nw), dtype=i32, device=dev)

    # per-lane registers, updated in place by `step` (a CUDA graph
    # replays against fixed addresses)
    node = cols["nxt0"][:, 0].clone()
    state = torch.zeros((L, n_state), dtype=i32, device=dev)
    state[:, 0] = _init_state(jm)
    h = torch.full((L,), FNV_BASIS, dtype=i64, device=dev)
    depth = torch.zeros(L, dtype=i32, device=dev)
    completed = torch.zeros(L, dtype=i32, device=dev)
    steps = torch.zeros(L, dtype=i32, device=dev)
    verdict = torch.where(ncomp == 0, VALID, RUNNING).to(i32)
    active = (verdict == RUNNING) & (steps < msteps)

    def at(table, idx):
        """table[l, idx[l]] per lane (idx in range)."""
        return table.gather(1, idx.to(i64)[:, None])[:, 0]

    def put(table, idx, val, mask):
        """table[l, idx[l]] = val[l] where mask[l] (idx in range)."""
        i = idx.to(i64)[:, None]
        old = table.gather(1, i)[:, 0]
        table.scatter_(1, i, torch.where(mask, val.to(table.dtype),
                                         old)[:, None])

    def bit_of(e):
        """Entry e's bit as a row of bitset words (bit 31 is INT32_MIN)."""
        b = torch.ones_like(e, dtype=i64) << (e & 31).to(i64)
        b = ((b ^ 2**31) - 2**31).to(i32)
        return torch.where(w_cols == (e >> 5)[:, None], b[:, None], 0)

    def step():
        act = active.clone()
        e = at(cols["node_entry"], node)
        is_call = (node != 0) & (at(cols["node_is_call"], node) != 0)
        new_state, ok = _step_batch(jm, state, at(cols["f"], e),
                                    at(cols["v1"], e), at(cols["v2"], e))
        can_lin = act & is_call & ok

        new_lin = lin | bit_of(e)
        new_h = h ^ ztab[e.to(i64)]
        hh = new_h
        if in_key:
            canon = _canon_batch(jm, new_state)
            key = torch.cat([new_lin, canon], 1)
            words = canon.to(i64) & _M32
            for i in range(n_state):  # the FNV fold, word by word
                hh = ((hh ^ words[:, i]) * FNV_PRIME) & _M32
        else:
            key = new_lin
        hh = _avalanche(hh)

        # the probe: every one of the N_PROBES slots is compared
        slots = (hh[:, None] + probes) & (c - 1)
        used_p = used.gather(1, slots)
        rows_p = memo.gather(1, slots[:, :, None].expand(L, N_PROBES, kw))
        found = (used_p & (rows_p == key[:, None, :]).all(2)).any(1)
        free = ~used_p
        first_free = free.to(i32).argmax(1)
        ins = torch.where(free.any(1), slots.gather(
            1, first_free.to(i64)[:, None])[:, 0], slots[:, -1])

        do_lift = can_lin & ~found
        advance = act & is_call & ~do_lift
        backtrack = act & ~is_call
        can_pop = depth > 0
        do_back = backtrack & can_pop
        lift_completed = completed + 1 - at(cols["crashed"], e)

        dm1 = (depth - 1).clamp(min=0)
        e2 = at(stack_e, dm1)
        cn2 = at(cols["call_node"], e2)
        rn2 = at(cols["ret_node"], e2)
        if jm.has_unstep:
            pop_state = _unstep_batch(jm, state, at(cols["f"], e2),
                                      at(cols["v1"], e2))
        else:
            pop_state = at(stack_s, dm1)[:, None]

        # linked list: write A (call node out / return node back in),
        # then write B reading the list as A left it
        moved = do_lift | do_back
        cn = at(cols["call_node"], e)
        rn = at(cols["ret_node"], e)
        src = torch.where(do_lift, cn, torch.where(do_back, rn2, 0))
        pa, qa = at(prv, src), at(nxt, src)
        put(nxt, pa, torch.where(do_back, rn2, qa), moved)
        put(prv, qa, torch.where(do_back, rn2, pa), moved)
        tgt = torch.where(do_lift, rn, torch.where(do_back, cn2, 0))
        pb, qb = at(prv, tgt), at(nxt, tgt)
        put(nxt, pb, torch.where(do_back, cn2, qb), moved)
        put(prv, qb, torch.where(do_back, cn2, pb), moved)

        # memo insert and push, on a lift only
        ins_idx = ins[:, None, None].expand(L, 1, kw)
        memo.scatter_(1, ins_idx, torch.where(
            do_lift[:, None, None], key[:, None, :], memo.gather(1, ins_idx)))
        put(used, ins, torch.ones_like(do_lift), do_lift)
        dpush = depth.clamp(max=n_pad - 1)
        put(stack_e, dpush, e, do_lift)
        if stack_s is not None:
            put(stack_s, dpush, state[:, 0], do_lift)

        pop_lin = lin & ~bit_of(e2)
        lin.copy_(torch.where(do_lift[:, None], new_lin,
                              torch.where(do_back[:, None], pop_lin, lin)))
        state.copy_(torch.where(do_lift[:, None], new_state,
                                torch.where(do_back[:, None], pop_state,
                                            state)))
        h.copy_(torch.where(do_lift, new_h, torch.where(
            do_back, h ^ ztab[e2.to(i64)], h)))
        completed.copy_(torch.where(
            do_lift, lift_completed,
            torch.where(do_back, completed - 1 + at(cols["crashed"], e2),
                        completed)))
        verdict.copy_(torch.where(
            do_lift & (lift_completed == ncomp), VALID,
            torch.where(backtrack & ~can_pop, INVALID, verdict)))
        depth.copy_(torch.where(do_lift, depth + 1,
                                torch.where(do_back, depth - 1, depth)))
        # the next node reads the list as this step left it
        nsrc = torch.where(do_lift, 0, torch.where(do_back, cn2, node))
        node.copy_(torch.where(moved | advance, at(nxt, nsrc), node))
        steps.add_(act.to(i32))
        active.copy_((verdict == RUNNING) & (steps < msteps))

    if dev.type == "cuda" and bool(active.any()):
        # warm up on a side stream (real steps), then capture one step
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        while bool(active.any()):
            for _ in range(PLAIN_CHUNK):
                graph.replay()
    else:
        while bool(active.any()):
            step()

    final = torch.where(verdict == RUNNING, UNKNOWN, verdict)
    return torch.stack([final, steps, depth]).to(i32)


def _results(model, entries_list, small) -> list:
    """One WGLResult a lane from the (3, lanes) verdict/steps rows; an
    invalid lane's counterexample comes from the host search."""
    out = []
    for es, v, s in zip(entries_list, small[0], small[1]):
        if v == VALID:
            out.append(WGLResult(valid=True, steps=int(s)))
        elif v == INVALID:
            out.append(recover_invalid(model, es))
        else:
            out.append(WGLResult(valid="unknown", steps=int(s)))
    return out


def deal(lengths, n_dev: int) -> tuple:
    """wgl_tpu.analysis_batch's deal (`:687-703`): lanes sorted
    longest-first by `lengths` (stable for equal lengths) and dealt
    round-robin into `n_dev` chunks. Returns (chunks, row_to_lane):
    each chunk's lane indices, and for every row of the chunks laid end
    to end, each padded to the longest with empty rows, the lane it
    holds or -1 for an empty lane."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    chunks: list = [[] for _ in range(n_dev)]
    for j, i in enumerate(order):
        chunks[j % n_dev].append(i)
    per = max(len(c) for c in chunks)
    row_to_lane = []
    for c in chunks:
        row_to_lane += c + [-1] * (per - len(c))
    return chunks, row_to_lane


def _launch_all(packed, msteps, jm, n_pad: int, n_state: int,
                cache_bits: int, dev) -> list:
    """`search` over the lanes of (numpy) `packed` on `dev`, in launches
    of `lanes_per_launch` lanes; the (3, lanes) results, still on the
    device and unread."""
    per = lanes_per_launch(jm, n_pad, n_state, cache_bits, _smem_max(dev))
    packed = torch.from_numpy(packed).to(dev)
    msteps = torch.from_numpy(msteps).to(dev)
    return [search(packed[a:a + per], msteps[a:a + per], jm, n_pad,
                   n_state, cache_bits)
            for a in range(0, packed.shape[0], per)]


def analysis_batch(model, entries_list, max_steps: int | None = None,
                   cache_bits: int = DEFAULT_CACHE_BITS,
                   device=None, devices=None) -> list:
    """Check a batch of independent histories (Ops or Entries), one lane
    each, in as few launches as the scratch budget allows
    (`lanes_per_launch`); returns one WGLResult per lane. Raises
    ValueError when the model has no kernel encoding or a lane's
    payloads do not encode — callers probe with `batch_eligible`.

    device None means CUDA (raising when absent); "cpu" runs the plain
    version. `devices` (a list for `device.devices`, not with `device`)
    deals the lanes over those devices (`deal`) when it names two or
    more and there are at least as many lanes; a one-device list is the
    single-device path on that device. A device that fails to launch
    raises: nothing falls back to fewer devices."""
    if device is not None and devices is not None:
        raise ValueError("give device or devices, not both")
    devs = device_mod.devices(devices) if devices is not None \
        else [resolve(device)]
    jm = mjit.for_model(model)
    if jm is None:
        raise ValueError(f"no kernel model for {model!r}")
    entries_list = [es if isinstance(es, Entries) else make_entries(es)
                    for es in entries_list]
    if not entries_list:
        return []
    if not batch_eligible(jm, entries_list):
        raise ValueError(f"wgl_search ineligible: a {jm.name} lane has no "
                         "kernel encoding")
    if max_steps is None:
        max_steps = DEFAULT_MAX_STEPS
    n = len(entries_list)
    n_pad = pad_size(max(len(es) for es in entries_list))
    n_state = state_width(jm, entries_list)
    packed = _pack(entries_list, jm, n_pad)
    msteps = np.full(n, max_steps, np.int32)
    if len(devs) < 2 or n < len(devs):
        small = torch.cat(_launch_all(packed, msteps, jm, n_pad, n_state,
                                      cache_bits, devs[0]), 1)
        return _results(model, entries_list, small.cpu().numpy())
    _, row_to_lane = deal([len(es) for es in entries_list], len(devs))
    rows = np.asarray(row_to_lane)
    real = rows >= 0
    # empty lanes: all-zero rows (n_completed 0) with a budget of 0, as
    # wgl_tpu's zero-filled padding entries
    dealt = np.zeros((len(rows), packed.shape[1]), np.int32)
    dealt[real] = packed[rows[real]]
    dealt_steps = np.zeros(len(rows), np.int32)
    dealt_steps[real] = max_steps
    per = len(rows) // len(devs)
    # every chunk launched before any result is read back
    parts = [_launch_all(dealt[d * per:(d + 1) * per],
                         dealt_steps[d * per:(d + 1) * per], jm, n_pad,
                         n_state, cache_bits, dev)
             for d, dev in enumerate(devs)]
    small_rows = np.concatenate(
        [s.cpu().numpy() for part in parts for s in part], 1)
    small = np.empty((small_rows.shape[0], n), np.int32)
    small[:, rows[real]] = small_rows[:, real]
    return _results(model, entries_list, small)


def analysis(model, history, time_limit: float | None = None,
             max_steps: int = DEFAULT_MAX_STEPS,
             cache_bits: int = DEFAULT_CACHE_BITS, device=None) -> WGLResult:
    """One history through the search (wgl_tpu.analysis): a time_limit
    becomes a step budget at STEPS_PER_SEC_ESTIMATE."""
    resolve(device)
    es = history if isinstance(history, Entries) else make_entries(history)
    if es.n_completed == 0:
        return WGLResult(valid=True)
    if time_limit is not None:
        max_steps = min(max_steps,
                        max(1000, int(time_limit * STEPS_PER_SEC_ESTIMATE)))
    (r,) = analysis_batch(model, [es], max_steps=max_steps,
                          cache_bits=cache_bits, device=device)
    return r


def probe_mesh(devices=None) -> bool:
    """One uneven batch dealt over `devices` (None: every CUDA device;
    wgl_tpu.probe_mesh): 2*D + 1 CAS-register lanes of 1 to 3 writes,
    so the chunks are padded with empty lanes; every lane must be
    valid."""
    from ..history import Op
    from ..models import CASRegister

    devs = device_mod.devices(devices)
    ess = []
    for lane in range(2 * len(devs) + 1):
        h = []
        for i in range(1 + lane % 3):
            h.append(Op(0, "invoke", "write", i, time=2 * i, index=2 * i))
            h.append(Op(0, "ok", "write", i, time=2 * i + 1,
                        index=2 * i + 1))
        ess.append(make_entries(h))
    rs = analysis_batch(CASRegister(None), ess, max_steps=10_000,
                        devices=devs)
    return all(r.valid is True for r in rs)
