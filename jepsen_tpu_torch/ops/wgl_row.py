"""The WGL search for long lanes, one CUDA warp per lane
(csrc/wgl_row.cu): the port of jepsen_tpu/ops/wgl_pallas.py (K5).

It takes the scalar models (cas-register, register, mutex) on lanes of
up to MAX_PAD = 4064 entries, where `wgl_vec` stops at 1024. A batch
pads to one n_pad: the pow2 bucket of its longest lane (floor 8),
capped at MAX_PAD. Each lane's memo is 2^cache_bits rows, each the
exact key — the bitset words of the lane's entries, then the model
state — probed at N_PROBES consecutive slots from the key's hash, a
key found iff some used probe holds it whole, inserted at the first
unused probe (else the last). K5 keeps its keys in a 128-word row
(bitset words 0..126, the state in word 127); this port stores only
the live words, ceil(n_pad/32) + 1, which compares equal exactly when
the full rows do (the words past the lane's last entry are zero in
every row).

Lanes are packed lane-major into one int32 tensor (`_pack`): per lane
K5's input columns one after another,

    f, v1, v2, crashed, call_node, ret_node   (n_pad each)
    node_entry, node_is_call, nxt0, prv0      (m_pad each)
    n_completed                               (1)

with m_pad = roundup8(2*n_pad + 1). `search` is the kernel's wrapper:
on a CUDA tensor it launches the kernel (building it at first use) or
raises; on a CPU tensor it runs `search_plain`, a lockstep PyTorch
version of the same search over all lanes. Both return, per lane, the
verdict, steps and depth K5 returns.

Where the kernel keeps its tables: in shared memory, the Zobrist table
(one per block) and, per lane, the entries' facts, v1 and v2, the
linked list and node map (int16), the undo stack and one fingerprint
per memo slot (the key's hash, 0 when unused); in device memory only
the memo's key rows (`_scratch_rows` words a lane), read where a
fingerprint matches. `_smem_plan` gives the shared bytes and lanes
(warps) per block; a shape whose lane does not fit one block's
shared memory raises — nothing falls back.

`cache_bits` is an argument of both: at 11 the search is K5's, at 13
(`wgl_search.DEFAULT_CACHE_BITS`) it takes the step counts of the JAX
package's scalar K2 search (`jepsen_tpu/ops/wgl_tpu.py`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..device import KernelError, resolve
from ..history import Entries, entries as make_entries
from ..models import jit as mjit
from .wgl_host import WGLResult, recover_invalid
from .wgl_search import (DEFAULT_MAX_STEPS, INVALID, N_PROBES, RUNNING,
                         UNKNOWN, VALID, _zobrist_table, encode_entries,
                         pad_size as _bucket)

CACHE_BITS = 11              # K5's memo: 2048 rows per lane
ROW = 128                    # K5's key row: 127 bitset words + the state
MAX_PAD = (ROW - 1) * 32     # 4064 entries
MAX_CACHE_BITS = 16
SMEM_MAX = 232448            # shared bytes a block may opt into on an
#                              H100: the plan's limit off the card
MAX_LANES_PER_BLOCK = 8      # warps a block holds (as wgl_row.cu)
FNV_BASIS = 2166136261       # the bitset hash before any entry
PLAIN_CHUNK = 256            # graph replays of search_plain per check

MODEL_IDS = {"cas-register": 0, "register": 1, "mutex": 2}

#: kernel launches so far (one per `search` call on a CUDA tensor)
LAUNCHES = 0
#: when a list, every launch appends its (start, end) CUDA events
TIMED: list | None = None
#: when a list, every `search` call appends its arguments (packed,
#: msteps, jm, n_pad, cache_bits), so a caller can replay exactly the
#: searches a check ran
CAPTURE: list | None = None

_COLS = ("f", "v1", "v2", "crashed", "call_node", "ret_node")
_NODE_COLS = ("node_entry", "node_is_call", "nxt0", "prv0")


def _m_pad(n_pad: int) -> int:
    """Node rows (2*n_pad+1) padded to 8, as K5 pads them."""
    return ((2 * n_pad + 1 + 7) // 8) * 8


def _nw(n_pad: int) -> int:
    return (n_pad + 31) // 32


def key_words(n_pad: int) -> int:
    """Words of one memo key: the bitset words, then the state."""
    return _nw(n_pad) + 1


def _rows(n_pad: int) -> int:
    return 6 * n_pad + 4 * _m_pad(n_pad) + 1


def pad_size(n: int) -> int:
    """The n_pad of a batch whose longest lane has `n` entries: the
    wgl_search bucket, capped at MAX_PAD (histories between 2048 and the
    cap still fit)."""
    return min(_bucket(n), MAX_PAD)


def eligible(jm, n_pad: int) -> bool:
    """Scalar models whose bitset fits the row."""
    return (isinstance(jm, mjit.JitModel) and jm.state_in_key
            and n_pad <= MAX_PAD)


def batch_eligible(jm, entries_list) -> bool:
    """Routing probe for a concrete batch: the model, every lane at most
    MAX_PAD entries, every payload int32-encodable."""
    if not entries_list:
        return False
    longest = max(len(es) for es in entries_list)
    return (longest <= MAX_PAD and eligible(jm, pad_size(longest))
            and all(jm.lane_eligible(es) for es in entries_list))


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


def _scratch_rows(n_pad: int, cache_bits: int) -> int:
    """Words of one lane's device-memory scratch: its memo key rows
    (2^cache_bits x key_words), never zeroed. Everything else the
    kernel keeps lives in shared memory (`_smem_plan`)."""
    return (1 << cache_bits) * key_words(n_pad)


class SmemPlan(NamedTuple):
    """A launch's shared memory: `lanes` warps (one lane each) a block,
    `lane_bytes` of tables per lane, `bytes` in all per block."""
    lanes: int
    lane_bytes: int
    bytes: int


def _smem_plan(n_pad: int, cache_bits: int, lanes: int | None = None,
               smem_max: int = SMEM_MAX) -> SmemPlan:
    """The shared-memory layout wgl_row.cu uses: the Zobrist table (n_pad
    uint32) once per block, then per lane facts, v1, v2 and stack states
    (n_pad int32 each), one fingerprint per memo slot (uint32), the list
    nxt/prv and the node map (m_pad int16 each) and the stack entries
    (n_pad int16). As many lanes a block as fit `smem_max` bytes, at
    most MAX_LANES_PER_BLOCK and at most `lanes` (the launch's lane
    count, when given); raises ValueError when one lane does not fit."""
    lane = 4 * (4 * n_pad + (1 << cache_bits)) \
        + 2 * (3 * _m_pad(n_pad) + n_pad)
    per_block = min(MAX_LANES_PER_BLOCK, (smem_max - 4 * n_pad) // lane)
    if per_block < 1:
        raise ValueError(
            f"wgl_row: n_pad {n_pad} at cache_bits {cache_bits} needs "
            f"{4 * n_pad + lane} bytes of shared memory, over {smem_max}")
    if lanes is not None:
        per_block = min(per_block, max(1, lanes))
    return SmemPlan(per_block, lane, 4 * n_pad + per_block * lane)


def launch_plan(packed: torch.Tensor, n_pad: int,
                cache_bits: int) -> SmemPlan:
    """The plan `search` launches `packed` (on a CUDA device) with: at
    most its lane count a block, under the device's own shared-memory
    limit."""
    return _smem_plan(n_pad, cache_bits, packed.shape[0],
                      torch.cuda.get_device_properties(packed.device)
                      .shared_memory_per_block_optin)


def _check_inputs(packed, msteps, jm, n_pad: int, cache_bits: int) -> None:
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
    if not eligible(jm, n_pad):
        raise ValueError(f"wgl_row ineligible: model={jm.name} n_pad={n_pad}")
    if not N_PROBES <= 1 << cache_bits <= 1 << MAX_CACHE_BITS:
        raise ValueError(f"cache_bits {cache_bits} out of range")


_SIG = {"wgl_row_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    ctypes.c_int)}


def build(device=None):
    """The kernel's library for `device` (None = the current CUDA
    device), built from csrc/wgl_row.cu at first use; raises
    _build.BuildError with nvcc's stderr when the build fails."""
    from . import _build

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the wgl_row kernel builds for a CUDA device")
    return _build.load("wgl_row", torch.cuda.get_device_capability(dev),
                       _SIG)


def _ztab(n_pad: int, dev) -> torch.Tensor:
    """The Zobrist table as int32 (the uint32 bits) on `dev`."""
    return torch.from_numpy(_zobrist_table(n_pad).view(np.int32)).to(dev)


def search(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
           cache_bits: int = CACHE_BITS) -> torch.Tensor:
    """One WGL search launch over the lanes of `packed` ((lanes, rows)
    int32, the `_pack` layout) with per-lane step budgets `msteps`
    ((lanes,) int32). Returns (3, lanes) int32 on packed's device:
    verdict, steps, depth.

    CUDA tensors launch the kernel (built at first use) on the current
    stream, each lane's tables in shared memory as `launch_plan` lays
    them out and its memo key rows in device memory; this raises if the
    plan does not fit a block or the build or the launch fails. CPU
    tensors run `search_plain`."""
    global LAUNCHES
    _check_inputs(packed, msteps, jm, n_pad, cache_bits)
    if CAPTURE is not None:
        CAPTURE.append((packed, msteps, jm, n_pad, cache_bits))
    if packed.device.type == "cpu":
        return search_plain(packed, msteps, jm, n_pad, cache_bits)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    dev = packed.device
    plan = launch_plan(packed, n_pad, cache_bits)
    with torch.cuda.device(dev):
        lib = build(dev)
        lanes = packed.shape[0]
        small = torch.empty((3, lanes), dtype=torch.int32, device=dev)
        # ztab and keys are freed when this returns, while the kernel
        # may still run: the caching allocator hands their memory only
        # to work queued after the kernel on this same stream
        ztab = _ztab(n_pad, dev)
        keys = torch.empty((lanes, _scratch_rows(n_pad, cache_bits)),
                           dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev)
        if TIMED is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        rc = lib.wgl_row_launch(
            packed.data_ptr(), ztab.data_ptr(), msteps.data_ptr(),
            small.data_ptr(), keys.data_ptr(),
            lanes, n_pad, _m_pad(n_pad), packed.shape[1],
            MODEL_IDS[jm.name], cache_bits, _nw(n_pad), int(jm.init_state),
            plan.lanes, plan.bytes, stream.cuda_stream)
        if rc != 0:
            raise KernelError(f"wgl_row kernel launch failed: cudaError {rc}")
        if TIMED is not None:
            ev[1].record(stream)
            TIMED.append(ev)
    LAUNCHES += 1
    return small


_M32 = 0xFFFFFFFF


def _mix_hash(h: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """K5's bucket hash of the bitset hash `h` (int64 holding a uint32)
    and the int32 state: the FNV fold of the state, then an avalanche,
    all mod 2^32 with logical shifts. The second multiplier is taken
    minus 2^32 so that the int64 product cannot overflow."""
    x = ((h ^ (state.to(torch.int64) & _M32)) * 16777619) & _M32
    x = ((x ^ (x >> 15)) * (0x85EBCA6B - 2**32)) & _M32
    return x ^ (x >> 13)


def search_plain(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
                 cache_bits: int = CACHE_BITS) -> torch.Tensor:
    """The plain PyTorch version of the kernel: every lane steps in
    lockstep, each data-dependent read a gather and each write a
    scatter, the N_PROBES memo rows compared whole, inactive lanes
    frozen. Same outputs as `search`, on packed's device.

    On a CUDA tensor one step is captured into a CUDA graph and
    replayed in chunks of PLAIN_CHUNK steps (a step after every lane has
    finished changes nothing); on the CPU it loops with a check per
    step. Tables stay int32 (the memo is lanes x 2^cache_bits x key
    words); only the hash runs in int64."""
    _check_inputs(packed, msteps, jm, n_pad, cache_bits)
    dev = packed.device
    i32, i64 = torch.int32, torch.int64
    L = packed.shape[0]
    m_pad = _m_pad(n_pad)
    nw = _nw(n_pad)
    kw = nw + 1
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
    stack_s = torch.zeros((L, n_pad), dtype=i32, device=dev)
    memo = torch.zeros((L, c, kw), dtype=i32, device=dev)
    used = torch.zeros((L, c), dtype=torch.bool, device=dev)
    lin = torch.zeros((L, nw), dtype=i32, device=dev)

    # per-lane registers, updated in place by `step` (a CUDA graph
    # replays against fixed addresses)
    node = cols["nxt0"][:, 0].clone()
    state = torch.full((L,), int(jm.init_state), dtype=i32, device=dev)
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
        """Entry e's bit as a row of bitset words (bit 31 is INT32_MIN,
        as K5's int32 shift makes it)."""
        b = torch.ones_like(e, dtype=i64) << (e & 31).to(i64)
        b = ((b ^ 2**31) - 2**31).to(i32)
        return torch.where(w_cols == (e >> 5)[:, None], b[:, None], 0)

    def step():
        act = active.clone()
        e = at(cols["node_entry"], node)
        is_call = (node != 0) & (at(cols["node_is_call"], node) != 0)
        new_state, ok = jm.step(state, at(cols["f"], e), at(cols["v1"], e),
                                at(cols["v2"], e))
        new_state = new_state.to(i32)
        can_lin = act & is_call & ok

        new_lin = lin | bit_of(e)
        new_h = h ^ ztab[e.to(i64)]
        key = torch.cat([new_lin, new_state[:, None]], 1)

        # the probe: every one of the N_PROBES slots is compared
        slots = (_mix_hash(new_h, new_state)[:, None] + probes) & (c - 1)
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
        put(stack_s, dpush, state, do_lift)

        pop_state = at(stack_s, dm1)
        pop_lin = lin & ~bit_of(e2)
        lin.copy_(torch.where(do_lift[:, None], new_lin,
                              torch.where(do_back[:, None], pop_lin, lin)))
        state.copy_(torch.where(do_lift, new_state,
                                torch.where(do_back, pop_state, state)))
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


def analysis_batch(model, entries_list, max_steps: int | None = None,
                   device=None) -> list:
    """Check a batch of independent histories (Ops or Entries), one lane
    each, in one launch; returns one WGLResult per lane. Raises
    ValueError on ineligible models and sizes — callers probe with
    `batch_eligible` first. An invalid lane's counterexample comes from
    `wgl_host.recover_invalid`.

    device None means CUDA (raising when absent); "cpu" runs the plain
    version."""
    dev = resolve(device)
    jm = mjit.for_model(model)
    if jm is None:
        raise ValueError(f"no kernel model for {model!r}")
    entries_list = [es if isinstance(es, Entries) else make_entries(es)
                    for es in entries_list]
    if not entries_list:
        return []
    if max_steps is None:
        max_steps = DEFAULT_MAX_STEPS
    longest = max(len(es) for es in entries_list)
    n_pad = pad_size(longest)
    if not eligible(jm, n_pad) or longest > n_pad:
        raise ValueError(
            f"wgl_row path ineligible: model={jm.name} n_pad={n_pad}")
    for es in entries_list:
        if not jm.lane_eligible(es):
            raise ValueError("lane has no int32 encoding")

    packed = torch.from_numpy(_pack(entries_list, jm, n_pad)).to(dev)
    msteps = torch.full((len(entries_list),), max_steps, dtype=torch.int32,
                        device=dev)
    small = search(packed, msteps, jm, n_pad).cpu().numpy()
    results = []
    for es, v, s in zip(entries_list, small[0], small[1]):
        if v == VALID:
            results.append(WGLResult(valid=True, steps=int(s)))
        elif v == INVALID:
            results.append(recover_invalid(model, es))
        else:
            results.append(WGLResult(valid="unknown", steps=int(s)))
    return results
