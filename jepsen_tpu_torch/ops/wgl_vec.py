"""The WGL search over a batch of independent lanes: one CUDA thread per
lane (csrc/wgl_vec.cu), the port of jepsen_tpu/ops/wgl_pallas_vec.py.

Every lane is one per-key history. The batch is encoded once into flat
per-entry arrays (`_encode_flats`) and laid out column-wise into ONE
bit-packed int32 buffer (`_layout`, the same row format as the JAX
package's, so a buffer from either package feeds either kernel):

    [0:n)   meta: (f+1) | crashed<<3 | call_node<<4 | ret_node<<16
    [n:2n)  (v1_16 & 0xFFFF) | v2_16<<16 when every value fits int16
            (NIL32 as NIL16); otherwise [n:2n) v1 and [2n:3n) v2
    [-1]    n | n_completed<<16

with n = n_pad. A launch is one host-to-device copy of that buffer, one
kernel, and one device-to-host copy of the 5-row result block (verdict,
steps, depth, best depth, stuck entry) plus the best stack.

Where the kernel keeps its tables: a block is one warp holding L <= 32
lanes, and each lane's search state lives in the block's shared memory
— the entries' meta and values decoded from the packed buffer, the
linked list and node map (int16), the undo stack, the bitset, the queue
state, the memo's keys with one fingerprint per slot (a slot's key is
compared only where its fingerprint matches) and the best stack, which
goes to device memory once at the end. Device memory holds only the
inputs and the outputs. `_smem_plan` lays a lane out and `launch_plan`
picks L before the launch (L only as large as it takes to fill the
card: lanes that share a warp and branch apart step one after another);
a shape whose lane does not fit one block's shared memory raises —
nothing falls back.

`search` is the kernel's wrapper: on a CUDA tensor it launches the
kernel (building it at first use) or raises; on a CPU tensor it runs
`search_plain`, a lockstep PyTorch transcription of the same search
over all lanes. Both compute exactly what the TPU kernel computes —
the same step counts, because the memo geometry, hash, relinking and
undo rules are the same.

`analysis_batch` keeps the JAX engine's two-pass rule: when the budget
dwarfs PASS1_CAP and there is more than one 128-lane block, every lane
first runs under PASS1_CAP steps and only the survivors re-run (from
scratch) with the full budget; their reported steps add both passes.

Over several devices (`analysis_batch(..., devices=[...])`, the port of
the JAX package's "blocks" mesh, `wgl_pallas_vec._launcher`'s shard_map
branch): each pass lays its lanes out once, pads the blocks with empty
lanes (all-zero columns: n = n_completed = 0, VALID before any step) to
a multiple of the device count, and gives each device one contiguous
column shard of n_blocks / D blocks — its own host-to-device copy and
its own `search` launch, all launched before any result is read back.
The result rows come back in shard order; a shard's best stacks are
fetched only when one of its lanes refuted. The survivors of pass 1 are
laid out and dealt again for pass 2. A device may repeat in the list.
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
from . import pad_size as _pad_size
from .common import (DEFAULT_MAX_STEPS, INVALID, RUNNING, UNKNOWN, VALID,
                     _next_pow2)
from .wgl_host import WGLResult

LANES = 128                  # lanes per layout block (buffer width unit)
CACHE_SLOTS = 128            # exact-key memo slots per lane
MAX_PAD = 1024               # call/ret node ids fit the 12-bit meta fields
FIFO_MAX_RING = 64           # fifo ring rows ride every memo key
CACHE_VMEM_BUDGET = 2 << 20  # memo bytes per 128 lanes (fifo shrink rule)
PASS1_CAP = 512              # first-pass step budget (two-pass rule)
NIL16 = 32767                # NIL32's image in the 16-bit value packing
WARP = 32                    # threads a block: one warp, at most 32 lanes
SMEM_MAX = 232448            # shared bytes a block may opt into on an
#                              H100: the plan's limit off the card
WARPS_PER_SM = 16            # a launch packs lanes into warps only past
#                              this many warps an SM: the count within 8 %
#                              of the fastest lanes a block at 4096 and
#                              16,384 lanes in chip_smoke.py's sweep
PLAIN_CHUNK = 256            # graph replays of search_plain per check

MODEL_IDS = {"cas-register": 0, "register": 1, "mutex": 2,
             "unordered-queue": 3, "fifo-queue": 4}

#: kernel launches so far (one per `search` call on a CUDA tensor)
LAUNCHES = 0
#: when a list, every launch appends its (start, end) CUDA events, so a
#: caller can read the kernel's own time on the card
TIMED: list | None = None
#: when a list, every `search` call appends its arguments (packed, msteps,
#: jm, n_pad, n_state, cache_slots), so a caller can replay exactly the
#: searches a check ran
CAPTURE: list | None = None


def _m_pad(n_pad: int) -> int:
    """Node rows (2*n_pad+1) padded to 8; the last row is the trash row
    padded entries point at."""
    return ((2 * n_pad + 1 + 7) // 8) * 8


def _nw(n_pad: int) -> int:
    return max(1, (n_pad + 31) // 32)


def _is_scalar(jm) -> bool:
    return isinstance(jm, mjit.JitModel)


def _key_words(jm, n_pad: int, n_state: int) -> int:
    if getattr(jm, "name", "") == "fifo-queue":
        return _nw(n_pad) + n_state - 8
    return _nw(n_pad) + 1 if _is_scalar(jm) else _nw(n_pad)


def eligible(jm, n_pad: int) -> bool:
    """Scalar one-word models and both queue families, up to MAX_PAD
    entries. Fifo lanes also need a bounded ring — checked per batch by
    `batch_eligible`."""
    if n_pad > MAX_PAD:
        return False
    if _is_scalar(jm) and jm.state_in_key:
        return True
    return getattr(jm, "name", "") in ("unordered-queue", "fifo-queue")


def batch_eligible(jm, entries_list) -> bool:
    """Full routing probe for a concrete batch: model/pad eligibility,
    per-lane payload encodability, and the fifo ring bound."""
    if not entries_list:
        return False
    n_pad = _pad_size(max(len(es) for es in entries_list))
    if not eligible(jm, n_pad):
        return False
    if not all(jm.lane_eligible(es) for es in entries_list):
        return False
    if getattr(jm, "name", "") == "fifo-queue":
        return _state_pad(jm, entries_list) - 8 <= FIFO_MAX_RING
    return True


def _state_pad(jm, entries_list) -> int:
    """State rows for a batch: 1 for scalar models; the widest lane's
    value count as a power of two (>= 8) for the unordered queue; the
    ring capacity (pow2 of the most enqueues) + 8 cursor rows for the
    fifo queue."""
    if _is_scalar(jm):
        return 1
    w = max((jm.lane_width(es) for es in entries_list), default=1)
    if getattr(jm, "name", "") == "fifo-queue":
        return max(8, _next_pow2(max(1, w - 2))) + 8
    return max(8, _next_pow2(w))


def _cache_slots(jm, n_pad: int, n_state: int) -> int:
    """Memo slots per lane: CACHE_SLOTS, shrunk for wide fifo keys by
    the JAX engine's VMEM-budget rule (kept: it sets the step counts)."""
    if getattr(jm, "name", "") != "fifo-queue":
        return CACHE_SLOTS
    ring = n_state - 8
    if ring > FIFO_MAX_RING:
        raise ValueError(
            f"fifo ring {ring} > {FIFO_MAX_RING}: memo keys too wide for "
            "the kernel")
    key_bytes = (_nw(n_pad) + ring) * LANES * 4
    return max(8, min(
        CACHE_SLOTS, _next_pow2(CACHE_VMEM_BUDGET // key_bytes + 1) // 2))


def _encode_flats(entries_list, jm, n_pad: int) -> dict:
    """Encode a whole batch ONCE into flat per-entry arrays, all the way
    to the packed words, so every later `_layout` (the survivor pass
    included) is a gather + scatter per row block."""
    m_pad = _m_pad(n_pad)
    n_lanes = len(entries_list)
    ns = np.array([len(es) for es in entries_list], np.int64)
    offs = np.concatenate([[0], np.cumsum(ns)])
    total = int(ns.sum())
    f_flat = v1_flat = v2_flat = None
    if _is_scalar(jm):
        try:
            f_flat, v1_flat, v2_flat = jm.encode_batch(entries_list, total)
        except TypeError:  # unhashable payload somewhere: lane by lane
            f_flat = None
    if f_flat is None:
        f_flat = np.empty(total, np.int32)
        v1_flat = np.empty(total, np.int32)
        v2_flat = np.empty(total, np.int32)
        pos = 0
        for es in entries_list:
            n = len(es)
            if n:
                (f_flat[pos:pos + n], v1_flat[pos:pos + n],
                 v2_flat[pos:pos + n]) = jm.encode_lane(es)
                pos += n
    nonempty = [es for es in entries_list if len(es)]
    cr_flat = (np.concatenate([es.crashed for es in nonempty])
               if nonempty else np.zeros(0, bool))
    # +1: node ids are event positions shifted past the head sentinel 0
    cp_flat = (np.concatenate([np.asarray(es.call_pos) for es in nonempty])
               if nonempty else np.zeros(0, np.int64)).astype(np.int32) + 1
    rp_flat = (np.concatenate([np.asarray(es.ret_pos) for es in nonempty])
               if nonempty else np.zeros(0, np.int64)).astype(np.int32) + 1

    lane_idx = np.repeat(np.arange(n_lanes), ns)

    # The kernel's node -> entry map is an inverse of call/ret positions:
    # it is only well defined because they are a permutation per lane.
    occ = np.bincount(
        np.concatenate([lane_idx, lane_idx]) * np.int64(m_pad)
        + np.concatenate([cp_flat, rp_flat]).astype(np.int64))
    assert occ.max(initial=0) <= 1, \
        "duplicate call/ret node positions in Entries"

    # 16-bit value packing, decided once for the whole batch so every
    # relaunch shares one layout
    nil1 = v1_flat == mjit.NIL32
    nil2 = v2_flat == mjit.NIL32
    v16_fit = bool(
        np.all(nil1 | ((v1_flat >= -32768) & (v1_flat < NIL16)))
        and np.all(nil2 | ((v2_flat >= -32768) & (v2_flat < NIL16))))

    cr32 = cr_flat.astype(np.int32)
    meta_flat = (f_flat + 1) | (cr32 << 3) | (cp_flat << 4) \
        | (rp_flat << 16)
    if v16_fit:
        lo = np.where(nil1, NIL16, v1_flat) & 0xFFFF
        hi = np.where(nil2, NIL16, v2_flat) & 0xFFFF
        v16_flat = lo | (hi << 16)
    else:
        v16_flat = None

    return {
        "f": f_flat, "v1": v1_flat, "v2": v2_flat,
        "cr": cr32, "cp": cp_flat, "rp": rp_flat,
        "meta": meta_flat, "v16p": v16_flat,
        "ns": ns, "offs": offs, "v16_fit": v16_fit,
        "ncomp": np.array([es.n_completed for es in entries_list],
                          np.int32),
    }


def _layout(flats: dict, idx, n_pad: int) -> tuple[np.ndarray, int]:
    """Lay the lanes `idx` (None = all) out column-wise into the packed
    int32 buffer (row format in the module docstring). Returns
    (buffer, n_blocks); the width is n_blocks * LANES with n_blocks a
    power of two, as in the JAX package, so both produce the same bytes.

    Padding lanes have n_completed == 0 (VALID at once, no search).
    Padded entries aim call/ret at the trash row m_pad-1, which no
    reachable node id ever equals."""
    m_pad = _m_pad(n_pad)
    ns_all, offs = flats["ns"], flats["offs"]
    if idx is None:
        ns = ns_all
        sel = slice(None)
    else:
        idx = np.asarray(idx, np.int64)
        ns = ns_all[idx]
        if len(idx) and np.all(np.diff(idx) == 1):
            sel = slice(int(offs[idx[0]]), int(offs[idx[-1] + 1]))
        else:
            total_sel = int(ns.sum())
            cum = np.cumsum(ns) - ns
            sel = (np.repeat(offs[idx] - cum, ns)
                   + np.arange(total_sel, dtype=np.int64))
    n_lanes = len(ns)
    n_blocks = (n_lanes + LANES - 1) // LANES
    n_blocks = 1 if n_blocks <= 1 else _next_pow2(n_blocks)
    width = n_blocks * LANES

    ncomp = flats["ncomp"] if idx is None else flats["ncomp"][idx]
    v16 = flats["v16_fit"]

    meta_flat = flats["meta"][sel]
    total = len(meta_flat)
    lane_idx = np.repeat(np.arange(n_lanes), ns)
    row_idx = np.arange(total) - np.repeat(np.cumsum(ns) - ns, ns)

    rows = (2 if v16 else 3) * n_pad + 1
    buf = np.empty((rows, width), np.int32)
    mb = buf[0:n_pad]
    mb.fill(((m_pad - 1) << 4) | ((m_pad - 1) << 16))
    mb[row_idx, lane_idx] = meta_flat
    if v16:
        vv = buf[n_pad:2 * n_pad]
        vv.fill(NIL16 | (NIL16 << 16))  # padding entries: both NIL
        vv[row_idx, lane_idx] = flats["v16p"][sel]
    else:
        v1 = buf[n_pad:2 * n_pad]
        v2 = buf[2 * n_pad:3 * n_pad]
        v1.fill(mjit.NIL32)
        v2.fill(mjit.NIL32)
        v1[row_idx, lane_idx] = flats["v1"][sel]
        v2[row_idx, lane_idx] = flats["v2"][sel]

    last = buf[-1]
    last.fill(0)
    last[:n_lanes] = ns.astype(np.int32) | (ncomp << 16)
    return buf, n_blocks


def _lane_bytes(jm, n_pad: int, n_state: int, cache_slots: int) -> int:
    """Shared bytes of one lane's tables, in wgl_vec.cu's layout: int32
    meta, v1, v2 (n_pad each), stack states (n_pad for the scalar
    models, else 1), bitset (nw), queue state (n_state), fingerprints
    (cache_slots) and memo keys (cache_slots x key words); int16 nxt,
    prv, node map (m_pad each), stack entries and best stack (n_pad
    each)."""
    stack_s = n_pad if _is_scalar(jm) else 1
    kw = _key_words(jm, n_pad, n_state)
    return (4 * (3 * n_pad + stack_s + _nw(n_pad) + n_state
                 + cache_slots * (1 + kw))
            + 2 * (3 * _m_pad(n_pad) + 2 * n_pad))


class SmemPlan(NamedTuple):
    """A launch's shared memory: `lanes` lanes (threads of the block's
    one warp) a block, `lane_bytes` per lane and `bytes` in all per
    block (the zmix table of n_pad words, then the lanes)."""
    lanes: int
    lane_bytes: int
    bytes: int


def _smem_plan(jm, n_pad: int, n_state: int, cache_slots: int,
               most: int = WARP, smem_max: int = SMEM_MAX) -> SmemPlan:
    """As many lanes a block as fit `smem_max` bytes beside the block's
    zmix table, at most `most` (<= WARP). Raises ValueError when one
    lane does not fit."""
    lane = _lane_bytes(jm, n_pad, n_state, cache_slots)
    lanes = min(most, WARP, (smem_max - 4 * n_pad) // lane)
    if lanes < 1:
        raise ValueError(
            f"wgl_vec: one lane at n_pad {n_pad}, n_state {n_state} needs "
            f"{4 * n_pad + lane} bytes of shared memory, over {smem_max}")
    return SmemPlan(lanes, lane, 4 * n_pad + lanes * lane)


def _warp_lanes(width: int, sms: int) -> int:
    """Lanes a warp for a launch of `width` lanes on `sms` SMs: no more
    than it takes to give each SM WARPS_PER_SM warps. Lanes that share a
    warp and branch apart step one after another, so few lanes run one
    a warp."""
    return max(1, -(-width // (sms * WARPS_PER_SM)))


def launch_plan(packed: torch.Tensor, jm, n_pad: int, n_state: int,
                cache_slots: int, lanes: int | None = None) -> SmemPlan:
    """The plan `search` launches `packed` (on a CUDA device) with: at
    most `lanes` lanes a block, or, when None, `_warp_lanes` of its
    width over the device's SMs; the device's own shared-memory limit."""
    props = torch.cuda.get_device_properties(packed.device)
    most = lanes or _warp_lanes(packed.shape[1], props.multi_processor_count)
    return _smem_plan(jm, n_pad, n_state, cache_slots, most,
                      props.shared_memory_per_block_optin)


def _check_inputs(packed, msteps, jm, n_pad: int, n_state: int,
                  cache_slots: int) -> None:
    if packed.dtype != torch.int32 or msteps.dtype != torch.int32:
        raise TypeError("packed and msteps must be int32")
    if packed.dim() != 2 or msteps.dim() != 1:
        raise ValueError("packed is (rows, width), msteps is (width,)")
    rows, width = packed.shape
    if rows not in (2 * n_pad + 1, 3 * n_pad + 1):
        raise ValueError(f"packed has {rows} rows; n_pad={n_pad} needs "
                         f"{2 * n_pad + 1} or {3 * n_pad + 1}")
    if msteps.shape[0] != width or width % LANES:
        raise ValueError(f"width {width} must match msteps and be a "
                         f"multiple of {LANES}")
    if packed.device != msteps.device:
        raise ValueError("packed and msteps on different devices")
    if not (packed.is_contiguous() and msteps.is_contiguous()):
        raise ValueError("packed and msteps must be contiguous")
    if not eligible(jm, n_pad):
        raise ValueError(f"wgl_vec ineligible: model={jm.name} n_pad={n_pad}")
    if cache_slots & (cache_slots - 1) or not 1 <= cache_slots <= CACHE_SLOTS:
        raise ValueError(f"cache_slots {cache_slots} not a power of two "
                         f"<= {CACHE_SLOTS}")
    if not _is_scalar(jm) and n_state < 8:
        raise ValueError("queue models need n_state >= 8")


_SIG = {"wgl_vec_launch": (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    ctypes.c_int)}


def build(device=None):
    """The kernel's library for `device` (None = the current CUDA
    device), built from csrc/wgl_vec.cu at first use; raises
    _build.BuildError with nvcc's stderr when the build fails."""
    from . import _build

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the wgl_vec kernel builds for a CUDA device")
    return _build.load("wgl_vec", torch.cuda.get_device_capability(dev),
                       _SIG)


def search(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
           n_state: int = 1, cache_slots: int = CACHE_SLOTS,
           lanes: int | None = None):
    """One WGL search launch over the lanes of `packed`.

    packed: (2*n_pad+1 or 3*n_pad+1, width) int32, the `_layout` buffer;
    msteps: (width,) int32 per-lane step budgets. Returns (small, best)
    on packed's device: small (5, width) = verdict, steps, depth, best
    depth, stuck entry; best (n_pad, width) = the deepest stack, rows
    [0, best depth) per lane, zero above.

    CUDA tensors launch the kernel (built at first use) on the current
    stream, every table of each lane's search in shared memory as
    `launch_plan` lays them out (at most `lanes` lanes a block when
    given); this raises if the plan does not fit a block or the build or
    the launch fails. CPU tensors run `search_plain`."""
    global LAUNCHES
    _check_inputs(packed, msteps, jm, n_pad, n_state, cache_slots)
    if CAPTURE is not None:
        CAPTURE.append((packed, msteps, jm, n_pad, n_state, cache_slots))
    if packed.device.type == "cpu":
        return search_plain(packed, msteps, jm, n_pad, n_state, cache_slots)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    dev = packed.device
    plan = launch_plan(packed, jm, n_pad, n_state, cache_slots, lanes)
    with torch.cuda.device(dev):
        lib = build(dev)
        width = packed.shape[1]
        small = torch.empty((5, width), dtype=torch.int32, device=dev)
        best = torch.empty((n_pad, width), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev)
        if TIMED is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        rc = lib.wgl_vec_launch(
            packed.data_ptr(), msteps.data_ptr(), small.data_ptr(),
            best.data_ptr(), width, n_pad, _m_pad(n_pad),
            int(packed.shape[0] == 2 * n_pad + 1), MODEL_IDS[jm.name],
            n_state, cache_slots, _nw(n_pad), _key_words(jm, n_pad, n_state),
            int(jm.init_state) if _is_scalar(jm) else 0,
            plan.lanes, plan.bytes, stream.cuda_stream)
        if rc != 0:
            raise KernelError(f"wgl_vec kernel launch failed: cudaError {rc}")
        if TIMED is not None:
            ev[1].record(stream)
            TIMED.append(ev)
    LAUNCHES += 1
    return small, best


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (two's
    complement wraparound, done explicitly)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _zmix(x: torch.Tensor) -> torch.Tensor:
    """K1's splitmix-style diffusion on int32 values (int64 arithmetic,
    wrapped to int32 after each multiply; >> is arithmetic)."""
    x = x.to(torch.int64)
    x = _wrap32((x - 1640531527) * -1640531535).to(torch.int64)
    x = _wrap32((x ^ (x >> 15)) * -2048144789).to(torch.int64)
    return (x ^ (x >> 13)).to(torch.int32)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """hm = x * 16777619 (wrapping); hm ^ (hm >> 15)."""
    hm = _wrap32(x.to(torch.int64) * 16777619).to(torch.int64)
    return (hm ^ (hm >> 15)).to(torch.int32)


def search_plain(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
                 n_state: int = 1, cache_slots: int = CACHE_SLOTS):
    """The plain PyTorch version of the kernel: every lane steps in
    lockstep, each data-dependent read a gather and each write a
    scatter, the memo compared against every slot as in the TPU kernel,
    inactive lanes frozen. Same outputs as `search`, on packed's device.

    One lockstep step is ~200 small tensor ops. On a CUDA tensor the
    step is captured once into a CUDA graph and replayed in chunks of
    PLAIN_CHUNK steps (a step after every lane has finished changes
    nothing, so overshooting the last one is harmless); on the CPU it
    loops with a check per step."""
    _check_inputs(packed, msteps, jm, n_pad, n_state, cache_slots)
    dev = packed.device
    i32, i64 = torch.int32, torch.int64
    rows, L = packed.shape
    m_pad = _m_pad(n_pad)
    nw = _nw(n_pad)
    scalar = _is_scalar(jm)
    fifo = getattr(jm, "name", "") == "fifo-queue"
    uq = not scalar and not fifo
    S = n_state - 8 if fifo else 0
    kw = _key_words(jm, n_pad, n_state)

    meta = packed[:n_pad]
    f_t = (meta & 7) - 1
    crashed_t = (meta >> 3) & 1
    cp_t = ((meta >> 4) & 0xFFF).to(i64)
    rp_t = ((meta >> 16) & 0xFFF).to(i64)
    if rows == 2 * n_pad + 1:
        raw = packed[n_pad:2 * n_pad]
        lo = ((raw & 0xFFFF) ^ 0x8000) - 0x8000
        hi = raw >> 16
        v1_t = torch.where(lo == NIL16, int(mjit.NIL32), lo)
        v2_t = torch.where(hi == NIL16, int(mjit.NIL32), hi)
    else:
        v1_t = packed[n_pad:2 * n_pad]
        v2_t = packed[2 * n_pad:3 * n_pad]
    last = packed[-1]
    nn = last & 0xFFFF
    ncomp = last >> 16
    msteps = msteps.to(i32)

    lanes = torch.arange(L, device=dev)
    m_rows = torch.arange(m_pad, device=dev, dtype=i32)[:, None]
    n_rows = torch.arange(n_pad, device=dev, dtype=i32)[:, None]
    w_rows = torch.arange(nw, device=dev, dtype=i32)[:, None]
    s_rows = torch.arange(n_state, device=dev, dtype=i32)[:, None]
    two_n = 2 * nn[None, :]
    nxt = torch.where(m_rows < two_n, m_rows + 1, 0).to(i32)
    prv = torch.where((m_rows >= 1) & (m_rows <= two_n), m_rows - 1, 0).to(i32)
    # node -> (entry << 1) | is_call, over the real entries of each lane
    ent = torch.zeros((m_pad, L), dtype=i32, device=dev)
    real = n_rows < nn[None, :]
    ecol = n_rows.expand(n_pad, L)
    lcol = lanes[None, :].expand(n_pad, L)
    ent[cp_t[real], lcol[real]] = (2 * ecol[real] + 1).to(i32)
    ent[rp_t[real], lcol[real]] = (2 * ecol[real]).to(i32)

    stack_e = torch.zeros((n_pad, L), dtype=i32, device=dev)
    stack_s = torch.zeros((n_pad, L), dtype=i32, device=dev)
    cache = torch.zeros((cache_slots, kw, L), dtype=i32, device=dev)
    used = torch.zeros((cache_slots, L), dtype=torch.bool, device=dev)
    best = torch.zeros((n_pad, L), dtype=i32, device=dev)
    lin = torch.zeros((nw, L), dtype=i32, device=dev)
    qstate = torch.zeros((n_state, L), dtype=i32, device=dev)

    # per-lane registers, updated in place by `step` (a CUDA graph
    # replays against fixed addresses)
    node = torch.where(nn > 0, 1, 0).to(i32)
    state = torch.full((L,), int(jm.init_state) if scalar else 0,
                       dtype=i32, device=dev)
    h = torch.zeros(L, dtype=i32, device=dev)
    depth = torch.zeros(L, dtype=i32, device=dev)
    completed = torch.zeros(L, dtype=i32, device=dev)
    steps = torch.zeros(L, dtype=i32, device=dev)
    verdict = torch.where(ncomp == 0, VALID, RUNNING).to(i32)
    bestd = torch.full((L,), -1, dtype=i32, device=dev)
    stuck = torch.full((L,), -1, dtype=i32, device=dev)
    active = (verdict == RUNNING) & (steps < msteps)

    def at(table, idx):
        """table[idx[l], l] per lane (idx in range)."""
        return table.gather(0, idx.to(i64)[None, :])[0]

    def put(table, idx, val, mask):
        """table[idx[l], l] = val[l] where mask[l] (idx in range)."""
        i = idx.to(i64)[None, :]
        old = table.gather(0, i)[0]
        table.scatter_(0, i, torch.where(mask, val.to(table.dtype),
                                         old)[None, :])

    def step():
        act = active.clone()
        en = at(ent, node)
        e = en >> 1
        is_call = (node != 0) & ((en & 1) == 1)
        f_e = at(f_t, e)
        v1_e = at(v1_t, e)
        crashed_e = at(crashed_t, e)

        if scalar:
            new_state, ok = jm.step(state, f_e, v1_e, at(v2_t, e))
            new_state = new_state.to(i32)
        elif uq:
            in_rng = (v1_e >= 0) & (v1_e < n_state)
            vi = v1_e.clamp(0, n_state - 1)
            cnt = torch.where(in_rng, at(qstate, vi), 0)
            ok = (f_e == 0) | ((f_e == 1) & (cnt > 0))
        else:
            head, tail = qstate[S].clone(), qstate[S + 1].clone()
            front = at(qstate, head.clamp(0, n_state - 1))
            front = torch.where((head >= 0) & (head < n_state), front, 0)
            enq_ok = (f_e == 0) & (tail < S)
            deq_ok = (f_e == 1) & (head < tail) & (front == v1_e + 1)
            ok = enq_ok | deq_ok
            qrow = torch.where(enq_ok, tail, head)
            qval = torch.where(enq_ok, v1_e + 1, 0).to(i32)
        can_lin = act & is_call & ok

        word = e >> 5
        bit = _wrap32(torch.ones_like(e, dtype=i64) << (e & 31).to(i64))
        new_lin = lin | torch.where(w_rows == word[None, :], bit[None, :], 0)
        new_h = h ^ _zmix(e)
        if scalar:
            hm = _fold(new_h ^ new_state)
            key = torch.cat([new_lin, new_state[None, :]], 0)
        elif fifo:
            hm = _fold(new_h ^ _zmix(v1_e))
            new_ring = torch.where(s_rows[:S] == qrow[None, :],
                                   qval[None, :], qstate[:S])
            key = torch.cat([new_lin, new_ring], 0)
        else:
            hm = _fold(new_h)
            key = new_lin
        slot = (hm & (cache_slots - 1)).to(i64)
        found = (used & (cache == key[None]).all(1)).any(0)
        do_lift = can_lin & ~found
        lift_completed = completed + 1 - crashed_e

        can_pop = depth > 0
        dm1 = (depth - 1).clamp(min=0)
        e2 = torch.where(can_pop, at(stack_e, dm1), 0)
        crashed_e2 = at(crashed_t, e2)
        cn2 = at(cp_t, e2).to(i32)
        rn2 = at(rp_t, e2).to(i32)
        advance = act & is_call & ~do_lift
        backtrack = act & ~is_call
        do_back = backtrack & can_pop

        # counterexample tracking at every return event
        upd = backtrack & (depth > bestd)
        bestd.copy_(torch.where(upd, depth, bestd))
        stuck.copy_(torch.where(upd, torch.where(node == 0, -1, e), stuck))
        best.copy_(torch.where(upd[None, :] & (n_rows < depth[None, :]),
                               stack_e, best))

        # linked list: write A (call node out / return node back in),
        # then write B reading the list as A left it
        moved = do_lift | do_back
        cn = at(cp_t, e).to(i32)
        rn = at(rp_t, e).to(i32)
        src = torch.where(do_lift, cn, torch.where(do_back, rn2, 0))
        pa, qa = at(prv, src), at(nxt, src)
        put(nxt, pa, torch.where(do_back, rn2, qa), moved)
        put(prv, qa, torch.where(do_back, rn2, pa), moved)
        tgt = torch.where(do_lift, rn, torch.where(do_back, cn2, 0))
        pb, qb = at(prv, tgt), at(nxt, tgt)
        put(nxt, pb, torch.where(do_back, cn2, qb), moved)
        put(prv, qb, torch.where(do_back, cn2, pb), moved)

        # memo insert (always overwrite) and push
        sl = slot[None, None, :].expand(1, kw, L)
        old = cache.gather(0, sl)
        cache.scatter_(0, sl, torch.where(do_lift[None, None, :],
                                          key[None], old))
        put(used, slot, torch.ones_like(do_lift), do_lift)
        dcl = depth.clamp(max=n_pad - 1)
        put(stack_e, dcl, e, do_lift)

        # model state: apply the lifted step / undo the popped one
        if scalar:
            put(stack_s, dcl, state, do_lift)
            state.copy_(torch.where(do_lift, new_state,
                                    torch.where(do_back, at(stack_s, dm1),
                                                state)))
        elif uq:
            v1_e2 = at(v1_t, e2)
            f_e2 = at(f_t, e2)
            vi2 = v1_e2.clamp(0, n_state - 1)
            in2 = (v1_e2 >= 0) & (v1_e2 < n_state)
            put(qstate, vi, at(qstate, vi) + torch.where(f_e == 0, 1, -1),
                do_lift & in_rng)
            put(qstate, vi2, at(qstate, vi2) + torch.where(f_e2 == 0, -1, 1),
                do_back & in2)
        else:
            v1_e2 = at(v1_t, e2)
            f_e2 = at(f_t, e2)
            put(qstate, qrow.clamp(0, n_state - 1), qval, do_lift)
            put(qstate, (tail - 1).clamp(0, n_state - 1),
                torch.zeros_like(tail), do_back & (f_e2 == 0))
            put(qstate, (head - 1).clamp(0, n_state - 1), v1_e2 + 1,
                do_back & (f_e2 == 1))
            qstate[S] = head + (do_lift & deq_ok).to(i32) \
                - (do_back & (f_e2 == 1)).to(i32)
            qstate[S + 1] = tail + (do_lift & enq_ok).to(i32) \
                - (do_back & (f_e2 == 0)).to(i32)

        word2 = e2 >> 5
        bit2 = _wrap32(torch.ones_like(e2, dtype=i64) << (e2 & 31).to(i64))
        pop_lin = lin & ~torch.where(w_rows == word2[None, :],
                                     bit2[None, :], 0)
        lin.copy_(torch.where(do_lift[None, :], new_lin,
                              torch.where(do_back[None, :], pop_lin, lin)))
        h.copy_(torch.where(do_lift, new_h,
                            torch.where(do_back, h ^ _zmix(e2), h)))
        completed.copy_(torch.where(
            do_lift, lift_completed,
            torch.where(do_back, completed - 1 + crashed_e2, completed)))
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

    final = torch.where(verdict == RUNNING, UNKNOWN, verdict).to(i32)
    small = torch.stack([final, steps, depth, bestd, stuck]).to(i32)
    return small, best


def analysis_batch(model, entries_list, max_steps: int | None = None,
                   device=None, devices=None) -> list:
    """Check a batch of independent histories (Ops or Entries), one lane
    each; returns one WGLResult per lane. Raises on ineligible
    models/sizes — callers probe with `batch_eligible` first.

    device None means CUDA (raising when absent); "cpu" runs the plain
    version. `devices` (a list for `device.devices`, not with `device`)
    shards every pass's blocks over those devices (module docstring)
    when it names two or more; a one-device list is the single-device
    path on that device. A shard that fails to launch raises."""
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
    if max_steps is None:
        max_steps = DEFAULT_MAX_STEPS
    n_pad = _pad_size(max(len(es) for es in entries_list))
    if not eligible(jm, n_pad):
        raise ValueError(
            f"wgl_vec path ineligible: model={jm.name} n_pad={n_pad}")
    for es in entries_list:
        if not jm.lane_eligible(es):
            raise ValueError("lane has no int32 encoding")

    n_state = _state_pad(jm, entries_list)
    cache_slots = _cache_slots(jm, n_pad, n_state)
    flats = _encode_flats(entries_list, jm, n_pad)
    n = len(entries_list)

    def launch(idx, cap):
        """One pass over the lanes `idx` (None = all) at step cap `cap`:
        the packed buffer's blocks padded to a multiple of the device
        count and split in contiguous shards, one H2D copy and one
        search a shard, then the D2H of the results (a shard's best
        stacks only when one of its lanes refuted)."""
        buf, n_blocks = _layout(flats, idx, n_pad)
        if n_blocks % len(devs):
            pad_to = -(-n_blocks // len(devs)) * len(devs)
            buf = np.pad(buf, ((0, 0), (0, (pad_to - n_blocks) * LANES)))
            n_blocks = pad_to
        width = n_blocks // len(devs) * LANES
        outs = []
        for k, d in enumerate(devs):
            packed = torch.from_numpy(np.ascontiguousarray(
                buf[:, k * width:(k + 1) * width])).to(d)
            msteps = torch.full((width,), cap, dtype=torch.int32, device=d)
            outs.append(search(packed, msteps, jm, n_pad, n_state,
                               cache_slots))
        smalls = [s.cpu().numpy() for s, _ in outs]
        w = n if idx is None else len(idx)
        small = np.concatenate(smalls, 1)[:, :w]
        best = None
        if (small[0] == INVALID).any():
            best = np.concatenate(
                [b.cpu().numpy() if (sm[0] == INVALID).any()
                 else np.zeros(b.shape, np.int32)
                 for sm, (_, b) in zip(smalls, outs)], 1)[:, :w]
        return small, best

    def result(es, small, best, i, extra_steps=0):
        v, s = small[0][i], int(small[1][i]) + extra_steps
        if v == VALID:
            return WGLResult(valid=True, steps=s)
        if v == INVALID:
            # the kernel tracked its own counterexample: the deepest
            # legal prefix and the entry it was stuck at
            stuck, bestd = int(small[4][i]), int(small[3][i])
            op = es.invokes[stuck] if stuck >= 0 else None
            bl = [es.invokes[int(e)] for e in best[: max(0, bestd), i]]
            return WGLResult(
                valid=False, op=op, best_linearization=bl, steps=s)
        return WGLResult(valid="unknown", steps=s)

    # Two-pass rule: lanes that need few steps resolve under PASS1_CAP;
    # only the survivors re-run with the whole budget, so one deep lane
    # does not hold every block at the full cap.
    two_pass = max_steps > 8 * PASS1_CAP and n > LANES
    pass1_cap = min(PASS1_CAP, max_steps) if two_pass else max_steps
    small1, best1 = launch(None, pass1_cap)
    survivors = [i for i in range(n) if small1[0][i] == UNKNOWN]
    surv_set = set(survivors)
    results: list = [None] * n
    for i, es in enumerate(entries_list):
        if i not in surv_set:
            results[i] = result(es, small1, best1, i)
    if survivors and max_steps > pass1_cap:
        small2, best2 = launch(survivors, max_steps)
        for j, i in enumerate(survivors):
            # pass-1 work was spent too: report it in the total
            results[i] = result(entries_list[i], small2, best2, j,
                                extra_steps=int(small1[1][i]))
    elif survivors:
        for i in survivors:
            results[i] = result(entries_list[i], small1, best1, i)
    return results
