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

Lanes are packed lane-major into one int32 tensor (`wgl_search._pack`):
per lane K5's input columns one after another (the layout is in
`ops/wgl_search.py`'s docstring; m_pad = roundup8(2*n_pad + 1), as K5
pads the node rows). `search` is the kernel's wrapper:
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

import torch

from ..device import KernelError, resolve
from ..history import Entries, entries as make_entries
from ..models import jit as mjit
from . import wgl_search
from .wgl_search import (DEFAULT_MAX_STEPS, INVALID, N_PROBES,  # noqa: F401
                         RUNNING, UNKNOWN, VALID, _COLS, _NODE_COLS, _m_pad,
                         _nw, _pack, _rows, pad_size as _bucket)

CACHE_BITS = 11              # K5's memo: 2048 rows per lane
ROW = 128                    # K5's key row: 127 bitset words + the state
MAX_PAD = (ROW - 1) * 32     # 4064 entries
MAX_CACHE_BITS = 16
SMEM_MAX = 232448            # shared bytes a block may opt into on an
#                              H100: the plan's limit off the card
MAX_LANES_PER_BLOCK = 8      # warps a block holds (as wgl_row.cu)

MODEL_IDS = {"cas-register": 0, "register": 1, "mutex": 2}

#: kernel launches so far (one per `search` call on a CUDA tensor)
LAUNCHES = 0
#: when a list, every launch appends its (start, end) CUDA events
TIMED: list | None = None
#: when a list, every `search` call appends its arguments (packed,
#: msteps, jm, n_pad, cache_bits), so a caller can replay exactly the
#: searches a check ran
CAPTURE: list | None = None

def key_words(n_pad: int) -> int:
    """Words of one memo key: the bitset words, then the state."""
    return _nw(n_pad) + 1


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
        ztab = wgl_search._ztab(n_pad, dev)
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


def search_plain(packed: torch.Tensor, msteps: torch.Tensor, jm, n_pad: int,
                 cache_bits: int = CACHE_BITS) -> torch.Tensor:
    """The plain PyTorch version of the kernel: `wgl_search.search_plain`
    at n_state 1, which for the scalar models is K5's search (the same
    hash, probes, insert rule and undo; a key of the live words compares
    equal exactly when K5's 128-word rows do). Same outputs as `search`,
    on packed's device."""
    _check_inputs(packed, msteps, jm, n_pad, cache_bits)
    return wgl_search.search_plain(packed, msteps, jm, n_pad, 1, cache_bits)


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
    return wgl_search._results(model, entries_list, small)
