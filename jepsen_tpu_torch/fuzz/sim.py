"""Vectorized list-append cluster simulator (the port's copy of
`jepsen_tpu/fuzz/sim.py`), with K4's counterpart on the card.

One launch simulates a whole batch of independent clusters. Cluster
``i`` is fully determined by ``(wseeds[i], scheds[i])``: the workload
(coordinator choice, txn shapes, keys, read/append mix) is a pure
function of the workload seed through a murmur-style integer hash, and
the fault behaviour is a pure function of the ``fuzz.schedule`` array.
Everything is fixed-shape integer math, so every engine gives the same
bits:

  sim_plain   the JAX package's `_sim_math` in PyTorch on any device:
              the hash in int64 with each 32-bit constant split into
              16-bit halves, so no product passes 2^48. On CPU tensors it
              is the host engine (`engine="host"`).
  sim         the CUDA kernel (csrc/sim.cu, one block a cluster, working
              only on the pairs of mops and of (append, node) that its
              outputs need) on a CUDA tensor; the plain version on a CPU
              tensor.

The model, in mop-time units (one txn slot = L mop-times): txn slot
``s`` runs on coordinator ``coord[s]`` with up to ``L`` micro-ops; mop
``(s, j)`` executes at ``s*L + j`` modified by the faults (kill fails the
coordinator's txns and redelivers replication at the window's end;
pause defers a txn's later mops; clock skews and strobes commit times;
partition walls replication across the cut; packet drops delay
deliveries; corruption rolls a replica's recent tail of one key back).
The final per-key append order ranks appends by ``(eff, mop index)``; a
read observes the appends delivered to its node before it, as the
smallest position not yet visible, so every read is a prefix of the
final order and decoded traces are always inferable.

`simulate_batch` canonicalizes the schedules, folds the workload seeds
to non-negative int32 and runs the chosen engine; there is no ladder: a
kernel that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import KernelError, resolve
from .schedule import (CLOCK, CORRUPT, DEFAULT_SPEC, KILL, PARTITION, PACKET,
                       PAUSE, SimSpec, canonicalize)

#: sentinel delivery/position for "never" — far beyond any real time
#: but safely inside int32 even after packet/retry arithmetic.
_BIG = 1 << 28

#: pad / append / read codes in the ``kind`` output array.
KIND_APPEND = 0
KIND_READ = 1
KIND_PAD = 2

#: the seven outputs, in the kernel's argument order
OUTPUTS = ("coord", "failed", "kind", "key", "eff", "pos", "rlen")

#: launches of the kernel on CUDA tensors so far
LAUNCHES = 0
#: when a list, every launch on the card appends its (start, end) CUDA
#: events
TIMED: list | None = None

#: shared memory a block may opt in to on the H100 (bytes)
SMEM_LIMIT = 232_448

#: threads a block the kernel takes at most (csrc/sim.cu MAX_THREADS)
MAX_THREADS = 256
#: threads a block: None = `block_threads`'s choice from the batch
#: (chip_smoke.py times other counts by setting it)
THREADS: int | None = None
#: clusters an SM up to which a launch is one cluster's chain of phases
#: (MAX_THREADS threads), and from which it is the instructions issued
#: (a thread a pair of mops): on the H100 at the default spec 256
#: threads a block led at 256 clusters, 128 at 1,024 and 64 at 16,384
#: (chip_smoke.py `threads_ms`)
LATENCY_CLUSTERS_PER_SM = 2
THROUGHPUT_CLUSTERS_PER_SM = 16

_M32 = 0xFFFFFFFF


# -- the hash ------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for int64 `a` in [0, 2^32): the constant in 16-bit
    halves, so each product stays below 2^48."""
    lo, hi_ = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi_) & 0xFFFF) << 16)) & _M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hi_torch(w, c: int, a, b) -> torch.Tensor:
    """The hash on torch tensors (broadcasting like its arguments), the
    same bits as the JAX package's numpy hash and the CUDA kernel's."""
    def conv(x):
        return x.to(torch.int64) if torch.is_tensor(x) \
            else torch.tensor(x, dtype=torch.int64)

    dev = next(x.device for x in (w, a, b) if torch.is_tensor(x))
    h = _fmix(conv(w).to(dev) ^ 0x9E3779B9)
    h = _fmix(h ^ _mul32(conv(a).to(dev), 0x85EBCA6B))
    h = _fmix(h ^ _mul32(conv(b).to(dev), 0xC2B2AE35))
    h = _fmix(h ^ _mul32(torch.tensor(c, dtype=torch.int64, device=dev),
                         0x27D4EB2F))
    return (h & 0x7FFFFFFF).to(torch.int32)


def _mod(a: torch.Tensor, b) -> torch.Tensor:
    """a % b where C's truncating % must agree with Python's flooring
    one: a >= 0 and b > 0, checked."""
    assert bool((a >= 0).all()), "negative left operand of %"
    assert bool((torch.as_tensor(b) > 0).all()), "non-positive modulus"
    return torch.remainder(a, b)


# -- the plain versions -------------------------------------------------

def sim_plain(scheds: torch.Tensor, wseeds: torch.Tensor,
              spec: SimSpec = DEFAULT_SPEC) -> dict:
    """The whole cluster batch as one tensor program, on the device of
    its inputs: the JAX package's `_sim_math` line for line
    (take_along_axis is torch.gather). scheds: [S, F, 6] int32,
    canonical; wseeds: [S] non-negative int32. Returns the seven outputs
    as tensors."""
    dev = scheds.device
    i32 = torch.int32
    S = scheds.shape[0]
    F, T, St, L = spec.faults, spec.txns, spec.slots, spec.mops
    N, K = spec.nodes, spec.keys
    sarr = torch.arange(St, dtype=i32, device=dev)
    jarr = torch.arange(L, dtype=i32, device=dev)
    w2 = wseeds.to(i32)[:, None]
    w3 = w2[:, :, None]
    zero = torch.zeros((), dtype=i32, device=dev)

    is_audit = sarr >= T
    coord = torch.where(is_audit, zero, _mod(hi_torch(w2, 11, sarr, 0), N))
    nmops = torch.where(is_audit, zero + L,
                        1 + _mod(hi_torch(w2, 12, sarr, 0), L))
    rd = _mod(hi_torch(w3, 13, sarr[None, :, None], jarr), 2)
    key = _mod(hi_torch(w3, 14, sarr[None, :, None], jarr), K)
    akey = (sarr[:, None] - T) * L + jarr[None, :]
    active = torch.where(is_audit[:, None], akey < K,
                         jarr[None, :] < nmops[:, :, None])
    key = torch.where(is_audit[:, None], akey.clamp(0, K - 1), key)
    kind = torch.where(~active, zero + KIND_PAD,
                       torch.where(is_audit[:, None] | (rd == 1),
                                   zero + KIND_READ, zero + KIND_APPEND))

    fam, msk = scheds[:, :, 0], scheds[:, :, 1]
    t0, t1 = scheds[:, :, 2], scheds[:, :, 3]
    p0, p1 = scheds[:, :, 4], scheds[:, :, 5]
    cbit = ((msk[:, :, None] >> coord[:, None, :]) & 1) == 1
    win = (t0[:, :, None] <= sarr) & (sarr < t1[:, :, None]) & ~is_audit
    cwin = cbit & win
    failed = ((fam[:, :, None] == KILL) & cwin).any(dim=1)
    pc = (fam[:, :, None] == PAUSE) & cwin
    pend = torch.where(pc, t1[:, :, None], zero).amax(dim=1)
    psplit = torch.where(pc, p0[:, :, None], zero).amax(dim=1)
    paused = pc.any(dim=1)
    cc = (fam[:, :, None] == CLOCK) & cwin
    coff = torch.where(cc, p0[:, :, None], zero).sum(dim=1).to(i32)
    camp = torch.where(cc, p1[:, :, None], zero).amax(dim=1)

    base = sarr[None, :, None] * L + jarr
    defer = paused[:, :, None] & (jarr[None, None, :] >= psplit[:, :, None])
    basew = torch.where(defer, pend[:, :, None] * L + jarr, base)
    denom = 2 * camp[:, :, None] + 1
    jit_ = _mod(hi_torch(w3, 16, sarr[None, :, None], jarr), denom) \
        - camp[:, :, None]
    effw = torch.clamp(basew + coff[:, :, None] + jit_, min=0)
    abase = (spec.audit_t0 + sarr[None, :, None] - T) * L + jarr
    eff = torch.where(is_audit[None, :, None], abase, effw).to(i32)

    Mtot = St * L
    marr = torch.arange(Mtot, dtype=i32, device=dev)
    effm = eff.reshape(S, Mtot)
    keym = key.reshape(S, Mtot)
    kindm = kind.reshape(S, Mtot)
    sendm = coord[:, :, None].expand(S, St, L).reshape(S, Mtot)
    failm = failed[:, :, None].expand(S, St, L).reshape(S, Mtot)
    vapp = (kindm == KIND_APPEND) & ~failm
    vread = (kindm == KIND_READ) & ~failm

    keyeq = keym[:, :, None] == keym[:, None, :]
    earlier = (effm[:, None, :] < effm[:, :, None]) \
        | ((effm[:, None, :] == effm[:, :, None])
           & (marr[None, :] < marr[:, None]))
    pos = (vapp[:, None, :] & keyeq & earlier).sum(dim=2).to(i32)

    narr = torch.arange(N, dtype=i32, device=dev)
    deliv = effm[:, :, None].expand(S, Mtot, N).clone()
    for f in range(F):
        fa = fam[:, f][:, None, None]
        mk = msk[:, f][:, None, None]
        a0 = t0[:, f][:, None, None] * L
        a1 = t1[:, f][:, None, None] * L
        q0 = p0[:, f][:, None, None]
        q1 = p1[:, f][:, None, None]
        sb = ((mk >> sendm[:, :, None]) & 1) == 1
        rb = ((mk >> narr[None, None, :]) & 1) == 1
        nonlocal_ = sendm[:, :, None] != narr[None, None, :]
        inw = (a0 <= deliv) & (deliv < a1)
        deliv = torch.where((fa == PARTITION) & (sb ^ rb) & inw, a1, deliv)
        hd = hi_torch(w3, 170 + f, marr[None, :, None], narr[None, None, :])
        inw = (a0 <= deliv) & (deliv < a1)
        drop = (fa == PACKET) & (sb | rb) & nonlocal_ & inw \
            & (_mod(hd, 16) < q0)
        extra = 1 + _mod(hd >> 4, torch.clamp(q1 * L, min=1))
        deliv = torch.where(drop, deliv + extra, deliv)
        inw = (a0 <= deliv) & (deliv < a1)
        deliv = torch.where((fa == KILL) & rb & inw, a1, deliv)
        inw = (a0 <= deliv) & (deliv < a1)
        deliv = torch.where((fa == PAUSE) & rb & inw, a1, deliv)
        roll = (fa == CORRUPT) & rb & (keym[:, :, None] == q0) \
            & (a0 - q1 * L <= deliv) & (deliv < a0)
        deliv = torch.where(roll, a0 + 1, deliv).to(i32)
    big = zero + _BIG
    local = narr[None, None, :] == sendm[:, :, None]
    deliv = torch.where(local, effm[:, :, None], deliv)
    deliv = torch.where(vapp[:, :, None], deliv, big)

    deliv_t = deliv.permute(0, 2, 1)
    dsel = torch.gather(deliv_t, 1, sendm[:, :, None].long().expand(
        S, Mtot, Mtot))
    e_r = effm[:, :, None]
    vis = (dsel < e_r) | ((dsel == e_r) & (marr[None, :] < marr[:, None]))
    inv = vapp[:, None, :] & keyeq & ~vis
    minpos = torch.where(inv, pos[:, None, :], big).amin(dim=2)
    total = (vapp[:, None, :] & keyeq).sum(dim=2).to(i32)
    rlen = torch.minimum(minpos, total)

    neg = zero - 1
    return {
        "coord": coord.to(i32),
        "failed": failm.reshape(S, St, L)[:, :, 0].contiguous(),
        "kind": kindm.reshape(S, St, L).to(i32),
        "key": keym.reshape(S, St, L).to(i32),
        "eff": effm.reshape(S, St, L),
        "pos": torch.where(vapp, pos, neg).reshape(S, St, L),
        "rlen": torch.where(vread, rlen, neg).reshape(S, St, L),
    }


# -- the kernel ----------------------------------------------------------

_SIG = {
    "sim_launch": ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 7
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
                   ctypes.c_int),
}


def smem_bytes(spec: SimSpec) -> int:
    """Dynamic shared memory of one block (csrc/sim.cu's `layout`): four
    int4 rule rows a fault slot, 36 bytes a mop (its 64-bit entry, five
    words and two entry words), a header of 4 words, 32 bucket counts and
    starts, 3 words a txn slot and a delivery time an (entry, node)."""
    M = spec.slots * spec.mops
    return (64 * spec.faults + 36 * M + 4 * (4 + 2 * 32)
            + 12 * spec.slots + 4 * M * spec.nodes)


def block_threads(spec: SimSpec, clusters: int, sms: int) -> int:
    """Threads of one block for a launch of `clusters` on a card of
    `sms` SMs: THREADS when set; else MAX_THREADS while the launch holds
    at most LATENCY_CLUSTERS_PER_SM clusters an SM (idle SMs: the most
    threads shorten the chain), one a pair of mops from
    THROUGHPUT_CLUSTERS_PER_SM an SM (fewer idle lanes, more blocks
    resident), one a mop between; rounded up to a warp, at most
    MAX_THREADS."""
    if THREADS is not None:
        return THREADS
    if clusters <= LATENCY_CLUSTERS_PER_SM * sms:
        return MAX_THREADS
    mops = spec.slots * spec.mops
    if clusters >= THROUGHPUT_CLUSTERS_PER_SM * sms:
        mops = -(-mops // 2)
    return min(MAX_THREADS, -(-mops // 32) * 32)


def build(device=None):
    """The kernel's library for `device` (None = the current CUDA
    device), built from csrc/sim.cu at first use; raises
    _build.BuildError with nvcc's stderr when the build fails."""
    from ..ops import _build

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the sim kernel builds for a CUDA device")
    return _build.load("sim", torch.cuda.get_device_capability(dev), _SIG)


def sim(scheds: torch.Tensor, wseeds: torch.Tensor,
        spec: SimSpec = DEFAULT_SPEC) -> dict:
    """The cluster batch (see sim_plain) in one launch of the kernel on
    CUDA tensors, one block of `block_threads` threads a cluster;
    the plain version on CPU tensors. Raises KernelError when the launch
    fails and ValueError when a cluster's shared memory passes
    SMEM_LIMIT."""
    global LAUNCHES
    if scheds.dtype != torch.int32 or scheds.dim() != 3 \
            or tuple(scheds.shape[1:]) != (spec.faults, 6) \
            or not scheds.is_contiguous():
        raise ValueError(f"scheds must be contiguous [S, {spec.faults}, 6] "
                         "int32")
    if wseeds.dtype != torch.int32 or tuple(wseeds.shape) \
            != (scheds.shape[0],) or wseeds.device != scheds.device:
        raise ValueError("wseeds must be [S] int32 beside scheds")
    if scheds.device.type == "cpu":
        return sim_plain(scheds, wseeds, spec)
    if scheds.device.type != "cuda":
        raise ValueError(f"unsupported device {scheds.device}")
    smem = smem_bytes(spec)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a cluster of {spec} needs {smem} bytes of shared "
                         f"memory, past {SMEM_LIMIT}")
    dev = scheds.device
    S, St, L = scheds.shape[0], spec.slots, spec.mops
    with torch.cuda.device(dev):
        lib = build(dev)
        out = {name: torch.empty((S, St) if name in ("coord", "failed")
                                 else (S, St, L),
                                 dtype=torch.bool if name == "failed"
                                 else torch.int32, device=dev)
               for name in OUTPUTS}
        stream = torch.cuda.current_stream(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        threads = block_threads(spec, S, sms)
        ev = None
        if TIMED is not None:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(stream)
        rc = lib.sim_launch(
            scheds.data_ptr(), wseeds.data_ptr(), S, spec.nodes, spec.keys,
            spec.txns, spec.mops, spec.faults, St, spec.audit_t0,
            *(out[name].data_ptr() for name in OUTPUTS), smem, threads,
            stream.cuda_stream)
        if rc != 0:
            raise KernelError(f"sim kernel launch failed: cudaError {rc}")
        if ev is not None:
            ev[1].record(stream)
            TIMED.append(ev)
        LAUNCHES += 1
    return out


# -- the batch entry point ------------------------------------------------

def _as_batch(scheds, wseeds, spec: SimSpec):
    scheds = np.asarray(scheds, dtype=np.int32)
    if scheds.ndim == 2:
        scheds = scheds[None]
    if scheds.shape[1:] != (spec.faults, 6):
        raise ValueError(f"schedule batch shape {scheds.shape}")
    wseeds = np.atleast_1d(np.asarray(wseeds, dtype=np.int64))
    if wseeds.shape[0] != scheds.shape[0]:
        raise ValueError("wseeds/scheds batch mismatch")
    # fold to non-negative 31-bit — the hash's seed lane width
    wseeds = (wseeds & 0x7FFFFFFF).astype(np.int32)
    return scheds, wseeds


def _split(out: dict, n: int) -> list:
    return [{k: np.asarray(v[i]) for k, v in out.items()} for i in range(n)]


def simulate_batch(scheds, wseeds, spec: SimSpec = DEFAULT_SPEC,
                   engine: str | None = None, device=None) -> list:
    """Simulate a batch of clusters; one result dict a cluster (numpy
    int32/bool arrays): coord [slots], failed [slots],
    kind/key/eff/pos/rlen [slots, mops].

    engine None: the kernel on the card (`device` None = CUDA, raising
    without it), or its plain version with device="cpu"; engine "host":
    the plain version on the CPU, whatever `device` says."""
    scheds = np.asarray(scheds, dtype=np.int32)
    if scheds.ndim == 2:
        scheds = scheds[None]
    scheds = np.stack([canonicalize(s, spec) for s in scheds])
    if engine not in (None, "host"):
        raise ValueError(f"unknown sim engine: {engine}")
    dev = torch.device("cpu") if engine == "host" else resolve(device)
    scheds, wseeds = _as_batch(scheds, wseeds, spec)
    out = sim(torch.from_numpy(scheds).to(dev),
              torch.from_numpy(wseeds).to(dev), spec)
    return _split({k: v.cpu().numpy() for k, v in out.items()},
                  scheds.shape[0])
