"""Transitive closure by boolean repeated squaring on the card: the
port's counterpart of K3, the JAX package's XLA closure engine
(`jepsen_tpu/ops/closure_tpu.py`, single-device path).

Reachability over a dependency adjacency matrix is the fixpoint of
R <- R | (R.R > 0). As in the JAX package the loop state is a *packed*
bit matrix (`_pack`: bit b of word w of a row is column 32*w + b, words
stored as int32), matrices are padded to a power of two (at least
MIN_PAD = 32) with all-zero rows and columns, which create and destroy
no path, and `reach_batch` stacks the matrices of one pad size into one
batched fixpoint of at most `max(1, p.bit_length())` rounds
(ceil(log2 p) squarings reach every path; one more observes the
fixpoint), leaving early once a round changes nothing.

The kernels (csrc/closure.cu), each behind a wrapper that launches it
for a CUDA tensor or raises, and runs its plain PyTorch version (same
name + `_plain`, same bit order, same rounds) for a CPU tensor:

    closure_word        the one-word bucket (p == 32): the whole fixpoint
                        in one launch, a warp per matrix
    unpack              packed words -> 0/1 bf16 [b, p, p]
    or_threshold_pack   words | pack(prod > 0), and a device flag raised
                        when a word changed; it also rewrites the 8
                        values of every byte that gained bits in
                        `operand`, the bf16 matrix the product read, so
                        the operand leaves equal to unpack(new words)
                        (the plain version also runs without one)

A bucket's fixpoint unpacks its words once; each round is then the
product, `torch.matmul` of the bf16 operand with itself (the JAX package
leaves it to XLA's matmul too), and one threshold pass that refreshes
the operand in place for the next round. The product sums in fp32 and
rounds the output to bf16, and a sum of 0/1 products is zero only when
every term is, while rounding a count >= 1 to bf16 never makes it 0, so
`> 0` on the rounded product is the boolean product exactly. The
closure only sets bits, so the refresh writes only where a round added
some, and the round that observes the fixpoint writes no operand byte.
The fixpoint reads the flag once a round (at most `p.bit_length()` host
syncs a bucket), resetting it on the device first. Every launch, the
product included, goes on `torch.cuda.current_stream(dev)`: a kernel
on another stream would race the product.

Closures are irreflexive-path closures, as in the host engine:
out[i, j] iff a path i -> ... -> j of >= 1 edge exists, so the diagonal
marks nodes on cycles.

Over several devices (`reach_batch(..., devices=[...])`, the port of
`closure_tpu._closure_block_mesh`, the block-row sharded squaring): a
bucket's rows are padded with zero rows to D shards of `shard_rows(p,
D)` rows each (JAX's multiple of D, rounded up so that a shard's words
of one matrix are whole tiles of closure.cu); zero rows create and
destroy no path. Unlike the JAX package the batch is not padded to a
power of two: that pad only spares jit a trace a batch size. Each
shard keeps its rows' words and their bf16 operand on its device, and a
round is, on every shard: gather every shard's words onto its device in
shard order, unpack them (the full operand changes on every shard, so it
is unpacked again each round), the product of the local operand with
the full one, and the threshold pass on the local rows, refreshing the
local operand in place and raising the shard's flag. The host ORs the
flags (the JAX package's psum); the round cap and the early exit are
the single-device path's, and one loop (`_squaring`) runs both. A
device may repeat in the list, and the one-word bucket takes this path
too, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
import time

import numpy as np
import torch

from .. import device as device_mod
from ..device import KernelError, resolve
from . import MIN_PAD, pad_size

#: launches on CUDA tensors so far: of each kernel, and of the product
#: (counted under _COUNTING: checkers launch from many threads at once,
#: e.g. one a key under independent.checker)
LAUNCHES = {"closure_word": 0, "unpack": 0, "or_threshold_pack": 0,
            "matmul": 0}
_COUNTING = threading.Lock()
#: when a list, every launch on the card appends (name, start, end), its
#: CUDA events
TIMED: list | None = None
#: when a list, every bucket's fixpoint appends (words0, p, rounds): its
#: packed input (a copy), pad size and round cap, so a caller can replay
#: exactly the closures a check ran
CAPTURE: list | None = None

# elements a plain version converts at once (bounds its int64 scratch)
_PLAIN_CHUNK = 1 << 24
# words a tile of closure.cu's unpack and threshold pass: a launch takes
# a multiple of it
TILE_WORDS = 32


class DeadlineExpired(RuntimeError):
    """The caller's deadline passed before every bucket was closed."""


def rounds_for(p: int) -> int:
    """The round cap of a pad bucket (closure_tpu._closure_block)."""
    return max(1, p.bit_length())


# ---------------------------------------------------------------------------
# Host packing: bool matrices <-> the packed layout

def _pack(mats, p: int) -> np.ndarray:
    """[b, p, p//32] int32 words of the bool matrices `mats` (each at most
    p x p), padded with zeros: np.packbits' little bit order puts column
    8*j + k at bit k of byte j, and four bytes read as a little-endian
    word give bit 8*q + k of word w for column 32*w + 8*q + k."""
    out = np.zeros((len(mats), p, p // 8), dtype=np.uint8)
    for j, a in enumerate(mats):
        n = a.shape[0]
        if n:
            bits = np.packbits(a, axis=1, bitorder="little")
            out[j, :n, :bits.shape[1]] = bits
    return out.view("<i4")


def _unpack(words: np.ndarray, n: int) -> np.ndarray:
    """The top-left n x n bool matrix of one packed [p, p//32] matrix."""
    by = np.ascontiguousarray(words[:n]).view(np.uint8)
    return np.unpackbits(by, axis=1, count=n, bitorder="little").astype(bool)


# ---------------------------------------------------------------------------
# Plain PyTorch versions

def _rows(t: torch.Tensor, width: int):
    """(start, end) row ranges of `t` holding at most _PLAIN_CHUNK
    elements of `width` each."""
    step = max(1, _PLAIN_CHUNK // width)
    for s in range(0, t.shape[0], step):
        yield s, min(t.shape[0], s + step)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., c] bool -> [..., c//32] int32 words (bit k of word w is
    column 32*w + k; bit 31 lands in the sign, as the kernel's uint32
    read as int32)."""
    *lead, c = bits.shape
    flat = bits.reshape(-1, c // 32, 32)
    out = torch.empty(flat.shape[:2], dtype=torch.int32, device=bits.device)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    for s, e in _rows(flat, c):
        w = (flat[s:e].to(torch.int64) << shifts).sum(-1)
        out[s:e] = ((w ^ 2**31) - 2**31).to(torch.int32)
    return out.reshape(*lead, c // 32)


def closure_word_plain(words: torch.Tensor, rounds: int):
    """The one-word bucket's fixpoint: `words` [b, 32] int32, row i one
    word; a round ORs into row i every row k whose bit is set in row i.
    Returns (words [b, 32], rounds each matrix ran [b] int32), a matrix
    stopping after the first round that changes it no more."""
    _check_word(words)
    w = words.clone()
    b = w.shape[0]
    taken = torch.zeros(b, dtype=torch.int32, device=w.device)
    active = torch.ones(b, dtype=torch.bool, device=w.device)
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    for _ in range(rounds):
        sel = ((w[:, :, None] >> shifts) & 1).bool()  # [b, row i, bit k]
        prod = torch.zeros_like(w)
        for k in range(32):
            prod |= torch.where(sel[:, :, k], w[:, k:k + 1], 0)
        nxt = w | prod
        taken += active.to(torch.int32)
        # a matrix that stopped is a fixpoint: nxt equals w there
        active &= (nxt != w).any(1)
        w = nxt
        if not bool(active.any()):
            break
    return w, taken


def unpack_plain(words: torch.Tensor, p: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """[b, r, p//32] int32 words -> [b, r, p] bf16 0/1."""
    _check_words(words, p)
    out = _out(out, (*words.shape[:2], p), torch.bfloat16, words.device)
    w = words.reshape(-1, p // 32)
    o = out.view(-1, p)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    for s, e in _rows(w, p):
        o[s:e] = ((w[s:e, :, None] >> shifts) & 1).reshape(e - s, p) \
            .to(torch.bfloat16)
    return out


def _refresh_plain(operand: torch.Tensor, old: torch.Tensor,
                   new: torch.Tensor, p: int) -> None:
    """The 8 bf16 values of `operand` under every byte of `new` that
    differs from that byte of `old`, rewritten from the new byte; the
    rest of `operand` left as it was."""
    ob = old.view(torch.uint8).reshape(-1, p // 8)
    nb = new.view(torch.uint8).reshape(-1, p // 8)
    op = operand.view(-1, p // 8, 8)
    shifts = torch.arange(8, dtype=torch.int32, device=old.device)
    for s, e in _rows(ob, p):
        vals = ((nb[s:e, :, None].to(torch.int32) >> shifts) & 1) \
            .to(torch.bfloat16)
        op[s:e] = torch.where((ob[s:e] != nb[s:e])[..., None], vals, op[s:e])


def or_threshold_pack_plain(prod: torch.Tensor, words: torch.Tensor,
                            flag: torch.Tensor,
                            out: torch.Tensor | None = None,
                            operand: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """words | pack(prod > 0), into `out` (which may be `words`); sets
    `flag` ([1] int32) to 1 when a word changed, else leaves it. Given
    `operand` (bf16 [b, p, p], the matrix the product read), rewrites its
    8 values under each byte of the words that gained bits from the new
    byte, and nothing else there."""
    p = prod.shape[-1]
    _check_otp(prod, words, flag, p, operand)
    new = words | pack_bits(prod > 0)
    changed = (new != words).any().to(torch.int32).reshape(1)
    flag.copy_(torch.maximum(flag, changed))
    if operand is not None:
        _refresh_plain(operand, words, new, p)
    out = _out(out, words.shape, torch.int32, words.device)
    out.copy_(new)
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers

_SIG = {
    "closure_word_launch": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
        ctypes.c_int),
    "closure_unpack_launch": (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int),
    "closure_or_threshold_pack_launch": (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p],
        ctypes.c_int),
}


def build(device=None):
    """The kernels' library for `device` (None = the current CUDA
    device), built from csrc/closure.cu at first use; raises
    _build.BuildError with nvcc's stderr when the build fails."""
    from . import _build

    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the closure kernels build for a CUDA device")
    return _build.load("closure", torch.cuda.get_device_capability(dev),
                       _SIG)


def _out(out, shape, dtype, device) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {device}")
    return out


def _check_word(words) -> None:
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != 32 or not words.is_contiguous():
        raise ValueError("closure_word takes contiguous [b, 32] int32 words")


def _check_words(words, p: int) -> None:
    """Words of a bucket of pad size p: [b, r, p/32] int32, contiguous;
    r is p for whole matrices and a shard's row count under a mesh."""
    if p < MIN_PAD or p & (p - 1):
        raise ValueError(f"pad size {p} is not a power of two >= {MIN_PAD}")
    if words.dtype != torch.int32 or words.dim() != 3 \
            or words.shape[1] < 1 or words.shape[2] != p // 32 \
            or not words.is_contiguous():
        raise ValueError(f"words must be contiguous [b, r, {p // 32}] "
                         f"int32, got {words.dtype} {tuple(words.shape)}")


def _check_otp(prod, words, flag, p: int, operand=None) -> None:
    _check_words(words, p)
    for name, m in (("prod", prod), ("operand", operand)):
        if m is not None and (
                m.dtype != torch.bfloat16
                or tuple(m.shape) != (*words.shape[:2], p)
                or not m.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous bf16 "
                             f"[b, r, p] tensor")
    if flag.dtype != torch.int32 or tuple(flag.shape) != (1,):
        raise ValueError("flag must be one int32")
    if not prod.device == words.device == flag.device:
        raise ValueError("prod, words and flag on different devices")
    if operand is not None and (operand.device != words.device
                                or operand.data_ptr() == prod.data_ptr()):
        raise ValueError("operand must be on the words' device, apart "
                         "from prod")


@contextlib.contextmanager
def _launch(name: str, dev):
    """Around one launch on the card: the current stream's handle, CUDA
    events into TIMED when it is a list, and the launch count."""
    stream = torch.cuda.current_stream(dev)
    if TIMED is not None:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(stream)
    yield stream.cuda_stream
    if TIMED is not None:
        ev[1].record(stream)
        TIMED.append((name, *ev))
    _count(name)


def _count(name: str) -> None:
    """One more launch of `name` (a read-modify-write: under the lock)."""
    with _COUNTING:
        LAUNCHES[name] += 1


def _aligned(*ts) -> None:
    """The kernels move words and bf16 values 16 bytes at a time."""
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise ValueError("the closure kernels take 16-byte aligned tensors")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} kernel launch failed: cudaError {rc}")


def _cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def closure_word(words: torch.Tensor, rounds: int):
    """The one-word bucket's fixpoint (see closure_word_plain) in one
    launch on a CUDA tensor; the plain version on a CPU tensor."""
    _check_word(words)
    if not _cuda(words):
        return closure_word_plain(words, rounds)
    dev = words.device
    with torch.cuda.device(dev):
        lib = build(dev)
        out = torch.empty_like(words)
        taken = torch.empty(words.shape[0], dtype=torch.int32, device=dev)
        with _launch("closure_word", dev) as stream:
            _raise_on(lib.closure_word_launch(
                words.data_ptr(), out.data_ptr(), taken.data_ptr(),
                words.shape[0], rounds, stream), "closure_word")
    return out, taken


def unpack(words: torch.Tensor, p: int,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Packed [b, r, p//32] int32 words -> 0/1 bf16 [b, r, p] (into
    `out` when given): the kernel on a CUDA tensor, the plain version on
    a CPU tensor. On the card a launch takes whole tiles: b*r*p/32 a
    multiple of TILE_WORDS."""
    _check_words(words, p)
    if not _cuda(words):
        return unpack_plain(words, p, out)
    dev = words.device
    out = _out(out, (*words.shape[:2], p), torch.bfloat16, dev)
    _aligned(words, out)
    with torch.cuda.device(dev):
        lib = build(dev)
        with _launch("unpack", dev) as stream:
            _raise_on(lib.closure_unpack_launch(
                words.data_ptr(), out.data_ptr(), words.numel(), stream),
                "unpack")
    return out


def or_threshold_pack(prod: torch.Tensor, words: torch.Tensor,
                      flag: torch.Tensor,
                      out: torch.Tensor | None = None,
                      operand: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """words | pack(prod > 0) into `out` (None: a new tensor; it may be
    `words` itself), raising `flag` when a word changed, and with
    `operand` refreshing it in place to unpack(new words) (see
    or_threshold_pack_plain): the kernel on CUDA tensors, the plain
    version on CPU tensors. The kernel always refreshes an operand: on
    CUDA tensors `operand` is required (ValueError without it)."""
    p = prod.shape[-1]
    _check_otp(prod, words, flag, p, operand)
    if not _cuda(words):
        return or_threshold_pack_plain(prod, words, flag, out, operand)
    if operand is None:
        raise ValueError("or_threshold_pack on the card takes the operand "
                         "the product read")
    dev = words.device
    out = _out(out, words.shape, torch.int32, dev)
    _aligned(prod, words, out, operand)
    with torch.cuda.device(dev):
        lib = build(dev)
        with _launch("or_threshold_pack", dev) as stream:
            _raise_on(lib.closure_or_threshold_pack_launch(
                prod.data_ptr(), words.data_ptr(), out.data_ptr(),
                flag.data_ptr(), operand.data_ptr(), words.numel(),
                stream), "or_threshold_pack")
    return out


def matmul(m: torch.Tensor, out: torch.Tensor | None = None,
           rhs: torch.Tensor | None = None) -> torch.Tensor:
    """The round's product of the bf16 0/1 operand: m.m, or m.rhs under a
    mesh (a shard's rows times the full operand); torch.matmul, counted
    and timed on the card like the kernels."""
    rhs = m if rhs is None else rhs
    if not _cuda(m):
        return torch.matmul(m, rhs, out=out)
    with _launch("matmul", m.device):
        return torch.matmul(m, rhs, out=out)


# ---------------------------------------------------------------------------
# The fixpoint

def closure_block(words0: torch.Tensor, p: int) -> torch.Tensor:
    """The closure of one pad bucket, [b, p, p//32] int32 packed (the
    kernels on a CUDA tensor, their plain versions on a CPU one).
    Returns the closed words; `words0` is left as it was."""
    _check_words(words0, p)
    rounds = rounds_for(p)
    if CAPTURE is not None:
        CAPTURE.append((words0.clone(), p, rounds))
    if p == MIN_PAD:
        out, _ = closure_word(words0.view(-1, 32), rounds)
        return out.view(words0.shape)
    words = words0.clone()
    _squaring([words], p, rounds, unpack, or_threshold_pack)
    return words


def closure_block_plain(words0: torch.Tensor, p: int):
    """closure_block through the plain versions on any device. Returns
    (closed words, rounds run: a [b] tensor in the one-word bucket, an
    int otherwise)."""
    _check_words(words0, p)
    rounds = rounds_for(p)
    if p == MIN_PAD:
        out, taken = closure_word_plain(words0.view(-1, 32), rounds)
        return out.view(words0.shape), taken
    words = words0.clone()
    ran = _squaring([words], p, rounds, unpack_plain,
                    or_threshold_pack_plain)
    return words, ran


def shard_rows(p: int, d: int) -> int:
    """Rows each of `d` shards holds of a pad-p bucket: ceil(p / d), as
    closure_tpu pads to a multiple of the mesh, rounded up to whole tiles
    of one matrix's words (r * p/32 a multiple of TILE_WORDS), which
    closure.cu's launches take."""
    unit = max(1, TILE_WORDS * 32 // p)  # rows of one tile
    rows = -(-p // d)
    return -(-rows // unit) * unit


def _sync_shards(devs) -> None:
    """Every device's current stream waits for the work queued so far on
    every other's: an event recorded a shard after its gather, so no
    shard's threshold pass rewrites its rows in place before every other
    shard's copy of them is done. (torch orders a copy between two cards
    with both current streams, and on one card the stream orders it;
    the events make the order explicit whatever the copy does.)"""
    cuda = [d for d in dict.fromkeys(devs) if d.type == "cuda"]
    if len(cuda) < 2:
        return
    evs = []
    for d in cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        evs.append(ev)
    for d in cuda:
        for ev in evs:
            torch.cuda.current_stream(d).wait_event(ev)


def _squaring(shards, p: int, rounds: int, unpack_fn, otp_fn) -> int:
    """R <- R | (R.R > 0) on a bucket's words, changed in place, at most
    `rounds` rounds, stopping after the first round that changes no
    word. `shards` hold the bucket's rows, [b, r, p/32] words a device;
    one shard is the whole [b, p, p/32] bucket on one device. Each
    shard's operand is unpacked once; a round is then, on every shard,
    the product of its operand with the full one and a threshold pass
    that refreshes its operand in place for the next product. With one
    shard the full operand is its own; with several it is unpacked again
    each round from every shard's words gathered onto the shard's device
    (module docstring). The flags are ORed on the host. Returns the
    rounds run."""
    devs = [w.device for w in shards]
    flags = [torch.zeros(1, dtype=torch.int32, device=d) for d in devs]
    local = [unpack_fn(w, p) for w in shards]
    prods: list = [None] * len(shards)
    fulls: list = [None] * len(shards)
    for t in range(rounds):
        if len(shards) > 1:
            fulls = [torch.cat([w.to(d) for w in shards], 1) for d in devs]
            _sync_shards(devs)
        for k, full in enumerate(fulls):
            rhs = None if full is None else unpack_fn(full, p)[:, :p]
            prods[k] = matmul(local[k], out=prods[k], rhs=rhs)
            flags[k].zero_()
            otp_fn(prods[k], shards[k], flags[k], out=shards[k],
                   operand=local[k])
        if not any([int(f.item()) for f in flags]):
            return t + 1
    return rounds


def _mesh_shards(words0: torch.Tensor, p: int, devs) -> list:
    """The bucket's words [b, p, p/32] padded with zero rows to
    len(devs) * shard_rows rows, cut into one contiguous [b, r, p/32]
    shard a device. (The JAX package also pads the batch to a power of
    two, so that jit does not trace again for each batch size; the port
    has no such cache and keeps the batch as it is.)"""
    _check_words(words0, p)
    b, c = words0.shape[0], p // 32
    r = shard_rows(p, len(devs))
    padded = words0.new_zeros((b, len(devs) * r, c))
    padded[:, :p] = words0
    shards = []
    for k, d in enumerate(devs):
        w = torch.empty((b, r, c), dtype=torch.int32, device=d)
        w.copy_(padded[:, k * r:(k + 1) * r])
        shards.append(w)
    return shards


def _mesh_gather(shards, p: int, dev) -> torch.Tensor:
    """The closed words back as [b, p, p/32] on `dev`."""
    full = torch.cat([w.to(dev) for w in shards], 1)
    return full[:, :p].contiguous()


def _closure_block_mesh(words0: torch.Tensor, p: int, devices
                        ) -> torch.Tensor:
    """closure_block with the bucket's rows dealt over `devices` (two or
    more; a device may repeat): the kernels on CUDA devices, the plain
    versions on the CPU. Returns the closed words [b, p, p/32] on the
    first device; `words0` is left as it was."""
    devs = device_mod.devices(devices)
    rounds = rounds_for(p)
    if CAPTURE is not None:
        CAPTURE.append((words0.clone(), p, rounds))
    shards = _mesh_shards(words0, p, devs)
    _squaring(shards, p, rounds, unpack, or_threshold_pack)
    return _mesh_gather(shards, p, devs[0])


def _closure_block_mesh_plain(words0: torch.Tensor, p: int, devices):
    """_closure_block_mesh through the plain versions on any devices.
    Returns (closed words, rounds run)."""
    devs = device_mod.devices(devices)
    shards = _mesh_shards(words0, p, devs)
    ran = _squaring(shards, p, rounds_for(p), unpack_plain,
                    or_threshold_pack_plain)
    return _mesh_gather(shards, p, devs[0]), ran


def _reach(adjs, dev, block, budget, on_closed=None) -> list:
    adjs = [np.asarray(a, dtype=bool) for a in adjs]
    for a in adjs:
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"adjacency must be square, got {a.shape}")
    out: list = [None] * len(adjs)
    buckets: dict = {}
    for i, a in enumerate(adjs):
        if a.shape[0] == 0:
            out[i] = np.zeros((0, 0), dtype=bool)
            continue
        buckets.setdefault(pad_size(a.shape[0]), []).append(i)
    for p, idxs in sorted(buckets.items()):
        if budget is not None and time.monotonic() >= budget:
            raise DeadlineExpired(
                f"deadline passed before the pad-{p} bucket's closure")
        words0 = torch.from_numpy(_pack([adjs[i] for i in idxs], p)).to(dev)
        closed = block(words0, p).cpu().numpy()
        for j, i in enumerate(idxs):
            out[i] = _unpack(closed[j], adjs[i].shape[0])
            if on_closed is not None:
                on_closed(i, out[i])
    return out


def reach_batch(adjs, device=None, budget: float | None = None,
                on_closed=None, devices=None) -> list:
    """Closure of each bool adjacency matrix in `adjs`, aligned with the
    input. Matrices are bucketed by pad size, each bucket one batched
    fixpoint through the kernels (device None = CUDA, raising when it is
    absent; "cpu" runs the plain versions). `budget` is an absolute
    time.monotonic() deadline, checked before each bucket: past it this
    raises DeadlineExpired. `on_closed(i, closure)` is called for each
    matrix as its bucket completes (before a later bucket's deadline
    can raise). `devices` (a list for `device.devices`, not with
    `device`) shards every bucket's rows over those devices when it
    names two or more (`_closure_block_mesh`); a one-device list is the
    single-device path on that device."""
    if device is not None and devices is not None:
        raise ValueError("give device or devices, not both")
    if devices is None:
        return _reach(adjs, resolve(device), closure_block, budget,
                      on_closed)
    devs = device_mod.devices(devices)
    if len(devs) < 2:
        return _reach(adjs, devs[0], closure_block, budget, on_closed)
    # the packed words stay on the host until they are sharded
    return _reach(adjs, torch.device("cpu"),
                  lambda w, p: _closure_block_mesh(w, p, devs), budget,
                  on_closed)


def reach_batch_mesh(adjs, devices=None, budget: float | None = None,
                     on_closed=None) -> list:
    """reach_batch over `devices` (None: every CUDA device; the JAX
    package's `closure_mesh` engine)."""
    return reach_batch(adjs, budget=budget, on_closed=on_closed,
                       devices=device_mod.devices(devices))


def reach_batch_plain(adjs, device="cpu") -> list:
    """reach_batch through the plain versions on `device`."""
    return _reach(adjs, resolve(device),
                  lambda w, p: closure_block_plain(w, p)[0], None)


def reach(adj: np.ndarray, device=None) -> np.ndarray:
    """Irreflexive-path closure of one bool adjacency matrix."""
    return reach_batch([adj], device=device)[0]


def probe(device=None) -> bool:
    """A 2-cycle inside one pad bucket, closed on `device`."""
    a = np.zeros((3, 3), dtype=bool)
    a[0, 1] = a[1, 0] = True
    r = reach(a, device=device)
    return bool(r[0, 0] and r[0, 1] and not r[2, 2])


def probe_mesh(devices=None) -> bool:
    """A ring of 2*MIN_PAD + 5 nodes (past the one-word bucket, uneven
    against the device count) closed over `devices` (None: every CUDA
    device) and on the first of them alone: equal, and every node on
    the cycle (closure_tpu.probe_mesh)."""
    devs = device_mod.devices(devices)
    n = 2 * MIN_PAD + 5
    a = np.zeros((n, n), dtype=bool)
    a[np.arange(n), (np.arange(n) + 1) % n] = True
    (r,) = reach_batch([a], devices=devs)
    (s,) = reach_batch([a], device=devs[0])
    return bool(np.array_equal(r, s) and r[0, 0])
