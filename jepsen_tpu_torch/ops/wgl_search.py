"""Host-side parts of the WGL batch search with a probed memo: the port's
copy of what `jepsen_tpu/ops/wgl_tpu.py` (the JAX package's K2 engine)
shares with its Pallas twin `jepsen_tpu/ops/wgl_pallas.py` (K5).

- the verdict codes and default budgets (from `ops.common`), the memo
  size and its probe count;
- `encode_entries`: one lane's fixed-shape int32 arrays — node ids
  (0 is the head sentinel, the event at position p is node p+1), the
  node -> entry map and the initial linked list;
- `_zobrist_table`: one uint32 per entry, XOR-ed into the bitset hash as
  the entry linearizes and out as it backtracks;
- `pad_size`: the pow2 bucket (floor 8) a batch pads to.

Both encodings are byte-identical to the JAX package's
(tests/test_torch_wgl_row.py). `ops/wgl_row.py` packs and searches the
lanes.
"""

from __future__ import annotations

import numpy as np

from ..models import jit as mjit
from . import next_pow2
from .common import (DEFAULT_MAX_STEPS, INVALID, RUNNING,  # noqa: F401
                     UNKNOWN, VALID)

DEFAULT_CACHE_BITS = 13  # K2's memo: 8192 slots per lane
N_PROBES = 8             # linear probes per memo lookup
MIN_PAD = 8              # the smallest bucket a lane pads to


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
