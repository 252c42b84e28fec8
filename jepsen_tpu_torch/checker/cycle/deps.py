"""Dependency-graph inference from transactional histories (Elle): the
port's copy of `jepsen_tpu/checker/cycle/deps.py`.

Reference: elle.core / elle.list-append / elle.rw-register — infer,
from the observed values alone, which transactions must have depended
on which, and emit the result as dense boolean adjacency matrices the
closure engines (ops/closure.py / ops/closure_host.py) consume.

Nodes are ok transactions (one node per completed op). Relations:

  ww  write-write: T1 installed a version that T2 overwrote/extended
  wr  write-read:  T2 read the version T1 installed
  rw  read-write (anti-dependency): T1 read a version that T2 replaced
  realtime  T1's completion preceded T2's invocation (optional — only
            computed when asked for; it is dense, O(n^2) edges)

Two inference modes, chosen PER KEY by the micro-ops touching it:

* list-append (txn.APPEND mops): reads return the key's whole list, so
  the version order is recoverable exactly — it is the longest read
  list, and every other read must be a prefix of it (prefix
  consistency; violations raise IllegalInference, the history is
  uncheckable, not invalid). The writer of element i ww-precedes the
  writer of element i+1; the writer of a read's last element wr-feeds
  the reader; a reader of prefix v_1..v_i rw-precedes the writer of
  v_{i+1}; a reader of [] rw-precedes the writer of v_1. Appends never
  observed by any read get no position (and no edges) — Elle does the
  same; recoverability, not completeness, is the contract.

* rw-register (txn.WRITE/READ mops): versions are single values, so a
  version order needs an assumption, picked by `version_order`:
  "write-once" (each key written at most once — long_fork, adya) or
  "value" (writes ordered by value — the causal workload's counter
  writes 1, 2, ...). Reads of an unwritten key observe the initial
  version (None, plus anything in `init_values`).

Both modes require written values to be attributable: a value written
twice to one key, or a read of a value nobody wrote, raises
IllegalInference (checker surfaces it as valid="unknown").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ... import txn as mop
from ...history import pairs as _pairs

RELATIONS = ("ww", "wr", "rw")

_INIT = object()  # the pre-history version of a register key


class IllegalInference(Exception):
    """The history's reads don't determine a version order (non-prefix
    read, duplicate write, phantom value) — uncheckable, not invalid."""

    def __init__(self, msg, **info):
        super().__init__(msg)
        self.info = {"msg": msg, **info}


@dataclass
class DepGraph:
    """A dependency graph over the ok transactions of one history.

    ops[i] is node i's completion Op; adj maps each relation name to a
    dense [n, n] bool matrix (adj[r][i, j]: i r-precedes j)."""

    ops: list
    adj: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.ops)

    def union(self, rels) -> np.ndarray:
        """OR of the named relations' matrices."""
        n = len(self.ops)
        out = np.zeros((n, n), dtype=bool)
        for r in rels:
            m = self.adj.get(r)
            if m is not None:
                out |= m
        return out

    def edges(self, rel) -> list:
        """[(i, j), ...] for one relation (diagnostics/tests)."""
        ii, jj = np.nonzero(self.adj[rel])
        return [(int(i), int(j)) for i, j in zip(ii, jj)]

    def rels_of(self, i: int, j: int) -> list:
        """Every relation containing edge i -> j, in RELATIONS order
        (+ realtime last) — used to label witness edges."""
        order = [r for r in (*RELATIONS, "realtime") if r in self.adj]
        return [r for r in order if self.adj[r][i, j]]


# ---------------------------------------------------------------------------
# History -> micro-op transactions

def txns_of(history, key=None) -> list:
    """[(op, micro-ops), ...] for every ok op carrying a micro-op txn
    value. Register-style ops (scalar value, f in read/read-init/write)
    are lifted to single-mop txns against `key` (the independent
    history_key, or 0) so register workloads need no adapter."""
    out = []
    k = key if key is not None else 0
    for o in history:
        if not o.is_ok:
            continue
        v = o.value
        if isinstance(v, (list, tuple)) and v and all(
                mop.is_op(m) for m in v):
            out.append((o, [list(m) for m in v]))
        elif isinstance(v, (dict, list, tuple, set)):
            # aggregate payloads (e.g. bank's {account: balance}
            # snapshots) carry no attributable versions — no node
            continue
        elif o.f in ("read", "read-init"):
            out.append((o, [[mop.READ, k, v]]))
        elif o.f == "write":
            out.append((o, [[mop.WRITE, k, v]]))
    return out


# ---------------------------------------------------------------------------
# Per-key version orders

def _append_key_edges(k, appends, reads, add):
    """List-append inference for one key (elle.list-append): version
    order = the longest read list, prefix-checked against every other
    read."""
    writer = {}
    for node, v in appends:
        if v in writer:
            raise IllegalInference(
                f"value {v!r} appended to key {k!r} more than once",
                key=k, value=v)
        writer[v] = node
    longest: list = []
    for node, obs in reads:
        obs = list(obs or [])
        if len(obs) > len(longest):
            longest = obs
    order = longest
    for node, obs in reads:
        obs = list(obs or [])
        if obs != order[:len(obs)]:
            raise IllegalInference(
                f"read of key {k!r} is not a prefix of the longest "
                f"read — no total version order exists",
                key=k, read=obs, longest=order)
    for v in order:
        if v not in writer:
            raise IllegalInference(
                f"read of key {k!r} observed {v!r}, which no txn "
                f"appended", key=k, value=v)
    # ww: consecutive observed versions
    for a, b in zip(order, order[1:]):
        add("ww", writer[a], writer[b])
    for node, obs in reads:
        obs = list(obs or [])
        # wr: the read observed exactly the state the last element's
        # appender installed
        if obs:
            add("wr", writer[obs[-1]], node)
        # rw: the read missed every later version; the next one's
        # appender overwrote what it saw
        if len(obs) < len(order):
            add("rw", node, writer[order[len(obs)]])


def _register_key_edges(k, writes, reads, add, *, version_order,
                        init_values):
    """rw-register inference for one key under the `version_order`
    assumption ("write-once" or "value")."""
    vals = [v for _, v in writes]
    if len(set(vals)) != len(vals):
        dup = next(v for v in vals if vals.count(v) > 1)
        raise IllegalInference(
            f"value {dup!r} written to key {k!r} more than once — "
            f"reads cannot be attributed", key=k, value=dup)
    if version_order == "write-once":
        if len(writes) > 1:
            raise IllegalInference(
                f"key {k!r} written {len(writes)} times under the "
                f"write-once order", key=k)
        ordered = list(writes)
    elif version_order == "value":
        ordered = sorted(writes, key=lambda nv: nv[1])
    else:
        raise ValueError(f"unknown version_order {version_order!r}")
    versions = [(_INIT, None)] + [(node, v) for node, v in ordered]
    pos = {v: i for i, (_, v) in enumerate(versions) if i > 0}
    for (w1, _), (w2, _) in zip(versions[1:], versions[2:]):
        add("ww", w1, w2)
    inits = {None, *init_values}
    for node, v in reads:
        if v in inits and v not in pos:
            i = 0
        elif v in pos:
            i = pos[v]
        else:
            raise IllegalInference(
                f"read of key {k!r} observed {v!r}, which no txn "
                f"wrote", key=k, value=v)
        if i > 0:
            add("wr", versions[i][0], node)
        if i + 1 < len(versions):
            add("rw", node, versions[i + 1][0])


# ---------------------------------------------------------------------------
# Graph extraction

def extract(history, *, key=None, version_order="write-once",
            init_values=(), realtime=False) -> DepGraph:
    """Infer the dependency graph of a history's ok transactions.

    `key`, `version_order`, `init_values` parameterize txns_of and the
    register order (see module docstring). realtime=True additionally
    emits the dense realtime relation (completion-before-invocation),
    using invocation positions from history.pairs when present (bare ok
    ops — fixtures — fall back to their own index)."""
    history = list(history)
    txns = txns_of(history, key=key)
    ops = [o for o, _ in txns]
    node = {id(o): i for i, o in enumerate(ops)}
    n = len(ops)
    adj = {r: np.zeros((n, n), dtype=bool) for r in RELATIONS}

    def add(rel, i, j):
        if i is not _INIT and j is not _INIT and i != j:
            adj[rel][i, j] = True

    per_key: dict = {}
    for o, t in txns:
        i = node[id(o)]
        for m in t:
            k = mop.key(m)
            slot = per_key.setdefault(
                k, {"appends": [], "writes": [], "reads": []})
            if mop.is_append(m):
                slot["appends"].append((i, mop.value(m)))
            elif mop.is_write(m):
                slot["writes"].append((i, mop.value(m)))
            else:
                slot["reads"].append((i, mop.value(m)))
    for k, slot in per_key.items():
        # a list observation marks an append-mode key even when every
        # append to it fell outside this history slice (read-only keys
        # in a sharded or truncated run)
        reads_lists = any(isinstance(v, (list, tuple))
                          for _, v in slot["reads"])
        if slot["appends"] or reads_lists:
            if slot["writes"]:
                raise IllegalInference(
                    f"key {k!r} saw both append/list-read and write "
                    f"micro-ops", key=k)
            _append_key_edges(k, slot["appends"], slot["reads"], add)
        elif slot["writes"] or slot["reads"]:
            _register_key_edges(
                k, slot["writes"], slot["reads"], add,
                version_order=version_order, init_values=init_values)
    g = DepGraph(ops=ops, adj=adj)
    if realtime:
        g.adj["realtime"] = _realtime(history, ops, node)
    return g


def _realtime(history, ops, node) -> np.ndarray:
    """rt[i, j] iff node i's completion came before node j's
    invocation — both definitely-committed and non-overlapping."""
    n = len(ops)
    call = np.empty(n, dtype=np.int64)
    ret = np.empty(n, dtype=np.int64)
    by_completion = {}
    try:
        for p in _pairs(history):
            if p.completion is not None:
                by_completion[id(p.completion)] = p
    except ValueError:  # malformed pairing: fall back to own indices
        by_completion = {}
    for i, o in enumerate(ops):
        p = by_completion.get(id(o))
        call[i] = p.invoke.index if p is not None else o.index
        ret[i] = o.index
    return ret[:, None] < call[None, :]
