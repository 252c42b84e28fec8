"""Long-fork anomaly workload checker (parallel snapshot isolation; the
port's copy of the checking half of `jepsen_tpu/workloads/long_fork.py`;
reference: jepsen/src/jepsen/tests/long_fork.clj:1-332): single-key
write transactions plus multi-key group reads; a long fork exists when
two reads observe a pair of writes in conflicting orders.

Transactions are sequences of [f, k, v] micro-ops (`txn`). Every key is
written at most once, so per-key states move nil -> v and read
snapshots within a key group form a partial order by domination; the
checker verifies this order is total.

Checking routes through the transactional cycle checker
(checker/cycle) on the card: a long fork is a dependency cycle with two
anti-dependency edges, so the pairwise-domination test reduces to cycle
detection under write-once rw-register inference. The vectorized
all-pairs comparator (find_forks) runs behind checker(n, legacy=True).
The generator (`LongForkGen`) is not ported (the port has no
`generator.py`).
"""

from __future__ import annotations

import random

import numpy as np

from .. import txn as mop
from ..checker import Checker
from ..history import ops as _ops


class IllegalHistory(Exception):
    """This history can't be checked — reads are malformed
    (long_fork.clj:163-175,253-258)."""

    def __init__(self, msg, **info):
        super().__init__(msg)
        self.info = {"msg": msg, **info}


_MSG_KEY_MISMATCH = (
    "These reads did not query for the same keys, and therefore cannot "
    "be compared."
)
_MSG_DISTINCT_VALUES = (
    "These two read states contain distinct values for the same key; "
    "this checker assumes only one write occurs per key."
)


def group_for(n: int, k: int) -> range:
    """The key group containing k: [k - k%n, k - k%n + n)
    (long_fork.clj:97-104)."""
    lower = k - (k % n)
    return range(lower, lower + n)


def read_txn_for(n: int, k: int) -> list:
    """A transaction reading k's whole group in shuffled order
    (long_fork.clj:106-112)."""
    ks = list(group_for(n, k))
    random.shuffle(ks)
    return [[mop.READ, k, None] for k in ks]


def read_op_to_value_map(op) -> dict:
    """{key: value} for a read op (long_fork.clj:198-206)."""
    return {mop.key(m): mop.value(m) for m in op.value}


def find_forks(ops) -> list:
    """All mutually-incomparable pairs among a group's reads, via a
    vectorized all-pairs domination test (long_fork.clj:216-224)."""
    ops = list(ops)
    m = len(ops)
    if m < 2:
        return []
    maps = [read_op_to_value_map(o) for o in ops]
    keys = sorted(maps[0].keys())
    # Uniform key sets + one-write-per-key are preconditions; verify via
    # the scalar comparator's error paths when they don't hold.
    vals = np.empty((m, len(keys)), dtype=object)
    for i, vm in enumerate(maps):
        if set(vm.keys()) != set(keys):
            raise IllegalHistory(_MSG_KEY_MISMATCH, reads=[maps[0], vm])
        vals[i] = [vm[k] for k in keys]
    nil = np.equal(vals, None)
    for j, k in enumerate(keys):
        col = vals[~nil[:, j], j]
        if len(set(col.tolist())) > 1:
            rows = np.flatnonzero(~nil[:, j])[:2]
            raise IllegalHistory(
                _MSG_DISTINCT_VALUES,
                key=k,
                reads=[maps[int(rows[0])], maps[int(rows[-1])]],
            )
    # i strictly ahead of j on some key AND j strictly ahead of i on
    # another => incomparable
    ahead = (~nil[:, None, :] & nil[None, :, :]).any(axis=-1)
    fork_at = np.triu(ahead & ahead.T, k=1)
    return [
        [ops[i], ops[j]] for i, j in zip(*np.nonzero(fork_at))
    ]


def is_read_txn(txn) -> bool:
    return all(mop.is_read(m) for m in txn)


def is_write_txn(txn) -> bool:
    return len(txn) == 1 and mop.is_write(txn[0])


def is_legal_txn(txn) -> bool:
    return is_read_txn(txn) or is_write_txn(txn)


def op_read_keys(op) -> tuple:
    """The keys a read op observed, as a canonical sorted tuple
    (long_fork.clj:243-246)."""
    return tuple(sorted(mop.key(m) for m in op.value))


def groups(n: int, read_ops) -> list:
    """Partition reads by key group; each group must read exactly n keys
    (long_fork.clj:248-261)."""
    by_group: dict = {}
    for op in read_ops:
        by_group.setdefault(op_read_keys(op), []).append(op)
    out = []
    for group, ops in by_group.items():
        if len(set(group)) != n:
            raise IllegalHistory(
                f"Every read in this history should have observed exactly "
                f"{n} keys, but this read observed {len(set(group))} "
                f"instead: {group!r}",
                op=ops[0],
            )
        out.append(ops)
    return out


def ensure_no_long_forks(n: int, reads) -> dict | None:
    forks = [f for g in groups(n, reads) for f in find_forks(g)]
    if forks:
        return {"valid": False, "forks": forks}
    return None


def ensure_no_multiple_writes_to_one_key(history) -> dict | None:
    """valid=unknown if any key is written twice (long_fork.clj:273-288)."""
    seen = set()
    for op in history:
        if op.is_invoke and is_write_txn(op.value or []):
            k = mop.key(op.value[0])
            if k in seen:
                return {"valid": "unknown", "error": ["multiple-writes", k]}
            seen.add(k)
    return None


def reads(history) -> list:
    """All ok pure-read ops (long_fork.clj:290-295)."""
    return [o for o in history if o.is_ok and is_read_txn(o.value or [])]


def early_reads(read_ops) -> list:
    """Reads observing only nils — too early to signify
    (long_fork.clj:297-302)."""
    return [
        o.value
        for o in read_ops
        if all(mop.value(m) is None for m in o.value)
    ]


def late_reads(read_ops) -> list:
    """Reads observing every key written — too late to signify
    (long_fork.clj:304-309)."""
    return [
        o.value
        for o in read_ops
        if all(mop.value(m) is not None for m in o.value)
    ]


class LongForkChecker(Checker):
    """No key written twice; no pair of reads observing conflicting write
    orders (long_fork.clj:311-324).

    The default path routes through the transactional cycle checker
    (checker/cycle): every key is written once, so rw-register
    inference under the write-once order applies, and a long fork IS a
    dependency cycle — each of the two reads wr-depends on the write
    it saw and rw-precedes the write it missed, closing a cycle with
    two anti-dependencies (G2-class; any requested anomaly fails). The
    pairwise-domination comparator runs on the host behind
    legacy=True. `device` is where the cycle checker's closures run
    (None = CUDA, raising when it is absent; "cpu" the kernels' plain
    versions)."""

    def __init__(self, n: int, legacy: bool = False, device=None):
        self.n = n
        self.legacy = legacy
        self.device = device

    def check(self, test, history, opts=None) -> dict:
        history = _ops(history)
        rs = reads(history)
        out = {
            "reads-count": len(rs),
            "early-read-count": len(early_reads(rs)),
            "late-read-count": len(late_reads(rs)),
        }
        try:
            verdict = (
                ensure_no_multiple_writes_to_one_key(history)
                or (ensure_no_long_forks(self.n, rs) if self.legacy
                    else self._cycle_verdict(test, history, rs, opts))
                or {"valid": True}
            )
        except IllegalHistory as e:
            verdict = {"valid": "unknown", "error": e.info}
        out.update(verdict)
        return out

    def _cycle_verdict(self, test, history, rs, opts) -> dict | None:
        from ..checker import cycle

        # structural validation first: mismatched group sizes and
        # twice-written values are uncheckable, same as the legacy path
        groups(self.n, rs)
        r = cycle.checker(version_order="write-once",
                          device=self.device).check(test, history, opts)
        if r["valid"] is True:
            return None
        if r["valid"] is False:
            # a long fork's witness cycle alternates reads and writes;
            # the observing reads are the classic "forks" pair
            forks = [
                [o for o in w["ops"] if is_read_txn(o.value or [])]
                for ws in r["anomalies"].values() for w in ws
            ]
            return {"valid": False, "forks": forks,
                    "anomaly-types": r["anomaly-types"],
                    "anomalies": r["anomalies"]}
        return {"valid": "unknown", "error": r.get("error")}


def checker(n: int, legacy: bool = False, device=None) -> LongForkChecker:
    return LongForkChecker(n, legacy=legacy, device=device)
