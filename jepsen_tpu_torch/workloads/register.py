"""Seeded register histories: the independent-key CAS-register workload.

`register_history` simulates clients against a real (atomic) register,
so its histories are linearizable by construction unless `corrupt` > 0,
in which case that fraction of reads return a random value. The
reference's linearizable-register test keeps each key at <= 128 ops with
a handful of clients; `keyed_history` interleaves many such keys into
one history whose values are KVTuple(key, value), the shape
`independent.checker(linearizable(...))` checks.
"""

from __future__ import annotations

import random

from ..history import Op
from ..independent import KVTuple


def register_history(n_process=3, n_ops=12, n_values=3, cas=True,
                     corrupt=0.0, seed=0) -> list[Op]:
    """A random concurrent register history of `n_ops` invocations over
    `n_process` clients (8% of completions crash as :info; CAS whose
    precondition fails records :fail). Returns indexed Ops."""
    rng = random.Random(seed)
    history = []
    t = 0
    reg = [None]
    pending = {}  # process -> (f, value, result)
    procs = list(range(n_process))
    ops_started = 0
    while ops_started < n_ops or pending:
        p = rng.choice(procs)
        if p in pending:
            f, value, result = pending.pop(p)
            if rng.random() < 0.08:
                history.append(Op(p, "info", f, value, time=t))
            else:
                history.append(Op(p, "ok", f, result, time=t))
        elif ops_started < n_ops:
            ops_started += 1
            roll = rng.random()
            if roll < 0.4:
                f, value = "read", None
                result = reg[0]
                if corrupt and rng.random() < corrupt:
                    result = rng.randrange(n_values)
            elif roll < 0.75 or not cas:
                f = "write"
                value = rng.randrange(n_values)
                reg[0] = value
                result = value
            else:
                f = "cas"
                value = (rng.randrange(n_values), rng.randrange(n_values))
                if reg[0] == value[0]:
                    reg[0] = value[1]
                    result = value
                else:
                    # a real register fails this CAS: record :fail
                    history.append(Op(p, "invoke", f, value, time=t))
                    t += 1
                    history.append(Op(p, "fail", f, value, time=t))
                    t += 1
                    continue
            history.append(Op(p, "invoke", f, value, time=t))
            pending[p] = (f, value, result)
        t += 1
    for i, o in enumerate(history):
        o.index = i
    return history


def keyed_history(n_keys, n_ops, n_process=5, n_values=3, bad_every=0,
                  bad_read="first", seed=0) -> list[Op]:
    """One history over `n_keys` independent keys, each a clean
    `register_history` of `n_ops` invocations (an int, or one int per
    key) by its own `n_process` clients (process ids are disjoint across keys), interleaved
    round-robin. In every `bad_every`-th key (0 = none) one :ok read
    returns `n_values` — a value no write ever wrote — so that key is
    certainly not linearizable. bad_read="first" plants it at the key's
    first :ok read, which the search refutes early; "random" at a read
    drawn from the seed, which may leave a deep search behind it.
    Values are KVTuple(key, value)."""
    if bad_read not in ("first", "random"):
        raise ValueError(f"bad_read must be 'first' or 'random': {bad_read!r}")
    ops = [n_ops] * n_keys if isinstance(n_ops, int) else list(n_ops)
    if len(ops) != n_keys:
        raise ValueError(f"{len(ops)} invocation counts for {n_keys} keys")
    rng = random.Random(seed)
    per_key = []
    for k in range(n_keys):
        h = register_history(n_process=n_process, n_ops=ops[k],
                             n_values=n_values, seed=seed * 1_000_003 + k)
        if bad_every and k % bad_every == 0:
            reads = [i for i, o in enumerate(h)
                     if o.type == "ok" and o.f == "read"]
            if reads:
                i = reads[0] if bad_read == "first" else rng.choice(reads)
                h[i] = h[i].with_(value=n_values)
        per_key.append(h)
    return interleave_keys(per_key, n_process)


def interleave_keys(per_key, n_process) -> list[Op]:
    """One history of the histories `per_key` (key k's ops by processes
    below `n_process`): key k's processes move up by k * n_process, its
    values become KVTuple(k, value), and the keys' ops are interleaved
    round-robin, indexed and timed in that order."""
    per_key = [[o.with_(process=o.process + k * n_process,
                        value=KVTuple(k, o.value)) for o in h]
               for k, h in enumerate(per_key)]
    out = []
    pos = [0] * len(per_key)
    live = [k for k in range(len(per_key)) if per_key[k]]
    while live:
        nxt = []
        for k in live:
            out.append(per_key[k][pos[k]])
            pos[k] += 1
            if pos[k] < len(per_key[k]):
                nxt.append(k)
        live = nxt
    for i, o in enumerate(out):
        o.index = i
        o.time = i
    return out
