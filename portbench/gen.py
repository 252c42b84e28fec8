"""The benchmark's traffic generator: seeded histories of independent CAS
registers, in the shape of jepsen's linearizable-register test.

The shape is frozen from `jepsen_tpu_torch/workloads/linearizable_register.py`
(lines 28-78), the port's copy of jepsen's
`jepsen/src/jepsen/tests/linearizable_register.clj` (lines 22-46):

- `independent.concurrent_generator(2 * n, keys, fgen)`: the test's
  threads work in groups of 2n (n the node count); a group works on one
  key at a time, and when a thread finds its key's generator exhausted
  the group moves on to the next key, while the group's other threads
  still complete what they invoked on the old one;
- `fgen(k) = limit(int((random() * 0.1 + 0.9) * per_key_limit),
  reserve(n, r, mix([w, cas, cas])))`: a key takes 90-100 % of
  `per_key_limit` invocations (the jitter that keeps keys out of phase);
  the group's first n threads only read, the other n pick write, cas or
  cas with equal odds;
- `w` writes `randrange(5)`, `cas` is (`randrange(5)`, `randrange(5)`),
  `r` reads: values 0-4.

The source supplies no client and no database, so the completions come
from an atomic register simulated here, which makes every history
linearizable by construction. A thread's op is invoked, takes effect at
a later step (a read returns the value then; a cas whose old value does
not match fails and completes :fail), and completes at a still later
step. With odds `info_rate` an invoked op crashes instead: it completes
:info (the client timed out), took effect at that moment with odds
`crash_takes_effect` and never otherwise, and its thread goes on as a
new process, process + concurrency (jepsen's rule for a crashed
process). Each step picks one live thread with equal odds. This
scheduler and `info_rate`/`crash_takes_effect` are the benchmark's own,
listed under `assumed` in the configuration.

A plant (`plant`) changes the first :ok read of every `every`-th key to
a value no write wrote (`values`, one past the largest): the key is
then not linearizable, and the search that proves it stays short. (A
read deeper in a key of this shape can take a search hours.)

An event is a plain tuple (process, type, f, value, key), with `type`
one of "invoke", "ok", "fail", "info" and a cas's value the pair
(old, new). The harness times and indexes events by their position.
The generator imports nothing of the program, so a later change to the
port cannot move the benchmark's inputs.
"""

from __future__ import annotations

import random

_IDLE, _INVOKED, _APPLIED = 0, 1, 2


def linearizable_register(keys, nodes=5, per_key_limit=128, jitter=0.1,
                          values=5, groups=1, info_rate=0.0,
                          crash_takes_effect=0.5, seed=0) -> list:
    """One history of `keys` independent CAS registers, keys 0, 1, ... in
    the order the groups reach them (module docstring)."""
    rng = random.Random(seed)
    per_group = 2 * nodes
    concurrency = per_group * groups
    next_key = 0
    reg: dict = {}           # key -> the register's value
    active = [None] * groups  # group -> [key, invocations left] or None

    def advance(g):
        nonlocal next_key
        if next_key < keys:
            k = next_key
            next_key += 1
            reg[k] = None
            active[g] = [k, int((rng.random() * jitter + 1 - jitter)
                                * per_key_limit)]
        else:
            active[g] = None

    for g in range(groups):
        advance(g)
    process = list(range(concurrency))
    state = [_IDLE] * concurrency
    op = [None] * concurrency  # thread -> [key, f, value, result]
    live = list(range(concurrency))
    history = []
    while live:
        j = rng.randrange(len(live))
        t = live[j]
        p = process[t]
        if state[t] == _IDLE:
            g = t // per_group
            while active[g] is not None and active[g][1] == 0:
                advance(g)
            if active[g] is None:
                live[j] = live[-1]
                live.pop()
                continue
            k = active[g][0]
            active[g][1] -= 1
            if t % per_group < nodes:
                f, value = "read", None
            else:
                f = ("write", "cas", "cas")[rng.randrange(3)]
                value = (rng.randrange(values) if f == "write" else
                         (rng.randrange(values), rng.randrange(values)))
            op[t] = [k, f, value, None]
            state[t] = _INVOKED
            history.append((p, "invoke", f, value, k))
        elif state[t] == _INVOKED:
            k, f, value, _ = op[t]
            if rng.random() < info_rate:
                if rng.random() < crash_takes_effect:
                    _apply(reg, k, f, value)
                history.append((p, "info", f, value, k))
                process[t] = p + concurrency
                state[t] = _IDLE
            else:
                op[t][3] = _apply(reg, k, f, value)
                state[t] = _APPLIED
        else:
            k, f, value, result = op[t]
            if result is _FAILED:
                history.append((p, "fail", f, value, k))
            else:
                history.append((p, "ok", f, result, k))
            state[t] = _IDLE
    return history


_FAILED = object()


def _apply(reg, k, f, value):
    """The op's effect on the register of key `k`: the value it returns,
    or _FAILED for a cas whose old value does not match."""
    if f == "read":
        return reg[k]
    if f == "write":
        reg[k] = value
        return value
    old, new = value
    if reg[k] != old:
        return _FAILED
    reg[k] = new
    return value


def plant(history, every, values) -> list:
    """`history` with the first :ok read of every `every`-th key (keys 0,
    every, 2 * every, ...) changed to read `values`, a value no write
    wrote; a key with no :ok read is left as it is."""
    first: dict = {}
    for i, (_, t, f, _, k) in enumerate(history):
        if t == "ok" and f == "read" and k % every == 0:
            first.setdefault(k, i)
    out = list(history)
    for k, i in first.items():
        p, t, f, _, _ = out[i]
        out[i] = (p, t, f, values, k)
    return out


def planted_keys(keys: int, every: int) -> list:
    """The keys `plant` plants a read in (those with an :ok read)."""
    return list(range(0, keys, every)) if every else []


def make_history(params: dict, traffic: dict, seed: int) -> list:
    """One history of a configuration's `history` parameters under a
    traffic mix (its optional `plant`), from `seed`."""
    h = linearizable_register(seed=seed, **params)
    p = traffic.get("plant")
    if p:
        h = plant(h, p["every"], params.get("values", 5))
    return h
