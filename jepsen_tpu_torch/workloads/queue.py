"""Seeded queue and mutex histories for the kernel's other model families.

`queue_history` simulates clients against a real (atomic) queue with
linearization points at invocation — linearizable by construction
unless `corrupt` > 0, in which case that fraction of dequeues return a
random value (possibly one never enqueued). fifo=True dequeues from the
front (for the fifo-queue model), otherwise from a random position (the
unordered queue). `mutex_history` does the same for a lock.
"""

from __future__ import annotations

import random

from ..history import Op


def queue_history(n_process=3, n_ops=12, n_values=None, corrupt=0.0,
                  seed=0, fifo=False) -> list[Op]:
    """A random concurrent queue history of `n_ops` invocations; 8% of
    completions crash as :info, a dequeue of an empty queue records
    :fail. n_values=None gives mostly unique payloads."""
    rng = random.Random(seed)
    if n_values is None:
        n_values = max(4, n_ops)
    history = []
    t = 0
    q: list = []
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
            if rng.random() < 0.5:
                f = "enqueue"
                value = rng.randrange(n_values)
                q.append(value)
                result = value
            else:
                f = "dequeue"
                if not q:
                    history.append(Op(p, "invoke", f, None, time=t))
                    t += 1
                    history.append(Op(p, "fail", f, None, time=t))
                    t += 1
                    continue
                result = q.pop(0 if fifo else rng.randrange(len(q)))
                value = None  # a dequeue invoke doesn't know its value
                if corrupt and rng.random() < corrupt:
                    result = rng.randrange(2 * n_values)
            history.append(Op(p, "invoke", f, value, time=t))
            pending[p] = (f, value, result)
        t += 1
    for i, o in enumerate(history):
        o.index = i
    return history


def mutex_history(n_process=3, n_ops=12, corrupt=0.0, seed=0) -> list[Op]:
    """A random concurrent lock history of `n_ops` invocations: acquires
    take effect at invocation when the lock is free (else they block
    until they can, as a real lock's acquire does); a holder releases.
    With `corrupt` > 0 that fraction of acquires succeed on a held lock
    (a broken lock). 8% of completions crash as :info."""
    rng = random.Random(seed)
    history = []
    t = 0
    holder = [None]
    pending = {}  # process -> f
    procs = list(range(n_process))
    ops_started = 0
    while ops_started < n_ops or pending:
        p = rng.choice(procs)
        if p in pending:
            f = pending[p]
            if f == "acquire" and holder[0] not in (None, p):
                if ops_started >= n_ops and holder[0] not in pending:
                    # the holder will never release: time out
                    del pending[p]
                    history.append(Op(p, "info", f, None, time=t))
                    t += 1
                    continue
                if not (corrupt and rng.random() < corrupt):
                    t += 1
                    continue  # still blocked
            if f == "acquire":
                holder[0] = p
            elif holder[0] == p:
                holder[0] = None
            del pending[p]
            kind = "info" if rng.random() < 0.08 else "ok"
            history.append(Op(p, kind, f, None, time=t))
        elif ops_started < n_ops:
            ops_started += 1
            f = "release" if holder[0] == p else "acquire"
            history.append(Op(p, "invoke", f, None, time=t))
            pending[p] = f
        t += 1
    for i, o in enumerate(history):
        o.index = i
    return history
