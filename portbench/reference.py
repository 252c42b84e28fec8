"""The plain reference that decides `correct`: linearizability of a
CAS register, checked key by key in plain Python.

It imports nothing of the system under test. It is written from the
definition of the Wing-Gong-Lowe search (Lowe, "Testing for
linearizability", 2016), the algorithm whose counterexample the
system reports:

- An entry is an invocation with its completion. A pair that completed
  `:fail` never happened and is left out. A pair that completed `:info`,
  or never completed, is crashed: it may take effect at any point after
  its call, or never, and nothing requires it.
- The calls and returns of the entries form a list in history order,
  with every crashed entry's return after all real events, in call
  order.
- The search walks the list from its head. At a call it applies the
  entry to the register; when that is legal and the pair (set of
  entries applied, register value) is new, it takes the entry out of
  the list, pushes it and starts again from the head. At a return (or
  the list's end) nothing minimal can be applied: it pops the last
  entry, restores the register and goes on after that entry's call.
- The history is linearizable once every completed entry is applied.
  It is not once the stack is empty at a return. Its counterexample is
  the entry of the return at which the stack first reached its
  greatest depth.

The register starts empty (None). A write sets it; a cas (old, new)
sets it to new when it holds old and is illegal otherwise; a read of v
is legal when it holds v, and a read whose value is unknown (None) is
always legal.

`check_key` takes one key's events as (index, process, type, f, value)
tuples and returns (valid, index of the counterexample's invocation or
None). Its two options break a guarantee on purpose, for the controls
(portbench/control.py): `info_as_fail` reads a crashed op as one that
never happened, and `max_steps` gives up ("unknown") after that many
steps.
"""

from __future__ import annotations

_ILLEGAL = object()


def _apply(state, f, value):
    if f == "write":
        return value
    if f == "cas":
        old, new = value
        return new if state == old else _ILLEGAL
    if f == "read":
        return state if value is None or value == state else _ILLEGAL
    raise ValueError(f"unknown op {f!r}")


def entries(events, info_as_fail=False) -> tuple:
    """(f, value, crashed, call node, return node, invoke index) of each
    entry of one key's events, in call order, and the node count. Nodes
    are numbered from 1 in list order."""
    pending = {}
    pairs = []  # [invoke event, completion event or None]
    for ev in events:
        _, p, t, _, _ = ev
        if t == "invoke":
            if p in pending:
                raise ValueError(f"process {p} invoked twice: {ev}")
            pair = [ev, None]
            pending[p] = pair
            pairs.append(pair)
        else:
            pair = pending.pop(p, None)
            if pair is not None:
                pair[1] = ev
    kept = []
    for inv, done in pairs:
        t = None if done is None else done[2]
        if t == "fail" or (info_as_fail and t == "info"):
            continue
        kept.append((inv, done, t not in ("ok",)))
    pos = 0
    call_ids = {id(inv): i for i, (inv, _, _) in enumerate(kept)}
    ret_ids = {id(done): i for i, (_, done, crashed) in enumerate(kept)
               if not crashed}
    call_node = [0] * len(kept)
    ret_node = [0] * len(kept)
    for ev in events:
        i = call_ids.get(id(ev))
        if i is not None:
            pos += 1
            call_node[i] = pos
            continue
        i = ret_ids.get(id(ev))
        if i is not None:
            pos += 1
            ret_node[i] = pos
    for i, (_, _, crashed) in enumerate(kept):
        if crashed:
            pos += 1
            ret_node[i] = pos
    out = []
    for i, (inv, done, crashed) in enumerate(kept):
        value = inv[4]
        if not crashed and done[4] is not None:
            value = done[4]
        out.append((inv[3], value, crashed, call_node[i], ret_node[i],
                    inv[0]))
    return out, pos


def check_key(events, info_as_fail=False, max_steps=None) -> tuple:
    """(valid, counterexample invocation index or None) of one key's
    events; valid is True, False or "unknown" (past `max_steps`)."""
    es, n_nodes = entries(events, info_as_fail)
    n = len(es)
    n_completed = sum(1 for e in es if not e[2])
    if n_completed == 0:
        return True, None
    # node 0 is the head; nodes 1..n_nodes in list order; 0 also ends it
    nxt = list(range(1, n_nodes + 2))
    nxt[n_nodes] = 0
    prv = list(range(-1, n_nodes))
    prv[0] = 0
    entry_of = [0] * (n_nodes + 1)
    is_call = [False] * (n_nodes + 1)
    fs = [e[0] for e in es]
    vals = [e[1] for e in es]
    crashed = [e[2] for e in es]
    call_node = [e[3] for e in es]
    ret_node = [e[4] for e in es]
    for i in range(n):
        entry_of[call_node[i]] = i
        entry_of[ret_node[i]] = i
        is_call[call_node[i]] = True

    state = None
    applied = 0
    done = 0
    seen = {(0, None)}
    stack = []
    best_depth = -1
    stuck = None
    node = nxt[0]
    steps = 0
    while True:
        steps += 1
        if max_steps is not None and steps > max_steps:
            return "unknown", None
        if node and is_call[node]:
            e = entry_of[node]
            new = _apply(state, fs[e], vals[e])
            if new is not _ILLEGAL:
                key = (applied | (1 << e), new)
                if key not in seen:
                    seen.add(key)
                    stack.append((e, state))
                    state = new
                    applied = key[0]
                    if not crashed[e]:
                        done += 1
                        if done == n_completed:
                            return True, None
                    for nd in (call_node[e], ret_node[e]):
                        p, q = prv[nd], nxt[nd]
                        nxt[p] = q
                        if q:
                            prv[q] = p
                    node = nxt[0]
                    continue
            node = nxt[node]
            continue
        if len(stack) > best_depth:
            best_depth = len(stack)
            stuck = entry_of[node] if node else None
        if not stack:
            return False, (None if stuck is None else es[stuck][5])
        e, state = stack.pop()
        applied &= ~(1 << e)
        if not crashed[e]:
            done -= 1
        for nd in (ret_node[e], call_node[e]):
            p, q = prv[nd], nxt[nd]
            nxt[p] = nd
            if q:
                prv[q] = nd
        node = nxt[call_node[e]]


def by_key(history) -> dict:
    """key -> that key's events as (index, process, type, f, value), from
    a history of (process, type, f, value, key) events (key None: one
    register)."""
    out: dict = {}
    for i, (p, t, f, v, k) in enumerate(history):
        out.setdefault(k, []).append((i, p, t, f, v))
    return out


def check_history(history, keys=None, **options) -> dict:
    """key -> (valid, counterexample index) for the keys `keys` (None:
    every key) of a history of (process, type, f, value, key) events."""
    split = by_key(history)
    if keys is None:
        keys = sorted(split, key=lambda k: (k is not None, k))
    return {k: check_key(split.get(k, []), **options) for k in keys}
