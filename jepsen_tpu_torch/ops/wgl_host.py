"""Wing-Gong-Lowe linearizability search, host implementation.

Parity target: knossos.wgl/analysis. The algorithm is Lowe's refinement
of Wing & Gong's tree search ("Testing for linearizability", Lowe
2016): a depth-first search over the orders in which concurrent
operations could have taken effect, pruned by a memo of
(linearized-bitset, model-state) pairs.

The history's call/return events form a doubly-linked list in
real-time order. The search repeatedly tries to linearize an operation
whose call precedes the first un-linearized return; linearizing *lifts*
its two events and pushes (op, previous-state) on an undo stack.
Hitting a return event means no minimal op could be linearized — pop
the stack and resume after the popped op's call. The history is
linearizable iff every *completed* operation gets linearized. Crashed
ops (:info / no completion) return at infinity: always available,
never required.

This is the semantics oracle for ops/wgl_vec.py and the engine for
lanes the kernel cannot take (models without an int32 encoding).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from typing import Any

from ..history import Entries, Op, entries as make_entries
from ..models import Model, inconsistent


@dataclass
class WGLResult:
    valid: Any  # True | False | "unknown"
    op: Op | None = None  # the op at whose return the search died
    best_linearization: list | None = None  # ops of the deepest prefix found
    final_state: Any = None
    cache_size: int = 0
    steps: int = 0
    error: str | None = None  # why an "unknown" verdict degraded

    def to_dict(self) -> dict:
        d = {"valid": self.valid}
        if self.op is not None:
            d["op"] = self.op.to_dict()
        if self.best_linearization is not None:
            d["best_linearization"] = [o.to_dict() for o in self.best_linearization]
        d["cache_size"] = self.cache_size
        d["steps"] = self.steps
        return d


def analysis(
    model: Model,
    history,
    time_limit: float | None = None,
    max_steps: int | None = None,
) -> WGLResult:
    """Check linearizability of `history` (Ops or Entries) against
    `model`. valid is True, False, or "unknown" on time/step budget
    exhaustion."""
    es = history if isinstance(history, Entries) else make_entries(history)
    n = len(es)
    if es.n_completed == 0:
        # nothing is *required* to linearize
        return WGLResult(valid=True, final_state=model)

    # node id = event position + 1 (0 is the head sentinel)
    n_nodes = 2 * n + 1
    nxt = list(range(1, n_nodes + 1))
    nxt[-1] = 0  # last node -> sentinel (treated as end)
    prv = list(range(-1, n_nodes - 1))
    prv[0] = 0
    node_entry = [0] * n_nodes
    node_is_call = [False] * n_nodes
    call_node = [0] * n
    ret_node = [0] * n
    for e in range(n):
        c = int(es.call_pos[e]) + 1
        r = int(es.ret_pos[e]) + 1
        call_node[e] = c
        ret_node[e] = r
        node_entry[c] = e
        node_entry[r] = e
        node_is_call[c] = True

    END = 0

    def lift(e: int) -> None:
        for nd in (call_node[e], ret_node[e]):
            p, q = prv[nd], nxt[nd]
            nxt[p] = q
            if q != END:
                prv[q] = p

    def unlift(e: int) -> None:
        for nd in (ret_node[e], call_node[e]):
            p, q = prv[nd], nxt[nd]
            nxt[p] = nd
            if q != END:
                prv[q] = nd

    fs = es.f
    vals = es.value_out
    crashed = es.crashed
    n_completed = es.n_completed

    state: Any = model
    linearized = 0
    completed_done = 0
    cache: set = {(0, model)}
    stack: list = []  # (entry, prev_state)
    best_depth = -1
    best_stack_entries: list = []
    stuck_entry: int | None = None

    node = nxt[0]
    steps = 0
    deadline = None if time_limit is None else _time.monotonic() + time_limit
    CHECK_EVERY = 4096

    while True:
        steps += 1
        if max_steps is not None and steps > max_steps:
            return WGLResult(valid="unknown", cache_size=len(cache), steps=steps)
        if (
            deadline is not None
            and steps % CHECK_EVERY == 0
            and _time.monotonic() > deadline
        ):
            return WGLResult(valid="unknown", cache_size=len(cache), steps=steps)

        if node != END and node_is_call[node]:
            e = node_entry[node]
            new_state = state.step(fs[e], vals[e])
            advanced = False
            if not inconsistent(new_state):
                new_lin = linearized | (1 << e)
                key = (new_lin, new_state)
                if key not in cache:
                    cache.add(key)
                    stack.append((e, state))
                    state = new_state
                    linearized = new_lin
                    if not crashed[e]:
                        completed_done += 1
                    lift(e)
                    if completed_done == n_completed:
                        return WGLResult(
                            valid=True,
                            best_linearization=[es.invokes[i] for i, _ in stack],
                            final_state=state,
                            cache_size=len(cache),
                            steps=steps,
                        )
                    node = nxt[0]
                    advanced = True
            if not advanced:
                node = nxt[node]
        else:
            # return event (or end of list): nothing minimal linearizes
            if len(stack) > best_depth:
                best_depth = len(stack)
                best_stack_entries = [i for i, _ in stack]
                stuck_entry = node_entry[node] if node != END else None
            if not stack:
                op = es.invokes[stuck_entry] if stuck_entry is not None else None
                return WGLResult(
                    valid=False,
                    op=op,
                    best_linearization=[es.invokes[i] for i in best_stack_entries],
                    cache_size=len(cache),
                    steps=steps,
                )
            e, prev_state = stack.pop()
            state = prev_state
            linearized &= ~(1 << e)
            if not crashed[e]:
                completed_done -= 1
            unlift(e)
            node = nxt[call_node[e]]


def check(model: Model, history, **kw) -> dict:
    """Convenience: analysis() as a plain dict."""
    return analysis(model, history, **kw).to_dict()


def recover_invalid(model: Model, es) -> WGLResult:
    """Re-run the search on the host for a lane a kernel already proved
    invalid, to recover its counterexample (`op`, best linearization);
    the verdicts agree by construction. A lane the native engine takes
    (ops/wgl_native.resolve) goes there, any other to the Python search.
    The choice is made from eligibility: a native failure raises."""
    from . import wgl_native

    jm = wgl_native.resolve(model, es)
    if jm is not None:
        return wgl_native.analysis_batch(model, [es], jms=[jm])[0]
    return analysis(model, es)
