"""Just-in-time linearization over configurations — the second
linearizability algorithm (the port's copy of `jepsen_tpu/ops/linear.py`;
parity target: knossos.linear/analysis, invoked from the reference's
checker.clj:126; SURVEY.md §2.2).

This is Lowe's "configurations" algorithm and is genuinely different
from the WGL depth-first search in ops/wgl_host.py / ops/wgl_search.py: it
sweeps the history's call/return events IN ORDER ONCE, carrying the set
of all distinguishable configurations — (model state, set of pending
ops linearized early) pairs — and only linearizes operations when a
return forces it ("just in time"). A history that defeats WGL's search
order (deep backtracking) often falls to the configuration sweep, and
vice versa; racing the two is what makes the competition checker real
(knossos.competition parity, checker.clj:125).

Semantics match the WGL engines: failed ops are excluded before the
sweep, crashed (:info) ops stay pending forever — available, never
required. A history is linearizable iff a configuration survives every
return event.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any

from ..history import Entries, Op, entries as make_entries
from ..models import Model, inconsistent

#: truncation for result artifacts (checker.clj:138-141)
MAX_CONFIGS_REPORTED = 10

DEFAULT_MAX_CONFIGS = 2_000_000


@dataclass
class LinearResult:
    valid: Any  # True | False | "unknown"
    op: Op | None = None  # the op at whose return every config died
    configs: list = field(default_factory=list)  # surviving/last configs
    cache_size: int = 0  # peak live configuration count
    steps: int = 0  # model.step invocations
    best_linearization: list | None = None  # kept None: not a DFS path

    def to_dict(self) -> dict:
        d = {"valid": self.valid}
        if self.op is not None:
            d["op"] = self.op.to_dict()
        if self.configs:
            d["configs"] = self.configs
        d["cache_size"] = self.cache_size
        d["steps"] = self.steps
        return d


def _config_dicts(configs, es: Entries) -> list:
    """Human-readable configurations, truncated (checker.clj:138-141)."""
    out = []
    for m, linset in list(configs)[:MAX_CONFIGS_REPORTED]:
        out.append({
            "model": str(m),
            "linearized_pending": [es.invokes[i].to_dict()
                                   for i in sorted(linset)],
        })
    return out


def analysis(
    model: Model,
    history,
    time_limit: float | None = None,
    max_configs: int = DEFAULT_MAX_CONFIGS,
) -> LinearResult:
    """Sweep the history once, maintaining all reachable configurations.

    Returns LinearResult with valid in {True, False, "unknown"} —
    "unknown" when the live configuration set exceeds max_configs or the
    time budget runs out (knossos's :unknown analog)."""
    es = history if isinstance(history, Entries) else make_entries(history)
    n = len(es)
    if es.n_completed == 0:
        return LinearResult(valid=True, configs=[{"model": str(model),
                                                  "linearized_pending": []}])

    # Events in real-time order. Crashed entries' returns are at
    # +infinity (positions past every real event) — skip them: a crashed
    # op simply never forces linearization.
    events: list[tuple[int, bool, int]] = []  # (pos, is_call, entry)
    for e in range(n):
        events.append((int(es.call_pos[e]), True, e))
        if not es.crashed[e]:
            events.append((int(es.ret_pos[e]), False, e))
    events.sort()

    fs = es.f
    vals = es.value_out

    deadline = None if time_limit is None else _time.monotonic() + time_limit
    steps = 0
    peak = 1

    # A configuration is (model, frozenset of open ops linearized early).
    configs: set = {(model, frozenset())}
    open_ops: set = set()

    for pos, is_call, e in events:
        if is_call:
            open_ops.add(e)
            continue

        # Return of e: every surviving configuration must have e
        # linearized. Expand just-in-time: from each config, linearize
        # any valid sequence of pending ops ending with e. Iterative
        # worklist (crash-heavy histories can have thousands of pending
        # ops — recursion would blow the stack) with budget checks in
        # the loop (a single expansion can be exponential on its own).
        open_ops.discard(e)
        new_configs: set = set()
        work: list = list(configs)
        seen: set = set(work)  # dedupe expansion states
        iters = 0
        while work:
            iters += 1
            if len(seen) + len(new_configs) > max_configs:
                return LinearResult(valid="unknown", cache_size=peak,
                                    steps=steps)
            if (deadline is not None and iters % 512 == 0
                    and _time.monotonic() > deadline):
                return LinearResult(valid="unknown", cache_size=peak,
                                    steps=steps)
            m, linset = work.pop()
            if e in linset:
                new_configs.add((m, linset - {e}))
                continue
            # linearize e now...
            steps += 1
            m2 = m.step(fs[e], vals[e])
            if not inconsistent(m2):
                new_configs.add((m2, linset))
            # ...or linearize some other pending op first, then retry.
            for o in open_ops:
                if o in linset:
                    continue
                steps += 1
                m3 = m.step(fs[o], vals[o])
                if inconsistent(m3):
                    continue
                key = (m3, linset | {o})
                if key in seen:
                    continue
                seen.add(key)
                work.append(key)
        if deadline is not None and _time.monotonic() > deadline:
            return LinearResult(valid="unknown", cache_size=peak, steps=steps)

        if not new_configs:
            return LinearResult(
                valid=False,
                op=es.invokes[e],
                configs=_config_dicts(configs, es),
                cache_size=peak,
                steps=steps,
            )
        configs = new_configs
        peak = max(peak, len(configs))

    return LinearResult(
        valid=True,
        configs=_config_dicts(configs, es),
        cache_size=peak,
        steps=steps,
    )


def check(model: Model, history, **kw) -> dict:
    return analysis(model, history, **kw).to_dict()
