"""Checker protocol, combinators and registry (the port's copy of
`jepsen_tpu.checker`; reference: jepsen.checker, checker.clj:49-114).

A checker validates a recorded history: `check(test, history, opts)`
returns a dict with at least {"valid": True | False | "unknown"}.
Exceptions become {"valid": "unknown", "error": ...} through check_safe,
except the faults of the card or of a build (`is_fault`), which
re-raise; compose() runs a map of checkers in threads, each under
check_safe, and merges their validities with false > unknown > true.

`REGISTRY` maps the names the CLI's --checker flag accepts to
factories, instantiated by `resolve(name, device=None)`, which passes
`device` to the two that reach the card:

  linearizable   single-register linearizability (checker/linearizable.py)
  cycle          Elle-style transactional cycle checker (checker/cycle/)
  timeline       the history as an HTML timeline
  clock          clock-skew plot
  perf           latency and rate graphs
  recovery       nemesis fault/recovery audit
  unbridled-optimism  everything is awesome (a no-op baseline)

The workload checkers (bank's totals, long_fork's forks, adya's G2,
causal's replay) come from `workloads/`; the transactional ones route
through `cycle`.
"""

from __future__ import annotations

import re
import threading
import traceback
from typing import Any, Mapping

import torch

from ..device import CudaUnavailable, KernelError
from ..ops._build import BuildError
from ..util import bounded_pmap

VALID_PRIORITIES = {True: 0, "unknown": 0.5, False: 1}

#: faults of the card or of a build: never turned into "unknown"
#: (check_safe, the "competition" race in linearizable.py, the online
#: frontiers, pack_check, the run monitor, the verdict daemon and its
#: sacrificial child). torch raises a CUDA error (an illegal address
#: that surfaces at a later sync, a device-side assert) as
#: AcceleratorError where it has that type, else as a RuntimeError that
#: names it; `is_fault` tells both apart from ordinary errors.
FAULTS = (KernelError, BuildError, CudaUnavailable, torch.OutOfMemoryError,
          *((torch.AcceleratorError,)
            if hasattr(torch, "AcceleratorError") else ()))

_CUDA_ERROR = re.compile(r"\bCUDA (?:driver )?error\b|CUBLAS_STATUS_")


def is_fault(e: BaseException) -> bool:
    """True for a fault of the card or of a build: one of FAULTS, or a
    torch RuntimeError that carries a CUDA error. Every except clause of
    the port that would otherwise read an exception as "unknown", an
    advisory warning or a worker death asks this first."""
    return isinstance(e, FAULTS) or (
        isinstance(e, RuntimeError) and bool(_CUDA_ERROR.search(str(e))))


def merge_valid(valids) -> Any:
    """The highest-priority validity: any False wins, else any "unknown",
    else True."""
    out = True
    for v in valids:
        if v not in VALID_PRIORITIES:
            raise ValueError(f"{v!r} is not a known valid value")
        if VALID_PRIORITIES[v] > VALID_PRIORITIES[out]:
            out = v
    return out


class Checker:
    def check(self, test: Mapping, history, opts: Mapping | None = None) -> dict:
        raise NotImplementedError


def check_safe(checker: Checker, test, history, opts=None) -> dict:
    """check(), but exceptions are wrapped as unknown verdicts — except
    a kernel that failed to build or launch, or a card that is absent or
    out of memory, or a CUDA error (`is_fault`): those re-raise, so a
    fault of the card never reads as "unknown"."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        if is_fault(e):
            raise
        return {"valid": "unknown", "error": traceback.format_exc()}


class Compose(Checker):
    """Runs a name->checker map in parallel threads, each under
    check_safe (so a fault of the card raises); the result maps each
    name to its sub-result, plus the merged "valid"
    (checker.clj:79-91)."""

    def __init__(self, checker_map: Mapping[str, Checker]):
        self.checker_map = dict(checker_map)

    def check(self, test, history, opts=None) -> dict:
        results = bounded_pmap(
            lambda kv: (kv[0], check_safe(kv[1], test, history, opts)),
            list(self.checker_map.items()))
        out = dict(results)
        out["valid"] = merge_valid(r["valid"] for _, r in results)
        return out


def compose(checker_map) -> Compose:
    return Compose(checker_map)


class ConcurrencyLimit(Checker):
    """Bounds concurrent executions of a memory-hungry checker with a
    semaphore (checker.clj:93-108)."""

    def __init__(self, limit: int, checker: Checker):
        self.sem = threading.Semaphore(limit)
        self.checker = checker

    def check(self, test, history, opts=None) -> dict:
        with self.sem:
            return self.checker.check(test, history, opts)


def concurrency_limit(limit: int, checker: Checker) -> ConcurrencyLimit:
    return ConcurrencyLimit(limit, checker)


class UnbridledOptimism(Checker):
    """Everything is awesoooommmmme! (checker.clj:110-114)"""

    def check(self, test, history, opts=None) -> dict:
        return {"valid": True}


def unbridled_optimism() -> UnbridledOptimism:
    return UnbridledOptimism()


# the concrete checkers import the protocol above, so they load after it
from . import cycle  # noqa: E402
from .basic import (  # noqa: E402
    counter,
    queue,
    set_checker,
    set_full,
    total_queue,
    unique_ids,
)
from .clock import clock_plot  # noqa: E402
from .linearizable import linearizable  # noqa: E402
# the composite perf checker is exported as perf_checker: the bare name
# `perf` is the checker.perf submodule
from .perf import (  # noqa: E402
    latency_graph,
    perf as perf_checker,
    rate_graph_checker as rate_graph,
)
from .recovery import RecoveryChecker, recovery  # noqa: E402
from .timeline import html as timeline_html  # noqa: E402

#: --checker names -> checker factories (module docstring)
REGISTRY = {
    "linearizable": linearizable,
    "cycle": cycle.checker,
    "timeline": timeline_html,
    "clock": clock_plot,
    "perf": perf_checker,
    "recovery": recovery,
    "unbridled-optimism": unbridled_optimism,
}

# the factories that reach the card, and so take `device`
_ON_CARD = ("linearizable", "cycle")


def resolve(name: str, device=None) -> Checker:
    """Instantiate a registered checker by CLI name; `device` (None =
    CUDA, raising at check time when it is absent; "cpu" the kernels'
    plain versions) goes to the checkers that reach the card."""
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown checker {name!r}; known: {sorted(REGISTRY)}"
        ) from None
    return factory(device=device) if name in _ON_CARD else factory()


__all__ = [
    "FAULTS",
    "REGISTRY",
    "Checker",
    "Compose",
    "ConcurrencyLimit",
    "RecoveryChecker",
    "UnbridledOptimism",
    "check_safe",
    "clock_plot",
    "compose",
    "concurrency_limit",
    "counter",
    "cycle",
    "is_fault",
    "latency_graph",
    "linearizable",
    "merge_valid",
    "perf_checker",
    "queue",
    "rate_graph",
    "recovery",
    "resolve",
    "set_checker",
    "set_full",
    "timeline_html",
    "total_queue",
    "unbridled_optimism",
    "unique_ids",
]
