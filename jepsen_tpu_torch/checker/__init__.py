"""Checker protocol (the port's copy of the part of
`jepsen_tpu.checker` its checkers need; reference: jepsen.checker).

A checker validates a recorded history: `check(test, history, opts)`
returns a dict with at least {"valid": True | False | "unknown"}.
"""

from __future__ import annotations

import traceback
from typing import Any, Mapping

from ..device import CudaUnavailable, KernelError
from ..ops._build import BuildError

VALID_PRIORITIES = {True: 0, "unknown": 0.5, False: 1}

#: faults of the card or of a build: never turned into "unknown"
#: (check_safe, and the "competition" race in linearizable.py)
FAULTS = (KernelError, BuildError, CudaUnavailable)


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
    a kernel that failed to build or launch, or a card that is absent:
    those re-raise, so a fault of the card never reads as "unknown"."""
    try:
        return checker.check(test, history, opts or {})
    except FAULTS:
        raise
    except Exception:  # noqa: BLE001
        return {"valid": "unknown", "error": traceback.format_exc()}


from . import cycle  # noqa: E402
from .linearizable import linearizable  # noqa: E402

__all__ = ["Checker", "check_safe", "cycle", "linearizable", "merge_valid"]
