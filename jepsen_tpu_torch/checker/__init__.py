"""Checker protocol (the port's copy of the part of
`jepsen_tpu.checker` its checkers need; reference: jepsen.checker).

A checker validates a recorded history: `check(test, history, opts)`
returns a dict with at least {"valid": True | False | "unknown"}.
"""

from __future__ import annotations

import re
import traceback
from typing import Any, Mapping

import torch

from ..device import CudaUnavailable, KernelError
from ..ops._build import BuildError

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


from . import cycle  # noqa: E402
from .linearizable import linearizable  # noqa: E402

__all__ = ["FAULTS", "Checker", "check_safe", "cycle", "is_fault",
           "linearizable", "merge_valid"]
