"""Linearizability checker (reference: jepsen.checker/linearizable,
backed by knossos).

Algorithms:
  "gpu_vec"  ops/wgl_vec.py — the batch search, one CUDA thread per
             lane (the counterpart of the JAX package's "pallas").
             Scalar models plus both queue families, up to 1024
             entries per lane.
  "host"     ops/wgl_host.py — the Python search (knossos.wgl analog).
  "auto"     gpu_vec when the batch is eligible (`batch_eligible`),
             else host. The route is chosen from eligibility BEFORE
             anything launches; a failing kernel raises, nothing falls
             back.

Results have the JAX package's shape: valid, op + final_paths for an
invalid history (truncated to TRUNCATE ops), cache_size, steps.
"""

from __future__ import annotations

from typing import Any

from ..history import entries as make_entries
from ..models import Model
from ..models import jit as mjit
from ..ops import wgl_host, wgl_vec
from ..ops.common import STEPS_PER_SEC_ESTIMATE
from . import Checker

TRUNCATE = 10
ALGORITHMS = ("auto", "gpu_vec", "host")


class Linearizable(Checker):
    def __init__(
        self,
        model: Model | None = None,
        algorithm: str = "auto",
        time_limit: float | None = None,
        device=None,
    ):
        if algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.model = model
        self.algorithm = algorithm
        self.time_limit = time_limit
        self.device = device

    def _model(self, test) -> Model:
        m = self.model or (test or {}).get("model")
        if m is None:
            raise ValueError("linearizable checker needs a model")
        return m

    def _max_steps(self) -> int | None:
        """time_limit as a step budget for the kernel (a kernel loop
        cannot consult the wall clock)."""
        if self.time_limit is None:
            return None
        return max(1000, int(self.time_limit * STEPS_PER_SEC_ESTIMATE))

    def _route(self, model, ess) -> str:
        if self.algorithm != "auto":
            return self.algorithm
        jm = mjit.for_model(model)
        if jm is not None and wgl_vec.batch_eligible(jm, ess):
            return "gpu_vec"
        return "host"

    def _results(self, model, ess) -> list:
        if self._route(model, ess) == "gpu_vec":
            return wgl_vec.analysis_batch(
                model, ess, max_steps=self._max_steps(), device=self.device)
        return [wgl_host.analysis(model, es, time_limit=self.time_limit)
                for es in ess]

    def check(self, test, history, opts=None) -> dict:
        model = self._model(test)
        (r,) = self._results(model, [make_entries(list(history))])
        return self._result(r)

    def check_batch(self, test, items) -> list[dict]:
        """Check many independent histories in one pass — the batched
        path the independent checker takes. `items` is a list of
        (history, per_item_opts); returns one result dict per item."""
        model = self._model(test)
        ess = [make_entries(list(h)) for h, _ in items]
        if not ess:
            return []
        return [self._result(r) for r in self._results(model, ess)]

    def _result(self, r) -> dict:
        d: dict[str, Any] = {"valid": r.valid}
        if r.valid is False:
            if r.op is not None:
                d["op"] = r.op.to_dict()
            if r.best_linearization is not None:
                d["final_paths"] = [
                    [o.to_dict() for o in r.best_linearization[:TRUNCATE]]
                ]
        d["cache_size"] = r.cache_size
        d["steps"] = r.steps
        return d


def linearizable(model=None, algorithm="auto", time_limit=None,
                 device=None) -> Linearizable:
    return Linearizable(model, algorithm, time_limit, device)
