"""Linearizability checker (reference: jepsen.checker/linearizable,
backed by knossos).

Algorithms:
  "gpu_vec"  ops/wgl_vec.py — the batch search, one CUDA thread per
             lane (the counterpart of the JAX package's "pallas").
             Scalar models plus both queue families, up to 1024
             entries per lane.
  "gpu_row"  ops/wgl_row.py — the batch search for long lanes, one CUDA
             warp per lane (the counterpart of jepsen_tpu/ops/
             wgl_pallas.py). Scalar models only, up to 4064 entries per
             lane.
  "host"     ops/wgl_host.py — the Python search (knossos.wgl analog).
  "auto"     per lane for the scalar models: gpu_vec for the lanes it
             takes, gpu_row for the other int32-encodable lanes up to
             4064 entries, host for the rest; the queue models go to
             gpu_vec when the whole batch is eligible, else to host.
             The routes are chosen from eligibility BEFORE anything
             launches, each engine gets its lanes in one call, and a
             failing kernel raises: nothing falls back.

Results have the JAX package's shape: valid, op + final_paths for an
invalid history (truncated to TRUNCATE ops), cache_size, steps.
"""

from __future__ import annotations

from typing import Any

from ..history import entries as make_entries
from ..models import Model
from ..models import jit as mjit
from ..ops import wgl_host, wgl_row, wgl_vec
from ..ops.common import STEPS_PER_SEC_ESTIMATE
from . import Checker

TRUNCATE = 10
ALGORITHMS = ("auto", "gpu_vec", "gpu_row", "host")


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

    def _route(self, model, ess) -> list[str]:
        """The engine of each lane, decided before anything launches."""
        if self.algorithm != "auto":
            return [self.algorithm] * len(ess)
        jm = mjit.for_model(model)
        if jm is None:
            return ["host"] * len(ess)
        if not wgl_row.eligible(jm, wgl_row.MAX_PAD):
            # the queue models: the whole batch goes one way
            whole = "gpu_vec" if wgl_vec.batch_eligible(jm, ess) else "host"
            return [whole] * len(ess)
        return ["gpu_vec" if wgl_vec.batch_eligible(jm, [es])
                else "gpu_row" if wgl_row.batch_eligible(jm, [es])
                else "host" for es in ess]

    def _results(self, model, ess) -> list:
        routes = self._route(model, ess)
        out: list = [None] * len(ess)
        for engine in ("gpu_vec", "gpu_row", "host"):
            idx = [i for i, r in enumerate(routes) if r == engine]
            if not idx:
                continue
            sub = [ess[i] for i in idx]
            if engine == "host":
                rs = [wgl_host.analysis(model, es, time_limit=self.time_limit)
                      for es in sub]
            else:
                mod = wgl_vec if engine == "gpu_vec" else wgl_row
                rs = mod.analysis_batch(model, sub,
                                        max_steps=self._max_steps(),
                                        device=self.device)
            for i, r in zip(idx, rs):
                out[i] = r
        return out

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
