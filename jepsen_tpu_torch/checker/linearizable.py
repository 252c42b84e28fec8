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
  "gpu_search" ops/wgl_search.py — the batch search for lanes of any
             length and a vector model state, one CUDA warp per lane
             (the counterpart of the JAX package's "tpu", jepsen_tpu/
             ops/wgl_tpu.py). Every model with a kernel encoding; the
             whole batch in one call.
  "host"     ops/wgl_host.py — the Python search (knossos.wgl analog).
  "auto"     first the P-compositional split (ops/pcomp.py) where the
             model declares one and every history decomposes (the
             unordered queue by value, single-key multi-register txns
             by key): every item's micro-lanes flatten into one batch
             per sub-model, and each item's verdict recombines from its
             own lanes. Then per lane for the scalar models: gpu_vec for
             the lanes it takes, gpu_row for the other int32-encodable
             lanes up to 4064 entries, gpu_search for the longer ones,
             host for the rest; the queue models go to gpu_vec when the
             whole batch is eligible, else to gpu_search (else host).
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
from ..ops import pcomp, wgl_host, wgl_row, wgl_search, wgl_vec
from ..ops.common import STEPS_PER_SEC_ESTIMATE
from . import Checker

TRUNCATE = 10
ALGORITHMS = ("auto", "gpu_vec", "gpu_row", "gpu_search", "host")
ENGINES = {"gpu_vec": wgl_vec, "gpu_row": wgl_row, "gpu_search": wgl_search}


def _combine_lanes(rs: list):
    """One WGLResult for a P-compositionally decomposed history: valid
    iff every lane is (locality); an invalid lane's counterexample is the
    history's (its ops are real ops of the full history); steps sum."""
    steps = sum(getattr(r, "steps", 0) or 0 for r in rs)
    for r in rs:
        if r.valid is False:
            return wgl_host.WGLResult(
                valid=False, op=r.op,
                best_linearization=r.best_linearization, steps=steps)
    if any(r.valid == "unknown" for r in rs):
        return wgl_host.WGLResult(valid="unknown", steps=steps)
    return wgl_host.WGLResult(valid=True, steps=steps)


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
            whole = ("gpu_vec" if wgl_vec.batch_eligible(jm, ess)
                     else "gpu_search" if wgl_search.batch_eligible(jm, ess)
                     else "host")
            return [whole] * len(ess)
        return ["gpu_vec" if wgl_vec.batch_eligible(jm, [es])
                else "gpu_row" if wgl_row.batch_eligible(jm, [es])
                else "gpu_search" if wgl_search.batch_eligible(jm, [es])
                else "host" for es in ess]

    def _results(self, model, ess) -> list:
        routes = self._route(model, ess)
        out: list = [None] * len(ess)
        for engine in ("gpu_vec", "gpu_row", "gpu_search", "host"):
            idx = [i for i, r in enumerate(routes) if r == engine]
            if not idx:
                continue
            sub = [ess[i] for i in idx]
            if engine == "host":
                rs = [wgl_host.analysis(model, es, time_limit=self.time_limit)
                      for es in sub]
            else:
                rs = ENGINES[engine].analysis_batch(
                    model, sub, max_steps=self._max_steps(),
                    device=self.device)
            for i, r in zip(idx, rs):
                out[i] = r
        return out

    def _split(self, model, ess):
        """Under "auto", every history's P-compositional lanes flattened
        into one list of (sub_model, Entries), with each history's span
        in it; None when the model declares no split or some history
        does not decompose (then every history takes the full
        search)."""
        if self.algorithm != "auto" or not pcomp.eligible(model):
            return None
        flat: list = []
        spans: list = []
        for es in ess:
            lanes = pcomp.split(model, es)
            if lanes is None:
                return None
            spans.append((len(flat), len(flat) + len(lanes)))
            flat.extend(lanes)
        return flat, spans

    def _component_results(self, comp_lanes) -> list:
        """WGLResults for a flat list of (sub_model, Entries) lanes, one
        batch (routed as any batch) per distinct sub-model."""
        out: list = [None] * len(comp_lanes)
        for m, idxs in pcomp.group_lanes(comp_lanes).items():
            rs = self._results(m, [comp_lanes[i][1] for i in idxs])
            for i, r in zip(idxs, rs):
                out[i] = r
        return out

    def _check_all(self, model, ess) -> list:
        """One WGLResult per history: through the P-compositional split
        when it applies, else through the per-lane routes."""
        split = self._split(model, ess)
        if split is None:
            return self._results(model, ess)
        flat, spans = split
        rs = self._component_results(flat)
        return [_combine_lanes(rs[a:b]) for a, b in spans]

    def check(self, test, history, opts=None) -> dict:
        model = self._model(test)
        (r,) = self._check_all(model, [make_entries(list(history))])
        return self._result(r)

    def check_batch(self, test, items) -> list[dict]:
        """Check many independent histories in one pass — the batched
        path the independent checker takes. `items` is a list of
        (history, per_item_opts); returns one result dict per item."""
        model = self._model(test)
        ess = [make_entries(list(h)) for h, _ in items]
        if not ess:
            return []
        return [self._result(r) for r in self._check_all(model, ess)]

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
