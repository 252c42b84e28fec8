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
  "native"   ops/wgl_native.py — the C++ search on the host (the same
             algorithm and search order as "host", no bound on its
             memo), for the models with an int32 encoding; lanes over a
             thread pool.
  "host"     ops/wgl_host.py — the Python search (knossos.wgl analog).
  "linear"   ops/linear.py — just-in-time linearization over
             configurations (knossos.linear analog): one in-order sweep
             carrying every reachable (state, early-linearized)
             configuration. `check_batch` runs `check` per lane.
  "competition" linear raced against one WGL entrant, the first
             definite verdict winning (knossos.competition,
             checker.clj:125-127): the card's search
             (wgl_search.analysis, K2's counterpart) when the model has
             a kernel encoding and the lane's payloads encode, else
             native when it takes the lane, else the host search. The
             losing thread is abandoned (`_abandoned_racers`, joined at
             exit under one shared 120-s bound). Unlike the JAX
             package, no error of the card's search and no build
             fault of an entrant is turned into "unknown": `check`
             raises it when it arrives before the race is decided,
             and `_drain_racers()` raises one that an abandoned loser
             met later. A missing card raises from `check` before the
             race starts. `check_batch` runs `check` per lane.
  "auto"     first the P-compositional split (ops/pcomp.py) where the
             model declares one and every history decomposes: every
             item's micro-lanes flatten into one batch per sub-model,
             and each item's verdict recombines from its own lanes.
             Then the batched policy of the JAX package
             (`jepsen_tpu/checker/linearizable.py` `_auto_results`),
             with the card in the TPU's place (`_auto_results` below):
             `_route` names each lane's card engine; a group of lanes
             of one engine at or past that engine's bar for the
             model's kind (GPU_BATCH_MIN) goes to the card whole; the rest are
             triaged by the native engine at TRIAGE_MAX_STEPS, and
             their hard tail is finished by native with no step budget,
             or goes to its card engine when the tail of its group
             reaches the bar. Lanes native cannot take go to their card
             engine, else to the host search. A lane a card engine left
             "unknown" (its bounded memo or step budget ran out) that
             native takes is finished by native (NATIVE_FINISH counts
             them). Every route is decided from eligibility and from
             results, never from a failure: a kernel or a native
             library that fails raises. A single `check` is a batch of
             one.

The mesh route (the JAX package's `wgl_mesh` rung, its eligibility in
`checker/supervisor.py:489-506`): with the default device (None) and two
or more CUDA devices (`device.mesh`), a `gpu_search` call — explicit, or
a card group of "auto" — whose lanes number at least the card count and
`calibrate.mesh_lanes_min()` is dealt over every card
(`wgl_search.analysis_batch(devices=...)`). The route is decided before
anything launches, and there is no demotion: a fault of a shard raises.
With one card, or an explicit device, every call is the single-device
one.

`test["deadline"]` (an absolute time.monotonic() instant) is checked
before every engine call but `auto`'s native triage: past it, the lanes
that call would have taken come back {"valid": "unknown", "error":
"deadline"}; a call that started is not interrupted. The triage runs as
the JAX package's does, with no budget check and no time limit, only
TRIAGE_MAX_STEPS, so past the budget a batch still resolves its easy
lanes. The JAX package checks one history that does not split in one
budget-checked engine call, so `check` of such a history checks the
budget first. The micro-lanes of one check share one time_limit.

Results have the JAX package's shape: valid, op + final_paths for an
invalid history (truncated to TRUNCATE ops), linear's configs
(truncated to TRUNCATE), error for an unknown one that has a reason,
cache_size, steps. On an invalid verdict of a test with a store dir
(name and start_time), `check` and `check_batch` write linear.svg of
the failed window there (checker/linear_report.py) and name it under
"counterexample_svg".
"""

from __future__ import annotations

import atexit
import logging
import threading
import time
from typing import Any

from .. import device as device_mod
from ..device import resolve
from ..history import entries as make_entries
from ..models import Model
from ..models import jit as mjit
from ..ops import (linear as linear_mod, pcomp, wgl_host, wgl_native,
                   wgl_row, wgl_search, wgl_vec)
from ..ops.common import STEPS_PER_SEC_ESTIMATE
from . import Checker, calibrate, is_fault

TRUNCATE = 10
ALGORITHMS = ("auto", "gpu_vec", "gpu_row", "gpu_search", "native", "host",
              "linear", "competition")

#: threads of entrants that lost a "competition" race and still run; each
#: is named "competition-<entrant>"
_abandoned_racers: list = []
#: faults those threads met after their race was decided, raised by
#: `_drain_racers`
_racer_faults: list = []
_racers_lock = threading.Lock()

#: races won by each entrant since the process started (chip_smoke.py
#: reads them around its competition run)
COMPETITION_WINS = {"linear": 0, "wgl_search": 0, "native": 0, "host": 0}


@atexit.register
def _drain_racers():
    """Join every abandoned racer under one shared 120-s bound (however
    many races), then raise the first fault one of them met after its
    race was decided."""
    deadline = time.monotonic() + 120
    with _racers_lock:
        racers = list(_abandoned_racers)
    for t in racers:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    with _racers_lock:
        _abandoned_racers[:] = [t for t in _abandoned_racers if t.is_alive()]
        faults = list(_racer_faults)
        _racer_faults.clear()
    if faults:
        raise faults[0]


ENGINES = {"gpu_vec": wgl_vec, "gpu_row": wgl_row, "gpu_search": wgl_search}

#: the native triage's step budget under "auto" (the JAX package's
#: TRIAGE_MAX_STEPS): a typical valid lane resolves well inside it
TRIAGE_MAX_STEPS = 2_000

#: the model kinds the bars are keyed by beside the card engine: each
#: queue model apart; the models with a one-word state (cas-register,
#: register, mutex) as one, "scalar"
QUEUE_KINDS = ("unordered-queue", "fifo-queue")

#: per (card engine, model kind) that "auto" can route, the fewest lanes
#: of one batch (or of its hard tail) that "auto" sends to the card rather
#: than to the native engine: ceil(t_rt / (slope_native - slope_card))
#: from `chip_smoke.py --only crossover`, on hard lanes of that engine's
#: range and that kind, the median of three runs (None: the card's
#: per-lane slope is not below native's, so native always; in the
#: median None ranks above every number). Measured on NVIDIA H100 80GB
#: HBM3, power limit 700.00 W, with os.cpu_count() 8 on its host; the
#: three runs' bars in the comment.
GPU_BATCH_MIN = {
    ("gpu_vec", "scalar"): 4849,              # 17880, 3840, 4849
    ("gpu_vec", "unordered-queue"): None,     # None, None, None
    ("gpu_vec", "fifo-queue"): None,          # None, None, None
    ("gpu_row", "scalar"): 4,                 # 5, 4, 3
    ("gpu_search", "scalar"): 7,              # 7, 10, 5
    ("gpu_search", "unordered-queue"): 1,     # 1, 1, 1
    ("gpu_search", "fifo-queue"): 1,          # 1, 1, None
}

#: lanes a card engine returned "unknown" without an error that the
#: native engine then finished under "auto", since the process started
#: (chip_smoke.py sets it to 0 before a path and reads it after)
NATIVE_FINISH = 0


def bar_kind(model) -> str:
    """The model kind of GPU_BATCH_MIN's keys: a queue model's kernel
    name, else "scalar"."""
    name = getattr(mjit.for_model(model), "name", None)
    return name if name in QUEUE_KINDS else "scalar"


def _card_present(device) -> bool:
    """Does the checker's device resolve to the card? (None means CUDA
    and raises CudaUnavailable without it; "cpu" is a host without a
    card, whose card engines run their plain versions.)"""
    return resolve(device).type == "cuda"


def _expired(budget) -> bool:
    return budget is not None and time.monotonic() >= budget


def _deadline_result():
    return wgl_host.WGLResult(valid="unknown", error="deadline")


def _combine_lanes(rs: list):
    """One WGLResult for a P-compositionally decomposed history: valid
    iff every lane is (locality); an invalid lane's counterexample is the
    history's (its ops are real ops of the full history); steps sum; an
    unknown lane's error survives."""
    steps = sum(getattr(r, "steps", 0) or 0 for r in rs)
    for r in rs:
        if r.valid is False:
            return wgl_host.WGLResult(
                valid=False, op=r.op,
                best_linearization=r.best_linearization, steps=steps)
    if any(r.valid == "unknown" for r in rs):
        error = next((r.error for r in rs
                      if r.valid == "unknown" and r.error), None)
        return wgl_host.WGLResult(valid="unknown", steps=steps, error=error)
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
        """The engine of each lane, decided before anything launches:
        under "auto", the card engine that takes it (or the host), by
        which "auto" groups lanes and holds them against GPU_BATCH_MIN."""
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

    @staticmethod
    def _budget(test):
        """The caller's absolute time.monotonic() verdict budget,
        `test["deadline"]`, or None."""
        b = (test or {}).get("deadline")
        return None if b is None else float(b)

    def _deadline(self):
        """One wall-clock deadline for the micro-lanes of one check: they
        share one time_limit (per-lane limits would multiply it by the
        lane count)."""
        return (None if self.time_limit is None
                else time.monotonic() + self.time_limit)

    def _lane_limit(self, deadline, budget):
        """The time limit of a host or native search: the shared
        deadline's remainder when there is one, else time_limit; capped
        by the budget's remainder."""
        now = time.monotonic()
        lim = (self.time_limit if deadline is None
               else max(0.001, deadline - now))
        if budget is not None:
            rem = max(0.001, budget - now)
            lim = rem if lim is None else min(lim, rem)
        return lim

    def _mesh(self, engine, ess) -> list | None:
        """The cards a call of `engine` over `ess` is dealt over (module
        docstring, the mesh route), or None for the single-device call."""
        if engine != "gpu_search":
            return None
        devs = device_mod.mesh(self.device)
        if devs is None or len(ess) < max(len(devs),
                                          calibrate.mesh_lanes_min()):
            return None
        return devs

    def _call(self, engine, model, ess, budget=None, time_limit=None,
              max_steps=None, jms=None) -> list:
        """One engine call over `ess`; when the budget has passed, none:
        every lane comes back unknown with error "deadline". The card
        engines take time_limit as a step budget; native and the host
        search take `time_limit` (and native `max_steps`, and `jms`, the
        lanes' JitModels where they are already resolved)."""
        if not ess:
            return []
        if _expired(budget):
            return [_deadline_result() for _ in ess]
        if engine in ENGINES:
            mesh = self._mesh(engine, ess)
            if mesh is not None:
                return wgl_search.analysis_batch(
                    model, ess, max_steps=self._max_steps(), devices=mesh)
            return ENGINES[engine].analysis_batch(
                model, ess, max_steps=self._max_steps(), device=self.device)
        if engine == "native":
            return wgl_native.analysis_batch(
                model, ess, max_steps=max_steps, time_limit=time_limit,
                jms=jms)
        return [wgl_host.analysis(model, es, time_limit=time_limit)
                for es in ess]

    def _results(self, model, ess, deadline=None, budget=None) -> list:
        if self.algorithm == "auto":
            return self._auto_results(model, ess, deadline, budget)
        return self._call(self.algorithm, model, ess, budget,
                          self._lane_limit(deadline, budget))

    def _auto_results(self, model, ess, deadline=None, budget=None) -> list:
        """The batched "auto" policy (module docstring): whole groups to
        the card at their bar, native triage and finish for the rest, the
        hard tail of a group to the card at its bar, lanes native cannot
        take to their card engine or the host, and card unknowns that
        native takes finished by native."""
        global NATIVE_FINISH
        card = _card_present(self.device)
        kind = bar_kind(model)
        routes = self._route(model, ess)
        n = len(ess)

        def bar(engine):
            b = GPU_BATCH_MIN.get((engine, kind))
            return b if card and b is not None else None

        def at_bar(engine, idx) -> bool:
            b = bar(engine)
            return b is not None and len(idx) >= b

        to_card: dict = {e: [] for e in ENGINES}
        for e in ENGINES:
            idx = [i for i in range(n) if routes[i] == e]
            if idx and at_bar(e, idx):
                to_card[e] = idx
        taken = {i for idx in to_card.values() for i in idx}
        # each lane's native encoding, resolved once for every native call
        jms = [wgl_native.resolve(model, es) for es in ess]
        left = [i for i in range(n) if i not in taken]
        native_ok = [i for i in left if jms[i] is not None]
        others = [i for i in left if jms[i] is None]
        out: list = [None] * n
        hard = []
        # the triage, as the JAX package's: no budget, no time limit
        for i, r in zip(native_ok, self._call(
                "native", model, [ess[i] for i in native_ok],
                max_steps=TRIAGE_MAX_STEPS, jms=[jms[i] for i in native_ok])):
            if r.valid == "unknown" and not r.error:
                hard.append(i)
            else:
                out[i] = r
        finish = [i for i in hard if routes[i] not in ENGINES]
        for e in ENGINES:
            tail = [i for i in hard if routes[i] == e]
            if tail and at_bar(e, tail):
                to_card[e] += tail
            else:
                finish += tail
        self._fill(out, finish, "native", model, ess, deadline, budget, jms)
        host = []
        for i in others:
            (to_card[routes[i]] if routes[i] in ENGINES else host).append(i)
        for e, idx in to_card.items():
            self._fill(out, sorted(idx), e, model, ess, deadline, budget)
        self._fill(out, host, "host", model, ess, deadline, budget)
        # a card engine's unknown without an error ran out of its memo or
        # its step budget: native finishes the lanes it takes
        redo = [i for idx in to_card.values() for i in idx
                if out[i].valid == "unknown" and not out[i].error
                and jms[i] is not None]
        NATIVE_FINISH += len(redo)
        self._fill(out, sorted(redo), "native", model, ess, deadline, budget,
                   jms)
        return out

    def _fill(self, out, idx, engine, model, ess, deadline, budget,
              jms=None) -> None:
        """out[i] for every i of idx, from one call of `engine`."""
        for i, r in zip(idx, self._call(
                engine, model, [ess[i] for i in idx], budget,
                self._lane_limit(deadline, budget),
                jms=None if jms is None else [jms[i] for i in idx])):
            out[i] = r

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

    def _component_results(self, comp_lanes, budget=None) -> list:
        """WGLResults for a flat list of (sub_model, Entries) lanes, one
        batch (routed as any batch) per distinct sub-model, all under
        one shared deadline."""
        deadline = self._deadline()
        out: list = [None] * len(comp_lanes)
        for m, idxs in pcomp.group_lanes(comp_lanes).items():
            rs = self._results(m, [comp_lanes[i][1] for i in idxs],
                               deadline, budget)
            for i, r in zip(idxs, rs):
                out[i] = r
        return out

    def _check_all(self, model, ess, budget=None) -> list:
        """One WGLResult per history: through the P-compositional split
        when it applies, else through the per-lane routes."""
        split = self._split(model, ess)
        if split is None:
            return self._results(model, ess, budget=budget)
        flat, spans = split
        rs = self._component_results(flat, budget)
        return [_combine_lanes(rs[a:b]) for a, b in spans]

    def check(self, test, history, opts=None) -> dict:
        model = self._model(test)
        history = list(history)
        es = make_entries(history)
        budget = self._budget(test)
        if self.algorithm == "competition":
            d = self._competition(model, es)
        elif self.algorithm == "linear":
            d = self._result(
                _deadline_result() if _expired(budget)
                else linear_mod.analysis(model, es,
                                         time_limit=self.time_limit))
        elif _expired(budget) and self._split(model, [es]) is None:
            # the JAX package checks one history that does not split in
            # one budget-checked engine call, triage or not
            d = self._result(_deadline_result())
        else:
            (r,) = self._check_all(model, [es], budget)
            d = self._result(r)
        self._render_invalid(test, history, d, opts)
        return d

    def check_batch(self, test, items) -> list[dict]:
        """Check many independent histories in one pass — the batched
        path the independent checker takes. `items` is a list of
        (history, per_item_opts); returns one result dict per item.
        Under "linear" and "competition", `check` per item."""
        items = [(list(h), o) for h, o in items]
        if self.algorithm in ("linear", "competition"):
            return [self.check(test, h, o) for h, o in items]
        model = self._model(test)
        ess = [make_entries(h) for h, _ in items]
        if not ess:
            return []
        out = [self._result(r)
               for r in self._check_all(model, ess, self._budget(test))]
        for (h, o), d in zip(items, out):
            self._render_invalid(test, h, d, o)
        return out

    @staticmethod
    def _render_invalid(test, history, d, opts) -> None:
        """On an invalid verdict, write linear.svg of the failed window
        into the test's store dir (checker.clj:130-137). A rendering
        failure is logged and does not mask the verdict."""
        if d.get("valid") is not False:
            return
        from . import linear_report
        from .perf import out_path

        path = out_path(test or {}, opts, "linear.svg")
        if path is None:
            return
        try:
            written = linear_report.render_analysis(history, d, path)
            if written:
                d["counterexample_svg"] = written
        except Exception:  # noqa: BLE001 — rendering must not mask verdicts
            logging.getLogger("jepsen_tpu_torch.checker.linearizable"
                              ).warning("linear.svg rendering failed",
                                        exc_info=True)

    def _wgl_entrant(self, model, es) -> tuple:
        """(name, thunk) of competition's WGL entrant: the card's search
        when the model has a kernel encoding and the lane's payloads
        encode, else native when it takes the lane, else the host
        search."""
        jm = mjit.for_model(model)
        if jm is not None and jm.lane_eligible(es):
            # a missing card raises here, before any race is run
            device = resolve(self.device)
            return "wgl_search", lambda: wgl_search.analysis(
                model, es, time_limit=self.time_limit, device=device)
        if wgl_native.eligible(model, es):
            return "native", lambda: wgl_native.analysis(
                model, es, time_limit=self.time_limit)
        return "host", lambda: wgl_host.analysis(
            model, es, time_limit=self.time_limit)

    def _competition(self, model, es) -> dict:
        """Race linear against the WGL entrant (`_wgl_entrant`); the
        first definite verdict wins (knossos.competition,
        checker.clj:125-127). A host entrant's exception reads "unknown"
        with its text under "error", as in the JAX package, except a
        fault of a build (`is_fault`). Every exception of the card's search
        is a fault (a failed launch, an out-of-memory, an illegal
        address that surfaces at a later sync). A fault is raised here
        when it arrives before the race is decided, else kept for
        `_drain_racers`."""
        entrants = [("linear", lambda: linear_mod.analysis(
            model, es, time_limit=self.time_limit)),
            self._wgl_entrant(model, es)]
        done = threading.Event()
        results: dict = {}
        faults: list = []

        def run(name, fn):
            try:
                r = fn()
            except Exception as e:  # noqa: BLE001
                if name != "wgl_search" and not is_fault(e):
                    r = wgl_host.WGLResult(valid="unknown", error=str(e))
                else:
                    with _racers_lock:
                        (_racer_faults if done.is_set() else faults).append(e)
                        done.set()
                    return
            with _racers_lock:
                results[name] = r
                if r.valid != "unknown" or len(results) == len(entrants):
                    done.set()

        threads = [threading.Thread(target=run, args=(name, fn),
                                    name=f"competition-{name}", daemon=True)
                   for name, fn in entrants]
        for t in threads:
            t.start()
        done.wait()
        with _racers_lock:
            for t in threads:
                if t.is_alive():
                    _abandoned_racers.append(t)
            if faults:
                raise faults[0]
            for name, r in results.items():
                if r.valid != "unknown":
                    COMPETITION_WINS[name] += 1
                    return self._result(r)
            return self._result(next(iter(results.values())))

    def _result(self, r) -> dict:
        d: dict[str, Any] = {"valid": r.valid}
        if r.valid is False:
            if r.op is not None:
                d["op"] = r.op.to_dict()
            if r.best_linearization is not None:
                d["final_paths"] = [
                    [o.to_dict() for o in r.best_linearization[:TRUNCATE]]
                ]
        # knossos.linear results carry :configs (checker.clj:138-141)
        configs = getattr(r, "configs", None)
        if configs:
            d["configs"] = configs[:TRUNCATE]
        error = getattr(r, "error", None)
        if r.valid == "unknown" and error:
            d["error"] = error
        d["cache_size"] = r.cache_size
        d["steps"] = r.steps
        return d


def linearizable(model=None, algorithm="auto", time_limit=None,
                 device=None) -> Linearizable:
    return Linearizable(model, algorithm, time_limit, device)
