"""Elle-style transactional cycle checker (the port's copy of
`jepsen_tpu.checker.cycle`).

The transactional counterpart to checker/linearizable: instead of
searching for a linearization, infer the dependency graph the observed
values force (deps.py — ww/wr/rw/realtime relations, list-append and
rw-register inference) and look for cycles, classified into Adya's
anomalies (anomalies.py — G0/G1c/G-single/G2) via boolean matrix
closure: repeated squaring on the card (ops/closure.py, K3's
counterpart) by default, or the host DFS (ops/closure_host.py) with
engine="host".

Usage::

    from jepsen_tpu_torch.checker import cycle
    cycle.checker(anomalies=["G1c", "G-single"]).check({}, history)

A result looks like::

    {"valid": False, "anomaly-types": ["G-single"],
     "anomalies": {"G-single": [{"cycle": [3, 7, 3], "steps": [
         {"from": 3, "to": 7, "rel": "rw"},
         {"from": 7, "to": 3, "rel": "wr"}], ...}]},
     "cycle-count": 1, "node-count": 120, "component-count": 40}

"valid" is False iff any requested anomaly has a cycle; inference
failures (non-prefix reads, duplicate writes, phantom values) degrade
to "unknown" with the offending detail under "error", and so does a
`test["deadline"]` that passes before the closure is done
({"valid": "unknown", "error": "deadline"}).

With an analysis journal on the test (`test["_analysis_journal"]`, a
store.AnalysisJournal), journaled closures are reused and never
launched again. On a falsified history of a test with a store dir (name
and start_time), timeline-cycle.html with the witness cycles drawn as
relation-labelled arrows is written there (checker/timeline.py).
"""

from __future__ import annotations

import logging
import time

from .. import Checker
from ...history import op as _op
from ...ops.closure import DeadlineExpired
from . import anomalies as _anomalies
from . import deps as _deps
from .anomalies import ANOMALIES, ENGINES, classify
from .deps import DepGraph, IllegalInference, extract

__all__ = [
    "ANOMALIES",
    "CycleChecker",
    "DepGraph",
    "IllegalInference",
    "checker",
    "classify",
    "extract",
]


class CycleChecker(Checker):
    """Dependency-cycle checker over transactional histories.

    anomalies      which Adya anomalies fail the history
    version_order  register-key version order assumption
                   ("write-once" or "value"; list-append keys always
                   recover their order from read prefixes)
    init_values    extra values reads of the initial version may show
                   (e.g. (0,) for the causal counter registers)
    realtime       also infer realtime edges and allow them in cycles
                   (strict serializability flavor)
    engine         None -> the closure on the card (ops/closure.py),
                   over every card when the mesh route takes the batch
                   (anomalies module docstring); "host" -> the host DFS;
                   "mesh" -> the rows sharded over `devices`
    max_witnesses  witness cycles kept per anomaly type
    device         where engine None runs: None = CUDA (raising when it
                   is absent), "cpu" = the kernels' plain versions
    devices        the device list of engine "mesh" (None: every CUDA
                   device; `device.devices`)

    `test["deadline"]`, an absolute time.monotonic() instant, is
    checked before each pad bucket's closure.
    """

    def __init__(self, anomalies=ANOMALIES, *, version_order="write-once",
                 init_values=(), realtime=False, engine=None,
                 max_witnesses=4, device=None, devices=None):
        for a in anomalies:
            if a not in ANOMALIES:
                raise ValueError(
                    f"unknown anomaly {a!r} (known: {ANOMALIES})")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (known: {ENGINES})")
        self.anomalies = tuple(anomalies)
        self.version_order = version_order
        self.init_values = tuple(init_values)
        self.realtime = realtime
        self.engine = engine
        self.max_witnesses = max_witnesses
        self.device = device
        self.devices = devices

    def graph(self, history, key=None) -> DepGraph:
        """The inferred dependency graph (exposed for tests/tools)."""
        return extract(
            history, key=key, version_order=self.version_order,
            init_values=self.init_values, realtime=self.realtime)

    def check(self, test, history, opts=None) -> dict:
        opts = opts or {}
        history = [self._unwrap(_op(o)) for o in history]
        budget = (test or {}).get("deadline")
        try:
            t0 = time.perf_counter()
            g = self.graph(history, key=opts.get("history_key"))
            _anomalies._lap("extract", t0)
            r = classify(g, self.anomalies, realtime=self.realtime,
                         engine=self.engine, device=self.device,
                         devices=self.devices,
                         max_witnesses=self.max_witnesses,
                         journal=(test or {}).get("_analysis_journal"),
                         budget=None if budget is None else float(budget))
        except IllegalInference as e:
            return {"valid": "unknown", "error": e.info}
        except DeadlineExpired:
            # closures that completed are journaled: a retry salvages them
            return {"valid": "unknown", "error": "deadline"}
        out = {"valid": not r["anomaly-types"], **r}
        self._render_invalid(test, history, out, opts)
        return out

    @staticmethod
    def _render_invalid(test, history, result, opts) -> None:
        """On a falsified history with a store attached, write a
        timeline with the witness cycles drawn as relation-labelled
        arrows (checker/timeline.py). A rendering failure is logged and
        does not mask the verdict."""
        if result["valid"] is not False:
            return
        if not (test and test.get("name") and test.get("start_time")):
            return
        try:
            from ... import store
            from .. import timeline

            ws = [w for ws in result["anomalies"].values() for w in ws]
            doc = timeline.render(test, history, witness=ws)
            p = store.path_(
                test, list((opts or {}).get("subdirectory") or []),
                "timeline-cycle.html")
            with open(p, "w") as f:
                f.write(doc)
        except Exception:  # noqa: BLE001 — rendering must not mask verdicts
            logging.getLogger("jepsen_tpu_torch.checker.cycle").warning(
                "timeline-cycle.html rendering failed", exc_info=True)

    @staticmethod
    def _unwrap(o):
        """Unwrap KVTuple txn values when used OUTSIDE independent's
        sharding (a global run over a keyed history): namespace every
        micro-op key with the tuple key so inference stays per-key."""
        # lazy: independent imports checker, which imports this package
        from ...independent import is_tuple
        v = o.value
        if not is_tuple(v) or not isinstance(v.value, (list, tuple)):
            return o
        if not all(_deps.mop.is_op(m) for m in v.value):
            return o
        return o.with_(value=[[m[0], (v.key, m[1]), m[2]]
                              for m in v.value])


def checker(anomalies=ANOMALIES, **kw) -> CycleChecker:
    return CycleChecker(anomalies, **kw)
