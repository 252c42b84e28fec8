"""In-run online monitoring: stream the live history through a frontier
and abort doomed runs early (the port's copy of
`jepsen_tpu/online/monitor.py`).

A runner starts a ``RunMonitor`` over a test map that carries the live
history (``test["_history"]`` under ``test["_history_lock"]``), the
checker (``test["checker"]``) and the drain gate (``test["_drain"]``, a
threading.Event the workers' generator honors). The monitor thread polls
the history, feeds the frontier matching the checker
(``stream.frontier_for``), and advances every ``window`` new ops. On a
definite ``valid: False`` it records the abort under
``test["_online_abort"]`` and sets ``test["_drain"]``, so workers finish
their in-flight ops and the run winds down, its batch analysis still
run over everything that happened.

The monitor is advisory: its verdicts never substitute for the batch
analysis, and an ordinary exception disables it (logged), never the
run. Unlike the JAX package, a fault of the card or of a build
(checker.is_fault) does not vanish that way: the monitor keeps the first
one and ``stop()`` raises it.
"""

from __future__ import annotations

import logging
import threading

from ..checker import is_fault
from .stream import frontier_for

log = logging.getLogger("jepsen_tpu_torch.online.monitor")

__all__ = ["RunMonitor"]

DEFAULT_WINDOW = 128


class RunMonitor:
    """Poll a live test's history through a streaming frontier."""

    def __init__(self, test, *, window: int | None = None,
                 poll_s: float = 0.05):
        cfg = test.get("online")
        cfg = cfg if isinstance(cfg, dict) else {}
        self.test = test
        self.window = int(window or cfg.get("window") or DEFAULT_WINDOW)
        self.poll_s = float(cfg.get("poll_s") or poll_s)
        self.frontier = frontier_for(test.get("checker"), test=test)
        self.aborted = False
        self.abort_info: dict | None = None
        self.fault: BaseException | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def supported(self) -> bool:
        return self.frontier is not None

    def start(self) -> "RunMonitor":
        if not self.supported:
            log.info("online monitor: checker %s has no streaming "
                     "frontier; monitoring disabled",
                     type(self.test.get("checker")).__name__)
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="jepsen online monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread; raise the fault of the card it met, if any."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.fault is not None:
            raise self.fault

    # -- internals ---------------------------------------------------------

    def _snapshot(self, seen: int) -> list:
        hist = self.test.get("_history")
        lock = self.test.get("_history_lock")
        if hist is None or lock is None:
            return []
        with lock:
            return list(hist[seen:])

    def _loop(self) -> None:
        seen = 0
        try:
            while not self._stop.is_set():
                new = self._snapshot(seen)
                seen += len(new)
                self.frontier.extend(new)
                if self.frontier.pending >= self.window:
                    if self._advance():
                        return
                else:
                    self._stop.wait(self.poll_s)
            # final look on shutdown: one last advance over whatever
            # arrived, so short runs still get a streamed verdict
            self.frontier.extend(self._snapshot(seen))
            if self.frontier.pending:
                self._advance()
        except Exception as e:  # noqa: BLE001 — advisory, never kills it
            if is_fault(e):
                log.error("online monitor: fault of the card; stop() "
                          "raises it", exc_info=True)
                self.fault = e
                return
            log.warning("online monitor died; run continues unmonitored",
                        exc_info=True)

    def _advance(self) -> bool:
        """One frontier advance; True when the run was aborted."""
        v = self.frontier.advance()
        if not (isinstance(v, dict) and v.get("valid") is False):
            return False
        self.aborted = True
        self.abort_info = {
            "op-count": int(self.frontier.checked),
            "anomaly-types":
                v.get("anomaly-types")
                or sorted(map(str, v.get("failures") or [])),
        }
        self.test["_online_abort"] = self.abort_info
        log.warning("online monitor: anomaly at op %d (%s); draining run",
                    self.abort_info["op-count"],
                    ", ".join(self.abort_info["anomaly-types"]) or "?")
        drain = self.test.get("_drain")
        if drain is not None:
            self.test["_preempted_by_monitor"] = True
            drain.set()
        return True
