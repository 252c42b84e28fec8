"""Analysis of a recorded test and the drain-on-SIGTERM primitive (the
port's copy of `jepsen_tpu.core.analyze`, `log_results` and
`DrainSignal`). The test runner itself (`core.run`, `core.resume`, and
the generators, nemeses, control plane and databases they drive) is not
ported: it never reaches a device, and a port checker is a plain object
the JAX package's runner can call."""

from __future__ import annotations

import logging
import signal
import threading

from . import checker as checker_mod
from .history import index

log = logging.getLogger("jepsen_tpu_torch.core")


class DrainSignal:
    """The FIRST SIGTERM invokes `on_drain` (which returns True when a
    graceful drain was actually initiated) and the process winds down
    through its normal cleanup; a second SIGTERM — or a first one that
    could not start a drain — raises SystemExit(143) so finally blocks
    still fire and the process exits with the conventional 128+SIGTERM
    status.

    Handlers only install from the main thread (the signal module's
    rule); elsewhere install() is a no-op and SIGTERM keeps its prior
    disposition."""

    def __init__(self, on_drain, what: str = "run"):
        self.on_drain = on_drain
        self.what = what
        self.draining = threading.Event()
        self._prev = None
        self._installed = False

    def _on_term(self, signum, frame):
        if not self.draining.is_set():
            initiated = False
            try:
                initiated = bool(self.on_drain())
            except Exception:  # noqa: BLE001 — a broken drain hook must
                #               not swallow the terminate request
                log.warning("drain hook failed", exc_info=True)
            if initiated:
                log.warning("SIGTERM: draining %s (send SIGTERM again "
                            "to force exit)", self.what)
                self.draining.set()
                return
        raise SystemExit(143)

    def install(self) -> "DrainSignal":
        if threading.current_thread() is threading.main_thread():
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_term)
                self._installed = True
            except ValueError:
                self._prev = None
        return self

    def uninstall(self) -> None:
        if self._installed:
            try:
                signal.signal(signal.SIGTERM, self._prev)
            except ValueError:
                pass
            self._installed = False


def analyze(test) -> dict:
    """Index the history, run the test's checker under check_safe (a
    fault of the card raises), persist the results (core.clj:506-523).
    With a store attached (name and start_time), finished analysis units
    journal to analysis.ckpt.jsonl (store.AnalysisJournal) as they
    complete — the independent checker's per-key verdicts and the cycle
    checker's closures — so analysing the same history again skips
    them; results.json and test.json are then written (store.save_2)."""
    from . import store

    log.info("Analyzing...")
    hist = test["history"]
    if any(o.index != i for i, o in enumerate(hist)):
        test["history"] = index(hist)
    journal = None
    if test.get("name") and test.get("start_time"):
        try:
            journal = store.AnalysisJournal(test)
        except OSError:  # journaling is best-effort
            log.warning("couldn't open analysis journal", exc_info=True)
        else:
            test["_analysis_journal"] = journal
    try:
        test["results"] = checker_mod.check_safe(
            test["checker"], test, test["history"], {})
    finally:
        if journal is not None:
            test.pop("_analysis_journal", None)
            journal.close()
    if test.get("_online_abort") and isinstance(test["results"], dict):
        # an early abort changed when the run stopped, not what the
        # batch analysis concluded; surface both
        test["results"]["online-abort"] = test["_online_abort"]
    log.info("Analysis complete")
    if test.get("name") and test.get("start_time"):
        store.save_2(test)
    return test


def log_results(test) -> dict:
    """Log the verdict (core.clj:996-1004)."""
    r = test.get("results", {})
    if r.get("valid") is True:
        log.info("Everything looks good! (valid)")
    elif r.get("valid") == "unknown":
        log.warning("Analysis returned :unknown")
    else:
        log.warning("Analysis invalid!")
    return test
