"""The drain-on-SIGTERM primitive (the port's copy of the part of
`jepsen_tpu.core.DrainSignal` that `web.serve_until_signal` uses; the
test runner itself is not ported)."""

from __future__ import annotations

import logging
import signal
import threading

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
