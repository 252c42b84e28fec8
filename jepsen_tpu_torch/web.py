"""Serving until a signal (the port's copy of
`jepsen_tpu.web.serve_until_signal`; the port has no web UI)."""

from __future__ import annotations

import logging
import threading

from .core import DrainSignal

log = logging.getLogger("jepsen_tpu_torch.web")


def serve_until_signal(server, on_drain=None, what="verdict daemon",
                       poll_s: float = 1.0) -> int:
    """Block until ctrl-C or SIGTERM, then shut `server` down cleanly.

    Returns the exit status the CLI should use: 0 for a ctrl-C, 143
    (128+SIGTERM) for a terminate. The first SIGTERM runs `on_drain`
    (when given) and stops the serve loop; a second SIGTERM force-exits
    through DrainSignal's SystemExit(143) path."""
    stop = threading.Event()

    def drain() -> bool:
        if on_drain is not None:
            try:
                on_drain()
            except Exception:  # noqa: BLE001 — drain is best-effort
                log.warning("drain hook failed", exc_info=True)
        stop.set()
        return True

    sig = DrainSignal(drain, what=what).install()
    code = 0
    try:
        while not stop.is_set():
            stop.wait(poll_s)
    except KeyboardInterrupt:
        pass
    finally:
        sig.uninstall()
        server.shutdown()
    if sig.draining.is_set():
        code = 143
    return code
