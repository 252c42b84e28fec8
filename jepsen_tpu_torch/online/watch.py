"""The `watch` runner: point a streaming checker at a WAL or foreign
trace (the port's copy of `jepsen_tpu/online/watch.py`).

Wires the pieces end to end: trace ingest (ingest.iter_trace) → workload
rehydration + checker (the registry's workload table, on the device the
options name: None = the card) → frontier (stream.frontier_for) →
StreamSession with an optional state dir holding the crash-safe verdict
log and the closure/per-key memo journal. Each new verdict prints as one
JSON line; the exit code is 1 iff the final verdict is a definite
falsification (unknown passes). A fault of the card raises."""

from __future__ import annotations

import json
import logging
import os
import signal
import threading

from ..device import resolve
from ..serve.registry import WORKLOAD_FACTORIES
from . import ingest
from .stream import (MEMO_JOURNAL_FILE, VERDICT_LOG_FILE, StreamSession,
                     VerdictLog, frontier_for)

log = logging.getLogger("jepsen_tpu_torch.online.watch")

__all__ = ["run_watch"]


def _emit_record(rec) -> None:
    v = rec.get("verdict") or {}
    out = {"prefix": rec["prefix"], "digest": rec["digest"],
           "valid": v.get("valid")}
    for k in ("anomaly-types", "failures", "error"):
        if v.get(k):
            out[k] = v[k]
    print(json.dumps(out, default=str), flush=True)


def run_watch(opts: dict) -> int:
    trace = opts["trace"]
    workload_name = opts.get("workload") or "cycle"
    factory = WORKLOAD_FACTORIES.get(workload_name)
    if factory is None:
        raise ValueError(f"unknown workload {workload_name!r} "
                         f"(known: {sorted(WORKLOAD_FACTORIES)})")
    device = opts.get("device")
    resolve(device)  # no card and no "cpu": raise before reading
    spec = factory(device=device)
    rehydrate = spec.get("rehydrate")

    journal = None
    verdict_log = None
    state_dir = opts.get("state_dir")
    if state_dir:
        from .. import store

        os.makedirs(state_dir, exist_ok=True)
        journal = store.AnalysisJournal(
            None, path=os.path.join(state_dir, MEMO_JOURNAL_FILE))
        verdict_log = VerdictLog(os.path.join(state_dir, VERDICT_LOG_FILE))

    deadline_ms = opts.get("deadline_ms")
    frontier = frontier_for(
        spec["checker"], test={"name": "watch"}, journal=journal,
        window_budget_s=(max(1, int(deadline_ms)) / 1000.0
                         if deadline_ms is not None else None))
    if frontier is None:
        raise ValueError(
            f"workload {workload_name!r} has no streaming frontier")

    stop = threading.Event()
    try:  # graceful stop: the first SIGTERM ends the tail, verdicts stay
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:  # not the main thread (tests drive run_watch)
        pass

    source = ingest.iter_trace(
        trace, follow=bool(opts.get("follow")),
        poll_s=opts.get("poll") or 0.05, stop=stop)
    if rehydrate is not None:
        source = (rehydrate(o) for o in source)

    session = StreamSession(
        source, frontier, window=opts.get("window") or 256,
        verdict_log=verdict_log, emit=_emit_record,
        abort_on_invalid=bool(opts.get("abort_on_invalid")),
        max_ops=opts.get("max_ops"))
    try:
        final = session.run()
    except KeyboardInterrupt:
        stop.set()
        final = session.last_verdict
    finally:
        if journal is not None:
            journal.close()
        if verdict_log is not None:
            verdict_log.close()
    if session.aborted and session.abort_info:
        log.warning("watch: stream falsified at prefix %d (%s)",
                    session.abort_info["prefix"],
                    ", ".join(session.abort_info["anomaly-types"]) or "?")
    return 1 if (isinstance(final, dict)
                 and final.get("valid") is False) else 0
