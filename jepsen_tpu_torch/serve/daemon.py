"""The resident verdict daemon: HTTP front end + check worker (the port's
counterpart of `jepsen_tpu/serve/daemon.py`).

``python -m jepsen_tpu_torch serve --daemon`` runs it. The daemon owns
one EngineRegistry (warmed through the engine bundle, on one device),
one DurableQueue, and one worker thread that drains the queue in
weighted-round-robin batches:

* jobs of a **packable** workload (independent-key histories) are packed
  across runs — MANY clients' histories flatten into ONE batched engine
  pass via ``independent.pack_check``, which P-compositionality licenses
  (each key lane's verdict is independent of the run it arrived with),
  so pooled lanes reach the card's bars (GPU_BATCH_MIN) sooner than any
  one run's would;
* other workloads check per job through ``checker.check_safe``.

Only the worker launches kernels, on the registry's device; the HTTP
handler threads read the queue and the registry.

Endpoints (stdlib ThreadingHTTPServer)::

    POST /submit            {client, workload, history, weight?,
                             deadline_ms?} -> {id}
                            429 + Retry-After when the queue is full,
                            503 + Retry-After while draining
    GET  /verdict/<id>      the committed verdict; 202 while pending
                            (?wait=SECONDS long-polls)
    GET  /stream            JSONL of verdicts as they commit
    GET  /healthz           liveness + the card topology + the last
                            fault of the card
    GET  /readyz            readiness: bundle, the card's memory, faults;
                            503 while draining or after a fault
    GET  /stats             queue depth, per-client backlog

SIGTERM drains (core.DrainSignal): the first signal closes admission
(submits get 503), lets the worker finish and commit its in-flight batch
— unanswered specs stay durable for the next start — and exits 143; a
second SIGTERM force-exits.

Failure containment (the attempt ledger in serve/queue.py), as in the
JAX package:

* every batch charges its jobs one durable attempt BEFORE checking
  begins, so a history that kills the daemon still burns attempts;
* after a crash, the blamed in-flight jobs are *suspects*: the worker
  drains the healthy backlog first, then re-runs each suspect in a
  **sacrificial subprocess** (serve/sacrifice.py) under capped
  exponential backoff, and quarantines it once ``max_attempts`` is spent;
* a job submitted with ``deadline_ms`` checks alone with the remaining
  budget stamped on its test; expiry commits ``unknown: deadline``;
* a workload whose check raises an ordinary exception commits
  ``unknown: workload ... failed`` for its jobs;
* the worker thread is supervised: an uncaught exception is logged,
  counted, and the loop restarts under backoff.

Unlike the JAX package, a fault of the card or of a build
(checker.is_fault: a kernel that fails to build or launch, a missing
card, the card out of memory, a CUDA error that surfaces at a sync)
commits NO verdict for the batch's jobs: they stay in flight in the
attempt ledger, so the next start blames them as suspects. The daemon
records the fault in the registry (``last_fault``), names it on
/healthz, answers /readyz with 503, and its worker takes no more work —
an orchestrator rotates the daemon. A fault in a sacrificial
child (its exit code FAULT_EXIT) is recorded the same way.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from .. import store
from ..checker import check_safe, is_fault
from ..history import Op, index as index_history

log = logging.getLogger("jepsen_tpu_torch.serve.daemon")

#: a suspect's re-run waits SUSPECT_BACKOFF_S x 2^(attempts - 1),
#: capped, and is given SUSPECT_TIMEOUT_S (or its deadline)
SUSPECT_BACKOFF_S = 1.0
SUSPECT_BACKOFF_CAP_S = 30.0
SUSPECT_TIMEOUT_S = 600.0
#: exit code of a sacrificial child whose check met a fault of the card
FAULT_EXIT = 3


def _jsonable(v):
    """Verdicts normalized exactly as store.write_json persists them, so
    a daemon verdict compares bit for bit against a one-shot run's
    stored results."""
    return json.loads(json.dumps(store._json_keys(v),
                                 default=store._json_default))


class _Faulted(Exception):
    """The worker met a fault of the card; it takes no more work."""


class VerdictDaemon:
    """Queue + registry + the single check worker."""

    def __init__(self, queue, registry, batch_max: int = 64):
        self.queue = queue
        self.registry = registry
        self.batch_max = batch_max
        self.draining = threading.Event()
        self.ready = threading.Event()
        self._worker_lock = threading.Lock()
        self.worker_deaths = 0
        self.last_death: dict | None = None
        self._worker = threading.Thread(
            target=self._run_guarded, name="serve verdict worker",
            daemon=True)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._worker.start()

    @property
    def last_fault(self) -> dict | None:
        """The last fault of the card the worker met (kept in the
        registry), or None."""
        return self.registry.last_fault

    @property
    def faulted(self) -> bool:
        return self.last_fault is not None

    def worker_state(self) -> dict:
        """Liveness + death history for /healthz."""
        with self._worker_lock:
            return {"alive": self._worker.is_alive(),
                    "deaths": self.worker_deaths,
                    "last_death": self.last_death}

    def ensure_worker(self) -> None:
        """Respawn the worker thread if it is dead for no reason the
        daemon knows of (not draining, not stopped by a fault). Called
        from request handlers: accepting a job implies someone runs
        it."""
        with self._worker_lock:
            if (self._worker.is_alive() or self.draining.is_set()
                    or self.faulted or not self.ready.is_set()):
                return
            log.error("verdict worker thread is dead; respawning")
            self._worker = threading.Thread(
                target=self._run_guarded, name="serve verdict worker",
                daemon=True)
            self._worker.start()

    def drain(self) -> bool:
        """First-SIGTERM hook: close admission, let the in-flight batch
        commit, stop. Always initiates (returns True)."""
        self.draining.set()
        with self.queue._cv:
            self.queue._cv.notify_all()
        return True

    def join(self, timeout: float | None = None) -> None:
        self._worker.join(timeout)

    def _fault(self, exc: BaseException, where: str) -> None:
        """Record a fault of the card; the worker then stops."""
        self.registry.record_fault(exc, where)
        log.error("fault of the card in %s: %s; the batch's jobs stay in "
                  "flight and this daemon takes no more work", where,
                  self.last_fault["error"])

    # -- the check loop ----------------------------------------------------

    def _rehydrate(self, spec) -> list:
        wl = self.registry.workload(spec["workload"])
        ops = [Op.from_dict(d) for d in spec["history"]]
        if wl["rehydrate"] is not None:
            ops = [wl["rehydrate"](o) for o in ops]
        return index_history(ops)

    def _check_group(self, workload: str, specs: list) -> list:
        """Verdicts for one workload's batch of specs, aligned. The test
        stub carries no start_time, so checkers write no artifacts — the
        verdict file is the daemon's artifact."""
        wl = self.registry.workload(workload)
        test = {"name": f"serve-{workload}"}
        histories = [self._rehydrate(s) for s in specs]
        if wl.get("packable") and len(histories) > 1:
            from .. import independent

            return independent.pack_check(wl["checker"], test, histories)
        return [check_safe(wl["checker"], test, h) for h in histories]

    def _run_guarded(self) -> None:
        """The worker thread body: _run() under a crash guard. An
        ordinary uncaught exception is a worker death — logged, counted
        for /healthz, and the loop restarts under capped backoff. A fault
        of the card ends the worker for good."""
        while True:
            try:
                self._run()
                return  # clean drain exit
            except _Faulted:
                return
            except Exception as e:  # noqa: BLE001 — anything else is a
                #                     thread death we must survive
                if is_fault(e):
                    self._fault(e, "verdict worker")
                    return
                with self._worker_lock:
                    self.worker_deaths += 1
                    deaths = self.worker_deaths
                    self.last_death = {
                        "error": f"{type(e).__name__}: {e}",
                        "time": time.time()}
                log.exception("verdict worker died (death #%d); "
                              "restarting", deaths)
                if self.draining.is_set():
                    return
                time.sleep(min(5.0, 0.1 * (2 ** min(deaths, 6))))

    def _check_deadline_spec(self, spec, remaining: float) -> None:
        """One deadline'd job, checked alone — NEVER packed (a pack
        shares one launch; a tight deadline must not drag sibling jobs
        to unknown) — with the remaining budget stamped on the test,
        which the checkers honor before each engine call."""
        workload = spec["workload"]
        wl = self.registry.workload(workload)
        test = {"name": f"serve-{workload}",
                "deadline": time.monotonic() + remaining}
        try:
            verdict = check_safe(wl["checker"], test, self._rehydrate(spec))
        except Exception as e:  # noqa: BLE001 — a broken workload must
            #                     not wedge the queue
            if is_fault(e):
                self._fault(e, f"job {spec['id']}")
                raise _Faulted from e
            log.exception("workload %s deadline job failed", workload)
            verdict = {"valid": "unknown",
                       "error": f"workload {workload} failed"}
        self.queue.commit(spec["id"], _jsonable(verdict))

    def _handle_suspect(self) -> bool:
        """Run ONE suspect (a job blamed for a previous crash) in a
        sacrificial subprocess, or quarantine it when its attempts are
        spent. Returns True when a suspect was handled."""
        spec = self.queue.take_suspect()
        if spec is None:
            return False
        jid = spec["id"]
        n = self.queue.attempts_of(jid)
        if n >= self.queue.max_attempts:
            self.queue.quarantine(jid)
            return True
        # capped exponential backoff on the attempt number: a poison job
        # must not turn the restart loop into a tight crash loop
        time.sleep(min(SUSPECT_BACKOFF_CAP_S,
                       SUSPECT_BACKOFF_S * (2 ** max(0, n - 1))))
        self.queue.begin_attempts([jid])
        self._run_sacrificial(spec)
        if not self.queue.refresh_done(jid) \
                and self.queue.attempts_of(jid) >= self.queue.max_attempts:
            self.queue.quarantine(jid)
        return True

    def _run_sacrificial(self, spec) -> None:
        """python -m jepsen_tpu_torch.serve.sacrifice <queue> <id>
        [--device D]: the subprocess rehydrates and checks the job on the
        registry's device, committing its verdict straight to the queue
        directory — a SIGKILL or abort takes the child, not the daemon.
        A child that exits FAULT_EXIT met a fault of the card: recorded,
        and the worker stops."""
        import subprocess
        import sys

        jid = spec["id"]
        remaining = self.queue.remaining_s(spec)
        timeout = SUSPECT_TIMEOUT_S
        if remaining is not None:
            timeout = min(timeout, max(1.0, remaining))
        log.warning("running suspect %s in a sacrificial subprocess "
                    "(attempt %d/%d)", jid, self.queue.attempts_of(jid),
                    self.queue.max_attempts)
        cmd = [sys.executable, "-m", "jepsen_tpu_torch.serve.sacrifice",
               self.queue.root, jid]
        if self.registry.device is not None:
            cmd += ["--device", str(self.registry.device)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired:
            log.warning("sacrificial check of %s timed out after %.1fs",
                        jid, timeout)
            return
        except OSError as e:
            log.warning("sacrificial check of %s failed to launch: %s",
                        jid, e)
            return
        if proc.returncode == FAULT_EXIT:
            self._fault(RuntimeError((proc.stderr or "")[-500:].strip()),
                        f"sacrificial check of {jid}")
            raise _Faulted
        if proc.returncode != 0:
            log.warning("sacrificial check of %s died rc=%s: %s",
                        jid, proc.returncode, (proc.stderr or "")[-500:])

    def _run(self) -> None:
        if self.registry.dev.index is not None:
            import torch

            # the worker launches every kernel: on the registry's card
            torch.cuda.set_device(self.registry.dev)
        self.ready.set()
        while True:
            if not self.queue.wait_for_work(timeout=0.5):
                if self.draining.is_set():
                    return
                continue
            batch = self.queue.take_batch(self.batch_max)
            if not batch:
                if self.draining.is_set():
                    # suspects stay durable (and blamed) for the next
                    # start; drain must not wait out their backoff
                    return
                if not self._handle_suspect():
                    time.sleep(0.05)
                continue
            # the durable attempt ledger: one fsync charges the whole
            # batch BEFORE checking starts, so an attempt the process
            # does not survive still counts (and names its suspects)
            self.queue.begin_attempts([s["id"] for s in batch])
            self._run_batch(batch)
            if self.draining.is_set():
                # in-flight work committed; leftover specs stay durable
                # for the next start
                return

    def _run_batch(self, batch) -> None:
        """Check and commit one batch; raises _Faulted (committing
        nothing more) at a fault of the card."""
        by_workload: dict = {}
        now = time.time()
        for spec in batch:
            remaining = self.queue.remaining_s(spec, now)
            if remaining is None:
                by_workload.setdefault(spec["workload"], []).append(spec)
            elif remaining <= 0:
                log.warning("job %s deadline expired before checking "
                            "began", spec["id"])
                self.queue.commit(spec["id"], {"valid": "unknown",
                                               "error": "deadline"})
            else:
                self._check_deadline_spec(spec, remaining)
        for workload, specs in by_workload.items():
            try:
                verdicts = self._check_group(workload, specs)
            except Exception as e:  # noqa: BLE001 — a broken workload
                #                     must not wedge the whole queue
                if is_fault(e):
                    self._fault(e, f"workload {workload} batch of "
                                   f"{len(specs)} job(s)")
                    raise _Faulted from e
                log.exception("workload %s batch failed", workload)
                verdicts = [{"valid": "unknown",
                             "error": f"workload {workload} failed"}
                            for _ in specs]
            for spec, verdict in zip(specs, verdicts):
                self.queue.commit(spec["id"], _jsonable(verdict))


class _Handler(BaseHTTPRequestHandler):
    daemon_obj: VerdictDaemon = None  # set by serve()
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("%s %s", self.address_string(), fmt % args)

    def _send_json(self, code: int, payload, extra_headers=()) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # -- POST /submit ------------------------------------------------------

    def do_POST(self):  # noqa: N802
        try:
            self._post()
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            log.exception("error serving %s", self.path)
            self._send_json(500, {"error": "internal error"})

    def _post(self):
        from .queue import QueueFull

        d = self.daemon_obj
        path = urlparse(self.path).path
        if path != "/submit":
            return self._send_json(404, {"error": "not found"})
        if d.draining.is_set():
            return self._send_json(
                503, {"error": "draining",
                      "retry_after_s": d.queue.retry_after_s},
                [("Retry-After", str(int(d.queue.retry_after_s) or 1))])
        try:
            n = int(self.headers.get("Content-Length", 0))
            spec = json.loads(self.rfile.read(n))
            client = str(spec["client"])
            workload = str(spec["workload"])
            history = spec["history"]
            weight = int(spec.get("weight", 1))
            deadline_ms = spec.get("deadline_ms")
            if deadline_ms is not None:
                deadline_ms = int(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be positive")
            if not isinstance(history, list):
                raise ValueError("history must be a list")
        except Exception:  # noqa: BLE001 — malformed submission
            return self._send_json(400, {"error": "bad submission"})
        try:
            d.registry.workload(workload)
        except KeyError:
            return self._send_json(
                400, {"error": f"unknown workload {workload!r}",
                      "workloads": d.registry.known_workloads()})
        d.ensure_worker()  # accepting a job implies someone runs it
        try:
            job_id = d.queue.submit(client, workload, history,
                                    weight=weight, deadline_ms=deadline_ms)
        except QueueFull as e:
            # bounded-queue backpressure: reject with a retry hint rather
            # than buffering toward OOM
            return self._send_json(
                429, {"error": "queue full", "pending": e.pending,
                      "retry_after_s": e.retry_after_s},
                [("Retry-After", str(int(e.retry_after_s) or 1))])
        return self._send_json(200, {"id": job_id})

    # -- GETs --------------------------------------------------------------

    def do_GET(self):  # noqa: N802
        try:
            self._get()
        except BrokenPipeError:
            pass
        except Exception:  # noqa: BLE001
            log.exception("error serving %s", self.path)
            self._send_json(500, {"error": "internal error"})

    def _get(self):
        d = self.daemon_obj
        url = urlparse(self.path)
        path = url.path
        if path == "/healthz":
            d.ensure_worker()
            worker = d.worker_state()
            # a drained worker exits on purpose; an unexpected death or a
            # fault of the card flips liveness
            ok = (worker["alive"] or d.draining.is_set()) and not d.faulted
            return self._send_json(
                200, {"ok": ok, "mesh": d.registry.mesh_topology(),
                      "worker": worker, "fault": d.last_fault,
                      "quarantined": d.queue.quarantined_ids()})
        if path == "/readyz":
            health = d.registry.health()
            health["draining"] = d.draining.is_set()
            code = 503 if (d.draining.is_set() or d.faulted
                           or not d.ready.is_set()) else 200
            return self._send_json(code, health)
        if path == "/stats":
            stats = d.queue.stats()
            stats["draining"] = d.draining.is_set()
            stats["faults"] = len(d.registry.faults)
            return self._send_json(200, stats)
        if path.startswith("/verdict/"):
            job_id = unquote(path[len("/verdict/"):])
            q = parse_qs(url.query)
            wait = float(q.get("wait", ["0"])[0])
            try:
                v = (d.queue.wait_for_verdict(job_id, timeout=wait)
                     if wait > 0 else d.queue.verdict(job_id))
            except KeyError:
                return self._send_json(404, {"error": "unknown job"})
            if v is None:
                return self._send_json(202, {"id": job_id,
                                             "state": "pending"})
            return self._send_json(200, {"id": job_id, "verdict": v})
        if path == "/stream":
            return self._stream()
        return self._send_json(404, {"error": "not found"})

    def _stream(self):
        """Stream verdicts as they commit, one JSON object per line,
        until the daemon drains (or the client hangs up). Starts from the
        already-committed set so a reconnecting client misses nothing."""
        d = self.daemon_obj
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Connection", "close")
        self.end_headers()
        known: set = set()
        while True:
            fresh = d.queue.wait_for_commit_after(known, timeout=0.5)
            for jid in fresh:
                known.add(jid)
                rec = {"id": jid, "verdict": d.queue.verdict(jid)}
                self.wfile.write(json.dumps(rec).encode() + b"\n")
            self.wfile.flush()
            if not fresh and d.draining.is_set():
                return


def serve(queue, registry, host="127.0.0.1", port=0) -> tuple:
    """Start the daemon: worker + HTTP server (daemon threads). Returns
    (server, daemon); the bound port is server.server_port."""
    daemon = VerdictDaemon(queue, registry)
    handler = type("Handler", (_Handler,), {"daemon_obj": daemon})
    server = ThreadingHTTPServer((host, port), handler)
    daemon.start()
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="serve http")
    t.start()
    return server, daemon


def run_daemon(opts: dict) -> int:
    """The `serve --daemon` body: warm the bundle, recover the queue,
    serve until SIGTERM, drain, exit 143 (or 0 on ctrl-C)."""
    from .. import web
    from .bundle import EngineBundle
    from .queue import (DEFAULT_MAX_ATTEMPTS, DEFAULT_MAX_PENDING,
                        DurableQueue)
    from .registry import EngineRegistry, load_extra_workloads

    load_extra_workloads()
    device = opts.get("device")
    queue_dir = opts.get("queue_dir") or os.path.join(
        opts.get("store_dir") or store.BASE_DIR, "serve-queue")
    bundle_dir = opts.get("bundle_dir")
    bundle = None
    if (bundle_dir or "").lower() not in ("off", "none", "0"):
        bundle = EngineBundle(bundle_dir or os.path.join(
            queue_dir, "bundle"), device=device)
    registry = EngineRegistry(bundle, device=device)
    state = registry.warm()
    if state:
        log.info("engine bundle %s in %.2fs",
                 "warm" if state.get("warm") else "built",
                 state.get("elapsed_s") or 0.0)
    queue = DurableQueue(
        queue_dir,
        max_pending=int(opts.get("max_pending") or DEFAULT_MAX_PENDING),
        max_attempts=int(opts.get("max_attempts")
                         or DEFAULT_MAX_ATTEMPTS))
    port = opts.get("port")
    server, daemon = serve(
        queue, registry, host=opts.get("host") or "127.0.0.1",
        port=8181 if port is None else int(port))
    log.info("verdict daemon on http://%s:%s/ (queue at %s, device %s)",
             opts.get("host") or "127.0.0.1", server.server_port,
             queue_dir, registry.dev)
    code = web.serve_until_signal(server, on_drain=daemon.drain,
                                  what="verdict daemon")
    # the drain hook closed admission; give the worker a bounded window
    # to commit its in-flight batch before the process exits
    daemon.draining.set()
    daemon.join(timeout=60)
    return code
