"""The durable work queue: exactly-once verdicts across SIGKILL (the
port's copy of `jepsen_tpu/serve/queue.py`, on the port's store).

Layout under one queue directory::

    jobs/<id>.json        the job spec (client, workload, history, seq)
    verdicts/<id>.json    the committed verdict
    attempts.json         the attempt ledger + in-flight blame record

All of it is written with the store module's write-temp → fsync →
rename discipline (``store.atomic_write_json``), so a kill at any
instant leaves each file either absent or complete — never torn. The
**verdict file is the commit point**: a job is done iff its verdict
file exists. A daemon SIGKILL'd mid-check restarts, rescans ``jobs/``,
finds the spec still unanswered, and re-runs it — re-running is safe
because checking is pure (same history, same verdict bits) and the
single atomic verdict write means the client can never observe two
answers. Nothing is ever lost (the spec was durable before submit
acknowledged) and nothing is double-verdicted (one file, one rename).

Re-running is safe — but not always SURVIVABLE: a history that OOMs
the process, wedges a compile, or outright SIGKILLs the daemon would
be re-enqueued forever, a crash loop fed by its own recovery. The
**attempt ledger** bounds that: ``begin_attempts`` bumps each job's
attempt count and records the batch as in-flight, fsynced BEFORE
execution starts, so an attempt the job never survives still counts.
At recovery, any unanswered job with ``max_attempts`` recorded
attempts is dead-lettered — an ``{"valid": "unknown", "error":
"quarantined"}`` verdict committed through the one true commit point —
and jobs named in-flight by the previous process (the crash *blame*)
become suspects: ``take_batch`` skips them, so healthy work flows
first, and the daemon runs them last in a sacrificial subprocess.

Admission control: ``max_pending`` bounds the backlog; past it,
``submit`` raises ``QueueFull`` carrying a retry-after hint instead of
buffering toward OOM — the daemon maps it to HTTP 429.

Fairness: ``take_batch`` drains clients weighted-round-robin — each
round, every client with waiting jobs contributes up to its weight in
submission order — so one chatty client cannot starve the rest, while
a client that paid for weight w gets w shares of every round.
"""

from __future__ import annotations

import logging
import os
import threading

from .. import store

log = logging.getLogger("jepsen_tpu_torch.serve.queue")

JOBS_DIR = "jobs"
VERDICTS_DIR = "verdicts"
ATTEMPTS_FILE = "attempts.json"

DEFAULT_MAX_PENDING = 256
DEFAULT_RETRY_AFTER_S = 5.0
DEFAULT_MAX_ATTEMPTS = 3

#: the dead-letter verdict every quarantined job commits
QUARANTINED_VERDICT = {"valid": "unknown", "error": "quarantined"}


class QueueFull(Exception):
    """Admission refused: the backlog is at max_pending."""

    def __init__(self, pending: int, retry_after_s: float):
        super().__init__(
            f"queue full ({pending} pending); retry in {retry_after_s}s")
        self.pending = pending
        self.retry_after_s = retry_after_s


class DurableQueue:
    def __init__(self, root: str, max_pending: int = DEFAULT_MAX_PENDING,
                 retry_after_s: float = DEFAULT_RETRY_AFTER_S,
                 max_attempts: int = DEFAULT_MAX_ATTEMPTS):
        self.root = os.path.abspath(root)
        self.max_pending = max_pending
        self.retry_after_s = retry_after_s
        self.max_attempts = max(1, int(max_attempts))
        self._jobs_dir = os.path.join(self.root, JOBS_DIR)
        self._verdicts_dir = os.path.join(self.root, VERDICTS_DIR)
        self._attempts_path = os.path.join(self.root, ATTEMPTS_FILE)
        os.makedirs(self._jobs_dir, exist_ok=True)
        os.makedirs(self._verdicts_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # crash recovery is just a directory scan: specs without
        # verdicts are the backlog, in submission (seq) order
        self._jobs: dict = {}        # id -> spec dict
        self._done: set = set()      # ids with committed verdicts
        self._attempts: dict = {}    # id -> attempts begun (durable)
        self._suspects: set = set()  # blamed in-flight by a dead run
        self._quarantined: set = set()  # dead-lettered ids
        self._seq = 0
        self._recover()

    # -- recovery ----------------------------------------------------------

    @staticmethod
    def _read_json(p: str):
        return store.read_json_dict(p)

    def _recover(self) -> None:
        """Rebuild in-memory state from the directories. ``.tmp``
        leftovers from a mid-rename kill are ignored (and later
        overwritten); an unparseable spec is quarantined by skipping —
        atomic writes should make that impossible, but a disk that
        lies must not wedge the daemon.

        The attempt ledger closes the crash loop: unanswered jobs
        that already burned ``max_attempts`` are dead-lettered here
        (the quarantine verdict commits through the normal commit
        point), and jobs the dead process had in flight become
        *suspects* — deferred by ``take_batch`` so a poison job can't
        take the healthy backlog down with it again."""
        for fn in os.listdir(self._verdicts_dir):
            if fn.endswith(".json"):
                self._done.add(fn[:-5])
        n_stale = 0
        for fn in sorted(os.listdir(self._jobs_dir)):
            if not fn.endswith(".json"):
                continue
            spec = self._read_json(os.path.join(self._jobs_dir, fn))
            if spec is None or "id" not in spec:
                log.warning("queue recovery: skipping unreadable %s", fn)
                continue
            self._jobs[spec["id"]] = spec
            self._seq = max(self._seq, int(spec.get("seq", 0)) + 1)
            if spec["id"] not in self._done:
                n_stale += 1
        ledger = self._read_json(self._attempts_path) or {}
        attempts = ledger.get("attempts")
        if isinstance(attempts, dict):
            self._attempts = {str(k): int(v) for k, v in attempts.items()
                              if str(k) in self._jobs}
        for jid in ledger.get("in_flight") or []:
            if jid in self._jobs and jid not in self._done:
                self._suspects.add(jid)
        with self._lock:  # _commit_locked notifies the condvar
            for jid, n in sorted(self._attempts.items()):
                if n < self.max_attempts:
                    continue
                self._quarantined.add(jid)
                if jid not in self._done:
                    log.warning("queue recovery: quarantining %s after "
                                "%d attempt(s)", jid, n)
                    self._commit_locked(jid, dict(QUARANTINED_VERDICT))
                self._suspects.discard(jid)
        if n_stale:
            log.info("queue recovery: %d unanswered job(s) re-enqueued"
                     " (%d suspect)", n_stale, len(self._suspects))

    # -- submission --------------------------------------------------------

    def pending_ids(self) -> list:
        with self._lock:
            return self._pending_ids_locked()

    def _pending_ids_locked(self) -> list:
        return sorted((j["id"] for j in self._jobs.values()
                       if j["id"] not in self._done),
                      key=lambda i: self._jobs[i].get("seq", 0))

    def submit(self, client: str, workload: str, history: list,
               weight: int = 1, deadline_ms: int | None = None) -> str:
        """Durably enqueue one history. The spec hits disk (fsync'd)
        BEFORE the id is returned, so an acknowledged submission
        survives any kill. Raises QueueFull past max_pending.

        ``deadline_ms`` is the client's total verdict budget, anchored
        at submission wall time (``submitted_at``) so a restarted
        daemon measures the same deadline the client was promised."""
        import time as _t

        with self._lock:
            pending = len(self._pending_ids_locked())
            if pending >= self.max_pending:
                raise QueueFull(pending, self.retry_after_s)
            seq = self._seq
            self._seq += 1
            job_id = f"{seq:08d}-{client}"
            spec = {"id": job_id, "seq": seq, "client": str(client),
                    "workload": str(workload),
                    "weight": max(1, int(weight)),
                    "history": list(history)}
            if deadline_ms is not None:
                spec["deadline_ms"] = max(1, int(deadline_ms))
                spec["submitted_at"] = _t.time()
            store.atomic_write_json(
                os.path.join(self._jobs_dir, job_id + ".json"), spec)
            self._jobs[job_id] = spec
            self._cv.notify_all()
        return job_id

    @staticmethod
    def remaining_s(spec: dict, now: float | None = None):
        """Seconds left on a spec's deadline (negative when expired),
        or None for the default no-deadline contract."""
        import time as _t

        if spec.get("deadline_ms") is None:
            return None
        anchor = float(spec.get("submitted_at") or 0.0)
        now = _t.time() if now is None else now
        return anchor + spec["deadline_ms"] / 1000.0 - now

    # -- scheduling --------------------------------------------------------

    def take_batch(self, max_jobs: int = 64) -> list:
        """Up to max_jobs pending specs, weighted round-robin across
        clients: rounds visit every client with waiting jobs (sorted
        for determinism) and take up to `weight` jobs each, oldest
        first. Jobs stay pending until commit() — a crash between
        take and commit re-runs them. Suspects (jobs blamed for a
        previous crash) are skipped: the daemon runs them LAST, in a
        sacrificial subprocess, once the healthy backlog has drained
        (``take_suspect``)."""
        with self._lock:
            by_client: dict = {}
            for jid in self._pending_ids_locked():
                if jid in self._suspects:
                    continue
                by_client.setdefault(
                    self._jobs[jid]["client"], []).append(jid)
            out: list = []
            while by_client and len(out) < max_jobs:
                for client in sorted(by_client):
                    lane = by_client.get(client)
                    if not lane:
                        by_client.pop(client, None)
                        continue
                    w = self._jobs[lane[0]].get("weight", 1)
                    for _ in range(max(1, int(w))):
                        if not lane or len(out) >= max_jobs:
                            break
                        out.append(self._jobs[lane.pop(0)])
                    if not lane:
                        by_client.pop(client, None)
            return out

    def take_suspect(self):
        """The oldest pending suspect spec, or None. Suspects are the
        jobs a dead daemon blamed (in flight when it died); the caller
        runs them in a sacrificial subprocess, never in-process."""
        with self._lock:
            for jid in self._pending_ids_locked():
                if jid in self._suspects:
                    return self._jobs[jid]
            return None

    def suspect_ids(self) -> list:
        with self._lock:
            return sorted(j for j in self._suspects
                          if j not in self._done)

    # -- the attempt ledger ------------------------------------------------

    def begin_attempts(self, ids: list) -> None:
        """Durably charge one attempt to every job in `ids` and blame
        them as in flight — fsynced BEFORE execution starts, so an
        attempt the process does not survive still counts (the whole
        point: SIGKILL'd attempts are the ones that matter). One
        ledger write covers the batch."""
        with self._lock:
            for jid in ids:
                self._attempts[jid] = self._attempts.get(jid, 0) + 1
            store.atomic_write_json(self._attempts_path, {
                "attempts": dict(self._attempts),
                "in_flight": list(ids)})

    def attempts_of(self, job_id: str) -> int:
        with self._lock:
            return self._attempts.get(job_id, 0)

    def quarantine(self, job_id: str) -> None:
        """Dead-letter a job: commit the quarantine verdict through
        the normal commit point and stop scheduling it."""
        log.warning("quarantining %s after %d attempt(s)", job_id,
                    self._attempts.get(job_id, 0))
        with self._lock:
            self._quarantined.add(job_id)
            self._commit_locked(job_id, dict(QUARANTINED_VERDICT))

    def quarantined_ids(self) -> list:
        with self._lock:
            return sorted(self._quarantined)

    def refresh_done(self, job_id: str) -> bool:
        """Notice a verdict committed by ANOTHER process (the
        sacrificial subprocess writes through its own queue handle):
        re-check the disk and absorb the commit. True iff done."""
        with self._lock:
            if job_id in self._done:
                return True
            rec = self._read_json(
                os.path.join(self._verdicts_dir, job_id + ".json"))
            if rec is None:
                return False
            self._done.add(job_id)
            self._suspects.discard(job_id)
            self._cv.notify_all()
            return True

    def wait_for_work(self, timeout: float | None = None) -> bool:
        """Block until at least one job is pending (or timeout)."""
        with self._lock:
            if self._pending_ids_locked():
                return True
            self._cv.wait(timeout)
            return bool(self._pending_ids_locked())

    # -- commit / read-back ------------------------------------------------

    def commit(self, job_id: str, verdict) -> None:
        """Atomically publish the verdict — THE commit point. A
        duplicate commit (crash replay racing a finished write) is a
        no-op: the first rename won."""
        with self._lock:
            self._commit_locked(job_id, verdict)

    def _commit_locked(self, job_id: str, verdict) -> None:
        if job_id in self._done:
            return
        store.atomic_write_json(
            os.path.join(self._verdicts_dir, job_id + ".json"),
            {"id": job_id, "verdict": verdict})
        self._done.add(job_id)
        self._suspects.discard(job_id)
        self._cv.notify_all()

    def verdict(self, job_id: str):
        """The committed verdict dict, or None while pending. Unknown
        ids raise KeyError."""
        with self._lock:
            known = job_id in self._jobs
        if not known:
            # a verdict may outlive its spec in a pruned queue; check
            # disk before declaring the id unknown
            rec = self._read_json(
                os.path.join(self._verdicts_dir, job_id + ".json"))
            if rec is None:
                raise KeyError(job_id)
            return rec.get("verdict")
        rec = self._read_json(
            os.path.join(self._verdicts_dir, job_id + ".json"))
        return None if rec is None else rec.get("verdict")

    def wait_for_verdict(self, job_id: str, timeout: float | None = None):
        """Long-poll one verdict; None on timeout."""
        import time as _t

        deadline = None if timeout is None else _t.monotonic() + timeout
        with self._lock:
            while job_id not in self._done:
                if job_id not in self._jobs:
                    raise KeyError(job_id)
                remaining = (None if deadline is None
                             else deadline - _t.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining)
        return self.verdict(job_id)

    def wait_for_commit_after(self, known: set,
                              timeout: float | None = None) -> list:
        """Ids committed that aren't in `known` — the verdict-stream
        endpoint's tail-follow primitive."""
        import time as _t

        deadline = None if timeout is None else _t.monotonic() + timeout
        with self._lock:
            while True:
                fresh = sorted(self._done - known)
                if fresh:
                    return fresh
                remaining = (None if deadline is None
                             else deadline - _t.monotonic())
                if remaining is not None and remaining <= 0:
                    return []
                self._cv.wait(remaining)

    def stats(self) -> dict:
        with self._lock:
            pending = self._pending_ids_locked()
            per_client: dict = {}
            for jid in pending:
                c = self._jobs[jid]["client"]
                per_client[c] = per_client.get(c, 0) + 1
            return {"pending": len(pending), "done": len(self._done),
                    "max_pending": self.max_pending,
                    "pending_per_client": per_client,
                    "max_attempts": self.max_attempts,
                    "suspects": sorted(j for j in self._suspects
                                       if j not in self._done),
                    "quarantined": sorted(self._quarantined)}
