"""Test orchestration: the execution core (reference: jepsen.core,
core.clj; the port's copy of `jepsen_tpu.core`).

`run(test)` threads one test dict through every layer
(core.clj:540-560): connect the control plane, provision the OS, cycle
the DB, spawn one client worker per process plus a nemesis worker, pull
ops from the generator until it is exhausted, record the history, then
analyze it with the checker (a check on the card, through the port's
checkers) and persist the results. `resume(test)` continues a preempted
run from its checkpoint and WAL.

Worker semantics, as the reference's:
- processes stripe over nodes round-robin (core.clj:485-496)
- a client exception makes the completion :info — the outcome is unknown
  (core.clj:271-304); the process is then reincarnated as process+n so
  every logical process stays single-threaded forever (core.clj:410-427)
- nemesis ops are journaled to every active history (core.clj:338-350)
- workers synchronize setup/run/teardown through latches so no client
  starts before all are ready (core.clj:171-268)

The device a test's checkers run on (`test["device"]`, None = the card)
is resolved before anything is provisioned, so a box without CUDA fails
before a daemon starts.
"""

from __future__ import annotations

import datetime
import logging
import queue
import signal
import threading
import time as _time
from typing import Any

from . import checker as checker_mod
from . import control, db as db_mod, generator, store
from .device import resolve
from .history import Op, index
from .util import (
    CountDownLatch,
    log_op_logger,
    real_pmap,
    relative_time_nanos,
    with_relative_time,
)

log = logging.getLogger("jepsen_tpu_torch.core")


def conj_op(test, op: Op) -> Op:
    """Append an op to the test's history (core.clj:30-38), and to the
    durability WAL when the run carries one (store.HistoryWAL) — so a
    killed run leaves the ops it completed on disk."""
    with test["_history_lock"]:
        test["_history"].append(op)
        # journal INSIDE the critical section: WAL line order must match
        # history order, or the reindexing fallback loader permutes ops
        wal = test.get("_wal")
        if wal is not None:
            wal.append(op)
    return op


class WorkerAbort(Exception):
    pass


class Worker:
    """Synchronized setup/run/teardown lifecycle (core.clj:161-169)."""

    name = "worker"

    def __init__(self):
        self.abort = threading.Event()

    def setup(self):
        pass

    def run(self):
        pass

    def teardown(self):
        pass


def do_worker(worker: Worker, abort_all, run_latch, teardown_latch):
    """Run one worker through its phases with error recovery; returns the
    first error, or None (core.clj:171-225)."""
    error = None
    try:
        log.debug("Starting %s", worker.name)
        worker.setup()
    except BaseException as e:  # noqa: BLE001
        log.warning("Error setting up %s", worker.name, exc_info=True)
        error = e
        abort_all(worker)
    if error is None:
        run_latch.count_down()
        run_latch.await_()
        try:
            worker.run()
        except BaseException as e:  # noqa: BLE001
            if not isinstance(e, WorkerAbort):
                log.warning("Error running %s", worker.name, exc_info=True)
                error = e
            abort_all(worker)
    else:
        run_latch.count_down()
    teardown_latch.count_down()
    teardown_latch.await_()
    try:
        log.debug("Stopping %s", worker.name)
        worker.teardown()
    except BaseException as e:  # noqa: BLE001
        log.warning("Error tearing down %s", worker.name, exc_info=True)
        error = error or e
    return error


def run_workers(test, workers) -> None:
    """Run all workers to completion; re-raise the error of the worker
    that aborted the run, if any (core.clj:227-268)."""
    n = len(workers)
    run_latch = CountDownLatch(n)
    teardown_latch = CountDownLatch(n)
    aborting: list = []
    abort_lock = threading.Lock()

    def abort_all(worker):
        with abort_lock:
            if not aborting:
                aborting.append(worker)
        for w in workers:
            w.abort.set()
        # Wake anyone blocked at a generator barrier; without this a
        # crashed worker leaves phases()/synchronize() waiters deadlocked
        generator.break_barriers()

    results: list = [None] * n
    threads_binding = [generator.NEMESIS] + list(range(test["concurrency"]))

    def runner(i, w):
        with generator.with_threads(threads_binding):
            results[i] = do_worker(w, abort_all, run_latch, teardown_latch)

    threads = [
        threading.Thread(
            target=runner, args=(i, w), name=f"jepsen {w.name}", daemon=True
        )
        for i, w in enumerate(workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    with abort_lock:
        if aborting:
            for w, r in zip(workers, results):
                if w is aborting[0] and r is not None:
                    raise r


def invoke_op(op: Op, test, client, abort: threading.Event) -> Op:
    """Apply op to a client; exceptions become :info completions — the
    outcome is unknown (core.clj:271-304)."""
    try:
        completion = client.invoke(test, op)
        completion = completion.with_(time=relative_time_nanos())
    except BaseException as e:  # noqa: BLE001
        if abort.is_set():
            raise
        log.warning("Process %s crashed", op.process, exc_info=True)
        return op.with_(
            type="info",
            time=relative_time_nanos(),
            error=f"indeterminate: {e}",
        )
    t = completion.type
    assert t in ("ok", "fail", "info"), (
        f"client invoke must complete with ok/fail/info, got {completion!r}"
    )
    assert completion.process == op.process
    assert completion.f == op.f
    return completion


class _InvokerThread:
    """A reusable single-purpose thread that runs client invokes so the
    worker can bound its wait. On timeout the worker marks it abandoned
    and walks away; if the hung call ever finishes, the thread notices
    the flag and exits (its late completion is discarded — the process
    was already reincarnated, matching the reference's interrupt
    semantics, generator.clj:409-518)."""

    def __init__(self, name: str):
        self.requests: queue.SimpleQueue = queue.SimpleQueue()
        self.abandoned = False
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name=name
        )
        self.thread.start()

    def _loop(self):
        while True:
            item = self.requests.get()
            if item is None or self.abandoned:
                # don't start work nobody is waiting on (an op whose
                # deadline already expired is abandoned before it runs)
                return
            fn, box, done = item
            try:
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001
                box["error"] = e
            done.set()
            if self.abandoned:
                return

    def submit(self, fn):
        box: dict = {}
        done = threading.Event()
        self.requests.put((fn, box, done))
        return box, done

    def stop(self):
        self.requests.put(None)


class ClientWorker(Worker):
    """One worker per initial process id, bound to a node
    (core.clj:352-440)."""

    def __init__(self, test, process: int, node):
        super().__init__()
        self.test = test
        self.node = node
        self.process = process
        self.client = None
        self.name = f"worker {process}"
        self._invoker: _InvokerThread | None = None
        self._client_hung = False

    def _open_client(self):
        """open then setup, like the reference's open-compat!
        (client.clj:38-51); the connection is closed if setup fails."""
        client = self.test["client"].open(self.test, self.node)
        try:
            client.setup(self.test)
        except BaseException:
            try:
                client.close(self.test)
            except Exception:  # noqa: BLE001
                log.warning("Error closing client after failed setup",
                            exc_info=True)
            raise
        return client

    def _close_client(self):
        """teardown then close, like the reference's close-compat!
        (client.clj:62-70); close always runs."""
        client, self.client = self.client, None
        if client is None:
            return
        try:
            client.teardown(self.test)
        finally:
            client.close(self.test)

    def setup(self):
        self.client = self._open_client()

    def run(self):
        test = self.test
        gen = test["generator"]
        while True:
            if self.abort.is_set():
                raise WorkerAbort()
            o = generator.op_and_validate(gen, test, self.process)
            if o is None:
                return
            op_deadline = o.pop(generator.DEADLINE_KEY, None)
            op = Op.from_dict(o).with_(
                process=self.process, time=relative_time_nanos()
            )
            if op.type is None:
                op = op.with_(type="invoke")
            log_op_logger(op)
            if self.client is None:
                try:
                    # bare open — no setup: reconnection after a crash must
                    # not re-run one-time DB state setup (core.clj:389)
                    self.client = test["client"].open(test, self.node)
                except Exception as e:  # noqa: BLE001
                    log.warning("Error opening client", exc_info=True)
                    fail = op.with_(
                        type="fail",
                        error=("no-client", str(e)),
                        time=relative_time_nanos(),
                    )
                    conj_op(test, op)
                    conj_op(test, fail)
                    self.client = None
                    continue
            conj_op(test, op)
            completion = self._invoke(op, op_deadline)
            conj_op(test, completion)
            log_op_logger(completion)
            if completion.is_info:
                # All bets are off: the op may or may not have taken
                # effect. The process is hung; reincarnate it so each
                # logical process stays single-threaded (core.clj:410-427).
                self.process += test["concurrency"]
                client, self.client = self.client, None
                if self._client_hung:
                    # the invoker still holds the client mid-call; closing
                    # synchronously could hang this worker too — close
                    # best-effort off-thread (core.clj's interrupt path)
                    self._client_hung = False
                    threading.Thread(
                        target=self._close_quietly,
                        args=(client,),
                        daemon=True,
                        name=f"jepsen close {self.name}",
                    ).start()
                else:
                    self._close_quietly(client)

    def _close_quietly(self, client):
        try:
            # bare close — no teardown: the DB's shared state must
            # survive for the other workers (core.clj:425-427)
            client.close(self.test)
        except Exception:  # noqa: BLE001
            log.warning("Error closing client", exc_info=True)

    def _invoke(self, op: Op, deadline=None) -> Op:
        """Invoke with the wait bounded by op_timeout and the op's
        time-limit deadline (attached by generator.TimeLimit); on expiry
        the op completes :info and the hung invoke is abandoned (the
        reference interrupts the worker thread at the time limit,
        generator.clj:409-518)."""
        test = self.test
        timeout = test.get("op_timeout")
        if deadline is not None:
            remaining = deadline - _time.monotonic()
            timeout = (
                remaining if timeout is None else min(timeout, remaining)
            )
        if timeout is None:
            return invoke_op(op, test, self.client, self.abort)
        if self._invoker is None:
            self._invoker = _InvokerThread(f"jepsen invoker {self.name}")
        invoker = self._invoker
        client = self.client
        box, done = invoker.submit(
            lambda: invoke_op(op, test, client, self.abort)
        )
        if done.wait(max(0.0, timeout)):
            if "error" in box:
                raise box["error"]
            return box["result"]
        invoker.abandoned = True
        # also enqueue the stop sentinel: if the call completed in the
        # instant after wait() expired, the thread may have re-entered
        # get() before seeing abandoned — the sentinel unblocks it so
        # the thread can't leak
        invoker.stop()
        self._invoker = None
        self._client_hung = True
        log.warning(
            "Process %s timed out after %.1fs; abandoning invoke",
            op.process,
            max(0.0, timeout),
        )
        return op.with_(
            type="info",
            time=relative_time_nanos(),
            error="op timed out",
        )

    def teardown(self):
        if self._invoker is not None:
            self._invoker.stop()
            self._invoker = None
        if self._client_hung:
            # teardown/close would block on the hung connection
            client, self.client = self.client, None
            if client is not None:
                threading.Thread(
                    target=self._close_quietly,
                    args=(client,),
                    daemon=True,
                    name=f"jepsen close {self.name}",
                ).start()
            return
        self._close_client()


class NemesisWorker(Worker):
    """Drives the nemesis from the same generator (core.clj:442-473)."""

    name = "nemesis"

    def __init__(self, test):
        super().__init__()
        self.test = test
        self.nemesis = None

    def setup(self):
        self.nemesis = self.test["nemesis"].setup(self.test)
        ledger = self.test.pop("_resume_ledger", None)
        if ledger:
            self._heal_ledger(ledger)

    def _heal_ledger(self, ledger) -> None:
        """Resume contract: every fault the preempted run left planted
        is healed BEFORE the first generated op — this runs in worker
        setup(), and do_worker's run latch releases no worker's run()
        until every setup() finished. Heal ops are journaled like any
        nemesis op, tagged resume_heal so audits can tell them from
        scheduled heals."""
        nem = self.nemesis
        if hasattr(nem, "restore_faults"):
            nem.restore_faults(ledger)
        log.info("Healing %d leftover fault(s) from the preempted run",
                 len(ledger))
        for e in ledger:
            f = e.get("heal_f")
            if not f:
                continue
            op = Op(
                process=generator.NEMESIS, type="info", f=f, value=None,
                time=relative_time_nanos(), extra={"resume_heal": True},
            )
            self._apply(op)

    def run(self):
        test = self.test
        gen = test["generator"]
        while True:
            if self.abort.is_set():
                raise WorkerAbort()
            o = generator.op_and_validate(gen, test, generator.NEMESIS)
            if o is None:
                return
            # nemesis invokes aren't deadline-bounded, but strip the
            # time-limit annotation so it doesn't leak into the history
            o.pop(generator.DEADLINE_KEY, None)
            op = Op.from_dict(o).with_(
                process=generator.NEMESIS, time=relative_time_nanos()
            )
            if op.type is None:
                op = op.with_(type="info")
            self._apply(op)

    @staticmethod
    def _journal(test, wal, op: Op) -> None:
        """Append to every active history; the WAL line lands under the
        MAIN history's lock (nemesis ops bypass conj_op) so WAL order
        matches history order for the reindexing fallback loader."""
        main_lock = test.get("_history_lock")
        journaled = False
        for hist, lock in list(test["active_histories"]):
            with lock:
                hist.append(op)
                if wal is not None and lock is main_lock:
                    wal.append(op)
                    journaled = True
        if wal is not None and not journaled:
            wal.append(op)

    def _apply(self, op: Op) -> Op:
        """Journal to ALL active histories, invoke, journal completion
        (core.clj:338-350); exceptions -> :info (core.clj:308-336)."""
        test = self.test
        log_op_logger(op)
        wal = test.get("_wal")
        self._journal(test, wal, op)
        try:
            completion = self.nemesis.invoke(test, op).with_(
                time=relative_time_nanos()
            )
            assert completion.type == "info", completion
            assert completion.f == op.f, completion
        except BaseException as e:  # noqa: BLE001
            if self.abort.is_set():
                raise
            log.warning("Nemesis crashed", exc_info=True)
            completion = op.with_(
                type="info",
                time=relative_time_nanos(),
                error=f"indeterminate: {e}",
            )
        self._journal(test, wal, completion)
        log_op_logger(completion)
        return completion

    def teardown(self):
        if self.nemesis is not None:
            self.nemesis.teardown(self.test)


#: default seconds between periodic run-state checkpoints
CHECKPOINT_INTERVAL = 5.0


def checkpoint_state(test) -> dict:
    """Assemble the crash-consistent run snapshot store.RunCheckpoint
    persists: generator cursors/rng states, the nemesis active-fault
    ledger, the process table (next process id per worker thread), the
    WAL session epoch, and time anchors. Reads live state without
    locks — a cursor can be at most one draw stale, which resume
    tolerates (the WAL is the ground truth for landed ops)."""
    nem = test.get("nemesis")
    workers = test.get("_client_workers") or []
    wal = test.get("_wal")
    return {
        "v": 1,
        "generator": generator.snapshot(test["generator"]),
        "faults": (list(nem.active_faults())
                   if hasattr(nem, "active_faults") else []),
        "processes": [w.process for w in workers],
        "wal_epoch": getattr(wal, "epoch", 0),
        "wal_count": len(test.get("_history") or ()),
        "elapsed_nanos": relative_time_nanos(),
        "wall_clock": _time.time(),
    }


def checkpoint_now(test):
    """Write a checkpoint immediately; None when the run carries no
    checkpoint store (no name/start_time)."""
    ckpt = test.get("_ckpt")
    if ckpt is None:
        return None
    return ckpt.write(checkpoint_state(test))


def _checkpoint_loop(test, stop: threading.Event) -> None:
    interval = test.get("checkpoint_interval") or CHECKPOINT_INTERVAL
    while not stop.wait(interval):
        try:
            checkpoint_now(test)
        except Exception:  # noqa: BLE001 — checkpointing is best-effort
            log.warning("periodic checkpoint failed", exc_info=True)


def run_case(test) -> list:
    """Spawn nemesis + client workers, run one case, return its history
    (core.clj:475-504). A resumed run pre-seeds the history with the
    prior sessions' WAL ops and restores each worker's process id."""
    history: list = list(test.pop("_prior_history", ()))
    lock = threading.Lock()
    test["_history"] = history
    test["_history_lock"] = lock
    test["active_histories"].append((history, lock))
    wal = None
    ckpt_stop = None
    ticker = None
    if test.get("name") and test.get("start_time"):
        # durability sidecar: every op lands on disk as it happens, so
        # a SIGKILL'd run leaves a partial history load_history can read
        try:
            wal = store.HistoryWAL(test)
            test["_wal"] = wal
        except Exception:  # noqa: BLE001 — best-effort durability
            log.warning("couldn't open history WAL", exc_info=True)
            wal = None
    if wal is not None:
        try:
            test["_ckpt"] = store.RunCheckpoint(test)
            ckpt_stop = threading.Event()
            ticker = threading.Thread(
                target=_checkpoint_loop, args=(test, ckpt_stop),
                daemon=True, name="jepsen checkpoint")
            ticker.start()
        except Exception:  # noqa: BLE001 — checkpointing is best-effort
            log.warning("couldn't open run checkpoint", exc_info=True)
            ckpt_stop = None
    monitor = None
    if test.get("online"):
        # streaming verdicts with bounded lag during the run; on a
        # definite falsification the monitor sets test["_drain"] (the
        # SIGTERM drain gate) so the doomed run winds down early
        try:
            from .online.monitor import RunMonitor

            monitor = RunMonitor(test).start()
        except Exception:  # noqa: BLE001 — monitoring is advisory
            log.warning("couldn't start online monitor", exc_info=True)
            monitor = None
    try:
        nodes = test["nodes"] or [None]
        client_nodes = [
            nodes[i % len(nodes)] for i in range(test["concurrency"])
        ]
        procs = test.pop("_resume_processes", None)
        client_workers = [
            ClientWorker(
                test,
                procs[i] if procs and i < len(procs) else i,
                node,
            )
            for i, node in enumerate(client_nodes)
        ]
        test["_client_workers"] = client_workers
        workers = [NemesisWorker(test)] + client_workers
        run_workers(test, workers)
    finally:
        if monitor is not None:
            monitor.stop()
        if ckpt_stop is not None:
            ckpt_stop.set()
            ticker.join(timeout=2.0)
            try:
                # final checkpoint: post-teardown, so the fault ledger
                # is empty and cursors sit at the drain point
                checkpoint_now(test)
            except Exception:  # noqa: BLE001
                log.warning("final checkpoint failed", exc_info=True)
        test.pop("_ckpt", None)
        test.pop("_client_workers", None)
        test["active_histories"].remove((history, lock))
        if wal is not None:
            test.pop("_wal", None)
            wal.close()
    return history


def snarf_logs(test) -> None:
    """Download DB log files from every node into the store directory
    (core.clj:98-130)."""
    dbo = test.get("db")
    if not isinstance(dbo, db_mod.LogFiles) or not test.get("start_time"):
        return

    def snarf(node):
        for path in dbo.log_files(test, node):
            dest = store.path_(
                test, [str(node), path.lstrip("/").replace("/", "_")]
            )
            try:
                test["remote"].download(node, path, dest)
            except Exception:  # noqa: BLE001
                log.warning("couldn't download %s from %s", path, node)

    real_pmap(snarf, test["nodes"])


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

    def __enter__(self) -> "DrainSignal":
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


class _SnarfHook:
    """Crash-time log collection (core.clj:132-149): the reference
    installs a JVM shutdown hook so DB logs still download on ctrl-C.
    Python's finally blocks already run on KeyboardInterrupt, but a
    SIGTERM kills the process without unwinding and a crash *during*
    cleanup can skip the snarf — so while a test runs we (a) turn the
    FIRST SIGTERM into a graceful preemption drain via DrainSignal
    (close the generator gate and let the run wind down, checkpointed
    and resumable; a second SIGTERM forces SystemExit so finally
    blocks still fire), and (b) register an atexit backstop.
    snarf-once semantics keep the normal path from downloading
    twice."""

    def __init__(self, test):
        self.test = test
        self._done = False
        self._lock = threading.Lock()
        self._drain_signal = DrainSignal(self._start_drain, what="run")

    def _start_drain(self) -> bool:
        # graceful preemption drain (a preemption notice is a SIGTERM):
        # close the generator gate — workers drain in-flight invokes
        # through the normal timeout/:info path, teardown heals active
        # faults, and run_case flushes the WAL and writes a final
        # checkpoint. Without a drain gate there is nothing to drain.
        drain = self.test.get("_drain")
        if drain is None or drain.is_set():
            return False
        self.test["_preempted"] = True
        drain.set()
        return True

    def snarf_once(self) -> None:
        with self._lock:
            if self._done:
                return
            self._done = True
        try:
            snarf_logs(self.test)
        except Exception:  # noqa: BLE001
            log.warning("log snarfing failed", exc_info=True)

    def __enter__(self):
        import atexit

        atexit.register(self.snarf_once)
        self._drain_signal.install()
        return self

    def __exit__(self, *exc):
        import atexit

        atexit.unregister(self.snarf_once)
        self._drain_signal.uninstall()
        return False


def analyze(test) -> dict:
    """Index the history, run the test's checker under check_safe (a
    fault of the card raises), persist the results (core.clj:506-523).
    With a store attached (name and start_time), finished analysis units
    journal to analysis.ckpt.jsonl (store.AnalysisJournal) as they
    complete — the independent checker's per-key verdicts and the cycle
    checker's closures — so analysing the same history again skips
    them; results.json and test.json are then written (store.save_2)."""
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


def with_recovery_phases(test) -> Any:
    """The recovery contract (nemesis/combined.clj's final-generator):
    once the main generator is exhausted, the nemesis runs every fault
    package's heal generator (test["final_generator"]), then — when
    test["stability_period"] and test["stability_generator"] are set —
    clients run a plain-op stability window so checker.recovery has a
    post-heal view to audit. Phases are barrier-synchronized: no heal
    starts while a client still draws main-phase ops."""
    main = test.get("generator")
    phase_list = [main]
    final = test.get("final_generator")
    if final is not None:
        phase_list.append(generator.nemesis(final))
    period = test.get("stability_period")
    stability = test.get("stability_generator")
    if period and stability is not None:
        phase_list.append(
            generator.time_limit(period, generator.clients(stability)))
    if len(phase_list) == 1:
        return main
    return generator.phases(*phase_list)


def prepare(test: dict) -> dict:
    """Fill in derived test-map fields (core.clj:593-608). A test map
    that names a device (`test["device"]`, None = the card) has it
    resolved here, before any node is touched: without CUDA and without
    "cpu" this raises CudaUnavailable."""
    test = dict(test)
    if "device" in test:
        resolve(test["device"])
    test.setdefault("nodes", [])
    test.setdefault("concurrency", max(1, len(test["nodes"])))
    test.setdefault("start_time", datetime.datetime.now())
    test["active_histories"] = []
    test["remote"] = control.remote_for_test(test)
    # drain gate outermost: a SIGTERM stops generation for EVERY phase,
    # and run/resume snapshot/restore the same generator shape
    test["_drain"] = threading.Event()
    test["generator"] = generator.interruptible(
        with_recovery_phases(test), test["_drain"])
    return test


def run(test: dict) -> dict:
    """Run a complete test: provision, execute, analyze
    (core.clj:539-640). Returns the test dict with :history and :results."""
    test = prepare(test)
    store.start_logging(test)
    try:
        # prime per-node connections in parallel, with rollback-free
        # semantics: any failure aborts the run (core.clj:611-620)
        real_pmap(test["remote"].connect, test["nodes"])
        try:
            # OS setup
            osys = test.get("os")
            if osys is not None:
                control.on_nodes(test, osys.setup)
            try:
                # DB cycle (teardown -> setup, with retries)
                if test.get("db") is not None:
                    db_mod.cycle(test)
                with _SnarfHook(test) as hook:
                    try:
                        with with_relative_time():
                            test["history"] = index(run_case(test))
                        preempted = test.pop("_preempted", False)
                        log.info("Run complete, writing")
                        if test.get("name"):
                            store.save_1(test)
                        if preempted:
                            # leave the cluster as-is: resuming needs
                            # the DB's on-node state
                            test["_preserve_db"] = True
                            log.warning(
                                "Run preempted; checkpoint + WAL saved "
                                "— continue with the `resume` subcommand")
                            raise SystemExit(143)
                        analyze(test)
                    finally:
                        hook.snarf_once()
                        if (test.get("db") is not None
                                and not test.get("_preserve_db")):
                            control.on_nodes(
                                test,
                                lambda t, n: test["db"].teardown(t, n),
                            )
            finally:
                if osys is not None:
                    control.on_nodes(test, osys.teardown)
        finally:
            for node in test["nodes"]:
                test["remote"].disconnect(node)
        log_results(test)
        return test
    finally:
        store.stop_logging(test)


def resume(test: dict) -> dict:
    """Resume a preempted or SIGKILL'd run from its crash-consistent
    checkpoint (the `resume` subcommand's path). The test dict must carry
    the ORIGINAL run's name and start_time (the CLI resolves them from
    the run dir) plus the same seed/options, so prepare() rebuilds a
    structurally identical generator for restore().

    Sequence: salvage the torn-tail-tolerant WAL as the prior history
    (the reopened WAL appends under session epoch last+1, so op indices
    never collide), restore generator/nemesis cursors from the
    checkpoint, heal every fault in the active-fault ledger BEFORE the
    first generated op (NemesisWorker setup), and continue to the
    original time budget. The cluster is NOT re-provisioned — no OS
    setup, no DB cycle — because preserved node state is the point of
    resuming. At-least-once caveat: cursors can trail the WAL by the
    one draw in flight at the kill, so a resumed schedule may re-emit
    that op."""
    assert test.get("name") and test.get("start_time"), (
        "resume needs the original run's name and start_time")
    test = prepare(test)
    ckpt = store.load_checkpoint(test)
    if ckpt is None:
        raise FileNotFoundError(
            f"no usable run checkpoint under {store.path(test)}")
    test["_prior_history"] = store.load_wal_history(test)
    gen_state = ckpt.get("generator")
    if gen_state:
        generator.restore(test["generator"], gen_state)
    ledger = list(ckpt.get("faults") or [])
    if ledger:
        test["_resume_ledger"] = ledger
    procs = ckpt.get("processes")
    if procs:
        test["_resume_processes"] = [int(p) for p in procs]
    log.info(
        "Resuming run %s/%s: %d prior op(s), %d leftover fault(s)",
        test["name"], store.time_str(test["start_time"]),
        len(test["_prior_history"]), len(ledger))
    store.start_logging(test)
    try:
        real_pmap(test["remote"].connect, test["nodes"])
        try:
            with _SnarfHook(test) as hook:
                try:
                    with with_relative_time(
                            int(ckpt.get("elapsed_nanos") or 0)):
                        test["history"] = index(run_case(test))
                    preempted = test.pop("_preempted", False)
                    log.info("Resumed run complete, writing")
                    store.save_1(test)
                    if preempted:
                        test["_preserve_db"] = True
                        log.warning("Resumed run preempted again; "
                                    "state saved for another resume")
                        raise SystemExit(143)
                    analyze(test)
                finally:
                    hook.snarf_once()
                    if (test.get("db") is not None
                            and not test.get("_preserve_db")):
                        control.on_nodes(
                            test, lambda t, n: test["db"].teardown(t, n))
        finally:
            for node in test["nodes"]:
                test["remote"].disconnect(node)
        log_results(test)
        return test
    finally:
        store.stop_logging(test)


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
