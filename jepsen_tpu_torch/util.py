"""General-purpose helpers (the port's copy of what it needs from
`jepsen_tpu.util`): parallel maps over threads and processes, retries,
latches, relative time, time units, interval-set strings and latency
extraction over histories."""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import logging
import multiprocessing
import os
import pickle
import threading
import time as _time
from typing import Any, Callable, Iterable

from .history import op as to_op

NANOS_PER_SECOND = 1_000_000_000
NANOS_PER_MS = 1_000_000


def majority(n: int) -> int:
    """Smallest integer m such that m > n/2 (util.clj:59-62)."""
    return n // 2 + 1


def real_pmap(fn: Callable, coll: Iterable) -> list:
    """Map fn over coll with one real thread per element, propagating the
    first exception (util.clj:46-52). Unlike a pooled map, every element
    gets its own thread at once — needed when elements block on each
    other (barriers across nodes)."""
    items = list(coll)
    if not items:
        return []
    results: list[Any] = [None] * len(items)
    errors: list[BaseException] = []
    lock = threading.Lock()

    def run(i, x):
        try:
            results[i] = fn(x)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            with lock:
                errors.append(e)

    threads = [threading.Thread(target=run, args=(i, x), daemon=True)
               for i, x in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def with_retry(fn: Callable[[], Any], retries: int = 3, backoff: float = 0.0,
               exceptions: tuple = (Exception,)) -> Any:
    """Call fn, retrying up to `retries` times on exception
    (util.clj:339-363)."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions:
            attempt += 1
            if attempt > retries:
                raise
            if backoff:
                _time.sleep(backoff)


_op_log = logging.getLogger("jepsen_tpu_torch.ops")


def log_op_logger(op) -> None:
    """Log an op at debug level (util.clj:208-212)."""
    _op_log.debug("%s", op)


class CountDownLatch:
    """count_down() decrements; await_() blocks until zero (the JVM latch
    of the worker phase gates, core.clj:174-225)."""

    def __init__(self, count: int):
        self._count = count
        self._cond = threading.Condition()

    def count_down(self) -> None:
        with self._cond:
            if self._count > 0:
                self._count -= 1
                if self._count == 0:
                    self._cond.notify_all()

    def await_(self, timeout: float | None = None) -> bool:
        with self._cond:
            if self._count == 0:
                return True
            return self._cond.wait_for(lambda: self._count == 0, timeout)


# ---------------------------------------------------------------------------
# Relative time (util.clj:271-288)

_relative_origin: int | None = None
_relative_lock = threading.Lock()


def init_relative_time(origin_nanos: int | None = None) -> None:
    """Set the origin of relative_time_nanos (util.clj:271-280)."""
    global _relative_origin
    with _relative_lock:
        _relative_origin = (origin_nanos if origin_nanos is not None
                            else _time.monotonic_ns())


def relative_time_nanos() -> int:
    """Nanoseconds since the origin set by init_relative_time
    (util.clj:282-288); initialised on first use."""
    if _relative_origin is None:
        init_relative_time()
    return _time.monotonic_ns() - _relative_origin


@contextlib.contextmanager
def with_relative_time(elapsed_nanos: int = 0):
    """A scope with a fresh relative-time origin. elapsed_nanos backdates
    the origin: a resumed run passes the preempted session's elapsed
    time so op timestamps stay monotone across sessions."""
    global _relative_origin
    prev = _relative_origin
    init_relative_time(_time.monotonic_ns() - int(elapsed_nanos))
    try:
        yield
    finally:
        with _relative_lock:
            _relative_origin = prev


def nanos_to_ms(n: float) -> float:
    return n / NANOS_PER_MS


def nanos_to_secs(n: float) -> float:
    return n / NANOS_PER_SECOND


def bounded_pmap(fn: Callable, coll: Iterable, bound: int | None = None) -> list:
    """Pooled parallel map with at most `bound` workers (util.clj bounded
    concurrency; default = cpu count + 2)."""
    items = list(coll)
    if not items:
        return []
    bound = bound or (os.cpu_count() or 1) + 2
    with concurrent.futures.ThreadPoolExecutor(max_workers=bound) as ex:
        return list(ex.map(fn, items))


def bounded_pmap_processes(fn: Callable, coll: Iterable,
                           bound: int | None = None) -> list:
    """Like bounded_pmap but over a pool of at most `bound` worker
    processes (default: the cpu count), for CPU-bound work the GIL would
    serialize. fn and every item must be picklable.

    Workers are spawned, never forked: CUDA cannot be forked once it is
    up, so each worker starts from a fresh import and opens its own
    context. An exception of a worker re-raises here, a fault of the
    card (`checker.is_fault`) included, and so does a worker that died
    (BrokenProcessPool: it may have died of the card). Only when the
    workers cannot start or their payloads cannot be pickled (OSError,
    PermissionError, PicklingError) does the map run on threads instead,
    as the JAX package's does."""
    items = list(coll)
    if not items:
        return []
    bound = min(bound or (os.cpu_count() or 1), len(items)) or 1
    ctx = multiprocessing.get_context("spawn")
    try:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=bound, mp_context=ctx) as ex:
            return list(ex.map(fn, items))
    except (OSError, pickle.PicklingError):
        return bounded_pmap(fn, items, bound=bound)


def integer_interval_set_str(values: Iterable[int]) -> str:
    """Compact string for a set of integers, collapsing runs:
    #{1..3 5 7..9} (util.clj:528-553)."""
    xs = sorted(set(values))
    if not xs:
        return "#{}"
    parts = []
    lo = prev = xs[0]
    for x in xs[1:]:
        if x == prev + 1:
            prev = x
            continue
        parts.append(str(lo) if lo == prev else f"{lo}..{prev}")
        lo = prev = x
    parts.append(str(lo) if lo == prev else f"{lo}..{prev}")
    return "#{" + " ".join(parts) + "}"


def history_latencies(history) -> list:
    """Each invoke op of a history as {"op", "latency", "completion"}:
    the completion's time less the invocation's (nanos), or None for an
    invocation never completed (util.clj:598-632)."""
    out = []
    open_by_process: dict = {}
    for o in map(to_op, history):
        if o.is_invoke:
            rec = {"op": o, "latency": None, "completion": None}
            open_by_process[o.process] = rec
            out.append(rec)
        else:
            rec = open_by_process.pop(o.process, None)
            if rec is not None:
                rec["latency"] = o.time - rec["op"].time
                rec["completion"] = o
    return out


def nemesis_intervals(history, start_fs=("start",), stop_fs=("stop",)) -> list:
    """Pairs of (start-op, stop-op) delimiting nemesis activity windows
    (util.clj:634-651). Histories interleave invocations and completions
    (start start stop stop), so each stop pairs FIFO with the oldest
    unpaired start; unclosed windows get a None stop."""
    pairs = []
    starts: collections.deque = collections.deque()
    for o in map(to_op, history):
        if o.process != "nemesis":
            continue
        if o.f in start_fs:
            starts.append(o)
        elif o.f in stop_fs and starts:
            pairs.append((starts.popleft(), o))
    pairs.extend((s, None) for s in starts)
    return pairs
