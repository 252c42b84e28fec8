"""Auto-reconnecting connection wrappers (reference: jepsen.reconnect,
reconnect.clj:1-129).

A Wrapper owns a connection plus open/close functions. Many threads may
use the connection concurrently (read lock); open/close/reopen take the
write lock. `with_conn()` yields the current connection and, if the body
throws, closes and reopens it (once, only if it's still the same
connection that failed) before re-raising.

The port's copy of `jepsen_tpu/reconnect.py`."""

from __future__ import annotations

import logging
import random
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable

log = logging.getLogger("jepsen_tpu_torch.reconnect")


class RWLock:
    """Write-preferring reentrant reader/writer lock (the reference's
    ReentrantReadWriteLock, reconnect.clj:14,30).

    Matches java.util.concurrent semantics: a thread may re-acquire the
    read lock it already holds (nested with_conn works), the writer may
    take the read lock (downgrade), and write acquisition is reentrant.
    Read→write *upgrade* is not supported — like the Java lock, a
    reader calling acquire_write deadlocks — so open()/close()/reopen()
    must not be called from inside a with_conn body."""

    def __init__(self):
        self._cond = threading.Condition()
        self._read_holds: dict[int, int] = {}  # thread id -> hold count
        self._writer: int | None = None  # owning thread id
        self._write_holds = 0
        self._writers_waiting = 0

    def acquire_read(self):
        me = threading.get_ident()
        with self._cond:
            if self._read_holds.get(me) or self._writer == me:
                self._read_holds[me] = self._read_holds.get(me, 0) + 1
                return
            while self._writer is not None or self._writers_waiting:
                self._cond.wait()
            self._read_holds[me] = 1

    def release_read(self):
        me = threading.get_ident()
        with self._cond:
            n = self._read_holds.get(me, 0) - 1
            if n > 0:
                self._read_holds[me] = n
            else:
                self._read_holds.pop(me, None)
                if not self._read_holds:
                    self._cond.notify_all()

    def acquire_write(self):
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._write_holds += 1
                return
            self._writers_waiting += 1
            try:
                while self._writer is not None or self._read_holds:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = me
            self._write_holds = 1

    def release_write(self):
        with self._cond:
            self._write_holds -= 1
            if self._write_holds == 0:
                self._writer = None
                self._cond.notify_all()

    def release_all_reads(self) -> int:
        """Drop every read hold this thread has; returns the count so it
        can be restored with reacquire_reads. Used by with_conn's
        error path so a nested body can still trade up to the write
        lock without deadlocking on its own outer holds."""
        me = threading.get_ident()
        with self._cond:
            n = self._read_holds.pop(me, 0)
            if n and not self._read_holds:
                self._cond.notify_all()
            return n

    def reacquire_reads(self, n: int):
        if n <= 0:
            return
        me = threading.get_ident()
        with self._cond:
            if self._read_holds.get(me) or self._writer == me:
                self._read_holds[me] = self._read_holds.get(me, 0) + n
                return
            while self._writer is not None or self._writers_waiting:
                self._cond.wait()
            self._read_holds[me] = n

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()


class Wrapper:
    """Stateful reconnecting handle to a database connection
    (reconnect.clj:16-31)."""

    def __init__(
        self,
        open: Callable[[], Any],
        close: Callable[[Any], None],
        name: str | None = None,
        log_reconnects: bool = True,
        max_retries: int = 1,
        backoff_base: float = 0.05,
        backoff_cap: float = 5.0,
        seed: int | None = None,
    ):
        """max_retries is the number of open ATTEMPTS per (re)open
        (default 1 — the historical immediate-single-attempt behavior);
        between failed attempts we sleep a capped exponential backoff
        with seeded jitter, and the LAST error surfaces to the caller."""
        assert callable(open) and callable(close)
        assert max_retries >= 1
        self._open = open
        self._close = close
        self.name = name
        self.log_reconnects = log_reconnects
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.lock = RWLock()
        self._conn: Any = None

    def _backoff(self, attempt: int) -> float:
        """Capped exponential backoff with jitter in [0.5x, 1.5x) —
        seeded so a test run's reconnect schedule replays exactly."""
        with self._rng_lock:
            jitter = 0.5 + self._rng.random()
        return min(self.backoff_cap, self.backoff_base * 2 ** attempt) * jitter

    def _open_retry(self):
        """One logical open = up to max_retries attempts with backoff;
        raises the last error when all fail. Called under the write
        lock."""
        last: Exception | None = None
        for attempt in range(self.max_retries):
            if attempt:
                delay = self._backoff(attempt - 1)
                if self.log_reconnects:
                    log.warning(
                        "Reopen %r attempt %d/%d failed; retrying in "
                        "%.2fs", self.name, attempt, self.max_retries,
                        delay)
                time.sleep(delay)
            try:
                c = self._open()
            except Exception as e:  # noqa: BLE001
                last = e
                continue
            if c is None:
                raise RuntimeError(
                    f"Reconnect wrapper {self.name!r}'s open function "
                    "returned None instead of a connection!"
                )
            return c
        assert last is not None
        raise last

    def conn(self):
        """The active connection, if any (reconnect.clj:49-52)."""
        return self._conn

    def open(self) -> "Wrapper":
        """Open a connection; no-op if already open
        (reconnect.clj:54-66)."""
        with self.lock.write():
            if self._conn is None:
                self._conn = self._open_retry()
        return self

    def close(self) -> "Wrapper":
        """Close the connection, if open (reconnect.clj:68-75)."""
        with self.lock.write():
            if self._conn is not None:
                self._close(self._conn)
                self._conn = None
        return self

    def reopen(self) -> "Wrapper":
        """Close (if open) and open a fresh connection
        (reconnect.clj:77-90)."""
        with self.lock.write():
            if self._conn is not None:
                self._close(self._conn)
                self._conn = None
            self._conn = self._open_retry()
        return self

    @contextmanager
    def with_conn(self):
        """Yield the current connection under the read lock; on any
        exception, reopen the connection (if it's still the one that
        failed) and re-raise the original error (reconnect.clj:92-129)."""
        self.lock.acquire_read()
        c = self._conn
        try:
            yield c
        except Exception:
            # Trade the read lock for the write lock to reopen. Release
            # ALL of this thread's read holds (we may be nested) so the
            # write acquisition can't deadlock on our own outer holds.
            held = self.lock.release_all_reads()
            try:
                with self.lock.write():
                    if self._conn is c:
                        if self.log_reconnects:
                            log.warning(
                                "Encountered error with conn %r; reopening",
                                self.name,
                            )
                        if self._conn is not None:
                            try:
                                self._close(self._conn)
                            finally:
                                self._conn = None
                        self._conn = self._open_retry()
            except Exception:  # noqa: BLE001
                # Log but don't mask the original transaction error
                if self.log_reconnects:
                    log.warning("Error reopening %r", self.name, exc_info=True)
            finally:
                self.lock.reacquire_reads(held)
            raise
        finally:
            self.lock.release_read()


def wrapper(open, close, name=None, log_reconnects=True, **kw) -> Wrapper:
    return Wrapper(open, close, name=name, log_reconnects=log_reconnects,
                   **kw)
