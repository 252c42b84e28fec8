"""Persistent storage for test runs and later analysis (the port's copy
of `jepsen_tpu/store.py`; reference: jepsen.store, store.clj).

The on-disk layout and formats are the JAX package's, so a store or an
analysis journal written by one package reads in the other
(store.clj:125-154, 302-328):

    store/<test-name>/<start-time>/
        jepsen.log       engine log for the run          (store.clj:398-418)
        history.txt      human-readable op log           (store.clj:340-357)
        history.jsonl    one JSON op per line (the EDN history analog)
        history.npz      TensorHistory, the flat int64 encoding
        test.json        serializable test-map snapshot  (store.clj:167-175)
        results.json     analysis results                (store.clj:336-339)
        analysis.ckpt.jsonl  the analysis journal (finished keys and
                         closures, so a killed analysis resumes)
        independent/<key>/results.edn, history.txt, linear.svg
                         per-key artifacts of the independent checker
    store/current        symlink -> the running test     (store.clj:302-328)
    store/latest         symlink -> the newest saved test
    store/<name>/latest  symlink -> the newest run of that test

There is no opaque binary snapshot (fressian, store.clj:28-123): every
artifact is JSON, text, or the npz tensor, all reloadable without the
defining code. `load()` reloads a stored history for a fresh check.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import shutil
import threading
from typing import Any, Iterable

from .history import Op, TensorHistory

BASE_DIR = "store"

log = logging.getLogger("jepsen_tpu_torch.store")

#: test-map keys that hold live objects and never serialize
#: (store.clj:167-172), plus engine internals.
DEFAULT_NONSERIALIZABLE_KEYS = {
    "db",
    "os",
    "net",
    "client",
    "checker",
    "nemesis",
    "generator",
    "model",
    "remote",
    "ssh",
    "barrier",
    "active_histories",
    "schema",
}


def nonserializable_keys(test) -> set:
    """Default nonserializable keys plus the test's own
    (store.clj:174-179), plus every "_"-prefixed engine-internal key."""
    ks = set(DEFAULT_NONSERIALIZABLE_KEYS)
    ks.update(test.get("nonserializable_keys", ()))
    ks.update(k for k in test if isinstance(k, str) and k.startswith("_"))
    return ks


def time_str(t) -> str:
    """Render a start-time as a directory name (the reference's
    :basic-date-time local format, store.clj:131-141)."""
    if isinstance(t, str):
        return t
    if isinstance(t, datetime.datetime):
        return t.strftime("%Y%m%dT%H%M%S.%f")[:-3]
    raise TypeError(f"can't render start_time {t!r}")


def base_dir(test=None) -> str:
    """The store root; override per-test with :store_dir."""
    if test is not None and test.get("store_dir"):
        return str(test["store_dir"])
    return BASE_DIR


def _flatten(args) -> list:
    out = []
    for a in args:
        if a is None:
            continue
        if isinstance(a, (list, tuple)):
            out.extend(_flatten(a))
        else:
            out.append(str(a))
    return out


def path(test, *args) -> str:
    """The directory for a test's results; extra args name a file inside
    it. Nested lists flatten; None components are ignored
    (store.clj:125-147)."""
    assert test.get("name"), "test needs a :name to have a store path"
    assert test.get("start_time"), "test needs a :start_time"
    d = os.path.join(
        base_dir(test), str(test["name"]), time_str(test["start_time"])
    )
    return os.path.join(d, *_flatten(args)) if args else d


def path_(test, *args) -> str:
    """path(), but ensures the containing directory exists
    (store.clj:149-154)."""
    p = path(test, *args)
    os.makedirs(os.path.dirname(p) if args else p, exist_ok=True)
    return p


# ---------------------------------------------------------------------------
# Writers

def atomic_write_json(p: str, value, rotate_prev: bool = False) -> str:
    """Crash-consistent JSON write: temp → flush+fsync → rename, so a
    SIGKILL at any instant leaves either the old file or the new one,
    never a torn half-write. With ``rotate_prev`` the previous current
    file is rotated to ``.prev`` first (the RunCheckpoint discipline).
    This is the single write primitive the checkpoint and the fuzz
    corpus share."""
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_json_keys(value), f, default=_json_default)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    if rotate_prev and os.path.exists(p):
        os.replace(p, p + ".prev")
    os.replace(tmp, p)
    return p


def read_json_dict(p: str) -> dict | None:
    """Best-effort read-back of an atomic_write_json file: the dict, or
    None for missing/torn/non-dict content ('a disk that lies must not
    wedge us')."""
    try:
        with open(p) as f:
            v = json.load(f)
        return v if isinstance(v, dict) else None
    except (OSError, ValueError):
        return None


def _json_keys(v):
    """json's default= hook never applies to dict KEYS — independent-
    checker results are keyed by arbitrary workload keys (e.g. tuples),
    so stringify any non-primitive key up front."""
    if isinstance(v, dict):
        return {
            k if isinstance(k, (str, int, float, bool)) or k is None else str(k):
            _json_keys(x)
            for k, x in v.items()
        }
    if isinstance(v, (list, tuple)):
        return [_json_keys(x) for x in v]
    return v


def _json_default(o):
    if isinstance(o, datetime.datetime):
        return o.isoformat()
    if isinstance(o, Op):
        return o.to_dict()
    if isinstance(o, (set, frozenset)):
        return sorted(o, key=repr)
    if isinstance(o, bytes):
        return o.decode("utf-8", "replace")
    if hasattr(o, "item"):  # numpy scalars
        return o.item()
    if hasattr(o, "tolist"):  # numpy arrays
        return o.tolist()
    return repr(o)


def write_json(test, subpath, value) -> str:
    """Write any value as pretty JSON under the test dir."""
    p = path_(test, subpath)
    with open(p, "w") as f:
        json.dump(_json_keys(value), f, indent=1, default=_json_default)
        f.write("\n")
    return p


# independent.py historically calls this write_edn (the reference writes
# results.edn); the on-disk format here is JSON.
write_edn = write_json


#: incremental-durability sidecar: one JSON op per line, appended as ops
#: land during the run (vs history.jsonl, written once at save_1)
WAL_FILE = "history.wal.jsonl"

#: when HistoryWAL calls os.fsync: every op / nemesis ops + close / close
WAL_FSYNC_POLICIES = ("op", "nemesis", "close")


def _terminate_torn_tail(f, p: str) -> None:
    """A mid-write kill can leave an append-mode JSONL file without a
    trailing newline; the next append would glue onto the torn line and
    corrupt BOTH records. Terminate the tail so the torn line stays an
    isolated, droppable parse failure."""
    try:
        size = os.path.getsize(p)
        if size:
            with open(p, "rb") as r:
                r.seek(size - 1)
                if r.read(1) != b"\n":
                    f.write("\n")
                    f.flush()
    except OSError:
        pass


class HistoryWAL:
    """Append-only JSONL write-ahead log of the live history.

    A run opens one and appends every op (invocations AND completions)
    the moment it lands, each line flushed
    so a SIGKILL'd run leaves an analyzable partial history on disk for
    ``load_history`` to fall back to — the in-memory history plus a
    final ``store.write_history`` is otherwise all-or-nothing. A torn
    final line (killed mid-write) is expected and tolerated on load.

    Every line is stamped with a **session epoch** (``_epoch``): a
    resumed run reopens the same file in append mode under epoch
    last+1, so ``load_history`` can reindex deterministically across
    sessions instead of colliding op indices. The stamp is an engine
    key, stripped before ops are rebuilt.

    The fsync policy is configurable (``test["wal_fsync"]`` or the
    ``fsync`` argument): ``"op"`` fsyncs every line (maximum
    durability, slowest), ``"nemesis"`` (the default) fsyncs lines the
    nemesis lands — fault boundaries are always durable without paying
    per-op fsync — and ``"close"`` only on close. Every policy still
    flushes each line to the OS, so only an OS/power crash (not a mere
    process SIGKILL) can lose un-fsynced ops.

    Appends are serialized by a lock: client workers and the nemesis
    land ops concurrently. A failed append disables the WAL rather than
    failing the run — durability is best-effort, the verdict is not."""

    def __init__(self, test, fsync: str | None = None):
        policy = fsync or (test or {}).get("wal_fsync") or "nemesis"
        if policy not in WAL_FSYNC_POLICIES:
            raise ValueError(
                f"wal_fsync must be one of {WAL_FSYNC_POLICIES}, "
                f"got {policy!r}")
        self.fsync_policy = policy
        self._path = path_(test, WAL_FILE)
        self._lock = threading.Lock()
        self.epoch = self._next_epoch(self._path)
        self._f = open(self._path, "a")
        _terminate_torn_tail(self._f, self._path)

    @staticmethod
    def _next_epoch(p: str) -> int:
        """One past the last parseable line's epoch; 0 for a fresh file.
        A nonempty file with no parseable line still advances (a prior
        session existed, even if only its torn tail survives)."""
        try:
            if not os.path.exists(p) or os.path.getsize(p) == 0:
                return 0
        except OSError:
            return 0
        last = None
        with open(p) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    last = json.loads(line)
                except ValueError:
                    continue
        if not isinstance(last, dict):
            return 1
        try:
            return int(last.get("_epoch", 0)) + 1
        except (TypeError, ValueError):
            return 1

    @staticmethod
    def follow(p: str, *, poll_s: float = 0.05, stop=None):
        """Tail-follow reader over a (possibly live) WAL file: yields
        reindexed Ops as lines land, holding a torn tail back until a
        resumed writer terminates it. Delegates to ``follow_wal`` —
        the same parse/stitch logic ``load_wal_history`` batch-reads
        with."""
        return follow_wal(p, follow=True, poll_s=poll_s, stop=stop)

    def append(self, op: Op) -> None:
        with self._lock:
            if self._f is None:
                return
            try:
                rec = op.to_dict()
                rec["_epoch"] = self.epoch
                self._f.write(json.dumps(rec, default=_json_default))
                self._f.write("\n")
                self._f.flush()
                if self.fsync_policy == "op" or (
                    self.fsync_policy == "nemesis"
                    and op.process == "nemesis"
                ):
                    os.fsync(self._f.fileno())
            except Exception:  # noqa: BLE001 — best-effort durability
                log.warning("history WAL append failed; disabling",
                            exc_info=True)
                try:
                    self._f.close()
                except Exception:  # noqa: BLE001
                    pass
                self._f = None

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    os.fsync(self._f.fileno())
                except (OSError, ValueError):
                    pass
                self._f.close()
                self._f = None


#: crash-consistent snapshot of live run state, written periodically
CKPT_FILE = "run.ckpt.json"


class RunCheckpoint:
    """Crash-consistent run-state snapshots for preemption-tolerant
    runs: generator cursors/rng states, the nemesis active-fault
    ledger, the process table, the WAL session epoch, and a wall-clock
    anchor (the caller assembles the dict; this class only guarantees
    durability).

    write() goes temp → flush+fsync → rotate current→``.prev`` →
    rename temp→current, so a SIGKILL at ANY instant leaves the new
    checkpoint, the previous good one, or both — never zero. load()
    validates the current file and falls back to ``.prev`` on a
    torn/truncated/missing current; a stale ``.tmp`` leftover is
    ignored and overwritten by the next write."""

    def __init__(self, test):
        self._path = path_(test, CKPT_FILE)
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        return self._path

    def write(self, state: dict) -> str:
        with self._lock:
            return atomic_write_json(self._path, state, rotate_prev=True)

    def load(self) -> dict | None:
        """The newest readable checkpoint, or None when neither the
        current file nor .prev parses."""
        for p in (self._path, self._path + ".prev"):
            try:
                with open(p) as f:
                    state = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(state, dict):
                return state
        return None


def load_checkpoint(test) -> dict | None:
    """The newest readable run checkpoint for a test dir, or None."""
    return RunCheckpoint(test).load()


#: append-only journal of finished analysis units (resumable analysis)
ANALYSIS_CKPT_FILE = "analysis.ckpt.jsonl"


class AnalysisJournal:
    """Append-only JSONL journal of completed analysis verdicts, so
    re-running analysis of a huge history skips finished work: the
    independent checker journals per-key linearizability verdicts
    ("independent-key") and the cycle checker journals per-component
    closure results ("closure") as they complete.

    Each line is ``{"kind", "key", "result"}``; keys are stringified
    for a stable JSON identity. Loading tolerates a torn tail (a kill
    mid-append loses at most the line being written). Journaled results
    round-trip through JSON — Ops inside come back as plain dicts — so
    consumers treat them as opaque verdicts, not live objects."""

    def __init__(self, test, path: str | None = None):
        """Open a test's journal, or — with an explicit ``path`` — a
        free-standing one (kept in a state dir with no test map at
        all)."""
        if path is None:
            self._path = path_(test, ANALYSIS_CKPT_FILE)
        else:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._path = path
        self._lock = threading.Lock()
        self._done: dict = {}
        try:
            with open(self._path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                        self._done[(rec["kind"], rec["key"])] = \
                            rec.get("result")
                    except (ValueError, KeyError, TypeError):
                        log.warning(
                            "analysis journal: dropping torn line %r",
                            line[:80])
        except FileNotFoundError:
            pass
        self._f = open(self._path, "a")
        _terminate_torn_tail(self._f, self._path)

    @property
    def path(self) -> str:
        return self._path

    def __len__(self) -> int:
        return len(self._done)

    def contains(self, kind: str, key) -> bool:
        return (kind, str(key)) in self._done

    def get(self, kind: str, key):
        return self._done.get((kind, str(key)))

    def record(self, kind: str, key, result) -> None:
        key = str(key)
        with self._lock:
            if (kind, key) in self._done:
                return
            self._done[(kind, key)] = result
            if self._f is None:
                return
            try:
                self._f.write(json.dumps(
                    {"kind": kind, "key": key,
                     "result": _json_keys(result)},
                    default=_json_default))
                self._f.write("\n")
                self._f.flush()
            except Exception:  # noqa: BLE001 — journal is best-effort
                log.warning("analysis journal append failed; disabling",
                            exc_info=True)
                try:
                    self._f.close()
                except Exception:  # noqa: BLE001
                    pass
                self._f = None

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def write_history_txt(test, subpath, history: Iterable[Op]) -> str:
    """history.txt: one tab-separated line per op (util/pwrite-history!
    format, util.clj:184-206)."""
    p = path_(test, subpath)
    with open(p, "w") as f:
        for o in history:
            f.write(str(o))
            f.write("\n")
    return p


def write_history(test) -> None:
    """Write history.txt + history.jsonl (+ history.npz when the test
    carries a tensor schema) — store.clj:340-357."""
    hist = test.get("history") or []
    write_history_txt(test, "history.txt", hist)
    p = path_(test, "history.jsonl")
    with open(p, "w") as f:
        for o in hist:
            f.write(json.dumps(o.to_dict(), default=_json_default))
            f.write("\n")
    schema = test.get("schema")
    if schema is not None:
        try:
            TensorHistory.encode(hist, schema).save(path_(test, "history.npz"))
        except Exception:  # noqa: BLE001 — tensor snapshot is best-effort
            log.warning("couldn't write history.npz", exc_info=True)


def write_test(test) -> str:
    """test.json: the serializable slice of the test map (the fressian
    snapshot analog, store.clj:359-366)."""
    drop = nonserializable_keys(test)
    snap = {k: v for k, v in test.items() if k not in drop and k != "history"}
    snap["start_time"] = time_str(test["start_time"])
    return write_json(test, "test.json", snap)


def write_results(test) -> str:
    """results.json (store.clj:336-339)."""
    return write_json(test, "results.json", test.get("results"))


# ---------------------------------------------------------------------------
# Symlinks

def update_symlink(test, dest_parts: list) -> None:
    """Symlink base_dir/<dest_parts...> -> the test dir, replacing any
    existing link (store.clj:302-313)."""
    src = path(test)
    if not os.path.exists(src):
        return
    dest = os.path.join(base_dir(test), *dest_parts)
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    try:
        if os.path.islink(dest) or os.path.exists(dest):
            os.remove(dest)
        os.symlink(os.path.relpath(src, os.path.dirname(dest)), dest)
    except OSError:
        log.warning("couldn't update symlink %s", dest, exc_info=True)


def update_current_symlink(test) -> None:
    update_symlink(test, ["current"])


def update_symlinks(test) -> None:
    """current, latest, and <name>/latest (store.clj:315-328)."""
    for dest in (["current"], ["latest"], [str(test["name"]), "latest"]):
        update_symlink(test, dest)


# ---------------------------------------------------------------------------
# Save phases (core.clj:636 calls save_1 post-run; analyze! calls save_2)

def save_1(test) -> dict:
    """Phase 1, after the run: history + test snapshot + symlinks
    (store.clj:367-379)."""
    write_history(test)
    write_test(test)
    update_symlinks(test)
    return test


def save_2(test) -> dict:
    """Phase 2, after analysis: results + refreshed test snapshot.
    Unlike the reference (store.clj:381-392), the history is NOT
    rewritten: core.run() indexes the history BEFORE save_1 writes it,
    analysis doesn't mutate it further, and rewriting a 10k+-op history
    twice per run is wasted I/O. (If you call save_1 with an unindexed
    history yourself, index it first — this phase won't fix it up.)"""
    write_results(test)
    write_test(test)
    update_symlinks(test)
    return test


# ---------------------------------------------------------------------------
# Loading

def tests(name=None, store_dir=None) -> dict:
    """With no name: {test-name: {time-str: dir}}. With a name:
    {time-str: dir} (store.clj:241-266)."""
    root = store_dir or BASE_DIR
    if name is None:
        out = {}
        if os.path.isdir(root):
            for n in sorted(os.listdir(root)):
                if n in ("latest", "current"):
                    continue
                if os.path.isdir(os.path.join(root, n)):
                    out[n] = tests(n, store_dir=root)
        return out
    d = os.path.join(root, str(name))
    out = {}
    if os.path.isdir(d):
        for t in sorted(os.listdir(d)):
            full = os.path.join(d, t)
            if t != "latest" and os.path.isdir(full):
                out[t] = full
    return out


def load_history(test) -> list[Op]:
    """Reload a run's history, preferring the jsonl form. A run that
    died before save_1 (SIGKILL, OOM, power) leaves no history.jsonl —
    fall back to the WAL the run appended as ops landed, tolerating a
    torn final line."""
    p = path(test, "history.jsonl")
    if os.path.exists(p):
        with open(p) as f:
            return [Op.from_dict(json.loads(line)) for line in f if line.strip()]
    p = path(test, "history.npz")
    if os.path.exists(p):
        return TensorHistory.load(p).decode()
    p = path(test, WAL_FILE)
    if os.path.exists(p):
        return load_wal_history(test)
    raise FileNotFoundError(f"no stored history under {path(test)}")


def _parse_wal_line(line: str) -> tuple[int, Op] | None:
    """One WAL line as an (epoch, op) pair, or None for a torn/blank
    line. Strips the "_"-prefixed engine stamps before the op is
    rebuilt (Op.from_dict would otherwise shelve them under .extra)."""
    if not line.strip():
        return None
    try:
        rec = json.loads(line)
        epoch = int(rec.pop("_epoch", 0))
        for k in [k for k in rec
                  if isinstance(k, str) and k.startswith("_")]:
            del rec[k]
        return (epoch, Op.from_dict(rec))
    except (ValueError, KeyError, TypeError, AttributeError):
        # torn tail from a mid-write kill: salvage the prefix
        log.warning("WAL: dropping unparseable line %r", line[:80])
        return None


def _parse_wal(p: str) -> list[tuple[int, Op]]:
    """(epoch, op) pairs from a WAL file, tolerating a torn tail."""
    out = []
    with open(p) as f:
        for line in f:
            pair = _parse_wal_line(line)
            if pair is not None:
                out.append(pair)
    return out


def _stitch_wal(pairs: list[tuple[int, Op]]) -> list[Op]:
    """Stitch (epoch, op) pairs into one history, reindexed 0..n-1.
    Stable sort by session epoch first (arrival order preserved within
    an epoch), so a run appended across resume sessions gets monotonic,
    collision-free indices — WAL lines land BEFORE history finalization
    assigns indices (index=-1), and pairs/checkers require monotonic
    ones."""
    pairs = sorted(pairs, key=lambda pair: pair[0])
    return [o.with_(index=i) for i, (_, o) in enumerate(pairs)]


def load_wal_history(test) -> list[Op]:
    """The salvageable ops of a run's WAL, stitched and reindexed.
    Returns [] when no WAL exists."""
    p = path(test, WAL_FILE)
    if not os.path.exists(p):
        return []
    return _stitch_wal(_parse_wal(p))


def follow_wal(p: str, *, follow: bool = False, poll_s: float = 0.05,
               stop=None):
    """Iterate a WAL file's salvageable ops, reindexed exactly as
    ``load_wal_history`` stitches them (same per-line salvage, same
    epoch-stable order — a WAL only ever appends, and every session's
    epoch exceeds its predecessors', so file order IS stitch order).

    With ``follow=False`` this is the one-shot batch read. With
    ``follow=True`` the iterator tails the file: it keeps polling for
    appended lines (surviving the file not existing yet) until ``stop``
    (a threading.Event) is set. Only newline-terminated records are
    yielded while tailing — a torn tail from a mid-write kill is held
    back, and becomes visible the moment a resumed session's
    ``HistoryWAL`` terminates it (or is dropped by its parse failure),
    matching the batch reader's salvage behavior."""
    if not follow:
        if os.path.exists(p):
            yield from _stitch_wal(_parse_wal(p))
        return
    import time as _time

    f = None
    buf = b""
    idx = 0
    try:
        while True:
            if f is None:
                try:
                    f = open(p, "rb")
                except OSError:
                    f = None
            progressed = False
            if f is not None:
                chunk = f.read()
                if chunk:
                    progressed = True
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        pair = _parse_wal_line(
                            line.decode("utf-8", "replace"))
                        if pair is None:
                            continue
                        yield pair[1].with_(index=idx)
                        idx += 1
            if stop is not None and stop.is_set():
                return
            if not progressed:
                _time.sleep(poll_s)
    finally:
        if f is not None:
            f.close()


def follow_wal_history(test, *, follow: bool = False, poll_s: float = 0.05,
                       stop=None):
    """``follow_wal`` over a test's own WAL path."""
    return follow_wal(path(test, WAL_FILE), follow=follow, poll_s=poll_s,
                      stop=stop)


def load(name, time_s, store_dir=None) -> dict:
    """Load a stored test by name and time: the test.json snapshot with
    its history attached (store.clj:177-184)."""
    test = {"name": name, "start_time": time_s}
    if store_dir:
        test["store_dir"] = store_dir
    p = path(test, "test.json")
    if os.path.exists(p):
        with open(p) as f:
            snap = json.load(f)
        snap.pop("store_dir", None)
        test.update(snap)
        test["name"], test["start_time"] = name, time_s
        if store_dir:
            test["store_dir"] = store_dir
    test["history"] = load_history(test)
    return test


def load_results(name, time_s, store_dir=None) -> Any:
    """Load only results.json (store.clj:224-233)."""
    test = {"name": name, "start_time": time_s}
    if store_dir:
        test["store_dir"] = store_dir
    with open(path(test, "results.json")) as f:
        return json.load(f)


def _resolve_latest(store_dir=None):
    root = store_dir or BASE_DIR
    link = os.path.join(root, "latest")
    # Trust the symlink only while it resolves — delete() can leave it
    # dangling; fall back to scanning.
    if os.path.islink(link) and os.path.isdir(os.path.realpath(link)):
        target = os.path.realpath(link)
        time_s = os.path.basename(target)
        name = os.path.basename(os.path.dirname(target))
        return name, time_s
    newest = None
    for name, runs in tests(store_dir=root).items():
        for t in runs:
            if newest is None or t > newest[1]:
                newest = (name, t)
    return newest


def latest(store_dir=None) -> dict | None:
    """Load the most recent test (store.clj:291-300)."""
    found = _resolve_latest(store_dir)
    if found is None:
        return None
    return load(found[0], found[1], store_dir=store_dir)


def delete(name=None, time_s=None, store_dir=None) -> None:
    """Delete all tests / all runs of a test / one run
    (store.clj:420-437)."""
    root = store_dir or BASE_DIR
    if name is None:
        for n in list(tests(store_dir=root)):
            delete(n, store_dir=root)
    elif time_s is None:
        d = os.path.join(root, str(name))
        if os.path.isdir(d):
            shutil.rmtree(d)
    else:
        d = os.path.join(root, str(name), time_s)
        if os.path.isdir(d):
            shutil.rmtree(d)
    _prune_dangling_symlinks(root)


def _prune_dangling_symlinks(root) -> None:
    """Drop latest/current links left dangling by delete()."""
    candidates = [os.path.join(root, "latest"), os.path.join(root, "current")]
    if os.path.isdir(root):
        candidates += [
            os.path.join(root, n, "latest")
            for n in os.listdir(root)
            if os.path.isdir(os.path.join(root, n))
        ]
    for link in candidates:
        if os.path.islink(link) and not os.path.isdir(os.path.realpath(link)):
            try:
                os.remove(link)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Logging (store.clj:394-418): a file handler on the framework's root
# logger for the duration of the run.

_LOG_FORMAT = "%(asctime)s\t%(levelname)s\t[%(threadName)s] %(name)s: %(message)s"


def start_logging(test) -> None:
    if not (test.get("name") and test.get("start_time")):
        return
    handler = logging.FileHandler(path_(test, "jepsen.log"))
    handler.setFormatter(logging.Formatter(_LOG_FORMAT))
    root = logging.getLogger("jepsen_tpu_torch")
    test["_log_prev_level"] = root.level
    if root.getEffectiveLevel() > logging.INFO:
        root.setLevel(logging.INFO)
    root.addHandler(handler)
    test["_log_handler"] = handler
    update_current_symlink(test)


def stop_logging(test) -> None:
    handler = test.pop("_log_handler", None)
    if handler is not None:
        root = logging.getLogger("jepsen_tpu_torch")
        root.removeHandler(handler)
        handler.close()
        prev = test.pop("_log_prev_level", None)
        if prev is not None:
            root.setLevel(prev)
