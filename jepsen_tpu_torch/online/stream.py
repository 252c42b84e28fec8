"""The streaming verdict session: source → frontier → durable verdict log
(the port's copy of `jepsen_tpu/online/stream.py`).

A ``StreamSession`` pulls ops from any iterator (a tailed WAL, a foreign
trace, an in-memory history), feeds a frontier (CycleFrontier or
WGLFrontier), and advances it at deterministic prefix boundaries — every
``window`` ops and once at stream end — so the set of checked prefixes
is a pure function of the stream, never of timing. Each advance emits a
verdict record ``{"prefix", "digest", "verdict"}``.

Crash safety is the WAL discipline turned on the checker itself: every
emission is appended (flushed and fsync'd) to a ``VerdictLog`` BEFORE the
emit callback fires, keyed by (prefix length, content digest of the
prefix). A SIGKILL'd session that resumes over the same stream derives
the same boundaries, finds the already-logged prefixes, and skips both
the re-check and the re-emission. The log's lines and digests are the
JAX package's, so a verdicts.jsonl either package wrote replays in the
other.

Bounded lag: between advances the frontier only buffers, so verdict lag
is bounded by the window size (plus one advance's compute). Early abort:
a definite ``valid: False`` sets ``.aborted`` and (with
``abort_on_invalid``) stops consuming — invalidity of a prefix is
monotone for both anomaly flavors checked here, so aborting early never
contradicts the full-history verdict.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

from .. import store

log = logging.getLogger("jepsen_tpu_torch.online.stream")

__all__ = ["VerdictLog", "StreamSession", "frontier_for"]

VERDICT_LOG_FILE = "verdicts.jsonl"
MEMO_JOURNAL_FILE = "analysis.ckpt.jsonl"


def _op_digest_update(h, o) -> None:
    """Fold one op's verdict-relevant identity into a running digest —
    the field set independent._journal_key hashes."""
    h.update(repr((o.process, o.type, o.f, o.value,
                   o.index, o.error)).encode())


class VerdictLog:
    """Append-only JSONL ledger of emitted streaming verdicts.

    Each line is ``{"prefix": n, "digest": d, "verdict": ...}``; loading
    tolerates a torn tail (the store's JSONL discipline), and ``record``
    fsyncs before returning so an acknowledged emission survives any
    kill. Duplicate records are dropped on both write and load — the
    (prefix, digest) pair is the emission's identity."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._seen: dict = {}
        try:
            with open(path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        rec = json.loads(line)
                        self._seen[(int(rec["prefix"]), rec["digest"])] = \
                            rec.get("verdict")
                    except (ValueError, KeyError, TypeError):
                        log.warning("verdict log: dropping torn line %r",
                                    line[:80])
        except FileNotFoundError:
            pass
        self._f = open(path, "a")
        store._terminate_torn_tail(self._f, path)

    def __len__(self) -> int:
        return len(self._seen)

    def get(self, prefix: int, digest: str):
        return self._seen.get((prefix, digest))

    def record(self, prefix: int, digest: str, verdict) -> bool:
        """Append one emission; returns False (and writes nothing) for a
        duplicate."""
        if (prefix, digest) in self._seen:
            return False
        self._seen[(prefix, digest)] = verdict
        self._f.write(json.dumps(
            {"prefix": prefix, "digest": digest,
             "verdict": store._json_keys(verdict)},
            default=store._json_default))
        self._f.write("\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        return True

    def entries(self) -> list:
        """[(prefix, digest, verdict)] sorted by prefix."""
        return sorted((p, d, v) for (p, d), v in self._seen.items())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class StreamSession:
    """Drive one frontier over one op stream.

    source            an iterator of Ops (store.follow_wal,
                      ingest.iter_trace, or any history)
    frontier          CycleFrontier / WGLFrontier (anything with
                      append/advance/.verdict)
    window            advance every `window` ops (and at stream end)
    verdict_log       optional VerdictLog for crash-safe emission
    emit              optional callback(record) per NEW emission
    abort_on_invalid  stop consuming at the first definite False
    max_ops           stop after this many ops (a deterministic end for
                      a tailed stream)
    """

    def __init__(self, source, frontier, *, window: int = 256,
                 verdict_log: VerdictLog | None = None, emit=None,
                 abort_on_invalid: bool = False, max_ops=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.source = source
        self.frontier = frontier
        self.window = window
        self.verdict_log = verdict_log
        self.emit = emit
        self.abort_on_invalid = abort_on_invalid
        self.max_ops = max_ops
        self.aborted = False
        self.abort_info: dict | None = None
        self.consumed = 0
        self.last_verdict: dict | None = None
        self._digest = hashlib.sha1()

    def run(self):
        """Consume the stream; returns the final verdict (the one for the
        longest checked prefix)."""
        n = 0
        for op in self.source:
            self.frontier.append(op)
            _op_digest_update(self._digest, self.frontier.ops[-1])
            n += 1
            if n % self.window == 0:
                self._checkpoint(n)
                if self.aborted and self.abort_on_invalid:
                    break
            if self.max_ops is not None and n >= self.max_ops:
                break
        self.consumed = n
        if n and n % self.window and not (self.aborted
                                          and self.abort_on_invalid):
            self._checkpoint(n)
        return self.last_verdict

    def _checkpoint(self, n: int) -> None:
        digest = self._digest.hexdigest()[:16]
        verdict = None
        if self.verdict_log is not None:
            verdict = self.verdict_log.get(n, digest)
        replayed = verdict is not None
        if not replayed:
            verdict = self.frontier.advance()
        self.last_verdict = verdict
        rec = {"prefix": n, "digest": digest, "verdict": verdict}
        if not replayed:
            if self.verdict_log is not None:
                self.verdict_log.record(n, digest, verdict)
            if self.emit is not None:
                self.emit(rec)
        if isinstance(verdict, dict) and verdict.get("valid") is False:
            self.aborted = True
            if self.abort_info is None:
                self.abort_info = {
                    "prefix": n,
                    "anomaly-types":
                        verdict.get("anomaly-types")
                        or sorted(map(str, verdict.get("failures") or [])),
                }


def frontier_for(checker, *, test=None, journal=None,
                 window_budget_s=None):
    """The streaming frontier matching a batch checker, or None when the
    checker has no streaming form: a CycleChecker streams through the
    incremental cycle frontier, an IndependentChecker through the
    windowed per-key frontier (whatever its sub-checker —
    P-compositionality is the licence). ``window_budget_s`` bounds each
    WGL advance's wall clock (the cycle frontier ignores it)."""
    from ..checker.cycle import CycleChecker
    from ..independent import IndependentChecker
    from .frontier import CycleFrontier
    from .wgl import WGLFrontier

    if isinstance(checker, CycleChecker):
        return CycleFrontier(checker, journal=journal)
    if isinstance(checker, IndependentChecker):
        return WGLFrontier(checker, test=test, journal=journal,
                           window_budget_s=window_budget_s)
    return None
