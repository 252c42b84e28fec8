"""Distributed-tracing spans for test clients and nemeses.

The reference's dgraph suite wraps client and nemesis work in
OpenCensus spans exported to a Jaeger collector
(dgraph/src/jepsen/dgraph/trace.clj:1-73: `tracing`
configures a sampler + exporter, `with-trace` opens a scoped span,
`context` exposes span/trace ids, `annotate!`/`attribute!` decorate the
current span). This module is the framework-native equivalent: spans
are plain dicts collected per-thread into a process-global buffer and
exported as JSONL (one span per line, Jaeger-thrift-shaped fields) to
whatever path `tracing` was given — no collector daemon needed, and the
file drops straight into the run's store directory so the web browser
serves it next to jepsen.log.

When tracing is disabled (endpoint None — trace.clj's neverSample
path), `with_trace` still runs its body but records nothing; the
overhead is one thread-local check.

The port's copy of `jepsen_tpu/trace.py`: it imports nothing of
`jepsen_tpu`, and writes the same span file (the same fields in the same
key order) for the same calls.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field

_state = threading.local()
_lock = threading.Lock()
_endpoint: str | None = None
_sink = None  # persistent append handle for the JSONL endpoint
# Bounded: the file is the durable record; the in-memory tail exists for
# drain() (tests, post-run analysis) and must not grow with run length.
_buffer: collections.deque = collections.deque(maxlen=4096)
_ids = iter(range(1, 1 << 62))


def sampler(enable) -> bool:
    """Sampling is on iff a tracing endpoint was provided
    (trace.clj:9-14: alwaysSample / neverSample)."""
    return bool(enable)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    start_us: int
    end_us: int | None = None
    annotations: list = field(default_factory=list)
    attributes: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "traceID": self.trace_id,
            "spanID": self.span_id,
            "parentSpanID": self.parent_id,
            "operationName": self.name,
            "startTime": self.start_us,
            "duration": (self.end_us or self.start_us) - self.start_us,
            "logs": self.annotations,
            "tags": self.attributes,
            "process": {"serviceName": "jepsen"},
        }


def _spans() -> list:
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = []
    return st


def _next_id() -> str:
    with _lock:
        return "%016x" % next(_ids)


def tracing(endpoint) -> dict:
    """Configure tracing: `endpoint` is a JSONL file path (or None to
    disable). Returns the config map like trace.clj:36-41."""
    global _endpoint, _sink
    with _lock:
        if _sink is not None:
            _sink.close()
            _sink = None
        _endpoint = endpoint if endpoint else None
    return {
        "endpoint": _endpoint,
        "config": sampler(_endpoint),
        "exporter": exporter(_endpoint),
    }


def exporter(endpoint) -> str | None:
    """Registers the exporter: ensures the directory exists and opens
    one persistent append handle, so span export is a single buffered
    write — not an open/close per span (trace.clj:26-33 registers the
    Jaeger exporter once, for the same reason)."""
    global _sink
    if not endpoint:
        return None
    d = os.path.dirname(os.path.abspath(endpoint))
    os.makedirs(d, exist_ok=True)
    with _lock:
        if _sink is None or _sink.name != endpoint:
            try:
                _sink = open(endpoint, "a")
            except OSError:
                _sink = None
    return endpoint


def enabled() -> bool:
    return _endpoint is not None


@contextlib.contextmanager
def with_trace(name: str):
    """Run the body inside a named span (trace.clj:43-53). Nested calls
    parent correctly; the span is exported when it closes."""
    if not enabled():
        yield None
        return
    stack = _spans()
    parent = stack[-1] if stack else None
    span = Span(
        name=name,
        trace_id=parent.trace_id if parent else _next_id(),
        span_id=_next_id(),
        parent_id=parent.span_id if parent else None,
        start_us=int(time.time() * 1e6),
    )
    stack.append(span)
    try:
        yield span
    finally:
        span.end_us = int(time.time() * 1e6)
        stack.pop()
        _export(span)


def context() -> dict:
    """Span/trace ids of the current span (trace.clj:55-62); zeros when
    not inside a span, matching OpenCensus's blank context."""
    stack = _spans()
    if not stack:
        return {"span_id": "0" * 16, "trace_id": "0" * 16}
    return {"span_id": stack[-1].span_id, "trace_id": stack[-1].trace_id}


def annotate(message: str) -> None:
    """Add a timestamped log to the current span (trace.clj:60-64)."""
    stack = _spans()
    if stack:
        stack[-1].annotations.append(
            {"timestamp": int(time.time() * 1e6), "fields": str(message)}
        )


def attribute(k, v) -> None:
    """Set a string key/value tag on the current span. Both must be
    strings — trace.clj:66-73's AttributeValue has the same rule, and
    enforcing it here keeps traces portable to real Jaeger. With no
    span open (tracing disabled, or outside with_trace) this is a
    no-op, so instrumented client code is safe on untraced runs."""
    stack = _spans()
    if not stack:
        return
    if not isinstance(k, str) or not isinstance(v, str):
        raise TypeError("trace attributes must be strings")
    stack[-1].attributes[k] = v


def _export(span: Span) -> None:
    d = span.to_dict()
    line = json.dumps(d) + "\n"
    with _lock:
        _buffer.append(d)
        if _sink is not None:
            try:
                _sink.write(line)
                _sink.flush()
            except (OSError, ValueError):
                pass


def drain() -> list:
    """Return and clear the in-memory span tail (tests, analysis)."""
    with _lock:
        out = list(_buffer)
        _buffer.clear()
    return out
