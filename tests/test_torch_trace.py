"""The port's span tracing (trace.py) against the JAX package's, on the
cases of tests/test_trace.py: the five cases run on the port; and, with
both modules' clocks and span-id counters fixed, the same sequence of
`with_trace`/`annotate`/`attribute` calls writes the same span file in
both packages, byte for byte, and drains the same in-memory tail."""

from __future__ import annotations

import itertools
import json
import threading
import types

import pytest

from jepsen_tpu import trace as jtrace

from jepsen_tpu_torch import trace


@pytest.fixture(autouse=True)
def reset():
    for mod in (jtrace, trace):
        mod.tracing(None)
        mod.drain()
    yield
    for mod in (jtrace, trace):
        mod.tracing(None)
        mod.drain()


def test_disabled_is_noop():
    trace.tracing(None)
    with trace.with_trace("nothing") as span:
        assert span is None
        assert trace.context() == {"span_id": "0" * 16,
                                   "trace_id": "0" * 16}
    assert trace.drain() == []


def test_span_nesting_and_export(tmp_path):
    out = tmp_path / "spans.jsonl"
    cfg = trace.tracing(str(out))
    assert cfg["config"] is True and cfg["exporter"] == str(out)
    with trace.with_trace("outer") as outer:
        ctx = trace.context()
        assert ctx["span_id"] == outer.span_id
        with trace.with_trace("inner") as inner:
            assert inner.parent_id == outer.span_id
            assert inner.trace_id == outer.trace_id
            trace.annotate("hello")
            trace.attribute("node", "n1")
    spans = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [s["operationName"] for s in spans] == ["inner", "outer"]
    assert spans[0]["tags"] == {"node": "n1"}
    assert spans[0]["logs"][0]["fields"] == "hello"
    assert spans[0]["parentSpanID"] == spans[1]["spanID"]
    assert all(s["duration"] >= 0 for s in spans)


def test_attribute_requires_strings(tmp_path):
    trace.tracing(str(tmp_path / "s.jsonl"))
    with trace.with_trace("x"):
        with pytest.raises(TypeError):
            trace.attribute("k", 5)


def test_attribute_annotate_are_noops_without_a_span():
    trace.tracing(None)
    trace.attribute("k", 3)  # non-string value: still safe when no span
    trace.annotate("nothing")
    assert trace.drain() == []


def test_threads_do_not_share_span_stacks(tmp_path):
    trace.tracing(str(tmp_path / "s.jsonl"))
    seen = {}

    def worker(name):
        with trace.with_trace(name):
            seen[name] = trace.context()

    with trace.with_trace("main"):
        t = threading.Thread(target=worker, args=("side",))
        t.start()
        t.join()
        main_ctx = trace.context()
    # The side thread's span is a fresh root, not a child of "main".
    assert seen["side"]["trace_id"] != main_ctx["trace_id"]


def calls(mod, path: str) -> tuple:
    """One fixed sequence of tracing calls on `mod`: nested spans with
    annotations and attributes, a refused non-string attribute, a span
    closed by an exception, two traces, the context inside and outside a
    span, and spans while tracing is off. Returns the span file's bytes,
    the drained tail and the contexts seen."""
    ctxs = [mod.context()]
    cfg = mod.tracing(path)
    ctxs.append({"config": cfg["config"],
                 "to_path": cfg["endpoint"] == cfg["exporter"] == path})
    with mod.with_trace("dgraph.client/mutate"):
        mod.annotate("first")
        mod.attribute("node", "n1")
        with mod.with_trace("dgraph.client/commit"):
            ctxs.append(mod.context())
            mod.annotate({"nested": [1, 2]})
            mod.attribute("startTs", "17")
            with pytest.raises(TypeError):
                mod.attribute("bad", 3)
        with pytest.raises(ValueError):
            with mod.with_trace("bank.invoke"):
                mod.attribute("f", "transfer")
                raise ValueError("aborted")
    with mod.with_trace("nemesis.tablet-mover.invoke"):
        ctxs.append(mod.context())
    ctxs.append(mod.context())
    mod.tracing(None)
    with mod.with_trace("off") as span:
        assert span is None
    mod.annotate("ignored")
    with open(path, "rb") as f:
        body = f.read()
    return body, mod.drain(), ctxs


def fix_clock(monkeypatch, mod) -> None:
    """A deterministic clock (µs steps of 250) and a fresh span-id
    counter for `mod`."""
    tick = itertools.count(1_700_000_000_000_000, 250)
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        time=lambda: next(tick) / 1e6))
    monkeypatch.setattr(mod, "_ids", iter(range(1, 1 << 62)))


def test_span_file_equals_the_jax_package_byte_for_byte(tmp_path,
                                                        monkeypatch):
    got = {}
    for name, mod in (("jax", jtrace), ("port", trace)):
        fix_clock(monkeypatch, mod)
        got[name] = calls(mod, str(tmp_path / name / "spans.jsonl"))
    body, tail, ctxs = got["port"]
    assert body == got["jax"][0]
    assert tail == got["jax"][1] and ctxs == got["jax"][2]
    spans = [json.loads(ln) for ln in body.decode().splitlines()]
    assert [s["operationName"] for s in spans] == [
        "dgraph.client/commit", "bank.invoke", "dgraph.client/mutate",
        "nemesis.tablet-mover.invoke"]
    assert list(spans[0]) == ["traceID", "spanID", "parentSpanID",
                              "operationName", "startTime", "duration",
                              "logs", "tags", "process"]
    ids = {s["spanID"] for s in spans}
    assert all(s["parentSpanID"] is None or s["parentSpanID"] in ids
               for s in spans)
    assert spans[0]["tags"] == {"startTs": "17"}
    assert spans[1]["tags"] == {"f": "transfer"}
    assert spans[3]["traceID"] != spans[2]["traceID"]


def test_tail_keeps_the_last_4096_spans(monkeypatch):
    for mod in (jtrace, trace):
        fix_clock(monkeypatch, mod)
    for mod in (jtrace, trace):
        mod._endpoint = "memory"  # enabled, no file: the tail alone
    try:
        for i in range(4100):
            for mod in (jtrace, trace):
                with mod.with_trace(f"s{i}"):
                    pass
        want, got = jtrace.drain(), trace.drain()
    finally:
        for mod in (jtrace, trace):
            mod._endpoint = None
    assert got == want and len(got) == 4096
    assert got[0]["operationName"] == "s4"
