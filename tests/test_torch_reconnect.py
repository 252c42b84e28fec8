"""The port's reconnecting connection wrapper (`jepsen_tpu_torch.reconnect`)
against the JAX package's: each case of tests/test_control_util.py's
reconnect classes runs on both modules and gives the same observations
(connections opened and closed, errors raised, backoff sleeps drawn from
the seeded jitter). Every thread a case starts is joined with a
timeout."""

from __future__ import annotations

import threading

import pytest

from jepsen_tpu import reconnect as jrc
from jepsen_tpu_torch import reconnect as trc

MODS = {"jax": jrc, "port": trc}


def both(fn) -> dict:
    out = {name: fn(rc) for name, rc in MODS.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


def wrapper(rc, fail_open=False, **kw):
    """A wrapper over fresh objects, recording opens and closes by
    ordinal (0, 1, ...) so the two modules' records compare."""
    opened, closed = [], []

    def op():
        if fail_open:
            raise RuntimeError("open failed")
        c = len(opened)
        opened.append(c)
        return ("conn", c)

    return rc.wrapper(op, lambda c: closed.append(c[1]), name="w",
                      **kw), opened, closed


def run_threads(targets, timeout=5.0) -> bool:
    ts = [threading.Thread(target=t) for t in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    return not any(t.is_alive() for t in ts)


def test_open_is_idempotent():
    def run(rc):
        w, opened, _ = wrapper(rc)
        w.open()
        c = w.conn()
        w.open()
        return w.conn() is c, opened

    assert both(run) == (True, [0])


def test_close_and_reopen():
    def run(rc):
        w, opened, closed = wrapper(rc)
        w.open()
        w.reopen()
        after = w.conn()
        w.close()
        return after, list(closed), w.conn()

    assert both(run) == (("conn", 1), [0, 1], None)


def test_open_returning_none_raises():
    def run(rc):
        w = rc.wrapper(lambda: None, lambda c: None)
        with pytest.raises(RuntimeError, match="returned None") as ei:
            w.open()
        return str(ei.value)

    both(run)


def test_with_conn_reopens_on_error_and_keeps_on_success():
    def run(rc):
        w, opened, closed = wrapper(rc)
        w.open()
        with w.with_conn() as c:
            first = c
        kept = list(closed)
        with pytest.raises(ValueError, match="boom"):
            with w.with_conn():
                raise ValueError("boom")
        return first, kept, list(closed), w.conn()

    assert both(run) == (("conn", 0), [], [0], ("conn", 1))


def test_failed_reopen_does_not_mask_original():
    def run(rc):
        calls = {"n": 0}

        def op():
            calls["n"] += 1
            if calls["n"] > 1:
                raise RuntimeError("reopen failed")
            return object()

        w = rc.wrapper(op, lambda c: None, log_reconnects=False)
        w.open()
        with pytest.raises(ValueError, match="original"):
            with w.with_conn():
                raise ValueError("original")
        return calls["n"], w.conn()

    assert both(run) == (2, None)


def test_concurrent_readers():
    def run(rc):
        w, _, _ = wrapper(rc)
        w.open()
        inside = threading.Barrier(4, timeout=5)

        def reader():
            with w.with_conn():
                inside.wait()  # all 4 readers hold the lock at once

        return run_threads([reader] * 4)

    assert both(run) is True


def test_nested_with_conn():
    def run(rc):
        w, opened, closed = wrapper(rc)
        w.open()
        done = []

        def nester():
            with w.with_conn() as c1:
                with w.with_conn() as c2:
                    done.append(c1 is c2)

        def failing_nester():
            try:
                with w.with_conn():
                    with w.with_conn():
                        raise ValueError("inner")
            except ValueError:
                done.append("raised")

        ok = run_threads([nester]) and run_threads([failing_nester])
        return ok, done, list(closed), list(opened)

    assert both(run) == (True, [True, "raised"], [0], [0, 1])


def test_rwlock_write_reentrant_and_downgrade():
    def run(rc):
        lk = rc.RWLock()
        with lk.write():
            with lk.write():
                with lk.read():
                    pass
        ok = []

        def writer():
            with lk.write():
                ok.append(1)

        return run_threads([writer]), ok

    assert both(run) == (True, [1])


def test_only_failed_conn_reopened_once():
    def run(rc):
        w, opened, closed = wrapper(rc)
        w.open()
        start = threading.Barrier(2, timeout=5)
        errs = []

        def failer():
            try:
                with w.with_conn():
                    start.wait()
                    raise ValueError("x")
            except ValueError:
                errs.append(1)

        return run_threads([failer] * 2), len(errs), len(closed), len(opened)

    assert both(run) == (True, 2, 1, 2)


def flaky(rc, failures, sleeps, monkeypatch, **kw):
    """A wrapper whose open raises `failures` times, then succeeds; the
    backoff sleeps recorded instead of slept."""
    calls = {"n": 0}

    def op():
        calls["n"] += 1
        if calls["n"] <= failures:
            raise RuntimeError(f"open attempt {calls['n']} failed")
        return object()

    monkeypatch.setattr(rc.time, "sleep", sleeps.append)
    return rc.wrapper(op, lambda c: None, name="w", log_reconnects=False,
                      seed=7, **kw), calls


@pytest.mark.parametrize("failures,kw", [
    (2, {"max_retries": 3, "backoff_base": 0.05, "backoff_cap": 5.0}),
    (4, {"max_retries": 5, "backoff_base": 1.0, "backoff_cap": 1.5}),
    (99, {"max_retries": 3}), (1, {})])
def test_backoff_schedules_equal(monkeypatch, failures, kw):
    def run(rc):
        sleeps = []
        w, calls = flaky(rc, failures, sleeps, monkeypatch, **kw)
        try:
            w.open()
            err = None
        except RuntimeError as e:
            err = str(e)
        return sleeps, calls["n"], err, w.conn() is None

    sleeps, n, err, none = both(run)
    retries = kw.get("max_retries", 1)
    assert n == min(failures + 1, retries)
    assert len(sleeps) == n - 1
    cap = kw.get("backoff_cap", 5.0)
    assert all(s <= cap * 1.5 for s in sleeps)
    assert (err is None) is (failures < retries) and none is (err is not None)


def test_reopen_retries_too(monkeypatch):
    def run(rc):
        sleeps, calls = [], {"n": 0}

        def op():
            calls["n"] += 1
            if calls["n"] == 2:  # the first reopen attempt fails
                raise RuntimeError("transient")
            return object()

        monkeypatch.setattr(rc.time, "sleep", sleeps.append)
        w = rc.wrapper(op, lambda c: None, log_reconnects=False,
                       max_retries=2, seed=0)
        w.open()
        w.reopen()
        return calls["n"], sleeps, w.conn() is not None

    n, sleeps, ok = both(run)
    assert n == 3 and len(sleeps) == 1 and ok
