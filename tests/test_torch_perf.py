"""The port's latency and rate graphs (checker/perf.py), clock-skew plot
(checker/clock.py) and recovery audit (checker/recovery.py) against the
JAX package's: tests/test_perf.py's buckets, quantiles and nemesis spans
exactly; the graphs and the clock plot by the files they write and their
result dicts; the recovery audit's dicts on tests/test_nemesis_combined
.py's histories; and the latency and interval helpers of util.py."""

import importlib
import os

import numpy as np
import pytest

from jepsen_tpu import history as jhist
from jepsen_tpu import util as jutil
from jepsen_tpu.checker import clock as jclock
from jepsen_tpu.checker import perf as jperf

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import util as tutil
from jepsen_tpu_torch.checker import clock as tclock
from jepsen_tpu_torch.checker import perf as tperf

# `checker.recovery` is the factory of that name in both packages
jrec = importlib.import_module("jepsen_tpu.checker.recovery")
trec = importlib.import_module("jepsen_tpu_torch.checker.recovery")

S = 1_000_000_000


def small_history(mod):
    """tests/test_perf.py's hand-written history with nemesis windows."""
    s = lambda sec: int(sec * S)  # noqa: E731
    Op = mod.Op
    return mod.index([
        Op("nemesis", "info", "start", None, time=s(2)),
        Op("nemesis", "info", "start", None, time=s(2.1)),
        Op(0, "invoke", "read", None, time=s(1)),
        Op(0, "ok", "read", 3, time=s(1.5)),
        Op(1, "invoke", "write", 4, time=s(3)),
        Op(1, "info", "write", 4, time=s(3.2), error="timeout"),
        Op(2, "invoke", "cas", (1, 2), time=s(4)),
        Op(2, "fail", "cas", (1, 2), time=s(4.1)),
        Op("nemesis", "info", "stop", None, time=s(5)),
        Op("nemesis", "info", "stop", None, time=s(5.1)),
        Op(3, "invoke", "read", None, time=s(6)),
        Op(3, "ok", "read", 4, time=s(7)),
    ])


def clock_history(mod):
    """tests/test_perf.py's clock-offset history."""
    s = lambda sec: int(sec * S)  # noqa: E731
    Op = mod.Op
    return mod.index([
        Op("nemesis", "info", "start", None, time=s(1),
           extra={"clock_offsets": {"n1.example.com": 0.0,
                                    "n2.example.com": 0.0}}),
        Op("nemesis", "info", "bump", {"n1.example.com": 2.2}, time=s(2),
           extra={"clock_offsets": {"n1.example.com": 2.2,
                                    "n2.example.com": 0.0}}),
        Op("nemesis", "info", "stop", None, time=s(3),
           extra={"clock_offsets": {"n1.example.com": 0.1,
                                    "n2.example.com": 0.0}}),
        Op(0, "invoke", "read", None, time=s(4)),
        Op(0, "ok", "read", 1, time=s(5)),
    ])


def store_test(root, name="perf-test"):
    return {"name": name, "start_time": "20260729T000000.000",
            "store_dir": str(root)}


def run_dir(root, name="perf-test"):
    return os.path.join(str(root), name, "20260729T000000.000")


def written(root) -> list:
    """Files under a store dir, relative, sorted."""
    out = []
    for d, _, files in os.walk(str(root)):
        out += [os.path.relpath(os.path.join(d, f), str(root))
                for f in files]
    return sorted(out)


@pytest.mark.parametrize("dt,t", [(10, 3), (10, 11), (30, 0), (30, 59.9),
                                  (10, np.array([1.0, 15.0, 29.9]))])
def test_bucket_time(dt, t):
    got, want = tperf.bucket_time(dt, t), jperf.bucket_time(dt, t)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dt,tmax", [(10, 30), (10, 29), (30, 0), (1, 7.5)])
def test_buckets(dt, tmax):
    assert np.array_equal(tperf.buckets(dt, tmax), jperf.buckets(dt, tmax))


@pytest.mark.parametrize("qs,times,values", [
    ([0.5, 1.0], [1, 2, 3, 4], [10, 20, 30, 40]),
    ((0.5, 0.95, 0.99, 1.0), [1, 12, 13, 25, 26, 27], [5, 1, 9, 4, 4, 2]),
    ((0.5,), [], []),
])
def test_quantile_points(qs, times, values):
    got = tperf.quantile_points(10, qs, times, values)
    want = jperf.quantile_points(10, qs, times, values)
    assert got == want


def test_nemesis_spans_and_events():
    assert (tperf.nemesis_spans(small_history(thist))
            == jperf.nemesis_spans(small_history(jhist))
            == [(2.0, 5.0), (2.1, 5.1)])
    assert (tperf.nemesis_event_times(clock_history(thist))
            == jperf.nemesis_event_times(clock_history(jhist)))


def test_latency_data_and_helpers():
    th, jh = small_history(thist), small_history(jhist)
    assert tperf._latency_data(th) == jperf._latency_data(jh)
    got = [(r["op"].to_dict(), r["latency"],
            r["completion"] and r["completion"].to_dict())
           for r in tutil.history_latencies(th)]
    want = [(r["op"].to_dict(), r["latency"],
             r["completion"] and r["completion"].to_dict())
            for r in jutil.history_latencies(jh)]
    assert got == want
    assert ([(a.to_dict(), b and b.to_dict())
             for a, b in tutil.nemesis_intervals(th)]
            == [(a.to_dict(), b and b.to_dict())
                for a, b in jutil.nemesis_intervals(jh)])
    for xs in ([], [3], [1, 2, 3, 5, 7, 8, 9], [9, 1, 2, 2]):
        assert (tutil.integer_interval_set_str(xs)
                == jutil.integer_interval_set_str(xs))
    assert tutil.nanos_to_secs(1.5 * S) == jutil.nanos_to_secs(1.5 * S)


@pytest.mark.parametrize("graph,file", [
    ("point_graph", "latency-raw.png"),
    ("quantiles_graph", "latency-quantiles.png"),
    ("rate_graph", "rate.png")])
def test_graph_files(tmp_path, graph, file):
    """Each graph writes its file where the JAX package's does, under
    opts["subdirectory"] too; an empty history or a test without a store
    writes nothing."""
    for sub in ([], ["independent", "3"]):
        opts = {"subdirectory": sub}
        jp = getattr(jperf, graph)(store_test(tmp_path / "jax"),
                                   small_history(jhist), opts)
        tp = getattr(tperf, graph)(store_test(tmp_path / "port"),
                                   small_history(thist), opts)
        assert os.path.relpath(tp, str(tmp_path / "port")) == \
            os.path.relpath(jp, str(tmp_path / "jax"))
        assert os.path.getsize(tp) > 1000
    assert getattr(tperf, graph)(store_test(tmp_path), [], {}) is None
    assert getattr(tperf, graph)({}, small_history(thist), {}) is None


def test_perf_checker_composite(tmp_path):
    jr = jperf.perf().check(store_test(tmp_path / "jax"),
                            small_history(jhist), {})
    tr = tperf.perf().check(store_test(tmp_path / "port"),
                            small_history(thist), {})
    assert tr == jr == {"latency_graph": {"valid": True},
                        "rate_graph": {"valid": True}, "valid": True}
    assert written(tmp_path / "port") == written(tmp_path / "jax")
    assert {os.path.basename(f) for f in written(tmp_path / "port")} == {
        "latency-raw.png", "latency-quantiles.png", "rate.png"}


def test_graphs_without_matplotlib_read_unknown(monkeypatch, tmp_path):
    """Where matplotlib cannot be imported, a graph checker raises
    ImportError and compose's check_safe reads it as unknown, as in the
    JAX package."""
    def no_pyplot():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(tperf, "load_pyplot", no_pyplot)
    r = tperf.perf().check(store_test(tmp_path), small_history(thist), {})
    assert r["valid"] == "unknown"
    assert "matplotlib" in r["latency_graph"]["error"]


def test_clock_datasets_and_names():
    assert (tclock.history_datasets(clock_history(thist))
            == jclock.history_datasets(clock_history(jhist)))
    for nodes in (["n1.example.com", "n2.example.com"], ["a", "b"], [],
                  ["x.a.b", "y.c.b"]):
        assert (tclock.short_node_names(nodes)
                == jclock.short_node_names(nodes))


def test_clock_plot(tmp_path):
    jr = jclock.clock_plot().check(store_test(tmp_path / "jax"),
                                   clock_history(jhist), {})
    tr = tclock.clock_plot().check(store_test(tmp_path / "port"),
                                   clock_history(thist), {})
    assert tr == jr == {"valid": True}
    assert written(tmp_path / "port") == written(tmp_path / "jax")
    assert os.path.getsize(os.path.join(run_dir(tmp_path / "port"),
                                        "clock-skew.png")) > 1000
    assert tclock.plot(store_test(tmp_path), small_history(thist), {}) \
        is None


FAMS = {"kill": {"faults": {"kill"}, "heals": {"restart"}}}


def _nem(mod, f, error=None):
    return mod.Op("nemesis", "info", f, None, error=error)


def _ok(mod):
    return mod.Op(0, "ok", "read", 1)


RECOVERY = {
    "healed": (FAMS, ["kill", "restart", "ok", "ok"]),
    "never_fired": (FAMS, ["ok"]),
    "missing_heal": (FAMS, ["kill", "ok"]),
    "fault_after_heal": (FAMS, ["kill", "restart", "kill", "ok"]),
    "errored_heal": (FAMS, ["kill", ("restart", "ssh broke"), "ok"]),
    "no_post_heal_traffic": (FAMS, ["ok", "kill", "restart"]),
    "unrevokable": ({"corruption": {"faults": {"corrupt-file"},
                                    "heals": set()}}, ["corrupt-file"]),
    "from_test_map": (None, ["kill", "ok"]),
}


@pytest.mark.parametrize("case", sorted(RECOVERY))
def test_recovery(case):
    fams, steps = RECOVERY[case]

    def hist(mod):
        out = []
        for s in steps:
            if s == "ok":
                out.append(_ok(mod))
            elif isinstance(s, tuple):
                out.append(_nem(mod, s[0], error=s[1]))
            else:
                out.append(_nem(mod, s))
        return out

    test = {"fault_families": FAMS} if fams is None else {}
    jr = jrec.RecoveryChecker(fams).check(dict(test), hist(jhist))
    tr = trec.RecoveryChecker(fams).check(dict(test), hist(thist))
    assert tr == jr
    assert trec.recovery(fams, min_ok=2).check(dict(test), hist(thist)) \
        == jrec.recovery(fams, min_ok=2).check(dict(test), hist(jhist))
