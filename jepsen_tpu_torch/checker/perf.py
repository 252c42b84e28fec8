"""Performance plots from histories (the port's copy of
`jepsen_tpu/checker/perf.py`; reference: jepsen.checker.perf,
checker/perf.clj). Rendered with matplotlib (Agg) instead of shelling out
to gnuplot — no external binary, and the data prep is vectorized numpy
over the flat history columns rather than per-op seq transforms.
matplotlib is imported only when a graph is drawn (`load_pyplot`): on a
host without it a graph checker raises ImportError, which check_safe
reads as "unknown", as the JAX package's does.

Artifacts written into the test's store dir (or opts["subdirectory"]):

    latency-raw.png        every op as a point, by f and outcome
                           (perf.clj:251-303)
    latency-quantiles.png  0.5/0.95/0.99/1.0 latency quantiles per
                           30s bucket, by f (perf.clj:305-347)
    rate.png               completion throughput per f/outcome in 10s
                           buckets (perf.clj:356-400)

All three shade nemesis activity windows and mark other nemesis events
with vertical lines (perf.clj:171-232).
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np

from ..util import history_latencies, nanos_to_secs, nemesis_intervals
from . import Checker

log = logging.getLogger("jepsen_tpu_torch.checker.perf")

#: outcome colors (perf.clj:164-168)
TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}
TYPES = ("ok", "info", "fail")

QUANTILES = (0.5, 0.95, 0.99, 1.0)
QUANTILE_COLORS = {0.5: "#81BFFC", 0.95: "#f9b447", 0.99: "#FF1E90",
                   1.0: "#888888"}


def load_pyplot():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def bucket_scale(dt: float, b: np.ndarray | float):
    """Midpoint time of bucket number b (perf.clj:17-21)."""
    return np.floor(b).astype(np.int64) * dt + dt / 2 if isinstance(
        b, np.ndarray
    ) else int(b) * dt + dt / 2


def bucket_time(dt: float, t):
    """Midpoint time of the bucket t falls into (perf.clj:23-27)."""
    return bucket_scale(dt, np.asarray(t) / dt)


def buckets(dt: float, tmax: float) -> np.ndarray:
    """Midpoints of all buckets up to tmax (perf.clj:29-36)."""
    return np.arange(0, tmax // dt + 1) * dt + dt / 2


def quantile_points(dt: float, qs, times, values):
    """{q: (bucket_times, quantile_values)} per time bucket — vectorized
    latencies->quantiles (perf.clj:58-82)."""
    times = np.asarray(times, float)
    values = np.asarray(values, float)
    if len(times) == 0:
        return {}
    mids = bucket_time(dt, times)
    out = {q: ([], []) for q in qs}
    for mid in np.unique(mids):
        vs = values[mids == mid]
        for q in qs:
            # the reference's index quantile: floor(n*q), clamped
            idx = min(len(vs) - 1, int(np.floor(len(vs) * q)))
            out[q][0].append(mid)
            out[q][1].append(np.sort(vs)[idx])
    return out


def _latency_data(history):
    """[(f, outcome, time_s, latency_ms)] for every completed invocation;
    crashed/pending pairs surface as 'info' with no latency point."""
    rows = []
    for rec in history_latencies(history):
        op = rec["op"]
        if not isinstance(op.process, int):
            continue
        comp = rec["completion"]
        outcome = comp.type if comp is not None else "info"
        if rec["latency"] is None:
            continue
        rows.append(
            (str(op.f), outcome, nanos_to_secs(op.time),
             rec["latency"] / 1e6)
        )
    return rows


def nemesis_spans(history):
    """[(start_s, stop_s)] nemesis activity windows; open windows run to
    the end of the history (perf.clj:170-190)."""
    final = 0.0
    for o in reversed(list(history)):
        if o.time is not None and o.time >= 0:
            final = nanos_to_secs(o.time)
            break
    return [
        (nanos_to_secs(start.time),
         nanos_to_secs(stop.time) if stop is not None else final)
        for start, stop in nemesis_intervals(history)
    ]


def nemesis_event_times(history):
    """Times of non-start/stop nemesis ops (perf.clj:206-215)."""
    return [
        nanos_to_secs(o.time)
        for o in history
        if o.process == "nemesis" and o.f not in ("start", "stop")
        and o.time is not None and o.time >= 0
    ]


def _decorate(ax, history, test, title, ylabel):
    for start, stop in nemesis_spans(history):
        ax.axvspan(start, stop, color="black", alpha=0.05, linewidth=0)
    for t in nemesis_event_times(history):
        ax.axvline(t, color="#dddddd", linewidth=1)
    ax.set_title(f"{test.get('name', 'test')} {title}")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel(ylabel)


def out_path(test, opts, filename: str) -> str | None:
    """The path of `filename` in the test's store dir, under
    opts["subdirectory"], its directory created; None when the test has
    no store dir (no name or start_time)."""
    if not (test.get("name") and test.get("start_time")):
        return None
    from .. import store

    return store.path_(test, list((opts or {}).get("subdirectory") or []),
                       filename)


def point_graph(test, history, opts) -> str | None:
    """latency-raw.png (perf.clj:251-303)."""
    rows = _latency_data(history)
    path = out_path(test, opts, "latency-raw.png")
    if not rows or path is None:
        return None
    plt = load_pyplot()
    fig, ax = plt.subplots(figsize=(9, 4), dpi=100)
    fs = sorted({r[0] for r in rows})
    markers = {f: m for f, m in zip(fs, "ox+s^v*D")}
    for f in fs:
        for t in TYPES:
            pts = [(r[2], r[3]) for r in rows if r[0] == f and r[1] == t]
            if not pts:
                continue
            xs, ys = zip(*pts)
            ax.plot(xs, ys, linestyle="", marker=markers[f], markersize=3,
                    color=TYPE_COLORS[t], label=f"{f} {t}")
    ax.set_yscale("log")
    _decorate(ax, history, test, "latency", "Latency (ms)")
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def quantiles_graph(test, history, opts, dt=30, qs=QUANTILES) -> str | None:
    """latency-quantiles.png (perf.clj:305-347)."""
    rows = _latency_data(history)
    path = out_path(test, opts, "latency-quantiles.png")
    if not rows or path is None:
        return None
    plt = load_pyplot()
    fig, ax = plt.subplots(figsize=(9, 4), dpi=100)
    fs = sorted({r[0] for r in rows})
    markers = {f: m for f, m in zip(fs, "ox+s^v*D")}
    for f in fs:
        sub = [(r[2], r[3]) for r in rows if r[0] == f]
        times, lats = zip(*sub)
        for q, (bx, by) in quantile_points(dt, qs, times, lats).items():
            ax.plot(bx, by, marker=markers[f], markersize=3,
                    color=QUANTILE_COLORS.get(q, "#333333"),
                    label=f"{f} {q}")
    ax.set_yscale("log")
    _decorate(ax, history, test, "latency quantiles", "Latency (ms)")
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def rate_graph(test, history, opts, dt=10) -> str | None:
    """rate.png: completion rates by f/outcome (perf.clj:356-400)."""
    rows = [
        (str(o.f), o.type, nanos_to_secs(o.time))
        for o in history
        if not o.is_invoke and isinstance(o.process, int)
        and o.time is not None and o.time >= 0
    ]
    path = out_path(test, opts, "rate.png")
    if not rows or path is None:
        return None
    t_max = max(r[2] for r in rows)
    centers = buckets(dt, t_max)
    plt = load_pyplot()
    fig, ax = plt.subplots(figsize=(9, 4), dpi=100)
    fs = sorted({r[0] for r in rows})
    markers = {f: m for f, m in zip(fs, "ox+s^v*D")}
    for f in fs:
        for t in TYPES:
            times = np.array([r[2] for r in rows if r[0] == f and r[1] == t])
            if len(times) == 0:
                continue
            mids = bucket_time(dt, times)
            ys = [(mids == c).sum() / dt for c in centers]
            ax.plot(centers, ys, marker=markers[f], markersize=3,
                    color=TYPE_COLORS[t], label=f"{f} {t}")
    _decorate(ax, history, test, "rate", "Throughput (hz)")
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# Checkers (checker.clj:703-724)

class LatencyGraph(Checker):
    """Renders latency-raw + latency-quantiles (checker.clj:703-710)."""

    def check(self, test: Mapping, history, opts=None) -> dict:
        point_graph(test, history, opts)
        quantiles_graph(test, history, opts)
        return {"valid": True}


class RateGraph(Checker):
    """Renders rate.png (checker.clj:712-717)."""

    def check(self, test: Mapping, history, opts=None) -> dict:
        rate_graph(test, history, opts)
        return {"valid": True}


def latency_graph() -> LatencyGraph:
    return LatencyGraph()


def rate_graph_checker() -> RateGraph:
    return RateGraph()


def perf() -> Checker:
    """Composite latency + rate checker (checker.clj:719-724)."""
    from . import compose

    return compose({"latency_graph": latency_graph(),
                    "rate_graph": rate_graph_checker()})
