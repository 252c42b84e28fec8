"""Clock-skew-over-time analysis (the port's copy of
`jepsen_tpu/checker/clock.py`; reference: jepsen.checker.clock,
checker/clock.clj).

The clock nemesis journals {"clock_offsets": {node: seconds}} onto its
ops (nemesis/time.clj:132); this extracts per-node offset series and
plots them as steps, with nemesis windows shaded. Writes clock-skew.png.
"""

from __future__ import annotations

import logging
from typing import Mapping

from ..util import nanos_to_secs
from . import Checker
from .perf import _decorate, load_pyplot, out_path

log = logging.getLogger("jepsen_tpu_torch.checker.clock")


def history_datasets(history) -> dict:
    """{node: ([times_s...], [offsets_s...])} from ops carrying
    clock_offsets (clock.clj:13-34). Each series is extended to the final
    history time so steps render to the end."""
    series: dict = {}
    final = 0.0
    for o in history:
        if o.time is not None and o.time >= 0:
            final = max(final, nanos_to_secs(o.time))
        offsets = o.extra.get("clock_offsets") if o.extra else None
        if offsets is None and isinstance(o.value, dict):
            offsets = o.value.get("clock_offsets")
        if not offsets:
            continue
        t = nanos_to_secs(o.time)
        for node, offset in offsets.items():
            xs, ys = series.setdefault(str(node), ([], []))
            xs.append(t)
            ys.append(float(offset))
    for xs, ys in series.values():
        if xs and xs[-1] < final:
            xs.append(final)
            ys.append(ys[-1])
    return series


def short_node_names(nodes) -> list[str]:
    """Strip common trailing domain components (clock.clj:36-45)."""
    split = [str(n).split(".") for n in nodes]
    if not split:
        return []
    while (
        len(split[0]) > 1
        and all(len(s) > 1 for s in split)
        and len({s[-1] for s in split}) == 1
    ):
        split = [s[:-1] for s in split]
    return [".".join(s) for s in split]


def plot(test, history, opts) -> str | None:
    """clock-skew.png (clock.clj:47-73)."""
    datasets = history_datasets(history)
    path = out_path(test, opts, "clock-skew.png")
    if not datasets or path is None:
        return None
    plt = load_pyplot()
    fig, ax = plt.subplots(figsize=(9, 4), dpi=100)
    nodes = sorted(datasets)
    for node, label in zip(nodes, short_node_names(nodes)):
        xs, ys = datasets[node]
        ax.step(xs, ys, where="post", label=label)
    _decorate(ax, history, test, "clock skew", "Skew (s)")
    ax.legend(loc="upper right", fontsize=7)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


class ClockPlot(Checker):
    """Renders the clock-skew plot (checker.clj:726-733)."""

    def check(self, test: Mapping, history, opts=None) -> dict:
        plot(test, history, opts)
        return {"valid": True}


def clock_plot() -> ClockPlot:
    return ClockPlot()
