"""HTML timeline of a history's concurrency windows (the port's copy of
`jepsen_tpu/checker/timeline.py`; reference: jepsen.checker.timeline,
checker/timeline.clj).

Each process gets a column; each operation is a box spanning its
invoke..completion window, colored by outcome, with full op details in
the hover title (timeline.clj:97-121). Writes timeline.html into the
test's store dir.
"""

from __future__ import annotations

import html as html_mod
import logging
from typing import Mapping

from ..util import nanos_to_ms
from . import Checker

log = logging.getLogger("jepsen_tpu_torch.checker.timeline")

#: ns per pixel (timeline.clj:20)
TIMESCALE = 1e6
COL_WIDTH = 100
GUTTER = 106
HEIGHT = 16

STYLESHEET = """
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.12),
                          0 1px 2px rgba(0,0,0,0.24);
              overflow: hidden; font-size: 11px;
              font-family: sans-serif; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #6DB6FE; }
.op.info    { background: #FFAA26; }
.op.fail    { background: #FEB5DA; }
.op:target  { box-shadow: 0 14px 28px rgba(0,0,0,0.25),
                          0 10px 10px rgba(0,0,0,0.22); }
"""


def op_pairs(history):
    """[invoke, completion|None] windows plus unmatched [info] singletons,
    in history order (timeline.clj:33-53)."""
    pending: dict = {}
    out = []
    for o in history:
        if o.is_invoke:
            assert o.process not in pending, f"double invoke by {o.process}"
            rec = [o, None]
            pending[o.process] = rec
            out.append(rec)
        elif o.is_info and o.process not in pending:
            out.append([o, None])  # unmatched info (nemesis etc.)
        else:
            rec = pending.pop(o.process, None)
            if rec is not None:
                rec[1] = o
    return out


def _title(start, stop) -> str:
    lines = []
    if stop is not None:
        lines.append(f"Dur: {int(nanos_to_ms(stop.time - start.time))} ms")
        if stop.error is not None:
            lines.append(f"Err: {stop.error!r}")
    lines.append(f"Op: {start.to_dict()!r}")
    if stop is not None:
        lines.append(f"Completion: {stop.to_dict()!r}")
    return "\n".join(lines)


def _process_index(history) -> dict:
    idx: dict = {}
    for o in history:
        if o.process not in idx:
            idx[o.process] = len(idx)
    return idx


#: witness-arrow stroke per dependency relation (checker/cycle)
REL_COLORS = {"ww": "#C62828", "wr": "#1565C0", "rw": "#EF6C00",
              "realtime": "#555555"}


def _witness_svg(witness, pos, width, height) -> str:
    """An absolutely-positioned SVG overlay drawing each witness-cycle
    edge as an op -> op arrow labeled with its relation. `witness` is
    a list of cycle-checker witness dicts ({"steps": [{"from": index,
    "to": index, "rel": ...}]}); `pos` maps op index -> box center."""
    lines = []
    for w in witness or []:
        for s in w.get("steps", []):
            a, b = pos.get(s.get("from")), pos.get(s.get("to"))
            if a is None or b is None:
                continue
            rel = str(s.get("rel", "?"))
            color = REL_COLORS.get(rel, "#000000")
            (x1, y1), (x2, y2) = a, b
            mx, my = (x1 + x2) / 2, (y1 + y2) / 2
            lines.append(
                f'<line x1="{x1:.0f}" y1="{y1:.1f}" x2="{x2:.0f}" '
                f'y2="{y2:.1f}" stroke="{color}" stroke-width="2" '
                f'marker-end="url(#arrow)"/>'
                f'<text x="{mx:.0f}" y="{my:.1f}" fill="{color}" '
                f'font-size="11" font-family="sans-serif">'
                f"{html_mod.escape(rel)}</text>"
            )
    if not lines:
        return ""
    return (
        f'<svg class="witness" width="{width:.0f}" '
        f'height="{height:.0f}" style="position:absolute;left:0;top:0;'
        f'pointer-events:none">'
        '<defs><marker id="arrow" viewBox="0 0 10 10" refX="9" refY="5" '
        'markerWidth="7" markerHeight="7" orient="auto-start-reverse">'
        '<path d="M 0 0 L 10 5 L 0 10 z" fill="context-stroke"/>'
        "</marker></defs>" + "".join(lines) + "</svg>"
    )


def render(test, history, end_time_nanos=None, witness=None) -> str:
    """The full HTML document (timeline.clj:123-157). `witness` takes
    cycle-checker witnesses (result["anomalies"] values flattened) and
    overlays their dependency edges as labeled arrows."""
    procs = _process_index(history)
    times = [o.time for o in history if o.time is not None and o.time >= 0]
    t_end = end_time_nanos if end_time_nanos is not None else (
        max(times) if times else 0
    )
    divs = []
    pos: dict = {}
    max_bottom = 0.0
    for start, stop in op_pairs(history):
        if start.time is None or start.time < 0:
            continue
        cls = stop.type if stop is not None else (
            "info" if start.is_info else "invoke"
        )
        left = GUTTER * procs[start.process]
        top = start.time / TIMESCALE
        bottom = (stop.time if stop is not None else t_end) / TIMESCALE
        height = max(HEIGHT, bottom - top)
        # either end of the op window addresses this box (cycle
        # witnesses carry completion indices)
        center = (left + COL_WIDTH / 2, top + height / 2)
        pos[start.index] = center
        if stop is not None:
            pos.setdefault(stop.index, center)
        max_bottom = max(max_bottom, top + height)
        label = f"{start.process} {start.f} {start.value!r}"
        divs.append(
            f'<div id="op-{start.index}" class="op {cls}" '
            f'style="left:{left:.0f}px;top:{top:.1f}px;'
            f'width:{COL_WIDTH}px;height:{height:.1f}px" '
            f'title="{html_mod.escape(_title(start, stop), quote=True)}">'
            f"{html_mod.escape(label)}</div>"
        )
    svg = _witness_svg(witness, pos, GUTTER * max(len(procs), 1),
                       max_bottom + HEIGHT)
    name = html_mod.escape(str(test.get("name", "test")))
    return (
        "<!doctype html><html><head>"
        f"<title>{name} timeline</title>"
        f"<style>{STYLESHEET}</style></head><body>"
        f"<h1>{name}</h1>"
        f'<div class="ops">{"".join(divs)}{svg}</div>'
        "</body></html>"
    )


class HtmlTimeline(Checker):
    """Writes timeline.html (timeline.clj:159-179). opts["witness"]
    (cycle-checker witnesses) overlays dependency-cycle arrows."""

    def check(self, test: Mapping, history, opts=None) -> dict:
        doc = render(test, history, witness=(opts or {}).get("witness"))
        if test.get("name") and test.get("start_time"):
            from .. import store

            p = store.path_(
                test, list((opts or {}).get("subdirectory") or []),
                "timeline.html",
            )
            with open(p, "w") as f:
                f.write(doc)
        return {"valid": True}


def html() -> HtmlTimeline:
    return HtmlTimeline()
