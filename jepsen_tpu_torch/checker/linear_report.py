"""Counterexample rendering (the port's copy of
`jepsen_tpu/checker/linear_report.py`): when a linearizability check
fails, draw the concurrency window around the failing operation as
linear.svg (reference: knossos.linear.report/render-analysis!, invoked at
checker.clj:130-137 — "Writing linearizability analysis").

The picture: one lane per process, each op a bar spanning its
invoke→complete interval, labeled "f value". The op at whose return the
search died is red; ops in the deepest legal linearization found are
numbered with their order, so the reader can see exactly how far a
legal history got and which completion it could not absorb. Pure-string
SVG, no plotting dependencies."""

from __future__ import annotations

import html
from ..history import Op, pairs as history_pairs

MAX_OPS = 40          # window cap, like the reference's truncation
LANE_H = 34
BAR_H = 22
LEFT_PAD = 90
RIGHT_PAD = 24
TOP_PAD = 46
PX_PER_COL = 46

OK_FILL = "#81bfd1"
CRASH_FILL = "#c6a6d1"
FAIL_FILL = "#e06c5f"
LIN_STROKE = "#2a7a34"


def _pairs(history: list) -> list:
    """(invoke, completion|None) pairs, in invoke order."""
    return [(p.invoke, p.completion) for p in history_pairs(history)]


def _window(history: list, failing: Op | None) -> list:
    """The (invoke, completion) pairs concurrent with the failure,
    capped at MAX_OPS. Without a known failing op, the tail of the
    history."""
    pairs = _pairs(history)
    if failing is None:
        return pairs[-MAX_OPS:]
    # locate the failing op's pair: exact index match wins outright —
    # a loose (process, f) match could center the window on a later
    # unrelated op and leave the real failure outside the picture
    fail_pos = None
    for i, (inv, comp) in enumerate(pairs):
        if failing.index is not None and (
            inv.index == failing.index
            or (comp is not None and comp.index == failing.index)
        ):
            fail_pos = i
            break
    if fail_pos is None:  # no index info: last (process, f, value) match
        for i, (inv, comp) in enumerate(pairs):
            if (inv.process == failing.process and inv.f == failing.f
                    and inv.value == failing.value):
                fail_pos = i
    if fail_pos is None:
        return pairs[-MAX_OPS:]
    lo = max(0, fail_pos - MAX_OPS // 2)
    return pairs[lo:lo + MAX_OPS]


def _is_failing(inv: Op, comp: Op | None, failing: Op | None) -> bool:
    if failing is None:
        return False
    for o in (inv, comp):
        if o is not None and o.index is not None \
                and o.index == failing.index:
            return True
    return False


def _lin_order(window: list, best: list | None) -> dict:
    """Map window position -> 1-based order in the deepest legal
    linearization."""
    if not best:
        return {}
    order = {}
    used = set()
    for rank, lin_op in enumerate(best, start=1):
        for i, (inv, comp) in enumerate(window):
            if i in used:
                continue
            if inv.process == lin_op.process and inv.f == lin_op.f \
                    and inv.value == lin_op.value:
                order[i] = rank
                used.add(i)
                break
    return order


def _label(inv: Op, comp: Op | None) -> str:
    value = inv.value
    if comp is not None and comp.value is not None:
        value = comp.value
    s = f"{inv.f} {value}" if value is not None else str(inv.f)
    return s if len(s) <= 18 else s[:17] + "…"


def render_analysis(history: list, result: dict, path: str) -> str | None:
    """Write linear.svg for an invalid linearizability result
    ({"op": ..., "final_paths": [[...]]}) to `path`. Returns the path,
    or None when there is nothing to draw."""
    history = [o for o in history if o.process != "nemesis"]
    if not history:
        return None
    failing = None
    if result.get("op"):
        failing = Op.from_dict(result["op"])
    best = None
    if result.get("final_paths"):
        best = [Op.from_dict(d) for d in result["final_paths"][0]]

    window = _window(history, failing)
    if not window:
        return None
    lin = _lin_order(window, best)

    processes = sorted({inv.process for inv, _ in window},
                       key=lambda p: (isinstance(p, str), p))
    lane = {p: i for i, p in enumerate(processes)}

    width = LEFT_PAD + PX_PER_COL * len(window) + RIGHT_PAD
    height = TOP_PAD + LANE_H * len(processes) + 30

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="Helvetica, Arial, sans-serif" '
        'font-size="11">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        '<text x="8" y="18" font-size="13" font-weight="bold">'
        "Linearizability failure window</text>",
        '<text x="8" y="34" fill="#666">red = op the search could not '
        "linearize; green numbers = deepest legal order found</text>",
    ]
    for p in processes:
        y = TOP_PAD + lane[p] * LANE_H + BAR_H // 2 + 4
        parts.append(
            f'<text x="8" y="{y}" fill="#333">process '
            f"{html.escape(str(p))}</text>"
        )

    for i, (inv, comp) in enumerate(window):
        x = LEFT_PAD + i * PX_PER_COL
        y = TOP_PAD + lane[inv.process] * LANE_H
        # bar spans from its column to its completion's column
        end = i
        if comp is not None:
            # find how many window invocations started before completion
            for j, (inv2, _) in enumerate(window):
                if inv2.time is not None and comp.time is not None \
                        and inv2.time <= comp.time:
                    end = j
        w = max(PX_PER_COL - 6, (end - i) * PX_PER_COL + PX_PER_COL - 6)
        if _is_failing(inv, comp, failing):
            fill = FAIL_FILL
        elif comp is None or comp.type == "info":
            fill = CRASH_FILL
        else:
            fill = OK_FILL
        stroke = (f' stroke="{LIN_STROKE}" stroke-width="2"'
                  if i in lin else "")
        parts.append(
            f'<rect x="{x}" y="{y}" width="{w}" height="{BAR_H}" '
            f'rx="4" fill="{fill}"{stroke}/>'
        )
        parts.append(
            f'<text x="{x + 4}" y="{y + 15}" fill="#111">'
            f"{html.escape(_label(inv, comp))}</text>"
        )
        if i in lin:
            parts.append(
                f'<text x="{x + 2}" y="{y - 3}" fill="{LIN_STROKE}" '
                f'font-weight="bold">{lin[i]}</text>'
            )
    parts.append("</svg>")

    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path
