"""Trace scoring: sim output -> verdict + coverage (the port's copy of
`jepsen_tpu/fuzz/score.py`).

``decode`` turns one cluster's output arrays back into a standard
invoke/ok list-append history, so the port's own inference path
(checker/cycle/deps.extract) and anomaly masks (checker/cycle/anomalies)
judge every fuzzed trace.

``score_batch`` is the batched form of anomalies.classify: it gathers
every trace's component x relation-mask closure jobs into ONE call of
the closure engine (`anomalies._closures`: K3's counterpart on the card,
or the host DFS with engine "host"; largest matrices first), then
reassembles per-trace verdicts plus the coverage features the fuzz loop
buckets on:

* anomaly class set (G0 / G1c / G-single / G2),
* cycle-participating SCC count and max size (log2 buckets),
* weak component count (log2 bucket),
* edge-relation mix (ww:wr:rw quartile signature),
* fault families + overlap signature of the schedule that produced
  the trace.

A trace's coverage key is the join of those features.
"""

from __future__ import annotations

import numpy as np

from .. import history as hist_mod
from ..checker.cycle import anomalies as an_mod
from ..checker.cycle import deps as deps_mod
from ..ops import closure
from .schedule import DEFAULT_SPEC, SimSpec, families_of, overlap_signature
from .sim import KIND_APPEND, KIND_READ

#: distinct relation masks classification needs closures of, in the
#: order anomalies._MASKS implies (G0; G1c + G-single; G2).
_MASK_KEYS = (("ww",), ("ww", "wr"), ("ww", "wr", "rw"))


def decode(res: dict, spec: SimSpec = DEFAULT_SPEC) -> list:
    """One cluster's arrays -> an indexed invoke/ok history.

    Failed txns (killed coordinators) are dropped whole — Elle-style
    inference only consumes ok txns. Append values are the globally
    unique vids; a read's value is the prefix of the final per-key
    append order of length ``rlen`` (the sim guarantees prefix
    consistency, so inference cannot raise IllegalInference).
    """
    St, L = spec.slots, spec.mops
    kind = np.asarray(res["kind"])
    key = np.asarray(res["key"])
    pos = np.asarray(res["pos"])
    rlen = np.asarray(res["rlen"])
    coord = np.asarray(res["coord"])
    failed = np.asarray(res["failed"])
    # final per-key append order, from the ranked positions
    orders: dict = {}
    for s in range(St):
        if failed[s]:
            continue
        for j in range(L):
            if kind[s, j] == KIND_APPEND:
                orders.setdefault(int(key[s, j]), []).append(
                    (int(pos[s, j]), s * L + j + 1))
    orders = {k: [vid for _, vid in sorted(v)] for k, v in orders.items()}
    out = []
    for s in range(St):
        if failed[s]:
            continue
        txn = []
        for j in range(L):
            kd = int(kind[s, j])
            k = int(key[s, j])
            if kd == KIND_APPEND:
                txn.append(["append", k, s * L + j + 1])
            elif kd == KIND_READ:
                txn.append(["r", k, list(orders.get(k, [])[:int(rlen[s, j])])])
        if not txn:
            continue
        p = int(coord[s])
        out.append(hist_mod.invoke_op(p, "txn", txn))
        out.append(hist_mod.ok_op(p, "txn", txn))
    return hist_mod.index(out)


def _features(g, closure_full: np.ndarray, comps) -> dict:
    mutual = closure_full & closure_full.T
    on_cycle = np.flatnonzero(np.diag(closure_full))
    sccs = set()
    max_scc = 0
    for i in on_cycle:
        members = frozenset(np.flatnonzero(mutual[i] | (np.arange(
            len(g)) == i)).tolist())
        sccs.add(members)
        max_scc = max(max_scc, len(members))
    return {
        "node-count": len(g),
        "component-count": len(comps),
        "scc-count": len(sccs),
        "max-scc": max_scc,
        "edges": {r: int(g.adj[r].sum()) for r in ("ww", "wr", "rw")},
    }


def _bucket(n: int) -> int:
    return int(n).bit_length()


def _mix_sig(edges: dict) -> str:
    total = sum(edges.values())
    if not total:
        return "0:0:0"
    return ":".join(str(min(3, 4 * edges[r] // total))
                    for r in ("ww", "wr", "rw"))


def coverage_key(score: dict, sched=None) -> str:
    """The corpus bucket a scored trace lands in. Coarse by design:
    log2 buckets and quartile mixes keep the corpus small while still
    separating structurally different traces."""
    types = "+".join(score["anomaly-types"]) or "none"
    parts = [
        f"t={types}",
        f"c={_bucket(score['component-count'])}",
        f"s={_bucket(score['max-scc'])}",
        f"m={_mix_sig(score['edges'])}",
    ]
    if sched is not None:
        parts.append(f"f={'+'.join(families_of(sched)) or 'none'}")
        parts.append(f"o={overlap_signature(sched)}")
    return "|".join(parts)


def score_batch(results: list, spec: SimSpec = DEFAULT_SPEC,
                scheds=None, engine: str | None = None, device=None,
                budget: float | None = None, devices=None) -> list:
    """Score a batch of sim results; one dict per trace:

    {"anomaly-types", "cycle-count", "node-count", "component-count",
     "scc-count", "max-scc", "edges", "coverage", "valid"}.

    All traces' closure jobs go to the closure engine as ONE batch:
    engine None is the card (`device` None = CUDA, "cpu" the plain
    versions; over every card when the mesh route takes the batch),
    "host" the host DFS, "mesh" the rows sharded over `devices` (None:
    every CUDA device). A trace whose inference fails
    (cannot happen for sim traces, but the scorer also takes foreign
    fixtures) scores as coverage bucket "unknown" rather than poisoning
    the batch.

    ``budget`` (absolute time.monotonic deadline) bounds the closure
    call: when it passes before the call or between two of its pad
    buckets, every trace scores "unknown" with error "deadline" (an
    incomplete closure can only miss anomalies, so no partial closure
    scores).
    """
    graphs: list = [None] * len(results)
    errors: list = [None] * len(results)
    for i, res in enumerate(results):
        try:
            graphs[i] = deps_mod.extract(decode(res, spec))
        except deps_mod.IllegalInference as e:
            errors[i] = str(e)
    jobs: list = []   # (trace index, rels)
    mats: list = []
    per: list = [None] * len(results)
    for gi, g in enumerate(graphs):
        if g is None:
            continue
        masks = {rels: g.union(rels) for rels in _MASK_KEYS}
        comps = an_mod.components(masks[_MASK_KEYS[-1]])
        per[gi] = (masks, comps)
        for rels in _MASK_KEYS:
            for c in comps:
                jobs.append((gi, rels))
                mats.append(masks[rels][np.ix_(c, c)])
    order = sorted(range(len(mats)), key=lambda i: -mats[i].shape[0])
    closed: list = [None] * len(mats)
    try:
        subs = an_mod._closures([mats[i] for i in order], engine=engine,
                                device=device, budget=budget,
                                devices=devices)
    except closure.DeadlineExpired:
        subs = [None] * len(order)
    for i, sub in zip(order, subs):
        closed[i] = sub
    # reassemble per-trace block-diagonal closures; a trace with ANY
    # deadline-expired (None) block degrades to unknown — an
    # incomplete closure can only miss anomalies, never find false
    # ones, so partial blocks must not score
    closures: list = [None] * len(results)
    ji = 0
    for gi, g in enumerate(graphs):
        if g is None:
            continue
        masks, comps = per[gi]
        n = len(g)
        cl = {rels: np.zeros((n, n), dtype=bool) for rels in _MASK_KEYS}
        for rels in _MASK_KEYS:
            for c in comps:
                if closed[ji] is None:
                    cl = None
                elif cl is not None:
                    cl[rels][np.ix_(c, c)] = closed[ji]
                ji += 1
        closures[gi] = cl
        if cl is None:
            errors[gi] = "deadline"
            graphs[gi] = None
    out = []
    for gi, g in enumerate(graphs):
        if g is None:
            score = {"anomaly-types": ["unknown"], "cycle-count": 0,
                     "node-count": 0, "component-count": 0,
                     "scc-count": 0, "max-scc": 0,
                     "edges": {"ww": 0, "wr": 0, "rw": 0},
                     "error": errors[gi], "valid": "unknown",
                     "coverage": "unknown"}
            out.append(score)
            continue
        masks, comps = per[gi]
        cl = closures[gi]
        types = []
        cycles = 0
        claimed = np.zeros((len(g), len(g)), dtype=bool)
        for a in an_mod.ANOMALIES:
            rels, hit_rel = an_mod._MASKS[a]
            hits = g.adj[hit_rel] & cl[tuple(rels)].T
            if a == "G-single":
                claimed |= hits
            elif a == "G2":
                hits = hits & ~claimed
            k = int(hits.sum())
            if k:
                cycles += k
                types.append(a)
        score = {"anomaly-types": types, "cycle-count": cycles,
                 "valid": not types,
                 **_features(g, cl[_MASK_KEYS[-1]], comps)}
        sched = scheds[gi] if scheds is not None else None
        score["coverage"] = coverage_key(score, sched)
        out.append(score)
    return out


def check_trace(res: dict, spec: SimSpec = DEFAULT_SPEC,
                engine: str | None = None, device=None,
                devices=None) -> dict:
    """Full standard-checker verdict for ONE trace (with witnesses) —
    decode + deps.extract + anomalies.classify, exactly the cycle
    checker's path."""
    try:
        g = deps_mod.extract(decode(res, spec))
    except deps_mod.IllegalInference as e:
        return {"valid": "unknown", "error": str(e), "anomaly-types": []}
    r = an_mod.classify(g, engine=engine, device=device, devices=devices)
    r["valid"] = not r["anomaly-types"]
    return r
