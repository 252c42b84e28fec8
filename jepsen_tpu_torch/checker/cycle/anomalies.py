"""Adya anomaly classification over a dependency graph (the port's copy
of `jepsen_tpu/checker/cycle/anomalies.py`).

Given the relation matrices from deps.extract, each anomaly is a cycle
shape, detected by masking WHICH relations may participate (Adya's
taxonomy, via Elle):

  G0        cycle of ww edges only (write cycle)
  G1c       cycle of ww|wr edges with at least one wr (circular
            information flow)
  G-single  cycle with exactly one rw edge (read skew / SI's
            characteristic anomaly)
  G2        cycle with two or more rw edges (anti-dependency cycle)

Detection reduces to transitive closure: an edge a -r-> b lies on a
qualifying cycle iff b reaches a through the allowed mask —

  G0 hits        ww  & closure(ww).T
  G1c hits       wr  & closure(ww|wr).T
  G-single hits  rw  & closure(ww|wr).T      (the return path has no
                                              rw, so the cycle has
                                              exactly one)
  G2 hits        rw  & closure(ww|wr|rw).T   minus G-single hits

With realtime in play (strict-serializability checking), the realtime
relation is simply OR-ed into every mask.

The graph is first split into weakly-connected components (cycles
cannot cross components), and every component x mask matrix goes to
the closure engine in ONE batch: `ops/closure.reach_batch` on the card
by default (engine None), the host DFS with engine "host", the rows
sharded over a device list with engine "mesh" (`closure.reach_batch_mesh`
over `devices`, every CUDA device by default). Engine None takes the mesh
itself (the JAX package's `closure_mesh` rung, `supervisor.py:428-448`)
when the device is the default one, two or more CUDA devices exist
(`device.mesh`) and the largest matrix has at least
`calibrate.mesh_min_n()` nodes. The engine is chosen before anything
launches; a kernel fault raises, with no demotion. Witness recovery
(a concrete shortest cycle per anomaly) is a host BFS on the flagged
component.

With an analysis journal (`classify(..., journal=)`, a
store.AnalysisJournal), each component x mask job is keyed by its
content; a journaled closure is reused and never sent to the engine,
and each closure the engine completes is journaled as a packed bitmap
(the JAX package's format, so either package's journal serves the
other).
"""

from __future__ import annotations

import hashlib
import logging
import time

import numpy as np

from ... import device as device_mod
from ...ops import closure, closure_host
from .. import calibrate
from .deps import DepGraph

ANOMALIES = ("G0", "G1c", "G-single", "G2")
ENGINES = (None, "host", "mesh")

#: when a dict, `classify` adds the host seconds of its steps to it
#: ("components", "closure", "hits_witnesses") and CycleChecker.check
#: those of "extract", so a caller can split a check's wall
PHASES: dict | None = None

# anomaly -> (relations allowed in the cycle, relation the hit edge
# must carry)
_MASKS = {
    "G0": (("ww",), "ww"),
    "G1c": (("ww", "wr"), "wr"),
    "G-single": (("ww", "wr"), "rw"),
    "G2": (("ww", "wr", "rw"), "rw"),
}


def components(full: np.ndarray) -> list:
    """Weakly-connected components of the union graph, as sorted index
    arrays in the order of their smallest node; singletons without a
    self-loop are dropped (no cycle can involve them)."""
    n = full.shape[0]
    und = full | full.T
    label = np.full(n, -1, dtype=np.int64)
    comps: list = []
    for s in range(n):
        if label[s] >= 0:
            continue
        c = len(comps)
        label[s] = c
        members = [np.array([s], dtype=np.int64)]
        stack = [s]
        while stack:
            nb = np.flatnonzero(und[stack.pop()])
            new = nb[label[nb] < 0]
            if new.size:
                label[new] = c
                members.append(new)
                stack.extend(new.tolist())
        comps.append(np.sort(np.concatenate(members)))
    return [c for c in comps
            if len(c) > 1 or full[c[0], c[0]]]


def _job_key(rels, sub: np.ndarray) -> str:
    """Content identity of one closure job (relation mask + the exact
    component submatrix), so journaled closures are only reused for
    bit-identical inputs."""
    h = hashlib.sha1()
    h.update(("|".join(rels) + f"#{sub.shape[0]}#").encode())
    h.update(np.packbits(sub).tobytes())
    return h.hexdigest()


def _pack_closure(m: np.ndarray) -> dict:
    return {"n": int(m.shape[0]),
            "bits": np.packbits(m).tobytes().hex()}


def _unpack_closure(d) -> np.ndarray:
    n = int(d["n"])
    bits = np.frombuffer(bytes.fromhex(d["bits"]), dtype=np.uint8)
    return np.unpackbits(bits, count=n * n).astype(bool).reshape(n, n)


def _closures(mats, engine=None, device=None, budget=None,
              on_closed=None, devices=None) -> list:
    """Closure of every matrix: on the card (`closure.reach_batch`,
    `device` None = CUDA) for engine None — over every card when the
    mesh route takes the batch (module docstring) —, by the host DFS for
    "host", and over `devices` (None: every CUDA device) for "mesh".
    `budget` is an absolute time.monotonic() deadline, checked before
    each pad bucket (before the whole batch on the host); past it this
    raises closure.DeadlineExpired. `on_closed(i, closure)` is called
    for each matrix as it completes."""
    if not mats:
        return []
    if engine == "host":
        if budget is not None and time.monotonic() >= budget:
            raise closure.DeadlineExpired(
                "deadline passed before the host closure")
        out = closure_host.reach_batch(mats)
        if on_closed is not None:
            for i, m in enumerate(out):
                on_closed(i, m)
        return out
    if engine == "mesh":
        return closure.reach_batch_mesh(mats, devices=devices, budget=budget,
                                        on_closed=on_closed)
    if engine is not None:
        raise ValueError(f"unknown closure engine {engine!r} "
                         f"(known: {ENGINES})")
    mesh = device_mod.mesh(device)
    if mesh is not None and max(a.shape[0] for a in mats) \
            >= calibrate.mesh_min_n():
        return closure.reach_batch(mats, devices=mesh, budget=budget,
                                   on_closed=on_closed)
    return closure.reach_batch(mats, device=device, budget=budget,
                               on_closed=on_closed)


def _lap(name: str, t0: float) -> float:
    """Add the seconds since t0 to PHASES[name] (when PHASES is a
    dict); returns now."""
    now = time.perf_counter()
    if PHASES is not None:
        PHASES[name] = PHASES.get(name, 0.0) + now - t0
    return now


def _witness(g: DepGraph, comp, allowed, a, b) -> dict:
    """A concrete cycle through edge a -> b: the edge plus the
    shortest b -> a path inside the allowed-mask subgraph of one
    component (host BFS). Returns op indices + relation labels."""
    sub = allowed[np.ix_(comp, comp)]
    la = int(np.searchsorted(comp, a))
    lb = int(np.searchsorted(comp, b))
    path = closure_host.shortest_cycle_path(sub, lb, la)
    if path is None:  # can't happen if the closure was sound; degrade
        path = [lb, la]
    nodes = [a] + [int(comp[i]) for i in path]
    steps = []
    for u, v in zip(nodes, nodes[1:]):
        rels = g.rels_of(u, v)
        steps.append({
            "from": int(g.ops[u].index),
            "to": int(g.ops[v].index),
            "rel": rels[0] if rels else "?",
        })
    return {
        "cycle": [int(g.ops[i].index) for i in nodes],
        "steps": steps,
        "ops": [g.ops[i] for i in nodes[:-1]],
    }


def classify(g: DepGraph, anomalies=ANOMALIES, *, realtime=False,
             engine=None, device=None, max_witnesses=4, journal=None,
             budget=None, devices=None) -> dict:
    """Find every requested anomaly in a dependency graph.

    Returns {"anomaly-types": [...], "anomalies": {type: [witness]},
    "cycle-count": int, "node-count": int, "component-count": int}.
    Witness lists are capped at max_witnesses per type; the hit COUNT
    (cycle-count) is exact. `journal` (a store.AnalysisJournal) makes
    the closure step resumable: journaled closures are reused and only
    the remaining jobs go to the engine, each journaled as it completes.
    `budget` (absolute time.monotonic() deadline) bounds the closure
    step: past it this raises closure.DeadlineExpired, the closures
    already completed journaled first."""
    for a in anomalies:
        if a not in _MASKS:
            raise ValueError(f"unknown anomaly {a!r} "
                             f"(known: {ANOMALIES})")
    anomalies = [a for a in ANOMALIES if a in anomalies]
    t0 = time.perf_counter()
    n = len(g)
    base = ("realtime",) if realtime and "realtime" in g.adj else ()
    # every distinct relation mask we need a closure of
    masks = {}
    for a in anomalies:
        rels = tuple(_MASKS[a][0]) + base
        masks.setdefault(rels, g.union(rels))
    full = g.union(("ww", "wr", "rw") + base)
    comps = components(full)
    t0 = _lap("components", t0)
    # one batch: |components| x |distinct masks| closures
    keys = list(masks)
    jobs = [(rels, c) for rels in keys for c in comps]
    mats = [masks[rels][np.ix_(c, c)] for rels, c in jobs]
    closed: list = [None] * len(jobs)
    jkeys: list = [None] * len(jobs)
    if journal is not None:
        for i, ((rels, _), m) in enumerate(zip(jobs, mats)):
            jkeys[i] = _job_key(rels, m)
            r = journal.get("closure", jkeys[i])
            if r is not None:
                try:
                    closed[i] = _unpack_closure(r)
                except (KeyError, TypeError, ValueError):
                    closed[i] = None
        skips = sum(1 for x in closed if x is not None)
        if skips:
            logging.getLogger("jepsen_tpu_torch.checker.cycle").info(
                "analysis journal: reusing %d of %d closures", skips,
                len(jobs))
    # largest first, as the JAX package submits (results realign by
    # index; the engine buckets by pad size either way)
    todo = sorted((i for i, x in enumerate(closed) if x is None),
                  key=lambda i: -mats[i].shape[0])

    got: dict = {}
    try:
        subs = _closures([mats[i] for i in todo], engine=engine,
                         device=device, budget=budget, devices=devices,
                         on_closed=got.__setitem__)
    finally:
        # in submission order, as the JAX package journals them, also
        # when the budget ran out after some buckets
        if journal is not None:
            for j in sorted(got):
                journal.record("closure", jkeys[todo[j]],
                               _pack_closure(got[j]))
    for i, sub in zip(todo, subs):
        closed[i] = sub
    # reassemble per-mask full-size closure (block-diagonal by
    # construction: no path leaves a weak component)
    closure_of = {rels: np.zeros((n, n), dtype=bool) for rels in keys}
    for (rels, c), sub in zip(jobs, closed):
        closure_of[rels][np.ix_(c, c)] = sub
    t0 = _lap("closure", t0)
    found: dict = {}
    types: list = []
    cycles = 0
    claimed = np.zeros((n, n), dtype=bool)  # G-single hits, for G2 dedup
    for a in anomalies:
        rels, hit_rel = _MASKS[a]
        allowed = masks[tuple(rels) + base]
        cl = closure_of[tuple(rels) + base]
        hits = g.adj[hit_rel] & cl.T
        if a == "G-single":
            claimed |= hits
        elif a == "G2":
            # when G-single also ran, its hits are the exactly-one-rw
            # cycles; without it, G2 keeps Adya's broad sense (>= 1 rw)
            hits = hits & ~claimed
        k = int(hits.sum())
        if not k:
            continue
        cycles += k
        types.append(a)
        ws = []
        ii, jj = np.nonzero(hits)
        for x, y in list(zip(ii, jj))[:max_witnesses]:
            x, y = int(x), int(y)
            comp = next(c for c in comps if x in c)
            # the return path b -> a stays inside the allowed mask (the
            # closure proved it exists there); the hit edge itself is
            # prepended from the real adjacency
            w = _witness(g, comp, allowed, x, y)
            w["type"] = a
            ws.append(w)
        found[a] = ws
    _lap("hits_witnesses", t0)
    return {
        "anomaly-types": types,
        "anomalies": found,
        "cycle-count": cycles,
        "node-count": n,
        "component-count": len(comps),
    }
