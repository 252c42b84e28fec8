"""Transitive closure of boolean dependency graphs on the host (the
port's copy of `jepsen_tpu/ops/closure_host.py`).

The cycle checker (checker/cycle) reduces Elle-style anomaly detection
to reachability over ww/wr/rw adjacency matrices: a transaction sits on
a dependency cycle iff it can reach itself through at least one edge.
This module is the cycle checker's `engine="host"` path (an iterative
DFS per source node over adjacency lists, O(n·(n+e))) and the witness
search the classifier runs on a flagged component, whichever engine
closed it.

All closures here are *irreflexive-path* closures: ``reach[i, j]`` is
True iff there is a path of length >= 1 from i to j, so ``reach[i, i]``
marks a genuine cycle through i, never the trivial empty path.
"""

from __future__ import annotations

import numpy as np


def reach(adj: np.ndarray) -> np.ndarray:
    """Reachability-by-at-least-one-edge matrix of a dense boolean
    adjacency matrix: out[i, j] iff a path i -> ... -> j with >= 1 edge
    exists. Iterative DFS from every source over adjacency lists."""
    a = np.asarray(adj, dtype=bool)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"adjacency must be square, got {a.shape}")
    out = np.zeros((n, n), dtype=bool)
    if n == 0:
        return out
    succs = [np.flatnonzero(a[i]).tolist() for i in range(n)]
    for src in range(n):
        seen = out[src]
        # seed with src's direct successors, then walk (explicit stack:
        # no recursion limit)
        stack = [v for v in succs[src] if not seen[v]]
        for v in stack:
            seen[v] = True
        while stack:
            u = stack.pop()
            for v in succs[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
    return out


def reach_batch(adjs) -> list:
    """Closure of each adjacency matrix in `adjs`, aligned with the
    input."""
    return [reach(a) for a in adjs]


def cyclic_nodes(reach_m: np.ndarray) -> np.ndarray:
    """Indices of nodes lying on at least one cycle (diagonal of the
    path closure)."""
    return np.flatnonzero(np.diagonal(reach_m))


def same_scc(reach_m: np.ndarray) -> np.ndarray:
    """Pairwise strongly-connected-component membership: i and j share
    an SCC iff each reaches the other (a node shares with itself only
    when it is on a cycle, consistent with the irreflexive closure)."""
    return reach_m & reach_m.T


def shortest_cycle_path(adj: np.ndarray, start: int, goal: int) -> list | None:
    """Shortest path start -> goal over `adj` (BFS), as a node list
    [start, ..., goal]; None when unreachable. With start == goal this
    finds the shortest nontrivial cycle through the node.

    The JAX package walks each frontier node's successors in Python;
    this walks a whole level at once and picks the same parents: a node
    first seen in a level takes as parent the earliest frontier node
    with an edge to it, and the next frontier is ordered by (parent's
    position, node), the order the one-by-one walk appends in."""
    a = np.asarray(adj, dtype=bool)
    n = a.shape[0]
    prev = np.full(n, -1, dtype=np.int64)
    frontier = np.flatnonzero(a[start])
    prev[frontier] = start
    visited = np.zeros(n, dtype=bool)
    visited[frontier] = True
    while frontier.size and not visited[goal]:
        rows = a[frontier] & ~visited
        cols = np.flatnonzero(rows.any(0))
        first = rows[:, cols].argmax(0)
        order = np.lexsort((cols, first))
        cols, first = cols[order], first[order]
        visited[cols] = True
        prev[cols] = frontier[first]
        frontier = cols
    if not visited[goal]:
        return None
    path = [goal]
    while path[-1] != start or len(path) == 1:
        p = int(prev[path[-1]])
        path.append(p)
        if p == start:
            break
    return path[::-1]
