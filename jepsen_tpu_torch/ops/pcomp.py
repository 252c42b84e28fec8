"""P-compositional decomposition of histories over product models (the
port's copy of `jepsen_tpu/ops/pcomp.py`).

"Faster linearizability checking via P-compositionality" (Horn &
Kroening) observes that when an object is a PRODUCT of independent
components and every operation touches exactly one component,
Herlihy-Wing locality applies componentwise: a history is linearizable
iff each component's projection is. Which models decompose, and for
which histories, is the model's own knowledge (the `Model.components`
hook, models/__init__.py):

- UnorderedQueue decomposes BY VALUE (its multiset state is one counter
  per value), so one 10k-op queue history, intractable as a single
  interleaving search, becomes thousands of micro-lanes the batch
  engines clear in one pass.
- MultiRegister decomposes BY KEY when every txn carries exactly one
  micro-op, each projected lane rewritten to plain register ops (which
  have a kernel encoding).

`checker/linearizable.py` groups the flattened lanes per sub-model
(`group_lanes`) and routes each group like any batch.

Soundness, as in the reference:
- A crashed op that recorded no payload can never linearize and is
  optional, so it is absent from every linearization and drops.
- An OK entry with an op the model doesn't know makes its own lane
  invalid, which is the whole history's verdict.
- Real-time order is kept: a projection keeps the relative order of its
  call/ret positions, and precedence is a positional comparison. FIFO
  queues do NOT decompose (order couples values).
"""

from __future__ import annotations

import numpy as np

from ..history import Entries
from ..models import Model


def eligible(model) -> bool:
    """Does this model type declare a decomposition at all? (The
    per-history answer is split() returning non-None.)"""
    return type(model).components is not Model.components


def _subset(es: Entries, idx: list, rewrite=None) -> Entries:
    """Sub-Entries over `idx`, positions re-ranked order-preservingly;
    `rewrite` optionally maps each projected entry's (f, value) — the
    ORIGINAL invoke Ops are kept for counterexample reporting."""
    sel = np.asarray(idx, np.int64)
    pos = np.concatenate([es.call_pos[sel], es.ret_pos[sel]])
    order = np.argsort(pos, kind="stable")
    rank = np.empty(len(pos), np.int64)
    rank[order] = np.arange(len(pos))
    m = len(idx)
    f = [es.f[i] for i in idx]
    value_in = [es.value_in[i] for i in idx]
    value_out = [es.value_out[i] for i in idx]
    if rewrite is not None:
        f_in = [rewrite(fi, vi) for fi, vi in zip(f, value_in)]
        f_out = [rewrite(fi, vo) for fi, vo in zip(f, value_out)]
        f = [t[0] for t in f_out]
        value_in = [t[1] for t in f_in]
        value_out = [t[1] for t in f_out]
    return Entries(
        f=f,
        value_in=value_in,
        value_out=value_out,
        crashed=es.crashed[sel],
        call_pos=rank[:m],
        ret_pos=rank[m:],
        invokes=[es.invokes[i] for i in idx],
    )


def split(model, es: Entries) -> list | None:
    """[(sub_model, sub_Entries)] per component, or None when this
    history doesn't decompose (no hook, coupling ops, unhashable
    payloads: the hook decides; the caller runs the full search)."""
    comps = model.components(es)
    if comps is None:
        return None
    return [(m, _subset(es, idx, rewrite)) for m, idx, rewrite in comps]


def group_lanes(comp_lanes) -> dict:
    """{sub_model: [indices]} over a flat list of (sub_model, Entries)
    lanes. The batch engines take ONE model per call, so lanes are
    bucketed per distinct sub-model (queue components share one
    UnorderedQueue; a multi-register split yields one Register per
    distinct initial value). Insertion order is kept."""
    groups: dict = {}
    for i, (m, _es) in enumerate(comp_lanes):
        groups.setdefault(m, []).append(i)
    return groups
