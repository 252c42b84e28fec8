"""Fault-schedule fuzzing of a simulated list-append cluster (the port's
copy of `jepsen_tpu/fuzz`, without the corpus loop).

schedule.py  fixed-shape [F, 6] int32 fault schedules over six nemesis
             families, seeded generation and mutation (numpy and
             `random` only: the same schedules from the same seeds).
sim.py       the vectorized cluster simulator: one launch of csrc/sim.cu
             (K4's counterpart, one block a cluster) for a batch of
             seeded clusters, its plain PyTorch version, and the numpy
             engine.
score.py     trace -> verdict + coverage: decode each cluster into a
             list-append history, infer its dependency graph
             (checker/cycle/deps) and classify Adya anomalies with every
             trace's closures in one call of the closure engine.

The coverage-guided loop (`jepsen_tpu/fuzz/loop.py`) needs the store and
is not ported.
"""

from __future__ import annotations

from .schedule import FAMILIES, SimSpec, random_schedule
from .score import decode, score_batch
from .sim import simulate_batch

__all__ = [
    "FAMILIES",
    "SimSpec",
    "decode",
    "random_schedule",
    "score_batch",
    "simulate_batch",
]
