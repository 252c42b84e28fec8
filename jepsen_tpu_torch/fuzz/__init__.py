"""Fault-schedule fuzzing of a simulated list-append cluster (the port's
copy of `jepsen_tpu/fuzz`).

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

loop.py      the coverage-guided loop: each round one sim launch and
             one scoring batch, new coverage kept in a crash-consistent
             corpus (corpus.json, anomalies.jsonl) committed through
             the store; `FuzzLoop(dir, clusters=256, seed=0).run(4)`.
"""

from __future__ import annotations

from . import loop
from .loop import Corpus, FuzzLoop, run_fuzz
from .schedule import FAMILIES, SimSpec, random_schedule
from .score import decode, score_batch
from .sim import simulate_batch

__all__ = [
    "FAMILIES",
    "Corpus",
    "FuzzLoop",
    "SimSpec",
    "decode",
    "loop",
    "random_schedule",
    "run_fuzz",
    "score_batch",
    "simulate_batch",
]
