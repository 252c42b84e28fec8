"""The coverage-guided fuzz loop and its crash-consistent corpus (the
port's copy of `jepsen_tpu/fuzz/loop.py`).

Each round builds a population of cluster configs — half fresh seeded
schedules, half mutants of corpus schedules (fuzz.schedule.mutate,
with donor splicing) — simulates them in one batch (fuzz.sim: one
launch of K4's counterpart on the card, or its plain version), scores
them in one closure batch (fuzz.score: K3's counterpart, or the host
DFS), and retains every config whose coverage key
(fuzz.score.coverage_key) is new. Discovered-anomaly entries are also
written to an anomalies.jsonl in the format of the JAX package's
replay-parity corpus.

Crash consistency: corpus state is ONE json document committed per
round via store.atomic_write_json (write-temp -> fsync -> rename,
``.prev`` rotation), and anomalies.jsonl is re-derived from that state
on the same commit. A round is a pure function of (fuzz seed, round
number, corpus state at round start) — NO wall clock or unseeded
randomness — so a kill anywhere simply replays the interrupted round
byte-identically on restart: entry ids are content fingerprints,
coverage keys collide exactly, and the corpus converges to the same
state as an uninterrupted run. The same seed gives the same corpus
bytes as the JAX package's loop, on the card or with engine="host".

The engines are arguments: `engine` (simulation) and `score_engine`
(closures) are None for the card or "host", and `device` is where
engine None runs (None = CUDA, raising without it; "cpu" the plain
versions). The JAX package's JEPSEN_TPU_SIM_ENGINE variable has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random

import numpy as np

from .. import store
from .schedule import (DEFAULT_SPEC, FAMILIES, SimSpec, derive_seed,
                       fingerprint, mutate, random_schedule,
                       schedule_from_lists, schedule_to_lists)
from .score import score_batch
from .sim import simulate_batch

STATE_FILE = "corpus.json"
ANOMALIES_FILE = "anomalies.jsonl"


def _spec_doc(spec: SimSpec) -> dict:
    return dataclasses.asdict(spec)


def spec_from_doc(doc: dict) -> SimSpec:
    return SimSpec(**{k: int(v) for k, v in doc.items()}).validate()


class Corpus:
    """The on-disk fuzz corpus: one state document, committed
    atomically once per round, plus the derived anomalies.jsonl."""

    def __init__(self, dir_path: str, spec: SimSpec = DEFAULT_SPEC,
                 seed: int = 0):
        self.dir = dir_path
        self.path = os.path.join(dir_path, STATE_FILE)
        self.anomalies_path = os.path.join(dir_path, ANOMALIES_FILE)
        self.state = self._load() or {
            "version": 1,
            "seed": int(seed),
            "spec": _spec_doc(spec),
            "round": 0,
            "clusters-run": 0,
            "coverage": {},      # coverage key -> entry id
            "entries": {},       # entry id -> entry (insertion order!)
            "anomalies": [],     # entry ids, discovery order
            "first-anomaly": None,
        }
        self.spec = spec_from_doc(self.state["spec"])

    def _load(self):
        """corpus.json, falling back to the rotated .prev — the same
        torn-tail tolerance RunCheckpoint has."""
        for p in (self.path, self.path + ".prev"):
            try:
                with open(p) as fh:
                    doc = json.load(fh)
                if doc.get("version") == 1:
                    return doc
            except (OSError, ValueError):
                continue
        return None

    def commit(self) -> None:
        """One atomic commit: derived anomalies.jsonl first, then the
        authoritative state document. A SIGKILL between the two leaves
        a jsonl from the NEW state with the OLD corpus.json — the next
        commit rewrites the jsonl from authoritative state, so it can
        never diverge for longer than the interrupted round's replay."""
        self._write_anomalies()
        store.atomic_write_json(self.path, self.state, rotate_prev=True)

    def _write_anomalies(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.anomalies_path + ".tmp"
        with open(tmp, "w") as fh:
            for eid in self.state["anomalies"]:
                e = self.state["entries"][eid]
                fh.write(json.dumps(
                    {"id": eid, "wseed": e["wseed"],
                     "schedule": e["schedule"],
                     "spec": self.state["spec"],
                     "types": e["types"],
                     "cycle-count": e["cycle-count"],
                     "coverage": e["coverage"],
                     "round": e["round"]},
                    sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.anomalies_path)

    # -- views ------------------------------------------------------------

    def entries(self) -> list:
        return list(self.state["entries"].values())

    def anomaly_entries(self) -> list:
        return [self.state["entries"][i] for i in self.state["anomalies"]]

    def anomaly_types(self) -> list:
        ts = {t for e in self.anomaly_entries() for t in e["types"]}
        return sorted(ts)

    def summary(self) -> dict:
        return {
            "seed": self.state["seed"],
            "round": self.state["round"],
            "clusters-run": self.state["clusters-run"],
            "coverage-buckets": len(self.state["coverage"]),
            "entries": len(self.state["entries"]),
            "anomalies": len(self.state["anomalies"]),
            "anomaly-types": self.anomaly_types(),
            "first-anomaly": self.state["first-anomaly"],
        }


class FuzzLoop:
    """Deterministic coverage-guided fuzzing over cluster schedules.

    ``round_hook(round_no)`` is a test seam invoked after a round's
    results are folded into in-memory state but BEFORE the commit —
    exactly where a crash is most interesting."""

    def __init__(self, corpus_dir: str, spec: SimSpec = DEFAULT_SPEC,
                 seed: int = 0, clusters: int = 256, families=None,
                 engine: str | None = None, score_engine: str | None = None,
                 round_hook=None, score_budget_s: float | None = None,
                 device=None):
        if clusters < 2:
            raise ValueError("clusters must be >= 2")
        self.corpus = Corpus(corpus_dir, spec, seed)
        self.spec = self.corpus.spec
        self.seed = int(self.corpus.state["seed"])
        self.clusters = int(clusters)
        self.families = tuple(families) if families else FAMILIES
        self.engine = engine
        self.score_engine = score_engine
        self.device = device
        self.round_hook = round_hook
        # wall-clock bound per round's scoring launch: traces whose
        # closures don't fit score unknown (never kept in the corpus)
        # instead of wedging the whole campaign
        self.score_budget_s = score_budget_s

    # -- population -------------------------------------------------------

    def _population(self, rnd: int) -> list:
        """The round's cluster configs: (wseed, schedule, parent-id,
        op). Pure function of (seed, round, corpus state) — determinism
        is what makes crash replay exactly-once."""
        entries = self.corpus.entries()
        pop = []
        for i in range(self.clusters):
            sd = derive_seed(self.seed, rnd, i)
            wseed = derive_seed(self.seed, rnd, i, 0xA) & 0x7FFFFFFF
            rng = random.Random(sd)
            if entries and i % 2 == 1:
                parent = rng.choice(entries)
                donor = rng.choice(entries)
                sched = mutate(schedule_from_lists(parent["schedule"],
                                                   self.spec),
                               sd, self.spec,
                               donor=schedule_from_lists(donor["schedule"],
                                                         self.spec),
                               families=self.families)
                if rng.random() < 0.5:
                    # keep the parent's workload: mutate ONLY the
                    # schedule, so coverage gains are attributable
                    wseed = int(parent["wseed"])
                pop.append((wseed, sched, parent["id"], "mutate"))
            else:
                sched = random_schedule(sd, self.spec,
                                        families=self.families)
                pop.append((wseed, sched, None, "seed"))
        return pop

    # -- rounds -----------------------------------------------------------

    def _fold(self, rnd: int, pop: list, scores: list) -> dict:
        st = self.corpus.state
        kept = new_anoms = 0
        for (wseed, sched, parent, op), score in zip(pop, scores):
            cov = score["coverage"]
            if cov == "unknown" or cov in st["coverage"]:
                continue
            eid = fingerprint(sched, wseed)
            if eid in st["entries"]:
                continue
            st["entries"][eid] = {
                "id": eid, "wseed": int(wseed),
                "schedule": schedule_to_lists(sched),
                "coverage": cov, "types": score["anomaly-types"],
                "cycle-count": score["cycle-count"],
                "round": rnd, "parent": parent, "op": op,
            }
            st["coverage"][cov] = eid
            kept += 1
            if score["anomaly-types"]:
                st["anomalies"].append(eid)
                new_anoms += 1
                if st["first-anomaly"] is None:
                    st["first-anomaly"] = {
                        "round": rnd,
                        "clusters": st["clusters-run"] + len(pop),
                        "types": score["anomaly-types"],
                    }
        st["clusters-run"] += len(pop)
        return {"round": rnd, "clusters": len(pop), "kept": kept,
                "new-anomalies": new_anoms}

    def run_round(self) -> dict:
        rnd = int(self.corpus.state["round"])
        pop = self._population(rnd)
        scheds = np.stack([p[1] for p in pop])
        wseeds = np.array([p[0] for p in pop], dtype=np.int64)
        results = simulate_batch(scheds, wseeds, self.spec,
                                 engine=self.engine, device=self.device)
        budget = None
        if self.score_budget_s is not None:
            import time

            budget = time.monotonic() + self.score_budget_s
        scores = score_batch(results, self.spec, scheds=scheds,
                             engine=self.score_engine, device=self.device,
                             budget=budget)
        stats = self._fold(rnd, pop, scores)
        if self.round_hook is not None:
            self.round_hook(rnd)
        self.corpus.state["round"] = rnd + 1
        self.corpus.commit()
        return stats

    def run(self, rounds: int) -> dict:
        """Run until the corpus has seen ``rounds`` rounds total (a
        resumed loop only runs the remainder)."""
        per_round = []
        while int(self.corpus.state["round"]) < rounds:
            per_round.append(self.run_round())
        return {**self.corpus.summary(), "per-round": per_round}


def run_fuzz(opts: dict) -> dict:
    """The body of the JAX package's ``jepsen-tpu fuzz`` command, on the
    port's loop: the same option names, plus "score_engine" and
    "device"."""
    spec = SimSpec(
        nodes=int(opts.get("nodes_n") or DEFAULT_SPEC.nodes),
        keys=int(opts.get("keys") or DEFAULT_SPEC.keys),
        txns=int(opts.get("txns") or DEFAULT_SPEC.txns),
        mops=int(opts.get("mops") or DEFAULT_SPEC.mops),
        faults=int(opts.get("fault_slots") or DEFAULT_SPEC.faults),
    ).validate()
    families = None
    if opts.get("families"):
        families = [f.strip() for f in str(opts["families"]).split(",")
                    if f.strip()]
        bad = [f for f in families if f not in FAMILIES]
        if bad:
            raise ValueError(f"unknown fault families: {bad} "
                             f"(known: {list(FAMILIES)})")
    deadline_ms = opts.get("deadline_ms")
    loop = FuzzLoop(
        opts["corpus_dir"], spec=spec,
        seed=int(opts.get("seed") or 0),
        clusters=int(opts.get("clusters") or 256),
        families=families,
        engine=opts.get("engine"),
        score_engine=opts.get("score_engine"),
        device=opts.get("device"),
        score_budget_s=(max(1, int(deadline_ms)) / 1000.0
                        if deadline_ms is not None else None),
    )
    return loop.run(int(opts.get("rounds") or 4))
