"""The WGL engines' kernels launched from many threads at once, as
`independent.checker` launches them (a thread a key), with plans whose
shared memory differs by key size: every launch goes through and every
verdict, step count and best stack is the one a lone launch gives; and
the cluster simulator's kernel launched from many threads at specs whose
shared memory differs, every result bit for bit its plain version's.
Each library sets its kernel's shared-memory limit, one value for every
thread, just before it launches, so the wrappers hold a lock across the
two (a launch between them once failed with cudaErrorInvalidValue on
the card). On the card only (the kernels have no CPU build); this file
imports nothing of JAX, so it runs where only the port is installed."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models
from jepsen_tpu_torch.fuzz import sim
from jepsen_tpu_torch.fuzz.schedule import SimSpec, random_schedule
from jepsen_tpu_torch.ops import wgl_row, wgl_search, wgl_vec
from jepsen_tpu_torch.workloads.register import register_history

THREADS = 8
ROUNDS = 24
# (invocations a key: a small plan and a large one; the share of
# corrupted reads) for each engine. wgl_vec's large key is a shallow
# one: the 480-invocation key with corrupted reads needs 11M search
# steps, past K1's cap a pass, and 192 launches of it take minutes.
CASES = {"wgl_vec": ((16, 240), 0.0), "wgl_row": ((16, 1500), 0.02),
         "wgl_search": ((16, 480), 0.02)}
ENGINES = {"wgl_vec": wgl_vec, "wgl_row": wgl_row,
           "wgl_search": wgl_search}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _summary(r) -> tuple:
    return (r.valid, r.steps, r.cache_size,
            None if r.op is None else r.op.index,
            None if r.best_linearization is None
            else [o.index for o in r.best_linearization])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_concurrent_launches_match_lone_ones(cuda, engine):
    mod, model = ENGINES[engine], models.CASRegister()
    sizes, corrupt = CASES[engine]
    ess = [thist.entries(register_history(
        n_process=5, n_ops=n, corrupt=corrupt, seed=7 + n))
        for n in sizes]
    lone = [_summary(mod.analysis_batch(model, [es], device=cuda)[0])
            for es in ess]
    launches = mod.LAUNCHES
    errors, results = [], []

    def worker(t: int) -> None:
        try:
            for r in range(ROUNDS):
                i = (t + r) % len(ess)
                res = mod.analysis_batch(model, [ess[i]], device=cuda)[0]
                results.append((i, _summary(res)))
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads), "a launch hung"
    torch.cuda.synchronize()
    assert errors == []
    assert len(results) == THREADS * ROUNDS
    assert all(s == lone[i] for i, s in results)
    assert mod.LAUNCHES - launches >= THREADS * ROUNDS


# two cluster shapes whose blocks need 105,232 and 121,580 bytes of
# shared memory, both past the 48-KiB default, so each launch must raise
# the kernel's limit to its own size first
SIM_SPECS = (SimSpec(nodes=16, keys=64, txns=120, mops=8, faults=16),
             SimSpec(nodes=9, keys=40, txns=200, mops=8, faults=12))


def test_concurrent_sim_launches_match_plain(cuda):
    batches = []
    for j, spec in enumerate(SIM_SPECS):
        scheds = torch.from_numpy(np.stack(
            [random_schedule(100 * j + i, spec) for i in range(64)]))
        wseeds = torch.arange(64, dtype=torch.int32) * 7919 + j
        plain = sim.sim_plain(scheds, wseeds, spec)
        batches.append((spec, scheds.to(cuda), wseeds.to(cuda), plain))
    launches = sim.LAUNCHES
    start = threading.Barrier(THREADS)
    errors, results = [], []

    def worker(t: int) -> None:
        try:
            start.wait(timeout=60)
            for r in range(ROUNDS):
                i = (t + r) % len(batches)
                spec, scheds, wseeds, _ = batches[i]
                out = sim.sim(scheds, wseeds, spec)
                results.append((i, {k: v.cpu() for k, v in out.items()}))
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads), "a launch hung"
    torch.cuda.synchronize()
    assert errors == []
    assert len(results) == THREADS * ROUNDS
    for i, out in results:
        plain = batches[i][3]
        assert all(torch.equal(out[k], plain[k]) for k in sim.OUTPUTS)
    assert sim.LAUNCHES - launches == THREADS * ROUNDS
