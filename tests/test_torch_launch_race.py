"""The WGL engines' kernels launched from many threads at once, as
`independent.checker` launches them (a thread a key), with plans whose
shared memory differs by key size: every launch goes through and every
verdict, step count and best stack is the one a lone launch gives. Each
library sets its kernel's shared-memory limit, one value for every
thread, just before it launches, so the wrappers hold a lock across the
two (a launch between them once failed with cudaErrorInvalidValue on
the card). On the card only (the kernels have no CPU build); this file
imports nothing of JAX, so it runs where only the port is installed."""

from __future__ import annotations

import threading

import pytest
import torch

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models
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
