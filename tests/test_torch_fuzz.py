"""The port's fuzz simulator and scorer against the JAX package: the
plain PyTorch simulator (CPU tensors) bit for bit against `sim_host`
(numpy) and `sim_device` (jax on the CPU) on seeded batches and specs
and on the committed anomaly fixtures; the scores (anomaly types, cycle
counts, coverage keys) equal; the hash on its edge values. Tolerance
zero everywhere. Sizes stay at <= 64 clusters."""

import json
import os

import numpy as np
import pytest
import torch

from jepsen_tpu.fuzz import schedule as jschedule
from jepsen_tpu.fuzz import score as jscore
from jepsen_tpu.fuzz import sim as jsim

from jepsen_tpu_torch.checker import cycle
from jepsen_tpu_torch.fuzz import schedule, score, sim
from jepsen_tpu_torch.fuzz import (SimSpec, decode, random_schedule,
                                   score_batch, simulate_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "fuzz_anomalies.jsonl")

SPECS = {
    "default": {},
    "small": dict(nodes=3, keys=5, txns=10, mops=3, faults=4),
    "wide": dict(nodes=7, keys=12, txns=30, mops=5, faults=10),
    "one_key": dict(nodes=2, keys=1, txns=6, mops=2, faults=2),
}


def batch(n, spec, seed0=0):
    scheds = np.stack([random_schedule(seed0 + i, spec) for i in range(n)])
    wseeds = (np.arange(n, dtype=np.int64) * 2654435761 + seed0) \
        & 0x7FFFFFFF
    return scheds, wseeds


def fixtures():
    with open(FIXTURES) as fh:
        return [json.loads(line) for line in fh]


def same_outputs(got: list, want: dict):
    """Every output of every cluster equal, value for value."""
    for k, v in want.items():
        stacked = np.stack([r[k] for r in got])
        assert stacked.shape == np.asarray(v).shape, k
        assert np.array_equal(stacked, np.asarray(v)), k


@pytest.mark.parametrize("n", [1, 16, 64])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_matches_sim_host(name, n):
    """simulate_batch(device="cpu") and engine="host" (both the plain
    version on the CPU) equal the JAX package's sim_host bit for bit; the
    schedules from the same seeds are the same arrays."""
    spec = SimSpec(**SPECS[name])
    scheds, wseeds = batch(n, spec, seed0=31 * n)
    jspec = jschedule.SimSpec(**SPECS[name])
    jscheds = np.stack([jschedule.random_schedule(31 * n + i, jspec)
                        for i in range(n)])
    assert np.array_equal(scheds, jscheds)
    want = jsim.sim_host(scheds, wseeds, jspec)
    same_outputs(simulate_batch(scheds, wseeds, spec, device="cpu"), want)
    same_outputs(simulate_batch(scheds, wseeds, spec, engine="host"), want)


@pytest.mark.parametrize("name", ["default", "small"])
def test_plain_matches_sim_device(name):
    """The plain version equals the JAX package's jitted simulator (jax on
    the CPU), and takes the same wseed fold (negative and wide seeds)."""
    spec = SimSpec(**SPECS[name])
    scheds, _ = batch(24, spec, seed0=900)
    wseeds = np.array([-1, -(2**40), 2**33 + 5, 0] * 6, dtype=np.int64)
    want = jsim.sim_device(scheds, wseeds, jschedule.SimSpec(**SPECS[name]))
    same_outputs(simulate_batch(scheds, wseeds, spec, device="cpu"), want)


def test_fixture_cases_reproduce():
    """The 8 committed anomaly traces: the plain version equals both JAX
    engines, and scoring reproduces each fixture's types and coverage."""
    cases = fixtures()
    assert len(cases) == 8
    for case in cases:
        spec = SimSpec(**case["spec"])
        sched = schedule.schedule_from_lists(case["schedule"], spec)
        jspec = jschedule.SimSpec(**case["spec"])
        res = simulate_batch(sched, [case["wseed"]], spec, device="cpu")
        same_outputs(res, jsim.sim_host(sched, [case["wseed"]], jspec))
        same_outputs(res, jsim.sim_device(sched, [case["wseed"]], jspec))
        (sc,) = score_batch(res, spec, scheds=[sched], device="cpu")
        assert sc["anomaly-types"] == case["types"], case["id"]
        assert sc["coverage"] == case["coverage"], case["id"]
        assert sc["cycle-count"] == case["cycle-count"], case["id"]


@pytest.mark.parametrize("name", ["default", "wide"])
def test_scores_match_jax(name):
    """score_batch on the card engine's plain versions and on the host
    DFS equals the JAX package's score_batch on the same results: the
    whole score dicts, types, cycle counts and coverage keys."""
    spec = SimSpec(**SPECS[name])
    jspec = jschedule.SimSpec(**SPECS[name])
    scheds, wseeds = batch(32, spec, seed0=77)
    res = simulate_batch(scheds, wseeds, spec, device="cpu")
    want = jscore.score_batch(
        jsim.simulate_batch(scheds, wseeds, jspec, engine="host"), jspec,
        scheds=scheds, engine="host")
    for engine, device in ((None, "cpu"), ("host", None)):
        got = score_batch(res, spec, scheds=scheds, engine=engine,
                          device=device)
        assert got == want
    assert any(s["anomaly-types"] for s in want)


def test_score_budget_expired():
    """A budget already spent scores every trace unknown with error
    "deadline"."""
    spec = SimSpec(**SPECS["small"])
    scheds, wseeds = batch(4, spec)
    res = simulate_batch(scheds, wseeds, spec, device="cpu")
    import time
    got = score_batch(res, spec, device="cpu", budget=time.monotonic() - 1)
    assert {s["error"] for s in got} == {"deadline"}
    assert {s["valid"] for s in got} == {"unknown"}


def test_check_trace_matches_cycle_checker():
    """check_trace is the cycle checker's own path on the decoded
    trace."""
    spec = SimSpec()
    case = fixtures()[0]
    sched = schedule.schedule_from_lists(case["schedule"], spec)
    (res,) = simulate_batch(sched, [case["wseed"]], spec, device="cpu")
    r = score.check_trace(res, spec, device="cpu")
    c = cycle.checker(device="cpu").check({}, decode(res, spec), {})
    assert r["anomaly-types"] == c["anomaly-types"] == case["types"]
    assert r["cycle-count"] == c["cycle-count"]
    assert r["valid"] is False and c["valid"] is False
    h = score.check_trace(res, spec, engine="host")
    assert h["anomaly-types"] == r["anomaly-types"]
    jr = jscore.check_trace(jsim.simulate_batch(
        sched, [case["wseed"]], jschedule.SimSpec(), engine="host")[0],
        engine="host")
    assert jr["anomaly-types"] == r["anomaly-types"]
    assert jr["cycle-count"] == r["cycle-count"]


def test_decode_matches_jax():
    spec = SimSpec()
    scheds, wseeds = batch(6, spec, seed0=5)
    res = simulate_batch(scheds, wseeds, spec, device="cpu")
    for r in res:
        a = [o.to_dict() for o in decode(r, spec)]
        b = [o.to_dict() for o in jscore.decode(r)]
        assert a == b


EDGES = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]


def test_hash_edges_match_numpy():
    """The torch hash (int64, 16-bit constant halves) against the JAX
    package's numpy hash (`_make_hi(np, True)`) on edge values of every
    argument, the mixing constants' own products included."""
    ref = jsim._make_hi(np, np_mode=True)
    w, a, b = np.meshgrid(np.array(EDGES, np.int64), np.array(EDGES, np.int64),
                          np.array(EDGES, np.int64), indexing="ij")
    for c in (0, 11, 16, 177, 2**32 - 1):
        want = ref(w, c, a, b)
        got = sim.hi_torch(torch.from_numpy(w), c, torch.from_numpy(a),
                           torch.from_numpy(b))
        assert np.array_equal(got.numpy(), want), c
    x = torch.tensor(EDGES, dtype=torch.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 2**32 - 1):
        want = (np.array(EDGES, np.uint64) * np.uint64(c)) \
            & np.uint64(0xFFFFFFFF)
        assert np.array_equal(sim._mul32(x, c).numpy().astype(np.uint64),
                              want)


def test_mod_rejects_negative_operands():
    with pytest.raises(AssertionError):
        sim._mod(torch.tensor([-1, 3]), 2)
    with pytest.raises(AssertionError):
        sim._mod(torch.tensor([1, 3]), torch.tensor([0, 1]))


def test_simulate_batch_device_rule():
    """engine None runs on CUDA unless device="cpu" (raising without
    it); unknown engines and shapes are refused; a spec past the block's
    shared memory is refused before any launch."""
    from jepsen_tpu_torch.device import CudaUnavailable

    spec = SimSpec(**SPECS["small"])
    scheds, wseeds = batch(2, spec)
    if not torch.cuda.is_available():
        with pytest.raises(CudaUnavailable):
            simulate_batch(scheds, wseeds, spec)
    with pytest.raises(ValueError):
        simulate_batch(scheds, wseeds, spec, engine="tpu")
    with pytest.raises(ValueError):
        simulate_batch(scheds[:, :2], wseeds, spec, device="cpu")
    huge = SimSpec(nodes=16, keys=8, txns=600, mops=8, faults=8)
    assert sim.smem_bytes(huge) > sim.SMEM_LIMIT
    assert sim.smem_bytes(SimSpec()) == (64 * 8 + 36 * 104 + 272 + 12 * 26
                                         + 4 * 104 * 5)


def test_block_threads_by_batch(monkeypatch):
    """Threads a block on an H100 (132 SMs) at the default spec's 104
    mops: MAX_THREADS for the fuzz loop's round, one a mop for the
    bench's 1,024, one a pair of mops at 16,384; whole warps up to
    MAX_THREADS at any spec; THREADS overrides."""
    spec = SimSpec()
    assert [sim.block_threads(spec, n, 132)
            for n in (1, 256, 1024, 16384)] == [256, 256, 128, 64]
    edge = SimSpec(nodes=16, keys=1, txns=2, mops=2, faults=16)
    assert [sim.block_threads(edge, n, 132) for n in (1, 1024, 10 ** 6)] \
        == [256, 32, 32]
    wide = SimSpec(nodes=5, keys=70, txns=40, mops=4, faults=8)
    assert [sim.block_threads(wide, n, 132) for n in (1, 1024, 10 ** 6)] \
        == [256, 256, 128]
    monkeypatch.setattr(sim, "THREADS", 96)
    assert sim.block_threads(spec, 16384, 132) == 96


def test_launch_counts_only_on_the_card():
    """The plain version on CPU tensors launches nothing."""
    spec = SimSpec(**SPECS["small"])
    scheds, wseeds = batch(3, spec)
    before = sim.LAUNCHES
    simulate_batch(scheds, wseeds, spec, device="cpu")
    assert sim.LAUNCHES == before


# On the card (skipped without CUDA: the kernel has no CPU build)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_kernel_matches_plain(cuda, name):
    spec = SimSpec(**SPECS[name])
    scheds, wseeds = batch(64, spec, seed0=3)
    s = torch.from_numpy(scheds).to(cuda)
    w = torch.from_numpy((wseeds & 0x7FFFFFFF).astype(np.int32)).to(cuda)
    got = sim.sim(s, w, spec)
    want = sim.sim_plain(s, w, spec)
    for k in sim.OUTPUTS:
        assert torch.equal(got[k], want[k]), k
