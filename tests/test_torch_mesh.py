"""The port's multi-device engines against the JAX package's mesh paths.

The JAX side runs on the 8 virtual CPU devices tests/conftest.py forces
(`jax.devices()[:D]`); the port's side deals over the device list
["cpu"] * D, the same code that deals over ["cuda:0"] * D or several
cards: K2's longest-first deal (`wgl_search.deal`, `analysis_batch(
devices=)`), K1's block shards (`wgl_vec.analysis_batch(devices=)`),
K3's row-block squaring (`closure.reach_batch(devices=)`), the routes of
`Linearizable` and `CycleChecker` over `device.devices()`, and the doctor.
Every comparison is exact: verdicts, steps, counterexamples (op and best
linearization), closures bit for bit, the deal's order and padding row
for row. The card-only case (["cuda:0"] * 2 against one device) skips
without CUDA."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.ops import closure_tpu, wgl_pallas_vec, wgl_tpu

from jepsen_tpu_torch import carry, device, doctor
from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import cycle
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.models import jit as tjit
from jepsen_tpu_torch.ops import closure, wgl_search, wgl_vec
from jepsen_tpu_torch.workloads import list_append

from helpers import random_queue_history, random_register_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_port(hist):
    return carry.history_from_dicts([o.to_dict() for o in hist])


def fields(r):
    """A WGLResult's verdict, steps and counterexample, as dicts."""
    return (r.valid, r.steps,
            None if r.op is None else r.op.to_dict(),
            None if r.best_linearization is None
            else [o.to_dict() for o in r.best_linearization])


def register_lanes(n, seed=1000):
    """Uneven register lanes of 4 to 28 invocations, every third one 30 %
    corrupt (the doctor's lanes)."""
    return [random_register_history(
        n_process=3, n_ops=4 + 3 * (s % 9), seed=seed + s,
        corrupt=0.3 if s % 3 == 0 else 0.0) for s in range(n)]


def fifo_lanes(n=16):
    return [random_queue_history(n_process=3, n_ops=10, fifo=True,
                                 corrupt=0.2 if s % 2 else 0.0,
                                 seed=500 + s) for s in range(n)]


# -- the device list -------------------------------------------------------

def test_devices_resolves_lists_and_repeats():
    assert device.devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    assert device.devices(("cpu",)) == [torch.device("cpu")]
    with pytest.raises(ValueError):
        device.devices([])
    with pytest.raises(ValueError):
        device.devices("cpu")


def test_devices_default_and_cuda_entries_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default list resolves")
    with pytest.raises(device.CudaUnavailable):
        device.devices()
    with pytest.raises(device.CudaUnavailable):
        device.devices(["cuda:0", "cuda:0"])
    assert device.mesh() is None
    assert device.mesh("cpu") is None


def test_mesh_needs_the_default_device_and_two_entries(monkeypatch):
    monkeypatch.setattr(device, "devices",
                        lambda spec=None: [torch.device("cpu")] * 2)
    assert device.mesh() == [torch.device("cpu")] * 2
    assert device.mesh("cpu") is None
    monkeypatch.setattr(device, "devices",
                        lambda spec=None: [torch.device("cpu")])
    assert device.mesh() is None


# -- K2's deal -------------------------------------------------------------

def jax_deal(ents_rows, n_dev):
    """The rows wgl_tpu.analysis_batch stacked for its mesh (its second
    `_stack` call), as lane indices (-1 an empty lane), or None when it
    did not deal."""
    calls = ents_rows
    if len(calls) < 2:
        return None
    ids = {id(e): i for i, e in enumerate(calls[0])}
    return [ids.get(id(r), -1) for r in calls[1]]


@pytest.mark.parametrize("d", [2, 3, 5])
def test_deal_matches_jax_order_and_padding(monkeypatch, d):
    """For 1, D-1, D and 3D+1 lanes of uneven lengths (ties included):
    the port's rows are the JAX package's, row for row; below D lanes
    neither package deals."""
    stacked = []
    real_stack = wgl_tpu._stack

    def spy(ents):
        stacked.append(list(ents))
        return real_stack(ents)

    monkeypatch.setattr(wgl_tpu, "_stack", spy)
    for n in (1, d - 1, d, 3 * d + 1):
        if n < 1:
            continue
        hists = register_lanes(n, seed=40 * d + n)
        stacked.clear()
        wgl_tpu.analysis_batch(jmodels.CASRegister(),
                               [jhist.entries(h) for h in hists],
                               devices=jax.devices()[:d])
        want = jax_deal(stacked, d)
        tess = [thist.entries(to_port(h)) for h in hists]
        chunks, rows = wgl_search.deal([len(es) for es in tess], d)
        if n < d:
            assert want is None
            continue
        assert rows == want
        per = len(rows) // d
        assert [[r for r in rows[k * per:(k + 1) * per] if r >= 0]
                for k in range(d)] == chunks


def test_deal_is_stable_for_equal_lengths():
    chunks, rows = wgl_search.deal([5, 5, 5, 5, 5], 2)
    assert chunks == [[0, 2, 4], [1, 3]] and rows == [0, 2, 4, 1, 3, -1]


def test_empty_lane_is_valid_with_no_steps():
    """An all-zero row (n_completed 0) in search_plain: VALID, 0 steps,
    depth 0, and its neighbours' results as without it."""
    jm = tjit.for_model(tmodels.CASRegister())
    tess = [thist.entries(to_port(h)) for h in register_lanes(4)]
    n_pad = wgl_search.pad_size(max(len(es) for es in tess))
    packed = wgl_search._pack(tess, jm, n_pad)
    with_empty = np.insert(packed, [0, 2, 4], 0, axis=0)
    steps = torch.full((len(tess),), 10_000, dtype=torch.int32)
    steps_e = torch.full((len(with_empty),), 10_000, dtype=torch.int32)
    steps_e[[0, 3, 6]] = 0
    got = wgl_search.search_plain(torch.from_numpy(with_empty), steps_e, jm,
                                  n_pad, 1)
    want = wgl_search.search_plain(torch.from_numpy(packed), steps, jm,
                                   n_pad, 1)
    assert got[:, [0, 3, 6]].tolist() == [[1] * 3, [0] * 3, [0] * 3]
    assert torch.equal(got[:, [1, 2, 4, 5]], want)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_k2_dealt_matches_jax_mesh_and_one_device(d):
    """Uneven register lanes dealt over D devices: the JAX package's
    mesh results, field for field, and the port's one-device results."""
    hists = register_lanes(3 * d + 1, seed=2000 + d)
    jr = wgl_tpu.analysis_batch(jmodels.CASRegister(),
                                [jhist.entries(h) for h in hists],
                                devices=jax.devices()[:d])
    tess = [to_port(h) for h in hists]
    tr = wgl_search.analysis_batch(tmodels.CASRegister(), tess,
                                   devices=["cpu"] * d)
    one = wgl_search.analysis_batch(tmodels.CASRegister(), tess,
                                    device="cpu")
    assert [fields(r) for r in tr] == [fields(r) for r in jr]
    assert [fields(r) for r in tr] == [fields(r) for r in one]
    assert {True, False} <= {r.valid for r in tr}


def test_k2_dealt_fifo_lanes_match_jax_mesh():
    hists = fifo_lanes()
    jr = wgl_tpu.analysis_batch(jmodels.FIFOQueue(),
                                [jhist.entries(h) for h in hists],
                                devices=jax.devices()[:3])
    tr = wgl_search.analysis_batch(tmodels.FIFOQueue(),
                                   [to_port(h) for h in hists],
                                   devices=["cpu"] * 3)
    one = wgl_search.analysis_batch(tmodels.FIFOQueue(),
                                    [to_port(h) for h in hists],
                                    device="cpu")
    assert [fields(r) for r in tr] == [fields(r) for r in jr]
    assert [fields(r) for r in tr] == [fields(r) for r in one]


def test_k2_deal_launches_a_chunk_a_device(monkeypatch):
    """Each device's chunk is one launch (of equal length, the empty
    lanes included), all launched before any result is read back; a
    scratch budget that splits a chunk splits every chunk alike."""
    wgl_search.CAPTURE = []
    try:
        tess = [to_port(h) for h in register_lanes(7)]
        wgl_search.analysis_batch(tmodels.CASRegister(), tess,
                                  devices=["cpu"] * 3)
        assert [c[0].shape[0] for c in wgl_search.CAPTURE] == [3, 3, 3]
        wgl_search.CAPTURE = []
        jm = tjit.for_model(tmodels.CASRegister())
        n_pad = wgl_search.pad_size(max(len(thist.entries(h)) for h in tess))
        lane = 4 * wgl_search._layout(jm, n_pad, 1, 13).words
        monkeypatch.setattr(wgl_search, "SCRATCH_BUDGET", 2 * lane)
        wgl_search.analysis_batch(tmodels.CASRegister(), tess,
                                  devices=["cpu"] * 3)
        assert [c[0].shape[0] for c in wgl_search.CAPTURE] == [2, 1] * 3
    finally:
        wgl_search.CAPTURE = None


def test_k2_device_and_devices_exclusive():
    with pytest.raises(ValueError):
        wgl_search.analysis_batch(tmodels.CASRegister(), [], device="cpu",
                                  devices=["cpu"])
    assert wgl_search.probe_mesh(["cpu"] * 3)


# -- K1's block shards -----------------------------------------------------

@pytest.mark.parametrize("d", [3, 8])
def test_k1_shards_match_jax_mesh(d):
    """300 register lanes (3 blocks, padded to D): the Pallas kernel's
    shard_map over D devices (interpret mode) and the port's shards,
    verdicts, steps, op and best linearization equal; and equal to the
    port's one device."""
    hists = [random_register_history(
        n_process=3, n_ops=10, seed=7300 + s,
        corrupt=0.3 if s % 4 == 0 else 0.0) for s in range(300)]
    jr = wgl_pallas_vec.analysis_batch(
        jmodels.CASRegister(), [jhist.entries(h) for h in hists],
        devices=jax.devices()[:d])
    tess = [to_port(h) for h in hists]
    tr = wgl_vec.analysis_batch(tmodels.CASRegister(), tess,
                                devices=["cpu"] * d)
    one = wgl_vec.analysis_batch(tmodels.CASRegister(), tess, device="cpu")
    assert [fields(r) for r in tr] == [fields(r) for r in jr]
    assert [fields(r) for r in tr] == [fields(r) for r in one]
    assert sum(r.valid is False for r in tr) >= 3


def test_k1_shards_queue_model_match_jax_mesh():
    hists = [random_queue_history(n_process=3, n_ops=10, seed=7600 + s)
             for s in range(20)]
    jr = wgl_pallas_vec.analysis_batch(
        jmodels.UnorderedQueue(), [jhist.entries(h) for h in hists],
        devices=jax.devices()[:3])
    tr = wgl_vec.analysis_batch(tmodels.UnorderedQueue(),
                                [to_port(h) for h in hists],
                                devices=["cpu"] * 3)
    assert [fields(r) for r in tr] == [fields(r) for r in jr]


def test_k1_two_pass_redeals_survivors(monkeypatch):
    """Past 8 * PASS1_CAP steps of budget, pass 1's survivors are laid
    out and sharded again: every pass is one launch a shard (of equal
    width), and the results are one device's."""
    hists = [random_register_history(n_process=4, n_ops=10, seed=900 + s,
                                     corrupt=0.4 if s % 3 == 0 else 0.0)
             for s in range(260)]
    tess = [to_port(h) for h in hists]
    monkeypatch.setattr(wgl_vec, "PASS1_CAP", 8)
    one = wgl_vec.analysis_batch(tmodels.CASRegister(), tess, max_steps=200,
                                 device="cpu")
    wgl_vec.CAPTURE = []
    try:
        tr = wgl_vec.analysis_batch(tmodels.CASRegister(), tess,
                                    max_steps=200, devices=["cpu"] * 3)
        widths = [c[0].shape[1] for c in wgl_vec.CAPTURE]
        caps = [int(c[1].max()) for c in wgl_vec.CAPTURE]
    finally:
        wgl_vec.CAPTURE = None
    assert [fields(r) for r in tr] == [fields(r) for r in one]
    # pass 1: 260 lanes in 4 blocks, padded to 6: 2 blocks a shard; pass
    # 2: the survivors' blocks padded to a multiple of 3
    assert len(widths) == 6 and caps == [8] * 3 + [200] * 3
    assert widths[:3] == [2 * wgl_vec.LANES] * 3
    assert len(set(widths[3:])) == 1


def test_one_device_list_is_not_a_mesh(monkeypatch):
    """A one-device list is the single-device path: one K1 launch over
    the whole batch, one K2 launch, closure_block (never the mesh)."""
    tess = [to_port(h) for h in register_lanes(5)]
    wgl_vec.CAPTURE, wgl_search.CAPTURE = [], []
    try:
        a = wgl_vec.analysis_batch(tmodels.CASRegister(), tess,
                                   devices=["cpu"])
        b = wgl_search.analysis_batch(tmodels.CASRegister(), tess,
                                      devices=["cpu"])
        assert len(wgl_vec.CAPTURE) == 1 and len(wgl_search.CAPTURE) == 1
        assert wgl_search.CAPTURE[0][0].shape[0] == 5
    finally:
        wgl_vec.CAPTURE = wgl_search.CAPTURE = None
    assert a == wgl_vec.analysis_batch(tmodels.CASRegister(), tess,
                                       device="cpu")
    assert b == wgl_search.analysis_batch(tmodels.CASRegister(), tess,
                                          device="cpu")

    def no_mesh(*a, **k):
        raise AssertionError("a one-device list took the mesh")

    monkeypatch.setattr(closure, "_closure_block_mesh", no_mesh)
    a = np.eye(40, k=1, dtype=bool)
    a[39, 0] = True
    (r,) = closure.reach_batch([a], devices=["cpu"])
    assert r.all()


# -- K3's row blocks -------------------------------------------------------

def digraph(n, p, seed):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    np.fill_diagonal(a, False)
    return a


@pytest.mark.parametrize("d", [3, 5, 8])
def test_k3_mesh_matches_jax_mesh_and_one_device(d):
    """n 17 (the one-word bucket, a row block smaller than a tile), 33,
    100 and 129 — with a 2-cycle, a ring and a random digraph — sharded
    over D: the JAX package's mesh closures and the port's one device,
    bit for bit."""
    mats = [digraph(n, 3.0 / n, 10 * d + n) for n in (17, 33, 100, 129)]
    ring = np.roll(np.eye(33, dtype=bool), 1, axis=1)
    two = np.zeros((17, 17), dtype=bool)
    two[3, 4] = two[4, 3] = True
    mats += [ring, two]
    jm = closure_tpu.reach_batch(mats, devices=jax.devices()[:d])
    tm = closure.reach_batch(mats, devices=["cpu"] * d)
    one = closure.reach_batch(mats, device="cpu")
    for a, j, t, o in zip(mats, jm, tm, one):
        assert t.shape == a.shape
        assert np.array_equal(t, j) and np.array_equal(t, o)


@pytest.mark.parametrize("p,d", [(32, 3), (64, 5), (128, 8), (2048, 3)])
def test_k3_mesh_rounds_and_tiles(p, d):
    """The sharded fixpoint runs the single-device fixpoint's rounds, each
    shard's words are whole tiles of closure.cu, and the kernels' plain
    versions give the closure_block words."""
    r = closure.shard_rows(p, d)
    assert r * d >= p and r >= -(-p // d)
    assert (r * p // 32) % closure.TILE_WORDS == 0
    if p > 256:
        return
    mats = [digraph(p - 3, 2.0 / p, p + d + s) for s in range(3)]
    words0 = torch.from_numpy(closure._pack(mats, p))
    want, ran = closure.closure_block_plain(words0, p)
    got, ran_m = closure._closure_block_mesh_plain(words0, p, ["cpu"] * d)
    assert torch.equal(got, want)
    assert ran_m == (int(ran.max()) if torch.is_tensor(ran) else ran) \
        or p == closure.MIN_PAD
    shards = closure._mesh_shards(words0, p, ["cpu"] * d)
    # the batch keeps its size: only the rows are padded
    assert [tuple(w.shape) for w in shards] == [(3, r, p // 32)] * d


def test_k3_mesh_keeps_budget_and_on_closed():
    mats = [digraph(40, 0.1, 1), digraph(300, 0.01, 2)]
    seen = {}
    out = closure.reach_batch(mats, devices=["cpu"] * 2,
                              on_closed=seen.__setitem__)
    assert sorted(seen) == [0, 1]
    assert all(np.array_equal(seen[i], out[i]) for i in seen)
    with pytest.raises(closure.DeadlineExpired):
        closure.reach_batch(mats, devices=["cpu"] * 2, budget=0.0)
    assert closure.probe_mesh(["cpu"] * 3)


def test_k3_row_block_shapes_accepted_by_the_passes():
    """unpack and the threshold pass take a shard's [b, r, p/32] words."""
    words = torch.from_numpy(closure._pack([digraph(60, 0.1, 3)], 64))
    block = words[:, :16].contiguous()
    m = closure.unpack(block, 64)
    assert m.shape == (1, 16, 64)
    assert torch.equal(m, closure.unpack_plain(words, 64)[:, :16])
    full = closure.unpack(words, 64)
    prod = closure.matmul(m, rhs=full)
    flag = torch.zeros(1, dtype=torch.int32)
    new = closure.or_threshold_pack(prod, block, flag, operand=m)
    assert new.shape == block.shape
    assert torch.equal(m, closure.unpack_plain(new, 64))


# -- the routes ------------------------------------------------------------

@pytest.fixture
def two_cpus(monkeypatch):
    """device.devices() lists two CPU entries, and both bars are 1."""
    monkeypatch.setattr(device, "devices",
                        lambda spec=None: [torch.device("cpu")] * 2
                        if spec is None else [torch.device("cpu")] * len(spec))
    monkeypatch.setenv("JEPSEN_TPU_TORCH_MESH_LANES_MIN", "1")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_MESH_MIN_N", "1")


def test_linearizable_route_deals_gpu_search(two_cpus):
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.workloads.register import keyed_history

    h = keyed_history(6, 8, n_process=2, bad_every=3, seed=1)
    wgl_search.CAPTURE = []
    try:
        got = independent.checker(linearizable(
            tmodels.CASRegister(), algorithm="gpu_search")).check({}, h, {})
        assert len(wgl_search.CAPTURE) == 2  # one chunk a device
    finally:
        wgl_search.CAPTURE = None
    want = independent.checker(linearizable(
        tmodels.CASRegister(), algorithm="gpu_search", device="cpu")).check(
        {}, h, {})
    assert got == want and got["valid"] is False


def test_linearizable_route_respects_its_bar(two_cpus, monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_TORCH_MESH_LANES_MIN", "100")
    chk = linearizable(tmodels.CASRegister(), algorithm="gpu_search")
    assert chk._mesh("gpu_search", [None] * 99) is None
    assert chk._mesh("gpu_search", [None] * 100) is not None
    assert chk._mesh("gpu_vec", [None] * 100) is None
    assert linearizable(tmodels.CASRegister(), algorithm="gpu_search",
                        device="cpu")._mesh("gpu_search", [None] * 100) \
        is None


def test_cycle_checker_route_shards_the_closures(two_cpus, monkeypatch):
    h = list_append.simulate(400, seed=0)
    calls = []
    real = closure._closure_block_mesh

    def spy(words0, p, devices):
        calls.append(p)
        return real(words0, p, devices)

    monkeypatch.setattr(closure, "_closure_block_mesh", spy)
    got = cycle.checker().check({}, h, {})
    assert calls
    want = cycle.checker(device="cpu").check({}, h, {})
    assert got == want and got["anomaly-types"] == ["G1c", "G-single"]
    pinned = cycle.checker(engine="mesh", devices=["cpu"] * 3).check(
        {}, h, {})
    assert pinned == want


def test_cycle_route_stays_below_mesh_min_n(two_cpus, monkeypatch):
    """Below mesh_min_n the batch takes the single-device route on the
    default device (device None, no device list), on any host."""
    monkeypatch.setenv("JEPSEN_TPU_TORCH_MESH_MIN_N", "100000")
    calls = []

    def spy(mats, **kw):
        calls.append(kw)
        return closure.reach_batch_plain(mats)

    monkeypatch.setattr(closure, "reach_batch", spy)
    from jepsen_tpu_torch.checker.cycle import anomalies
    mats = [digraph(20, 0.2, 0)]
    anomalies._closures(mats)
    assert [(kw.get("device"), kw.get("devices")) for kw in calls] == \
        [(None, None)]


def test_calibrate_bars(monkeypatch):
    from jepsen_tpu_torch.checker import calibrate

    monkeypatch.delenv("JEPSEN_TPU_TORCH_MESH_LANES_MIN", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_TORCH_MESH_MIN_N", raising=False)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert calibrate.mesh_lanes_min() == max(64, 4 * cards)
    if cards < 2:
        assert calibrate.mesh_min_n() == calibrate.MESH_MIN_N_DEFAULT
    monkeypatch.setenv("JEPSEN_TPU_TORCH_MESH_LANES_MIN", "7")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_MESH_MIN_N", "9")
    assert (calibrate.mesh_lanes_min(), calibrate.mesh_min_n()) == (7, 9)


def test_bundle_warms_the_mesh_buckets_only_with_a_mesh(two_cpus):
    from jepsen_tpu_torch.serve import bundle, registry

    assert bundle.buckets() == {**bundle.DEFAULT_BUCKETS,
                                **bundle.MESH_BUCKETS}
    assert bundle.buckets("cpu") == bundle.DEFAULT_BUCKETS
    bundle._probe_search_mesh_bucket(32, device.devices())
    bundle._probe_closure_mesh_bucket(64, device.devices())
    topo = registry.EngineRegistry(device="cpu").mesh_topology()
    assert topo["mesh_routes"] == {"wgl_mesh": False, "closure_mesh": False}


# -- the doctor ------------------------------------------------------------

def test_doctor_matches_jax_doctor():
    from jepsen_tpu import cli as jcli

    jrep = jcli._load_mesh_doctor().diagnose(max_devices=3)
    trep = doctor.diagnose(devices=["cpu"] * 3)
    assert jrep["ok"] and trep["ok"]
    assert [d["ok"] for d in trep["per_device"]] == \
        [d["ok"] for d in jrep["per_device"]]
    for k in ("wgl_mesh", "closure_mesh"):
        assert {f: trep[k][f] for f in ("ok", "lanes", "n") if f in jrep[k]} \
            == {f: jrep[k][f] for f in ("ok", "lanes", "n") if f in jrep[k]}
    assert trep["wgl_vec_mesh"]["ok"] and trep["wgl_vec_mesh"]["refuted"]
    assert trep["n_devices"] == 3 and trep["platform"] == "cpu"


def test_doctor_names_a_sick_device(monkeypatch):
    real = wgl_search.analysis_batch

    def sick(model, ess, devices=None, **k):
        if devices is not None and len(devices) == 1:
            raise RuntimeError("sick card")
        return real(model, ess, devices=devices, **k)

    monkeypatch.setattr(wgl_search, "analysis_batch", sick)
    rep = doctor.diagnose(devices=["cpu"] * 2)
    assert not rep["ok"] and "sick card" in rep["per_device"][0]["error"]


@pytest.mark.parametrize("argv,code", [(["--mesh", "3"], 0),
                                       (["--mesh", "0"], 254)])
def test_doctor_cli(argv, code):
    out = subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch", "doctor", *argv],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == code, out.stdout[-2000:] + out.stderr[-2000:]
    if code == 0:
        import json

        assert json.loads(out.stdout)["ok"] is True


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_repeated_device_equals_one_device(cuda):
    tess = [to_port(h) for h in register_lanes(300)]
    for mod in (wgl_search, wgl_vec):
        assert mod.analysis_batch(tmodels.CASRegister(), tess,
                                  devices=["cuda:0"] * 2) == \
            mod.analysis_batch(tmodels.CASRegister(), tess)
    mats = [digraph(n, 3.0 / n, n) for n in (17, 100, 700)]
    for a, b in zip(closure.reach_batch(mats, devices=["cuda:0"] * 3),
                    closure.reach_batch(mats)):
        assert np.array_equal(a, b)
