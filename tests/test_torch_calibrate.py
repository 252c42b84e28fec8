"""The measured crossover of "auto" (`jepsen_tpu_torch/checker/
calibrate.py`) against the JAX package's (`jepsen_tpu/checker/
calibrate.py`, tests/test_calibrate.py case for case where a case has a
counterpart): the bar's derivation on a seeded grid, the seeded lanes op
for op, the disk record, the pin, the seed, the measurement's arithmetic
and its first use, and "auto"'s dicts under a seeded bar. Everything is
exact (tolerance zero) but the fitted terms, which are compared to
1e-12 relative.

The CPU never measures: a check on device="cpu" has no card. Cases that
follow a measurement steer `calibrate._card` to the CPU device and stub
the two walls, so nothing here is timed."""

import importlib
import json

import numpy as np
import pytest
import torch

from jepsen_tpu import history as jhist
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker import calibrate as jcal
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable
from jepsen_tpu.models import jit as jjit
from jepsen_tpu.ops import wgl_pallas_vec

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch.checker import calibrate
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable, KernelError
from jepsen_tpu_torch.history import entries as make_entries
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.models import jit as mjit
from jepsen_tpu_torch.ops import wgl_native, wgl_vec

from helpers import random_register_history

lin_mod = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
jlin_mod = importlib.import_module("jepsen_tpu.checker.linearizable")

FAKE_FP = {"platform": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
           "capability": "9.0", "device_count": 1, "torch": "2.x",
           "cuda": "12.x"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    """Both packages' in-memory measurements dropped around each case,
    their records in scratch files, no pin."""
    for mod in (calibrate, jcal):
        mod._reset_for_tests()
    monkeypatch.setenv(calibrate._CACHE_ENV, str(tmp_path / "cal.json"))
    monkeypatch.setenv(jcal._CACHE_ENV, str(tmp_path / "jcal.json"))
    for env in (calibrate._ENV, jcal._ENV, calibrate._ENV_MESH_N):
        monkeypatch.delenv(env, raising=False)
    yield
    for mod in (calibrate, jcal):
        mod._reset_for_tests()


def _grid() -> list:
    """200 (t_rt, per_lane_native, per_lane_card) triples: the JAX tests'
    cases, margins of zero and below, both clamps, and a seeded spread
    of round trips and slopes."""
    out = [(0.110, 85e-6, 61e-6), (0.1, 50e-6, 50e-6), (0.1, 40e-6, 60e-6),
           (1e-6, 200e-6, 100e-6), (3600.0, 101e-6, 100e-6),
           (0.0, 1e-4, 1e-5), (0.02, 70e-6, 50e-6), (5.0, 1e-6, 0.0)]
    rng = np.random.default_rng(21)
    while len(out) < 200:
        t_rt = float(10 ** rng.uniform(-7, 4))
        native = float(10 ** rng.uniform(-7, -2))
        r = rng.random()
        card = (native if r < 0.1 else native * float(rng.uniform(1, 3))
                if r < 0.25 else native * float(rng.uniform(0, 1)))
        out.append((t_rt, native, card))
    return out


GRID = _grid()


@pytest.mark.parametrize("i", range(len(GRID)))
def test_derive_batch_min_matches_jax(i):
    """`derive_batch_min` and `Calibration.batch_min` equal the JAX
    package's on every triple (tests/test_calibrate.py TestDeriveBatchMin:
    the crossover, a margin of zero or below pinned to CAL_MAX, both
    clamps, the dataclass property)."""
    t_rt, native, card = GRID[i]
    want = jcal.derive_batch_min(t_rt, native, card)
    assert calibrate.derive_batch_min(t_rt, native, card) == want
    assert calibrate.Calibration(t_rt, card, native).batch_min == want
    assert jcal.Calibration(t_rt, card, native).batch_min == want
    if native - card <= 0:
        assert want == calibrate.CAL_MAX
    assert calibrate.CAL_MIN <= want <= calibrate.CAL_MAX


def test_grid_reaches_every_branch():
    bars = [calibrate.derive_batch_min(*t) for t in GRID]
    margins = [n - c for _, n, c in GRID]
    assert any(m == 0 for m in margins) and any(m < 0 for m in margins)
    assert bars.count(calibrate.CAL_MIN) > 5
    assert sum(b == calibrate.CAL_MAX for b, m in zip(bars, margins)
               if m > 0) > 5
    assert sum(calibrate.CAL_MIN < b < calibrate.CAL_MAX for b in bars) > 25
    assert calibrate.derive_batch_min(0.110, 85e-6, 61e-6) == 4584


def test_constants_are_the_jax_packages():
    for name in ("CAL_MAX_STEPS", "CAL_LANES_SMALL", "CAL_LANES_BIG",
                 "CAL_NATIVE_LANES", "CAL_OPS_PER_LANE", "CAL_MIN",
                 "CAL_MAX", "MESH_MIN_N_DEFAULT", "MESH_LANES_MIN_DEFAULT",
                 "MESH_NEVER", "MESH_CAL_SIZES"):
        assert getattr(calibrate, name) == getattr(jcal, name), name


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_corrupt_lanes_match_jax(seed):
    """The seeded lanes op for op (TestSyntheticLanes), deterministic,
    and every lane encodes in both packages' lane kernels."""
    mine = calibrate._corrupt_register_lanes(64, seed=seed)
    theirs = jcal._corrupt_register_lanes(64, seed=seed)
    assert [[o.to_dict() for o in h] for h in mine] == \
        [[o.to_dict() for o in h] for h in theirs]
    assert [[o.to_dict() for o in h] for h in mine] == \
        [[o.to_dict() for o in h] for h in
         calibrate._corrupt_register_lanes(64, seed=seed)]
    jm = mjit.for_model(CASRegister(None))
    assert all(wgl_vec.batch_eligible(jm, [make_entries(h)]) for h in mine)
    assert wgl_pallas_vec.batch_eligible(
        jjit.for_model(jmodels.CASRegister(None)),
        [jhist.entries(h) for h in theirs])


class TestFallbackChain:
    def test_no_calibration_on_the_cpu(self, monkeypatch):
        """device="cpu" never measures and never reads the record (the
        JAX package's CPU backend never calibrates)."""
        monkeypatch.setattr(calibrate, "_measure", _boom)
        monkeypatch.setattr(calibrate, "_load_disk_cache", _boom)
        assert calibrate.calibration("cpu") is None
        assert calibrate.batch_min("cpu") is None
        assert jcal.calibration() is None and jcal.batch_min() is None

    def test_default_device_without_cuda_raises(self):
        """None means the card, which is absent here (the device rule)."""
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(CudaUnavailable):
            calibrate.batch_min()

    def test_router_falls_back_to_the_table(self):
        for (engine, kind), b in lin_mod.GPU_BATCH_MIN.items():
            assert lin_mod.card_bar(engine, kind, "cpu") == b
        assert jlin_mod._pallas_batch_min() == jlin_mod.PALLAS_BATCH_MIN

    def test_fallback_reads_the_table_at_call_time(self, monkeypatch):
        monkeypatch.setattr(lin_mod, "GPU_BATCH_MIN",
                            {k: 4 for k in lin_mod.GPU_BATCH_MIN})
        assert lin_mod.card_bar("gpu_vec", "scalar", "cpu") == 4
        monkeypatch.setattr(jlin_mod, "PALLAS_BATCH_MIN", 4)
        assert jlin_mod._pallas_batch_min() == 4

    def test_pin_wins(self, monkeypatch):
        monkeypatch.setenv(calibrate._ENV, "123")
        monkeypatch.setenv(jcal._ENV, "123")
        calibrate.seed(calibrate.Calibration(0.02, 50e-6, 70e-6))
        assert calibrate.batch_min("cpu") == jcal.batch_min() == 123
        assert calibrate.batch_min() == 123  # no device is resolved
        assert lin_mod.card_bar("gpu_vec", "scalar", "cpu") == 123
        assert jlin_mod._pallas_batch_min() == 123

    @pytest.mark.parametrize("pin, want", [("0", 1), ("-5", 1),
                                           ("not-a-number", None),
                                           ("", None)])
    def test_pin_floor_and_garbage(self, monkeypatch, pin, want):
        """A pin is floored at 1; one that is not an integer is ignored,
        as in the JAX package."""
        monkeypatch.setenv(calibrate._ENV, pin)
        monkeypatch.setenv(jcal._ENV, pin)
        assert calibrate.batch_min("cpu") == jcal.batch_min() == want
        assert lin_mod.card_bar("gpu_vec", "scalar", "cpu") == (
            want or lin_mod.GPU_BATCH_MIN[lin_mod.CALIBRATED])

    def test_seed_installs_without_measuring(self, monkeypatch):
        """The bundle's warm start: `seed` makes a measurement this
        process's, on any device, and `_reset_for_tests` drops it."""
        monkeypatch.setattr(calibrate, "_measure", _boom)
        cal = calibrate.Calibration(0.11, 61e-6, 85e-6)
        calibrate.seed(cal)
        jcal.seed(jcal.Calibration(0.11, 61e-6, 85e-6))
        assert calibrate.calibration("cpu") == cal
        assert calibrate.batch_min("cpu") == cal.batch_min == \
            jcal.batch_min() == 4584
        calibrate._reset_for_tests()
        assert calibrate.calibration("cpu") is None

    def test_measured_bar_routes_only_its_key(self):
        """A measurement is K1's bar on scalar models; the other keys
        keep the table's bars (they have no measured counterpart)."""
        cal = calibrate.Calibration(t_rt=0.02, per_lane_card=50e-6,
                                    per_lane_native=70e-6)
        calibrate.seed(cal)
        for key, b in lin_mod.GPU_BATCH_MIN.items():
            want = 1024 if key == lin_mod.CALIBRATED else b
            assert lin_mod.card_bar(*key, "cpu") == want, key


def _boom(*a, **kw):
    raise AssertionError("must not be called")


class TestDiskCache:
    def test_cache_path_env(self, monkeypatch):
        """The record's path (TestDiskCache.test_cache_path_env)."""
        for mod in (calibrate, jcal):
            monkeypatch.setenv(mod._CACHE_ENV, "/some/where.json")
            assert mod.cache_path() == "/some/where.json"
            for off in ("off", "OFF", "0", "none", "None", ""):
                monkeypatch.setenv(mod._CACHE_ENV, off)
                assert mod.cache_path() is None
            monkeypatch.delenv(mod._CACHE_ENV)
        assert calibrate.cache_path().endswith(
            "/.cache/jepsen-tpu-torch/calibration.json")
        assert jcal.cache_path().endswith("/.cache/jepsen-tpu/"
                                          "calibration.json")

    def test_fingerprint_names_the_device_torch_and_cuda(self):
        fp = calibrate.device_fingerprint("cpu")
        assert fp == {"platform": "cpu", "device_kind": "cpu",
                      "capability": None,
                      "device_count": torch.cuda.device_count()
                      if torch.cuda.is_available() else 0,
                      "torch": torch.__version__, "cuda": torch.version.cuda}

    def test_roundtrip(self, tmp_path):
        cal = calibrate.Calibration(0.11, 61e-6, 85e-6)
        calibrate._save_disk_cache(cal, "cpu")
        assert calibrate._load_disk_cache("cpu") == cal
        rec = json.loads((tmp_path / "cal.json").read_text())
        assert rec == {"fingerprint": calibrate.device_fingerprint("cpu"),
                       "calibration": {"t_rt": 0.11, "per_lane_card": 61e-6,
                                       "per_lane_native": 85e-6}}

    @pytest.mark.parametrize("field", sorted(FAKE_FP))
    def test_stale_fingerprint_is_a_miss_and_overwritten(self, tmp_path,
                                                         field):
        """A record of another device, count, torch or CUDA does not
        route this one; the next write replaces it whole."""
        p = tmp_path / "cal.json"
        calibrate._save_disk_cache(calibrate.Calibration(0.11, 1e-6, 2e-6),
                                   "cpu")
        calibrate._update_disk_cache({"mesh_min_n": 512}, "cpu")
        rec = json.loads(p.read_text())
        rec["fingerprint"][field] = "another"
        p.write_text(json.dumps(rec))
        assert calibrate._load_disk_cache("cpu") is None
        assert calibrate._load_disk_mesh("cpu") is None
        cal = calibrate.Calibration(0.2, 3e-6, 4e-6)
        calibrate._save_disk_cache(cal, "cpu")
        rec = json.loads(p.read_text())
        assert rec["fingerprint"] == calibrate.device_fingerprint("cpu")
        assert "mesh_min_n" not in rec
        assert calibrate._load_disk_cache("cpu") == cal

    @pytest.mark.parametrize("text", ['{"fingerprint": ', "[1, 2]", "",
                                      '{"calibration": {"t_rt": 1}}'])
    def test_unreadable_record_is_a_miss(self, tmp_path, text):
        (tmp_path / "cal.json").write_text(text)
        (tmp_path / "jcal.json").write_text(text)
        assert calibrate._load_disk_cache("cpu") is None
        assert calibrate._load_disk_mesh("cpu") is None
        assert jcal._load_disk_cache() is None

    def test_disabled_record_never_touches_disk(self, tmp_path,
                                                monkeypatch):
        monkeypatch.setenv(calibrate._CACHE_ENV, "off")
        calibrate._save_disk_cache(calibrate.Calibration(0.1, 1e-6, 2e-6),
                                   "cpu")
        calibrate._update_disk_cache({"mesh_min_n": 7}, "cpu")
        assert calibrate._load_disk_cache("cpu") is None
        assert list(tmp_path.iterdir()) == []

    def test_mesh_and_calibration_sections_merge(self, tmp_path):
        """One record holds both crossovers under one fingerprint, as
        the JAX package's `_update_disk_cache` merges them."""
        cal = calibrate.Calibration(0.11, 61e-6, 85e-6)
        calibrate._update_disk_cache({"mesh_min_n": 512}, "cpu")
        calibrate._save_disk_cache(cal, "cpu")
        calibrate._update_disk_cache({"mesh_min_n": 2048}, "cpu")
        assert calibrate._load_disk_cache("cpu") == cal
        assert calibrate._load_disk_mesh("cpu") == 2048
        jcal._update_disk_cache(mesh_min_n=2048)
        jcal._save_disk_cache(jcal.Calibration(0.11, 61e-6, 85e-6))
        mine = json.loads((tmp_path / "cal.json").read_text())
        theirs = json.loads((tmp_path / "jcal.json").read_text())
        assert sorted(mine) == sorted(theirs) == ["calibration",
                                                  "fingerprint",
                                                  "mesh_min_n"]
        assert mine["mesh_min_n"] == theirs["mesh_min_n"]

    def test_mesh_crossover_is_kept_on_disk(self, monkeypatch):
        """With two cards, `mesh_min_n` is measured once and written to
        the record; a later process reads it back without measuring."""
        measured = []
        monkeypatch.setattr(calibrate, "_cards", lambda: 2)
        monkeypatch.setattr(calibrate, "device_fingerprint",
                            lambda device=None: FAKE_FP)
        monkeypatch.setattr(calibrate, "_measure_mesh_min_n",
                            lambda: measured.append(1) or 512)
        assert calibrate.mesh_min_n() == 512 and measured == [1]
        assert calibrate.measured_mesh_min_n() == 512
        calibrate._reset_for_tests()
        assert calibrate.mesh_min_n() == 512 and measured == [1]
        calibrate._reset_for_tests()
        calibrate.seed_mesh(64)
        assert calibrate.mesh_min_n() == 64 and measured == [1]


class Steered:
    """A "card" on the CPU: `calibrate._card` gives the CPU device, and
    the two walls are stubbed (card: t_rt + lanes * card; native: lanes *
    native), each call recorded."""

    def __init__(self, monkeypatch, t_rt=0.004, card=20e-6, native=300e-6):
        self.calls = []
        self.t_rt, self.card, self.native = t_rt, card, native
        monkeypatch.setattr(calibrate, "_card",
                            lambda device: torch.device("cpu"))
        monkeypatch.setattr(calibrate, "_card_wall", self.card_wall)
        monkeypatch.setattr(calibrate, "_native_wall", self.native_wall)

    def card_wall(self, model, ess, dev):
        self.calls.append(("card", len(ess)))
        return self.t_rt + len(ess) * self.card

    def native_wall(self, model, ess):
        self.calls.append(("native", len(ess)))
        return len(ess) * self.native


class TestMeasurement:
    def test_measure_arithmetic(self, monkeypatch):
        """One warm call, the best of two small calls, one big call and
        native on CAL_NATIVE_LANES lanes give the JAX package's fit."""
        walls = iter([9.0, 0.0070, 0.0066, 0.0250])
        calls = []

        def card_wall(model, ess, dev):
            calls.append(("card", len(ess)))
            assert all(es.n_completed for es in ess)
            return next(walls)

        monkeypatch.setattr(calibrate, "_card_wall", card_wall)
        monkeypatch.setattr(calibrate, "_native_wall", lambda model, ess: (
            calls.append(("native", len(ess))) or 0.0048))
        cal = calibrate._measure("cpu")
        assert calls == [("card", 128)] * 3 + [("card", 1024),
                                               ("native", 16)]
        slope = (0.0250 - 0.0066) / (1024 - 128)
        assert cal.per_lane_card == pytest.approx(slope, rel=1e-12)
        assert cal.t_rt == pytest.approx(0.0066 - 128 * slope, rel=1e-12)
        assert cal.per_lane_native == pytest.approx(0.0048 / 16, rel=1e-12)
        assert cal.batch_min == calibrate.derive_batch_min(
            cal.t_rt, cal.per_lane_native, cal.per_lane_card)

    def test_measure_clamps_a_negative_fit(self, monkeypatch):
        walls = iter([1.0, 0.02, 0.03, 0.01])
        monkeypatch.setattr(calibrate, "_card_wall",
                            lambda model, ess, dev: next(walls))
        monkeypatch.setattr(calibrate, "_native_wall",
                            lambda model, ess: 0.0)
        cal = calibrate._measure("cpu")
        assert cal == calibrate.Calibration(0.02, 0.0, 0.0)
        assert cal.batch_min == calibrate.CAL_MAX

    def test_walls_time_the_engines(self, monkeypatch):
        """The real walls call K1's `analysis_batch` at CAL_MAX_STEPS on
        the device, and native one lane at a time at the same cap."""
        seen = []
        monkeypatch.setattr(wgl_vec, "analysis_batch",
                            lambda model, ess, **kw: seen.append(
                                ("card", len(ess), kw)))
        monkeypatch.setattr(wgl_native, "analysis",
                            lambda model, es, **kw: seen.append(
                                ("native", 1, kw)))
        ess = [make_entries(h)
               for h in calibrate._corrupt_register_lanes(3, seed=7)]
        assert calibrate._card_wall(CASRegister(), ess,
                                    torch.device("cpu")) >= 0
        assert calibrate._native_wall(CASRegister(), ess) >= 0
        cap = calibrate.CAL_MAX_STEPS
        assert seen == [("card", 3, {"max_steps": cap,
                                     "device": torch.device("cpu")})] + \
            [("native", 1, {"max_steps": cap})] * 3

    def test_first_use_measures_and_keeps_it_on_disk(self, tmp_path,
                                                     monkeypatch):
        """A miss measures once a process and writes the record; the
        next process hits it and measures nothing."""
        s = Steered(monkeypatch)
        monkeypatch.setattr(wgl_native, "build", lambda: None)
        cal = calibrate.calibration()
        assert [c[0] for c in s.calls] == ["card"] * 4 + ["native"]
        assert calibrate.batch_min() == cal.batch_min
        assert calibrate.calibration() is cal and len(s.calls) == 5
        rec = json.loads((tmp_path / "cal.json").read_text())
        assert rec["fingerprint"] == calibrate.device_fingerprint("cpu")
        calibrate._reset_for_tests()
        assert calibrate.calibration() == cal and len(s.calls) == 5

    def test_stale_or_torn_record_is_measured_again(self, tmp_path,
                                                    monkeypatch):
        s = Steered(monkeypatch)
        monkeypatch.setattr(wgl_native, "build", lambda: None)
        p = tmp_path / "cal.json"
        calibrate.calibration()
        for spoil in ("stale", "torn"):
            if spoil == "stale":
                rec = json.loads(p.read_text())
                rec["fingerprint"]["device_kind"] = "another"
                p.write_text(json.dumps(rec))
            else:
                p.write_text('{"fingerprint": ')
            calibrate._reset_for_tests()
            n = len(s.calls)
            calibrate.calibration()
            assert len(s.calls) == n + 5, spoil
            rec = json.loads(p.read_text())
            assert rec["fingerprint"] == calibrate.device_fingerprint("cpu")

    def test_off_measures_every_process(self, tmp_path, monkeypatch):
        s = Steered(monkeypatch)
        monkeypatch.setattr(wgl_native, "build", lambda: None)
        monkeypatch.setenv(calibrate._CACHE_ENV, "off")
        calibrate.calibration()
        calibrate._reset_for_tests()
        calibrate.calibration()
        assert len(s.calls) == 10 and list(tmp_path.iterdir()) == []

    @pytest.mark.parametrize("where", ["card", "native", "build"])
    def test_a_failed_measurement_raises(self, monkeypatch, where):
        """A kernel fault, native's fault or a build that fails raises out
        of the measurement; nothing is cached, nothing written."""
        Steered(monkeypatch)
        err = {"card": KernelError("wgl_vec kernel launch failed"),
               "native": RuntimeError("CUDA error: an illegal memory "
                                      "access"),
               "build": wgl_native.NativeUnavailable("no g++")}[where]

        def fail(*a, **kw):
            raise err

        monkeypatch.setattr(wgl_native, "build",
                            fail if where == "build" else lambda: None)
        if where == "card":
            monkeypatch.setattr(calibrate, "_card_wall", fail)
        if where == "native":
            monkeypatch.setattr(calibrate, "_native_wall", fail)
        with pytest.raises(type(err)):
            calibrate.batch_min()
        assert calibrate._cached is False
        assert calibrate.cache_path() and calibrate._load_record("cpu") is None
        with pytest.raises(type(err)):
            lin_mod.card_bar("gpu_vec", "scalar")

    def test_ineligible_lanes_mean_the_committed_bar(self, monkeypatch):
        s = Steered(monkeypatch)
        monkeypatch.setattr(wgl_native, "build", lambda: None)
        monkeypatch.setattr(wgl_vec, "batch_eligible", lambda jm, ess: False)
        assert calibrate.calibration() is None and s.calls == []
        assert lin_mod.card_bar("gpu_vec", "scalar") == \
            lin_mod.GPU_BATCH_MIN[lin_mod.CALIBRATED]


def _port_ops(h):
    return [thist.Op.from_dict(o.to_dict()) for o in h]


def _normalise(d):
    d = json.loads(json.dumps(d, default=str))
    d.pop("supervision", None)
    return d


@pytest.mark.parametrize("n", [8, 1024])
def test_auto_at_a_seeded_bar_matches_jax(monkeypatch, n):
    """"auto" with the card present and a seeded Calibration (bar 1024):
    a batch at the bar goes to gpu_vec whole, with no native call; one
    under it takes the native triage and launches nothing. The dicts
    equal the JAX package's "auto" under the same bar, steered as
    tests/test_calibrate.py steers it (`_tpu_backend` and
    `calibrate.batch_min` monkeypatched; interpret mode)."""
    monkeypatch.setattr(lin_mod, "_card_present", lambda device: True)
    cal = calibrate.Calibration(0.001, 50e-6, 70e-6)
    calibrate.seed(cal)
    assert cal.batch_min == 1024
    monkeypatch.setattr(jcal, "batch_min", lambda: cal.batch_min)
    monkeypatch.setattr(jlin_mod, "_tpu_backend", lambda: True)
    native_calls = []
    real = wgl_native.analysis_batch
    monkeypatch.setattr(wgl_native, "analysis_batch", lambda *a, **kw: (
        native_calls.append(len(a[1])) or real(*a, **kw)))
    hists = [random_register_history(
        n_process=3, n_ops=6, seed=9700 + s,
        corrupt=0.4 if s % 3 == 0 else 0.0) for s in range(n)]
    jm = jmodels.CASRegister()
    want = jlinearizable(jm).check_batch({"model": jm},
                                         [(h, {}) for h in hists])
    m = CASRegister()
    monkeypatch.setattr(wgl_vec, "CAPTURE", [])
    got = linearizable(m, device="cpu").check_batch(
        {"model": m}, [(_port_ops(h), {}) for h in hists])
    lanes = sum(c[0].shape[1] for c in wgl_vec.CAPTURE)
    if n >= cal.batch_min:
        assert lanes >= n and native_calls == [], (lanes, native_calls)
    else:
        assert wgl_vec.CAPTURE == [] and native_calls == [n]
    assert [_normalise(d) for d in got] == [_normalise(d) for d in want]
    assert {d["valid"] for d in got} == {True, False}
