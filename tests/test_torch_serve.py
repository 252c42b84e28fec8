"""The port's resident verdict service (jepsen_tpu_torch.serve) and
`independent.pack_check`, against the JAX package's where both compute a
verdict: the durable queue's exactly-once, fairness, admission and
attempt-ledger cases (the JAX package's own cases), the bundle's
fingerprint and warm replay (nothing compiled: on the CPU the warm pass
runs the kernels' plain versions), pack_check's verdicts equal to the JAX
pack_check's and to one-shot checks, the registry's device and health,
and the daemon's HTTP surface on port 0 with the checks on the CPU. Also
the deliberate differences: a kernel fault inside pack_check raises, and
a daemon whose batch met one commits no verdict for it, leaves the jobs
in flight for the next start, names the fault on /healthz and answers
/readyz with 503."""

from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from jepsen_tpu import history as jhist
from jepsen_tpu import independent as jind
from jepsen_tpu import models as jmodels
from jepsen_tpu.checker.linearizable import linearizable as jlinearizable

from jepsen_tpu_torch import independent, store
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable, KernelError
from jepsen_tpu_torch.history import (index as index_history, invoke_op,
                                      ok_op)
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.ops import wgl_vec
from jepsen_tpu_torch.serve import (DurableQueue, EngineBundle,
                                    EngineRegistry, QueueFull)
from jepsen_tpu_torch.serve import bundle as bundle_mod
from jepsen_tpu_torch.serve import daemon as daemon_mod
from jepsen_tpu_torch.serve import registry as registry_mod
from jepsen_tpu_torch.serve import sacrifice

pytestmark = pytest.mark.chaos


def _register_history(k="x", good=True) -> list:
    """One keyed CAS-register history as it arrives over HTTP: plain JSON
    dicts, KVTuple values flattened to [k, v] lists."""
    v = 1 if good else 2  # read 2 after write 1 -> not linearizable
    return [
        {"process": 0, "type": "invoke", "f": "write", "value": [k, 1],
         "time": 0},
        {"process": 0, "type": "ok", "f": "write", "value": [k, 1],
         "time": 1},
        {"process": 1, "type": "invoke", "f": "read", "value": [k, None],
         "time": 2},
        {"process": 1, "type": "ok", "f": "read", "value": [k, v],
         "time": 3},
    ]


def normalise(v):
    """A verdict as the queue's JSON carries it, without the JAX
    package's supervision telemetry."""
    d = json.loads(json.dumps(store._json_keys(v),
                              default=store._json_default))
    d.pop("supervision", None)
    return d


def kernel_fault(*a, **kw):
    raise KernelError("injected launch failure")


def torch_error(*a, **kw):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


#: a fault of the card as a wrapper raises it, and as torch raises a
#: CUDA error that surfaces at a later sync; each with the type name
#: the daemon records
CARD_FAULTS = pytest.mark.parametrize("fault,fault_name", [
    (kernel_fault, "KernelError"), (torch_error, "RuntimeError"),
], ids=["kernel-error", "torch-error"])


def gpu_vec_workload() -> dict:
    """The register workload on K1's engine (its plain version on the
    CPU), so a patched K1 wrapper is reached without a card."""
    return {"checker": independent.checker(linearizable(
                CASRegister(), algorithm="gpu_vec", device="cpu")),
            "rehydrate": registry_mod._register_workload()["rehydrate"],
            "packable": True}


class TestDurableQueue:
    def test_submit_durable_before_ack(self, tmp_path):
        q = DurableQueue(str(tmp_path / "q"))
        jid = q.submit("alice", "register", _register_history())
        q2 = DurableQueue(str(tmp_path / "q"))
        assert q2.pending_ids() == [jid]
        assert q2.verdict(jid) is None

    def test_admission_bound_rejects_with_retry_hint(self, tmp_path):
        q = DurableQueue(str(tmp_path / "q"), max_pending=2,
                         retry_after_s=7.0)
        q.submit("a", "register", [])
        q.submit("a", "register", [])
        with pytest.raises(QueueFull) as ei:
            q.submit("b", "register", [])
        assert ei.value.pending == 2
        assert ei.value.retry_after_s == 7.0
        q.commit(q.pending_ids()[0], {"valid": True})
        q.submit("b", "register", [])

    def test_weighted_round_robin_fairness(self, tmp_path):
        q = DurableQueue(str(tmp_path / "q"))
        for _ in range(4):
            q.submit("alice", "register", [], weight=1)
            q.submit("bob", "register", [], weight=2)
        order = [(s["client"], s["seq"]) for s in q.take_batch()]
        assert order == [("alice", 0), ("bob", 1), ("bob", 3),
                         ("alice", 2), ("bob", 5), ("bob", 7),
                         ("alice", 4), ("alice", 6)]

    def test_exactly_once_across_restart(self, tmp_path):
        root = str(tmp_path / "q")
        q = DurableQueue(root)
        ids = [q.submit("a", "register", _register_history(str(i)))
               for i in range(3)]
        q.commit(ids[0], {"valid": True})
        q2 = DurableQueue(root)
        assert q2.pending_ids() == ids[1:]
        assert q2.verdict(ids[0]) == {"valid": True}
        q2.commit(ids[0], {"valid": False})
        assert q2.verdict(ids[0]) == {"valid": True}

    def test_unknown_id_raises(self, tmp_path):
        q = DurableQueue(str(tmp_path / "q"))
        with pytest.raises(KeyError):
            q.verdict("00000042-ghost")

    def test_wait_for_commit_after_streams_fresh_ids(self, tmp_path):
        q = DurableQueue(str(tmp_path / "q"))
        jid = q.submit("a", "register", [])
        assert q.wait_for_commit_after({jid}, timeout=0.01) == []
        t = threading.Timer(0.05, q.commit, (jid, {"valid": True}))
        t.start()
        assert q.wait_for_commit_after(set(), timeout=5.0) == [jid]
        t.join()


class TestAttemptLedger:
    def test_attempts_charged_durably_before_execution(self, tmp_path):
        root = str(tmp_path / "q")
        q = DurableQueue(root, max_attempts=3)
        jid = q.submit("a", "register", _register_history())
        q.begin_attempts([jid])
        q2 = DurableQueue(root, max_attempts=3)
        assert q2.attempts_of(jid) == 1
        assert q2.suspect_ids() == [jid]
        assert q2.take_batch() == []
        assert q2.take_suspect()["id"] == jid

    def test_recovery_dead_letters_at_max_attempts(self, tmp_path):
        root = str(tmp_path / "q")
        q = DurableQueue(root, max_attempts=2)
        jid = q.submit("a", "register", _register_history())
        ok = q.submit("b", "register", _register_history("y"))
        q.begin_attempts([jid])
        DurableQueue(root, max_attempts=2).begin_attempts([jid])
        q3 = DurableQueue(root, max_attempts=2)
        assert q3.verdict(jid) == {"valid": "unknown",
                                   "error": "quarantined"}
        assert q3.quarantined_ids() == [jid]
        assert q3.suspect_ids() == []
        assert [s["id"] for s in q3.take_batch()] == [ok]

    def test_commit_clears_suspicion(self, tmp_path):
        root = str(tmp_path / "q")
        q = DurableQueue(root)
        jid = q.submit("a", "register", [])
        q.begin_attempts([jid])
        q2 = DurableQueue(root)
        assert q2.suspect_ids() == [jid]
        q2.commit(jid, {"valid": True})
        assert q2.suspect_ids() == []
        assert DurableQueue(root, max_attempts=1).verdict(jid) == \
            {"valid": True}

    def test_refresh_done_absorbs_foreign_commit(self, tmp_path):
        root = str(tmp_path / "q")
        q = DurableQueue(root)
        jid = q.submit("a", "register", [])
        assert q.refresh_done(jid) is False
        DurableQueue(root).commit(jid, {"valid": True})
        assert q.refresh_done(jid) is True
        assert q.verdict(jid) == {"valid": True}

    def test_deadline_ms_anchored_at_submission(self, tmp_path):
        q = DurableQueue(str(tmp_path / "q"))
        jid = q.submit("a", "register", [], deadline_ms=5000)
        spec = q.take_batch()[0]
        assert spec["id"] == jid
        r = DurableQueue.remaining_s(spec)
        assert 0 < r <= 5.0
        spec2 = DurableQueue(str(tmp_path / "q")).take_batch()[0]
        assert abs(DurableQueue.remaining_s(spec2) - r) < 1.0
        assert DurableQueue.remaining_s({"deadline_ms": None}) is None


class TestBundle:
    @pytest.fixture(autouse=True)
    def _fresh_crossovers(self, tmp_path, monkeypatch):
        """No measurement in memory, the calibration record in a scratch
        file, no pin."""
        from jepsen_tpu_torch.checker import calibrate

        calibrate._reset_for_tests()
        monkeypatch.setenv(calibrate._CACHE_ENV, str(tmp_path / "cal.json"))
        monkeypatch.delenv(calibrate._ENV, raising=False)
        monkeypatch.delenv(calibrate._ENV_MESH_N, raising=False)
        yield
        calibrate._reset_for_tests()

    @pytest.fixture
    def quiet_bundle(self, tmp_path, monkeypatch):
        """A bundle whose warm pass is stubbed out: these cases exercise
        the fingerprint and manifest logic, nothing is built or run."""
        calls = []
        monkeypatch.setattr(
            EngineBundle, "_warm_engines",
            lambda self: calls.append("warm") or {"closure": [32]})
        return EngineBundle(str(tmp_path / "bundle"), device="cpu"), calls

    def test_cold_build_then_warm_replay(self, quiet_bundle):
        b, calls = quiet_bundle
        first = b.ensure()
        assert first["warm"] is False and calls == ["warm"]
        assert b.load_manifest()["fingerprint"] == \
            bundle_mod.fingerprint("cpu")
        second = b.ensure()
        # a warm start still runs every bucket once, and keeps the
        # manifest it found
        assert second["warm"] is True and calls == ["warm", "warm"]
        assert second["manifest"] == first["manifest"]
        assert second["elapsed_s"] >= 0

    @pytest.mark.parametrize("change", ["code", "bars", "calibration"])
    def test_any_fingerprint_change_rebuilds(self, quiet_bundle,
                                             monkeypatch, change):
        import importlib

        from jepsen_tpu_torch.checker import calibrate

        b, _ = quiet_bundle
        b.ensure()
        assert b.is_fresh()
        if change == "code":
            monkeypatch.setattr(bundle_mod, "code_digest", lambda: "beef")
        elif change == "calibration":
            fp = calibrate.device_fingerprint("cpu")
            monkeypatch.setattr(calibrate, "device_fingerprint",
                                lambda device=None: {**fp, "cuda": "99.9"})
        else:
            lin = importlib.import_module(
                "jepsen_tpu_torch.checker.linearizable")
            monkeypatch.setattr(lin, "GPU_BATCH_MIN",
                                {k: 2 for k in lin.GPU_BATCH_MIN})
        assert not b.is_fresh()
        assert b.ensure()["warm"] is False
        assert b.is_fresh()

    def test_manifest_carries_the_crossovers(self, quiet_bundle):
        """A built bundle keeps the calibration and the mesh crossover
        this process holds (None for each it has none of)."""
        from dataclasses import asdict

        from jepsen_tpu_torch.checker import calibrate

        b, _ = quiet_bundle
        m = b.ensure()["manifest"]
        assert m["calibration"] is None and m["mesh_min_n"] is None
        cal = calibrate.Calibration(0.004, 20e-6, 300e-6)
        calibrate.seed(cal)
        calibrate.seed_mesh(512)
        with open(b.manifest_path, "w") as f:
            f.write("{}")
        m = b.ensure()["manifest"]
        assert m["calibration"] == asdict(cal) and m["mesh_min_n"] == 512
        assert b.load_manifest() == m

    def test_warm_start_seeds_without_measuring(self, quiet_bundle,
                                                monkeypatch):
        """A fresh manifest's crossovers become a new process's own: no
        measurement, no read of the record."""
        from jepsen_tpu_torch.checker import calibrate

        b, _ = quiet_bundle
        cal = calibrate.Calibration(0.004, 20e-6, 300e-6)
        calibrate.seed(cal)
        calibrate.seed_mesh(512)
        b.ensure()
        calibrate._reset_for_tests()

        def boom(*a, **kw):
            raise AssertionError("a warm start measured")

        for name in ("_measure", "_measure_mesh_min_n", "_load_record"):
            monkeypatch.setattr(calibrate, name, boom)
        assert b.ensure()["warm"] is True
        assert calibrate.calibration("cpu") == cal
        assert calibrate.batch_min("cpu") == cal.batch_min == 1024
        assert calibrate.measured_mesh_min_n() == 512
        assert calibrate.mesh_min_n() == 512

    def test_cold_build_measures_unless_pinned(self, quiet_bundle,
                                               monkeypatch):
        """On a card, a stale bundle's build measures the calibration
        (steered here: `_card` gives the CPU, the walls are stubbed) and
        keeps it; under JEPSEN_TPU_TORCH_BATCH_MIN it measures nothing."""
        import torch

        from jepsen_tpu_torch.checker import calibrate
        from jepsen_tpu_torch.ops import wgl_native

        b, _ = quiet_bundle
        walls = []
        monkeypatch.setattr(calibrate, "_card",
                            lambda device: torch.device("cpu"))
        monkeypatch.setattr(wgl_native, "build", lambda: None)
        monkeypatch.setattr(calibrate, "_card_wall", lambda m, ess, dev: (
            walls.append(len(ess)) or 0.004 + 20e-6 * len(ess)))
        monkeypatch.setattr(calibrate, "_native_wall",
                            lambda m, ess: 300e-6 * len(ess))
        monkeypatch.setenv(calibrate._ENV, "4849")
        assert b.ensure()["manifest"]["calibration"] is None
        assert walls == []
        monkeypatch.delenv(calibrate._ENV)
        with open(b.manifest_path, "w") as f:
            f.write("{}")
        m = b.ensure()["manifest"]
        assert walls == [128, 128, 128, 1024]
        assert m["calibration"] == {"t_rt": pytest.approx(0.004),
                                    "per_lane_card": pytest.approx(20e-6),
                                    "per_lane_native": pytest.approx(300e-6)}

    def test_record_points_into_the_bundle(self, quiet_bundle, monkeypatch):
        """While a bundle is in use the calibration record is its
        calibration.json, unless the operator has pointed it elsewhere."""
        from jepsen_tpu_torch.checker import calibrate

        b, _ = quiet_bundle
        b.ensure()
        assert calibrate.cache_path() != b.calib_cache_path
        monkeypatch.delenv(calibrate._CACHE_ENV)
        b.ensure()
        assert calibrate.cache_path() == b.calib_cache_path == \
            os.path.join(b.root, "calibration.json")

    def test_torn_manifest_is_stale(self, quiet_bundle):
        b, _ = quiet_bundle
        b.ensure()
        with open(b.manifest_path, "w") as f:
            f.write('{"fingerprint": ')
        assert not b.is_fresh()
        assert b.ensure()["warm"] is False

    def test_fingerprint_names_sources_torch_and_device(self):
        import torch

        fp = bundle_mod.fingerprint("cpu")
        assert fp["torch"] == torch.__version__
        assert fp["device"] == "cpu" and fp["capability"] is None
        assert len(fp["code"]) == 64
        assert [k for k, _ in fp["gpu_batch_min"]] == sorted(
            [list(k) for k in importlib_lin().GPU_BATCH_MIN])
        with pytest.raises(CudaUnavailable):
            bundle_mod.fingerprint()

    def test_warm_pass_runs_every_bucket(self, tmp_path, monkeypatch):
        """The real warm pass on the CPU: every family's buckets, through
        each engine's plain version, one search a bucket; the native
        library's build step is patched, so nothing compiles."""
        captured = {}
        from jepsen_tpu_torch.ops import (closure, wgl_native, wgl_row,
                                          wgl_search)

        builds = []
        monkeypatch.setattr(wgl_native, "build", lambda: builds.append(1))

        mods = {"wgl_vec": wgl_vec, "wgl_row": wgl_row,
                "wgl_search": wgl_search}
        for m in mods.values():
            m.CAPTURE = []
        closure.CAPTURE = []
        try:
            out = EngineBundle(str(tmp_path / "b"), device="cpu").ensure()
            for name, m in mods.items():
                captured[name] = [c[3] for c in m.CAPTURE]
            captured["closure"] = [c[1] for c in closure.CAPTURE]
        finally:
            for m in mods.values():
                m.CAPTURE = None
            closure.CAPTURE = None
        assert out["warm"] is False and builds == [1]
        assert out["manifest"]["buckets"] == bundle_mod.DEFAULT_BUCKETS
        assert captured == bundle_mod.DEFAULT_BUCKETS


def importlib_lin():
    import importlib

    return importlib.import_module("jepsen_tpu_torch.checker.linearizable")


class TestPackCheck:
    @staticmethod
    def _jobs():
        def job(keys, good):
            ops = []
            for k in keys:
                ops.append(invoke_op(0, "write", independent.tuple_(k, 1)))
                ops.append(ok_op(0, "write", independent.tuple_(k, 1)))
                ops.append(invoke_op(1, "read",
                                     independent.tuple_(k, None)))
                ops.append(ok_op(1, "read", independent.tuple_(
                    k, 1 if good else 2)))
            return index_history(ops)
        return [job(["a", "b"], True), job(["c"], False),
                job(["d", "e", "f"], True), job([], True)]

    @staticmethod
    def _jax(h):
        return [jhist.Op.from_dict({**o.to_dict(), "value": jind.tuple_(
            o.value.key, o.value.value)}) for o in h]

    @pytest.mark.parametrize("algorithm", ["auto", "host"])
    def test_packed_verdicts_match_jax_and_one_shot(self, algorithm):
        """Packing is invisible in the verdicts: each job's equals the
        JAX pack_check's and the port's one-shot check of it alone."""
        chk = independent.checker(linearizable(
            CASRegister(), algorithm=algorithm, device="cpu"))
        jchk = jind.checker(jlinearizable(jmodels.CASRegister(None),
                                          algorithm=algorithm))
        test = {"name": "pack-equivalence"}
        jobs = self._jobs()
        packed = independent.pack_check(chk, test, jobs)
        assert [normalise(p) for p in packed] == \
            [normalise(chk.check(test, h, {})) for h in jobs]
        assert [normalise(p) for p in packed] == [normalise(p) for p in
            jind.pack_check(jchk, test, [self._jax(h) for h in jobs])]
        assert [p["valid"] for p in packed] == [True, False, True, True]

    def test_packed_on_k1_matches_one_shot(self, monkeypatch):
        """With the card's bars at 1 (K1's plain version here), every
        job's lanes go to K1 in ONE launch, and the verdicts equal the
        one-shot checks."""
        lin = importlib_lin()
        monkeypatch.setattr(lin, "_card_present", lambda device: True)
        monkeypatch.setattr(lin, "GPU_BATCH_MIN",
                            {k: 1 for k in lin.GPU_BATCH_MIN})
        monkeypatch.setattr(lin.calibrate, "batch_min",
                            lambda device=None: None)
        chk = independent.checker(linearizable(CASRegister(), device="cpu"))
        jobs = self._jobs()
        wgl_vec.CAPTURE = []
        try:
            packed = independent.pack_check(chk, {}, jobs)
            launches = len(wgl_vec.CAPTURE)
        finally:
            wgl_vec.CAPTURE = None
        assert launches == 1
        assert [normalise(p) for p in packed] == \
            [normalise(chk.check({}, h, {})) for h in jobs]

    def test_pack_falls_back_without_check_batch(self):
        class NoBatch:
            def check(self, test, history, opts=None):
                return {"valid": True, "n": len(history)}

        chk = independent.checker(NoBatch())
        out = independent.pack_check(chk, {"name": "t"}, self._jobs()[:2])
        assert [r["valid"] for r in out] == [True, True]

    @pytest.mark.parametrize("error", [KernelError, RuntimeError])
    def test_pack_check_kernel_fault_raises(self, monkeypatch, error):
        """A K1 launch that fails (or a torch error of the packed pass)
        raises from pack_check: no per-job fallback reads it as
        "unknown" (one key a job, which a per-job check would take
        through check_safe)."""
        def fault(*a, **kw):
            raise error("injected")

        monkeypatch.setattr(wgl_vec, "search", fault)
        jobs = [h for h in self._jobs() if len(h) == 4]
        assert len(jobs) == 1
        with pytest.raises(error):
            independent.pack_check(gpu_vec_workload()["checker"], {},
                                   jobs * 2)


class TestRegistry:
    def test_default_device_is_the_card(self):
        with pytest.raises(CudaUnavailable):
            EngineRegistry()

    def test_workloads_on_the_registry_device(self):
        reg = EngineRegistry(device="cpu")
        assert reg.workload("register")["checker"].checker.device == "cpu"
        assert reg.workload("cycle")["checker"].device == "cpu"
        assert reg.workload("cycle") is reg.workload("cycle")
        with pytest.raises(KeyError):
            reg.workload("nope")
        assert reg.known_workloads() == ["cycle", "register"]

    def test_health_and_topology_on_the_cpu(self):
        reg = EngineRegistry(device="cpu")
        h = reg.health()
        assert h["degraded"] is False and h["fault"] is None
        assert "memory" not in h
        assert reg.mesh_topology()["platform"] == "cpu"
        reg.record_fault(KernelError("x"), "test")
        assert reg.health()["degraded"] is True
        assert reg.health()["fault"]["error"] == "KernelError: x"

    def test_extra_workloads_module(self, monkeypatch):
        import sys
        import types

        mod = types.ModuleType("port_extra_workloads")

        def factory(device=None):
            return {"checker": None, "rehydrate": None, "packable": False,
                    "device": device}

        mod.WORKLOAD_FACTORIES = registry_mod.WORKLOAD_FACTORIES
        monkeypatch.setitem(sys.modules, "port_extra_workloads", mod)
        monkeypatch.setitem(registry_mod.WORKLOAD_FACTORIES, "extra",
                            factory)
        monkeypatch.setenv(registry_mod.WORKLOADS_ENV,
                           "port_extra_workloads, missing_module_x")
        assert registry_mod.load_extra_workloads() == [mod]
        assert EngineRegistry(device="cpu").workload("extra")["device"] \
            == "cpu"


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _http_code(fn, *a):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn(*a)
    return ei.value


class TestDaemonHTTP:
    @pytest.fixture
    def served(self, tmp_path):
        reg = EngineRegistry(None, device="cpu")
        q = DurableQueue(str(tmp_path / "q"), max_pending=4)
        server, dm = daemon_mod.serve(q, reg, port=0)
        base = f"http://127.0.0.1:{server.server_port}"
        yield base, q, dm
        dm.draining.set()
        server.shutdown()
        dm.join(timeout=10)

    def test_submit_check_verdict_roundtrip(self, served):
        base, _q, _dm = served
        for good in (False, True):
            code, body = _post(base + "/submit", {
                "client": "c1", "workload": "register",
                "history": _register_history("k", good=good)})
            assert code == 200
            code, body = _get(base + f"/verdict/{body['id']}?wait=120")
            assert code == 200
            assert body["verdict"]["valid"] is good

    def test_health_ready_stats(self, served):
        base, _q, dm = served
        code, health = _get(base + "/healthz")
        assert code == 200 and health["ok"] is True
        assert health["worker"] == {"alive": True, "deaths": 0,
                                    "last_death": None}
        assert health["fault"] is None and health["quarantined"] == []
        assert health["mesh"]["platform"] == "cpu"
        code, ready = _get(base + "/readyz")
        assert code == 200
        assert ready["bundle"] == {"present": False, "warm": False,
                                   "elapsed_s": None}
        assert ready["degraded"] is False and ready["device"] == "cpu"
        code, stats = _get(base + "/stats")
        assert code == 200 and stats["max_pending"] == 4
        dm.draining.set()
        assert _http_code(_get, base + "/readyz").code == 503
        assert _http_code(_post, base + "/submit", {
            "client": "c", "workload": "register",
            "history": []}).code == 503

    def test_unknown_workload_and_job(self, served):
        base, _q, _dm = served
        e = _http_code(_post, base + "/submit",
                       {"client": "c", "workload": "nope", "history": []})
        assert e.code == 400
        assert "register" in json.loads(e.read())["workloads"]
        assert _http_code(_get, base + "/verdict/00000099-ghost").code == 404
        assert _http_code(_post, base + "/submit", {
            "client": "c", "workload": "register", "history": {},
        }).code == 400

    def test_queue_full_maps_to_429_with_retry_after(self, tmp_path):
        reg = EngineRegistry(None, device="cpu")
        q = DurableQueue(str(tmp_path / "q"), max_pending=0,
                         retry_after_s=9.0)
        server, dm = daemon_mod.serve(q, reg, port=0)
        try:
            e = _http_code(_post, f"http://127.0.0.1:{server.server_port}"
                           "/submit", {"client": "c", "workload": "register",
                                       "history": _register_history()})
            assert e.code == 429
            assert e.headers["Retry-After"] == "9"
            assert json.loads(e.read())["retry_after_s"] == 9.0
        finally:
            dm.draining.set()
            server.shutdown()

    def test_worker_death_is_detected_and_survived(self, served):
        base, q, dm = served
        real = q.take_batch
        tripped = threading.Event()

        def boom(*a, **kw):
            if not tripped.is_set():
                tripped.set()
                raise RuntimeError("injected worker death")
            return real(*a, **kw)

        q.take_batch = boom
        _, body = _post(base + "/submit", {
            "client": "c1", "workload": "register",
            "history": _register_history()})
        code, v = _get(base + f"/verdict/{body['id']}?wait=120")
        assert code == 200 and v["verdict"]["valid"] is True
        _, health = _get(base + "/healthz")
        assert health["ok"] is True and health["worker"]["deaths"] == 1
        assert "injected worker death" in \
            health["worker"]["last_death"]["error"]

    def test_deadline_expired_before_start_commits_unknown(self, served):
        base, _q, _dm = served
        _, body = _post(base + "/submit", {
            "client": "c1", "workload": "register",
            "history": _register_history(), "deadline_ms": 1})
        code, v = _get(base + f"/verdict/{body['id']}?wait=120")
        assert code == 200
        assert v["verdict"] == {"valid": "unknown", "error": "deadline"}

    def test_stream_lists_committed_verdicts(self, served):
        base, q, dm = served
        jid = q.submit("c", "register", _register_history())
        assert q.wait_for_verdict(jid, timeout=120)["valid"] is True
        dm.draining.set()
        with urllib.request.urlopen(base + "/stream", timeout=60) as r:
            recs = [json.loads(x) for x in r.read().splitlines()]
        assert [x["id"] for x in recs] == [jid]


@CARD_FAULTS
@pytest.mark.parametrize("deadline_ms", [None, 600_000],
                         ids=["packed", "deadline"])
def test_daemon_kernel_fault_commits_nothing(tmp_path, monkeypatch,
                                             deadline_ms, fault, fault_name):
    """A K1 launch that fails (or a CUDA error torch raises) inside the
    worker's batch (packed, or a deadline job checked alone) commits no
    verdict: the jobs stay in flight in the attempt ledger, so the next
    start blames them; the fault is recorded, named on /healthz, /readyz
    answers 503, and the worker takes no more work."""
    monkeypatch.setattr(wgl_vec, "search", fault)
    reg = EngineRegistry(None, device="cpu")
    reg._workloads["register"] = gpu_vec_workload()
    root = str(tmp_path / "q")
    q = DurableQueue(root)
    ids = [q.submit("c", "register", _register_history(k),
                    deadline_ms=deadline_ms) for k in "ab"]
    server, dm = daemon_mod.serve(q, reg, port=0)
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        dm.join(timeout=60)
        assert not dm._worker.is_alive()
        assert dm.faulted and fault_name in dm.last_fault["error"]
        assert [q.verdict(j) for j in ids] == [None, None]
        _, health = _get(base + "/healthz")
        assert health["ok"] is False
        assert health["fault"]["error"].startswith(fault_name)
        e = _http_code(_get, base + "/readyz")
        assert e.code == 503 and json.loads(e.read())["degraded"] is True
    finally:
        dm.draining.set()
        server.shutdown()
    restarted = DurableQueue(root)
    assert restarted.suspect_ids() == ids
    assert restarted.take_batch() == []


def test_daemon_ordinary_workload_error_commits_unknown(tmp_path):
    """A workload whose check raises an ordinary exception commits
    "unknown: workload ... failed" (the JAX package's behaviour) and the
    daemon stays ready."""
    class Broken:
        def check(self, test, history, opts=None):
            raise ValueError("broken workload")

    reg = EngineRegistry(None, device="cpu")
    reg._workloads["broken"] = {"checker": Broken(), "rehydrate": None,
                                "packable": False}
    q = DurableQueue(str(tmp_path / "q"))
    dm = daemon_mod.VerdictDaemon(q, reg)
    dm.start()
    try:
        jid = q.submit("c", "broken", [])
        v = q.wait_for_verdict(jid, timeout=60)
    finally:
        dm.draining.set()
        dm.join(timeout=10)
    assert v["valid"] == "unknown" and not dm.faulted


def test_sacrificial_subprocess_commits_suspect(tmp_path, monkeypatch):
    """A job a dead daemon blamed runs in `python -m
    jepsen_tpu_torch.serve.sacrifice ... --device cpu` after the healthy
    backlog, whose verdict the daemon absorbs from the disk."""
    root = str(tmp_path / "q")
    q = DurableQueue(root)
    suspect = q.submit("a", "register", _register_history("s", good=False))
    q.begin_attempts([suspect])
    q = DurableQueue(root)
    healthy = q.submit("b", "register", _register_history("h"))
    assert q.suspect_ids() == [suspect]
    monkeypatch.setattr(daemon_mod, "SUSPECT_BACKOFF_S", 0.01)
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dm = daemon_mod.VerdictDaemon(q, EngineRegistry(None, device="cpu"))
    dm.start()
    try:
        assert q.wait_for_verdict(healthy, timeout=120)["valid"] is True
        assert q.wait_for_verdict(suspect, timeout=300)["valid"] is False
    finally:
        dm.draining.set()
        dm.join(timeout=10)
    assert q.attempts_of(suspect) == 2 and q.suspect_ids() == []


@CARD_FAULTS
def test_sacrifice_fault_exits_without_commit(tmp_path, monkeypatch, fault,
                                              fault_name):
    """A fault of the card in the sacrificial check (a failed launch, or
    a CUDA error torch raises) commits nothing and exits FAULT_EXIT."""
    monkeypatch.setattr(wgl_vec, "search", fault)
    monkeypatch.setitem(registry_mod.WORKLOAD_FACTORIES, "register",
                        lambda device=None: gpu_vec_workload())
    root = str(tmp_path / "q")
    jid = DurableQueue(root).submit("a", "register",
                                    _register_history())
    code = sacrifice.main([root, jid, "--device", "cpu"])
    assert code == daemon_mod.FAULT_EXIT
    assert DurableQueue(root).verdict(jid) is None


def _spawn_listening(args, cwd, env, pattern):
    """Start `args` and read its stderr until a line matches `pattern`
    (whose group 1 is the bound port); returns the process, the port and
    the reader thread, which drains stderr until the process exits."""
    import re
    import subprocess

    proc = subprocess.Popen(args, cwd=cwd, env=env, stderr=subprocess.PIPE,
                            text=True)
    ports: list = []
    listening = threading.Event()

    def read_port():
        for line in proc.stderr:
            m = re.search(pattern, line)
            if m and not ports:
                ports.append(int(m.group(1)))
                listening.set()

    reader = threading.Thread(target=read_port, daemon=True)
    reader.start()
    if not listening.wait(timeout=120):
        proc.kill()
        proc.wait()
        raise AssertionError(f"{args} never listened")
    return proc, ports[0], reader


def test_serve_daemon_cli_round_trip_and_sigterm(tmp_path):
    """`python -m jepsen_tpu_torch serve --daemon --device cpu -p 0`
    warms its bundle, answers a submission over HTTP, and the first
    SIGTERM drains it: exit 143. Without --daemon it serves the store's
    web UI, and a SIGTERM exits it 143 too."""
    import signal
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    base = [sys.executable, "-m", "jepsen_tpu_torch", "serve",
            "--device", "cpu", "-p", "0",
            "--queue-dir", str(tmp_path / "q")]
    proc, port, reader = _spawn_listening(
        base, str(tmp_path), env, r"Listening on http://[^:]+:(\d+)/")
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                    timeout=60) as r:
            assert r.status == 200 and b"<h1>Jepsen-TPU</h1>" in r.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        proc.stderr.close()
    proc, port, reader = _spawn_listening(
        base + ["--daemon"], str(tmp_path), env,
        r"verdict daemon on http://[^:]+:(\d+)/")
    try:
        url = f"http://127.0.0.1:{port}"
        _, body = _post(url + "/submit", {
            "client": "c", "workload": "register",
            "history": _register_history(good=False)})
        _, v = _get(url + f"/verdict/{body['id']}?wait=120")
        assert v["verdict"]["valid"] is False
        _, ready = _get(url + "/readyz")
        assert ready["bundle"]["present"] and not ready["bundle"]["warm"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
        proc.stderr.close()
