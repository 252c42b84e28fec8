"""Mesh doctor: are these devices safe to check verdicts on? (The port's
counterpart of `tools/mesh_doctor.py`'s `diagnose`, driven by
`python -m jepsen_tpu_torch doctor`.)

It reports, as one JSON-able dict:

topology
    the platform, the device list and each device's name (the shape the
    serving registry's `mesh_topology` shows).
per-device parity
    a small WGL lane batch (a third of the lanes corrupt) through K2 on
    EACH device of the list alone, its verdicts against the host search:
    a device that computes wrong verdicts is named, not averaged away.
mesh parity
    the same lanes dealt longest-first over the whole list (K2's deal),
    a batch of several blocks of lanes over K1's block shards, and a
    closure batch through K3's row-block squaring, each against the host
    search or the host DFS, with its wall.
memory headroom
    each CUDA device's free and total bytes (`torch.cuda.mem_get_info`).

A device list may repeat a device (`["cuda:0"] * 2` examines the deal
and the shards on one card; `["cpu"] * 3` the plain versions, the
counterpart of the JAX package's virtual CPU mesh). A device that raises
is a finding: its entry carries the error and the report is not ok.
"""

from __future__ import annotations

import time

import numpy as np

from . import device as device_mod
from .history import entries as make_entries
from .models import CASRegister
from .ops import closure, closure_host, wgl_host, wgl_search, wgl_vec
from .workloads.register import register_history


def _wgl_lanes(n_lanes: int) -> list:
    """Seeded register lanes of 4 to 28 invocations, every third one
    corrupt, so parity covers refutations too (mesh_doctor's lanes)."""
    return [make_entries(register_history(
        n_process=3, n_ops=4 + 3 * (s % 9), seed=1000 + s,
        corrupt=0.3 if s % 3 == 0 else 0.0)) for s in range(n_lanes)]


def _k1_lanes(n_devices: int) -> list:
    """Several 128-lane blocks of register lanes of 10 invocations, every
    fourth one corrupt (`__graft_entry__.dryrun_multichip`'s K1 mesh
    lanes)."""
    return [make_entries(register_history(
        n_process=3, n_ops=10, seed=4000 + s,
        corrupt=0.3 if s % 4 == 0 else 0.0))
        for s in range(wgl_vec.LANES * n_devices + 7)]


def _memory(dev) -> dict | None:
    if dev.type != "cuda":
        return None
    import torch

    free, total = torch.cuda.mem_get_info(dev)
    return {"free_bytes": int(free), "total_bytes": int(total)}


def _describe(k: int, dev) -> dict:
    out = {"id": k, "device": str(dev),
           "kind": device_mod.describe(dev)["name"]}
    mem = _memory(dev)
    if mem:
        out["memory"] = mem
    return out


def _mismatches(rs, oracle) -> int:
    return sum(1 for r, o in zip(rs, oracle) if r.valid != o)


def diagnose(devices=None, closure_n: int = 100) -> dict:
    """Examine `devices` (a list for `device.devices`; None: every CUDA
    device) and return the report (module docstring); report["ok"] is
    True when every device and every mesh path agreed with the host."""
    devs = device_mod.devices(devices)
    report: dict = {
        "platform": "gpu" if devs[0].type == "cuda" else "cpu",
        "n_devices": len(devs),
        "devices": [_describe(k, d) for k, d in enumerate(devs)],
    }
    model = CASRegister()
    ess = _wgl_lanes(3 * len(devs) + 1)  # uneven: the deal pads
    oracle = [wgl_host.analysis(model, es).valid for es in ess]

    per_dev = []
    for k, d in enumerate(devs):
        try:
            bad = _mismatches(wgl_search.analysis_batch(model, ess,
                                                        devices=[d]), oracle)
            per_dev.append({"id": k, "ok": bad == 0,
                            **({"mismatches": bad} if bad else {})})
        except Exception as e:  # noqa: BLE001 — a dead device is a finding
            per_dev.append({"id": k, "ok": False,
                            "error": f"{type(e).__name__}: {e}"})
    report["per_device"] = per_dev

    def run(name, fn, **fields) -> None:
        t0 = time.perf_counter()
        try:
            bad = fn()
            report[name] = {"ok": bad == 0, **fields,
                            "wall_s": time.perf_counter() - t0,
                            **({"mismatches": bad} if bad else {})}
        except Exception as e:  # noqa: BLE001 — a finding, as above
            report[name] = {"ok": False, **fields,
                            "error": f"{type(e).__name__}: {e}"}

    run("wgl_mesh", lambda: _mismatches(
        wgl_search.analysis_batch(model, ess, devices=devs), oracle),
        lanes=len(ess))

    pess = _k1_lanes(len(devs))
    poracle = [wgl_host.analysis(model, es).valid for es in pess]

    def k1() -> int:
        rs = wgl_vec.analysis_batch(model, pess, devices=devs)
        bad = _mismatches(rs, poracle)
        # the refuted lanes' counterexamples come back through the shards
        return bad + sum(1 for r in rs if r.valid is False and r.op is None
                         and not r.best_linearization)

    run("wgl_vec_mesh", k1, lanes=len(pess),
        refuted=sum(1 for o in poracle if o is False))

    rng = np.random.default_rng(17)
    mats = [rng.random((n, n)) < (4.0 / max(n, 1))
            for n in (closure_n, closure_n // 2 + 1, 7)]
    want = closure_host.reach_batch(mats)
    run("closure_mesh", lambda: sum(
        1 for w, g in zip(want, closure.reach_batch(mats, devices=devs))
        if not np.array_equal(w, g)),
        n=[int(m.shape[0]) for m in mats])

    report["ok"] = (all(d["ok"] for d in per_dev)
                    and all(report[k]["ok"] for k in
                            ("wgl_mesh", "wgl_vec_mesh", "closure_mesh")))
    return report
