"""The session-scoped engine registry (the port's counterpart of
`jepsen_tpu/serve/registry.py`).

The workload table maps a job spec's workload name to the checker that
decides it; the `watch` CLI and the verdict daemon share it, so streamed,
queued and one-shot verdicts are one computation. The registry holds, for
the daemon's whole life, that table's checkers (built once, on the
registry's device), the engine bundle, the resolved device and the faults
the daemon met.

The JAX package's registry delegates to its supervisor singletons
(circuit breakers and rung demotion). The port has no supervisor: a
kernel that fails to build or launch raises, the daemon records the
fault here, and `health()` reports the registry degraded from those
faults.
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger("jepsen_tpu_torch.serve.registry")


def _register_workload(device=None) -> dict:
    """Keyed CAS-register histories: the independent checker over the
    linearizable search — the checker a one-shot
    `independent.checker(linearizable(CASRegister()))` run builds, so
    daemon verdicts and CLI verdicts are the same computation."""
    from ..checker import linearizable
    from ..independent import checker as indep_checker, tuple_
    from ..models import CASRegister

    def rehydrate(op):
        # HTTP submissions arrive as JSON: KVTuple values flattened to
        # [k, v] lists. Client ops of this workload are ALWAYS keyed, so
        # any 2-element list value on a client op rebuilds the tuple;
        # nemesis/info ops pass through.
        v = op.value
        if (op.process != "nemesis" and isinstance(v, (list, tuple))
                and len(v) == 2):
            return op.with_(value=tuple_(v[0], v[1]))
        return op

    return {"checker": indep_checker(
                linearizable(CASRegister(None), device=device)),
            "rehydrate": rehydrate,
            "packable": True}


def _cycle_workload(device=None) -> dict:
    """Transactional list-append histories for the cycle checker; txn
    values are JSON-native nested lists and need no rehydration."""
    from ..checker import cycle

    return {"checker": cycle.checker(device=device),
            "rehydrate": None,
            "packable": False}


#: workload name -> spec factory(device=None); a job spec's "workload"
#: field picks one. Factories run lazily, on the device they are given
#: (None = the card).
WORKLOAD_FACTORIES = {
    "register": _register_workload,
    "cycle": _cycle_workload,
}

#: comma-separated module names registering extra workload factories
#: (imported for their WORKLOAD_FACTORIES side effects; each factory
#: takes `device`)
WORKLOADS_ENV = "JEPSEN_TPU_TORCH_SERVE_WORKLOADS"


def load_extra_workloads() -> list:
    """Import every module named by JEPSEN_TPU_TORCH_SERVE_WORKLOADS;
    each registers its factories into WORKLOAD_FACTORIES at import time.
    Called by the daemon AND the sacrificial subprocess, so a job's
    workload exists wherever the job runs."""
    import importlib
    import os

    mods = []
    for name in (os.environ.get(WORKLOADS_ENV) or "").split(","):
        name = name.strip()
        if not name:
            continue
        try:
            mods.append(importlib.import_module(name))
        except ImportError:
            log.exception("cannot import workloads module %s", name)
    return mods


class EngineRegistry:
    """One session's workloads, bundle state, device and faults.

    bundle  a serve.bundle.EngineBundle, or None
    device  where the workloads' checkers run: None = the card (raising
            when CUDA is absent), "cpu" = the kernels' plain versions
    """

    def __init__(self, bundle=None, device=None):
        from ..device import resolve

        self.bundle = bundle
        self.device = device
        self.dev = resolve(device)
        self.bundle_state: dict = {}   # EngineBundle.ensure() result
        self.faults: list = []         # every fault the daemon met
        self._workloads: dict = {}
        self._topology: dict | None = None
        self._lock = threading.Lock()

    # -- bundle ------------------------------------------------------------

    def warm(self) -> dict:
        """Build or load every kernel and run each bucket once (no-op
        without a bundle). Returns the ensure() result."""
        if self.bundle is not None:
            self.bundle_state = self.bundle.ensure()
        return self.bundle_state

    # -- workloads ---------------------------------------------------------

    def workload(self, name: str) -> dict:
        """The (cached) workload spec for a job's workload name."""
        with self._lock:
            spec = self._workloads.get(name)
            if spec is None:
                factory = WORKLOAD_FACTORIES.get(name)
                if factory is None:
                    raise KeyError(f"unknown workload {name!r}")
                spec = factory(device=self.device)
                self._workloads[name] = spec
            return spec

    def known_workloads(self) -> list:
        return sorted(WORKLOAD_FACTORIES)

    # -- faults ------------------------------------------------------------

    def record_fault(self, exc: BaseException, where: str) -> dict:
        """Keep one fault of the card or of a build; returns its
        record."""
        rec = {"error": f"{type(exc).__name__}: {exc}", "where": where,
               "time": time.time()}
        with self._lock:
            self.faults.append(rec)
        return rec

    @property
    def last_fault(self) -> dict | None:
        with self._lock:
            return self.faults[-1] if self.faults else None

    # -- health ------------------------------------------------------------

    def memory_state(self) -> dict | None:
        """The card's memory (free and total from cudaMemGetInfo, and
        the caching allocator's bytes), for /readyz: an orchestrator can
        rotate a daemon whose memory is running out. None on the CPU."""
        if self.dev.type != "cuda":
            return None
        import torch

        free, total = torch.cuda.mem_get_info(self.dev)
        stats = torch.cuda.memory_stats(self.dev)
        return {"free_bytes": int(free), "total_bytes": int(total),
                "allocated_bytes": int(stats.get(
                    "allocated_bytes.all.current", 0)),
                "reserved_bytes": int(stats.get(
                    "reserved_bytes.all.current", 0)),
                "peak_allocated_bytes": int(stats.get(
                    "allocated_bytes.all.peak", 0))}

    def mesh_topology(self) -> dict:
        """The cards this daemon checks on — platform, count, names and
        compute capabilities — and whether the mesh routes are open
        (`mesh_routes`: the registry checks on the default device and
        `device.mesh` lists two or more cards, so "wgl_mesh" and
        "closure_mesh" deal a batch that reaches their bars), for
        /healthz. Static per registry, so computed once: /healthz is a
        liveness probe and must stay cheap."""
        if self._topology is None:
            from ..device import mesh

            if self.dev.type != "cuda":
                self._topology = {"platform": "cpu", "devices": 0,
                                  "kinds": [], "capabilities": []}
            else:
                import torch

                n = torch.cuda.device_count()
                self._topology = {
                    "platform": "gpu", "devices": n,
                    "kinds": sorted({torch.cuda.get_device_name(i)
                                     for i in range(n)}),
                    "capabilities": sorted({
                        "%d.%d" % torch.cuda.get_device_capability(i)
                        for i in range(n)})}
            is_open = mesh(self.device) is not None
            self._topology["mesh_routes"] = {"wgl_mesh": is_open,
                                             "closure_mesh": is_open}
        return self._topology

    def health(self) -> dict:
        """The readiness picture: device, bundle warmth, the card's
        memory, and the faults recorded (degraded iff any)."""
        out = {
            "device": str(self.dev),
            "bundle": {
                "present": self.bundle is not None,
                "warm": bool(self.bundle_state.get("warm")),
                "elapsed_s": self.bundle_state.get("elapsed_s"),
            },
        }
        mem = self.memory_state()
        if mem:
            out["memory"] = mem
        fault = self.last_fault
        out["degraded"] = fault is not None
        out["fault"] = fault
        return out
