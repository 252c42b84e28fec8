"""The engine bundle: a daemon start that has every kernel built, loaded
and launched once before the first job, and a manifest that says whether
this start found the code, the toolchain and the card it was made for
(the port's counterpart of `jepsen_tpu/serve/bundle.py`).

A bundle directory holds ``bundle.json``, the manifest: a
**fingerprint** (the digests of the kernel sources in ops/csrc/ — the
cache key of ops/_build.py —, the torch and CUDA versions, the device's
name and compute capability, GPU_BATCH_MIN, and the bundle format) and
the buckets its warm pass ran.

``ensure()`` builds or loads each kernel library through ops/_build.py
(whose own cache is keyed by source digest and capability) and runs
each bucket of each kernel family once on the registry's device: K1
(wgl_vec) and K5 (wgl_row) at n_pad 32 and 64, K2 (wgl_search) at n_pad
32 and 64, and K3 (closure) at pads 32 and 64 — so a daemon's first job
pays no build, module load or shared-memory opt-in. A fresh manifest
(every fingerprint field equal) makes the start ``warm``; a stale or
torn one is rewritten. A kernel that fails to build or launch raises:
the warm pass is not best-effort. With two or more cards and the
default device (`device.mesh`), the warm pass also deals K2 over every
card at n_pad 32 (`search_mesh`) and shards K3's rows at pad 64
(`closure_mesh`), and the fingerprint carries the card count; with one
card none of this changes. The JAX package's persisted calibration has
no counterpart (the port's bars are constants, fingerprinted here; the
mesh crossover is measured in the process).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time

log = logging.getLogger("jepsen_tpu_torch.serve.bundle")

MANIFEST_FILE = "bundle.json"

#: bump on any change to what warming covers or how the manifest reads
BUNDLE_FORMAT = 1

#: each kernel family's warm buckets (the n_pads / pad sizes a bucket
#: of its launches takes)
DEFAULT_BUCKETS = {"wgl_vec": [32, 64], "wgl_row": [32, 64],
                   "wgl_search": [32, 64], "closure": [32, 64]}
#: ...and the mesh routes', warmed with two or more cards
MESH_BUCKETS = {"search_mesh": [32], "closure_mesh": [64]}


def buckets(device=None) -> dict:
    """The warm pass's buckets: DEFAULT_BUCKETS, and MESH_BUCKETS when
    `device.mesh(device)` lists two or more cards."""
    from ..device import mesh

    if mesh(device) is None:
        return dict(DEFAULT_BUCKETS)
    return {**DEFAULT_BUCKETS, **MESH_BUCKETS}


def code_digest() -> str:
    """sha256 over the kernel sources (ops/csrc/*), name and bytes."""
    from ..ops import _build

    h = hashlib.sha256()
    for name in sorted(os.listdir(_build.CSRC)):
        h.update(name.encode())
        with open(os.path.join(_build.CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def fingerprint(device=None) -> dict:
    """Everything that can change what a built kernel computes, where it
    runs or how "auto" routes: the sources, torch and CUDA, the device,
    and the measured bars."""
    import importlib

    import torch

    from ..device import describe, mesh

    lin = importlib.import_module("jepsen_tpu_torch.checker.linearizable")
    d = describe(device)
    fp = {"format": BUNDLE_FORMAT, "code": code_digest(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": d["name"], "capability": d["capability"],
          "gpu_batch_min": sorted(
              [list(k), v] for k, v in lin.GPU_BATCH_MIN.items())}
    cards = mesh(device)
    if cards is not None:
        fp["cards"] = len(cards)
    return fp


def _writes(n: int) -> list:
    """`n` sequential write invocations of one process: `n` entries that
    the search linearizes in n steps."""
    from ..history import index, invoke_op, ok_op

    ops = []
    for i in range(n):
        ops.append(invoke_op(0, "write", i))
        ops.append(ok_op(0, "write", i))
    return index(ops)


def _probe_search_bucket(mod, n_pad: int, device) -> None:
    """One launch of a WGL engine (`mod`: wgl_vec, wgl_row or
    wgl_search) in the `n_pad` bucket: a CAS-register history of
    n_pad // 2 + 1 entries, which pads to exactly n_pad."""
    from ..history import entries as make_entries
    from ..models import CASRegister

    es = make_entries(_writes(n_pad // 2 + 1))
    (r,) = mod.analysis_batch(CASRegister(None), [es], device=device)
    if r.valid is not True:
        raise AssertionError(f"{mod.__name__} warm lane at n_pad {n_pad}: "
                             f"{r.valid}")


def _probe_search_mesh_bucket(n_pad: int, devices) -> None:
    """One K2 batch dealt over `devices` in the `n_pad` bucket: 2*D + 1
    lanes (the chunks padded with empty lanes) of n_pad // 2 + 1
    entries."""
    from ..history import entries as make_entries
    from ..models import CASRegister
    from ..ops import wgl_search

    ess = [make_entries(_writes(n_pad // 2 + 1))
           for _ in range(2 * len(devices) + 1)]
    rs = wgl_search.analysis_batch(CASRegister(None), ess, devices=devices)
    if any(r.valid is not True for r in rs):
        raise AssertionError(f"wgl_search mesh warm lanes at n_pad {n_pad}")


def _probe_closure_mesh_bucket(pad: int, devices) -> None:
    """One closure with its rows sharded over `devices` in the `pad`
    bucket: the 2-cycle of _probe_closure_bucket."""
    import numpy as np

    from ..ops import closure

    a = np.zeros((pad // 2 + 1,) * 2, dtype=bool)
    a[0, 1] = a[1, 0] = True
    (got,) = closure.reach_batch([a], devices=devices)
    if not (got[0, 0] and got[1, 1]) or got.sum() != 4:
        raise AssertionError(f"closure mesh warm bucket {pad}: wrong "
                             "closure")


def _probe_closure_bucket(pad: int, device) -> None:
    """One closure fixpoint in the `pad` bucket: a 2-cycle in a matrix
    of pad // 2 + 1 nodes."""
    import numpy as np

    from ..ops import closure

    a = np.zeros((pad // 2 + 1,) * 2, dtype=bool)
    a[0, 1] = a[1, 0] = True
    got = closure.reach(a, device=device)
    if not (got[0, 0] and got[1, 1]) or got.sum() != 4:
        raise AssertionError(f"closure warm bucket {pad}: wrong closure")


class EngineBundle:
    """One bundle directory. ``ensure()`` is the entry point the daemon
    needs: warm every bucket, then decide fresh or stale."""

    def __init__(self, root: str, device=None):
        self.root = os.path.abspath(root)
        self.device = device

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST_FILE)

    def load_manifest(self) -> dict | None:
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
            return m if isinstance(m, dict) else None
        except (OSError, ValueError):
            return None

    def is_fresh(self, manifest: dict | None = None) -> bool:
        """Stale on ANY fingerprint mismatch."""
        m = manifest if manifest is not None else self.load_manifest()
        return bool(m) and m.get("fingerprint") == fingerprint(self.device)

    def _warm_engines(self) -> dict:
        """Build or load every kernel library and run each bucket once on
        the device. Returns {family: [buckets warmed]}; raises on the
        first kernel that fails to build or launch."""
        from ..device import mesh, resolve
        from ..ops import closure, wgl_native, wgl_row, wgl_search, wgl_vec

        dev = resolve(self.device)
        cards = mesh(self.device)
        mods = {"wgl_vec": wgl_vec, "wgl_row": wgl_row,
                "wgl_search": wgl_search}
        if dev.type == "cuda":
            for mod in (*mods.values(), closure):
                mod.build(dev)
        wgl_native.build()
        warmed: dict = {}
        for fam, pads in buckets(self.device).items():
            for pad in pads:
                if fam == "closure":
                    _probe_closure_bucket(pad, self.device)
                elif fam == "search_mesh":
                    _probe_search_mesh_bucket(pad, cards)
                elif fam == "closure_mesh":
                    _probe_closure_mesh_bucket(pad, cards)
                else:
                    _probe_search_bucket(mods[fam], pad, self.device)
                warmed.setdefault(fam, []).append(pad)
        if dev.type == "cuda":
            import torch

            for d in dict.fromkeys(cards or [dev]):
                torch.cuda.synchronize(d)
        return warmed

    def ensure(self) -> dict:
        """Warm every bucket and make the manifest fresh. Returns
        ``{"manifest", "warm", "elapsed_s"}``: ``warm`` is True when the
        manifest on disk was fresh; ``elapsed_s`` is this start's
        seconds from the call to a warmed card."""
        from .. import store

        t0 = time.monotonic()
        manifest = self.load_manifest()
        warm = self.is_fresh(manifest)
        warmed = self._warm_engines()
        if not warm:
            if manifest is not None:
                log.info("engine bundle at %s is stale; rewriting",
                         self.root)
            manifest = {"fingerprint": fingerprint(self.device),
                        "buckets": warmed,
                        "build_s": time.monotonic() - t0}
            store.atomic_write_json(self.manifest_path, manifest)
        return {"manifest": manifest, "warm": warm,
                "elapsed_s": time.monotonic() - t0}
