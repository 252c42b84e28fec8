"""The measured crossovers of "auto" (the port's copy of
`jepsen_tpu/checker/calibrate.py`).

A committed bar bakes one host's dispatch latency and core count into
checker policy. So the bar at which "auto" sends a batch of scalar lanes
to K1 (`wgl_vec`) whole, rather than to the native triage, is measured
on the machine that runs it, at first use, from three terms:

``t_rt``
    the fixed cost of one card call: the intercept of a two-point fit
    of `wgl_vec.analysis_batch` (encode, upload, launch, download).
``per_lane_card``
    the card's marginal cost a (hard, step-capped) lane: that fit's
    slope.
``per_lane_native``
    the native engine's wall a lane on the same lanes at the same step
    cap, one lane at a time.

Checking L hard lanes costs native ``L * per_lane_native`` and the card
``t_rt + L * per_lane_card``, so the bar is

    batch_min = t_rt / (per_lane_native - per_lane_card) + 1

clamped to [CAL_MIN, CAL_MAX]; CAL_MAX ("never") when the card's slope is
not below native's. The lanes are seeded corrupt cas-register histories
of ~48 entries (`_corrupt_register_lanes`), capped at CAL_MAX_STEPS: the
hard-tail shape the router routes. Native is timed one lane at a time,
as in the JAX package, while "auto" pools native lanes over the host's
cores: the bar sits below the pooled crossover that `chip_smoke.py
--only crossover` measures.

- `batch_min(device)`: `JEPSEN_TPU_TORCH_BATCH_MIN` pins the bar (read
  at each call); else `calibration(device).batch_min`; None means "the
  committed bar" (`GPU_BATCH_MIN` in checker/linearizable.py).
- `calibration(device)`: the process's measurement, made once at first
  use and only when the device resolves to CUDA (on the CPU it gives
  what `seed` installed, else None, and never measures). A measurement
  is kept on disk (`cache_path()`: `JEPSEN_TPU_TORCH_CALIB_CACHE`,
  default ``~/.cache/jepsen-tpu-torch/calibration.json``; "", "0",
  "off" or "none" disables it) stamped with `device_fingerprint()`, so
  a later process on the same card, torch and CUDA reads it back
  instead of measuring; a record of another fingerprint, or a torn one,
  is a miss and is overwritten by the next measurement.
  Unlike the JAX package, a measurement that fails raises: a fault of
  the card (`checker.is_fault`), a kernel or the native library that
  fails to build or launch. Only lanes the kernel cannot take give None.
- `seed(cal)` installs a measurement without measuring (the engine
  bundle's warm start, serve/bundle.py).

The mesh crossover:

- `mesh_min_n()`: the smallest adjacency side the closure mesh takes.
  `JEPSEN_TPU_TORCH_MESH_MIN_N` pins it; else, with two or more CUDA
  devices, it is read from the disk record or measured once a process
  (`_measure_mesh_min_n`: one card's closure against the mesh's at
  MESH_CAL_SIZES) and written to the same record; else
  MESH_MIN_N_DEFAULT. `seed_mesh(v)` installs one.
- `mesh_lanes_min()`: the smallest lane batch the WGL mesh takes:
  `JEPSEN_TPU_TORCH_MESH_LANES_MIN`, else max(MESH_LANES_MIN_DEFAULT,
  4 * cards).

`_reset_for_tests()` drops the in-memory measurements only; tests point
`JEPSEN_TPU_TORCH_CALIB_CACHE` at a scratch file to isolate the disk.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from dataclasses import asdict, dataclass

from . import is_fault

log = logging.getLogger("jepsen_tpu_torch.checker.calibrate")

CAL_MAX_STEPS = 4_000   # step cap a calibration lane: the hard-tail shape
CAL_LANES_SMALL = 128   # the fit's first point
CAL_LANES_BIG = 1024    # ...and its second
CAL_NATIVE_LANES = 16   # native runs one lane at a time; a few suffice
CAL_OPS_PER_LANE = 40   # ~48-entry lanes: the 64-row pad bucket
CAL_MIN = 1024          # below this the fit's noise exceeds the signal
CAL_MAX = 1 << 20       # "never": the card loses at any realistic width

_ENV = "JEPSEN_TPU_TORCH_BATCH_MIN"
_CACHE_ENV = "JEPSEN_TPU_TORCH_CALIB_CACHE"

_lock = threading.Lock()
_cached = False
_calibration: "Calibration | None" = None


@dataclass(frozen=True)
class Calibration:
    """One host's measured economics of K1 against native (seconds)."""

    t_rt: float            # the fixed cost of one card call
    per_lane_card: float   # the card's marginal cost a hard lane
    per_lane_native: float  # native's cost a lane, one at a time

    @property
    def batch_min(self) -> int:
        return derive_batch_min(
            self.t_rt, self.per_lane_native, self.per_lane_card)


def derive_batch_min(t_rt: float, per_lane_native: float,
                     per_lane_card: float,
                     lo: int = CAL_MIN, hi: int = CAL_MAX) -> int:
    """The lane count where `t_rt + L * card < L * native`, clamped."""
    margin = per_lane_native - per_lane_card
    if margin <= 0:
        return hi
    return max(lo, min(hi, int(t_rt / margin) + 1))


def _corrupt_register_lanes(n_lanes: int, seed: int = 0) -> list:
    """Seeded hard lanes: concurrent cas-register histories (4
    processes, CAL_OPS_PER_LANE invocations) whose reads are corrupt 30 %
    of the time, so most refute only after a deep search or run out of
    a step cap. The JAX package's construction, op for op."""
    from ..history import Op

    lanes = []
    for lane in range(n_lanes):
        rng = random.Random(seed * 100_003 + lane)
        history, t, reg, pending = [], 0, None, {}
        started = 0
        while started < CAL_OPS_PER_LANE or pending:
            p = rng.randrange(4)
            if p in pending:
                f, value, result = pending.pop(p)
                history.append(Op(p, "ok", f, result, time=t))
            elif started < CAL_OPS_PER_LANE:
                started += 1
                if rng.random() < 0.5:
                    f, value = "read", None
                    result = (rng.randrange(5) if rng.random() < 0.3
                              else reg)
                else:
                    f = "write"
                    value = result = rng.randrange(5)
                    reg = value
                history.append(Op(p, "invoke", f, value, time=t))
                pending[p] = (f, value, result)
            t += 1
        for i, o in enumerate(history):
            o.index = i
        lanes.append(history)
    return lanes


# ---------------------------------------------------------------------------
# The disk record: both crossovers in one file, stamped with the device
# fingerprint they were measured under.

def cache_path() -> str | None:
    """The calibration record's file, or None when it is disabled."""
    p = os.environ.get(_CACHE_ENV)
    if p is None:
        p = os.path.join(os.path.expanduser("~"), ".cache",
                         "jepsen-tpu-torch", "calibration.json")
    return None if p.lower() in ("", "0", "off", "none") else p


def device_fingerprint(device=None) -> dict:
    """What a record is valid for: the platform, the device's name and
    compute capability, the CUDA device count, and the torch and CUDA
    versions. A record of any other fingerprint is stale."""
    import torch

    from ..device import describe

    d = describe(device)
    return {
        "platform": d["type"],
        "device_kind": d["name"],
        "capability": d["capability"],
        "device_count": (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def _load_record(device=None) -> dict | None:
    """The record on disk when its fingerprint is this device's, else
    None (missing, unreadable, torn or stale: all a miss)."""
    p = cache_path()
    if not p:
        return None
    try:
        with open(p) as f:
            rec = json.load(f)
        if not isinstance(rec, dict) or \
                rec.get("fingerprint") != device_fingerprint(device):
            log.info("calibration record %s is not this device's", p)
            return None
        return rec
    except (OSError, ValueError):
        log.debug("calibration record unreadable", exc_info=True)
        return None


def _load_disk_cache(device=None) -> Calibration | None:
    """The record's Calibration, or None on a miss."""
    rec = _load_record(device)
    try:
        c = rec["calibration"]
        return Calibration(float(c["t_rt"]), float(c["per_lane_card"]),
                           float(c["per_lane_native"]))
    except (KeyError, TypeError, ValueError):
        return None


def _load_disk_mesh(device=None) -> int | None:
    """The record's mesh crossover, or None on a miss."""
    rec = _load_record(device)
    try:
        return int(rec["mesh_min_n"])
    except (KeyError, TypeError, ValueError):
        return None


def _update_disk_cache(fields: dict, device=None) -> None:
    """Merge `fields` into the record (the calibration and the mesh
    crossover share one file and its fingerprint); a stale or torn
    record is replaced whole. Writing is best-effort: a failure is
    logged."""
    p = cache_path()
    if not p:
        return
    try:
        from .. import store

        rec = _load_record(device) or {}
        rec["fingerprint"] = device_fingerprint(device)
        rec.update(fields)
        store.atomic_write_json(p, rec)
    except OSError:
        log.warning("could not write the calibration record %s", p,
                    exc_info=True)


def _save_disk_cache(cal: Calibration, device=None) -> None:
    _update_disk_cache({"calibration": asdict(cal)}, device)


# ---------------------------------------------------------------------------
# The measurement

def _card_wall(model, ess, dev) -> float:
    """Wall seconds of one K1 call over `ess`, to a device sync."""
    import torch

    from ..ops import wgl_vec

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    wgl_vec.analysis_batch(model, ess, max_steps=CAL_MAX_STEPS, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def _native_wall(model, ess) -> float:
    """Wall seconds of native over `ess`, one lane at a time."""
    from ..ops import wgl_native

    t0 = time.perf_counter()
    for es in ess:
        wgl_native.analysis(model, es, max_steps=CAL_MAX_STEPS)
    return time.perf_counter() - t0


def _measure(device=None) -> Calibration | None:
    """The three terms on `device`: one warm K1 call, the best of two
    calls of CAL_LANES_SMALL lanes, one of CAL_LANES_BIG, and native on
    CAL_NATIVE_LANES lanes. None when K1 cannot take the lanes."""
    from ..device import resolve
    from ..history import entries as make_entries
    from ..models import CASRegister
    from ..models import jit as mjit
    from ..ops import wgl_vec

    dev = resolve(device)
    model = CASRegister(None)
    ess = [make_entries(h)
           for h in _corrupt_register_lanes(CAL_LANES_BIG, seed=7)]
    if not wgl_vec.batch_eligible(mjit.for_model(model), ess):
        return None
    small = ess[:CAL_LANES_SMALL]
    _card_wall(model, small, dev)  # the library's load and first launch
    t_small = min(_card_wall(model, small, dev) for _ in range(2))
    t_big = _card_wall(model, ess, dev)
    per_lane_card = max(
        0.0, (t_big - t_small) / (CAL_LANES_BIG - CAL_LANES_SMALL))
    t_rt = max(0.0, t_small - CAL_LANES_SMALL * per_lane_card)
    per_lane_native = (_native_wall(model, ess[:CAL_NATIVE_LANES])
                       / CAL_NATIVE_LANES)
    return Calibration(t_rt, per_lane_card, per_lane_native)


def _card(device):
    """The resolved device when it is a card, else None (the CPU)."""
    from ..device import resolve

    dev = resolve(device)
    return dev if dev.type == "cuda" else None


def calibration(device=None) -> Calibration | None:
    """This process's measurement (module docstring): what `seed`
    installed or an earlier call found; else, when `device` resolves to
    CUDA, the disk record, or a new measurement, kept on disk. On the
    CPU, None without measuring. A measurement that fails raises."""
    global _cached, _calibration
    if _cached:
        return _calibration
    dev = _card(device)
    if dev is None:
        return None
    with _lock:
        if _cached:
            return _calibration
        cal = _load_disk_cache(dev)
        if cal is not None:
            log.info("calibration record hit: batch_min=%d", cal.batch_min)
        else:
            from ..ops import wgl_native

            wgl_native.build()
            cal = _measure(dev)
            if cal is not None:
                _save_disk_cache(cal, dev)
                log.info("measured the K1 crossover: t_rt=%.2fms "
                         "card=%.4fms/lane native=%.4fms/lane -> "
                         "batch_min=%d", cal.t_rt * 1e3,
                         cal.per_lane_card * 1e3,
                         cal.per_lane_native * 1e3, cal.batch_min)
        _calibration, _cached = cal, True
    return _calibration


def pinned() -> int | None:
    """The bar `JEPSEN_TPU_TORCH_BATCH_MIN` pins (at least 1), or None; a
    value that is not an integer is logged and ignored."""
    return _env_int(_ENV)


def batch_min(device=None) -> int | None:
    """K1's bar under "auto": the pin, else the measurement's; None
    means "the committed bar"."""
    pin = pinned()
    if pin is not None:
        return pin
    cal = calibration(device)
    return None if cal is None else cal.batch_min


def seed(cal: Calibration | None) -> None:
    """Install `cal` as this process's measurement without measuring
    (the bundle's warm start; the caller vouches for its fingerprint)."""
    global _cached, _calibration
    with _lock:
        _calibration, _cached = cal, True


# ---------------------------------------------------------------------------
# The mesh crossover: the closure's mesh route pays one gather of the
# packed rows a squaring round for a D-way split of the product; the WGL
# mesh route pays a launch a device and empty-lane padding for a D-way
# split of the lanes. Both win only past a size bar.

MESH_MIN_N_DEFAULT = 2048    # closure: the adjacency side where the row
#                              split starts to win (conservative: below
#                              it one card's product is cheap and the
#                              gathers dominate)
MESH_LANES_MIN_DEFAULT = 64  # wgl: fewer lanes are not worth dealing
MESH_NEVER = 1 << 30         # "the mesh never wins here"
MESH_CAL_SIZES = (512, 2048)  # measured closure sizes (pad buckets)

_ENV_MESH_N = "JEPSEN_TPU_TORCH_MESH_MIN_N"
_ENV_MESH_LANES = "JEPSEN_TPU_TORCH_MESH_LANES_MIN"

_mesh_cached = False
_mesh_min_n: int | None = None  # measured; None = unmeasured or failed


def _cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _env_int(name: str) -> int | None:
    env = os.environ.get(name)
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            log.warning("ignoring non-integer %s=%r", name, env)
    return None


def _measure_mesh_min_n() -> int | None:
    """One card's closure against the closure over every card at
    MESH_CAL_SIZES (each run once to warm first): the smallest size
    where the mesh's wall wins, MESH_NEVER when it never does; None
    with fewer than two CUDA devices."""
    import numpy as np
    import torch

    from .. import device as device_mod
    from ..ops import closure

    if _cards() < 2:
        return None
    devs = device_mod.devices()

    def wall(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for n in MESH_CAL_SIZES:
        a = np.random.default_rng(11).random((n, n)) < (2.0 / n)
        t_single = wall(lambda: closure.reach_batch([a], device=devs[0]))
        t_mesh = wall(lambda: closure.reach_batch([a], devices=devs))
        if t_mesh <= t_single:
            return n
    return MESH_NEVER


def mesh_min_n() -> int:
    """The smallest adjacency side the closure mesh route takes (module
    docstring): the env pin, the measurement of this process (read from
    the disk record, or measured and written there), or
    MESH_MIN_N_DEFAULT. A measurement that fails for another reason than
    a fault of the card (`checker.is_fault`, which raises) is logged and
    reads as the default."""
    global _mesh_cached, _mesh_min_n
    pinned_n = _env_int(_ENV_MESH_N)
    if pinned_n is not None:
        return pinned_n
    if not _mesh_cached:
        with _lock:
            if not _mesh_cached:
                v = None
                try:
                    if _cards() >= 2:
                        v = _load_disk_mesh()
                        if v is None:
                            v = _measure_mesh_min_n()
                            if v is not None:
                                _update_disk_cache({"mesh_min_n": v})
                                log.info("measured mesh crossover: "
                                         "mesh_min_n=%d", v)
                except Exception as e:  # noqa: BLE001
                    if is_fault(e):
                        raise
                    log.warning("mesh crossover measurement failed",
                                exc_info=True)
                    v = None
                _mesh_min_n, _mesh_cached = v, True
    return _mesh_min_n if _mesh_min_n is not None else MESH_MIN_N_DEFAULT


def measured_mesh_min_n() -> int | None:
    """The measured (or seeded) mesh crossover, None when this process
    has none: what the bundle keeps (the default is policy, not a
    measurement)."""
    mesh_min_n()
    return _mesh_min_n


def seed_mesh(v: int | None) -> None:
    """Install a measured mesh crossover (the bundle's warm start)."""
    global _mesh_cached, _mesh_min_n
    with _lock:
        _mesh_min_n = None if v is None else int(v)
        _mesh_cached = True


def mesh_lanes_min() -> int:
    """The smallest lane batch the WGL mesh route takes: the env pin, or
    a few chunks a card (the deal is cheap; the bar only keeps out
    batches whose chunks would be mostly empty lanes)."""
    pinned_lanes = _env_int(_ENV_MESH_LANES)
    if pinned_lanes is not None:
        return pinned_lanes
    return max(MESH_LANES_MIN_DEFAULT, 4 * _cards())


def _reset_for_tests() -> None:
    """Drop the in-memory measurements (the disk record stays: tests
    point JEPSEN_TPU_TORCH_CALIB_CACHE at a scratch file, or "off")."""
    global _cached, _calibration, _mesh_cached, _mesh_min_n
    with _lock:
        _cached = False
        _calibration = None
        _mesh_cached = False
        _mesh_min_n = None
