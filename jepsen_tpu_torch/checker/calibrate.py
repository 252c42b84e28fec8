"""The mesh crossover: when the multi-device routes take a batch (the
port's copy of the mesh part of `jepsen_tpu/checker/calibrate.py`).

The closure's mesh route pays one gather of the packed rows a squaring
round for a D-way split of the product; the WGL mesh route pays a
launch a device and empty-lane padding for a D-way split of the lanes.
Both win only past a size bar:

- `mesh_min_n()`: the smallest adjacency side the closure mesh takes.
  `JEPSEN_TPU_TORCH_MESH_MIN_N` pins it; else, with two or more CUDA
  devices, it is measured once per process (`_measure_mesh_min_n`: one
  card's closure against the mesh's at MESH_CAL_SIZES); else
  MESH_MIN_N_DEFAULT. The JAX package keeps the measurement on disk
  beside its batch-min record; the port keeps it in the process only
  (a record on disk waits for a box with two cards to measure it on).
- `mesh_lanes_min()`: the smallest lane batch the WGL mesh takes:
  `JEPSEN_TPU_TORCH_MESH_LANES_MIN`, else max(MESH_LANES_MIN_DEFAULT,
  4 * cards).
"""

from __future__ import annotations

import logging
import os
import threading
import time

from . import is_fault

log = logging.getLogger("jepsen_tpu_torch.checker.calibrate")

MESH_MIN_N_DEFAULT = 2048    # closure: the adjacency side where the row
#                              split starts to win (conservative: below
#                              it one card's product is cheap and the
#                              gathers dominate)
MESH_LANES_MIN_DEFAULT = 64  # wgl: fewer lanes are not worth dealing
MESH_NEVER = 1 << 30         # "the mesh never wins here"
MESH_CAL_SIZES = (512, 2048)  # measured closure sizes (pad buckets)

_ENV_MESH_N = "JEPSEN_TPU_TORCH_MESH_MIN_N"
_ENV_MESH_LANES = "JEPSEN_TPU_TORCH_MESH_LANES_MIN"

_lock = threading.Lock()
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
    docstring): the env pin, the measurement of this process, or
    MESH_MIN_N_DEFAULT. A measurement that fails for another reason than
    a fault of the card (`checker.is_fault`, which raises) is logged and
    reads as the default."""
    global _mesh_cached, _mesh_min_n
    pinned = _env_int(_ENV_MESH_N)
    if pinned is not None:
        return pinned
    if not _mesh_cached:
        with _lock:
            if not _mesh_cached:
                v = None
                try:
                    v = _measure_mesh_min_n()
                    if v is not None:
                        log.info("measured mesh crossover: mesh_min_n=%d", v)
                except Exception as e:  # noqa: BLE001
                    if is_fault(e):
                        raise
                    log.warning("mesh crossover measurement failed",
                                exc_info=True)
                    v = None
                _mesh_min_n, _mesh_cached = v, True
    return _mesh_min_n if _mesh_min_n is not None else MESH_MIN_N_DEFAULT


def mesh_lanes_min() -> int:
    """The smallest lane batch the WGL mesh route takes: the env pin, or
    a few chunks a card (the deal is cheap; the bar only keeps out
    batches whose chunks would be mostly empty lanes)."""
    pinned = _env_int(_ENV_MESH_LANES)
    if pinned is not None:
        return pinned
    return max(MESH_LANES_MIN_DEFAULT, 4 * _cards())
