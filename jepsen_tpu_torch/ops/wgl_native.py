"""The native (C++) Wing-Gong-Lowe search: the host engine of the port
(the counterpart of `jepsen_tpu/ops/wgl_native.py`).

csrc/wgl_native.cpp is a copy of the JAX package's
`jepsen_tpu/native/wgl_search.cpp`: the same algorithm and search order
as ops/wgl_host.py (Lowe's linked-list search with a (bitset, state)
memo, no bound on the memo), for the models with an int32 kernel
encoding, GIL-free. `_build.load_host` compiles it with g++ on first use
into the digest-keyed build cache; a failed build raises
NativeUnavailable, and no caller falls back to the Python search for it.

It is a host engine: it takes no device. `analysis_batch` fans lanes
over a thread pool (ctypes drops the GIL for each search).
"""

from __future__ import annotations

import ctypes
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..history import Entries, entries as make_entries
from ..models import Model
from ..models import jit as mjit
from . import _build
from .wgl_host import WGLResult

_MODEL_KINDS = {
    "cas-register": 0,
    "register": 1,
    "mutex": 2,
    "unordered-queue": 3,
    "fifo-queue": 4,
}

#: worker threads of analysis_batch, at most
MAX_WORKERS = 16

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_INT = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {"wgl_search": ([
    ctypes.c_int, _I32, _I32, _I32, ctypes.POINTER(ctypes.c_uint8),
    _I64, _I64, ctypes.c_int, ctypes.c_int32, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_double,
    _INT, _INT, _INT, _INT, ctypes.POINTER(ctypes.c_longlong),
], ctypes.c_longlong)}


class NativeUnavailable(_build.BuildError):
    """The native library does not build (no g++, or g++ failed), or a
    history has no native encoding."""


def build():
    """The native library, compiled if needed; raises NativeUnavailable
    when it does not build."""
    try:
        return _build.load_host("wgl_native", _SIGNATURES)
    except _build.BuildError as e:
        if isinstance(e, NativeUnavailable):
            raise
        raise NativeUnavailable(f"can't build the native search: {e}") from e


def resolve(model: Model, es: Entries):
    """The JitModel the native engine encodes (model, es) with, or None
    when it has no native encoding (one pass over the lane)."""
    jm = mjit.for_model(model)
    if jm is None or jm.name not in _MODEL_KINDS \
            or not jm.lane_eligible(es):
        return None
    return jm


def eligible(model: Model, es: Entries) -> bool:
    return resolve(model, es) is not None


def analysis(model: Model, history, time_limit: float | None = None,
             max_steps: int | None = None) -> WGLResult:
    """Linearizability of one history through the native engine. valid
    is True, False or "unknown" (the step budget or the time limit ran
    out). Raises NativeUnavailable for a history without a native
    encoding or a library that does not build."""
    es = history if isinstance(history, Entries) else make_entries(history)
    jm = resolve(model, es)
    if jm is None:
        raise NativeUnavailable(f"no native encoding for {model!r}")
    return _search(build(), model, jm, es, time_limit, max_steps)


def _search(lib, model: Model, jm, es: Entries, time_limit, max_steps):
    """One lane through the library, with its JitModel already
    resolved."""
    n = len(es)
    if es.n_completed == 0:
        return WGLResult(valid=True, final_state=model)

    f, v1, v2 = jm.encode_lane(es)
    crashed = np.ascontiguousarray(es.crashed, np.uint8)
    call_pos = np.ascontiguousarray(es.call_pos, np.int64)
    ret_pos = np.ascontiguousarray(es.ret_pos, np.int64)
    width = jm.lane_width(es)
    init_state = int(jm.init_vec(max(1, width))[0])

    out_valid = ctypes.c_int(2)
    out_stuck = ctypes.c_int(-1)
    out_best = (ctypes.c_int * max(1, n))()
    out_best_len = ctypes.c_int(0)
    out_cache = ctypes.c_longlong(0)

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    steps = lib.wgl_search(
        n, ptr(f, ctypes.c_int32), ptr(v1, ctypes.c_int32),
        ptr(v2, ctypes.c_int32), ptr(crashed, ctypes.c_uint8),
        ptr(call_pos, ctypes.c_int64), ptr(ret_pos, ctypes.c_int64),
        _MODEL_KINDS[jm.name], init_state, max(1, width),
        # None: no budget (-1); a negative budget is already spent (0)
        ctypes.c_longlong(-1 if max_steps is None else max(0, max_steps)),
        ctypes.c_double(-1.0 if time_limit is None
                        else max(0.0, time_limit)),
        ctypes.byref(out_valid), ctypes.byref(out_stuck),
        out_best, ctypes.byref(out_best_len), ctypes.byref(out_cache))

    best = [es.invokes[out_best[i]] for i in range(out_best_len.value)]
    if out_valid.value == 1:
        return WGLResult(valid=True, best_linearization=best,
                         cache_size=out_cache.value, steps=int(steps))
    if out_valid.value == 0:
        op = es.invokes[out_stuck.value] if out_stuck.value >= 0 else None
        return WGLResult(valid=False, op=op, best_linearization=best,
                         cache_size=out_cache.value, steps=int(steps))
    return WGLResult(valid="unknown", cache_size=out_cache.value,
                     steps=int(steps))


def analysis_batch(model: Model, entries_list,
                   max_steps: int | None = None,
                   time_limit: float | None = None,
                   max_workers: int = MAX_WORKERS,
                   jms: list | None = None) -> list[WGLResult]:
    """Many independent histories through the native engine, over a
    thread pool of min(lanes, cores, max_workers) threads. Every lane
    must have a native encoding (else NativeUnavailable, before any
    search runs). `jms`: each lane's `resolve` result, where the caller
    has already resolved them."""
    ess = [es if isinstance(es, Entries) else make_entries(es)
           for es in entries_list]
    lib = build()
    if jms is None:
        jms = [resolve(model, es) for es in ess]
    for i, jm in enumerate(jms):
        if jm is None:
            raise NativeUnavailable(
                f"lane {i} has no native encoding for {model!r}")

    def one(lane):
        return _search(lib, model, *lane, time_limit, max_steps)

    lanes = list(zip(jms, ess))
    workers = min(len(ess), os.cpu_count() or 1, max_workers)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(one, lanes))
    return [one(lane) for lane in lanes]
