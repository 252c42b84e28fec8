"""General-purpose helpers (the port's copy of what it needs from
`jepsen_tpu.util`)."""

from __future__ import annotations

import concurrent.futures
import os
from typing import Callable, Iterable

NANOS_PER_MS = 1_000_000


def nanos_to_ms(n: float) -> float:
    return n / NANOS_PER_MS


def bounded_pmap(fn: Callable, coll: Iterable, bound: int | None = None) -> list:
    """Pooled parallel map with at most `bound` workers (util.clj bounded
    concurrency; default = cpu count + 2)."""
    items = list(coll)
    if not items:
        return []
    bound = bound or (os.cpu_count() or 1) + 2
    with concurrent.futures.ThreadPoolExecutor(max_workers=bound) as ex:
        return list(ex.map(fn, items))
