"""Shared plumbing for per-DB suites (the port's copy of what the etcd
suite reaches in `jepsen_tpu/dbs/common.py`): the --nemesis option and
its registry, the readiness poll and its generator gate.

Two --nemesis forms of the JAX package need modules the port does not
have yet, and raise `NotPorted` (exit 255 from the CLI) instead of being
ignored: the fs-break modes (`nemesis/fsfault.py`) and fault families or
a schedule file (`nemesis/combined.py`). The archive-DB suite shape
(`ArchiveDB`, its kill nemeses) waits for the suites that use it."""

from __future__ import annotations

import logging
import threading
import time

from .. import generator as gen
from ..util import real_pmap

log = logging.getLogger("jepsen_tpu_torch.dbs.common")

#: the fault families of `jepsen_tpu/nemesis/combined.py` (FAULT_FAMILIES)
FAULT_FAMILIES = ("partition", "clock", "kill", "pause", "corruption",
                  "packet")


class NotPorted(RuntimeError):
    """An option that needs a module the port does not have yet."""


def poll_until_ready(db, test, nodes, timeout: float) -> list:
    """Poll db.probe_ready on `nodes` (in parallel) until all answer or
    the timeout passes; returns the still-down nodes. ANY probe
    exception counts as not-ready — a daemon mid-startup can refuse
    connections (OSError), speak garbage HTTP (http.client errors), or
    answer protocol-level errors ("-LOADING"), and a probe must poll
    through all of them, never crash the caller."""
    def probe(node) -> bool:
        try:
            return bool(db.probe_ready(test, node))
        except NotImplementedError:
            raise  # missing override is a programming error, not "down"
        except Exception:
            return False

    deadline = time.monotonic() + timeout
    down = list(nodes)
    while True:
        up = real_pmap(probe, down)
        down = [n for n, ok in zip(down, up) if not ok]
        if not down or time.monotonic() > deadline:
            return down
        time.sleep(0.2)


class AwaitReadyGen(gen.Generator):
    """A generator gate: delay the wrapped (final) generator until every
    node answers db.probe_ready, or the timeout passes. A kill/restart
    nemesis's heal returns as soon as the daemon is spawned; a fixed
    quiesce sleep races the daemon's bind on slow machines, while
    probing is deterministic. On expiry the gate logs the still-down
    nodes and proceeds — the final ops' own failures then tell the
    story (the run must not hang forever on a node that never
    revives)."""

    def __init__(self, db, inner, timeout: float = 30.0):
        """`db` is anything with probe_ready(test, node) — ArchiveDB
        subclasses, or any DB that grows the method."""
        self.db = db
        self.name = getattr(getattr(db, "suite", None), "name",
                            type(db).__name__)
        self.inner = gen.to_gen(inner)
        self.timeout = timeout
        self._lock = threading.Lock()
        self._done = False

    def op(self, test, process):
        with self._lock:
            if not self._done:
                down = poll_until_ready(self.db, test, test["nodes"],
                                        self.timeout)
                if down:
                    log.warning(
                        "%s still not ready after %.0fs health gate: %s "
                        "— final ops may fail",
                        self.name, self.timeout, down)
                self._done = True
        return self.inner.op(test, process)


def await_ready_gen(db, inner, timeout: float = 30.0) -> AwaitReadyGen:
    return AwaitReadyGen(db, inner, timeout)


def standard_nemeses(db) -> dict:
    """The named-nemesis registry the per-DB runners share
    (nemesis.clj:110-144): partitions and the majorities ring. The JAX
    package adds SIGSTOP pauses and bounded kill+restart for its
    `ArchiveDB` suites, which the port does not have yet."""
    from .. import nemesis as nem

    return {
        "none": lambda: nem.noop,
        "parts": nem.partition_random_halves,
        "majority-ring": nem.partition_majorities_ring,
    }


NEMESIS_NAMES = ("none", "parts", "majority-ring", "start-stop",
                 "start-kill", "start-kill-2")
PARTITION_NEMESIS_NAMES = ("none", "parts", "majority-ring")


def pick_nemesis(db, opts: dict, default: str = "parts", extra=None):
    """Resolve the suite's nemesis from the shared --nemesis option.
    `extra` merges suite-specific entries over the standard registry."""
    name = opts.get("nemesis") or default
    registry = standard_nemeses(db)
    if extra:
        registry.update(extra)
    if name not in registry:
        raise ValueError(
            f"nemesis {name!r} not available for this suite "
            f"(have: {sorted(registry)})")
    return registry[name]()


FSFAULT_NEMESIS_NAMES = ("fs-break", "fs-break-1pct")


def fsfault_wiring(db_, opts: dict, data_dir_fn):
    """(db, None) unless --nemesis names an fs-break mode, which needs
    the FUSE fault layer of `nemesis/fsfault.py`: not ported yet, so it
    raises NotPorted."""
    name = opts.get("nemesis") or ""
    if not name.startswith("fs-break"):
        return db_, None
    raise NotPorted(
        f"--nemesis {name} needs nemesis/fsfault.py, which the port "
        "does not have yet")


def nemesis_opt(p, names=NEMESIS_NAMES, default: str = "parts") -> None:
    """argparse surface for --nemesis: a registry name from `names`
    (validated by pick_nemesis) or a comma list of fault families (which
    needs `nemesis/combined.py`)."""
    p.add_argument(
        "--nemesis", default=default, metavar="SPEC",
        help=f"named fault mode (one of: {', '.join(names)}), or a "
        f"comma list of fault families ({', '.join(FAULT_FAMILIES)}) "
        f"for a composed package (default: {default})")


def parse_fault_spec(spec) -> tuple | None:
    """A --nemesis value as a fault-family spec (the port's copy of
    `jepsen_tpu.nemesis.combined.parse_fault_spec`): the family tuple,
    or None for a suite registry name."""
    if not spec or not isinstance(spec, str):
        return None
    parts = [s.strip() for s in spec.split(",") if s.strip()]
    if not parts:
        return None
    if all(p in FAULT_FAMILIES for p in parts):
        return tuple(parts)
    if len(parts) > 1:
        bad = sorted(set(parts) - set(FAULT_FAMILIES))
        raise ValueError(
            f"comma-separated --nemesis must name fault families; "
            f"{bad} aren't (have: {list(FAULT_FAMILIES)})")
    return None


def fault_package_wiring(test: dict, db_, opts: dict,
                         stability_generator=None,
                         corrupt_paths=None,
                         set_time_fn=None) -> bool:
    """False when --nemesis is a plain registry name for pick_nemesis.
    Fault families and --nemesis-schedule build a composed package in
    the JAX package (`nemesis/combined.py`), not ported yet: they raise
    NotPorted."""
    if opts.get("nemesis_schedule"):
        raise NotPorted(
            "--nemesis-schedule needs nemesis/combined.py, which the port "
            "does not have yet")
    fams = parse_fault_spec(opts.get("nemesis"))
    if fams is None:
        return False
    raise NotPorted(
        f"--nemesis {','.join(fams)} (fault families) needs "
        "nemesis/combined.py, which the port does not have yet")
