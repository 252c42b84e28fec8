"""Shared plumbing for per-DB suites (the port's copy of what the etcd
suite reaches in `jepsen_tpu/dbs/common.py`): the --nemesis option and
its registry, the fs-break wiring (`nemesis/fsfault.py`), the
fault-package wiring (`nemesis/combined.py`: fault families and
--nemesis-schedule), the readiness poll and its generator gate. The
archive-DB suite shape (`ArchiveDB`, its kill nemeses) waits for the
suites that use it."""

from __future__ import annotations

import logging
import threading
import time

from .. import generator as gen
from ..nemesis.combined import FAULT_FAMILIES, parse_fault_spec  # noqa: F401
from ..util import real_pmap

log = logging.getLogger("jepsen_tpu_torch.dbs.common")


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
    """(db, nemesis) for the --nemesis fs-break modes, else
    (db, None). The DB wraps in FaultFsDB — the mount must happen
    between install and daemon start — and the nemesis only flips the
    shared fault switch; ONE opt_dir (opts['fsfault_opt_dir']) feeds
    both, since diverging control-file paths would make every
    break/clear a silent no-op. Suites add FSFAULT_NEMESIS_NAMES to
    their nemesis_opt choices and consume 'fsfault_opt_dir' in their
    merge-opts-last step."""
    name = opts.get("nemesis") or ""
    if not name.startswith("fs-break"):
        return db_, None
    from ..nemesis import fsfault

    fs_opt = opts.get("fsfault_opt_dir", fsfault.OPT_DIR)
    wrapped = fsfault.FaultFsDB(db_, data_dir_fn, opt_dir=fs_opt)
    nem = fsfault.fs_fault_nemesis(
        backend="fuse", manage_mounts=False, opt_dir=fs_opt,
        default_mode=("break-one-percent" if name == "fs-break-1pct"
                      else "break-all"))
    return wrapped, nem


def nemesis_opt(p, names=NEMESIS_NAMES, default: str = "parts") -> None:
    """argparse surface for --nemesis. The value is either a registry
    name from `names` (validated at test-build time by pick_nemesis) or
    a comma list of fault families ("kill,partition") resolved into a
    composed nemesis package by fault_package_wiring — open-ended, so
    no argparse `choices` gate."""
    p.add_argument(
        "--nemesis", default=default, metavar="SPEC",
        help=f"named fault mode (one of: {', '.join(names)}), or a "
        f"comma list of fault families ({', '.join(FAULT_FAMILIES)}) "
        f"for a composed package (default: {default})")


def fault_package_wiring(test: dict, db_, opts: dict,
                         stability_generator=None,
                         corrupt_paths=None,
                         set_time_fn=None) -> bool:
    """When --nemesis names fault families ("kill,partition"), build
    the composed NemesisPackage and install it into the test map —
    nemesis, schedules, heal phase, stability window, recovery checker
    (nemesis.combined.wire_package). The test map's CURRENT generator
    must be the client-side generator; wiring wraps it. Returns True
    when wired, False when --nemesis is a plain registry name for
    pick_nemesis.

    --nemesis-schedule FILE takes precedence over --nemesis: the file's
    schedule document (combined.schedule_to_json / a fuzz-discovered
    schedule) is replayed VERBATIM through the real nemeses — same
    wiring, no rng. `set_time_fn` replaces the clock family's setter
    (`nemesis.set_time`, which runs `date -s` on the node)."""
    from ..nemesis import combined

    wiring = {
        "time_limit": opts.get("time_limit", 60),
        "stability_period": opts.get("stability_period", 10.0),
        "stability_generator": stability_generator,
        "recovery_min_ok": opts.get("recovery_min_ok", 1),
    }
    sched_file = opts.get("nemesis_schedule")
    if sched_file:
        pkg = combined.load_schedule_file(
            sched_file, db=db_, corrupt_paths=corrupt_paths,
            set_time_fn=set_time_fn)
        combined.wire_package(test, pkg, wiring)
        return True
    fams = combined.parse_fault_spec(opts.get("nemesis"))
    if fams is None:
        return False
    pkg = combined.nemesis_package(
        faults=fams,
        db=db_,
        seed=opts.get("seed"),
        interval=opts.get("nemesis_interval", 10.0),
        fault_ops=opts.get("fault_ops"),
        corrupt_paths=corrupt_paths,
        set_time_fn=set_time_fn,
        targets=opts.get("targets"),
    )
    combined.wire_package(test, pkg, wiring)
    return True
