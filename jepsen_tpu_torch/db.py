"""Database lifecycle protocols (reference: jepsen.db, db.clj:8-67).

The port's copy of `jepsen_tpu/db.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import logging

from .util import real_pmap

log = logging.getLogger("jepsen_tpu_torch.db")

CYCLE_TRIES = 3


class SetupFailed(Exception):
    """Raise from DB.setup to request a teardown+setup retry
    (db.clj ::setup-failed)."""


class DB:
    def setup(self, test, node) -> None:
        """Set up the database on this node."""

    def teardown(self, test, node) -> None:
        """Tear down the database on this node."""


class Primary:
    """Mixin: one-time setup on a single (first) node (db.clj:12-13)."""

    def setup_primary(self, test, node) -> None:
        raise NotImplementedError

    def primaries(self, test) -> list:
        """Nodes currently believed to be primaries (db.clj:18-22).
        Single-leader systems should override with a real leader probe;
        the default — the setup_primary node — matches the reference's
        degenerate case."""
        nodes = test.get("nodes") or []
        return nodes[:1]


class Process:
    """Mixin: the DB can report whether its process runs on a node
    (db.clj ::Process). alive() answers True/False, or None when the
    node has no record of the process at all (e.g. no pidfile)."""

    def alive(self, test, node):
        raise NotImplementedError


class Kill(Process):
    """Mixin: the DB's process can be killed and restarted on demand
    (db.clj ::Kill). kill() must be crash-like (SIGKILL, no graceful
    shutdown); start() must be idempotent — starting a running node is
    a no-op, so heal phases can blanket-restart."""

    def kill(self, test, node) -> None:
        raise NotImplementedError

    def start(self, test, node) -> None:
        raise NotImplementedError


class Pause(Process):
    """Mixin: the DB's process can be paused (SIGSTOP) and resumed
    (SIGCONT) (db.clj ::Pause). Both must be idempotent for the same
    reason Kill.start is."""

    def pause(self, test, node) -> None:
        raise NotImplementedError

    def resume(self, test, node) -> None:
        raise NotImplementedError


class LogFiles:
    """Mixin: per-node log file paths to snarf at test end (db.clj:15-16)."""

    def log_files(self, test, node) -> list:
        return []


class Noop(DB):
    pass


noop = Noop()


def cycle(test) -> None:
    """Tear down then set up the DB on all nodes concurrently; retry the
    whole cycle up to CYCLE_TRIES times on SetupFailed (db.clj:24-67)."""
    db = test["db"]
    nodes = test["nodes"]
    tries = CYCLE_TRIES
    while True:
        log.info("Tearing down DB")
        def safe_teardown(node):
            try:
                db.teardown(test, node)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.warning("teardown failed on %s", node, exc_info=True)
        real_pmap(safe_teardown, nodes)

        try:
            log.info("Setting up DB")
            real_pmap(lambda node: db.setup(test, node), nodes)
            if isinstance(db, Primary) and nodes:
                log.info("Setting up primary %s", nodes[0])
                db.setup_primary(test, nodes[0])
            return
        except SetupFailed:
            tries -= 1
            if tries <= 0:
                raise
            log.warning("Unable to set up database; retrying...")
