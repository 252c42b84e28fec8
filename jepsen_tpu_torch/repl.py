"""Helpers for mucking around with tests interactively (reference:
jepsen.repl, repl.clj:6-13). The port's copy of `jepsen_tpu/repl.py`, on
the port's `store.py`."""

from __future__ import annotations

from . import store


def last_test(test_name: str | None = None, store_dir=None) -> dict | None:
    """The most recently run test, optionally filtered by name
    (repl.clj:6-13). Returns the fully loaded test map (history,
    results) or None."""
    if test_name is None:
        return store.latest(store_dir=store_dir)
    runs = store.tests(test_name, store_dir=store_dir)
    if not runs:
        return None
    return store.load(test_name, max(runs), store_dir=store_dir)
