"""Where a checker writes its files (the port's copy of `out_path` from
`jepsen_tpu/checker/perf.py`; the latency and rate graphs of that module
are not ported yet)."""

from __future__ import annotations


def out_path(test, opts, filename: str) -> str | None:
    """The path of `filename` in the test's store dir, under
    opts["subdirectory"], its directory created; None when the test has
    no store dir (no name or start_time)."""
    if not (test.get("name") and test.get("start_time")):
        return None
    from .. import store

    return store.path_(test, list((opts or {}).get("subdirectory") or []),
                       filename)
