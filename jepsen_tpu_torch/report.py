"""Report helpers (reference: jepsen.report, report.clj:7-16): bind
stdout to a file for a block of code. The port's copy of
`jepsen_tpu/report.py`."""

from __future__ import annotations

import contextlib
import os
import sys


@contextlib.contextmanager
def to(filename: str):
    """Redirect stdout into `filename` for the duration of the block,
    creating parent directories; prints a pointer to the report when
    done (report.clj:7-16)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as w:
        with contextlib.redirect_stdout(w):
            yield w
    print("Report written to", filename, file=sys.stderr)
