"""Online streaming checker: verdicts during the run, on traces from
anywhere (the port's counterpart of `jepsen_tpu.online`).

frontier.py  incremental transactional cycle checking: per-key edge
             maintenance under appended ops, with only dirty
             weakly-connected components closed again on the card
             (classify's content-hash closure memo); verdicts equal to
             CycleChecker.check on every prefix.
wgl.py       windowed per-key streaming advance of the independent
             linearizable (WGL) checker: dirty keys re-check in one
             check_batch window, verdicts recombine through
             independent.combine_results.
ingest.py    foreign trace adapters — Jepsen EDN histories and OTLP-ish
             span-log JSONL — mapped onto the WAL op schema.
stream.py    the StreamSession: deterministic window boundaries, a
             crash-safe fsync'd verdict log (resume emits each verdict
             exactly once), bounded lag, early abort.
monitor.py   in-run monitoring: a live history streamed through a
             frontier, a doomed run drained through test["_drain"].
client.py    a WAL stream as a serve-queue client: window snapshots
             submitted to the resident daemon, packed across concurrent
             streams by independent.pack_check.
watch.py     the `python -m jepsen_tpu_torch watch <wal-or-trace>` CLI.

A fault of the card or of a build (checker.is_fault) raises from every
one of them; none reads it as "unknown".
"""

from .client import QueueStreamClient  # noqa: F401
from .frontier import ClosureMemo, CycleFrontier  # noqa: F401
from .ingest import edn_ops, iter_trace, read_edn, span_ops  # noqa: F401
from .stream import (StreamSession, VerdictLog,  # noqa: F401
                     frontier_for)
from .wgl import WGLFrontier  # noqa: F401
