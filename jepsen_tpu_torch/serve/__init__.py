"""Resident verdict service: warmed kernels behind a crash-safe,
backpressured check queue (the port's counterpart of `jepsen_tpu.serve`).

bundle.py    the engine bundle: a fingerprinted manifest (kernel source
             digests, torch/CUDA, the device, GPU_BATCH_MIN, the
             calibration's fingerprint) holding the measured crossovers,
             and a warm pass that builds or loads every kernel and
             launches each bucket once, so the first job pays no build
             and no measurement.
registry.py  the session-scoped registry: the workload table (shared
             with `watch`), the device, the bundle state and the faults
             the daemon met, with a combined health snapshot for the
             readiness endpoint.
queue.py     the durable work queue: job specs and verdicts as
             atomically-renamed JSON files, weighted round-robin
             fairness across clients, bounded admission, and the attempt
             ledger that turns crash-blamed jobs into suspects.
daemon.py    the HTTP front end (`python -m jepsen_tpu_torch serve
             --daemon`): submit/verdict/stream endpoints, health and
             readiness wired to the card's faults and memory, cross-run
             packing of independent-key lanes (independent.pack_check),
             and SIGTERM drain.
sacrifice.py one suspect job checked in a child process.
"""

from .bundle import EngineBundle  # noqa: F401
from .queue import DurableQueue, QueueFull  # noqa: F401
from .registry import EngineRegistry  # noqa: F401
