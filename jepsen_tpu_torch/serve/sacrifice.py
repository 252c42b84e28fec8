"""Sacrificial execution of one suspected-poison job (the port's copy of
`jepsen_tpu/serve/sacrifice.py`).

``python -m jepsen_tpu_torch.serve.sacrifice <queue_dir> <job_id>
[--device cpu]``

The daemon's crash-blame record (serve/queue.py's attempt ledger) names
the jobs in flight when a previous process died; re-running one of those
in the daemon itself risks the same death. This module is the
containment boundary: it rehydrates and checks exactly one job in a
fresh process, on the device the daemon passes (default: the card), and
commits the verdict straight into the queue directory with the same
atomic-rename discipline, so a SIGKILL or an abort takes this child and
nothing else. The kernels it launches load from the build cache the
daemon's start filled; nothing is compiled here unless that cache lacks
them.

A fault of the card or of a build (checker.is_fault) commits nothing and
exits FAULT_EXIT, which the daemon records as a fault.

Deliberately NOT a DurableQueue client: opening the queue would run
recovery, and recovery quarantines unanswered jobs whose attempts are
spent — including the very attempt this process is here to make.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

log = logging.getLogger("jepsen_tpu_torch.serve.sacrifice")


def run_one(queue_dir: str, job_id: str, device=None) -> int:
    from .. import store
    from ..checker import check_safe
    from ..history import Op, index as index_history
    from .daemon import _jsonable
    from .queue import JOBS_DIR, VERDICTS_DIR, DurableQueue
    from .registry import EngineRegistry, load_extra_workloads

    load_extra_workloads()
    spec = store.read_json_dict(
        os.path.join(queue_dir, JOBS_DIR, job_id + ".json"))
    if spec is None:
        log.error("no readable spec for %s", job_id)
        return 2
    verdict_path = os.path.join(queue_dir, VERDICTS_DIR, job_id + ".json")
    if os.path.exists(verdict_path):
        return 0  # already committed by someone; nothing to do
    registry = EngineRegistry(device=device)
    wl = registry.workload(spec["workload"])
    test: dict = {"name": f"serve-{spec['workload']}"}
    remaining = DurableQueue.remaining_s(spec)
    verdict = None
    if remaining is not None:
        if remaining <= 0:
            verdict = {"valid": "unknown", "error": "deadline"}
        else:
            test["deadline"] = time.monotonic() + remaining
    if verdict is None:
        ops = [Op.from_dict(d) for d in spec["history"]]
        if wl["rehydrate"] is not None:
            ops = [wl["rehydrate"](o) for o in ops]
        verdict = check_safe(wl["checker"], test, index_history(ops))
    store.atomic_write_json(verdict_path,
                            {"id": job_id, "verdict": _jsonable(verdict)})
    return 0


def main(argv: list) -> int:
    from ..checker import is_fault
    from .daemon import FAULT_EXIT

    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve.sacrifice",
        description="Check one queued job in this process and commit its "
        "verdict to the queue directory.")
    ap.add_argument("queue_dir")
    ap.add_argument("job_id")
    ap.add_argument("--device", default=None,
                    help="where the check runs (default: the card; cpu "
                    "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    try:
        return run_one(args.queue_dir, args.job_id, device=args.device)
    except Exception as e:  # noqa: BLE001
        if not is_fault(e):
            raise
        log.exception("fault of the card checking %s; nothing committed",
                      args.job_id)
        return FAULT_EXIT


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
