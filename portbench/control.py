"""The controls of the comparison that decides `correct`: the plain
reference put in the program's place with one of the configurations'
guarantees broken, scored by the same comparison as a run's checks.

    python3 -m portbench.control --workload <cell> --seed <n> [--seed ...]

For every seed it makes the cell's pool of histories as a run does,
answers each history with every control, and prints one JSON line a
seed: the wrong answers each control gave (the run's `wrong_answers`,
whose limit is 0) and the answers compared. The benchmark's runs never
run it. The controls:

- `info_as_fail`: a crashed op (`:info`) read as one that never
  happened, the shortcut that drops indeterminate operations;
- `step_cap`: a search that gives up ("unknown") after CAP_STEPS steps,
  the shortcut that trades the exact verdict for a bounded search.

Both searches stop at MAX_STEPS a key at the most; past it a key reads
"unknown", which is a wrong answer like any other.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import compare, run

#: the bounded search's cap: the native triage's budget under "auto"
CAP_STEPS = 2_000
#: no control searches a key longer than this
MAX_STEPS = 2_000_000

CONTROLS = {
    "info_as_fail": {"info_as_fail": True, "max_steps": MAX_STEPS},
    "step_cap": {"max_steps": CAP_STEPS},
}


def as_result(answers: dict) -> dict:
    """A keyed check's result dict holding `answers` (compare.expected's
    form), as the program would have returned them."""
    def one(a):
        valid, idx, p, f = a
        d = {"valid": valid}
        if idx is not None:
            d["op"] = {"index": idx, "process": p, "f": f}
        return d

    results = {k: one(a) for k, a in answers.items()}
    failures = [k for k, a in answers.items() if a[0] is False]
    valid = (False if failures else
             True if all(a[0] is True for a in answers.values())
             else "unknown")
    return {"valid": valid, "results": results, "failures": failures}


def readings(root: str, workload: str, seed: int) -> dict:
    """Each control's wrong answers over the pool of `workload` at
    `seed`, and the answers compared."""
    _, _, config, traffic = run.find_cell(root, workload)
    pool = run.make_pool(config, traffic, seed)
    out = {"workload": workload, "seed": seed, "answers": 0}
    for name in CONTROLS:
        out[name] = 0
    t0 = time.perf_counter()
    for h in pool:
        want = compare.expected(h)
        out["answers"] += len(want)
        for name, options in CONTROLS.items():
            got = as_result(compare.expected(h, **options))
            out[name] += compare.wrong(compare.digest(got), want)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(readings(run.ROOT, args.workload, seed)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
