"""Suite discovery: `python -m jepsen_tpu_torch.dbs` lists every per-DB
suite, its runner module, and its --workload choices (pulled from each
suite's argparse surface), so a user can find the right entry point
without reading source.

The port's copy of `jepsen_tpu/dbs/__main__.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import argparse
import importlib

from . import SUITES


def workload_choices(modname: str) -> list:
    """The --workload choices a suite's opt spec declares ([] when the
    suite has a single fixed workload, or when the module can't load —
    one broken suite must not take down the whole listing)."""
    try:
        mod = importlib.import_module(modname)
        spec = (getattr(mod, "_opt_spec", None)
                or getattr(mod, "opt_spec", None))
        if spec is None:
            return []
        p = argparse.ArgumentParser(allow_abbrev=False)
        spec(p)
    except Exception:
        return []
    for action in p._actions:
        if "--workload" in getattr(action, "option_strings", ()):
            return list(action.choices or [])
    return []


def main() -> None:
    print(f"{len(SUITES)} per-DB suites "
          "(run: python -m <module> test --help)\n")
    width = max(len(n) for n in SUITES)
    for name, modname in sorted(SUITES.items()):
        wls = workload_choices(modname)
        extra = f"  workloads: {', '.join(wls)}" if wls else ""
        print(f"  {name:<{width}}  {modname}{extra}")


if __name__ == "__main__":
    main()
