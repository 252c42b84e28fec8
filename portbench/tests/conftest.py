"""Fixtures of the harness's own tests (run from the repo's root with
`python3 -m pytest portbench/tests`). Tests that need the card carry the
`portbench_card` marker and take the `cuda` fixture, which skips them
without one."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: the cells' shapes cut to what a test run holds on the CPU
TINY = {"register_keyed": {"keys": 16, "per_key_limit": 16}}
#: cells the tests run beside BENCHMARK.json's: the clean mix (every key
#: linearizable), whose traffic file stays for its cell to come back by
#: an entry alone
EXTRA_CELLS = [{"name": "register_keyed.clean", "config": "register_keyed",
                "traffic": "clean", "chips": 1,
                "why": "the register test's histories as they come"}]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "portbench_card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")
    return torch.device("cuda")


def tiny_root(dst) -> str:
    """A copy of BENCHMARK.json, with EXTRA_CELLS, and the benchmark's
    data files under `dst`, its configurations cut to TINY; the
    harness's code stays the repo's."""
    dst = str(dst)
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"] += EXTRA_CELLS
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(REPO, "portbench", d),
                        os.path.join(dst, "portbench", d))
    for name, cut in TINY.items():
        p = os.path.join(dst, "portbench", "configs", name + ".json")
        with open(p) as fh:
            c = json.load(fh)
        c["history"].update(cut)
        with open(p, "w") as fh:
            json.dump(c, fh)
    return dst


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)


def run_cell(root, workload, seed=3_000_000_019, seconds=0.5, trace=0,
             capsys=None, device="cpu") -> tuple:
    """One run of `workload` under `root` (on the CPU; on the card with
    device None): (exit code, the result line as a dict, or None)."""
    from portbench import run

    try:
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      root=root, device=device)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr().out if capsys else ""
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None)
