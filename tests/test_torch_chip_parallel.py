"""chip_smoke.py's side-by-side runner of the registers and locks cells
(`run_children`, `side_by_side`), on the CPU with stub children in
place of `chip_smoke.py --cell ...`: every child gets ports no other
child of the call has and a directory of its own; the cells' lines come
back, one per cell, with the kernels' figures each child reports folded
into the parent's rows; a child that exits non-zero, prints no line of
its cell, or runs past the limit fails the phase (and a child still
running then is killed)."""

from __future__ import annotations

import io
import json
import os
import sys
import time
import types
from contextlib import redirect_stdout

import pytest

import chip_smoke

STUB = """
import json, os, sys, time
cell, ports, d, mode = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
with open(os.path.join(d, "pid"), "w") as f:
    f.write(str(os.getpid()))
ports = [int(p) for p in ports.split(",")]
print("a line that is not JSON", flush=True)
if mode == "hang":
    time.sleep(120)
if mode == "fail":
    print("stub failure", file=sys.stderr)
    sys.exit(3)
if mode != "silent":
    print(json.dumps({"phase": cell, "ports": ports, "dir": d,
                      "at_s": 1.5}), flush=True)
print(json.dumps({"cell_kernels": {"wgl_vec": {
    "launches": 1, "compared": 1, "max_abs_err": 0,
    "cells": {cell: {"launches": 1}}, "shape": "1 lane", "ms": 0.1,
    "plain_ms": 2.0, "bound_ms": 0.001, "bound_by": "bytes"}}}),
    flush=True)
"""


@pytest.fixture
def stub(tmp_path):
    path = tmp_path / "stub.py"
    path.write_text(STUB)

    def argv_fn(modes):
        return lambda cell, ports, d: [
            sys.executable, str(path), cell, ",".join(map(str, ports)), d,
            modes.get(cell, "ok")]

    return argv_fn


CELLS = ["cell_a", "cell_b", "cell_c", "cell_d"]


def test_ports_disjoint_and_one_line_per_cell(stub, tmp_path):
    t0 = time.monotonic()
    got = chip_smoke.run_children(CELLS, stub({}), str(tmp_path / "w"), 60)
    assert time.monotonic() - t0 < 30
    assert sorted(got) == CELLS
    seen = []
    for cell, (line, rest, ports, wall) in got.items():
        assert line["phase"] == cell and line["ports"] == ports
        assert 0 < wall < 30
        assert len(ports) == len(chip_smoke.RUNNER_NODES)
        assert line["dir"] == str(tmp_path / "w" / cell)
        assert [list(o) for o in rest] == [["cell_kernels"]]
        seen += ports
    assert len(set(seen)) == len(seen) == 4 * len(chip_smoke.RUNNER_NODES)


def test_cells_take_their_own_port_counts(stub, tmp_path):
    """`n_ports(cell)`: each child gets that many ports, none shared;
    by default (`cell_ports`) tidb's cell takes four a node (its SQL, pd
    client, pd peer and tikv ports), every other cell one."""
    counts = {"cell_a": 20, "cell_b": 5, "cell_c": 10}
    got = chip_smoke.run_children(list(counts), stub({}),
                                  str(tmp_path / "w"), 60,
                                  n_ports=counts.get)
    seen = []
    for cell, (line, _, ports, _) in got.items():
        assert len(ports) == counts[cell] and line["ports"] == ports
        seen += ports
    assert len(set(seen)) == len(seen) == 35
    n = len(chip_smoke.RUNNER_NODES)
    assert chip_smoke.cell_ports("suites_tidb_register") == 4 * n
    assert all(chip_smoke.cell_ports(c) == n for c in chip_smoke.CELLS
               if c != "suites_tidb_register")


def test_disjoint_ports_are_distinct():
    ports = chip_smoke.disjoint_ports(64)
    assert len(set(ports)) == 64 and all(p > 0 for p in ports)


@pytest.mark.parametrize("mode,match", [
    ("fail", "cell_b: exit 3: stub failure"),
    ("silent", "cell_b: 0 lines of its cell"),
])
def test_a_failing_or_silent_child_fails_the_phase(stub, tmp_path, mode,
                                                   match):
    with pytest.raises(chip_smoke.ChildFailed, match=match):
        chip_smoke.run_children(CELLS, stub({"cell_b": mode}),
                                str(tmp_path / "w"), 60)


def test_a_hanging_child_fails_the_phase_and_is_killed(stub, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(chip_smoke.ChildFailed,
                       match="cell_c: still running after 3 s"):
        chip_smoke.run_children(CELLS, stub({"cell_c": "hang"}),
                                str(tmp_path / "w"), 3)
    assert time.monotonic() - t0 < 30
    pid = int((tmp_path / "w" / "cell_c" / "pid").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


def kernel(name: str):
    mod = types.SimpleNamespace(__name__=f"jepsen_tpu_torch.ops.{name}")
    return chip_smoke.Kernel(name, mod, "jepsen_tpu/ops/x.py:1")


def test_side_by_side_emits_each_line_and_merges_kernels(stub,
                                                        monkeypatch):
    """The parent emits each child's line (its at_s kept as child_at_s,
    its wall as child_wall_s) and each phase's line (its wall until its
    last child exited, within the batch's), and folds each child's
    kernel report into its rows: launches and comparisons add up, each
    cell's figures land in the row's cells."""
    monkeypatch.setattr(chip_smoke, "child_argv",
                        lambda args, cell, ports, d: stub({})(cell, ports,
                                                              d))
    vec, row = kernel("wgl_vec"), kernel("wgl_row")
    vec.launches = 2
    args = types.SimpleNamespace(seed=0, smi="stub card, 1 W")
    buf = io.StringIO()
    with redirect_stdout(buf):
        chip_smoke.side_by_side(args, [vec, row], {"one": CELLS[:2],
                                                   "two": CELLS[2:]})
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [ln["phase"] for ln in lines] == CELLS + ["one", "two"]
    assert all(ln["child_at_s"] == 1.5 for ln in lines[:4])
    for ln in lines[4:]:
        assert ln["side_by_side"] == CELLS
        assert ln["wall_s"] == max(c["child_wall_s"] for c in lines[:4]
                                   if c["phase"] in ln["cells"])
        assert ln["wall_s"] <= ln["side_by_side_wall_s"]
    assert vec.launches == 6 and vec.compared == 4 and row.launches == 0
    assert sorted(vec.cells) == CELLS
    assert vec.shape == "1 lane" and vec.plain_ms == 2.0


def test_child_cells_cover_both_phases():
    """Every registers and locks cell, and the requeued mutex, runs as a
    child of its phase (`--cell` takes each)."""
    want = {c for _, c, *_ in chip_smoke.REGISTERS + chip_smoke.LOCKS}
    assert set(chip_smoke.CELLS) == want | {"suites_rabbitmq_requeued"}
    assert set(chip_smoke.CELLS) == set(chip_smoke.REGISTERS_CELLS
                                        + chip_smoke.LOCKS_CELLS)
    argv = chip_smoke.child_argv(types.SimpleNamespace(seed=3),
                                 "suites_aerospike", [1, 2], "/w")
    assert argv[1:] == [os.path.abspath(chip_smoke.__file__), "--seed", "3",
                        "--cell", "suites_aerospike", "--workdir", "/w",
                        "--ports", "1,2"]


@pytest.mark.parametrize("cell", ["suites_hazelcast_lock",
                                  "suites_rabbitmq_requeued"])
def test_child_cell_runs_its_cell_then_reports(monkeypatch, cell):
    """`--cell`: the registers or locks cell alone (its REGISTERS or
    LOCKS entry; the requeued mutex its own function), under the
    workdir, then the kernel report, from launches made in this process
    only."""
    calls = []

    def cell_fn(name):
        def fn(args, kernels, ck, td, *spec):
            calls.append((name, td, spec))
            kernels[0].launches += 1
        return fn

    monkeypatch.setattr(chip_smoke, "registers_cell", cell_fn("registers"))
    monkeypatch.setattr(chip_smoke, "locks_requeued", cell_fn("requeued"))
    args = types.SimpleNamespace(cell=cell, workdir="/w", seed=0)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert chip_smoke.run_child_cell(args) == 0
    (report,) = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert list(report["cell_kernels"]) == ["wgl_vec"]
    assert report["cell_kernels"]["wgl_vec"]["launches"] == 1
    if cell == "suites_rabbitmq_requeued":
        assert calls == [("requeued", "/w", (cell,))]
    else:
        assert calls == [("registers", "/w", (
            "hazelcast", cell, ("--workload", "lock", "--nemesis",
                                "majority-ring"), "1n", "workload"))]
