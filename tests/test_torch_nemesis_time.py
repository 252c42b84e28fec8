"""The port's clock nemesis (`jepsen_tpu_torch.nemesis.time`), its native
tools (`jepsen_tpu_torch/native/bump_time.cpp`, `strobe_time.cpp`,
`strobe_time_experiment.cpp`) and `faketime` against the JAX package's:
the commands each issues to a recording remote, the tools compiled with
g++ in a LocalRemote sandbox and run only in their --dry-run modes (no
clock of this machine is set), the seeded generators, and the wrapper
scripts. The cases of tests/test_nemesis_time.py."""

from __future__ import annotations

import os
import random
import re
import shutil
import time

import pytest

from jepsen_tpu import faketime as jft
from jepsen_tpu import generator as jgen
from jepsen_tpu import nemesis as jnem
from jepsen_tpu.control import DummyRemote as JDummy
from jepsen_tpu.control import LocalRemote as JLocal
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.nemesis import time as jtime
from jepsen_tpu_torch import faketime as tft
from jepsen_tpu_torch import generator as tgen
from jepsen_tpu_torch import nemesis as tnem
from jepsen_tpu_torch.control import DummyRemote as TDummy
from jepsen_tpu_torch.control import LocalRemote as TLocal
from jepsen_tpu_torch.control import Result as TResult
from jepsen_tpu.control import Result as JResult
from jepsen_tpu_torch.history import Op as TOp
from jepsen_tpu_torch.nemesis import time as ttime

PKGS = {"jax": (jtime, jft, jnem, jgen, JDummy, JLocal, JOp, JResult),
        "port": (ttime, tft, tnem, tgen, TDummy, TLocal, TOp, TResult)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bump_time", "strobe_time", "strobe_time_experiment")
# the programs that set or reset a clock, or stop a service: faked on
# the sandbox remote (a `date` that reads the clock runs)
CLOCK_PROGRAMS = ("ntpdate", "service", "bump-time", "strobe-time",
                  "strobe-time-experiment")


def both(fn) -> dict:
    out = {}
    for name, mods in PKGS.items():
        random.seed(5)
        out[name] = fn(*mods)
    return out


def normalise(cmds) -> list:
    """Commands with each package's source directory and the clock's
    seconds masked."""
    out = []
    for c in cmds:
        c = str(c).replace(os.path.dirname(ttime._NATIVE_DIR), "<pkg>")
        c = c.replace(os.path.dirname(jtime._NATIVE_DIR), "<pkg>")
        out.append(re.sub(r"@\d+", "@<t>", c))
    return out


def sandbox(Local, Result):
    """A LocalRemote class that records, and does not run, any command
    that would set or reset this machine's clock or stop its services."""

    class Sandbox(Local):
        def __init__(self, root):
            super().__init__(root=root)
            self.faked = []

        def exec(self, node, cmd, *a, **kw):
            argv = cmd.split() if isinstance(cmd, str) else list(map(str, cmd))
            prog = os.path.basename(argv[0]) if argv else ""
            if (prog in CLOCK_PROGRAMS and "--dry-run" not in argv) or (
                    prog == "date" and "-s" in argv):
                self.faked.append((node, " ".join(argv)))
                return Result("0.0", "", 0, " ".join(argv))
            return super().exec(node, cmd, *a, **kw)

    return Sandbox


def test_native_sources_equal_but_comments():
    def code(path):
        with open(path) as f:
            return [ln for ln in f if not ln.lstrip().startswith("//")]

    for tool in TOOLS + ("faultfs", "faultfs_fuse"):
        port = os.path.join(REPO, "jepsen_tpu_torch", "native", f"{tool}.cpp")
        jax = os.path.join(REPO, "jepsen_tpu", "native", f"{tool}.cpp")
        assert code(port) == code(jax), tool
    assert os.path.realpath(ttime._NATIVE_DIR) == os.path.join(
        REPO, "jepsen_tpu_torch", "native")
    assert set(ttime.SOURCES) == set(jtime.SOURCES)
    assert ttime.EXPERIMENTAL_SOURCES == jtime.EXPERIMENTAL_SOURCES


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """Each package's three tools compiled into a sandbox node."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    out = {}
    for name, (tm, _, _, _, _, Local, _, _) in PKGS.items():
        lr = Local(root=str(tmp_path_factory.mktemp(f"nodes_{name}")))
        tm.compile_tools(lr, "n1", opt_dir="opt")
        tm.compile_tool(lr, "n1", "strobe-time-experiment", opt_dir="opt")
        out[name] = lr
    return out


DRY_RUNS = {
    "bump": (["opt/bump-time", "--dry-run", "5000"], (4.0, 6.5)),
    "bump_negative": (["opt/bump-time", "-n", "-3000"], (-4.5, -1.5)),
    "strobe": (["opt/strobe-time", "--dry-run", "100", "10", "0.2"], (5, 25)),
    "strobe_experiment": (["opt/strobe-time-experiment", "--dry-run", "100",
                           "20", "0.4"], (5, 21)),
}


@pytest.mark.parametrize("case", sorted(DRY_RUNS))
def test_tools_dry_run_as_jax(compiled, case):
    cmd, (lo, hi) = DRY_RUNS[case]
    for lr in compiled.values():
        before = time.time()
        out = lr.exec("n1", cmd).out
        v = (jtime.parse_time(out) - before if case.startswith("bump")
             else int(out))
        assert lo < v < hi if case.startswith("bump") else lo <= v <= hi


@pytest.mark.parametrize("cmd", [["opt/bump-time"], ["opt/strobe-time", "5"],
                                 ["opt/strobe-time-experiment", "5"]])
def test_tools_usage_equal(compiled, cmd):
    res = {name: lr.exec("n1", cmd, check=False)
           for name, lr in compiled.items()}
    assert res["port"].exit == res["jax"].exit == 1
    assert res["port"].err == res["jax"].err and "usage" in res["port"].err


def test_install_and_bring_up_commands_equal():
    def run(tm, ft, nem, gen, Dummy, Local, Op, Result):
        remote = Dummy()
        tm.install(remote, "n1", opt_dir="/opt/x")
        tm.compile_tool(remote, "n2", "strobe-time-experiment")
        nemesis = tm.clock_nemesis(opt_dir="/opt/y")
        nemesis.setup({"remote": remote, "nodes": ["n1", "n2"]})
        nemesis.teardown({"remote": remote, "nodes": ["n1", "n2"]})
        return (sorted(normalise(remote.commands)),
                sorted(normalise(remote.uploads)))

    out = both(run)
    assert out["port"] == out["jax"]


def clock_remote(Dummy, Result, skew=0.0):
    """A recording remote that answers date, bump-time and strobe-time
    with wall-clock strings (the JAX tests' _ClockRemote)."""

    class ClockRemote(Dummy):
        def exec(self, node, cmd, **kw):
            r = super().exec(node, cmd, **kw)
            if "date +%s.%N" in r.cmd:
                return Result(f"{time.time() + skew:.9f}", "", 0, r.cmd)
            m = re.search(r"bump-time'? (-?[\d.]+)", r.cmd)
            if m:
                return Result(f"{time.time() + float(m.group(1)) / 1000:.6f}",
                              "", 0, r.cmd)
            return r

    return ClockRemote()


@pytest.mark.parametrize("f,value", [
    ("check-offsets", None), ("bump", {"n2": 8000}),
    ("strobe", {"n1": {"delta": 100, "period": 5, "duration": 2}}),
    ("reset", ["n1"])])
def test_clock_nemesis_ops_equal(f, value):
    def run(tm, ft, nem, gen, Dummy, Local, Op, Result):
        remote = clock_remote(Dummy, Result, skew=3.0)
        t = {"remote": remote, "nodes": ["n1", "n2"]}
        op = tm.clock_nemesis().invoke(t, Op("nemesis", "info", f, value))
        offs = op.extra["clock_offsets"]
        return (sorted(normalise(c for _, c in remote.commands)),
                sorted(offs), {n: round(v) for n, v in offs.items()})

    out = both(run)
    assert out["port"] == out["jax"]


def test_clock_nemesis_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown clock op"):
        ttime.clock_nemesis().invoke({"remote": TDummy(), "nodes": ["n1"]},
                                     TOp("nemesis", "info", "warp", None))


def test_setup_on_sandbox_installs_tools_and_sets_no_clock(tmp_path):
    """ClockNemesis.setup on a LocalRemote sandbox: the tools built, and
    the clock reset and service stop recorded, not run."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    out = {}
    for name, (tm, _, _, _, _, Local, _, Result) in PKGS.items():
        lr = sandbox(Local, Result)(str(tmp_path / name))
        tm.ClockNemesis(opt_dir="opt").setup(
            {"remote": lr, "nodes": ["n1"]})
        d = lr.node_dir("n1")
        assert os.path.exists(os.path.join(d, "opt", "bump-time"))
        assert os.path.exists(os.path.join(d, "opt", "strobe-time"))
        out[name] = normalise(c for _, c in lr.faked)
    assert out["port"] == out["jax"]
    assert any("ntpdate" in c for c in out["port"])


def test_generators_equal():
    def run(tm, ft, nem, gen, Dummy, Local, Op, Result):
        t = {"nodes": ["a", "b", "c"], "concurrency": 3}
        ops = [tm.reset_gen(t, 0), tm.bump_gen(t, 0), tm.strobe_gen(t, 0)]
        g = tm.clock_gen()
        with gen.with_threads([gen.NEMESIS]):
            ops += [g.op(t, gen.NEMESIS) for _ in range(6)]
        return ops

    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"][3]["f"] == "check-offsets"
    for op in (PKGS["port"][0].bump_gen({"nodes": ["a", "b"]}, 0)
               for _ in range(20)):
        assert all(4 <= abs(d) <= 2 ** 18 for d in op["value"].values())


def test_clock_scrambler_commands_equal():
    def run(tm, ft, nem, gen, Dummy, Local, Op, Result):
        remote = Dummy()
        t = {"remote": remote, "nodes": ["n1", "n2"]}
        s = nem.clock_scrambler(60)
        op = s.invoke(t, Op("nemesis", "info", "scramble"))
        s.teardown(t)
        return sorted(normalise(c for _, c in remote.commands)), sorted(
            op.value)

    out = both(run)
    assert out["port"] == out["jax"]
    assert len([c for c in out["port"][0] if "date +%s -s" in c]) == 4


def test_faketime_script_and_commands_equal():
    def run(tm, ft, nem, gen, Dummy, Local, Op, Result):
        remote = Dummy()
        ft.wrap(remote, "n1", "/opt/db/bin/db", -5, 1.5)
        return ft.script("/opt/db/bin/db", -5, 1.5), remote.commands

    out = both(run)
    assert out["port"] == out["jax"]
    assert 'faketime -m -f "-5s x1.5"' in out["port"][0]


def test_faketime_wrap_is_idempotent_as_jax(tmp_path):
    out = {}
    for name, (_, ft, _, _, _, Local, _, _) in PKGS.items():
        lr = Local(root=str(tmp_path / name))
        d = lr.node_dir("n1")
        os.makedirs(os.path.join(d, "bin"), exist_ok=True)
        with open(os.path.join(d, "bin", "db"), "w") as f:
            f.write("#!/bin/bash\necho real-db\n")
        ft.wrap(lr, "n1", "bin/db", 10, 2.0)
        first = open(os.path.join(d, "bin", "db")).read()
        ft.wrap(lr, "n1", "bin/db", 20, 0.5)
        out[name] = (first, open(os.path.join(d, "bin", "db")).read(),
                     open(os.path.join(d, "bin", "db.no-faketime")).read())
    assert out["port"] == out["jax"]
    assert "real-db" in out["port"][2] and 'x0.5"' in out["port"][1]
