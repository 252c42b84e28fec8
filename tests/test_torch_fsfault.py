"""The port's file-system fault layer (`jepsen_tpu_torch.nemesis.fsfault`,
`jepsen_tpu_torch/native/faultfs.cpp` and `faultfs_fuse.cpp`) against the
JAX package's: the LD_PRELOAD interposer built with g++ in a LocalRemote
sandbox and driven on child processes (clear, break-all, scoping,
percent, recovery, wrap and unwrap, the nemesis lifecycle), each result
as the JAX package's library gives it; the FUSE daemon built the same
way; and the commands that the FUSE layer, `FaultFsDB` and
`FsFaultNemesis` issue to a recording remote. Nothing here mounts a
file system: the FUSE layer is held here on its commands and its build,
and mounted in test_torch_fsfault_fuse.py. The cases of
tests/test_fsfault.py, test_fsfault_fuse.py and
test_fsfault_integration.py."""

from __future__ import annotations

import os
import re
import shutil
import subprocess

import pytest

from jepsen_tpu import db as jdb
from jepsen_tpu.control import DummyRemote as JDummy
from jepsen_tpu.control import LocalRemote as JLocal
from jepsen_tpu.control import Result as JResult
from jepsen_tpu.history import Op as JOp
from jepsen_tpu.nemesis import fsfault as jfs
from jepsen_tpu_torch import db as tdb
from jepsen_tpu_torch.control import DummyRemote as TDummy
from jepsen_tpu_torch.control import LocalRemote as TLocal
from jepsen_tpu_torch.control import Result as TResult
from jepsen_tpu_torch.history import Op as TOp
from jepsen_tpu_torch.nemesis import fsfault as tfs

PKGS = {"jax": (jfs, jdb, JDummy, JLocal, JResult, JOp),
        "port": (tfs, tdb, TDummy, TLocal, TResult, TOp)}


def both(fn) -> dict:
    return {name: fn(*mods) for name, mods in PKGS.items()}


def normalise(cmds) -> list:
    """Commands and uploads with each package's native directory and the
    source digests in the build stamps masked."""
    out = []
    for c in cmds:
        c = str(c).replace(os.path.realpath(tfs._NATIVE_DIR), "<native>")
        c = c.replace(os.path.realpath(jfs._NATIVE_DIR), "<native>")
        c = c.replace(tfs._NATIVE_DIR, "<native>").replace(
            jfs._NATIVE_DIR, "<native>")
        out.append(re.sub(r"\.src\.[0-9a-f]{16}", ".src.<digest>", c))
    return out


def recorder(Dummy, Result, mounted=False, stamped=False):
    """A recording remote: `mountpoint` answers `mounted`, a build stamp
    `stamped`; every other command succeeds."""

    class Recorder(Dummy):
        def exec(self, node, cmd, **kw):
            r = super().exec(node, cmd, **kw)
            if ("mountpoint" in r.cmd and not mounted) or (
                    "stat" in r.cmd and ".src." in r.cmd and not stamped):
                r = Result("", "", 1, r.cmd)
                return r.throw() if kw.get("check", True) else r
            return r

    return Recorder()


# ---------------------------------------------------------------------------
# Commands to a recording remote

@pytest.mark.parametrize("stamped", [False, True])
def test_builds_issue_the_jax_commands(stamped):
    def run(fs, db, Dummy, Local, Result, Op):
        remote = recorder(Dummy, Result, stamped=stamped)
        fs.install(remote, "n1", opt_dir="/opt/x")
        fs.install_fuse(remote, "n2", opt_dir="/opt/y")
        return normalise(remote.commands), normalise(remote.uploads)

    out = both(run)
    assert out["port"] == out["jax"]
    assert any("<native>/faultfs_fuse.cpp" in u for u in out["port"][1]) \
        is not stamped


@pytest.mark.parametrize("mounted", [False, True])
def test_fuse_mount_commands_equal(mounted):
    def run(fs, db, Dummy, Local, Result, Op):
        remote = recorder(Dummy, Result, mounted=mounted)
        fs.mount_fuse(remote, "n1", "/opt/db/data", opt_dir="/opt/j")
        err = None
        try:
            fs.umount_fuse(remote, "n1", "/opt/db/data")
        except Exception as e:  # a live mount after umount -l raises
            err = type(e).__name__
        return normalise(remote.commands), err, fs.backing_dir("/d/x/")

    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"][1] == ("RemoteError" if mounted else None)


def test_control_file_commands_equal():
    def run(fs, db, Dummy, Local, Result, Op):
        remote = Dummy()
        fs.break_all(remote, "n1", prefix="/data", opt_dir="/o")
        fs.break_percent(remote, "n1", pct=7, prefix="/data", opt_dir="/o")
        fs.clear(remote, "n1", opt_dir="/o")
        fs.wrap(remote, "n1", "/opt/db/bin", prefix="/data", opt_dir="/o")
        fs.unwrap(remote, "n1", "/opt/db/bin")
        return remote.commands, fs.lib_path("/o"), fs.ctl_path("/o"), \
            fs.fuse_bin_path("/o")

    out = both(run)
    assert out["port"] == out["jax"]


def inner_db(db):
    """A DB of the package of `db` with etcd's install/start split,
    recording its calls."""

    class Inner(db.DB, db.LogFiles):
        def __init__(self):
            self.calls = []

        def setup(self, test, node):
            self.install(test, node)
            self.start(test, node)

        def install(self, test, node):
            self.calls.append(("install", node))

        def start(self, test, node):
            self.calls.append(("start", node))

        def teardown(self, test, node):
            self.calls.append(("teardown", node))

        def log_files(self, test, node):
            return [f"/logs/{node}.log"]

        def kill(self, test, node):
            self.calls.append(("kill", node))

    return Inner()


def test_faultfs_db_lifecycle_equal():
    def run(fs, db, Dummy, Local, Result, Op):
        remote = recorder(Dummy, Result)
        inner = inner_db(db)
        wrapped = fs.FaultFsDB(inner, lambda t, n: f"/opt/db/{n}/data")
        test = {"remote": remote, "nodes": ["n1"],
                "fsfault_opt_dir": "/opt/ff"}
        wrapped.setup(test, "n1")
        wrapped.kill(test, "n1")
        logs = wrapped.log_files(test, "n1")
        wrapped.teardown(test, "n1")
        return normalise(remote.commands), inner.calls, logs, isinstance(
            wrapped, db.LogFiles)

    out = both(run)
    assert out["port"] == out["jax"]
    assert out["port"][1] == [("install", "n1"), ("start", "n1"),
                              ("kill", "n1"), ("teardown", "n1")]


@pytest.mark.parametrize("backend,manage", [("preload", True),
                                            ("fuse", False), ("fuse", True)])
def test_nemesis_commands_equal(backend, manage):
    def run(fs, db, Dummy, Local, Result, Op):
        remote = recorder(Dummy, Result)
        nem = fs.fs_fault_nemesis(
            prefix_fn=lambda t, n: f"/data/{n}", backend=backend,
            data_dir_fn=lambda t, n: f"/data/{n}", manage_mounts=manage,
            opt_dir="/opt/n", default_mode="break-one-percent")
        test = {"remote": remote, "nodes": ["n1", "n2"]}
        nem.setup(test)
        values = [nem.invoke(test, Op("nemesis", "invoke", f, v)).value
                  for f, v in (("start", None), ("break-all", None),
                               ("break-percent", 30), ("stop", None),
                               ("clear", None))]
        with pytest.raises(ValueError):
            nem.invoke(test, Op("nemesis", "invoke", "detonate", None))
        nem.teardown(test)
        return sorted(normalise(remote.commands)), values

    out = both(run)
    assert out["port"] == out["jax"]
    with pytest.raises(ValueError, match="data_dir_fn"):
        tfs.fs_fault_nemesis(backend="fuse")


# ---------------------------------------------------------------------------
# The interposer and the FUSE daemon, built with g++

@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    """Each package's interposer compiled into a LocalRemote sandbox."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    out = {}
    for name, (fs, _, _, Local, _, _) in PKGS.items():
        tmp = tmp_path_factory.mktemp(f"fsfault_{name}")
        remote = Local(root=str(tmp / "nodes"))
        opt_dir = os.path.join(remote.node_dir("n1"), "opt", "jepsen")
        fs.install(remote, "n1", opt_dir=opt_dir)
        data_dir = os.path.join(remote.node_dir("n1"), "data")
        os.makedirs(data_dir, exist_ok=True)
        out[name] = (fs, remote, opt_dir, data_dir)
    return out


def io_attempt(fs, opt_dir, path) -> bool:
    """open+write+close+read under the interposer in a child process."""
    code = ("p = %r\n"
            "try:\n"
            "    f = open(p, 'w'); f.write('hello'); f.close()\n"
            "    assert open(p).read() == 'hello'\n"
            "    print('OK')\n"
            "except OSError as e:\n"
            "    print('ERR', e.errno)\n" % path)
    env = {**os.environ, "LD_PRELOAD": fs.lib_path(opt_dir),
           "FAULTFS_CTL": fs.ctl_path(opt_dir)}
    out = subprocess.run(["python3", "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    return "OK" in out.stdout


def each(rigs, fn) -> dict:
    return {name: fn(*rig) for name, rig in rigs.items()}


def test_interposer_modes_equal(rigs, tmp_path):
    def run(fs, remote, opt_dir, data_dir):
        res = []
        fs.clear(remote, "n1", opt_dir=opt_dir)
        res.append(io_attempt(fs, opt_dir, os.path.join(data_dir, "a")))
        try:
            fs.break_all(remote, "n1", prefix=data_dir, opt_dir=opt_dir)
            res.append(io_attempt(fs, opt_dir, os.path.join(data_dir, "b")))
            # scoping: a path outside the prefix is spared
            res.append(io_attempt(fs, opt_dir, str(tmp_path / "outside")))
        finally:
            fs.clear(remote, "n1", opt_dir=opt_dir)
        res.append(io_attempt(fs, opt_dir, os.path.join(data_dir, "d")))
        return res

    out = each(rigs, run)
    assert out["port"] == out["jax"] == [True, False, True, True]


def test_interposer_percent_mode_as_jax(rigs):
    def run(fs, remote, opt_dir, data_dir):
        try:
            fs.break_percent(remote, "n1", pct=10, prefix=data_dir,
                             opt_dir=opt_dir)
            res = [io_attempt(fs, opt_dir, os.path.join(data_dir, "c"))
                   for _ in range(20)]
        finally:
            fs.clear(remote, "n1", opt_dir=opt_dir)
        return any(res) and not all(res)

    assert each(rigs, run) == {"jax": True, "port": True}


def test_wrap_and_unwrap_equal(rigs):
    def run(fs, remote, opt_dir, data_dir):
        bin_path = os.path.join(remote.node_dir("n1"), "bin", "writer")
        os.makedirs(os.path.dirname(bin_path), exist_ok=True)
        with open(bin_path, "w") as f:
            f.write("#!/bin/sh\necho hi > \"$1\" && cat \"$1\"\n")
        os.chmod(bin_path, 0o755)
        fs.wrap(remote, "n1", bin_path, prefix=data_dir, opt_dir=opt_dir)
        fs.wrap(remote, "n1", bin_path, prefix=data_dir, opt_dir=opt_dir)
        kept = "echo hi" in open(bin_path + ".no-faultfs").read()
        target = os.path.join(data_dir, "w")
        fs.clear(remote, "n1", opt_dir=opt_dir)
        res = [kept, remote.exec("n1", [bin_path, target]).out.strip()]
        try:
            fs.break_all(remote, "n1", prefix=data_dir, opt_dir=opt_dir)
            res.append(remote.exec("n1", [bin_path, target],
                                   check=False).exit != 0)
        finally:
            fs.clear(remote, "n1", opt_dir=opt_dir)
        fs.unwrap(remote, "n1", bin_path)
        res.append(os.path.exists(bin_path + ".no-faultfs"))
        res.append(remote.exec("n1", [bin_path, target]).out.strip())
        res.append(fs.is_static(remote, "n1", bin_path))
        return res

    out = each(rigs, run)
    assert out["port"] == out["jax"] == [True, "hi", True, False, "hi", False]


def test_nemesis_lifecycle_equal(rigs):
    def run(fs, remote, opt_dir, data_dir):
        Op = PKGS["port" if fs is tfs else "jax"][5]
        nem = fs.FsFaultNemesis(prefix_fn=lambda t, n: data_dir,
                                opt_dir=opt_dir)
        test = {"remote": remote, "nodes": ["n1"]}
        nem.setup(test)
        path = os.path.join(data_dir, "n")
        res = []
        try:
            for f, v in (("break-all", None), ("clear", None),
                         ("break-percent", 100), ("stop", None),
                         ("start", None)):
                out = nem.invoke(test, Op("nemesis", "invoke", f, v))
                res.append((out.value, io_attempt(fs, opt_dir, path)))
        finally:
            nem.teardown(test)
        res.append(io_attempt(fs, opt_dir, path))
        return res

    out = each(rigs, run)
    assert out["port"] == out["jax"]
    assert [ok for _, ok in out["port"][:5]] == [False, True, False, True,
                                                 False]


def test_fuse_daemon_builds_as_jax(tmp_path):
    """faultfs_fuse.cpp compiles in both packages (nothing is mounted)."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    for name, (fs, _, _, Local, _, _) in PKGS.items():
        remote = Local(root=str(tmp_path / name))
        opt = os.path.join(remote.node_dir("n1"), "opt")
        assert fs.compile_fuse(remote, "n1", opt_dir=opt) == \
            fs.fuse_bin_path(opt)
        assert os.access(fs.fuse_bin_path(opt), os.X_OK)
        r = remote.exec("n1", [fs.fuse_bin_path(opt)], check=False)
        assert r.exit != 0  # usage: no mount without its arguments
