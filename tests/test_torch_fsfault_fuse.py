"""The port's FUSE fault layer mounted for real, against the JAX
package's: a statically linked binary writing through each package's
faultfs mount (passthrough, an EIO storm under break-all, recovery on
clear, the percent mode), the unmount restoring the data directory,
`wrap` refusing a static binary and taking a dynamic one or a script,
and the port's etcd suite under `--nemesis fs-break` through `core.run`
on the CPU with a mid-run storm over the interposed data dir. The cases
of tests/test_fsfault_fuse.py and test_fsfault_fuse_suite.py (its etcd
case; the consul and cockroach suites are not ported), under the same
skip conditions: g++, /dev/fuse and root. Every mount is taken down in
a `finally`."""

from __future__ import annotations

import itertools
import os
import shutil
import subprocess
import time

import pytest

from jepsen_tpu.control import LocalRemote as JLocal
from jepsen_tpu.control import RemoteError as JRemoteError
from jepsen_tpu.nemesis import fsfault as jfs
from jepsen_tpu_torch import core, independent
from jepsen_tpu_torch import db as tdb
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control import LocalRemote as TLocal
from jepsen_tpu_torch.control import RemoteError as TRemoteError
from jepsen_tpu_torch.dbs import etcd, etcd_sim
from jepsen_tpu_torch.nemesis import fsfault as tfs

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None
    or not os.path.exists("/dev/fuse")
    or os.geteuid() != 0,
    reason="needs g++, /dev/fuse, and root",
)

PKGS = {"jax": (jfs, JLocal, JRemoteError),
        "port": (tfs, TLocal, TRemoteError)}

STATIC_SRC = r"""
#include <stdio.h>
#include <string.h>
#include <errno.h>
int main(int argc, char **argv) {
  char path[512];
  snprintf(path, sizeof path, "%s/wal.log", argv[1]);
  FILE *f = fopen(path, "a");
  if (!f) { printf("OPEN_FAIL %d\n", errno); return 1; }
  if (fprintf(f, "entry\n") < 0 || fflush(f) < 0 || ferror(f)) {
    printf("WRITE_FAIL %d\n", errno); return 1; }
  fclose(f);
  printf("WRITE_OK\n");
  return 0;
}
"""


@pytest.fixture(scope="module")
def static_bin(tmp_path_factory):
    td = tmp_path_factory.mktemp("staticbin")
    src = td / "db.c"
    src.write_text(STATIC_SRC)
    out = td / "static_db"
    r = subprocess.run(["gcc", "-static", "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"no static libc: {r.stderr[:200]}")
    ldd = subprocess.run(["ldd", str(out)], capture_output=True, text=True)
    assert "not a dynamic executable" in (ldd.stdout + ldd.stderr).lower()
    return str(out)


def run_static(static_bin, data) -> str:
    r = subprocess.run([static_bin, data], capture_output=True, text=True,
                       timeout=30)
    return r.stdout.strip()


def with_mount(tmp_path, body) -> dict:
    """body(fs, remote, data, opt) on a live faultfs mount over a seeded
    data dir, once for each package; the mount is taken down after."""
    out = {}
    for name, (fs, Local, _) in PKGS.items():
        remote = Local(root=str(tmp_path / name / "nodes"))
        opt = os.path.join(remote.node_dir("n1"), "opt", "jepsen")
        data = str(tmp_path / name / "data")
        os.makedirs(data)
        with open(os.path.join(data, "seed.txt"), "w") as fh:
            fh.write("seeded\n")
        fs.install_fuse(remote, "n1", opt_dir=opt)
        fs.mount_fuse(remote, "n1", data, opt_dir=opt)
        try:
            time.sleep(0.3)
            out[name] = body(fs, remote, data, opt)
        finally:
            fs.umount_fuse(remote, "n1", data)
    return out


def test_eio_storm_hits_static_binary_as_jax(tmp_path, static_bin):
    def body(fs, remote, data, opt):
        res = [open(os.path.join(data, "seed.txt")).read(),
               run_static(static_bin, data)]
        fs.break_all(remote, "n1", opt_dir=opt)
        time.sleep(0.2)  # the daemon re-reads its control file each 100 ms
        broken = run_static(static_bin, data)
        res.append((broken.split()[0] in ("OPEN_FAIL", "WRITE_FAIL"),
                    broken.split()[1]))
        fs.clear(remote, "n1", opt_dir=opt)
        time.sleep(0.2)
        res.append(run_static(static_bin, data))
        with open(os.path.join(fs.backing_dir(data), "wal.log")) as fh:
            res.append(fh.read().count("entry"))
        return res

    out = with_mount(tmp_path, body)
    assert out["port"] == out["jax"] == [
        "seeded\n", "WRITE_OK", (True, "5"), "WRITE_OK", 2]


def test_percent_mode_fails_some_as_jax(tmp_path, static_bin):
    def body(fs, remote, data, opt):
        fs.break_percent(remote, "n1", 50, opt_dir=opt)
        time.sleep(0.2)
        outs = [run_static(static_bin, data) for _ in range(40)]
        return (any(o == "WRITE_OK" for o in outs),
                any("FAIL" in o for o in outs))

    assert with_mount(tmp_path, body) == {"jax": (True, True),
                                          "port": (True, True)}


def test_unmount_restores_data_dir_as_jax(tmp_path):
    def run(fs, Local):
        root = tmp_path / ("port" if fs is tfs else "jax")
        remote = Local(root=str(root / "nodes"))
        opt = os.path.join(remote.node_dir("n1"), "opt", "jepsen")
        data = str(root / "data")
        os.makedirs(data)
        with open(os.path.join(data, "keep.txt"), "w") as fh:
            fh.write("precious\n")
        fs.install_fuse(remote, "n1", opt_dir=opt)
        fs.mount_fuse(remote, "n1", data, opt_dir=opt)
        try:
            time.sleep(0.3)
            mounted = subprocess.run(["mountpoint", "-q", data]).returncode
            with open(os.path.join(data, "during.txt"), "w") as fh:
                fh.write("written through the mount\n")
        finally:
            fs.umount_fuse(remote, "n1", data)
        return (mounted, os.path.exists(fs.backing_dir(data)),
                subprocess.run(["mountpoint", "-q", data]).returncode != 0,
                open(os.path.join(data, "keep.txt")).read(),
                open(os.path.join(data, "during.txt")).read())

    out = {name: run(fs, Local) for name, (fs, Local, _) in PKGS.items()}
    assert out["port"] == out["jax"] == (
        0, False, True, "precious\n", "written through the mount\n")


def test_wrap_refuses_static_binary_as_jax(tmp_path, static_bin):
    out = {}
    for name, (fs, Local, RemoteError) in PKGS.items():
        remote = Local(root=str(tmp_path / name))
        target = os.path.join(remote.node_dir("n1"), "db-binary")
        shutil.copy(static_bin, target)
        os.chmod(target, 0o755)
        with pytest.raises(RemoteError, match="statically linked") as e:
            fs.wrap(remote, "n1", target)
        out[name] = (str(e.value).replace(str(tmp_path / name), "<root>"),
                     os.path.exists(target + ".no-faultfs"))
    assert out["port"] == out["jax"]
    assert out["port"][1] is False  # nothing half-wrapped


def test_wrap_accepts_dynamic_and_scripts_as_jax(tmp_path):
    out = {}
    for name, (fs, Local, _) in PKGS.items():
        remote = Local(root=str(tmp_path / name))
        opt = os.path.join(remote.node_dir("n1"), "opt", "jepsen")
        os.makedirs(opt, exist_ok=True)
        script = os.path.join(remote.node_dir("n1"), "sim-daemon")
        with open(script, "w") as fh:
            fh.write("#!/bin/sh\necho hi\n")
        os.chmod(script, 0o755)
        fs.wrap(remote, "n1", script, opt_dir=opt)
        dyn = os.path.join(remote.node_dir("n1"), "dyn-binary")
        shutil.copy("/bin/true", dyn)
        fs.wrap(remote, "n1", dyn, opt_dir=opt)
        out[name] = (os.path.exists(script + ".no-faultfs"),
                     os.path.exists(dyn + ".no-faultfs"),
                     remote.exec("n1", [script]).out.strip())
    assert out["port"] == out["jax"] == (True, True, "hi")


def test_etcd_suite_fs_break_end_to_end(tmp_path):
    """The port's etcd suite under `--nemesis fs-break` on one simulated
    member whose state file lives in the interposed data dir: the mount
    comes and goes with the DB, a storm fails client ops, the healed
    phase recovers and the verdict is sound (test_fsfault_fuse_suite's
    etcd case, with the checker on the CPU)."""
    remote = TLocal(root=str(tmp_path / "nodes"))
    etcd_dir = os.path.join(remote.node_dir("n1"), "opt", "etcd")
    data_dir = os.path.join(etcd_dir, "n1.etcd")
    os.makedirs(data_dir, exist_ok=True)
    archive = str(tmp_path / "etcd-sim.tar.gz")
    etcd_sim.build_archive(archive, os.path.join(data_dir, "state.json"))
    test = etcd.etcd_test({
        "nemesis": "fs-break",
        "archive_url": f"file://{archive}",
        "version": "sim",
        "time_limit": 10,
        "threads_per_key": 3,
        "device": "cpu",
        "fsfault_opt_dir": os.path.join(remote.node_dir("n1"), "opt",
                                        "jepsen"),
    })
    assert isinstance(test["db"], tfs.FaultFsDB)
    assert isinstance(test["db"], tdb.LogFiles)
    assert test["db"].log_files(
        {"remote": remote, "etcd": {"dir": lambda n: etcd_dir}}, "n1")
    test.update({
        "nodes": ["n1"],
        "remote": remote,
        "os": None,
        "net": None,
        "concurrency": 3,
        "etcd": {
            "addr_fn": lambda n: "127.0.0.1",
            "client_ports": {"n1": etcd_sim.free_port()},
            "peer_ports": {"n1": etcd_sim.free_port()},
            "dir": lambda n: etcd_dir,
            "sudo": None,
        },
    })

    def client_phase(key_start):
        return gen.time_limit(2, gen.clients(
            independent.concurrent_generator(
                3, itertools.count(key_start),
                lambda k: gen.limit(15, gen.stagger(
                    0.01, gen.mix([etcd.r, etcd.w, etcd.cas]))))))

    test["generator"] = gen.phases(
        client_phase(0),
        gen.nemesis(gen.once({"type": "info", "f": "start"})),
        client_phase(100),
        gen.nemesis(gen.once({"type": "info", "f": "stop"})),
        client_phase(200),
    )
    try:
        result = core.run(test)
    finally:
        if os.path.exists(tfs.backing_dir(data_dir)):
            tfs.umount_fuse(remote, "n1", data_dir)
    hist, res = result["history"], result["results"]
    assert res["valid"] in (True, "unknown"), res
    assert not os.path.exists(tfs.backing_dir(data_dir))
    assert subprocess.run(["mountpoint", "-q", data_dir]).returncode != 0
    nem_ops = [o for o in hist if o.process == "nemesis"]
    assert any(o.f in ("break-all", "start") for o in nem_ops), nem_ops
    errs = [o for o in hist
            if o.process != "nemesis" and o.type in ("fail", "info")]
    assert errs, "the EIO storm failed no client op"
    assert [o for o in hist[-60:] if o.type == "ok"], \
        "no successful op after the heal"
