"""The port's control plane (`jepsen_tpu_torch.control`, `control.util`)
against the JAX package's: `build_cmd` and its escaping byte for byte,
`SshRemote`'s argv (there is no ssh binary here, so the argv and not a
connection), `remote_for_test`, DummyRemote's command stream; then
LocalRemote's exec, upload and download, and `install_archive`,
`start_daemon`, `daemon_running` and `stop_daemon` on a simulated etcd
node, and `grepkill` on a process the test started itself. Every wait
has a timeout, and every process a test starts is stopped in a
finalizer."""

from __future__ import annotations

import os
import subprocess
import sys
import time
import urllib.request

import pytest

from jepsen_tpu import control as jctl
from jepsen_tpu.control import util as jcu
from jepsen_tpu_torch import control as tctl
from jepsen_tpu_torch.control import util as tcu
from jepsen_tpu_torch.dbs import etcd_sim

from helpers import free_port

CMDS = [
    "echo hi",
    ["echo", "hi there"],
    ["ls", "-la", "/tmp/a b", "it's"],
    ["sh", "-c", "x=$(date); echo \"$x\" > /dev/null"],
    ["tar", ["--extract", "--file"], "/tmp/x.tar.gz"],
    ["printf", "%s\\n", "a;b&&c|d", "`uname`", "$HOME"],
    [1, 2.5, None, True],
]


@pytest.mark.parametrize("cmd", CMDS, ids=range(len(CMDS)))
@pytest.mark.parametrize("sudo", [None, True, "postgres"])
@pytest.mark.parametrize("cd", [None, "/opt/my db"])
def test_build_cmd_equal(cmd, sudo, cd):
    assert tctl.build_cmd(cmd, sudo, cd) == jctl.build_cmd(cmd, sudo, cd)
    assert tctl.escape(cmd) == jctl.escape(cmd)


class _Captured:
    returncode = 0
    stdout = "out\n"
    stderr = ""


def _argvs(ctl, monkeypatch, **kw):
    """Every argv an SshRemote hands subprocess.run for one exec (with
    and without sudo, cd and stdin), an upload, a download and a
    disconnect."""
    seen = []

    def fake_run(argv, **k):
        seen.append((list(argv), k.get("input")))
        return _Captured()

    monkeypatch.setattr(ctl.subprocess, "run", fake_run)
    r = ctl.SshRemote(**kw)
    if r.control_master:
        r._control_dir = "/tmp/jt-cm-fixed"  # the socket dir, made per run
    r.connect("n1")
    r.exec("n2", ["cat", "/etc/hosts"], sudo=True, cd="/var/log",
           stdin="data")
    r.exec("n3", "uptime")
    r.upload("n1", "/tmp/local file", "/opt/remote")
    r.download("n4", "/var/log/x.log", "/tmp/x.log")
    r.disconnect("n1")
    return seen


@pytest.mark.parametrize("kw", [
    {},
    {"control_master": False},
    {"username": "admin", "port": 2222, "private_key_path": "/k/id_ed25519",
     "strict_host_key_checking": True},
    {"connect_timeout": 3, "control_persist": 5},
], ids=["default", "no-master", "creds", "timeouts"])
def test_ssh_remote_argv_equal(kw, monkeypatch):
    assert _argvs(tctl, monkeypatch, **kw) == _argvs(jctl, monkeypatch, **kw)


def test_remote_for_test_equal():
    for test in ({}, {"ssh": {"dummy": True}},
                 {"ssh": {"username": "u", "port": 2200,
                          "private_key_path": "/k", "control_master": False}}):
        j, t = jctl.remote_for_test(test), tctl.remote_for_test(test)
        assert type(j).__name__ == type(t).__name__
        if isinstance(t, tctl.SshRemote):
            assert (t.username, t.port, t.private_key_path, t.strict,
                    t.control_master) == (j.username, j.port,
                                          j.private_key_path, j.strict,
                                          j.control_master)
    given = tctl.LocalRemote(root="/nonexistent")
    assert tctl.remote_for_test({"remote": given}) is given


def test_dummy_remote_and_util_commands_equal():
    def run(ctl, cu):
        r = ctl.DummyRemote()
        cu.start_daemon(r, "n1", "/opt/db/bin", "--port", 7, logfile="/l",
                        pidfile="/p", chdir="/opt/db", env={"A": "1"})
        cu.stop_daemon(r, "n1", "/p", cmd="db")
        cu.grepkill(r, "n2", "db[d]", signal=15)
        cu.ensure_user(r, "n3", "dbuser")
        r.exec("n1", ["rm", "-rf", "/x y"], sudo=True, cd="/")
        return r.commands

    j, t = run(jctl, jcu), run(tctl, tcu)
    # byte for byte, the start line's `date` format included
    assert t == j


@pytest.fixture
def local(tmp_path):
    return tctl.LocalRemote(root=str(tmp_path / "nodes"))


def test_local_remote_exec_upload_download(local, tmp_path):
    r = local.exec("n1", ["sh", "-c", "echo $JEPSEN_NODE; pwd"])
    assert r.ok and r.out.splitlines() == ["n1", local.node_dir("n1")]
    assert local.exec("n1", "exit 3", check=False).exit == 3
    with pytest.raises(tctl.RemoteError):
        local.exec("n1", "exit 3")
    assert local.exec("n2", ["cat"], stdin="piped").out == "piped"
    src = tmp_path / "up.txt"
    src.write_text("payload")
    local.upload("n2", str(src), "/etc/conf/up.txt")
    inside = os.path.join(local.node_dir("n2"), "etc", "conf", "up.txt")
    assert open(inside).read() == "payload"
    local.download("n2", "/etc/conf/up.txt", str(tmp_path / "back.txt"))
    assert (tmp_path / "back.txt").read_text() == "payload"
    assert tcu.exists(local, "n2", "etc/conf/up.txt")
    assert tcu.ls(local, "n2", "etc/conf") == ["up.txt"]


def test_sim_node_install_start_stop(local, tmp_path):
    """The etcd simulator's archive installs, starts under
    start-stop-daemon, answers, and stops, as a real node would."""
    archive = str(tmp_path / "sim.tar.gz")
    etcd_sim.build_archive(archive, str(tmp_path / "shared" / "state.json"))
    d = os.path.join(local.node_dir("n1"), "opt", "etcd")
    pidfile = f"{d}/etcd.pid"
    port = free_port()
    try:
        assert tcu.install_archive(local, "n1", f"file://{archive}", d) == d
        assert os.access(os.path.join(d, "etcd"), os.X_OK)
        assert tcu.daemon_running(local, "n1", pidfile) is None
        url = f"http://127.0.0.1:{port}"
        tcu.start_daemon(local, "n1", f"{d}/etcd", "--name", "n1",
                         "--listen-client-urls", url,
                         logfile=f"{d}/etcd.log", pidfile=pidfile, chdir=d)
        deadline = time.monotonic() + 30
        while True:
            try:
                with urllib.request.urlopen(url + "/version", timeout=2) as r:
                    assert r.status == 200
                    break
            except OSError:
                assert time.monotonic() < deadline, "sim never answered"
                time.sleep(0.1)
        assert tcu.daemon_running(local, "n1", pidfile) is True
    finally:
        tcu.stop_daemon(local, "n1", pidfile)
    assert tcu.daemon_running(local, "n1", pidfile) is None
    assert "Jepsen starting" in open(f"{d}/etcd.log").read()


def test_local_scratch_stays_in_node_dir(local, tmp_path):
    """On a LocalRemote the node's scratch space (/tmp/jepsen) is under
    the node's own directory, and an archive install runs no command on
    the machine's /tmp/jepsen and leaves its scratch empty."""
    base = os.path.join(local.node_dir("n1"), "tmp", "jepsen")
    assert tcu.tmp_base(local, "n1") == base
    assert tcu.tmp_base(tctl.DummyRemote(), "n1") == tcu.TMP_DIR_BASE
    d = tcu.tmp_dir(local, "n1")
    assert os.path.dirname(d) == base and os.path.isdir(d)
    archive = str(tmp_path / "sim.tar.gz")
    etcd_sim.build_archive(archive, str(tmp_path / "shared" / "state.json"))
    cmds, run_cmd = [], local.exec

    def exec_(node, cmd, *a, **k):
        cmds.append((cmd if isinstance(cmd, str) else " ".join(cmd), k))
        return run_cmd(node, cmd, *a, **k)

    local.exec = exec_
    dest = os.path.join(local.node_dir("n2"), "opt", "etcd")
    tcu.install_archive(local, "n2", f"file://{archive}", dest)
    n2 = os.path.join(local.node_dir("n2"), "tmp", "jepsen")
    for c, k in cmds:
        assert " /tmp/jepsen" not in c and not str(
            k.get("cd", "")).startswith("/tmp/jepsen"), c
    assert any(str(k.get("cd", "")).startswith(n2) for _, k in cmds)
    assert os.listdir(n2) == []


def test_grepkill_kills_own_process(local, monkeypatch):
    # grepkill's pipeline is `ps aux | grep ...` (the JAX package's, byte
    # for byte); ps cuts its lines at $COLUMNS when it is set (a test
    # runner may set it to its terminal's width), which can cut the
    # marker off: give ps the whole line
    monkeypatch.setenv("COLUMNS", "100000")
    marker = f"jepsen-port-gk-{os.getpid()}-{time.monotonic_ns()}"
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(120)", marker])
    try:
        deadline = time.monotonic() + 20
        while marker not in local.exec("n1", "ps aux", check=False).out:
            assert time.monotonic() < deadline, "target never listed"
            time.sleep(0.05)
        # a bracket class, so the pipeline's own line does not match
        tcu.grepkill(local, "n1", f"[j]{marker[1:]}")
        p.wait(timeout=20)
        assert p.returncode == -9
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=20)
