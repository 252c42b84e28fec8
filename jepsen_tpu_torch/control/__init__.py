"""Remote execution: the control plane (reference: jepsen.control,
control.clj).

The reference drives nodes over SSH (JSch) with shell escaping, sudo
wrapping, retries, and scp. Here the transport is a pluggable `Remote`:

  SshRemote    shells out to the system ssh/scp binaries (OpenSSH),
               persistent via ControlMaster when available
  LocalRemote  runs commands in per-node sandbox directories on this
               machine via subprocess — hermetic multi-"node" testing
               without any cluster (the analog of docker/lxc setups,
               docker/README.md:1-22)
  DummyRemote  records commands and returns empty output
               (control.clj *dummy*, control.clj:16,288-300)

All higher layers (os/db/net/nemesis) talk to test["remote"], never to a
transport directly.

The port's copy of `jepsen_tpu/control/__init__.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import logging
import os
import shlex
import subprocess
import threading
from dataclasses import dataclass
from typing import Mapping

from ..util import with_retry

log = logging.getLogger("jepsen_tpu_torch.control")


@dataclass
class Result:
    out: str
    err: str
    exit: int
    cmd: str = ""

    @property
    def ok(self) -> bool:
        return self.exit == 0

    def throw(self) -> "Result":
        if not self.ok:
            raise RemoteError(
                f"command failed ({self.exit}): {self.cmd}\n{self.err or self.out}"
            )
        return self


class RemoteError(Exception):
    pass


def escape(arg) -> str:
    """Shell-escape one argument (control.clj:54-97). Sequences are
    joined with spaces after escaping each element."""
    if isinstance(arg, (list, tuple)):
        return " ".join(escape(a) for a in arg)
    return shlex.quote(str(arg))


def wrap_sudo(cmd: str, user: str = "root") -> str:
    """Wrap a shell command in sudo (control.clj:99-107)."""
    return f"sudo -S -u {user} bash -c {shlex.quote(cmd)}"


def wrap_cd(cmd: str, directory: str | None) -> str:
    """Prefix with a cd (control.clj:109-114)."""
    if not directory:
        return cmd
    return f"cd {shlex.quote(str(directory))} && {cmd}"


def build_cmd(cmd, sudo=None, cd=None) -> str:
    s = cmd if isinstance(cmd, str) else " ".join(escape(c) for c in cmd)
    s = wrap_cd(s, cd)
    if sudo:
        s = wrap_sudo(s, "root" if sudo is True else sudo)
    return s


class Remote:
    """Transport interface. exec() raises RemoteError on nonzero exit
    unless check=False."""

    def connect(self, node) -> None:
        pass

    def disconnect(self, node) -> None:
        pass

    def exec(
        self,
        node,
        cmd,
        sudo=None,
        cd=None,
        stdin: str | None = None,
        timeout: float | None = None,
        check: bool = True,
        retries: int = 0,
    ) -> Result:
        raise NotImplementedError

    def upload(self, node, local_path, remote_path) -> None:
        raise NotImplementedError

    def download(self, node, remote_path, local_path) -> None:
        raise NotImplementedError


class DummyRemote(Remote):
    """Records every command; returns empty success results
    (control.clj *dummy* mode)."""

    def __init__(self):
        self.commands: list = []
        self.uploads: list = []
        self.downloads: list = []
        self._lock = threading.Lock()

    def exec(self, node, cmd, sudo=None, cd=None, stdin=None, timeout=None,
             check=True, retries=0) -> Result:
        full = build_cmd(cmd, sudo, cd)
        with self._lock:
            self.commands.append((node, full))
        return Result("", "", 0, full)

    def upload(self, node, local_path, remote_path):
        with self._lock:
            self.uploads.append((node, str(local_path), str(remote_path)))

    def download(self, node, remote_path, local_path):
        with self._lock:
            self.downloads.append((node, str(remote_path), str(local_path)))


class LocalRemote(Remote):
    """Each "node" is a sandbox directory on this machine; commands run
    there via bash. sudo is a no-op wrapper (we're already the only
    user). Hermetic substitute for a container cluster."""

    def __init__(self, root: str | None = None):
        self.root = root or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "jepsen-tpu-nodes"
        )

    def node_dir(self, node) -> str:
        d = os.path.join(self.root, str(node))
        os.makedirs(d, exist_ok=True)
        return d

    def exec(self, node, cmd, sudo=None, cd=None, stdin=None, timeout=None,
             check=True, retries=0) -> Result:
        full = build_cmd(cmd, sudo=None, cd=cd)  # sudo elided locally

        def attempt():
            p = subprocess.run(
                ["bash", "-c", full],
                cwd=self.node_dir(node),
                input=stdin,
                capture_output=True,
                text=True,
                timeout=timeout,
                env={**os.environ, "JEPSEN_NODE": str(node)},
            )
            r = Result(p.stdout.strip(), p.stderr.strip(), p.returncode, full)
            return r.throw() if check else r

        return with_retry(attempt, retries=retries, exceptions=(RemoteError,))

    def upload(self, node, local_path, remote_path):
        import shutil

        dest = self._abs(node, remote_path)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copy(local_path, dest)

    def download(self, node, remote_path, local_path):
        import shutil

        os.makedirs(os.path.dirname(str(local_path)) or ".", exist_ok=True)
        shutil.copy(self._abs(node, remote_path), local_path)

    def _abs(self, node, path) -> str:
        path = str(path)
        nd = os.path.abspath(self.node_dir(node))
        if os.path.isabs(path):
            # Paths already inside the sandbox pass through (tests hand
            # DBs absolute sandbox dirs); anything else is confined.
            ap = os.path.abspath(path)
            if ap == nd or ap.startswith(nd + os.sep):
                return ap
            return os.path.join(nd, path.lstrip("/"))
        return os.path.join(nd, path)


class SshRemote(Remote):
    """OpenSSH subprocess transport with retry-on-corruption
    (control.clj:141-161) and scp file transfer (control.clj:199-231).

    Persistent by default via OpenSSH connection multiplexing: every
    exec/scp shares one master connection per node (ControlMaster=auto +
    ControlPath socket + ControlPersist), the analog of the reference's
    one JSch session per node held for the whole test (core.clj:611-620).
    connect() primes the master so nemesis grudges touching many nodes
    pay the handshake once, not per command."""

    def __init__(
        self,
        username: str = "root",
        port: int = 22,
        private_key_path: str | None = None,
        strict_host_key_checking: bool = False,
        connect_timeout: int = 10,
        control_master: bool = True,
        control_persist: int = 60,
    ):
        self.username = username
        self.port = port
        self.private_key_path = private_key_path
        self.strict = strict_host_key_checking
        self.connect_timeout = connect_timeout
        self.control_master = control_master
        self.control_persist = control_persist
        self._control_dir: str | None = None
        self._lock = threading.Lock()

    def _control_path_dir(self) -> str:
        """Socket dir, created lazily (kept short: unix socket paths cap
        out near 104 bytes)."""
        with self._lock:
            if self._control_dir is None:
                import shutil
                import tempfile
                import weakref

                self._control_dir = tempfile.mkdtemp(prefix="jt-cm-")
                weakref.finalize(
                    self, shutil.rmtree, self._control_dir,
                    ignore_errors=True,
                )
            return self._control_dir

    def _opts(self) -> list:
        o = [
            "-o", f"ConnectTimeout={self.connect_timeout}",
            "-o", "BatchMode=yes",
            "-p", str(self.port),
        ]
        if not self.strict:
            o += ["-o", "StrictHostKeyChecking=no",
                  "-o", "UserKnownHostsFile=/dev/null", "-o", "LogLevel=ERROR"]
        if self.private_key_path:
            o += ["-i", self.private_key_path]
        if self.control_master:
            o += [
                "-o", "ControlMaster=auto",
                "-o", f"ControlPath={self._control_path_dir()}/%C",
                "-o", f"ControlPersist={self.control_persist}",
                # a mux'd command has no fresh TCP connect, so
                # ConnectTimeout can't bound it — keepalives detect a
                # dead/black-holed master instead (~15s)
                "-o", "ServerAliveInterval=5",
                "-o", "ServerAliveCountMax=3",
            ]
        return o

    def connect(self, node) -> None:
        """Prime the per-node master connection (core.clj:611-620 opens
        one session per node up front); raises if the node is
        unreachable, like the reference's with-ssh."""
        self.exec(node, ["true"], retries=1)

    def disconnect(self, node) -> None:
        """Ask the master for this node to exit; best-effort."""
        if not self.control_master or self._control_dir is None:
            return
        try:
            subprocess.run(
                ["ssh", *self._opts(), "-O", "exit",
                 f"{self.username}@{node}"],
                capture_output=True, text=True, timeout=10,
            )
        except Exception:  # noqa: BLE001
            log.debug("ssh -O exit failed for %s", node, exc_info=True)

    def exec(self, node, cmd, sudo=None, cd=None, stdin=None, timeout=None,
             check=True, retries=3) -> Result:
        full = build_cmd(cmd, sudo, cd)
        argv = ["ssh", *self._opts(), f"{self.username}@{node}", full]

        def attempt():
            p = subprocess.run(
                argv, input=stdin, capture_output=True, text=True,
                timeout=timeout,
            )
            if p.returncode == 255:  # ssh transport failure: retry
                raise RemoteError(f"ssh transport failure: {p.stderr}")
            r = Result(p.stdout.strip(), p.stderr.strip(), p.returncode, full)
            return r.throw() if check else r

        return with_retry(
            attempt, retries=retries, backoff=0.5, exceptions=(RemoteError,)
        )

    def _scp(self, src, dest):
        opts = self._opts()
        # scp spells the port flag -P, ssh spells it -p
        opts[opts.index("-p")] = "-P"
        p = subprocess.run(
            ["scp", "-q", *opts, src, dest], capture_output=True, text=True
        )
        if p.returncode != 0:
            raise RemoteError(f"scp failed: {p.stderr}")

    def upload(self, node, local_path, remote_path):
        self._scp(str(local_path), f"{self.username}@{node}:{remote_path}")

    def download(self, node, remote_path, local_path):
        self._scp(f"{self.username}@{node}:{remote_path}", str(local_path))


def remote_for_test(test: Mapping) -> Remote:
    """Pick the remote: an explicit test["remote"], else SSH when
    credentials are given, else dummy (control.clj with-ssh + *dummy*)."""
    r = test.get("remote")
    if r is not None:
        return r
    ssh = test.get("ssh") or {}
    if ssh.get("dummy", False) or not ssh:
        return DummyRemote()
    return SshRemote(
        username=ssh.get("username", "root"),
        port=ssh.get("port", 22),
        private_key_path=ssh.get("private_key_path"),
        strict_host_key_checking=ssh.get("strict_host_key_checking", False),
        control_master=ssh.get("control_master", True),
        control_persist=ssh.get("control_persist", 60),
    )


def on_nodes(test, fn, nodes=None) -> dict:
    """Run fn(test, node) on each node in parallel; returns {node: result}
    (control.clj:345-381)."""
    from ..util import real_pmap

    nodes = list(nodes if nodes is not None else test["nodes"])
    results = real_pmap(lambda n: fn(test, n), nodes)
    return dict(zip(nodes, results))
