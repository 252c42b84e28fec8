"""Shared machinery for the hermetic protocol simulators (etcd_sim,
zk_sim): the flock-guarded JSON state store that makes a multi-process
simulated cluster linearizable by construction, and the tarball builder
that packages a simulator as an installable "database binary" for the
suites' normal install_archive path.

The port's copy of `jepsen_tpu/dbs/simbase.py`: it imports nothing of
`jepsen_tpu`. It adds `free_port` and `RecordingClockTools`, the clock
tools the simulated clusters' recipes give the clock nemeses, and
`sim_cluster`/`sim_test_fn`, the recipe the zookeeper, mongodb,
rethinkdb, elasticsearch, aerospike, hazelcast, rabbitmq, disque, MySQL
(galera, percona, mysql-cluster, tidb), crate, chronos and robustirc
simulators share.
"""

from __future__ import annotations

import fcntl
import json
import os
import shlex
import sys
import tempfile


class Store:
    """Shared, flock-serialized JSON state."""

    def __init__(self, path: str):
        self.path = path
        self.lock_path = path + ".lock"
        # Touch the lock file so flock always has a target.
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        open(self.lock_path, "a").close()

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _save(self, data: dict) -> None:
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(self.path)) or "."
        )
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, self.path)

    def transact(self, fn):
        """Run fn(state-dict) -> (result, new-state|None) under the
        exclusive lock; None keeps the state unchanged."""
        with open(self.lock_path, "a") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                data = self._load()
                result, new = fn(data)
                if new is not None:
                    self._save(new)
                return result
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


class StoreTxn:
    """An explicit multi-round-trip transaction on a Store: holds the
    flock from begin() to commit()/rollback(), with a bounded
    acquisition wait so contending transactions fail fast instead of
    queueing forever (crdb_sim surfaces that as SQLSTATE 40001, the
    shape of CockroachDB's 'restart transaction' errors)."""

    def __init__(self, store: Store):
        self.store = store
        self._lockf = None
        self.data: dict | None = None

    @property
    def active(self) -> bool:
        return self._lockf is not None

    def begin(self, timeout: float = 2.0) -> bool:
        """True if the lock was acquired and a working snapshot loaded;
        False on acquisition timeout."""
        import time as _time

        assert not self.active, "transaction already open"
        lockf = open(self.store.lock_path, "a")
        deadline = _time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(lockf, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if _time.monotonic() >= deadline:
                    lockf.close()
                    return False
                _time.sleep(0.005)
        self._lockf = lockf
        self.data = self.store._load()
        return True

    def commit(self) -> None:
        assert self.active, "no transaction open"
        try:
            self.store._save(self.data)
        finally:
            self._release()

    def rollback(self) -> None:
        if self.active:
            self._release()

    def _release(self) -> None:
        fcntl.flock(self._lockf, fcntl.LOCK_UN)
        self._lockf.close()
        self._lockf = None
        self.data = None


def build_sim_archive(dest: str, module: str, binary: str, arcname: str,
                      data_path: str, mean_latency: float = 0.0,
                      python: str | None = None,
                      pidfile: str | None = None) -> str:
    """Build a tar.gz whose `binary` is a script launching `module`
    (a jepsen_tpu_torch.dbs simulator) with a shared state file."""
    return build_multi_sim_archive(
        dest, arcname, {binary: module}, data_path,
        mean_latency=mean_latency, python=python, pidfile=pidfile)


def _already_running(module: str, pidfile: str,
                     marker: str = ".sim.pid") -> str:
    """Launcher lines that do what start-stop-daemon's --exec match does
    for a real binary, which it cannot do for a script that execs
    Python: if this node's simulator already runs (the pid the launcher
    last recorded in `marker` in the working directory, alive there and
    running `module`), put that pid back into `pidfile` (relative to the
    working directory), which start-stop-daemon has just overwritten,
    and start nothing."""
    return (
        f"old=$(cat {marker} 2>/dev/null)\n"
        "if [ -n \"$old\" ] && "
        "[ \"$(readlink /proc/$old/cwd 2>/dev/null)\" = \"$(pwd -P)\" ] && "
        f"grep -qaF {shlex.quote(module)} /proc/$old/cmdline 2>/dev/null; "
        "then\n"
        f"  echo \"$old\" > {shlex.quote(pidfile)}\n"
        "  exit 0\n"
        "fi\n"
        f"echo $$ > {marker}\n"
    )


def build_multi_sim_archive(dest: str, arcname: str, binaries: dict,
                            data_path: str, mean_latency: float = 0.0,
                            python: str | None = None,
                            pidfile: str | dict | None = None) -> str:
    """Build a tar.gz containing SEVERAL launcher scripts — the shape
    of multi-daemon systems (tidb's pd/tikv/tidb triple, mysql
    cluster's mgmd/ndbd/mysqld roles). `binaries` maps binary name ->
    jepsen_tpu_torch.dbs module; every script shares the same state file so
    the role daemons and the SQL daemon see one cluster. With `pidfile`
    (the suite's pidfile, relative to the directory the daemon starts
    in; or {binary: its pidfile}, for daemons that share a directory,
    each then recording its pid in a marker of its own), starting a
    daemon that already runs there does nothing, as start-stop-daemon
    does for a live real binary."""
    import tarfile

    python = python or sys.executable
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(os.path.dirname(os.path.abspath(dest)) or ".", exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, arcname)
        os.makedirs(top)
        for binary, module in binaries.items():
            if isinstance(pidfile, dict):
                guard = _already_running(module, pidfile[binary],
                                         f".sim-{binary}.pid")
            else:
                guard = _already_running(module, pidfile) if pidfile else ""
            script = (
                "#!/bin/bash\n"
                f"export PYTHONPATH={shlex.quote(repo_root)}:$PYTHONPATH\n"
                + guard
                + f"exec {shlex.quote(python)} -m {module} "
                f"--data {shlex.quote(data_path)} "
                f"--mean-latency {mean_latency} "
                "\"$@\"\n"
            )
            bin_path = os.path.join(top, binary)
            with open(bin_path, "w") as f:
                f.write(script)
            os.chmod(bin_path, 0o755)
        with tarfile.open(dest, "w:gz") as tar:
            tar.add(top, arcname=arcname)
    return dest


def free_port() -> int:
    """An ephemeral localhost TCP port."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RecordingClockTools:
    """Clock tools for the suites' clock nemeses on simulated nodes (the
    test map's "clock_tools"; `nemesis/time.py`'s `install`,
    `reset_time`, `bump_time`, `strobe_time`, `try_reset` and
    `bring_up`) that append (node, call, args) to `record` and set no
    clock: the simulated nodes share this machine's clock, and the
    native tools would set it (`LocalRemote` runs `sudo` commands as the
    caller). cockroachdb's `BumpTime` and `StrobeTime` and dgraph's
    `BumpTimeSkew` take them."""

    def __init__(self, record: list):
        self.record = record

    def install(self, remote, node) -> None:
        self.record.append((node, "install", ()))

    def reset_time(self, remote, node) -> None:
        self.record.append((node, "reset_time", ()))

    def bump_time(self, remote, node, delta_ms) -> None:
        self.record.append((node, "bump_time", (delta_ms,)))

    def strobe_time(self, remote, node, delta_ms, period_ms,
                    duration_s) -> None:
        self.record.append((node, "strobe_time",
                            (delta_ms, period_ms, duration_s)))

    def try_reset(self, remote, node) -> None:
        self.record.append((node, "try_reset", ()))

    def bring_up(self, test) -> None:
        for node in test["nodes"]:
            self.record.append((node, "bring_up", ()))


def sim_cluster(root: str, nodes, ports, key: str, arcname: str, build,
                ports_key: str = "ports", roles: tuple = (),
                role_ports: dict | None = None) -> dict:
    """The test-map entries that run a suite against simulated nodes on
    this machine, one simulator process a node: a LocalRemote whose nodes
    are directories under root/nodes, the simulator's archive (`build`,
    its `build_archive`; every node shares root/shared/state.json), and
    each node's port (`ports` = {node: port} to reuse a cluster's; else
    free ports), under the suite's config key `key` (`ports_key` names
    the ports there; each node installs into <node dir>/opt/<key>).
    A suite whose nodes run several daemons names the settings of its
    other daemons' ports in `roles` (tidb's "pd_ports", ...): each gets
    {node: port} from `role_ports` ({setting: {node: port}}, to reuse a
    cluster's, as "role_ports" of the result holds them), else free
    ports."""
    from ..control import LocalRemote

    remote = LocalRemote(root=os.path.join(root, "nodes"))
    archive = build(os.path.join(root, f"{arcname}.tar.gz"),
                    os.path.join(root, "shared", "state.json"))
    ports = ports or {n: free_port() for n in nodes}
    role_ports = {r: (role_ports or {}).get(r)
                  or {n: free_port() for n in nodes} for r in roles}
    return {
        "remote": remote,
        "archive_url": f"file://{archive}",
        "ports": ports,
        "role_ports": role_ports,
        key: {
            "addr_fn": lambda n: "127.0.0.1",
            ports_key: ports,
            **role_ports,
            "dir": lambda n: os.path.join(remote.node_dir(n), "opt", key),
            "sudo": None,
        },
    }


def sim_test_fn(cluster: dict, key: str, make_test, extra=None,
                refused=None):
    """A test-map constructor for `cli.single_test_cmd` on a
    `sim_cluster`: the command's options, with the cluster's entries and
    `extra` over them, go to `make_test` (the suite's `*_test`); then the
    OS is none (there is no real node to provision) and the network the
    no-op one, so the suite's own nemesis records and heals its
    partitions without changing traffic. The fs-break modes of --nemesis
    raise `cli.CliError` before anything runs on a node: their FUSE layer
    would mount over the nodes' data as the caller. So do the --nemesis
    names of `refused` ({name: why}), a suite's modes that would act on
    this machine itself."""
    def test_fn(opts: dict) -> dict:
        from .. import net
        from ..cli import CliError
        from .common import FSFAULT_NEMESIS_NAMES

        opts = {**opts, "remote": cluster["remote"], key: cluster[key],
                "archive_url": cluster["archive_url"], **(extra or {})}
        if opts.get("nemesis") in FSFAULT_NEMESIS_NAMES:
            raise CliError(f"--nemesis {opts['nemesis']}: the simulated "
                           "cluster cannot mount the FUSE fault layer")
        if opts.get("nemesis") in (refused or {}):
            raise CliError(f"--nemesis {opts['nemesis']}: not on the "
                           f"simulated cluster ({refused[opts['nemesis']]})")
        t = make_test(opts)
        t.update({"os": None, "net": net.noop})
        return t

    return test_fn
