"""Filesystem fault-injection nemesis with TWO backends sharing one
control surface — break-all (every op fails EIO), break-one-percent
(~1% fail), clear — the TPU-era equivalent of the reference's
charybdefs layer (charybdefs/src/jepsen/charybdefs.clj:1-86):

1. **fuse** (charybdefs parity): `native/faultfs_fuse.cpp`, a FUSE
   passthrough filesystem speaking the raw kernel protocol over
   /dev/fuse (no libfuse, no thrift), mounted OVER the DB's data dir
   with the original directory as backing store. Faults any process's
   I/O — including STATICALLY LINKED executables (etcd, consul,
   cockroach, dgraph: most Go binaries) — because the fault lives
   below the VFS boundary, exactly like the reference's FUSE mount
   (charybdefs.clj:40-65). Needs root (the daemon calls mount(2)) and
   /dev/fuse on the node.

2. **preload**: `native/faultfs.cpp`, an LD_PRELOAD libc interposer
   wrapped around the DB binary, scoped to a path prefix. No mount,
   no /dev/fuse, works in unprivileged containers — BUT it is a
   silent no-op for statically linked executables, which never go
   through the dynamic loader. `wrap()` probes the target's ELF
   headers and REFUSES static binaries loudly rather than injecting
   nothing; route those through the fuse backend instead.

Use (fuse, the default where it can run):
    fsfault.install_fuse(remote, node)         # compile faultfs_fuse
    fsfault.mount_fuse(remote, node, "/opt/db/data")
    ... start the DB; its data dir is now fault-injectable ...
    nemesis = fsfault.fs_fault_nemesis(backend="fuse",
                                       data_dir_fn=...)

Use (preload):
    fsfault.install(remote, node)              # compile libfaultfs.so
    fsfault.wrap(remote, node, "/opt/db/bin", prefix="/opt/db/data")
    nemesis = fsfault.fs_fault_nemesis(prefix_fn)

Nemesis ops: {"f": "break-all"|"break-one-percent"|"clear"}, or the
start/stop convention: start == break (mode from the op's value or
the nemesis default), stop == clear.

The port's copy of `jepsen_tpu/nemesis/fsfault.py`: it imports nothing
of `jepsen_tpu`, and the C++ sources it uploads are the port's own
(`jepsen_tpu_torch/native/`).
"""

from __future__ import annotations

import logging
import os.path

from .. import osdist
from ..control import Remote, RemoteError
from ..control.util import exists
from ..util import real_pmap
from . import Nemesis

log = logging.getLogger("jepsen_tpu_torch.nemesis.fsfault")

OPT_DIR = "/opt/jepsen"
LIB_NAME = "libfaultfs.so"
CTL_NAME = "faultfs.ctl"

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")


def lib_path(opt_dir: str = OPT_DIR) -> str:
    return f"{opt_dir}/{LIB_NAME}"


def ctl_path(opt_dir: str = OPT_DIR) -> str:
    return f"{opt_dir}/{CTL_NAME}"


def compile_lib(remote: Remote, node, opt_dir: str = OPT_DIR) -> str:
    """Upload faultfs.cpp and build the shared library on the node
    (the charybdefs analog builds its FUSE binary on-node too,
    charybdefs.clj:40-65). Idempotent and atomic: an unchanged source
    skips the rebuild, and a rebuild lands via mv — rewriting a .so IN
    PLACE while a wrapped daemon has it mmapped can SIGBUS the
    daemon."""
    import hashlib

    src = os.path.join(_NATIVE_DIR, "faultfs.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    stamp = f"{opt_dir}/faultfs.src.{digest}"
    remote.exec(node, ["mkdir", "-p", opt_dir], sudo=True)
    remote.exec(node, ["chmod", "a+rwx", opt_dir], sudo=True)
    if exists(remote, node, stamp) and exists(remote, node,
                                              lib_path(opt_dir)):
        return lib_path(opt_dir)
    remote.upload(node, src, f"{opt_dir}/faultfs.cpp")
    remote.exec(
        node,
        ["g++", "-shared", "-fPIC", "-O2", "-o", f"{LIB_NAME}.tmp",
         "faultfs.cpp", "-ldl"],
        cd=opt_dir, sudo=True,
    )
    remote.exec(node, ["mv", "-f", f"{opt_dir}/{LIB_NAME}.tmp",
                       lib_path(opt_dir)], sudo=True)
    # one stamp at a time: a stale stamp from an OLDER source version
    # would let a revert skip the rebuild and run mismatched code
    remote.exec(node, f"rm -f {opt_dir}/faultfs.src.*", check=False)
    remote.exec(node, ["touch", stamp], sudo=True)
    return lib_path(opt_dir)


def install(remote: Remote, node, opt_dir: str = OPT_DIR) -> None:
    """Build the interposer; install a compiler and retry on failure
    (mirrors nemesis.time.install)."""
    try:
        compile_lib(remote, node, opt_dir)
    except RemoteError:
        try:
            osdist.install(remote, node, ["build-essential"])
        except RemoteError:
            osdist.centos_install(remote, node, ["gcc-c++"])
        compile_lib(remote, node, opt_dir)
    clear(remote, node, opt_dir)


def _write_ctl(remote: Remote, node, content: str,
               opt_dir: str = OPT_DIR) -> None:
    """Atomic control-file handoff: the interposer re-reads the file
    every 100 ms, and a reader racing a plain truncate-and-write could
    see 'all' with no scope line — i.e. fault EVERYTHING for a beat.
    tee to a temp path, then rename."""
    tmp = ctl_path(opt_dir) + ".tmp"
    remote.exec(node, ["tee", tmp], stdin=content, sudo=True)
    remote.exec(node, ["mv", "-f", tmp, ctl_path(opt_dir)], sudo=True)


def break_all(remote: Remote, node, prefix: str = "",
              opt_dir: str = OPT_DIR) -> None:
    """Every intercepted I/O call fails with EIO
    (charybdefs.clj:72-75)."""
    _write_ctl(remote, node, f"all\n{prefix}\n", opt_dir)


def break_percent(remote: Remote, node, pct: int = 1, prefix: str = "",
                  opt_dir: str = OPT_DIR) -> None:
    """~pct% of intercepted calls fail with EIO
    (charybdefs.clj:77-80 is the 1% case)."""
    _write_ctl(remote, node, f"percent {int(pct)}\n{prefix}\n", opt_dir)


def clear(remote: Remote, node, opt_dir: str = OPT_DIR) -> None:
    """Stop injecting faults (charybdefs.clj:82-85)."""
    _write_ctl(remote, node, "off\n", opt_dir)


FUSE_BIN = "faultfs_fuse"


def fuse_bin_path(opt_dir: str = OPT_DIR) -> str:
    return f"{opt_dir}/{FUSE_BIN}"


def compile_fuse(remote: Remote, node, opt_dir: str = OPT_DIR) -> str:
    """Upload faultfs_fuse.cpp and build the FUSE daemon on the node
    (charybdefs builds its FUSE binary on-node too,
    charybdefs.clj:40-65). Idempotent via a source-hash stamp, atomic
    via mv — same discipline as compile_lib."""
    import hashlib

    src = os.path.join(_NATIVE_DIR, "faultfs_fuse.cpp")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    stamp = f"{opt_dir}/faultfs_fuse.src.{digest}"
    remote.exec(node, ["mkdir", "-p", opt_dir], sudo=True)
    remote.exec(node, ["chmod", "a+rwx", opt_dir], sudo=True)
    if exists(remote, node, stamp) and exists(remote, node,
                                              fuse_bin_path(opt_dir)):
        return fuse_bin_path(opt_dir)
    remote.upload(node, src, f"{opt_dir}/faultfs_fuse.cpp")
    remote.exec(
        node,
        ["g++", "-O2", "-o", f"{FUSE_BIN}.tmp", "faultfs_fuse.cpp"],
        cd=opt_dir, sudo=True,
    )
    remote.exec(node, ["mv", "-f", f"{opt_dir}/{FUSE_BIN}.tmp",
                       fuse_bin_path(opt_dir)], sudo=True)
    remote.exec(node, f"rm -f {opt_dir}/faultfs_fuse.src.*", check=False)
    remote.exec(node, ["touch", stamp], sudo=True)
    return fuse_bin_path(opt_dir)


def install_fuse(remote: Remote, node, opt_dir: str = OPT_DIR) -> None:
    """Build the FUSE daemon; install a compiler and retry on failure
    (mirrors install())."""
    try:
        compile_fuse(remote, node, opt_dir)
    except RemoteError:
        try:
            osdist.install(remote, node, ["build-essential"])
        except RemoteError:
            osdist.centos_install(remote, node, ["gcc-c++"])
        compile_fuse(remote, node, opt_dir)
    clear(remote, node, opt_dir)


def backing_dir(data_dir: str) -> str:
    return data_dir.rstrip("/") + ".faultfs-backing"


def mount_fuse(remote: Remote, node, data_dir: str,
               opt_dir: str = OPT_DIR) -> None:
    """Interpose the FUSE layer over `data_dir`: the real directory
    moves aside to <data_dir>.faultfs-backing and faultfs_fuse mounts
    at the original path (the charybdefs /faulty analog, but in place
    — the DB's configuration never changes). Idempotent. The daemon
    requires root and /dev/fuse; a missing /dev/fuse fails loudly
    here rather than as a hung daemon."""
    if not exists(remote, node, "/dev/fuse"):
        raise RemoteError(
            f"no /dev/fuse on {node}: the fuse backend cannot run "
            "(use the preload backend for dynamically linked targets, "
            "or load the fuse kernel module)")
    back = backing_dir(data_dir)
    if not exists(remote, node, back):
        if exists(remote, node, data_dir):
            remote.exec(node, ["mv", data_dir, back], sudo=True)
        else:
            # fresh node (a db cycle wiped the tree): the DB will
            # populate the dir THROUGH the mount
            remote.exec(node, ["mkdir", "-p", back], sudo=True)
        remote.exec(node, ["mkdir", "-p", data_dir], sudo=True)
        # the mountpoint's OWN perms only matter unmounted; match the
        # backing dir so a crashed daemon degrades gracefully
        remote.exec(node, ["chmod", "--reference", back, data_dir],
                    sudo=True, check=False)
        remote.exec(node, ["chown", "--reference", back, data_dir],
                    sudo=True, check=False)
    # already mounted? (idempotence for retried setups)
    try:
        remote.exec(node, ["mountpoint", "-q", data_dir], sudo=True)
        return
    except RemoteError:
        pass
    remote.exec(node, [fuse_bin_path(opt_dir), back, data_dir,
                       ctl_path(opt_dir)], sudo=True)


def umount_fuse(remote: Remote, node, data_dir: str) -> None:
    """Tear the FUSE layer down and put the real directory back.
    The restore only runs once the mount is REALLY gone: with a busy
    mount still up, `mv backing data_dir` would target the live FUSE
    fs whose backing store is the source itself — stranding the real
    data. A busy mount gets a lazy (detached) unmount and a re-check."""
    back = backing_dir(data_dir)

    def mounted() -> bool:
        try:
            remote.exec(node, ["mountpoint", "-q", data_dir], sudo=True)
            return True
        except RemoteError:
            return False

    remote.exec(node, ["umount", data_dir], sudo=True, check=False)
    if mounted():
        remote.exec(node, ["umount", "-l", data_dir], sudo=True,
                    check=False)
        if mounted():
            raise RemoteError(
                f"{node}: {data_dir} is still mounted after umount -l; "
                f"refusing to restore {back} over a live mount")
    if exists(remote, node, back):
        remote.exec(node, ["rmdir", data_dir], sudo=True, check=False)
        remote.exec(node, ["mv", back, data_dir], sudo=True)


from .. import db as db_mod


class FaultFsDB(db_mod.DB, db_mod.LogFiles):
    """DB wrapper that interposes the FUSE fault layer around an inner
    DB's lifecycle: mount BEFORE the daemon starts (its data dir must
    not move underneath live file descriptors), unmount after
    teardown. This mirrors how the reference integrates charybdefs —
    as part of the DB stack, not the nemesis (charybdefs.clj:40-65
    runs at db setup time); the nemesis then only flips the fault
    switch (FsFaultNemesis(manage_mounts=False)).

    Subclasses DB + LogFiles so isinstance-dispatched capabilities
    (core's log snarfing above all — EIO-storm runs are exactly where
    the daemon logs matter) keep working through the wrapper;
    log_files delegates, returning [] for inner DBs without the
    mixin. Primary/ArchiveDB-specific dispatch (setup_primary, the
    kill/pause registry) does NOT pass through isinstance checks —
    wire those against the INNER db directly.

    Use:
        db = fsfault.FaultFsDB(EtcdDB(...), data_dir_fn)
    """

    def __init__(self, inner, data_dir_fn,
                 opt_dir: str | None = None):
        self.inner = inner
        self.data_dir_fn = data_dir_fn
        self.opt_dir = opt_dir

    def _opt(self, test) -> str:
        # explicit constructor arg wins; else the test map's
        # fsfault_opt_dir (how registry-built wirings plumb it); else
        # the default install dir
        return (self.opt_dir or (test or {}).get("fsfault_opt_dir")
                or OPT_DIR)

    def log_files(self, test, node) -> list:
        if isinstance(self.inner, db_mod.LogFiles):
            return self.inner.log_files(test, node)
        return []

    @staticmethod
    def _split(inner):
        """(install, start) when the inner DB's setup genuinely IS
        install-then-start — i.e. the class that OWNS setup() in the
        MRO also declares the split pieces. A subclass that overrides
        setup() without re-declaring install (tidb's multi-role
        bring-up, chronos' extra dirs) must NOT be bypassed: inherited
        install/start from a base class describe the BASE's setup, not
        the override's."""
        cls = type(inner)
        owner = next((k for k in cls.__mro__ if "setup" in vars(k)),
                     None)
        if owner is None:
            return None, None
        if "install" not in vars(owner):
            return None, None
        # "bring the daemon to ready": the piece must be the one the
        # setup-OWNING class declares (ArchiveDB's start_and_await;
        # etcd folds readiness into a bare start) — an inherited
        # start_and_await describes the BASE's setup, not an override
        # that deliberately composed install()+start() differently
        if "start_and_await" in vars(owner):
            return inner.install, inner.start_and_await
        if "start" in vars(owner):
            return inner.install, inner.start
        return None, None

    def setup(self, test, node) -> None:
        remote = test["remote"]
        opt_dir = self._opt(test)
        install_fuse(remote, node, opt_dir)
        inner_install, inner_start = self._split(self.inner)
        if inner_install and inner_start:
            # the right interposition point: after install's tree wipe,
            # before the daemon opens any file (a post-start mount
            # would miss every fd the daemon already holds)
            inner_install(test, node)
            mount_fuse(remote, node, self.data_dir_fn(test, node),
                       opt_dir)
            inner_start(test, node)
        else:
            # no install/start split: the data dir must live OUTSIDE
            # the inner DB's install tree, or its setup will collide
            # with the live mountpoint
            mount_fuse(remote, node, self.data_dir_fn(test, node),
                       opt_dir)
            self.inner.setup(test, node)

    def teardown(self, test, node) -> None:
        # unmount FIRST: the inner teardown's tree wipe cannot remove
        # a live mountpoint (EBUSY). umount_fuse falls back to a lazy
        # detach while the daemon still holds fds, then restores the
        # backing dir; the inner teardown then wipes the real tree.
        try:
            umount_fuse(remote=test["remote"], node=node,
                        data_dir=self.data_dir_fn(test, node))
        except RemoteError:
            log.warning("faultfs unmount failed on %s", node,
                        exc_info=True)
        self.inner.teardown(test, node)

    def __getattr__(self, name):
        # LogFiles / Primary / kill hooks etc. pass through untouched
        return getattr(self.inner, name)


def is_static(remote: Remote, node, cmd: str) -> bool | None:
    """True if `cmd` is a statically linked ELF (no PT_INTERP), False
    if dynamic, None if undeterminable (no readelf on the node and no
    usable fallback)."""
    try:
        # not an ELF at all (a #! script, e.g. the hermetic sims):
        # what executes is the INTERPRETER, which is dynamically
        # linked — LD_PRELOAD interposes fine
        magic = remote.exec(node, f"head -c 4 {cmd} | od -An -tx1").out
        if "7f 45 4c 46" not in magic:
            return False
    except RemoteError:
        pass
    try:
        out = remote.exec(node, ["readelf", "-l", cmd], sudo=True).out
        if "Program Headers" in out or "INTERP" in out:
            return "INTERP" not in out
    except RemoteError:
        pass
    try:
        # ldd prints "not a dynamic executable" on static binaries
        # (and exits nonzero on some distros — capture either way)
        out = remote.exec(node, f"ldd {cmd} 2>&1 || true").out
        if "not a dynamic executable" in out.lower():
            return True
        if "=>" in out or "linux-vdso" in out:
            return False
    except RemoteError:
        pass
    return None


def wrap(remote: Remote, node, cmd: str, prefix: str = "",
         opt_dir: str = OPT_DIR) -> None:
    """Replace executable `cmd` with a wrapper that launches the
    original under LD_PRELOAD=libfaultfs.so, keeping the original at
    cmd.no-faultfs; idempotent (the faketime.wrap pattern).

    REFUSES statically linked targets: LD_PRELOAD interposition rides
    the dynamic loader, so on a static binary (etcd, consul,
    cockroach — most Go executables) it silently injects NOTHING and
    every fault op becomes a vacuous no-op. Those targets need the
    fuse backend (mount_fuse), which faults below the VFS boundary."""
    st = is_static(remote, node, cmd)
    if st is True:
        raise RemoteError(
            f"{node}: {cmd} is statically linked: the LD_PRELOAD "
            "faultfs backend cannot interpose it (the dynamic loader "
            "never runs) — use the fuse backend (fsfault.mount_fuse "
            "over the data dir) instead")
    if st is None:
        log.warning(
            "%s: cannot determine whether %s is statically linked "
            "(no readelf/ldd); LD_PRELOAD faults will be silent "
            "no-ops if it is", node, cmd)
    orig = f"{cmd}.no-faultfs"
    wrapper = (
        "#!/bin/sh\n"
        f"export LD_PRELOAD={lib_path(opt_dir)}${{LD_PRELOAD:+:$LD_PRELOAD}}\n"
        f"export FAULTFS_CTL={ctl_path(opt_dir)}\n"
        f'exec {orig} "$@"\n'
    )
    if not exists(remote, node, orig):
        remote.exec(node, ["mv", cmd, orig], sudo=True)
    remote.exec(node, ["tee", cmd], stdin=wrapper, sudo=True)
    remote.exec(node, ["chmod", "a+x", cmd], sudo=True)


def unwrap(remote: Remote, node, cmd: str) -> None:
    """Restore the original executable."""
    orig = f"{cmd}.no-faultfs"
    if exists(remote, node, orig):
        remote.exec(node, ["mv", orig, cmd], sudo=True)


class FsFaultNemesis(Nemesis):
    """Drives faultfs across all nodes. Ops:

        {"f": "break-all"}          every I/O call fails EIO
        {"f": "break-one-percent"}  ~1% fail
        {"f": "break-percent", "value": pct}
        {"f": "clear"}              heal
        {"f": "start"}              alias for the default break mode
        {"f": "stop"}               alias for clear

    backend="preload": prefix_fn(test, node) -> path scopes faults to
    the system under test's data directory; the suite must have
    wrap()ed the (dynamically linked) binary.

    backend="fuse": data_dir_fn(test, node) -> the data directory to
    interpose; setup compiles the daemon and mounts it over the dir,
    teardown unmounts and restores. Works against any process,
    including static binaries (charybdefs.clj:40-85 parity). NOTE the
    standard run lifecycle starts the DB before nemesis setup — for
    real suites wrap the DB in FaultFsDB (which owns the mount) and
    pass manage_mounts=False here so this nemesis only flips the
    fault switch; manage_mounts=True is for harnesses that bring the
    DB up after the nemesis."""

    def __init__(self, prefix_fn=None, default_mode: str = "break-all",
                 opt_dir: str | None = None, backend: str = "preload",
                 data_dir_fn=None, manage_mounts: bool = True):
        assert backend in ("preload", "fuse"), backend
        if backend == "fuse" and manage_mounts and data_dir_fn is None:
            raise ValueError("fuse backend needs data_dir_fn")
        self.prefix_fn = prefix_fn or (lambda test, node: "")
        self.default_mode = default_mode
        self.opt_dir = opt_dir
        self.backend = backend
        self.data_dir_fn = data_dir_fn
        self.manage_mounts = manage_mounts

    def _opt(self, test) -> str:
        return (self.opt_dir or (test or {}).get("fsfault_opt_dir")
                or OPT_DIR)

    def setup(self, test):
        remote = test["remote"]
        opt_dir = self._opt(test)
        if self.backend == "fuse":
            if self.manage_mounts:
                def up(n):
                    install_fuse(remote, n, opt_dir)
                    mount_fuse(remote, n, self.data_dir_fn(test, n),
                               opt_dir)
                real_pmap(up, test["nodes"])
            else:  # FaultFsDB owns the mounts; start healed
                real_pmap(lambda n: clear(remote, n, opt_dir),
                          test["nodes"])
        else:
            real_pmap(lambda n: install(remote, n, opt_dir),
                      test["nodes"])
        return self

    def invoke(self, test, op):
        remote = test["remote"]
        f = op.f
        if f == "start":
            f = self.default_mode
        if f == "stop":
            f = "clear"

        opt_dir = self._opt(test)

        def apply(node):
            prefix = self.prefix_fn(test, node)
            if f == "break-all":
                break_all(remote, node, prefix, opt_dir)
            elif f == "break-one-percent":
                break_percent(remote, node, 1, prefix, opt_dir)
            elif f == "break-percent":
                break_percent(remote, node, int(op.value), prefix,
                              opt_dir)
            elif f == "clear":
                clear(remote, node, opt_dir)
            else:
                raise ValueError(f"fsfault can't handle {op.f!r}")
            return f

        res = dict(zip(test["nodes"],
                       real_pmap(apply, test["nodes"])))
        return op.with_(type="info", value=res)

    def teardown(self, test):
        remote = test["remote"]
        opt_dir = self._opt(test)
        for node in test["nodes"]:
            try:
                clear(remote, node, opt_dir)
            except RemoteError:
                log.warning("fsfault clear failed on %s", node,
                            exc_info=True)
            if self.backend == "fuse" and self.manage_mounts:
                try:
                    umount_fuse(remote, node,
                                self.data_dir_fn(test, node))
                except RemoteError:
                    log.warning("faultfs unmount failed on %s", node,
                                exc_info=True)


def fs_fault_nemesis(prefix_fn=None,
                     default_mode: str = "break-all",
                     backend: str = "preload",
                     data_dir_fn=None,
                     manage_mounts: bool = True,
                     opt_dir: str | None = None) -> FsFaultNemesis:
    return FsFaultNemesis(prefix_fn, default_mode, opt_dir=opt_dir,
                          backend=backend, data_dir_fn=data_dir_fn,
                          manage_mounts=manage_mounts)
