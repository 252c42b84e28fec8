"""Remote install/daemon helpers (reference: jepsen.control.util,
control/util.clj:1-264).

All functions take an explicit (remote, node) pair — the framework passes
state explicitly instead of the reference's dynamic vars — and otherwise
keep the reference's semantics: /tmp/jepsen scratch space, cached wgets
keyed by base64 URL, archive installs that flatten a single top-level
directory, start-stop-daemon-style daemon management.

The port's copy of `jepsen_tpu/control/util.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import base64
import logging
import os.path
import random

from . import LocalRemote, Remote, RemoteError

log = logging.getLogger("jepsen_tpu_torch.control.util")

#: scratch space on nodes (control/util.clj:10)
TMP_DIR_BASE = "/tmp/jepsen"

#: wget cache (control/util.clj:75-77)
WGET_CACHE_DIR = f"{TMP_DIR_BASE}/wget-cache"

#: standard wget retry options (control/util.clj:53-60)
STD_WGET_OPTS = [
    "--tries", "20",
    "--waitretry", "60",
    "--retry-connrefused",
    "--dns-timeout", "60",
    "--connect-timeout", "60",
    "--read-timeout", "60",
]


def exists(remote: Remote, node, path) -> bool:
    """Is a path present (control/util.clj:18-23)?"""
    return remote.exec(node, ["stat", str(path)], check=False).exit == 0


def ls(remote: Remote, node, directory=".") -> list[str]:
    """Directory entries, without . and .. (control/util.clj:25-31)."""
    out = remote.exec(node, ["ls", "-A", str(directory)]).out
    return [line for line in out.splitlines() if line.strip()]


def ls_full(remote: Remote, node, directory) -> list[str]:
    """ls with the directory prepended (control/util.clj:33-41)."""
    d = str(directory)
    if not d.endswith("/"):
        d += "/"
    return [d + e for e in ls(remote, node, d)]


def tmp_base(remote: Remote, node) -> str:
    """The node's scratch space: TMP_DIR_BASE, or on a LocalRemote that
    path under the node's own directory (its exec runs an absolute path
    as it is, and the machine's /tmp is no node's)."""
    if isinstance(remote, LocalRemote):
        return os.path.join(remote.node_dir(node), TMP_DIR_BASE.lstrip("/"))
    return TMP_DIR_BASE


def tmp_dir(remote: Remote, node) -> str:
    """A fresh temporary directory under the node's scratch space,
    /tmp/jepsen (control/util.clj:43-51)."""
    while True:
        d = f"{tmp_base(remote, node)}/{random.randrange(2**31)}"
        if not exists(remote, node, d):
            remote.exec(node, ["mkdir", "-p", d])
            return d


def wget(remote: Remote, node, url: str, force: bool = False) -> str:
    """Download url into the cwd, skipping if present; returns the
    filename (control/util.clj:62-73)."""
    filename = os.path.basename(url)
    if force:
        remote.exec(node, ["rm", "-f", filename])
    if not exists(remote, node, filename):
        remote.exec(node, ["wget", *STD_WGET_OPTS, url])
    return filename


def cached_wget(remote: Remote, node, url: str, force: bool = False) -> str:
    """Download url into the wget cache, named by its base64-encoded URL
    (so versions living in the path, not the filename, still get distinct
    cache entries); returns the full path (control/util.clj:79-104)."""
    encoded = base64.b64encode(url.encode()).decode()
    cache = f"{tmp_base(remote, node)}/wget-cache"  # WGET_CACHE_DIR
    dest = f"{cache}/{encoded}"
    if force:
        log.info("Clearing cached copy of %s", url)
        remote.exec(node, ["rm", "-rf", dest])
    if not exists(remote, node, dest):
        log.info("Downloading %s", url)
        remote.exec(node, ["mkdir", "-p", cache])
        remote.exec(
            node, ["wget", *STD_WGET_OPTS, "-O", dest, url], cd=cache
        )
    return dest


def install_archive(
    remote: Remote,
    node,
    url: str,
    dest: str,
    force: bool = False,
    sudo=None,
    _retried: bool = False,
) -> str:
    """Fetch a zip/tarball (cached) and extract it to dest, replacing
    dest's contents; a sole top-level directory is flattened into dest.
    Corrupt cached downloads are re-fetched once
    (control/util.clj:106-173)."""
    local_file = url[len("file://"):] if url.startswith("file://") else None
    archive = local_file or cached_wget(remote, node, url, force=force)
    tmpdir = tmp_dir(remote, node)
    remote.exec(node, ["rm", "-rf", dest], sudo=sudo)
    remote.exec(node, ["mkdir", "-p", os.path.dirname(dest) or "/"], sudo=sudo)
    try:
        if url.endswith(".zip"):
            remote.exec(node, ["unzip", archive], cd=tmpdir)
        else:
            remote.exec(
                node,
                ["tar", "--no-same-owner", "--no-same-permissions",
                 "--extract", "--file", archive],
                cd=tmpdir,
            )
        if sudo:
            remote.exec(node, ["chown", "-R", "root:root", "."],
                        cd=tmpdir, sudo=sudo)
        roots = ls(remote, node, tmpdir)
        if not roots:
            raise RemoteError("Archive contained no files")
        if len(roots) == 1:
            remote.exec(node, ["mv", f"{tmpdir}/{roots[0]}", dest], sudo=sudo)
        else:
            remote.exec(node, ["mv", tmpdir, dest], sudo=sudo)
        return dest
    except RemoteError as e:
        if "Unexpected EOF" in str(e):
            if local_file:
                raise RemoteError(
                    f"Local archive {local_file} on node {node} is corrupt: "
                    "unexpected EOF."
                ) from e
            if not _retried:
                log.info("Retrying corrupt archive download")
                remote.exec(node, ["rm", "-rf", archive])
                return install_archive(
                    remote, node, url, dest, force=force, sudo=sudo,
                    _retried=True,
                )
        raise
    finally:
        remote.exec(node, ["rm", "-rf", tmpdir], check=False)


def ensure_user(remote: Remote, node, username: str) -> str:
    """Make sure a user exists (control/util.clj:182-189)."""
    r = remote.exec(
        node,
        ["adduser", "--disabled-password", "--gecos", "", username],
        sudo=True,
        check=False,
    )
    if r.exit != 0 and "already exists" not in (r.err + r.out):
        r.throw()
    return username


def grepkill(remote: Remote, node, pattern: str, signal: int = 9) -> None:
    """Kill processes whose ps line matches pattern
    (control/util.clj:191-206)."""
    remote.exec(
        node,
        f"ps aux | grep {pattern} | grep -v grep | awk '{{print $2}}' "
        f"| xargs -r kill -{signal}",
        check=False,
    )


def start_daemon(
    remote: Remote,
    node,
    bin: str,
    *args,
    logfile: str,
    pidfile: str,
    chdir: str = "/",
    background: bool = True,
    make_pidfile: bool = True,
    match_executable: bool = True,
    match_process_name: bool = False,
    process_name: str | None = None,
    env: dict | None = None,
) -> None:
    """Start a daemon via start-stop-daemon, appending stdout/stderr to
    logfile (control/util.clj:208-236)."""
    log.info("starting %s", os.path.basename(bin))
    remote.exec(
        node,
        f"echo \"`date +'%Y-%m-%d %H:%M:%S'` Jepsen starting {bin} "
        f"{' '.join(str(a) for a in args)}\" >> {logfile}",
    )
    argv = ["start-stop-daemon", "--start"]
    if background:
        argv += ["--background", "--no-close"]
    if make_pidfile:
        argv += ["--make-pidfile"]
    if match_executable:
        argv += ["--exec", bin]
    if match_process_name:
        argv += ["--name", process_name or os.path.basename(bin)]
    argv += ["--pidfile", pidfile, "--chdir", chdir, "--oknodo",
             "--startas", bin, "--"]
    argv += [str(a) for a in args]
    cmd = " ".join(argv) + f" >> {logfile} 2>&1"
    if env:
        exports = " ".join(f"{k}={v}" for k, v in env.items())
        cmd = f"env {exports} {cmd}"
    remote.exec(node, cmd)


def stop_daemon(remote: Remote, node, pidfile: str, cmd: str | None = None
                ) -> None:
    """Kill a daemon by pidfile — or by command name, if given — and
    remove the pidfile (control/util.clj:238-251)."""
    if cmd is not None:
        log.info("Stopping %s", cmd)
        remote.exec(node, ["killall", "-9", "-w", cmd], check=False)
        remote.exec(node, ["rm", "-rf", pidfile], check=False)
        return
    if exists(remote, node, pidfile):
        log.info("Stopping %s", pidfile)
        pid = remote.exec(node, ["cat", pidfile]).out.strip()
        if pid:
            remote.exec(node, ["kill", "-9", pid], check=False)
        remote.exec(node, ["rm", "-rf", pidfile], check=False)


def daemon_running(remote: Remote, node, pidfile: str) -> bool | None:
    """True if pidfile names a live process, None if no pidfile, False if
    the process is gone (control/util.clj:253-264)."""
    r = remote.exec(node, ["cat", pidfile], check=False)
    if r.exit != 0 or not r.out.strip():
        return None
    return remote.exec(
        node, ["ps", "-o", "pid=", "-p", r.out.strip()], check=False
    ).exit == 0
