"""Concrete OS provisioning for Debian and CentOS nodes (reference:
jepsen.os.debian os/debian.clj:1-169 and jepsen.os.centos
os/centos.clj:1-160).

Functions take an explicit (remote, node) pair. The OS objects install
the same base tool set the reference does (wget, iptables, psmisc,
ntpdate, faketime, ...) and heal the network on setup.

The port's copy of `jepsen_tpu/osdist.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import logging

from .control import Remote
from .control.util import exists
from .osenv import OS

log = logging.getLogger("jepsen_tpu_torch.osdist")

#: base packages every node gets (os/debian.clj:147-165)
BASE_PACKAGES = [
    "wget", "curl", "unzip", "iptables", "psmisc", "tar", "bzip2",
    "ntpdate", "faketime", "iputils-ping", "iproute2", "rsyslog",
    "logrotate",
]


# ---------------------------------------------------------------------------
# Debian

def setup_hostfile(remote: Remote, node) -> None:
    """Ensure /etc/hosts maps loopback to plain localhost
    (os/debian.clj:12-25)."""
    hosts = remote.exec(node, ["cat", "/etc/hosts"]).out
    lines = [
        "127.0.0.1\tlocalhost" if line.startswith("127.0.0.1\t") else line
        for line in hosts.splitlines()
    ]
    new = "\n".join(lines)
    if new != hosts:
        remote.exec(node, ["tee", "/etc/hosts"], stdin=new, sudo=True)


def time_since_last_update(remote: Remote, node) -> int:
    """Seconds since the last apt-get update (os/debian.clj:27-31)."""
    try:
        now = int(remote.exec(node, ["date", "+%s"]).out)
    except ValueError:
        return 0  # dummy-mode remote: treat the cache as fresh
    r = remote.exec(
        node,
        "stat -c %Y /var/cache/apt/pkgcache.bin || echo 0",
        check=False,
    )
    try:
        last = int(r.out.split()[-1])
    except (ValueError, IndexError):
        last = 0
    return now - last


def update(remote: Remote, node) -> None:
    """apt-get update (os/debian.clj:33-36)."""
    remote.exec(node, ["apt-get", "update"], sudo=True)


def maybe_update(remote: Remote, node) -> None:
    """apt-get update at most once a day (os/debian.clj:38-42)."""
    if time_since_last_update(remote, node) > 86400:
        update(remote, node)


def installed(remote: Remote, node, pkgs) -> set:
    """Subset of pkgs currently installed (os/debian.clj:44-54)."""
    pkgs = [str(p) for p in pkgs]
    r = remote.exec(node, ["dpkg", "--get-selections", *pkgs], check=False)
    out = set()
    for line in r.out.splitlines():
        parts = line.split()
        if len(parts) >= 2 and parts[1] == "install":
            out.add(parts[0])
    return out


def is_installed(remote: Remote, node, pkgs) -> bool:
    """Are all of the given packages installed (os/debian.clj:63-68)?"""
    pkgs = [str(p) for p in pkgs]
    return set(pkgs) <= installed(remote, node, pkgs)


def installed_version(remote: Remote, node, pkg) -> str | None:
    """Version of an installed package, or None (os/debian.clj:70-76)."""
    import re

    out = remote.exec(node, ["apt-cache", "policy", str(pkg)], check=False).out
    m = re.search(r"Installed: (\S+)", out)
    if m and m.group(1) != "(none)":
        return m.group(1)
    return None


def uninstall(remote: Remote, node, pkgs) -> None:
    """Purge packages (os/debian.clj:56-61)."""
    pkgs = [pkgs] if isinstance(pkgs, str) else list(pkgs)
    present = installed(remote, node, pkgs)
    if present:
        remote.exec(
            node,
            ["apt-get", "remove", "--purge", "-y", *sorted(present)],
            sudo=True,
        )


def install(remote: Remote, node, pkgs) -> None:
    """Ensure packages are installed; a dict pins versions
    (os/debian.clj:78-99)."""
    if isinstance(pkgs, dict):
        for pkg, version in pkgs.items():
            if installed_version(remote, node, pkg) != version:
                log.info("Installing %s %s", pkg, version)
                remote.exec(
                    node,
                    ["env", "DEBIAN_FRONTEND=noninteractive", "apt-get",
                     "install", "-y", f"{pkg}={version}"],
                    sudo=True,
                )
        return
    pkgs = {str(p) for p in pkgs}
    missing = pkgs - installed(remote, node, pkgs)
    if missing:
        log.info("Installing %s", sorted(missing))
        remote.exec(
            node,
            ["env", "DEBIAN_FRONTEND=noninteractive", "apt-get", "install",
             "-y", *sorted(missing)],
            sudo=True,
        )


def add_key(remote: Remote, node, keyserver: str, key: str) -> None:
    """Receive an apt key (os/debian.clj:101-107)."""
    remote.exec(
        node,
        ["apt-key", "adv", "--keyserver", keyserver, "--recv", key],
        sudo=True,
    )


def add_repo(remote: Remote, node, repo_name: str, apt_line: str,
             keyserver: str | None = None, key: str | None = None) -> None:
    """Add an apt repo + optional key, then update
    (os/debian.clj:109-120)."""
    list_file = f"/etc/apt/sources.list.d/{repo_name}.list"
    if not exists(remote, node, list_file):
        log.info("setting up %s apt repo", repo_name)
        if keyserver or key:
            add_key(remote, node, keyserver, key)
        remote.exec(node, ["tee", list_file], stdin=apt_line, sudo=True)
        update(remote, node)


def install_jdk(remote: Remote, node) -> None:
    """Ensure a JDK is present (os/debian.clj:122-136 installs Oracle
    jdk8 via the long-dead webupd8 PPA; modern Debian ships OpenJDK in
    main, so we install that instead of resurrecting the PPA dance)."""
    install(remote, node, ["default-jdk-headless"])


class Debian(OS):
    """Debian provisioning: hostfile, apt update, base packages, heal
    the network (os/debian.clj:138-169)."""

    def setup(self, test, node) -> None:
        log.info("%s setting up debian", node)
        remote = test["remote"]
        setup_hostfile(remote, node)
        maybe_update(remote, node)
        install(remote, node, BASE_PACKAGES)
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001
            log.warning("net heal failed during OS setup", exc_info=True)

    def teardown(self, test, node) -> None:
        pass


debian = Debian()


# ---------------------------------------------------------------------------
# CentOS

def centos_setup_hostfile(remote: Remote, node) -> None:
    """Append the hostname to the loopback line (os/centos.clj:12-25)."""
    name = remote.exec(node, ["hostname"]).out.strip()
    hosts = remote.exec(node, ["cat", "/etc/hosts"]).out
    lines = [
        f"{line} {name}"
        if line.startswith("127.0.0.1") and name not in line
        else line
        for line in hosts.splitlines()
    ]
    remote.exec(node, ["tee", "/etc/hosts"], stdin="\n".join(lines), sudo=True)


def centos_installed(remote: Remote, node, pkgs) -> set:
    """Subset of pkgs yum reports installed (os/centos.clj:50-61)."""
    import re

    pkgs = {str(p) for p in pkgs}
    out = remote.exec(node, ["yum", "list", "installed"], check=False).out
    found = set()
    for line in out.splitlines():
        first = line.split()[0] if line.split() else ""
        m = re.match(r"(.*)\.[^\-.]+$", first)
        if m:
            found.add(m.group(1))
    return pkgs & found


def centos_install(remote: Remote, node, pkgs) -> None:
    """Ensure packages are installed via yum (os/centos.clj:92-112)."""
    pkgs = {str(p) for p in pkgs}
    missing = pkgs - centos_installed(remote, node, pkgs)
    if missing:
        log.info("Installing %s", sorted(missing))
        remote.exec(node, ["yum", "-y", "install", *sorted(missing)],
                    sudo=True)


class CentOS(OS):
    """CentOS provisioning via yum (os/centos.clj:133-160)."""

    PACKAGES = [
        "wget", "curl", "unzip", "iptables", "psmisc", "tar", "bzip2",
        "ntpdate", "iputils", "iproute", "rsyslog", "logrotate",
    ]

    def setup(self, test, node) -> None:
        log.info("%s setting up centos", node)
        remote = test["remote"]
        centos_setup_hostfile(remote, node)
        centos_install(remote, node, self.PACKAGES)
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001
            log.warning("net heal failed during OS setup", exc_info=True)

    def teardown(self, test, node) -> None:
        pass


centos = CentOS()


# ---------------------------------------------------------------------------
# SmartOS (os/smartos.clj:1-132): pkgin package management, loopback
# hostfile entry, ipfilter service.


def smartos_setup_hostfile(remote: Remote, node) -> None:
    """Ensure /etc/hosts' loopback line mentions the local hostname
    (os/smartos.clj:12-25) — same append-hostname behavior as CentOS,
    so reuse it (the centos variant matches both tab- and
    space-separated loopback lines)."""
    centos_setup_hostfile(remote, node)


def smartos_time_since_last_update(remote: Remote, node) -> int:
    """Seconds since the last pkgin update (os/smartos.clj:27-31)."""
    now = int(remote.exec(node, ["date", "+%s"]).out.strip())
    then = int(remote.exec(
        node, ["stat", "-c", "%Y", "/var/db/pkgin/sql.log"]).out.strip())
    return now - then


def smartos_update(remote: Remote, node) -> None:
    remote.exec(node, ["pkgin", "update"], sudo=True)


def smartos_maybe_update(remote: Remote, node) -> None:
    """pkgin update if we haven't in a day (os/smartos.clj:37-43)."""
    try:
        if smartos_time_since_last_update(remote, node) > 86400:
            smartos_update(remote, node)
    except Exception:  # noqa: BLE001 — missing sql.log etc.
        smartos_update(remote, node)


def _pkgin_list(remote: Remote, node) -> dict:
    """{package-name: version} from `pkgin -p list` lines like
    "name-1.2.3;..." (os/smartos.clj:45-57,72-84)."""
    out = {}
    listing = remote.exec(node, ["pkgin", "-p", "list"]).out
    for line in listing.splitlines():
        full = line.split(";", 1)[0].strip()
        if not full or "-" not in full:
            continue
        name_part, _, version = full.rpartition("-")
        if name_part:
            out[name_part] = version
    return out


def smartos_installed(remote: Remote, node, pkgs) -> set:
    pkgs = {str(p) for p in pkgs}
    return pkgs & set(_pkgin_list(remote, node))


def smartos_installed_version(remote: Remote, node, pkg) -> str | None:
    return _pkgin_list(remote, node).get(str(pkg))


def smartos_uninstall(remote: Remote, node, pkgs) -> None:
    present = smartos_installed(remote, node, pkgs)
    if present:
        remote.exec(node, ["pkgin", "-y", "remove", *sorted(present)],
                    sudo=True)


def smartos_install(remote: Remote, node, pkgs) -> None:
    """Ensure packages are installed; a dict pins versions
    (os/smartos.clj:86-105)."""
    if isinstance(pkgs, dict):
        versions = _pkgin_list(remote, node)  # one listing for all pins
        for pkg, version in pkgs.items():
            if versions.get(str(pkg)) != version:
                log.info("Installing %s %s", pkg, version)
                remote.exec(
                    node, ["pkgin", "-y", "install", f"{pkg}-{version}"],
                    sudo=True,
                )
        return
    pkgs = {str(p) for p in pkgs}
    missing = pkgs - smartos_installed(remote, node, pkgs)
    if missing:
        log.info("Installing %s", sorted(missing))
        remote.exec(node, ["pkgin", "-y", "install", *sorted(missing)],
                    sudo=True)


class SmartOS(OS):
    """SmartOS provisioning via pkgin; enables the ipfilter service the
    ipfilter Net impl depends on (os/smartos.clj:107-132)."""

    PACKAGES = ["wget", "curl", "vim", "unzip", "rsyslog", "logrotate"]

    def setup(self, test, node) -> None:
        log.info("%s setting up smartos", node)
        remote = test["remote"]
        smartos_setup_hostfile(remote, node)
        smartos_maybe_update(remote, node)
        smartos_install(remote, node, self.PACKAGES)
        remote.exec(node, ["svcadm", "enable", "-r", "ipfilter"], sudo=True)
        try:
            net = test.get("net")
            if net is not None:
                net.heal(test)
        except Exception:  # noqa: BLE001
            log.warning("net heal failed during OS setup", exc_info=True)

    def teardown(self, test, node) -> None:
        pass


smartos = SmartOS()
