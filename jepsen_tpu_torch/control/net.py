"""Node network helpers (reference: jepsen.control.net, control/net.clj).

The port's copy of `jepsen_tpu/control/net.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import threading

_ip_cache: dict = {}
_lock = threading.Lock()


def ip(test, node) -> str:
    """Resolve a node's IP from the control plane's perspective, memoized
    (control/net.clj:21-34)."""
    key = (id(test.get("remote")), node)
    with _lock:
        if key in _ip_cache:
            return _ip_cache[key]
    from . import DummyRemote, LocalRemote

    remote = test["remote"]
    if isinstance(remote, (DummyRemote, LocalRemote)):
        addr = "127.0.0.1"
    else:
        r = remote.exec(
            node,
            ["getent", "ahostsv4", str(node)],
            check=False,
        )
        addr = r.out.split()[0] if r.ok and r.out else str(node)
    with _lock:
        _ip_cache[key] = addr
    return addr


def reachable(test, from_node, to_node) -> bool:
    """Can from_node ping to_node? (control/net.clj:7-11)"""
    r = test["remote"].exec(
        from_node, ["ping", "-w", "1", "-c", "1", str(to_node)], check=False
    )
    return r.ok
