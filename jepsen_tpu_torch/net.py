"""Network manipulation protocol (reference: jepsen.net, net.clj:14-143).

Net implementations degrade links between DB nodes: drop (partitions),
slow/flaky (tc netem), heal. The iptables implementation batches all the
drop rules for a grudge in one pass per node (net/proto.clj PartitionAll
fast path, net.clj:100-109).

The port's copy of `jepsen_tpu/net.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

from typing import Mapping

from .util import real_pmap


class Net:
    def drop(self, test, src, dest) -> None:
        """Drop traffic from src to dest."""
        raise NotImplementedError

    def heal(self, test) -> None:
        """End all traffic drops and restore network to fast operation."""
        raise NotImplementedError

    def slow(self, test) -> None:
        """Delay and/or reorder packets."""
        raise NotImplementedError

    def flaky(self, test) -> None:
        """Introduce packet loss."""
        raise NotImplementedError

    def fast(self, test) -> None:
        """Remove packet loss and delays."""
        raise NotImplementedError

    def drop_all(self, test, grudge: Mapping) -> None:
        """Drop traffic between all pairs in the grudge: node -> set of
        nodes that node should lose contact with (net.clj:28-43). Default
        applies drop() pairwise; implementations may batch."""
        for node, banned in grudge.items():
            for other in banned:
                self.drop(test, other, node)


class Noop(Net):
    """No-op network for environments without link control."""

    def drop(self, test, src, dest):
        pass

    def heal(self, test):
        pass

    def slow(self, test):
        pass

    def flaky(self, test):
        pass

    def fast(self, test):
        pass

    def drop_all(self, test, grudge):
        pass


noop = Noop()


class IPTables(Net):
    """iptables/tc-based network degradation (net.clj:57-109). Commands
    run through the test's remote (control plane) on each node."""

    @staticmethod
    def _exec(test, node, cmd):
        return test["remote"].exec(node, cmd, sudo=True)

    @staticmethod
    def _ip(test, node) -> str:
        from .control import net as cnet

        return cnet.ip(test, node)

    def drop(self, test, src, dest):
        self._exec(
            test,
            dest,
            [
                "iptables", "-A", "INPUT", "-s", self._ip(test, src),
                "-j", "DROP", "-w",
            ],
        )

    def drop_all(self, test, grudge):
        def apply_one(item):
            node, banned = item
            if not banned:
                return
            ips = ",".join(self._ip(test, other) for other in sorted(banned))
            self._exec(
                test,
                node,
                ["iptables", "-A", "INPUT", "-s", ips, "-j", "DROP", "-w"],
            )

        real_pmap(apply_one, list(grudge.items()))

    def heal(self, test):
        def heal_one(node):
            self._exec(test, node, ["iptables", "-F", "-w"])
            self._exec(test, node, ["iptables", "-X", "-w"])

        real_pmap(heal_one, test["nodes"])

    def slow(self, test):
        # "replace" instead of "add": a second slow/flaky op must swap
        # the netem discipline, not die with RTNETLINK "File exists"
        # and poison the nemesis worker
        real_pmap(
            lambda node: self._exec(
                test,
                node,
                ["tc", "qdisc", "replace", "dev", "eth0", "root", "netem",
                 "delay", "50ms", "10ms", "distribution", "normal"],
            ),
            test["nodes"],
        )

    def flaky(self, test):
        real_pmap(
            lambda node: self._exec(
                test,
                node,
                ["tc", "qdisc", "replace", "dev", "eth0", "root", "netem",
                 "loss", "20%", "75%"],
            ),
            test["nodes"],
        )

    def fast(self, test):
        def fast_one(node):
            try:
                self._exec(
                    test, node, ["tc", "qdisc", "del", "dev", "eth0", "root"]
                )
            except Exception:  # noqa: BLE001 — no qdisc installed is fine
                pass

        real_pmap(fast_one, test["nodes"])


iptables = IPTables()


class IPFilter(IPTables):
    """ipfilter-based partition control for SmartOS/illumos nodes
    (net.clj:111-143): block rules fed to `ipf -f -`, flush with
    `ipf -Fa`. slow/flaky/fast are inherited from IPTables — the
    reference's ipfilter impl issues the identical tc/netem commands
    (net.clj:121-142), a quirk kept for parity (they only work where
    tc exists)."""

    @staticmethod
    def _exec_in(test, node, cmd, stdin=None):
        return test["remote"].exec(node, cmd, sudo=True, stdin=stdin)

    def drop(self, test, src, dest):
        from .control import net as cnet

        rule = f"block in from {cnet.ip(test, src)} to any\n"
        self._exec_in(test, dest, ["ipf", "-f", "-"], stdin=rule)

    def drop_all(self, test, grudge):
        def apply_one(item):
            node, banned = item
            if not banned:
                return
            from .control import net as cnet

            rules = "".join(
                f"block in from {cnet.ip(test, other)} to any\n"
                for other in sorted(banned)
            )
            self._exec_in(test, node, ["ipf", "-f", "-"], stdin=rules)

        real_pmap(apply_one, list(grudge.items()))

    def heal(self, test):
        real_pmap(
            lambda node: self._exec_in(test, node, ["ipf", "-Fa"]),
            test["nodes"],
        )


ipfilter = IPFilter()
