"""Operating-system provisioning protocol (reference: jepsen.os,
os.clj:4-14). Concrete distro implementations live in osdist.py.

The port's copy of `jepsen_tpu/osenv.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations


class OS:
    def setup(self, test, node) -> None:
        """Prepare the operating system on this node."""

    def teardown(self, test, node) -> None:
        """Clean up whatever setup did."""


class Noop(OS):
    pass


noop = Noop()
