"""libfaketime wrappers: make a DB binary's clock run offset and at a
different rate (reference: jepsen.faketime, faketime.clj:1-31).

The port's copy of `jepsen_tpu/faketime.py`."""

from __future__ import annotations

import logging

from .control import Remote
from .control.util import exists

log = logging.getLogger("jepsen_tpu_torch.faketime")


def script(cmd: str, init_offset: float, rate: float) -> str:
    """A shell script invoking cmd under faketime with an initial offset
    (seconds) and clock rate (faketime.clj:8-18)."""
    off = int(init_offset)
    sign = "-" if off < 0 else "+"
    return (
        "#!/bin/bash\n"
        f'faketime -m -f "{sign}{abs(off)}s x{float(rate)}" {cmd} "$@"\n'
    )


def wrap(remote: Remote, node, cmd: str, init_offset: float, rate: float
         ) -> None:
    """Replace executable cmd with a faketime wrapper, keeping the
    original at cmd.no-faketime; idempotent (faketime.clj:20-31)."""
    orig = f"{cmd}.no-faketime"
    wrapper = script(orig, init_offset, rate)
    # DB executables are normally root-owned; these must run as root
    # like the reference's su context (faketime.clj:20-31).
    if exists(remote, node, orig):
        log.info("Installing faketime wrapper.")
        remote.exec(node, ["tee", cmd], stdin=wrapper, sudo=True)
        # re-chmod: a prior install may have died before its chmod
        remote.exec(node, ["chmod", "a+x", cmd], sudo=True)
    else:
        remote.exec(node, ["mv", cmd, orig], sudo=True)
        remote.exec(node, ["tee", cmd], stdin=wrapper, sudo=True)
        remote.exec(node, ["chmod", "a+x", cmd], sudo=True)
