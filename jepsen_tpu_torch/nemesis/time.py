"""Clock-skew nemesis: uploads and compiles the native C++ time tools on
each node, then drives clock resets, jumps, and strobes (reference:
jepsen.nemesis.time, nemesis/time.clj:1-173).

Ops:

    {"f": "reset",  "value": [node1, ...]}
    {"f": "bump",   "value": {node1: delta_ms, ...}}
    {"f": "strobe", "value": {node1: {"delta": ms, "period": ms,
                                      "duration": s}, ...}}
    {"f": "check-offsets"}

Every completion is annotated with "clock_offsets" ({node: seconds}),
which feeds the clock-skew plot (checker.clock).

The port's copy of `jepsen_tpu/nemesis/time.py`: it imports nothing of
`jepsen_tpu`, and compiles the port's own C++ tools
(`jepsen_tpu_torch/native/`). These tools set a node's real clock:
run them only against real nodes, or on a `LocalRemote` sandbox whose
clock is faked.
"""

from __future__ import annotations

import logging
import os.path
import time as _time

from .. import osdist
from ..control import Remote, RemoteError, on_nodes
from ..util import random_nonempty_subset
from .. import generator as gen
from . import Nemesis

log = logging.getLogger("jepsen_tpu_torch.nemesis.time")

#: where tools are installed on nodes (nemesis/time.clj:22)
OPT_DIR = "/opt/jepsen"

#: native sources shipped with the package, {binary-name: source-file}
SOURCES = {
    "bump-time": "bump_time.cpp",
    "strobe-time": "strobe_time.cpp",
}

#: ported but un-wired tools (the reference ships
#: resources/strobe-time-experiment.c without compiling it either,
#: nemesis/time.clj:38-41): NOT built by compile_tools — the clock
#: nemesis must not fail bring-up over a tool no op invokes. Build
#: explicitly via compile_tool(..., "strobe-time-experiment").
EXPERIMENTAL_SOURCES = {
    "strobe-time-experiment": "strobe_time_experiment.cpp",
}

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")


def compile_tool(remote: Remote, node, bin_name: str, opt_dir: str = OPT_DIR
                 ) -> str:
    """Upload one C++ source and compile it to <opt_dir>/<bin>
    (nemesis/time.clj:14-30)."""
    src = os.path.join(_NATIVE_DIR,
                       {**SOURCES, **EXPERIMENTAL_SOURCES}[bin_name])
    remote.exec(node, ["mkdir", "-p", opt_dir], sudo=True)
    remote.exec(node, ["chmod", "a+rwx", opt_dir], sudo=True)
    remote.upload(node, src, f"{opt_dir}/{bin_name}.cpp")
    remote.exec(node, ["g++", "-O2", "-o", bin_name, f"{bin_name}.cpp"],
                cd=opt_dir, sudo=True)
    return bin_name


def compile_tools(remote: Remote, node, opt_dir: str = OPT_DIR) -> None:
    """Build both time tools on a node (nemesis/time.clj:38-41)."""
    for bin_name in SOURCES:
        compile_tool(remote, node, bin_name, opt_dir)


def install(remote: Remote, node, opt_dir: str = OPT_DIR) -> None:
    """Compile the tools; if that fails, install a compiler (g++ via apt,
    gcc-c++ via yum) and retry (nemesis/time.clj:43-52)."""
    try:
        compile_tools(remote, node, opt_dir)
    except RemoteError:
        try:
            osdist.install(remote, node, ["build-essential"])
        except RemoteError:
            osdist.centos_install(remote, node, ["gcc-c++"])
        compile_tools(remote, node, opt_dir)


def parse_time(s: str) -> float:
    """Decimal unix-epoch seconds (nemesis/time.clj:54-58)."""
    return float(s.strip())


def clock_offset(remote_time: float) -> float:
    """remote wall time minus the control node's wall time, seconds
    (nemesis/time.clj:60-64)."""
    return remote_time - _time.time()


def current_offset(remote: Remote, node) -> float:
    """The node's clock offset in seconds (nemesis/time.clj:66-69)."""
    return clock_offset(parse_time(remote.exec(node, ["date", "+%s.%N"]).out))


def reset_time(remote: Remote, node) -> None:
    """Reset the node's clock from NTP (nemesis/time.clj:71-75)."""
    remote.exec(node, ["ntpdate", "-b", "pool.ntp.org"], sudo=True)


def bump_time(remote: Remote, node, delta_ms, opt_dir: str = OPT_DIR
              ) -> float:
    """Jump the node's clock by delta ms; returns the node's resulting
    offset in seconds (nemesis/time.clj:77-81)."""
    out = remote.exec(node, [f"{opt_dir}/bump-time", str(delta_ms)],
                      sudo=True).out
    return clock_offset(parse_time(out))


def strobe_time(remote: Remote, node, delta_ms, period_ms, duration_s,
                opt_dir: str = OPT_DIR) -> None:
    """Strobe the node's clock back and forth by delta ms every period ms
    for duration seconds (nemesis/time.clj:83-87)."""
    remote.exec(
        node,
        [f"{opt_dir}/strobe-time", str(delta_ms), str(period_ms),
         str(duration_s)],
        sudo=True,
    )


def try_reset(remote, node) -> None:
    """Best-effort clock reset — hosts without ntpdate/network just
    log (nemesis/time.clj:89-96's guarded reset)."""
    try:
        reset_time(remote, node)
    except RemoteError:
        log.warning("ntpdate reset failed on %s", node)


def bring_up(test, opt_dir: str = OPT_DIR) -> None:
    """Shared clock-nemesis bring-up: install the native bump/strobe
    tools on every node in parallel, stop ntpd so it can't fight the
    skew, and best-effort reset (nemesis/time.clj:89-99)."""
    remote = test["remote"]
    on_nodes(test, lambda t, n: install(remote, n, opt_dir))
    on_nodes(
        test,
        lambda t, n: remote.exec(n, ["service", "ntpd", "stop"],
                                 sudo=True, check=False),
    )
    on_nodes(test, lambda t, n: try_reset(remote, n))


class ClockNemesis(Nemesis):
    """Clock manipulation nemesis (nemesis/time.clj:89-135)."""

    def __init__(self, opt_dir: str = OPT_DIR):
        self.opt_dir = opt_dir

    def setup(self, test):
        bring_up(test, self.opt_dir)
        return self

    # kept for callers that used the private name
    _try_reset = staticmethod(try_reset)

    def invoke(self, test, op):
        remote = test["remote"]
        f = op.f
        if f == "reset":
            offsets = on_nodes(
                test,
                lambda t, n: (self._try_reset(remote, n),
                              current_offset(remote, n))[1],
                nodes=op.value,
            )
        elif f == "check-offsets":
            offsets = on_nodes(test,
                               lambda t, n: current_offset(remote, n))
        elif f == "strobe":
            m = dict(op.value)

            def strobe_one(t, n):
                spec = m[n]
                strobe_time(remote, n, spec["delta"], spec["period"],
                            spec["duration"], self.opt_dir)
                return current_offset(remote, n)

            offsets = on_nodes(test, strobe_one, nodes=list(m))
        elif f == "bump":
            m = dict(op.value)
            offsets = on_nodes(
                test,
                lambda t, n: bump_time(remote, n, m[n], self.opt_dir),
                nodes=list(m),
            )
        else:
            raise ValueError(f"unknown clock op {f!r}")
        return op.with_(extra={**op.extra, "clock_offsets": offsets})

    def teardown(self, test):
        remote = test["remote"]
        on_nodes(test, lambda t, n: self._try_reset(remote, n))


def clock_nemesis(opt_dir: str = OPT_DIR) -> ClockNemesis:
    return ClockNemesis(opt_dir)


# ---------------------------------------------------------------------------
# Generators (nemesis/time.clj:137-173)

def reset_gen(test, process):
    """Reset random node subsets (nemesis/time.clj:137-141)."""
    return {
        "type": "info",
        "f": "reset",
        "value": random_nonempty_subset(test["nodes"]),
    }


def bump_gen(test, process):
    """Bump clocks on random subsets by ±4 ms..±262 s, exponentially
    distributed (nemesis/time.clj:143-152)."""
    import random

    return {
        "type": "info",
        "f": "bump",
        "value": {
            n: int(random.choice([-1, 1]) * 2 ** (2 + random.random() * 16))
            for n in random_nonempty_subset(test["nodes"])
        },
    }


def strobe_gen(test, process):
    """Strobe clocks on random subsets: delta 4 ms..262 s, period
    1 ms..1 s, duration 0-32 s (nemesis/time.clj:154-165)."""
    import random

    return {
        "type": "info",
        "f": "strobe",
        "value": {
            n: {
                "delta": int(2 ** (2 + random.random() * 16)),
                "period": int(2 ** (random.random() * 10)),
                "duration": random.random() * 32,
            }
            for n in random_nonempty_subset(test["nodes"])
        },
    }


def clock_gen() -> gen.Generator:
    """Random clock-skew schedule, starting with a check-offsets to
    establish a baseline (nemesis/time.clj:167-173)."""
    return gen.phases(
        gen.once({"type": "info", "f": "check-offsets"}),
        gen.mix([reset_gen, bump_gen, strobe_gen]),
    )
