"""Base test maps and the in-process fake backend (reference:
jepsen.tests, tests.clj).

`atom_db`/`atom_client` run the ENTIRE engine — workers, generators,
history capture, checking — against a lock-protected in-memory register,
no cluster required (tests.clj:27-56; the trick behind the reference's
hermetic core_test.clj:18-30).

The port's copy of `jepsen_tpu/testlib.py`: it imports nothing of
`jepsen_tpu`. The JAX package's `FlakyEngine` (fault injection for its
engine supervisor) is left out: the port has no supervisor.
"""

from __future__ import annotations

import threading

from . import checker as checker_mod
from . import client as client_mod
from . import db as db_mod
from . import generator as gen
from . import models, nemesis as nemesis_mod, net as net_mod, osenv


def noop_test() -> dict:
    """Boring test stub to build real tests on (tests.clj:12-25)."""
    return {
        "name": "noop",
        "nodes": ["n1", "n2", "n3", "n4", "n5"],
        "os": osenv.noop,
        "db": db_mod.noop,
        "net": net_mod.noop,
        "client": client_mod.noop,
        "nemesis": nemesis_mod.noop,
        "generator": gen.void,
        "model": models.noop(),
        "checker": checker_mod.unbridled_optimism(),
        "ssh": {"dummy": True},
    }


class SharedAtom:
    """A compare-and-set cell guarded by a lock (the Clojure atom)."""

    def __init__(self, value=None):
        self.value = value
        self.lock = threading.Lock()


class AtomDB(db_mod.DB):
    """Wraps an atom as a database (tests.clj:27-32)."""

    def __init__(self, state: SharedAtom):
        self.state = state

    def setup(self, test, node):
        with self.state.lock:
            self.state.value = None

    def teardown(self, test, node):
        with self.state.lock:
            self.state.value = "done"


class AtomClient(client_mod.Client):
    """A linearizable-by-construction CAS register client over a shared
    atom (tests.clj:34-56)."""

    def __init__(self, state: SharedAtom):
        self.state = state

    def open(self, test, node):
        return self

    def invoke(self, test, op):
        s = self.state
        if op.f == "write":
            with s.lock:
                s.value = op.value
            return op.with_(type="ok")
        if op.f == "cas":
            old, new = op.value
            with s.lock:
                if s.value == old:
                    s.value = new
                    return op.with_(type="ok")
            return op.with_(type="fail")
        if op.f == "read":
            with s.lock:
                v = s.value
            return op.with_(type="ok", value=v)
        raise ValueError(f"unknown op {op.f!r}")


class FlakyClient(AtomClient):
    """AtomClient that crashes (raises) with some probability AFTER
    applying the op — producing genuine :info indeterminacy for engine
    tests (the analog of core_test.clj's throwing clients)."""

    def __init__(self, state, crash_p=0.1, seed=0):
        super().__init__(state)
        import random

        self.rng = random.Random(seed)
        self.crash_p = crash_p
        self._lock = threading.Lock()

    def invoke(self, test, op):
        completion = super().invoke(test, op)
        with self._lock:
            crash = self.rng.random() < self.crash_p
        if crash:
            raise RuntimeError("simulated client crash (post-apply)")
        return completion


def cas_test(state: SharedAtom | None = None, **overrides) -> dict:
    """The reference's basic-cas-test shape (core_test.clj:18-30): full
    engine against the atom backend, linearizable checker."""
    state = state or SharedAtom()
    base = noop_test()
    base.update(
        {
            "name": "cas-atom",
            "db": AtomDB(state),
            "client": AtomClient(state),
            "model": models.cas_register(),
            "generator": gen.clients(
                gen.time_limit(2, gen.limit(100, gen.cas))
            ),
            "checker": checker_mod.linearizable(algorithm="host"),
        }
    )
    base.update(overrides)
    return base
