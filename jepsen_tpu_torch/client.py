"""Client protocol: how workers apply operations to the system under test
(reference: jepsen.client, client.clj:8-36).

Lifecycle: open(test, node) -> connected client; setup(test) once for DB
state; invoke(test, op) -> completion op (type ok/fail/info per the
determinacy rules, core.clj:271-304); teardown(test); close(test).
open/close must not affect logical DB state.

The port's copy of `jepsen_tpu/client.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

from .history import Op


class Client:
    def open(self, test, node) -> "Client":
        """Connect to `node`; returns a ready client (often a new
        instance). Must not alter logical state."""
        return self

    def close(self, test) -> None:
        """Release the connection. Must not alter logical state."""

    def setup(self, test) -> None:
        """One-time database state setup."""

    def invoke(self, test, op: Op) -> Op:
        """Apply op, returning the completion (op.with_(type=...)).
        Raise for indeterminate outcomes — the worker records :info."""
        raise NotImplementedError

    def teardown(self, test) -> None:
        """Clean up database state."""


class Noop(Client):
    """Does nothing successfully (client.clj:28-36)."""

    def invoke(self, test, op):
        return op.with_(type="ok")


noop = Noop()


class Validating(Client):
    """Wraps a client, asserting invoke() returns a well-formed completion
    (the worker also validates; this gives clearer errors in client unit
    tests)."""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        return Validating(self.client.open(test, node))

    def close(self, test):
        self.client.close(test)

    def setup(self, test):
        self.client.setup(test)

    def teardown(self, test):
        self.client.teardown(test)

    def invoke(self, test, op):
        completion = self.client.invoke(test, op)
        assert isinstance(completion, Op), completion
        assert completion.type in ("ok", "fail", "info"), completion
        assert completion.process == op.process, completion
        assert completion.f == op.f, completion
        return completion
