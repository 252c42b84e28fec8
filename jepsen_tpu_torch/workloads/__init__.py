"""Workload bundles: generator + checker (+ model) packages for standard
consistency tests, mirroring the reference's jepsen.tests.* namespaces
(SURVEY.md §2.1). Each module exposes a `test(...)`/`workload(...)`
builder returning a partial test map — callers supply the client and DB.
Beside them, the port's seeded history makers (`register`, `queue`,
`list_append.simulate`).

The bundle modules load on first use, not with the package: a
simulated database node imports nothing of torch (the cycle checkers
do).
"""

import importlib

__all__ = [
    "adya",
    "bank",
    "causal",
    "linearizable_register",
    "list_append",
    "long_fork",
]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
