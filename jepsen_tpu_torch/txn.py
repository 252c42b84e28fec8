"""Transaction micro-operations.

A transaction value is a sequence of micro-ops, each a 3-element sequence
``[f, k, v]`` where f is "r" or "w". Accessor/predicate parity with
jepsen.txn (reference: txn/src/jepsen/txn/micro_op.clj:1-33).
"""

from __future__ import annotations

READ = "r"
WRITE = "w"
APPEND = "append"  # list-append workloads (Elle's richest inference)


def f(mop):
    """The function this micro-op executes (micro_op.clj:4-7)."""
    return mop[0]


def key(mop):
    """The key this micro-op affects (micro_op.clj:9-12)."""
    return mop[1]


def value(mop):
    """The value this micro-op used (micro_op.clj:14-17)."""
    return mop[2]


def is_read(mop) -> bool:
    return f(mop) == READ


def is_write(mop) -> bool:
    return f(mop) == WRITE


def is_append(mop) -> bool:
    return f(mop) == APPEND


def is_op(mop) -> bool:
    """Is this a legal micro-op (micro_op.clj:29-33)?"""
    try:
        return len(mop) == 3 and f(mop) in (READ, WRITE, APPEND)
    except TypeError:
        return False
