"""The comparison that decides `correct`: every answer a check gave,
held against the plain reference's answer for the same history.

A configuration names its judge by "module:attribute" (its "judge"
key); the harness builds it with `Judge(config)` in set-up. In the
window it keeps of each check only `digest(result)`, the answers in a
compact form the collector leaves untracked, so that what the window
keeps does not slow its later checks. After the window it calls
`expected(events)` once for each history the window met and
`wrong(digest, want)` for each check; `answers(want)` counts the
answers compared.

`KeyedRegister` judges a keyed CAS-register history. An answer is one
key's verdict: (valid, the counterexample's invocation index, that
invocation's process, its f). The configurations guarantee an exact
verdict for every key: True, or False with its failing op; never
"unknown". So an answer is wrong when it differs from the reference's
in any part, when it is missing, and when the check gave one for a key
the history does not have; and a check's merged verdict and its list of
failing keys count one wrong answer each when they do not follow from
the reference's answers. The limit on wrong answers is 0.
"""

from __future__ import annotations

from . import reference


def digest(result: dict) -> tuple:
    """(merged valid, failing keys, ((key, valid, op index, op process,
    op f), ...)) of the dict a keyed check returned: tuples of atomic
    values only."""
    per_key = []
    for k, r in result.get("results", {}).items():
        op = r.get("op") or {}
        per_key.append((k, r.get("valid"), op.get("index"),
                        op.get("process"), op.get("f")))
    return (result.get("valid"), tuple(result.get("failures") or ()),
            tuple(per_key))


def answers(digested: tuple) -> dict:
    """key -> (valid, op index, op process, op f) of a digest."""
    return {k: (v, i, p, f) for k, v, i, p, f in digested[2]}


def expected(history, **options) -> dict:
    """key -> the reference's answer, in the form of `answers`, for a
    history of (process, type, f, value, key) events; `options` go to
    `reference.check_key` (the controls' broken guarantees)."""
    out = {}
    for k, (valid, idx) in reference.check_history(history,
                                                   **options).items():
        if idx is None:
            out[k] = (valid, None, None, None)
        else:
            p, _, f, _, _ = history[idx]
            out[k] = (valid, idx, p, f)
    return out


def wrong(digested: tuple, want: dict) -> int:
    """Answers of one keyed check's digest that are wrong against `want`
    (the reference's, from `expected`)."""
    valid, failures, _ = digested
    got = answers(digested)
    bad = sum(1 for k, a in want.items() if got.get(k) != a)
    bad += sum(1 for k in got if k not in want)
    failing = sorted(k for k, a in want.items() if a[0] is False)
    merged = (False if failing else
              True if all(a[0] is True for a in want.values())
              else "unknown")
    if valid != merged:
        bad += 1
    if sorted(failures) != failing:
        bad += 1
    return bad


class KeyedRegister:
    """The judge of a keyed CAS-register configuration."""

    def __init__(self, config: dict):
        self.config = config

    @staticmethod
    def digest(result: dict) -> tuple:
        return digest(result)

    @staticmethod
    def expected(events: list) -> dict:
        return expected(events)

    @staticmethod
    def wrong(digested: tuple, want: dict) -> int:
        return wrong(digested, want)

    @staticmethod
    def answers(want: dict) -> int:
        return len(want)
