"""Linearizability over many independent CAS registers: the standard
per-key register workload (reference: jepsen/src/jepsen/tests/
linearizable_register.clj:1-46).

Clients understand three functions, with independent-tuple values:

    {"type": "invoke", "f": "write", "value": (k, v)}
    {"type": "invoke", "f": "read",  "value": (k, None)}
    {"type": "invoke", "f": "cas",   "value": (k, (v, v2))}

The port's copy of `jepsen_tpu/workloads/linearizable_register.py`. Its
checker reaches the card: `auto` routes each key's history to K1
(`ops/csrc/wgl_vec.cu`), K5 (`ops/csrc/wgl_row.cu`) or the native
search, on `opts["device"]` (None = the card; "cpu" runs each kernel's
plain version).
"""

from __future__ import annotations

import itertools
import random

from .. import checker as checker_mod
from .. import generator as gen
from .. import independent, models


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def cas(test, process):
    return {
        "type": "invoke",
        "f": "cas",
        "value": (random.randrange(5), random.randrange(5)),
    }


def test(opts: dict) -> dict:
    """Partial test: generator, model, checker; you supply the client
    (linearizable_register.clj:22-46). Options:

        nodes          nodes you'll operate on (only the count matters)
        per_key_limit  max ops per key, default 128
        algorithm      linearizable-checker algorithm override
        device         the checker's device (None = the card)
    """
    n = len(opts["nodes"])
    per_key_limit = opts.get("per_key_limit", 128)
    algorithm = opts.get("algorithm", "auto")

    def fgen(k):
        # Randomize the per-key limit so keys drift out of phase and
        # don't line up on Significant Event Boundaries
        # (linearizable_register.clj:42-46).
        return gen.limit(
            int((random.random() * 0.1 + 0.9) * per_key_limit),
            gen.reserve(n, r, gen.mix([w, cas, cas])),
        )

    return {
        "checker": independent.checker(
            checker_mod.Compose(
                {
                    "linearizable": checker_mod.linearizable(
                        algorithm=algorithm, device=opts.get("device")),
                    "timeline": checker_mod.timeline_html(),
                }
            )
        ),
        "model": models.cas_register(),
        "generator": independent.concurrent_generator(
            2 * n, itertools.count(), fgen
        ),
    }
