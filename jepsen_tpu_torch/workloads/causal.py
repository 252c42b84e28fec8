"""Causal-consistency register workload checkers (the port's copy of the
checking half of `jepsen_tpu/workloads/causal.py`; reference:
jepsen/src/jepsen/tests/causal.clj:1-131): a causal order of reads and
writes against per-key registers, verified by sequential replay.

Ops carry two extra fields (in Op.extra): "position", an opaque site
position for this op, and "link", the position of the causally preceding
op (or "init" for the first op in a causal order). The generators are
not ported (the port has no `generator.py`).
"""

from __future__ import annotations

from .. import independent
from ..checker import Checker
from ..history import ops as _ops
from ..models import Inconsistent, inconsistent


class CausalRegister:
    """Register whose writes must arrive in counter order and whose ops
    must link to the last-seen position (causal.clj:33-83)."""

    def __init__(self, value=0, counter=0, last_pos=None):
        self.value = value
        self.counter = counter
        self.last_pos = last_pos

    def step(self, op):
        c = self.counter + 1
        v = op.value
        pos = op.extra.get("position")
        link = op.extra.get("link")
        if link != "init" and link != self.last_pos:
            return Inconsistent(
                f"Cannot link {link} to last-seen position {self.last_pos}"
            )
        if op.f == "write":
            if v == c:
                return CausalRegister(v, c, pos)
            return Inconsistent(
                f"expected value {c} attempting to write {v} instead"
            )
        if op.f == "read-init":
            # On a fresh register the init read must be exactly 0 —
            # the reference's (and (= 0 counter) (not= 0 v')) also
            # rejects nil (causal.clj:56-60).
            if self.counter == 0 and v != 0:
                return Inconsistent(f"expected init value 0, read {v}")
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(f"can't read {v} from register {self.value}")
        if op.f == "read":
            if v is None or v == self.value:
                return CausalRegister(self.value, self.counter, pos)
            return Inconsistent(f"can't read {v} from register {self.value}")
        return Inconsistent(f"unknown f {op.f}")

    def __str__(self) -> str:
        return repr(self.value)


def causal_register() -> CausalRegister:
    return CausalRegister()


class CausalChecker(Checker):
    """Sequentially folds the model over ok ops; any inconsistency fails
    the history (causal.clj:88-110)."""

    def __init__(self, model=None):
        self.model = model

    def check(self, test, history, opts=None) -> dict:
        s = self.model or test.get("model") or causal_register()
        for op in _ops(history):
            if not op.is_ok:
                continue
            s = s.step(op)
            if inconsistent(s):
                return {"valid": False, "error": s.msg}
        return {"valid": True, "model": str(s)}


def check(model=None) -> CausalChecker:
    return CausalChecker(model)


def checker(device=None) -> independent.IndependentChecker:
    """The checker of the reference's partial test (causal.clj:118-131):
    per key, the sequential causal replay beside the cycle checker under
    value-ordered rw-register inference (writes are the counter values
    1, 2, ...; reads may see the initial 0), where circular causality
    shows up as a G1c/G-single cycle. The cycle checker runs on `device`
    (None = CUDA, raising when it is absent; "cpu" the kernels' plain
    versions)."""
    from ..checker import Compose, cycle

    return independent.checker(Compose({
        "causal": check(),
        "cycle": cycle.checker(version_order="value", init_values=(0,),
                               device=device),
    }))
