"""The entries a configuration's checks go through: the program's own
checker, as a suite calls it. A configuration names its entry by
"module:attribute" (its "entry" key); the harness builds it once in
set-up with `Entry(config, device)` and then calls

- `setup(on_card)`: what the entry needs before its first check;
- `prepare(events)`: the program's form of a history of the
  generator's events, made in set-up;
- `check(history)`: one check, the call the window times;
- `steps(result)`: the search steps a result reports, for the guard
  that a history met again does the same work.

A later configuration with another entry brings a module of its own.
"""

from __future__ import annotations

#: the program's model of each configuration "model"
MODELS = {"cas-register": "CASRegister"}


class IndependentLinearizable:
    """`independent.checker(linearizable(model, algorithm=...))` over a
    keyed history, the checker jepsen's linearizable-register test
    composes (linearizable_register.clj:37-41), without the timeline."""

    def __init__(self, config: dict, device=None):
        from jepsen_tpu_torch import independent, models
        from jepsen_tpu_torch.checker.linearizable import linearizable

        check = config["check"]
        self.algorithm = check["algorithm"]
        self.checker = independent.checker(linearizable(
            getattr(models, MODELS[check["model"]])(),
            algorithm=self.algorithm, device=device))

    def setup(self, on_card: bool) -> None:
        if on_card and self.algorithm == "auto":
            # the crossover "auto" routes by: measured by a checkout's
            # first run, read from the record by the others
            from jepsen_tpu_torch.checker import calibrate

            calibrate.batch_min(None)

    def prepare(self, events: list) -> list:
        """The port's Ops, indexed and timed by position, values
        KVTuple(key, value)."""
        from jepsen_tpu_torch.history import Op
        from jepsen_tpu_torch.independent import KVTuple

        return [Op(p, t, f, KVTuple(k, v), i, i)
                for i, (p, t, f, v, k) in enumerate(events)]

    def check(self, history: list) -> dict:
        # a test map with no store: the analysis journal stays off
        return self.checker.check({}, history)

    @staticmethod
    def steps(result: dict) -> int:
        return sum(r.get("steps") or 0 for r in result["results"].values())
