"""The comparison fails what it must: the controls (the reference in the
program's place with a guarantee broken) on three seeds, and a run whose
timed path is broken underneath, once for each fault a cell can have."""

from __future__ import annotations

import copy
import json
import os

import pytest

from conftest import run_cell
from portbench import control, run

SEEDS = (11, 3_000_000_019, 2**31 + 7)


@pytest.fixture
def control_root(tiny):
    """The tiny copy, with keys of the configuration's own length, at
    which the controls have something to break."""
    p = os.path.join(tiny, "portbench", "configs", "register_keyed.json")
    with open(p) as fh:
        c = json.load(fh)
    c["history"].update(keys=64, per_key_limit=128)
    with open(p, "w") as fh:
        json.dump(c, fh)
    return tiny


CELLS = ["register_keyed.clean", "register_keyed.planted"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_control_fails_on_three_seeds(control_root, cell):
    for seed in SEEDS:
        r = control.readings(control_root, cell, seed)
        assert r["answers"] > 0
        for name in control.CONTROLS:
            assert r[name] > 0, (cell, seed, name, r)


class Broken:
    """The configuration's checker with one fault planted where its
    answers are produced."""

    def __init__(self, inner, fault):
        self.inner, self.fault, self.last = inner, fault, None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def check(self, history):
        if self.fault == "stale" and self.last is not None:
            return self.last  # returns its state unchanged
        r = self.inner.check(history)
        self.last = r
        r = copy.deepcopy(r)
        if self.fault == "half":
            # half the keys left out, the verdict merged over the rest
            keep = sorted(r["results"], key=str)[: len(r["results"]) // 2]
            r["results"] = {k: r["results"][k] for k in keep}
            r["failures"] = [k for k in r["failures"] if k in keep]
            r["valid"] = not r["failures"]
        elif self.fault == "altered":
            target = r["results"][sorted(r["results"], key=str)[0]]
            target["valid"] = target["valid"] is not True
        elif self.fault == "valid":
            # every key declared linearizable: a search cut short
            for v in r["results"].values():
                v["valid"] = True
                v.pop("op", None)
            r["valid"], r["failures"] = True, []
        return r


#: the faults each cell can have. Only the planted cell has keys that
#: are not linearizable, so only there can every key be declared so. A
#: stale answer of the clean cell is a right verdict (every key of both
#: histories is linearizable): only the launch counts give it away, and
#: the CPU launches nothing (the card test below)
CELL_FAULTS = [("register_keyed.clean", "half"),
               ("register_keyed.clean", "altered")] + [
    ("register_keyed.planted", fault)
    for fault in ("stale", "half", "altered", "valid")]


def broken_run(tiny, capsys, monkeypatch, cell, fault, device="cpu"):
    load = run.load

    def broken_load(ref):
        obj = load(ref)
        if ref.endswith(":IndependentLinearizable"):
            return lambda *a, **k: Broken(obj(*a, **k), fault)
        return obj

    monkeypatch.setattr(run, "load", broken_load)
    rc, res = run_cell(tiny, cell, seconds=0.3, capsys=capsys,
                       device=device)
    assert rc == 0
    return res


@pytest.mark.parametrize("cell,fault", CELL_FAULTS)
def test_a_broken_timed_path_reads_not_correct(tiny, capsys, monkeypatch,
                                               cell, fault):
    res = broken_run(tiny, capsys, monkeypatch, cell, fault)
    assert res["correct"] is False, res["compared"]


@pytest.mark.portbench_card
def test_on_the_card_a_stale_answer_reads_not_correct(cuda, tiny, capsys,
                                                      monkeypatch):
    # the tiny cell's 16 keys reach K1 only under a bar of 1
    monkeypatch.setenv("JEPSEN_TPU_TORCH_BATCH_MIN", "1")
    cell = "register_keyed.clean"
    rc, res = run_cell(tiny, cell, seconds=0.3, capsys=capsys, device=None)
    assert rc == 0 and res["correct"] is True, res
    res = broken_run(tiny, capsys, monkeypatch, cell, "stale", device=None)
    assert res["correct"] is False, res["compared"]
    assert res["compared"]["repeat_mismatches"]["value"] > 0
