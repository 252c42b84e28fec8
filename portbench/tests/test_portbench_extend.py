"""A configuration, a traffic mix and a per-layer metric are added as
files and entries alone: in a temporary copy, a new cell of a new
configuration under a new mix reports a new metric; a configuration of
another kind brings its generator, entry and judge as modules of its
own; and the guard that a history met again does the same work counts
every module of the program that counts its launches."""

from __future__ import annotations

import json
import os

from conftest import run_cell


def test_add_a_config_a_traffic_and_a_metric(tiny, capsys):
    pb = os.path.join(tiny, "portbench")
    with open(os.path.join(pb, "configs", "register_keyed.json")) as fh:
        config = json.load(fh)
    config["name"] = "register_small"
    config["history"].update(keys=6, per_key_limit=10, nodes=3)
    with open(os.path.join(pb, "configs", "register_small.json"), "w") as fh:
        json.dump(config, fh)
    with open(os.path.join(pb, "traffic", "three.json"), "w") as fh:
        json.dump({"why": "no plant", "pool": 3, "callers": 1}, fh)
    with open(os.path.join(pb, "metrics", "keys_per_check.py"), "w") as fh:
        fh.write("def read(run):\n"
                 "    return sum(len(c.result[2]) for c in "
                 "run.checks) / len(run.checks)\n")
    with open(os.path.join(tiny, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({
        "name": "register_small", "source": "https://example.org/small",
        "file": "portbench/configs/register_small.json", "reduced": [],
        "why": "a test's"})
    bench["workloads"].append({
        "name": "register_small.three", "config": "register_small",
        "traffic": "three", "chips": 1, "why": "a test's"})
    bench["per_layer"].append({
        "name": "keys_per_check", "unit": "keys", "better": "higher",
        "source": "program_counter", "layer": "independent",
        "moves": "ops_checked_per_s", "workloads": ["register_small.three"]})
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)

    rc, res = run_cell(tiny, "register_small.three", trace=1, capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["keys_per_check"] == {"value": 6.0,
                                                "unit": "keys"}
    rc, res = run_cell(tiny, "register_small.three", capsys=capsys)
    assert rc == 0 and set(res["metrics"]) == {"ops_checked_per_s",
                                               "setup_s"}


#: a configuration of another kind: histories of one counter, checked by
#: a toy entry, judged against their sum
KIND = """
def generate(params, traffic, seed):
    return [("inc", (seed + i) % 5) for i in range(params["n"])]


class Entry:
    def __init__(self, config, device=None):
        self.setups = 0

    def setup(self, on_card):
        self.setups += 1

    def prepare(self, events):
        return [v for _, v in events]

    def check(self, history):
        return {"sum": sum(history)}

    @staticmethod
    def steps(result):
        return len(str(result))


class Judge:
    def __init__(self, config):
        pass

    def digest(self, result):
        return result["sum"]

    def expected(self, events):
        return sum(v for _, v in events)

    def wrong(self, digested, want):
        return int(digested != want)

    def answers(self, want):
        return 1
"""


def test_a_configuration_of_another_kind(tiny, capsys, tmp_path,
                                        monkeypatch):
    mods = tmp_path / "kind"
    mods.mkdir()
    (mods / "counter_kind.py").write_text(KIND)
    monkeypatch.syspath_prepend(str(mods))
    pb = os.path.join(tiny, "portbench")
    with open(os.path.join(pb, "configs", "counter.json"), "w") as fh:
        json.dump({"name": "counter", "generator": "counter_kind:generate",
                   "history": {"n": 50}, "entry": "counter_kind:Entry",
                   "judge": "counter_kind:Judge"}, fh)
    with open(os.path.join(tiny, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({
        "name": "counter", "source": "https://example.org/counter",
        "file": "portbench/configs/counter.json", "reduced": [],
        "why": "a test's"})
    bench["workloads"].append({
        "name": "counter.clean", "config": "counter", "traffic": "clean",
        "chips": 1, "why": "a test's"})
    with open(os.path.join(tiny, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    rc, res = run_cell(tiny, "counter.clean", capsys=capsys)
    assert rc == 0 and res["correct"] is True
    assert res["compared"]["wrong_answers"]["of"] == res["attempted"] + 1


def test_the_repeat_guard_counts_every_module_that_counts_launches(
        monkeypatch):
    import sys
    import types

    from portbench import run

    mods = run.kernel_modules()
    assert {"wgl_vec", "wgl_row", "wgl_search", "closure"} <= set(mods)
    extra = types.ModuleType("jepsen_tpu_torch.ops.extra_kernel")
    extra.LAUNCHES = 0
    monkeypatch.setitem(sys.modules, extra.__name__, extra)
    mods = run.kernel_modules()
    assert mods["extra_kernel"] is extra

    class Entry:
        def check(self, history):
            extra.LAUNCHES += len(history)
            return {}

        @staticmethod
        def steps(result):
            return 0

    def meet(k, n):
        return run.run_check(Entry(), [0] * n, k, lambda: None, mods, {})

    works = [(c.pool, c.work) for c in
             (meet(0, 2), meet(1, 3), meet(0, 2), meet(1, 1))]
    compared, _ = run.judge(_NoJudge(), [[], []], [(0, {})], works)
    # pool history 1 met again with fewer launches of the new module
    assert compared["repeat_mismatches"]["value"] == 1


class _NoJudge:
    def digest(self, result):
        return result

    def expected(self, events):
        return None

    def wrong(self, result, want):
        return 0

    def answers(self, want):
        return 0
