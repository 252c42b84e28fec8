"""BENCHMARK.json keeps to the format its checker reads: keys, names,
units, lengths, and every cell's files and readers present."""

from __future__ import annotations

import json
import os
import re

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line(s):
    assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s, s


def test_top_level():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024


def test_configs_and_cells():
    b = bench()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        line(c["source"]), line(c["why"])
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.isfile(os.path.join(
            REPO, "portbench", "traffic", w["traffic"] + ".json"))
    assert {c for c, _ in pairs} == names


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        line(m["layer"])
        assert m["moves"] in e2e
        assert os.path.isfile(os.path.join(REPO, "portbench", "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
        assert any(w in m.get("workloads", cells) for m in b["end_to_end"]
                   if m["name"] != "setup_s")
