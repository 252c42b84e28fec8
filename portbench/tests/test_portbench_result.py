"""The result line a run prints last, and the lines on standard error
that close it, from runs of the tiny cells on the CPU."""

from __future__ import annotations

from conftest import run_cell

CELLS = ("register_keyed.clean", "register_keyed.planted")


def check_shape(res, trace):
    assert list(res) == (["correct", "attempted", "failed", "metrics",
                          "device"] + (["breakdown"] if trace else [])
                         + ["compared"])
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    dev = res["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in dev
    assert dev["count"] == 1
    if trace:
        assert dev["window_s"] > 0 and dev["busy_s"] >= 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for name, v in res["compared"].items():
        assert v["value"] == 0 and v["limit"] == 0 and v["of"] > 0


def test_untraced_line(tiny, capsys):
    for cell in CELLS:
        rc, res = run_cell(tiny, cell, capsys=capsys)
        assert rc == 0
        check_shape(res, False)
        assert set(res["metrics"]) == {"ops_checked_per_s", "setup_s"}


def test_traced_line_and_the_compared_lines(tiny, capsys):
    from portbench import run

    rc = run.main(["--workload", "register_keyed.planted", "--seed", "12",
                   "--seconds", "0.3", "--trace", "1"], root=tiny,
                  device="cpu")
    assert rc == 0
    out, err = capsys.readouterr()
    import json

    res = json.loads(out.strip().splitlines()[-1])
    check_shape(res, True)
    # a CPU run reads no device metric, and leaves each out of the line;
    # the collector's time is the host's
    assert set(res["metrics"]) == {"gc_ms_per_check"}
    assert res["metrics"]["gc_ms_per_check"]["value"] >= 0
    assert "; gc s: " in err
    tail = err.strip().splitlines()[-2:]
    assert tail[0].startswith("compared wrong_answers 0 limit 0")
    assert tail[1].startswith("compared repeat_mismatches 0 limit 0")
