"""The port's coverage-guided fuzz loop (`jepsen_tpu_torch/fuzz/loop.py`)
against the JAX package's: the same seed writes byte-identical
corpus.json and anomalies.jsonl, through the kernels' plain versions on
the CPU (engine None, device "cpu") and through the host engines; an
interrupted and resumed loop equals an uninterrupted one. Exact (byte
for byte)."""

import json

import pytest

from jepsen_tpu.fuzz import loop as jloop
from jepsen_tpu.fuzz.schedule import SimSpec as JSimSpec

from jepsen_tpu_torch import fuzz
from jepsen_tpu_torch.fuzz import loop
from jepsen_tpu_torch.fuzz.schedule import SimSpec

SPECS = {
    "default": {},
    "small": {"nodes": 3, "keys": 4, "txns": 12, "mops": 3, "faults": 4},
}
ENGINES = {
    "card_on_cpu": {"device": "cpu"},
    "host": {"engine": "host", "score_engine": "host"},
}


def read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_loop_matches_jax(tmp_path, spec, engine):
    """2 rounds of 32 clusters, seed 5: the port's corpus files are the
    JAX package's bytes (its host engines: the same corpus as its device
    path, which tests/test_fuzz.py holds)."""
    kw = SPECS[spec]
    t = loop.FuzzLoop(str(tmp_path / "t"), spec=SimSpec(**kw), seed=5,
                      clusters=32, **ENGINES[engine])
    ts = t.run(2)
    j = jloop.FuzzLoop(str(tmp_path / "j"), spec=JSimSpec(**kw), seed=5,
                       clusters=32, engine="host", score_engine="host")
    js = j.run(2)
    assert ts == js
    for f in (loop.STATE_FILE, loop.ANOMALIES_FILE):
        assert read(tmp_path / "t" / f) == read(tmp_path / "j" / f)
    assert ts["clusters-run"] == 64 and ts["entries"] > 0
    # the loop a user reaches through the fuzz package
    assert fuzz.FuzzLoop is loop.FuzzLoop and fuzz.loop is loop


def test_resume_matches_uninterrupted(tmp_path):
    """tests/test_fuzz.py's case on the port: 2 rounds + a fresh loop's
    third == 3 rounds straight, byte-identical corpus state and
    anomalies.jsonl; a loop already at its target runs nothing."""
    a = loop.FuzzLoop(str(tmp_path / "a"), seed=3, clusters=32,
                      device="cpu")
    a.run(3)
    b = loop.FuzzLoop(str(tmp_path / "b"), seed=3, clusters=32,
                      device="cpu")
    b.run(2)
    b2 = loop.FuzzLoop(str(tmp_path / "b"), seed=3, clusters=32,
                       device="cpu")
    out = b2.run(3)
    assert len(out["per-round"]) == 1
    assert (json.dumps(a.corpus.state, sort_keys=True)
            == json.dumps(b2.corpus.state, sort_keys=True))
    for f in (loop.STATE_FILE, loop.ANOMALIES_FILE):
        assert read(tmp_path / "a" / f) == read(tmp_path / "b" / f)
    again = loop.FuzzLoop(str(tmp_path / "b"), seed=3, clusters=32,
                          device="cpu").run(3)
    assert again["per-round"] == []


def test_interrupted_round_replays(tmp_path):
    """A round that dies after folding its results but before its commit
    (the loop's `round_hook`) leaves the previous commit; the resumed
    loop replays the round to the uninterrupted loop's bytes."""
    class Killed(Exception):
        pass

    def kill(rnd):
        if rnd == 1:
            raise Killed

    a = loop.FuzzLoop(str(tmp_path / "a"), seed=8, clusters=32,
                      engine="host", score_engine="host")
    a.run(2)
    b = loop.FuzzLoop(str(tmp_path / "b"), seed=8, clusters=32,
                      engine="host", score_engine="host", round_hook=kill)
    with pytest.raises(Killed):
        b.run(2)
    assert json.loads(read(tmp_path / "b" / loop.STATE_FILE))["round"] == 1
    loop.FuzzLoop(str(tmp_path / "b"), seed=8, clusters=32,
                  engine="host", score_engine="host").run(2)
    for f in (loop.STATE_FILE, loop.ANOMALIES_FILE):
        assert read(tmp_path / "a" / f) == read(tmp_path / "b" / f)


def test_run_fuzz_matches_jax(tmp_path):
    """run_fuzz's options (the JAX package's command body) build the same
    loop: the same summary and files."""
    opts = {"seed": 2, "clusters": 16, "rounds": 2, "keys": 6,
            "families": "partition,kill"}
    ts = loop.run_fuzz({**opts, "corpus_dir": str(tmp_path / "t"),
                        "engine": "host", "score_engine": "host"})
    js = jloop.run_fuzz({**opts, "corpus_dir": str(tmp_path / "j"),
                         "engine": "host"})
    assert ts == js
    assert read(tmp_path / "t" / loop.STATE_FILE) == read(
        tmp_path / "j" / loop.STATE_FILE)
    with pytest.raises(ValueError):
        loop.run_fuzz({"corpus_dir": str(tmp_path / "x"),
                       "families": "meteor"})


def test_default_device_is_cuda(tmp_path):
    """The loop's simulation runs on the card unless told otherwise:
    without CUDA its first round raises."""
    import torch

    from jepsen_tpu_torch.device import CudaUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(CudaUnavailable):
        loop.FuzzLoop(str(tmp_path / "c"), clusters=4).run(1)
