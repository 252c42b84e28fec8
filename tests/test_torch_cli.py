"""The port's `analyze` and `fuzz` subcommands (jepsen_tpu_torch/cli.py)
against the JAX package's, and independent.checker(processes=...) over
spawned workers:

- `single_test_cmd(...)["analyze"]` over a store written by the JAX
  package's `single_test_cmd(...)["test"]` (a CAS register run, valid
  and with a planted impossible read), with the suite's checker and with
  `--checker linearizable`: the exit code and every results file equal
  the JAX package's `analyze` of a copy of the same store;
- an empty store and a mismatched test name exit 255; without CUDA and
  without `--device cpu`, analyze raises before reading anything;
- `fuzz` against the JAX package's `fuzz_cmd` on seeded corpus dirs:
  equal exit codes, summaries and byte-identical corpus.json and
  anomalies.jsonl;
- `independent.checker(causal bundle, processes=2)` over spawned workers
  equal to the thread path and to the JAX package's checker; a card
  fault in a worker re-raises, as does a worker's death."""

import json
import os
import shutil
from concurrent.futures.process import BrokenProcessPool

import pytest
import torch

import chip_smoke
from jepsen_tpu import cli as jcli
from jepsen_tpu.testlib import AtomClient, SharedAtom, cas_test
from jepsen_tpu.workloads import causal as jcausal

from jepsen_tpu_torch import cli, independent
from jepsen_tpu_torch import models as tmodels
from jepsen_tpu_torch.checker import cycle
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.device import CudaUnavailable
from jepsen_tpu_torch.util import bounded_pmap_processes
from jepsen_tpu_torch.workloads import causal

NAME = "cas-analyze"
NEGATE = lambda x: -x  # noqa: E731 — a payload pickle cannot name
NODES = ["--nodes", "n1,n2", "--concurrency", "2"]


class ImpossibleReadClient(AtomClient):
    """The JAX package's atom register, but its third read returns a
    value no write wrote: the history is not linearizable."""

    def __init__(self, state):
        super().__init__(state)
        self.reads = 0

    def invoke(self, test, op):
        done = super().invoke(test, op)
        if op.f == "read":
            with self.state.lock:
                self.reads += 1
                if self.reads == 3:
                    return done.with_(value=99)
        return done


def jax_test_fn(bad):
    def fn(opts):
        state = SharedAtom()
        t = cas_test(state, name=NAME)
        if bad:
            t["client"] = ImpossibleReadClient(state)
        t["nodes"], t["concurrency"] = opts["nodes"], opts["concurrency"]
        return t
    return fn


def port_test_fn(opts):
    """The same suite's test map for the port: its name, model and
    checker (the JAX suite's: host linearizability)."""
    return {"name": NAME, "model": tmodels.CASRegister(),
            "checker": linearizable(algorithm="host",
                                    device=opts.get("device"))}


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    """A store a variant ("valid", "invalid"), each one run of the JAX
    package's `test` subcommand."""
    out = {}
    for variant in ("valid", "invalid"):
        d = str(tmp_path_factory.mktemp(variant) / "store")
        rc = jcli.run_cli(jcli.single_test_cmd(
            jax_test_fn(variant == "invalid")),
            ["test", *NODES, "--time-limit", "5", "--store-dir", d])
        assert rc == (1 if variant == "invalid" else 0)
        out[variant] = d
    return out


def results_files(root) -> dict:
    """Every results file under a store, relative path -> text, the
    store's own path written as <store>."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.startswith("results."):
                p = os.path.join(d, f)
                with open(p) as fh:
                    out[os.path.relpath(p, root)] = fh.read().replace(
                        os.path.abspath(root), "<store>")
    return out


@pytest.mark.parametrize("flag", [[], ["--checker", "linearizable"]],
                         ids=["suite", "registry"])
@pytest.mark.parametrize("variant", ["valid", "invalid"])
def test_analyze_matches_jax(tmp_path, jax_stores, variant, flag):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(jax_stores[variant], jd, symlinks=True)
    shutil.copytree(jax_stores[variant], td, symlinks=True)
    before = results_files(jax_stores[variant])
    jrc = jcli.run_cli(jcli.single_test_cmd(jax_test_fn(False)),
                       ["analyze", *NODES, "--store-dir", jd, *flag])
    trc = cli.run_cli(cli.single_test_cmd(port_test_fn),
                      ["analyze", *NODES, "--store-dir", td,
                       "--device", "cpu", *flag])
    assert trc == jrc == (1 if variant == "invalid" else 0)
    got, want = results_files(td), results_files(jd)
    assert got == want
    assert got.keys() == before.keys()
    if not flag:
        # the suite's own checker gives the run's own results again
        assert got == before
    assert os.path.exists(os.path.join(td, NAME, "latest",
                                       "analysis.ckpt.jsonl"))


def test_analyze_empty_store_and_name_mismatch(tmp_path, jax_stores):
    cmd = cli.single_test_cmd(port_test_fn)
    empty = str(tmp_path / "empty")
    assert cli.run_cli(cmd, ["analyze", "--store-dir", empty,
                             "--device", "cpu"]) == 255
    d = str(tmp_path / "store")
    shutil.copytree(jax_stores["valid"], d, symlinks=True)

    def renamed(opts):
        return {**port_test_fn(opts), "name": "other-name"}

    assert cli.run_cli(cli.single_test_cmd(renamed),
                       ["analyze", "--store-dir", d, "--device", "cpu"]) \
        == 255
    assert cli.run_cli(cmd, ["analyze", "--store-dir", d,
                             "--concurrency", "zz", "--device", "cpu"]) \
        == 254


def test_analyze_without_cuda_raises(monkeypatch, tmp_path, jax_stores):
    """No device given and no CUDA: the subcommand raises
    CudaUnavailable (the CLI's exit 255) before reading the store."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = str(tmp_path / "store")
    shutil.copytree(jax_stores["valid"], d, symlinks=True)
    sub = cli.single_test_cmd(port_test_fn)["analyze"]
    opts = cli.test_opt_fn({"store_dir": d, "device": None,
                            "nodes": "n1,n2", "concurrency": "2"})
    with pytest.raises(CudaUnavailable):
        sub.run(opts)
    assert cli.run_cli(cli.single_test_cmd(port_test_fn),
                       ["analyze", "--store-dir", d]) == 255
    assert results_files(d) == results_files(jax_stores["valid"])


def test_opt_parsing_matches_jax(tmp_path):
    f = tmp_path / "nodes"
    f.write_text("f1\nf2\n")
    for opts in ({"concurrency": "3n", "nodes": "a,b,c"},
                 {"concurrency": "7", "node": ["x1"], "nodes": "c1, c2",
                  "nodes_file": str(f)},
                 {"username": "u", "password": "p",
                  "strict_host_key_checking": True,
                  "ssh_private_key": "/k", "dummy_ssh": True},
                 {}):
        assert cli.test_opt_fn(dict(opts)) == jcli.test_opt_fn(dict(opts))
    with pytest.raises(cli.CliError):
        cli.parse_concurrency({"concurrency": "x2", "nodes": []})


@pytest.mark.parametrize("seed,families", [(0, None), (3, "partition,kill")])
def test_fuzz_matches_jax(tmp_path, capsys, seed, families):
    args = ["--rounds", "2", "--clusters", "8", "--seed", str(seed)]
    if families:
        args += ["--families", families]
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jrc = jcli.run_cli(jcli.fuzz_cmd(), ["fuzz", "--corpus-dir", jd, *args,
                                         "--engine", "host"])
    jout = capsys.readouterr().out
    trc = cli.run_cli(cli.fuzz_cmd(), ["fuzz", "--corpus-dir", td, *args,
                                       "--device", "cpu"])
    tout = capsys.readouterr().out
    assert trc == jrc == 0
    assert json.loads(tout) == json.loads(jout)
    for f in ("corpus.json", "anomalies.jsonl"):
        with open(os.path.join(td, f), "rb") as a, \
                open(os.path.join(jd, f), "rb") as b:
            assert a.read() == b.read(), f


def test_fuzz_bad_options():
    assert cli.run_cli(cli.fuzz_cmd(), ["fuzz", "--engine", "tpu"]) == 254
    assert cli.run_cli(cli.fuzz_cmd(), ["fuzz", "--families", "nope",
                                        "--device", "cpu"]) == 255


def test_independent_processes_match_threads_and_jax():
    """The causal bundle's checker over 8 keys of chip_smoke's causal
    history (keys 0 and 64 invalid... here key 0): two spawned workers
    give the thread path's dict and the JAX package's."""
    h = chip_smoke.causal_history(8, 0)
    threads = causal.checker(device="cpu")
    procs = independent.checker(threads.checker, processes=2)
    r = procs.check({}, h, {})
    assert r == threads.check({}, h, {})
    from test_torch_workloads import normalise, to_jax
    jr = jcausal.test({})["checker"].check({}, to_jax(h), {})
    assert normalise(r) == normalise(jr)
    assert r["failures"] == [0]


def test_process_pool_faults_and_deaths_raise(monkeypatch):
    """A fault of the card in a spawned worker re-raises in the parent
    (here the missing card of a cycle checker with no device, resolved
    in the worker), and so does a worker's death; a payload that cannot
    be pickled by name runs on threads, as in the JAX package."""
    h = [o.with_(value=independent.tuple_(k, o.value))
         for k in (0, 1) for o in chip_smoke.long_fork_history(8, 0)
         if o.is_ok]
    h = [o.with_(index=i) for i, o in enumerate(h)]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(CudaUnavailable):
        independent.checker(cycle.checker(), processes=2).check({}, h, {})
    with pytest.raises(BrokenProcessPool):
        bounded_pmap_processes(os._exit, [3, 4])
    # pickled by name, a module-level lambda is a PicklingError: threads
    assert bounded_pmap_processes(NEGATE, [1, 2]) == [-1, -2]
    # any other error of a payload raises
    with pytest.raises(AttributeError):
        bounded_pmap_processes(lambda x: -x, [1, 2])
    assert bounded_pmap_processes(abs, [-1, 2, -3], bound=2) == [1, 2, 3]
