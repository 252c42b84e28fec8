"""sim.cu's own source, run on the CPU, against the plain version.

The kernel has no interpret mode, so this compiles `csrc/sim.cu` with g++
against `csrc/warp_emu.h` (one thread a CUDA thread, a barrier a warp and
one a block, shared atomics, the blocks one after another over shared
memory filled with garbage) and calls `sim_launch` on CPU tensors, its
outputs filled with garbage first. All seven outputs must equal
`sim_plain`'s bit for bit: on the four specs of tests/test_torch_fuzz.py,
the bench's seeded batch at the default spec, the 8 committed anomaly
traces, a spec of 16 nodes and 16 fault slots with one key and two mops a
txn, and a spec of more keys than buckets and more mops than threads, at
several thread counts. The launch must refuse a shared-memory size other
than its layout's and a thread count it cannot run. On the card
chip_smoke.py holds the compiled kernel to the same plain version."""

import ctypes
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.fuzz import sim
from jepsen_tpu_torch.fuzz.schedule import (DEFAULT_SPEC, SimSpec,
                                            canonicalize, random_schedule,
                                            schedule_from_lists)
from jepsen_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_SMS = 132

# tests/test_torch_fuzz.py's specs
SPECS = {
    "default": {},
    "small": dict(nodes=3, keys=5, txns=10, mops=3, faults=4),
    "wide": dict(nodes=7, keys=12, txns=30, mops=5, faults=10),
    "one_key": dict(nodes=2, keys=1, txns=6, mops=2, faults=2),
}
EDGE = SimSpec(nodes=16, keys=1, txns=2, mops=2, faults=16)
# 70 keys share 32 buckets; 232 mops stride over blocks of fewer threads
MANY_KEYS = SimSpec(nodes=5, keys=70, txns=40, mops=4, faults=8)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel's source built for the host: its launch entry point."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("sim_emu")
    with open(f"{_build.CSRC}/sim.cu") as fh:
        src = fh.read()
    decl = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(decl) == 1
    src = src.replace(decl, "unsigned char* smem = g_smem;")
    src, n = re.subn(r"(\w+)<<<([^,]+),([^,]+),([^,]+),.*?>>>\(",
                     r"emu_launch(\1, \2, \3, \4, ", src, flags=re.S)
    assert n == 1
    src = src.replace("#include <cuda_runtime.h>", '#include "warp_emu.h"')
    (d / "sim_emu.cc").write_text(src)
    so = d / "libsim_emu.so"
    r = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
         f"-I{_build.CSRC}", "-o", str(so), str(d / "sim_emu.cc")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    fn = lib.sim_launch
    fn.argtypes, fn.restype = sim._SIG["sim_launch"]
    return lib


def inputs(scheds, wseeds, spec):
    """CPU tensors of canonical schedules and folded seeds, as
    simulate_batch hands them to `sim`."""
    scheds = np.stack([canonicalize(s, spec) for s in scheds])
    scheds, wseeds = sim._as_batch(scheds, wseeds, spec)
    return torch.from_numpy(scheds), torch.from_numpy(wseeds)


def seeded(n, spec, seed0):
    """The bench's batch (chip_smoke.fuzz_batch) for any spec."""
    scheds = [random_schedule(seed0 + i, spec) for i in range(n)]
    wseeds = (np.arange(n, dtype=np.int64) * 2654435761 + seed0) \
        & 0x7FFFFFFF
    return inputs(scheds, wseeds, spec)


def launch(lib, s, w, spec, threads=None, smem=None):
    """sim_launch on CPU tensors: (return code, the seven outputs, each
    filled with garbage before the launch)."""
    S, St, L = s.shape[0], spec.slots, spec.mops
    out = {name: torch.full((S, St) if name in ("coord", "failed")
                            else (S, St, L), 0x5A5A, dtype=torch.int32)
           for name in sim.OUTPUTS}
    out["failed"] = torch.ones((S, St), dtype=torch.bool)
    rc = lib.sim_launch(
        s.data_ptr(), w.data_ptr(), S, spec.nodes, spec.keys, spec.txns,
        spec.mops, spec.faults, St, spec.audit_t0,
        *(out[name].data_ptr() for name in sim.OUTPUTS),
        sim.smem_bytes(spec) if smem is None else smem,
        sim.block_threads(spec, S, H100_SMS) if threads is None else threads,
        None)
    return rc, out


def held(lib, s, w, spec, threads=None):
    rc, got = launch(lib, s, w, spec, threads)
    assert rc == 0
    want = sim.sim_plain(s, w, spec)
    for k in sim.OUTPUTS:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    return got


@pytest.mark.parametrize("name", sorted(SPECS))
def test_specs(emu, name):
    spec = SimSpec(**SPECS[name])
    held(emu, *seeded(8, spec, seed0=11), spec)


def test_bench_batch(emu):
    """chip_smoke.fuzz_batch(0, 24): every output kind occurs."""
    got = held(emu, *seeded(24, DEFAULT_SPEC, seed0=0), DEFAULT_SPEC)
    assert bool((got["pos"] > 0).any()) and bool((got["rlen"] > 0).any())
    assert bool(got["failed"].any())


def test_fixture_traces(emu):
    with open(os.path.join(REPO, "tests", "fixtures",
                           "fuzz_anomalies.jsonl")) as fh:
        cases = [json.loads(line) for line in fh if line.strip()]
    assert len(cases) == 8
    scheds = [schedule_from_lists(c["schedule"]) for c in cases]
    wseeds = np.array([c["wseed"] for c in cases], dtype=np.int64)
    held(emu, *inputs(scheds, wseeds, DEFAULT_SPEC), DEFAULT_SPEC)


def test_edge_spec(emu):
    """16 nodes (the sender bits' width) and 16 fault slots, one key, two
    mops a txn: 6 mops in a block of a warp, and of MAX_THREADS."""
    held(emu, *seeded(16, EDGE, seed0=5), EDGE, 32)
    held(emu, *seeded(16, EDGE, seed0=6), EDGE)


@pytest.mark.parametrize("threads", [32, 64, 128, 256])
def test_threads(emu, threads):
    """Every thread count the launch takes a block at: at the default
    spec and at 70 keys (walks that compare keys) with 232 mops (loops
    that stride)."""
    held(emu, *seeded(6, DEFAULT_SPEC, seed0=40), DEFAULT_SPEC, threads)
    held(emu, *seeded(4, MANY_KEYS, seed0=50), MANY_KEYS, threads)


def test_launch_refuses(emu):
    """A shared-memory size other than the layout's, a thread count that
    is not whole warps up to MAX_THREADS: cudaErrorInvalidValue, and not
    one output written."""
    s, w = seeded(2, DEFAULT_SPEC, seed0=3)
    good = sim.smem_bytes(DEFAULT_SPEC)
    for smem, threads in ((good - 4, None), (good + 16, None), (None, 48),
                          (None, 2 * sim.MAX_THREADS), (None, 0)):
        rc, out = launch(emu, s, w, DEFAULT_SPEC, threads, smem)
        assert rc != 0
        assert bool((out["kind"] == 0x5A5A).all())
