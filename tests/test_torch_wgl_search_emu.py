"""wgl_search.cu's own source, run on the CPU, against the plain version.

The kernel has no interpret mode, so this compiles `csrc/wgl_search.cu`
with g++ against `csrc/warp_emu.h` (one thread a CUDA thread, a barrier
a warp) and launches it through `wgl_search._launch` on CPU tensors, the
plan passed as `search` passes it. Every placement of the shared-memory
plan is reached by shrinking the budget the plan is made for: from the
bitset alone in shared memory to every table there, the fingerprints in
device memory at cache_bits 17, the 32-bit node ids and node map at
n_pad 32768 and 65536, and fifo lanes whose keys share bitsets and
counts but not live windows, and chunks padded with the deal's empty
lanes. Verdict, steps and depth
must equal `search_plain`'s bit for bit. The launch's plan check is held
to refuse a plan it cannot run. On the card chip_smoke.py holds the
compiled kernel to the same plain version."""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from jepsen_tpu_torch import history as thist
from jepsen_tpu_torch.models import jit as tjit
from jepsen_tpu_torch.ops import _build, wgl_search as ws
from jepsen_tpu_torch.workloads.queue import mutex_history, queue_history
from jepsen_tpu_torch.workloads.register import register_history

NAMES = ("cas-register", "register", "mutex", "unordered-queue",
         "fifo-queue")
# shared-memory budgets from "the bitset and little else" to the H100's
BUDGETS = (64, 2000, 16000, ws.SMEM_MAX)


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernel's source built for the host: its launch entry point."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("wgl_search_emu")
    with open(f"{_build.CSRC}/wgl_search.cu") as fh:
        src = fh.read()
    decl = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(decl) == 1
    src = src.replace(decl, "unsigned char* smem = g_smem;")
    src, n = re.subn(
        r"(\w+)<<<([^,]+),([^,]+),([^,]+),.*?>>>\((\w+)\);",
        r"emu_launch(\1, \2, \3, \4, \5);", src, flags=re.S)
    assert n == 1
    src = src.replace("#include <cuda_runtime.h>", '#include "warp_emu.h"')
    (d / "wgl_search_emu.cc").write_text(src)
    so = d / "libwgl_search_emu.so"
    r = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
         f"-I{_build.CSRC}", "-o", str(so), str(d / "wgl_search_emu.cc")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    fn = lib.wgl_search_launch
    fn.argtypes, fn.restype = ws._SIG["wgl_search_launch"]
    return lib


def lanes_of(name, k, n_ops, seed, n_process=4):
    """`k` seeded histories of model `name` as Entries, every other one
    corrupted."""
    out = []
    for i in range(k):
        c = 0.2 if i % 2 else 0.0
        if name == "mutex":
            h = mutex_history(n_process=n_process, n_ops=n_ops, corrupt=c,
                              seed=seed + i)
        elif name.endswith("queue"):
            h = queue_history(n_process=n_process, n_ops=n_ops, corrupt=c,
                              seed=seed + i, fifo=name == "fifo-queue")
        else:
            h = register_history(n_process=n_process, n_ops=n_ops,
                                 corrupt=c, seed=seed + i,
                                 cas=name == "cas-register")
        out.append(thist.entries(h))
    return out


def check(lib, name, ess, cache_bits, n_pad=None, n_state=None,
          smem_max=ws.SMEM_MAX, max_steps=1000):
    """The emulated kernel and the plain version on the same packed
    lanes: equal (verdict, steps, depth) rows, a lane still searching at
    `max_steps` included (the plain version steps on the CPU at about a
    millisecond a step). Returns the plan."""
    jm = tjit.BY_NAME[name]
    n_pad = n_pad or ws.pad_size(max(len(es) for es in ess))
    n_state = n_state or ws.state_width(jm, ess)
    packed = torch.from_numpy(ws._pack(ess, jm, n_pad))
    msteps = torch.full((len(ess),), max_steps, dtype=torch.int32)
    plan = ws._smem_plan(jm, n_pad, n_state, cache_bits, smem_max)
    lay = ws._layout(jm, n_pad, n_state, cache_bits, smem_max)
    small = torch.full((3, len(ess)), -7, dtype=torch.int32)
    # scratch starts as garbage, as torch.empty leaves it on the card
    scratch = torch.full((len(ess) * lay.words,), 0x5A5A5A5A,
                         dtype=torch.int32)
    rc = ws._launch(lib, packed, msteps, small, scratch, jm, n_pad, n_state,
                    cache_bits, plan, lay)
    assert rc == 0
    want = ws.search_plain(packed, msteps, jm, n_pad, n_state, cache_bits)
    assert torch.equal(small, want), (small.tolist(), want.tolist())
    return plan


@pytest.mark.parametrize("smem_max", BUDGETS)
@pytest.mark.parametrize("name", NAMES)
def test_every_placement(emu, name, smem_max):
    """Each budget places a different prefix of the ranked tables in
    shared memory; at cache_bits 17 the fingerprints (256 KB) are in
    device memory whatever the budget."""
    ess = lanes_of(name, 4, 20, seed=100)
    jm = tjit.BY_NAME[name]
    n_pad = ws.pad_size(max(len(es) for es in ess))
    n_state = ws.state_width(jm, ess)
    for cb in (13, 3, 17):
        plan = check(emu, name, ess, cb, smem_max=smem_max)
        assert "lin" in plan.smem
        if cb == 17:
            assert "fp" not in plan.smem
        elif smem_max == ws.SMEM_MAX:  # these short lanes fit whole
            assert set(plan.smem) == {t for t, b in ws._table_bytes(
                jm, n_pad, n_state, cb).items() if b}


@pytest.mark.parametrize("n_pad", [32768, 65536])
@pytest.mark.parametrize("name", NAMES)
def test_wide_node_ids(emu, name, n_pad):
    """Small lanes packed where node ids (n_pad 32768) and then the node
    map (65536) take 32 bits, and most tables sit in device memory."""
    check(emu, name, lanes_of(name, 2, 20, seed=200), 3, n_pad=n_pad)


@pytest.mark.parametrize("cache_bits", [13, 3])
def test_fifo_live_windows(emu, cache_bits):
    """Fifo lanes of 8 clients: states whose bitsets and counts agree but
    whose live windows differ, partial key rows written over stale ones
    at 8 slots, n_state 64."""
    ess = lanes_of("fifo-queue", 4, 24, seed=500, n_process=8)
    check(emu, "fifo-queue", ess, cache_bits, n_state=64, max_steps=2000)


@pytest.mark.parametrize("name", NAMES)
def test_empty_lanes_of_a_deal(emu, name):
    """A chunk the deal pads with empty lanes (all-zero rows: n_completed
    0; budget 0 as `analysis_batch` gives them, or a full one): each
    reads VALID after no step at depth 0, and the real lanes beside them
    read what they read without them, bit for bit the plain version."""
    ess = lanes_of(name, 3, 16, seed=700)
    jm = tjit.BY_NAME[name]
    n_pad = ws.pad_size(max(len(es) for es in ess))
    n_state = ws.state_width(jm, ess)
    alone = torch.from_numpy(ws._pack(ess, jm, n_pad))
    packed = torch.zeros((5, alone.shape[1]), dtype=torch.int32)
    packed[[0, 2, 3]] = alone
    plan = ws._smem_plan(jm, n_pad, n_state, 13)
    lay = ws._layout(jm, n_pad, n_state, 13)
    for empty_budget in (0, 1000):
        msteps = torch.tensor([1000, empty_budget, 1000, 1000, empty_budget],
                              dtype=torch.int32)
        small = torch.full((3, 5), -7, dtype=torch.int32)
        scratch = torch.full((5 * lay.words,), 0x5A5A5A5A, dtype=torch.int32)
        assert ws._launch(emu, packed, msteps, small, scratch, jm, n_pad,
                          n_state, 13, plan, lay) == 0
        want = ws.search_plain(packed, msteps, jm, n_pad, n_state, 13)
        assert torch.equal(small, want), (small.tolist(), want.tolist())
        assert small[:, [1, 4]].tolist() == [[1, 1], [0, 0], [0, 0]]
        assert torch.equal(small[:, [0, 2, 3]], ws.search_plain(
            alone, torch.full((3,), 1000, dtype=torch.int32), jm, n_pad,
            n_state, 13))


def test_launch_refuses_bad_plans(emu):
    """A plan the launch cannot run returns an error: a misaligned or
    missing table offset, key rows past the scratch, node ids too narrow
    for the n_pad, and shared memory past the opt-in limit."""
    jm = tjit.cas_register
    ess = lanes_of("cas-register", 1, 10, seed=600)
    n_pad, cb = 64, 13
    packed = torch.from_numpy(ws._pack(ess, jm, n_pad))
    msteps = torch.full((1,), 100, dtype=torch.int32)
    small = torch.zeros((3, 1), dtype=torch.int32)
    plan = ws._smem_plan(jm, n_pad, 1, cb)
    lay = ws._layout(jm, n_pad, 1, cb)
    scratch = torch.zeros((lay.words,), dtype=torch.int32)

    def launch(plan=plan, lay=lay, widths=None):
        words = ws._plan_words(n_pad, plan, lay)
        if widths:
            words[-2], words[-1] = widths
        return emu.wgl_search_launch(
            packed.data_ptr(), msteps.data_ptr(), small.data_ptr(),
            scratch.data_ptr(), 1, n_pad, ws._m_pad(n_pad),
            packed.shape[1], ws.MODEL_IDS[jm.name], 1, cb, ws._nw(n_pad),
            ws._init_state(jm), words, None)

    assert launch() == 0
    fact = ws.TABLES.index("fact")
    assert plan.mask >> fact & 1
    bad = dict(lay.smem, fact=lay.smem["fact"] + 4)
    assert launch(lay=lay._replace(smem=bad)) != 0
    gone = {k: v for k, v in lay.smem.items() if k != "fact"}
    assert launch(plan=plan._replace(mask=plan.mask & ~(1 << fact)),
                  lay=lay._replace(smem=gone)) != 0
    assert launch(lay=lay._replace(words=lay.words - 1)) != 0
    assert launch(widths=(4, 2)) != 0
    big = ws._smem_plan(jm, 16384, 1, cb, 1 << 20)
    assert big.bytes > 232448
    assert ws._launch(
        emu, torch.from_numpy(ws._pack(ess, jm, 16384)), msteps, small,
        torch.zeros((ws._layout(jm, 16384, 1, cb, 1 << 20).words,),
                    dtype=torch.int32),
        jm, 16384, 1, cb, big, ws._layout(jm, 16384, 1, cb, 1 << 20)) != 0
