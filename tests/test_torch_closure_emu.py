"""closure.cu's own source, run on the CPU, against the plain versions.

The kernels have no interpret mode, so this compiles `csrc/closure.cu`
with g++ against `csrc/warp_emu.h` (one thread a CUDA thread, a barrier
a warp, an emulated device of two SMs, so the persistent grids are two
blocks whose warps stride over several tiles) and calls its launch entry
points on CPU tensors: `unpack`, the threshold pass (words, flag,
operand; the launch refuses a missing operand), `closure_word`, and a
whole bucket
fixpoint through the emulated passes and the product, at p 64 and 128
with columns 31 and 63 (the sign bit of a word) set. Every result must
equal the plain version's bit for bit. On the card chip_smoke.py holds
the same kernels to the same plain versions."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.ops import _build, closure


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """The kernels' source built for the host: its library."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp("closure_emu")
    with open(f"{_build.CSRC}/closure.cu") as fh:
        src = fh.read()
    src, n = re.subn(
        r"(\w+)<<<(.+?),\s*(\w+),\s*(\w+),\s*\(cudaStream_t\)stream>>>\(",
        r"emu_launch(\1, \2, \3, \4, ", src, flags=re.S)
    assert n == 3
    src = src.replace("#include <cuda_runtime.h>", '#include "warp_emu.h"')
    (d / "closure_emu.cc").write_text(src)
    so = d / "libclosure_emu.so"
    r = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC",
         f"-I{_build.CSRC}", "-o", str(so), str(d / "closure_emu.cc")],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in closure._SIG.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def packed(p: int, b: int, density: float, seed: int) -> torch.Tensor:
    """[b, p, p//32] words of seeded digraphs, columns 31 and 63 of
    some rows set."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(b):
        a = rng.random((p, p)) < density
        a[rng.integers(p, size=4), 31] = True
        a[rng.integers(p, size=4), 63] = True
        mats.append(a)
    return torch.from_numpy(closure._pack(mats, p))


def unpack_emu(lib, words, p, out=None):
    out = closure._out(out, (words.shape[0], p, p), torch.bfloat16,
                       words.device)
    assert lib.closure_unpack_launch(words.data_ptr(), out.data_ptr(),
                                     words.numel(), None) == 0
    return out


def otp_emu(lib, prod, words, flag, out=None, operand=None):
    out = closure._out(out, words.shape, torch.int32, words.device)
    assert lib.closure_or_threshold_pack_launch(
        prod.data_ptr(), words.data_ptr(), out.data_ptr(), flag.data_ptr(),
        operand.data_ptr(), words.numel(), None) == 0
    return out


def products(words, p, seed):
    """The real product of the words' operand, and a seeded bf16 matrix
    of zeros, ±0, counts past 256, +inf, -inf, NaN and negatives, so the
    threshold is held to `> 0` on every kind of value."""
    real = closure.matmul(closure.unpack_plain(words, p))
    rng = np.random.default_rng(seed)
    kinds = np.array([0.0, -0.0, 1.0, 3.0, 300.0, np.inf, -np.inf, np.nan,
                      -2.0, 1e-30], dtype=np.float32)
    pick = rng.integers(len(kinds), size=real.shape)
    odd = torch.from_numpy(np.where(rng.random(real.shape) < 0.02,
                                    kinds[pick], 0.0)).to(torch.bfloat16)
    return real, odd


@pytest.mark.parametrize("p", [64, 128])
def test_unpack(emu, p):
    words = packed(p, 3, 0.3, p)
    assert bool((words < 0).any())  # the sign bit is set somewhere
    got = unpack_emu(emu, words, p,
                     out=torch.full((3, p, p), 7.0, dtype=torch.bfloat16))
    assert torch.equal(got.view(torch.int16),
                       closure.unpack_plain(words, p).view(torch.int16))


@pytest.mark.parametrize("p", [64, 128])
def test_threshold_pass_with_operand(emu, p):
    """Words, flag and operand equal the plain version's; the operand is
    rewritten only under the bytes that gained bits (a garbage operand
    keeps its garbage elsewhere), and from a true operand it leaves as
    unpack(new words). In place (out = words) too."""
    words = packed(p, 3, 0.05, 10 + p)
    for i, prod in enumerate(products(words, p, 20 + p)):
        for garbage in (False, True):
            if garbage:
                g = np.random.default_rng(30 + i).standard_normal(
                    (3, p, p)).astype(np.float32)
                operand = torch.from_numpy(g).to(torch.bfloat16)
            else:
                operand = closure.unpack_plain(words, p)
            k_op, p_op = operand.clone(), operand.clone()
            k_flag = torch.zeros(1, dtype=torch.int32)
            p_flag = torch.zeros(1, dtype=torch.int32)
            k_new = otp_emu(emu, prod, words, k_flag, operand=k_op)
            p_new = closure.or_threshold_pack_plain(prod, words, p_flag,
                                                    operand=p_op)
            assert torch.equal(k_new, p_new)
            assert int(k_flag) == int(p_flag) == 1
            assert torch.equal(k_op.view(torch.int16),
                               p_op.view(torch.int16))
            if not garbage:
                assert torch.equal(k_op, closure.unpack_plain(k_new, p))
            # the same pass again from the new words: nothing changes, so
            # the flag stays 0 and not one operand value is written
            before = k_op.clone()
            k_flag.zero_()
            inplace = k_new.clone()
            otp_emu(emu, prod, inplace, k_flag, out=inplace, operand=k_op)
            assert torch.equal(inplace, k_new) and int(k_flag) == 0
            assert torch.equal(k_op.view(torch.int16),
                               before.view(torch.int16))
    # in place from the old words
    w, op = words.clone(), closure.unpack_plain(words, p)
    flag = torch.zeros(1, dtype=torch.int32)
    otp_emu(emu, prod, w, flag, out=w, operand=op)
    assert torch.equal(w, p_new) and int(flag) == 1
    assert torch.equal(op, closure.unpack_plain(w, p))


def test_threshold_pass_refuses_no_operand(emu, monkeypatch):
    """The card's threshold pass always refreshes an operand: the
    wrapper raises ValueError for a CUDA launch without one (before it
    reaches the library), and the launch returns cudaErrorInvalidValue
    for a NULL operand, writing nothing."""
    words = packed(64, 2, 0.05, 104)
    prod = products(words, 64, 114)[0]
    flag = torch.zeros(1, dtype=torch.int32)
    monkeypatch.setattr(closure, "_cuda", lambda t: True)
    monkeypatch.setattr(closure, "build", lambda dev=None: pytest.fail(
        "the wrapper reached the library"))
    with pytest.raises(ValueError, match="operand"):
        closure.or_threshold_pack(prod, words, flag)
    out = torch.full_like(words, 7)
    assert emu.closure_or_threshold_pack_launch(
        prod.data_ptr(), words.data_ptr(), out.data_ptr(), flag.data_ptr(),
        None, words.numel(), None) != 0
    assert bool((out == 7).all()) and int(flag) == 0


def test_closure_word(emu):
    """The one-word bucket: 40 matrices of 2-32 nodes, column 31 set in
    some, and a 32-node path (six rounds), words and rounds as plain."""
    rng = np.random.default_rng(60)
    mats = []
    for i in range(40):
        n = int(rng.integers(2, 33))
        a = rng.random((n, n)) < float(rng.random()) * 0.3
        if n == 32:
            a[rng.integers(32), 31] = True
        mats.append(a)
    mats.append(np.eye(32, k=1, dtype=bool))
    words = torch.from_numpy(closure._pack(mats, 32)[..., 0].copy())
    rounds = closure.rounds_for(32)
    out = torch.empty_like(words)
    taken = torch.empty(words.shape[0], dtype=torch.int32)
    assert emu.closure_word_launch(words.data_ptr(), out.data_ptr(),
                                   taken.data_ptr(), words.shape[0], rounds,
                                   None) == 0
    want, want_t = closure.closure_word_plain(words, rounds)
    assert torch.equal(out, want) and torch.equal(taken, want_t)
    assert taken.tolist()[-1] == 6 and bool((out < 0).any())


@pytest.mark.parametrize("p", [64, 128])
def test_fixpoint(emu, p):
    """A bucket's whole fixpoint through the emulated unpack and
    threshold pass (the product on the CPU): the closed words and the
    rounds of closure_block_plain."""
    words0 = packed(p, 2, 1.5 / p, 70 + p)
    words = words0.clone()
    ran = closure._squaring(
        [words], p, closure.rounds_for(p),
        lambda w, p: unpack_emu(emu, w, p),
        lambda prod, w, flag, out, operand: otp_emu(emu, prod, w, flag, out,
                                                    operand))
    want, want_ran = closure.closure_block_plain(words0, p)
    assert torch.equal(words, want) and ran == want_ran
    assert ran > 2
