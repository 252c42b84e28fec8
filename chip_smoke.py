#!/usr/bin/env python3
"""Chip smoke test of jepsen_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]
        [--only crossover|closure|fuzz|linear|store|online|serve|mesh|checkers
                |runner|faults]

Run from the root of a checkout. It builds the port's kernel sources
(jepsen_tpu_torch/ops/csrc/wgl_vec.cu, wgl_row.cu, wgl_search.cu,
closure.cu and sim.cu, one nvcc each) and the native search
(wgl_native.cpp, g++), all started together, holds each WGL kernel bit
for bit against its plain PyTorch version on the card, then drives the
port's main paths — `independent.checker(linearizable(CASRegister(),
...))` over keyed register histories at the sizes the reference workload
checks (short lanes through wgl_vec, long lanes through wgl_row, and a
history mixing both), and one long single history; through wgl_search
the 50k-op stress history (and it with a planted impossible read), a
10k-op single history, 16 long fifo-queue keys and the 4096 register
keys (one launch of 4096 lanes); and one 10k-op
unordered-queue history split P-compositionally into micro-lanes on
wgl_vec — and checks the verdicts (against the host search's). Cells
that exist to drive a kernel name its engine (or set every bar of
"auto" to 1, the card half of the policy); beside each, the same check
under "auto" with the measured bars (GPU_BATCH_MIN) is its own main path,
and register-late under "auto" must leave no key unknown, with the
measured bars and with every bar at 1 (the native engine finishes what
K1's bounded memo gives up). A launch identical to one an earlier path
made is compared once. The crossover phase measures the bar of each
(card engine, model kind) against the native engine (`--only crossover`:
that phase alone, at the depth whose bars GPU_BATCH_MIN holds); the
corpus phase runs every case of the verdict corpus through each card
engine that takes it and through "auto".
Each path runs with every kernel's launch count set to 0 just before it
and read just after, and every search it launched is replayed through
the kernel and the plain version (lanes that ran past PLAIN_STEP_LIMIT
steps under the common LONG_CAP). wgl_vec's widest main-path launches
run again at other lanes-a-block counts beside its plan's
(SWEEP_LANES), bit for bit equal; wgl_search is held against its plain
version at every tier of its shared-memory plan (the n_pads on each side
of each tier boundary, all five models, memos of 8192 and of 8 slots,
and of 2^17 slots, whose fingerprints stay in device memory), and a plan
past the device's shared-memory limit must raise. Then the closure kernels
(closure_word, unpack, or_threshold_pack; the product is torch.matmul)
against their plain versions on seeded digraphs of 7 to 10,000 nodes,
and the cycle checker's main path, `cycle.checker().check`, on
list-append histories of 5,000 ops (its dict equal to the host DFS
engine's), 20,000 ops and 5,000 ops with realtime edges (unpack one a
bucket, the product and the threshold pass that refreshes the operand
one a round), every bucket fixpoint it ran replayed round by round
through the kernels and their plain versions, each launch timed alone
behind a GPU spin beside its bound, and closure_word's launch on one
matrix for one round beside its bucket's (`--only closure`: those
phases alone). Then the sim kernel against its plain version at six
specs (1024 clusters each), and the fuzz path: 1024 seeded clusters
simulated in one sim launch and scored through the closure kernels
(scores equal to the host DFS engine's), with the fuzz loop's round of
256 clusters launched beside it, 16,384 clusters for throughput, and the
8 committed anomaly traces (their types and coverage reproduced), every
sim launch held bit for bit against its plain version and timed behind
the spin beside a bound counted from the work its outputs need, at the
256, 1,024 and 16,384 batches also at 32 to 256 threads a block
(`--only fuzz`: those phases alone). Then the `linear` phase: every
corpus case through the `linear` algorithm on the host and through
`competition` on the card (linear raced against K2's counterpart), at
a 2-s limit a case, every K2 launch held against its plain version, the
winners counted and the card's busy time behind an abandoned loser
measured (`--only linear`); and the `store` phase: the register cell
(every bar at 1) and cycle_append with a store dir and an analysis
journal under a temporary directory (run 1 writes each key's
results.edn, history.txt and linear.svg, or timeline-cycle.html; the
journaled run 2 launches nothing and gives run 1's dict), and the fuzz
loop (FuzzLoop(clusters=256), 4 rounds) on the card and on the host
engines, whose corpus files must be byte-identical (`--only store`).
Then the `online` phase: the JAX package's online bench stream (34
register keys of 150 invocations, ~10k ops) through `WGLFrontier` over
the registry's register workload in windows of 512, with every bar at 1
(each window's dirty keys through K1) and beside it with the measured
bars, each window's verdict equal to a one-shot check of that prefix;
and 4,000 list-append ops with a G1c at the middle through
`StreamSession(window=256, abort_on_invalid=True)` over `CycleFrontier`
on the card, which must abort before the end, each advance's dict equal
to `CycleChecker.check` of that prefix, K3's launches counted, timed and
replayed (`--only online`). Then the `serve` phase: 100 register
histories from 5 clients through an in-process `VerdictDaemon` on the
card (bars at 1, then the measured bars; every verdict as built), a
blamed cycle job through the sacrificial subprocess on the card, the
bundle's warm pass in process (K1, K5 and K2 at n_pad 32 and 64, K3 at
pads 32 and 64, every launch replayed) and its `ensure()` in two fresh
processes (stale, then warm), and `python -m jepsen_tpu_torch watch` on
the three EDN fixtures, exit codes as expected.json says (`--only
serve`). The subprocesses' launches cannot be counted or replayed from
here, so each subprocess path also runs in this process as a main path
of its own, every launch replayed: `run_watch` on the three fixtures,
the sacrificial child's `run_one` on the same blamed job, and the warm
pass (the same fixed inputs as `ensure()`'s). Then the `mesh` phase,
the multi-device engines over the device list ["cuda:0"] * 2 and * 3
(one card dealt as several; the routes opened by `device.devices()`
answering that list): K2's deal of 2,048 register lanes (64
invocations, every 8th key bad) and of main_fifo_long's 16 fifo lanes
through the `wgl_mesh` route of
`linearizable(..., algorithm="gpu_search")`, K1's block shards of the
same 2,048 lanes, the cycle checker's `closure_mesh` route on
cycle_append and cycle_append_20k's bucket fixpoints dealt over K3's
row blocks, and `doctor.diagnose(devices=["cuda:0"] * 2)`: every dealt
result equal to one device's, every shard launch held bit for bit
against its plain version (`--only mesh`). Then the `checkers` phase,
the checkers that reach the closure kernels through the cycle checker,
each on a history from a seeded maker here (5 clients, 8 % of
completions :info): adya's G2 checker on 8,192 keys of insert pairs
(128 planted double inserts), long_fork's on 4,096 keys (a fork planted
in every 64th group), causal's (the causal replay and the value-order
cycle checker composed, a key a thread) on 512 keys (8 stale reads),
each dict equal to the one on device="cpu" (and adya's counts and
long_fork's validity to the legacy paths'), causal's first 64 keys
again under independent.checker(processes=2) in spawned workers (equal
to the thread path); the bank-setfull histories through the bank and
set-full checkers on the host; `single_test_cmd(...)["analyze"]` over
two stores (the register cell's keyed store written by
IndependentChecker, and one 3,000-invocation register history analysed
with --checker linearizable), exit codes and results files equal to the
runs that wrote them; and `python -m jepsen_tpu_torch fuzz` in a
subprocess, the command in process and with --device cpu, corpus files
byte-identical; every K3 and K4 launch held against its plain version,
and an empty kernel's launch timed as the launch floor (`--only
checkers`). Then the `runner` phase, the test runner end to end: the
etcd suite's `test` subcommand (`cli.single_test_cmd`) on five
simulated members, one process a node over LocalRemote, 20 workers,
etcd's r/w/cas workload for 15 s, its checker a key at a time on K1 or
K5 with every bar at 1: exit 0 and valid, the wall split into
provision, workers, save, analyze and teardown; `analyze` over its
store under every bar at 1 and under the committed bars, the same
per-key verdicts; a 5-s run whose client plants one stale read on
each of two keys: exit 1, exactly those keys refuted; and, under
`--only runner` only (the whole script would pass its 1200-s
limit), the same test in a subprocess SIGTERMed 5 s into its ops (exit
143), then `resume` here (exit 0, valid, the first session's ops then
the second's); every K1 and K5 launch held against its plain version.
Then the `faults` phase, the fault layer under the same suite, cluster
and workload: `test --nemesis kill,pause,partition,clock,corruption
--seed 0` (8 fault ops 1.5 s apart, a 15-s limit, a 3-s stability
window): exit 0, every key True, the recovery checker valid with kill,
pause, partition and corruption seen, a member's pid changed by a kill,
the nemesis ops a prefix of `combined.materialize_schedule`'s document
then its heal ops; then one fuzz-loop round of 256 clusters on the card,
its entry with the most fault families rendered by
`fuzz.schedule.to_nemesis_doc` and replayed by `test
--nemesis-schedule`: the nemesis ops exactly the document's; clock
faults go to a recording setter, never to this machine's clock; every
K4, K3 and K1 launch held against its plain version (`--only faults`).
Every phase prints one JSON line; the last lines are the kernel table (per kernel and main-path
cell: kernel ms, launches, for the WGL kernels the longest lane's steps
and µs a step and each launch's shared bytes and lanes a block (for
wgl_search also the tables in shared memory, scratch bytes and the share
of the bound reached, by main-path shape), for the
closure kernels each bucket's rounds, the bound; the product's launches
and ms beside), the card's name and power limit (nvidia-smi), and
{"ok": true, "device": ...}. Any failed check raises, so the exit code
is not 0. Without CUDA, or outside a checkout, it exits 2 and prints no
result. It imports nothing of jax or jepsen_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet / Hopper white paper):
# HBM3 bandwidth, and int32 ALU throughput (64 INT32 lanes per SM x 132
# SMs x 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations one search step does besides the memo key compare
# (decode the entry, step the model, hash, relink four list words,
# push or pop, bookkeeping) — counted from wgl_vec.cu's step body, and
# taken for wgl_row.cu's too
STEP_OPS = 64
# dense bf16 tensor-core peak of one H100 SXM (data sheet): the bound of
# the closure's product
BF16_FLOPS_PER_S = 989e12


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries `at_s`, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn):
    """Milliseconds of fn() on the current stream (CUDA events around
    the whole call), and fn()'s result."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def kernel_ms(mod, fn, reps: int = 5):
    """Median milliseconds of the kernel alone over `reps` launches (the
    wrapper's own events, recorded right around each launch), after one
    warm-up launch; and the last launch's result."""
    import torch

    fn()
    mod.TIMED = []
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in mod.TIMED)
    mod.TIMED = None
    return times[len(times) // 2], out


# lockstep steps the plain version is run for in one comparison (~0.3 ms
# a step on the card): lanes whose kernel search took longer are left out
# of that launch's full plain run, and the line says how many were compared
PLAIN_STEP_LIMIT = 200_000
# ...and are compared instead under this common step budget, through both
# the kernel and the plain version (a capped search is the same search up
# to the cap)
LONG_CAP = 20_000
# lanes a block K1 is timed at beside its plan's, on the main paths'
# widest launches (those that fit)
SWEEP_LANES = (1, 2, 4, 8, 16, 32)


class Kernel:
    """One kernel's row of the final table, built up by the phases."""

    library = False  # a PyTorch call timed beside the kernels, no row

    def __init__(self, name, mod, replaces):
        self.name, self.mod, self.replaces = name, mod, replaces
        # the kernel module's own name (wgl_vec, wgl_row, wgl_search, ...):
        # what a launch is replayed through
        self.engine = mod.__name__.rsplit(".", 1)[1]
        self.launches = 0  # on the main paths
        self.compared = 0
        self.max_abs_err = 0
        self.shape = None
        self.ms = self.plain_ms = self.bound_ms = None
        self.bound_by = None
        self.cells = {}  # main-path cell -> its launches' figures
        self.widest = {}  # main-path cell -> its widest captured launch
        self.lanes_sweep = None
        self.extra = {}  # kernel-specific fields of its row

    def reset(self) -> None:
        """Launch count to 0; time and capture every launch."""
        self.mod.LAUNCHES = 0
        self.mod.TIMED, self.mod.CAPTURE = [], []

    def collect(self) -> tuple:
        """(launches, kernel ms, captured launches) since `reset`."""
        return (self.mod.LAUNCHES,
                sum(a.elapsed_time(b) for a, b in self.mod.TIMED),
                self.mod.CAPTURE)

    def release(self) -> None:
        self.mod.TIMED = self.mod.CAPTURE = None

    def row(self) -> dict:
        return {
            "name": self.name, "route": "cuda",
            "source": "jepsen_tpu_torch/ops/csrc/"
                      f"{self.mod.__name__.rsplit('.', 1)[1]}.cu",
            "replaces": self.replaces,
            "launches": self.launches, "max_abs_err": self.max_abs_err,
            "ms": self.ms, "kernel_ms": self.ms, "plain_ms": self.plain_ms,
            "bound_ms": self.bound_ms, "bound_by": self.bound_by,
            "library_ms": None, "shape": self.shape,
            "matches_plain": self.max_abs_err == 0,
            "compared_launches": self.compared, "cells": self.cells,
            "lanes_sweep": self.lanes_sweep, **self.extra}


def bound(packed, n_pad, small, key_words) -> tuple:
    """(seconds for the bytes, seconds for the operations) of one launch
    over `packed`: the packed input and step budgets read once, the
    result block and best stack written once, over HBM bandwidth; and
    the steps this run took times the int32 operations of one step, over
    the int32 rate. The bound is the larger of the two."""
    width = packed.shape[1]
    nbytes = 4 * (packed.numel() + width + 5 * width + n_pad * width)
    ops = int(small[1].sum()) * (key_words + STEP_OPS)
    return nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S


def bound_ms(t_bytes: float, t_ops: float) -> tuple:
    return (1000 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare(kernel, launch) -> dict:
    """Replay one captured `search` of `kernel` through the kernel and
    its plain version (`compare_vec`, `compare_row` or `compare_search`,
    which `compare_all` also gives several launches of one shape)."""
    if kernel.engine == "wgl_row":
        return compare_row(kernel.mod, launch, kernel)
    if kernel.engine == "wgl_search":
        return compare_search(kernel.mod, [launch], kernel)[0]
    return compare_vec(kernel.mod, launch, kernel)


def check_equal(kernel, name, small, small_p, best=None, best_p=None):
    """Fold one comparison into the kernel's max_abs_err; raise unless
    the kernel's outputs equal the plain version's bit for bit."""
    import torch

    parts = [(small.long() - small_p.long()).flatten(),
             small.new_zeros(1, dtype=torch.long)]
    if best is not None:
        parts.append((best.long() - best_p.long()).flatten())
    err = int(torch.cat(parts).abs().max())
    kernel.max_abs_err = max(kernel.max_abs_err, err)
    kernel.compared += 1
    if err:
        bad = (small != small_p).any(0).nonzero()[:4, 0].tolist()
        raise AssertionError(
            f"{kernel.name} {name}: kernel != plain at lanes {bad}: "
            f"{small[:, bad].tolist()} vs {small_p[:, bad].tolist()}")


def vec_lanes(wv, packed, msteps, cols, cap=None):
    """The lanes `cols` of a wgl_vec launch as a buffer of their own
    (lanes are independent; zero columns are empty lanes, valid at once,
    no search), with their step budgets or `cap` for every one."""
    import torch

    n_cmp = len(cols)
    w = max(1, -(-n_cmp // wv.LANES)) * wv.LANES
    sub = torch.zeros((packed.shape[0], w), dtype=packed.dtype,
                      device=packed.device)
    sub[:, :n_cmp] = packed[:, cols]
    steps = torch.zeros(w, dtype=msteps.dtype, device=msteps.device)
    steps[:n_cmp] = msteps[cols] if cap is None else cap
    return sub, steps


def compare_vec(wv, launch, kernel) -> dict:
    """Replay one captured `search` (wgl_vec.CAPTURE): the kernel, timed,
    and the plain version on the same inputs on the card. The result
    block and best stack must be bit-identical on every compared lane,
    or this raises. Lanes whose kernel search took more than
    PLAIN_STEP_LIMIT steps are left out of the full plain run and run
    again through both under LONG_CAP. Returns the launch's figures."""
    import torch

    packed, msteps, jm, n_pad, n_state, slots = launch
    k_ms, (small_k, best) = kernel_ms(wv, lambda: wv.search(*launch))
    small = small_k
    width = packed.shape[1]
    long = small_k[1] > PLAIN_STEP_LIMIT
    cols = (~long).nonzero()[:, 0]
    n_cmp = len(cols)
    if n_cmp == width:
        sub, sub_steps = packed, msteps
    else:
        sub, sub_steps = vec_lanes(wv, packed, msteps, cols)
        small, best = small[:, cols], best[:, cols]
    p_ms, (small_p, best_p) = cuda_ms(lambda: wv.search_plain(
        sub, sub_steps, jm, n_pad, n_state, slots))
    check_equal(kernel, jm.name, small, small_p[:, :n_cmp], best,
                best_p[:, :n_cmp])
    t_b, t_o = bound(packed, n_pad, small_k,
                     wv._key_words(jm, n_pad, n_state))
    b_ms, b_by = bound_ms(t_b, t_o)
    plan = wv.launch_plan(packed, jm, n_pad, n_state, slots)
    real = (packed[-1] & 0xFFFF) > 0  # lanes with entries
    out = {"lanes": int(real.sum()), "rows": packed.shape[0],
           "n_pad": n_pad, "slots": slots,
           "cap": int(msteps.max()), "kernel_ms": k_ms, "plain_ms": p_ms,
           "plain_lanes": int(real[cols].sum()), "bound_ms": b_ms,
           "bound_by": b_by, "t_bytes": t_b, "t_ops": t_o,
           "steps": int(small_k[1].sum()),
           "max_lane_steps": int(small_k[1].max()),
           "smem_bytes": plan.bytes, "lanes_per_block": plan.lanes}
    if bool(long.any()):
        lcols = long.nonzero()[:, 0]
        t0 = time.perf_counter()
        sub, sub_steps = vec_lanes(wv, packed, msteps, lcols, LONG_CAP)
        small_l, best_l = wv.search(sub, sub_steps, jm, n_pad, n_state, slots)
        small_lp, best_lp = wv.search_plain(sub, sub_steps, jm, n_pad,
                                            n_state, slots)
        check_equal(kernel, f"{jm.name} capped", small_l, small_lp,
                    best_l, best_lp)
        torch.cuda.synchronize()
        out.update(long_lanes=len(lcols), long_cap=LONG_CAP,
                   long_s=time.perf_counter() - t0)
    return out


def bound_row(packed, n_pad, small, key_words) -> tuple:
    """(seconds for the bytes, seconds for the operations) of one wgl_row
    launch: the packed lanes, the Zobrist table and the step budgets read
    once and the (3, lanes) result written once, over HBM bandwidth; and
    this run's steps times (one memo row's key words + STEP_OPS) int32
    operations, over the int32 rate."""
    lanes = packed.shape[0]
    nbytes = 4 * (packed.numel() + n_pad + lanes + 3 * lanes)
    ops = int(small[1].sum()) * (key_words + STEP_OPS)
    return nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S


def compare_row(wr, launch, kernel) -> dict:
    """Replay one captured wgl_row `search` (wgl_row.CAPTURE): the
    kernel, timed, and the plain version on the same inputs on the card.
    Verdict, steps and depth must be bit-identical on every compared
    lane, or this raises. Lanes whose kernel search took more than
    PLAIN_STEP_LIMIT steps are left out of the full plain run (the lanes
    are rows of `packed`, so the others are compared as a smaller batch)
    and run again through both under LONG_CAP."""
    import torch

    packed, msteps, jm, n_pad, cache_bits = launch
    k_ms, small_k = kernel_ms(wr, lambda: wr.search(*launch))
    lanes = packed.shape[0]
    long = small_k[1] > PLAIN_STEP_LIMIT
    cols = (~long).nonzero()[:, 0]
    n_cmp = len(cols)
    small = small_k
    if n_cmp == lanes:
        sub, sub_steps = packed, msteps
    else:
        sub = packed[cols].contiguous()
        sub_steps = msteps[cols].contiguous()
        small = small_k[:, cols]
    p_ms, small_p = cuda_ms(lambda: wr.search_plain(
        sub, sub_steps, jm, n_pad, cache_bits))
    check_equal(kernel, jm.name, small, small_p)
    t_b, t_o = bound_row(packed, n_pad, small_k, wr.key_words(n_pad))
    b_ms, b_by = bound_ms(t_b, t_o)
    plan = wr.launch_plan(packed, n_pad, cache_bits)
    out = {"lanes": lanes, "n_pad": n_pad, "cache_bits": cache_bits,
           "cap": int(msteps.max()), "kernel_ms": k_ms, "plain_ms": p_ms,
           "plain_lanes": n_cmp, "bound_ms": b_ms, "bound_by": b_by,
           "t_bytes": t_b, "t_ops": t_o, "steps": int(small_k[1].sum()),
           "max_lane_steps": int(small_k[1].max()),
           "smem_bytes": plan.bytes, "lanes_per_block": plan.lanes,
           "verdicts": small_k[0].tolist() if lanes <= 16 else None}
    if bool(long.any()):
        lcols = long.nonzero()[:, 0]
        t0 = time.perf_counter()
        sub = packed[lcols].contiguous()
        sub_steps = torch.full_like(msteps[lcols], LONG_CAP)
        check_equal(kernel, f"{jm.name} capped",
                    wr.search(sub, sub_steps, jm, n_pad, cache_bits),
                    wr.search_plain(sub, sub_steps, jm, n_pad, cache_bits))
        torch.cuda.synchronize()
        out.update(long_lanes=len(lcols), long_cap=LONG_CAP,
                   long_s=time.perf_counter() - t0)
    return out


# bytes one wgl_search step must move at the least, from the kernel's own
# reads and writes: the node's map words (2), the entry's six columns, the
# four list words read and the four written, in int32 words, and the 8
# probe fingerprints (uint16); the Zobrist word is computed, not read
SEARCH_STEP_BYTES = 4 * (2 + 6 + 4 + 4) + 2 * 8
# steps x state words the plain version's FNV fold may take in one
# comparison of a wgl_search launch (its graph holds 3 nodes a state word
# a step): a fifo launch with n_state 1024 is compared in full up to
# 12,500 steps a lane, and lanes past that under that many steps
SEARCH_FOLD_WORK = 12_800_000


def search_plain_limit(jm, n_state: int) -> int:
    """Steps past which a wgl_search lane is compared under a cap: the
    common PLAIN_STEP_LIMIT, lower where the plain version folds a wide
    state word by word each step."""
    if not jm.state_in_key or n_state <= 1:
        return PLAIN_STEP_LIMIT
    return min(PLAIN_STEP_LIMIT, SEARCH_FOLD_WORK // n_state)


def bound_search(ws, packed, launch, small) -> tuple:
    """(seconds for the bytes, seconds for the operations) of one
    wgl_search launch, both from the work this run's data needs at the
    least: the packed lanes and the step budgets read once and the (3,
    lanes) result written once; SEARCH_STEP_BYTES a step this run took;
    and every key the run must have inserted — at least one per level of
    each lane's final depth — written once, at the words such a key
    holds (a fifo key's bitset and count words, its live window not
    counted). Operations: STEP_OPS int32 operations a step and one a word
    of those keys, over the int32 rate."""
    _, _, jm, n_pad, n_state, _ = launch
    lanes = packed.shape[0]
    kw = ws.key_words(jm, n_pad, n_state)
    kw_min = ws._nw(n_pad) + 1 if jm.name == "fifo-queue" else kw
    steps = int(small[1].sum())
    key_words = kw_min * int(small[2].sum())
    nbytes = (4 * (packed.numel() + lanes + 3 * lanes)
              + SEARCH_STEP_BYTES * steps + 4 * key_words)
    ops = steps * STEP_OPS + key_words
    return nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S


def compare_search(ws, launches, kernel, cap=None) -> list:
    """Replay captured wgl_search `search`es of one shape
    (wgl_search.CAPTURE; model, n_pad, n_state and cache_bits alike):
    each through the kernel, timed, with its own bound; and the lanes of
    all of them through the plain version on the card in one lockstep
    run (the lanes are independent, and the plain version's cost is its
    longest lane's steps). Verdict, steps and depth must be
    bit-identical on every lane, or this raises: each timed launch's
    lanes as that launch left them. Lanes whose kernel search took more
    steps than `search_plain_limit` (or `cap`, where lower) run under
    that many steps in that same plain run, beside the others at their
    own budgets, and through the kernel again alone under that cap. One
    dict a launch; the plain run's time and the capped lanes stand on
    the first."""
    import torch

    _, _, jm, n_pad, n_state, cache_bits = launches[0]
    limit = search_plain_limit(jm, n_state)
    if cap is not None:
        limit = min(limit, cap)
    lay = None
    outs, smalls = [], []
    for launch in launches:
        packed, msteps = launch[:2]
        k_ms, small_k = kernel_ms(ws, lambda: ws.search(*launch))
        t_b, t_o = bound_search(ws, packed, launch, small_k)
        b_ms, b_by = bound_ms(t_b, t_o)
        plan = ws.launch_plan(packed, jm, n_pad, n_state, cache_bits)
        lay = lay or ws._layout(jm, n_pad, n_state, cache_bits,
                                ws._smem_max(packed.device))
        lanes = packed.shape[0]
        top = int(small_k[1].max())
        outs.append({
            "model": jm.name, "lanes": lanes, "n_pad": n_pad,
            "n_state": n_state, "cache_bits": cache_bits,
            "cap": int(msteps.max()), "kernel_ms": k_ms, "plain_ms": None,
            "plain_lanes": int((small_k[1] <= limit).sum()),
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
            "t_bytes": t_b, "t_ops": t_o, "steps": int(small_k[1].sum()),
            "max_lane_steps": top, "us_per_step": 1000 * k_ms / max(1, top),
            "scratch_bytes": 4 * lay.words * lanes,
            "smem_bytes": plan.bytes, "lanes_per_block": 1,
            "smem_tables": list(plan.smem),
            "verdicts": small_k[0].tolist() if lanes <= 16 else None})
        smalls.append(small_k)
    if len(launches) > 1:
        packed = torch.cat([la[0] for la in launches])
        msteps = torch.cat([la[1] for la in launches])
        small_k = torch.cat(smalls, 1)
        outs[0]["plain_launches"] = len(launches)
    long = small_k[1] > limit
    # one plain run takes every lane: the long ones under the cap, the
    # others at their own budgets
    steps_cmp = torch.where(long, torch.full_like(msteps, limit), msteps)
    outs[0]["plain_ms"], small_p = cuda_ms(lambda: ws.search_plain(
        packed, steps_cmp, jm, n_pad, n_state, cache_bits))
    short = (~long).nonzero()[:, 0]
    if len(short):
        # the timed launches themselves, at their own shapes and budgets
        check_equal(kernel, f"{jm.name} n_pad {n_pad}", small_k[:, short],
                    small_p[:, short])
    if bool(long.any()):
        lcols = long.nonzero()[:, 0]
        t0 = time.perf_counter()
        small_l = ws.search(packed[lcols].contiguous(),
                            steps_cmp[lcols].contiguous(), jm, n_pad,
                            n_state, cache_bits)
        torch.cuda.synchronize()
        outs[0].update(long_lanes=len(lcols), long_cap=limit,
                       long_s=time.perf_counter() - t0)
        check_equal(kernel, f"{jm.name} n_pad {n_pad} capped", small_l,
                    small_p[:, lcols])
    return outs


def shifted(hist, d: int):
    """`hist` with every register value moved up by `d`."""
    def sh(v):
        if isinstance(v, tuple):
            return tuple(x + d for x in v)
        return v if v is None else v + d
    return [o.with_(value=sh(o.value)) for o in hist]


def planted(hist, n_values: int = 3):
    """`hist` with its first :ok read returning `n_values`, a value no
    write wrote: certainly not linearizable, refuted early."""
    hist = list(hist)
    i = next(i for i, o in enumerate(hist) if o.type == "ok" and o.f == "read")
    hist[i] = hist[i].with_(value=n_values)
    return hist


def verdict_counts(valids) -> dict:
    valids = list(valids)
    return {str(v): sum(1 for x in valids if x == v)
            for v in (True, False, "unknown")}


def phase_kernel_vs_plain(args, kernel):
    """Phase 3: kernel == plain on the card for every model family and
    both value packings and memo sizes. Each batch goes through
    `analysis_batch`; every search it launched is replayed through
    `compare`. The cas-register batch takes the two-pass schedule."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.workloads.queue import mutex_history, queue_history
    from jepsen_tpu_torch.workloads.register import register_history

    wv = kernel.mod
    s = args.seed
    batches = [
        ("cas-register", models.CASRegister, 200_000, [register_history(
            n_process=5, n_ops=64, corrupt=0.2, seed=s * 7919 + i)
            for i in range(256)]),
        # values outside int16: the 3-row (wide) packing
        ("cas-register-v32", models.CASRegister, 20_000, [shifted(
            register_history(n_process=5, n_ops=64, corrupt=0.2,
                             seed=s * 7919 + 500 + i), 2**20)
            for i in range(128)]),
        ("register", models.Register, 20_000, [register_history(
            n_process=5, n_ops=64, cas=False, corrupt=0.1 if i % 4 else 0.0,
            seed=s * 7919 + 1000 + i) for i in range(128)]),
        ("mutex", models.Mutex, 20_000, [mutex_history(
            n_process=5, n_ops=48, corrupt=0.1 if i % 4 == 0 else 0.0,
            seed=s * 7919 + 2000 + i) for i in range(128)]),
        ("unordered-queue", models.UnorderedQueue, 20_000, [queue_history(
            n_process=5, n_ops=40, corrupt=0.1 if i % 4 == 0 else 0.0,
            seed=s * 7919 + 3000 + i) for i in range(128)]),
        ("fifo-queue", models.FIFOQueue, 20_000, [queue_history(
            n_process=4, n_ops=24, fifo=True,
            corrupt=0.1 if i % 4 == 0 else 0.0,
            seed=s * 7919 + 4000 + i) for i in range(128)]),
        # 17+ enqueues in a lane: a 32- or 64-row ring, so the memo
        # shrinks below 128 slots
        ("fifo-queue-shrink", models.FIFOQueue, 20_000, [queue_history(
            n_process=3, n_ops=40, fifo=True,
            corrupt=0.1 if i % 4 == 0 else 0.0,
            seed=s * 7919 + 5000 + i) for i in range(128)]),
    ]
    for name, model, max_steps, hists in batches:
        wv.CAPTURE = []
        results = wv.analysis_batch(model(), hists, max_steps=max_steps,
                                    device="cuda")
        launches, wv.CAPTURE = wv.CAPTURE, None
        passes = [compare(kernel, launch) for launch in launches]
        n_pad = launches[0][3]
        if name == "cas-register-v32":
            assert passes[0]["rows"] == 3 * n_pad + 1, passes[0]["rows"]
        if name == "fifo-queue-shrink":
            assert passes[0]["slots"] < wv.CACHE_SLOTS, passes[0]["slots"]
        emit({"phase": "kernel_vs_plain", "model": name, "n_pad": n_pad,
              "max_steps": max_steps, "passes": passes,
              "matches_plain": True,
              "verdicts": verdict_counts(r.valid for r in results)})


def phase_row_vs_plain(args, kernel):
    """wgl_row == plain on the card for the three scalar models: lanes
    under and over 1024 entries, one near 4000, crashed (:info) ops,
    impossible reads (planted, and random corrupt reads), values above
    2^15, and a lane cut by a small step budget. Each batch goes through
    `wgl_row.analysis_batch`; every search it launched is replayed
    through `compare`."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.workloads.queue import mutex_history
    from jepsen_tpu_torch.workloads.register import register_history

    wr = kernel.mod
    s = args.seed * 7919 + 6000

    def reg(n, i, **kw):
        return register_history(n_process=5, n_ops=n, seed=s + i, **kw)

    batches = [
        ("cas-register", models.CASRegister, 20_000,
         [reg(200, i, corrupt=0.2) for i in range(3)]
         + [reg(n, 10 + i) for i, n in enumerate((700, 1400, 2100, 4000))]
         + [planted(reg(1800, 20)), planted(reg(600, 21))]
         + [shifted(reg(1500, 22), 2**20), shifted(reg(300, 23), 2**16)]),
        ("register", models.Register, 20_000,
         [reg(200, 30 + i, cas=False, corrupt=0.2) for i in range(2)]
         + [reg(n, 40 + i, cas=False) for i, n in enumerate((300, 1200))]
         + [reg(3990, 44, cas=False), planted(reg(2500, 45, cas=False))]),
        ("mutex", models.Mutex, 20_000,
         [mutex_history(n_process=5, n_ops=n, corrupt=c, seed=s + 50 + i)
          for i, (n, c) in enumerate(((150, 0.1), (150, 0.1), (300, 0.0),
                                      (1100, 0.0), (2000, 0.0)))]),
        # a long valid lane under a budget it cannot finish in: unknown
        ("cas-register-cut", models.CASRegister, 500, [reg(2000, 60)]),
    ]
    for name, model, max_steps, hists in batches:
        wr.CAPTURE = []
        results = wr.analysis_batch(model(), hists, max_steps=max_steps,
                                    device="cuda")
        launches, wr.CAPTURE = wr.CAPTURE, None
        passes = [compare(kernel, launch) for launch in launches]
        counts = verdict_counts(r.valid for r in results)
        if name == "cas-register-cut":
            assert counts["unknown"] == 1, counts
        else:
            assert counts["True"] and counts["False"], (name, counts)
        emit({"phase": "row_kernel_vs_plain", "model": name,
              "max_steps": max_steps,
              "history_ops": [len(h) for h in hists],
              "passes": passes, "matches_plain": True, "verdicts": counts})


def run_path(kernels, fn):
    """fn() with every kernel's launch count set to 0 just before it and
    read just after, and every launch timed and captured: (result, wall
    seconds, {name: (launches, kernel ms, captured launches)})."""
    import torch

    for k in kernels:
        k.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seen = {k.name: k.collect() for k in kernels}
    for k in kernels:
        k.release()
        k.launches += seen[k.name][0]
    return res, wall, seen


def lin_module():
    """jepsen_tpu_torch.checker.linearizable (the package's `linearizable`
    attribute is the function of that name)."""
    import importlib

    return importlib.import_module("jepsen_tpu_torch.checker.linearizable")


@contextlib.contextmanager
def card_bars(bar: int):
    """Every card engine's bar set to `bar` for the duration: with 1,
    "auto" sends every group of lanes to its card engine whole (the card
    half of the policy), as the kernel-driving cells need."""
    lin = lin_module()
    saved = lin.GPU_BATCH_MIN
    lin.GPU_BATCH_MIN = {k: bar for k in saved}
    try:
        yield
    finally:
        lin.GPU_BATCH_MIN = saved


def auto_beside(kernels, cell: str, fn) -> tuple:
    """fn(), a check under "auto" with the measured bars, as a main path
    of its own (counts reset before, read after, every launch replayed
    through `compare`): its result, and the fields its cell's line
    records beside the kernel-driving run."""
    lin = lin_module()
    f0 = lin.NATIVE_FINISH
    res, wall, seen = run_path(kernels, fn)
    passes = replay(kernels, seen, cell)
    return res, {"auto_wall_s": wall,
                 "auto_launches": {k: v[0] for k, v in seen.items() if v[0]},
                 "auto_native_finish": lin.NATIVE_FINISH - f0,
                 "auto_kernel_vs_plain": passes}


def wgl(kernels) -> list:
    """The WGL search kernels of `kernels`."""
    return [k for k in kernels
            if k.engine in ("wgl_vec", "wgl_row", "wgl_search")]


# (kernel, launch digest) -> (cell, compare() result) of every launch
# replayed so far: a launch with the same arguments as one an earlier path
# made (the same lanes, budget and plan) is not compared twice
COMPARED: dict = {}


def launch_digest(launch) -> str:
    """A digest of one captured launch's arguments."""
    import hashlib

    import numpy as np
    import torch

    h = hashlib.sha1()
    for a in launch:
        if torch.is_tensor(a):
            a = a.detach().cpu().numpy()
        if isinstance(a, np.ndarray):
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(repr(a).encode())
    return h.hexdigest()


def search_shape(launch) -> tuple:
    """The shape of one captured wgl_search launch: model, n_pad, n_state
    and cache_bits."""
    _, _, jm, n_pad, n_state, cache_bits = launch
    return jm.name, n_pad, n_state, cache_bits


def compare_all(k, captured, cell: str, cap=None) -> list:
    """compare() of every launch of `captured`, in order, each once: the
    identical launch of an earlier path gives that path's result, marked
    `same_launch_as` it. wgl_search's launches are compared a shape at a
    time (`compare_search`, lanes past `cap` steps under it)."""
    keys = [(k.name, launch_digest(launch)) for launch in captured]
    fresh = {key: launch for key, launch in zip(keys, captured)
             if key not in COMPARED}
    if k.engine == "wgl_search":
        groups: dict = {}
        for key, launch in fresh.items():
            groups.setdefault(search_shape(launch), []).append(key)
        for group in groups.values():
            for key, p in zip(group, compare_search(
                    k.mod, [fresh[g] for g in group], k, cap)):
                COMPARED[key] = (cell, p)
    else:
        for key, launch in fresh.items():
            COMPARED[key] = (cell, compare(k, launch))
    out = []
    for key in keys:
        first, p = COMPARED[key]
        out.append(p if first == cell else {**p, "same_launch_as": first})
    return out


# launches of a cell listed one by one in its `per_launch`; a cell with
# more lists its slowest and the range of their bound shares
PER_LAUNCH_LISTED = 16


def replay(kernels, seen, cell: str, cap=None) -> dict:
    """Every launch a path made, replayed through `compare_all` (once for
    identical launches; wgl_search's lanes past `cap` steps compared
    under it). Each kernel the path launched gets a `cells` entry for
    it: the path's launches and their own kernel time, and per replayed
    launch its kernel time, its longest lane's steps and µs a step of
    that lane, its shared memory plan and its bound. The first path that
    launches a kernel also sets that kernel's top-level figures."""
    out = {}
    for k in wgl(kernels):
        launched, path_ms, captured = seen[k.name]
        passes = compare_all(k, captured, cell, cap)
        out[k.name] = passes
        if not passes:
            continue
        b_ms, b_by = bound_ms(sum(p["t_bytes"] for p in passes),
                              sum(p["t_ops"] for p in passes))
        slowest = max(passes, key=lambda p: p["kernel_ms"])
        per_launch = [{
            "kernel_ms": p["kernel_ms"], "lanes": p["lanes"],
            "n_pad": p["n_pad"], "max_lane_steps": p["max_lane_steps"],
            "us_per_step": 1000 * p["kernel_ms"]
            / max(1, p["max_lane_steps"]),
            "smem_bytes": p["smem_bytes"],
            "lanes_per_block": p["lanes_per_block"],
            "smem_tables": p.get("smem_tables"),
            "scratch_bytes": p.get("scratch_bytes"),
            "bound_ms": p["bound_ms"],
            "bound_share": p["bound_ms"] / p["kernel_ms"]}
            for p in passes]
        shares = [p["bound_share"] for p in per_launch]
        k.cells[cell] = {
            "launches": launched, "path_kernel_ms": path_ms,
            "kernel_ms": sum(p["kernel_ms"] for p in passes),
            "plain_ms": sum(p["plain_ms"] or 0.0 for p in passes),
            "max_lane_steps": max(p["max_lane_steps"] for p in passes),
            "us_per_step": 1000 * slowest["kernel_ms"]
            / max(1, slowest["max_lane_steps"]),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_share_range": [min(shares), max(shares)],
            "capped_lanes": sum(p.get("long_lanes", 0) for p in passes),
            "per_launch": sorted(
                per_launch, key=lambda p: -p["kernel_ms"]
            )[:PER_LAUNCH_LISTED] if len(per_launch) > PER_LAUNCH_LISTED
            else per_launch}
        k.widest[cell] = max(captured, key=lambda c: c[0].shape[-1])
        if k.shape is None:
            lanes = sum(p["lanes"] for p in passes)
            k.shape = (f"{lanes} lanes in {len(passes)} launches, n_pad "
                       f"{captured[0][3]}: every search of the {cell} cell")
            k.ms = sum(p["kernel_ms"] for p in passes)
            k.plain_ms = k.cells[cell]["plain_ms"]
            k.bound_ms, k.bound_by = b_ms, b_by
    return out


def main_path(args, kernels, name, n_keys, n_ops, bad_every, host_sample: int,
              bad_read: str = "first", algorithm: str = "gpu_vec",
              expect=("wgl_vec",), bars=None):
    """The port's main path over one keyed history, then every search it
    launched replayed through `compare`. `expect` names the kernels the
    path must launch; the others must not launch. `bars`: every bar of
    "auto" set to it for the path (`card_bars`), else the measured ones."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_host
    from jepsen_tpu_torch.workloads.register import keyed_history

    t0 = time.perf_counter()
    hist = keyed_history(n_keys, n_ops, n_process=5, bad_every=bad_every,
                         bad_read=bad_read, seed=args.seed)
    gen_s = time.perf_counter() - t0
    chk = independent.checker(linearizable(CASRegister(),
                                           algorithm=algorithm))
    lin = lin_module()
    finished0 = lin.NATIVE_FINISH
    with card_bars(bars) if bars is not None else contextlib.nullcontext():
        res, wall, seen = run_path(kernels, lambda: chk.check({}, hist, {}))
    native_finish = lin.NATIVE_FINISH - finished0
    for k in kernels:
        launched = seen[k.name][0]
        if expect is not None:
            assert (launched > 0) == (k.name in expect), (name, k.name,
                                                          launched)
    kernel_ms = sum(v[1] for v in seen.values())

    results = res["results"]
    assert len(results) == n_keys, (len(results), n_keys)
    # planted-bad keys are refuted (a late plant may instead run out of
    # a card engine's budget: unknown; never under "auto", whose native
    # finish takes such lanes); every other key is linearizable
    bad_ok = (False,) if bad_read == "first" or algorithm == "auto" \
        else (False, "unknown")
    for k, r in results.items():
        assert "error" not in r, (k, r.get("error"))
        if bad_every and k % bad_every == 0:
            assert r["valid"] in bad_ok, (k, r["valid"])
            if r["valid"] is False:
                assert r.get("op") and r.get("final_paths") is not None, k
        else:
            assert r["valid"] is True, (k, r["valid"])
    # a sample of keys against the host search (unbounded memo): equal
    # verdicts, and a key the kernel left unknown is one the host refutes
    model = CASRegister()
    step = max(1, n_keys // host_sample)
    sample = sorted({(i * step + i) % n_keys for i in range(host_sample)})
    t1 = time.perf_counter()
    sample_subs = independent._split(hist, sample)
    for k in sample:
        hr = wgl_host.analysis(model, sample_subs[k])
        kv = results[k]["valid"]
        assert hr.valid == (False if kv == "unknown" else kv), (k, hr.valid,
                                                                kv)
    host_s = time.perf_counter() - t1
    steps = sum(r["steps"] for r in results.values())

    passes = replay(kernels, seen, name)
    if algorithm == "auto":
        assert "unknown" not in {r["valid"] for r in results.values()}
    emit({"phase": name, "algorithm": algorithm, "keys": n_keys,
          "bars": bars or "measured", "native_finish": native_finish,
          "invocations_per_key": n_ops,
          "bad_every": bad_every, "bad_read": bad_read,
          "ops": len(hist), "history_gen_s": gen_s, "wall_s": wall,
          "kernel_ms": kernel_ms,
          "launches": {k: v[0] for k, v in seen.items()},
          "device_idle": 1 - kernel_ms / 1000 / wall if wall > 0 else None,
          "total_steps": steps,
          "steps_per_s": steps / wall if wall > 0 else None,
          "kernel_steps_per_s": steps / (kernel_ms / 1000)
          if kernel_ms > 0 else None,
          "verdicts": verdict_counts(r["valid"] for r in results.values()),
          "host_sample": len(sample), "host_sample_s": host_s,
          "kernel_vs_plain": passes, "matches_plain": True})


def phase_mixed(args, kernels):
    """One keyed history of 1024 short keys (64 invocations) and 16 long
    ones (2000): one `check` under "auto" with every bar at 1 (the card
    half of the policy) launches both kernels, and the short keys'
    result dicts equal those of the same keys checked alone through
    gpu_vec. The same check under "auto" with the measured bars is
    recorded beside it, with the same verdicts."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.workloads.register import keyed_history

    n_short, n_long = 1024, 16
    hist = keyed_history(n_short + n_long, [64] * n_short + [2000] * n_long,
                         n_process=5, bad_every=8, seed=args.seed)
    chk = independent.checker(linearizable(CASRegister()))
    with card_bars(1):
        res, wall, seen = run_path(kernels, lambda: chk.check({}, hist, {}))
    assert all((v[0] > 0) == (k in ("wgl_vec", "wgl_row"))
               for k, v in seen.items()), {k: v[0] for k, v in seen.items()}
    results = res["results"]
    for k, r in results.items():
        assert r["valid"] is (k % 8 != 0), (k, r["valid"])
    short = [o for o in hist if o.value.key < n_short]
    alone = independent.checker(linearizable(
        CASRegister(), algorithm="gpu_vec")).check({}, short, {})["results"]
    same = all(results[k] == alone[k] for k in range(n_short))
    assert same, "short keys' results changed beside the long keys"
    passes = replay(kernels, seen, "mixed")
    auto, beside = auto_beside(kernels, "mixed_auto",
                               lambda: chk.check({}, hist, {}))
    assert {k: r["valid"] for k, r in auto["results"].items()} \
        == {k: r["valid"] for k, r in results.items()}
    emit({"phase": "mixed", "bars": "1 (the card half of auto)",
          **beside, "keys": [n_short, n_long],
          "invocations_per_key": [64, 2000], "ops": len(hist),
          "wall_s": wall, "launches": {k: v[0] for k, v in seen.items()},
          "kernel_ms": {k: v[1] for k, v in seen.items()},
          "verdicts": verdict_counts(r["valid"] for r in results.values()),
          "short_keys_equal_alone": same, "kernel_vs_plain": passes,
          "matches_plain": True})


def phase_single(args, kernels):
    """One register history of 3000 invocations (~2500 entries) through
    `linearizable(CASRegister(), algorithm="gpu_row").check`: valid, and
    the host search agrees; beside it the same check under "auto"."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_host
    from jepsen_tpu_torch.workloads.register import register_history

    hist = register_history(n_process=5, n_ops=3000, seed=args.seed)
    chk = linearizable(CASRegister(), algorithm="gpu_row")
    res, wall, seen = run_path(kernels, lambda: chk.check({}, hist, {}))
    launches = {k: v[0] for k, v in seen.items()}
    assert launches == {k.name: int(k.name == "wgl_row") for k in kernels}, \
        launches
    assert res["valid"] is True, res
    assert wgl_host.analysis(CASRegister(), hist).valid is True
    passes = replay(kernels, seen, "single")
    auto, beside = auto_beside(
        kernels, "single_auto",
        lambda: linearizable(CASRegister()).check({}, hist, {}))
    assert auto["valid"] is True, auto
    emit({"phase": "single_history", **beside, "ops": len(hist),
          "wall_s": wall,
          "launches": launches, "kernel_ms": seen["wgl_row"][1],
          "steps": res["steps"], "valid": res["valid"],
          "kernel_vs_plain": passes, "matches_plain": True})


def phase_search_vs_plain(args, kernel):
    """wgl_search == plain on the card, bit for bit on verdict, steps and
    depth: all five models, n_pad from 8 to 32768 (a 4-invocation batch,
    lanes of ~4,600, ~9,000 and ~20,900 entries), an unordered-queue lane
    past 1024 entries, fifo lanes whose rings are past 64 (n_state 256 to
    1024), planted and corrupt reads, a memo of 8 slots and a lane cut by
    its step budget. Each batch goes through `wgl_search.analysis_batch`;
    every search it launched is replayed through `compare`."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.workloads.queue import mutex_history, queue_history
    from jepsen_tpu_torch.workloads.register import register_history

    ws = kernel.mod
    s = args.seed * 7919 + 9000

    def reg(n, i, **kw):
        return register_history(n_process=5, n_ops=n, seed=s + i, **kw)

    def q(n, i, **kw):
        return queue_history(n_process=5, n_ops=n, seed=s + i, **kw)

    batches = [
        ("cas-register", models.CASRegister, 20_000, 13,
         [reg(64, i, corrupt=0.2) for i in range(64)]),
        ("cas-register-n8", models.CASRegister, 20_000, 13,
         [reg(2, 100 + i, corrupt=0.3) for i in range(32)]),
        ("cas-register-memo8", models.CASRegister, 20_000, 3,
         [reg(64, 150 + i, corrupt=0.2) for i in range(32)]),
        ("register", models.Register, 20_000, 13,
         [reg(64, 200 + i, cas=False, corrupt=0.1 if i % 4 else 0.0)
          for i in range(32)]),
        ("mutex", models.Mutex, 20_000, 13,
         [mutex_history(n_process=5, n_ops=48, seed=s + 300 + i,
                        corrupt=0.1 if i % 4 == 0 else 0.0)
          for i in range(32)]),
        ("unordered-queue", models.UnorderedQueue, 20_000, 13,
         [q(40, 400 + i, corrupt=0.1 if i % 4 == 0 else 0.0)
          for i in range(32)]),
        # one lane of ~1150 entries: past wgl_vec's 1024
        ("unordered-queue-long", models.UnorderedQueue, 20_000, 13,
         [q(1200, 500, n_values=300), q(300, 501, n_values=50)]),
        ("fifo-queue", models.FIFOQueue, 20_000, 13,
         [q(24, 600 + i, fifo=True, corrupt=0.1 if i % 4 == 0 else 0.0)
          for i in range(32)]),
        # 70-1000 enqueues a lane: rings past wgl_vec's 64
        ("fifo-queue-ring", models.FIFOQueue, 20_000, 13,
         [q(n, 700 + i, fifo=True)
          for i, n in enumerate((150, 300, 600, 1980))]),
        ("cas-register-n8192", models.CASRegister, 4_000_000, 13,
         [reg(5600, 800), planted(reg(5600, 801))]),
        ("register-n16384", models.Register, 4_000_000, 13,
         [reg(11000, 802, cas=False)]),
        ("cas-register-n32768", models.CASRegister, 4_000_000, 13,
         [register_history(n_process=10, n_ops=25000, seed=s + 803)]),
        # a long valid lane under a budget it cannot finish in: unknown
        ("cas-register-cut", models.CASRegister, 500, 13, [reg(2000, 804)]),
    ]
    for name, model, max_steps, cache_bits, hists in batches:
        ws.CAPTURE = []
        results = ws.analysis_batch(model(), hists, max_steps=max_steps,
                                    cache_bits=cache_bits, device="cuda")
        launches, ws.CAPTURE = ws.CAPTURE, None
        passes = [compare(kernel, launch) for launch in launches]
        counts = verdict_counts(r.valid for r in results)
        if name == "cas-register-cut":
            assert counts["unknown"] == 1, counts
        if name.startswith("cas-register-n"):
            assert results[0].valid is True, (name, counts)
        emit({"phase": "search_vs_plain", "model": name,
              "max_steps": max_steps, "cache_bits": cache_bits,
              "history_ops": [len(h) for h in hists][:8],
              "n_pad": launches[0][3], "n_state": launches[0][4],
              "passes": passes, "matches_plain": True, "verdicts": counts})


def phase_search_tiers(args, kernel):
    """wgl_search == plain on the card at every tier of its shared-memory
    plan: small seeded lanes of all five models packed at the n_pads on
    each side of each tier boundary (`search_tier_pads`), at cache_bits
    13 and 3, and at 17 (the fingerprints in device memory); fifo lanes whose states share bitsets and counts but differ
    in their live windows; and a plan past the device's shared-memory
    limit, which must raise KernelError."""
    import torch

    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.device import KernelError
    from jepsen_tpu_torch.history import entries
    from jepsen_tpu_torch.models import jit as mjit
    from jepsen_tpu_torch.workloads.queue import mutex_history, queue_history
    from jepsen_tpu_torch.workloads.register import register_history

    ws = kernel.mod
    s = args.seed * 7919 + 9000

    def reg(n, i, **kw):
        return register_history(n_process=4, n_ops=n, seed=s + i, **kw)

    def q(n, i, n_process=4, **kw):
        return queue_history(n_process=n_process, n_ops=n, seed=s + i, **kw)

    for name, model in (("cas-register", models.CASRegister),
                        ("register", models.Register),
                        ("mutex", models.Mutex),
                        ("unordered-queue", models.UnorderedQueue),
                        ("fifo-queue", models.FIFOQueue)):
        jm = mjit.for_model(model())
        hists = [q(20, 900 + i, fifo=name == "fifo-queue",
                   corrupt=0.2 if i % 2 else 0.0)
                 if name.endswith("queue") else
                 mutex_history(n_process=4, n_ops=20, seed=s + 900 + i,
                               corrupt=0.2 if i % 2 else 0.0)
                 if name == "mutex" else
                 reg(20, 900 + i, cas=name == "cas-register",
                     corrupt=0.2 if i % 2 else 0.0) for i in range(4)]
        ess = [entries(h) for h in hists]
        n_state = ws.state_width(jm, ess)
        least = ws.pad_size(max(len(es) for es in ess))
        for cache_bits in (13, 3, 17):
            rows = []
            pads = search_tier_pads(ws, jm, n_state, cache_bits, least)
            if cache_bits == 17:
                # the fingerprints (256 KB) in device memory; 2^17 key
                # rows a lane, so up to n_pad 8192 (0.5 GB of rows for
                # the four lanes, in the kernel and the plain version)
                pads = [n for n in pads if n <= 8192]
            for n_pad in pads:
                packed = torch.from_numpy(ws._pack(ess, jm, n_pad)).cuda()
                msteps = torch.full((len(ess),), 20_000, dtype=torch.int32,
                                    device="cuda")
                rows.append(compare(kernel, (packed, msteps, jm, n_pad,
                                             n_state, cache_bits)))
            emit({"phase": "search_tiers", "model": name,
                  "cache_bits": cache_bits, "n_state": n_state,
                  "passes": rows, "matches_plain": True})

    # fifo lanes with many concurrent enqueues: states whose bitsets and
    # counts agree but whose live windows differ, at a memo of 8192 and of
    # 8 slots (partial key rows written over stale ones)
    hists = [q(60, 950 + i, fifo=True, n_process=8) for i in range(8)]
    for cache_bits in (13, 3):
        ws.CAPTURE = []
        ws.analysis_batch(models.FIFOQueue(), hists, max_steps=20_000,
                          cache_bits=cache_bits, device="cuda")
        launches, ws.CAPTURE = ws.CAPTURE, None
        emit({"phase": "search_vs_plain", "model": "fifo-queue-windows",
              "cache_bits": cache_bits,
              "passes": [compare(kernel, launch) for launch in launches],
              "matches_plain": True})

    # a launch the device cannot take raises: a plan for 1 MiB of shared
    # memory a block (n_pad 16384: every table of a lane, ~510 KB), past
    # the opt-in limit
    jm = mjit.for_model(models.CASRegister())
    packed = torch.from_numpy(ws._pack([entries(reg(20, 990))], jm,
                                       16384)).cuda()
    msteps = torch.full((1,), 20_000, dtype=torch.int32, device="cuda")
    saved = ws._smem_max
    ws._smem_max = lambda dev: 1 << 20
    try:
        ws.search(packed, msteps, jm, 16384, 1)
    except KernelError as e:
        refused = str(e)
    else:
        raise AssertionError("a plan past the shared-memory limit launched")
    finally:
        ws._smem_max = saved
    emit({"phase": "search_refuses", "error": refused})


def search_tier_pads(ws, jm, n_state: int, cache_bits: int,
                     least: int = 8) -> list:
    """The power-of-two n_pads from `least` to 65536 on each side of
    every boundary between the plan's tiers (a tier: the n_pads whose
    plan puts the same tables in shared memory), and the first and
    last."""
    pads = [1 << k for k in range(least.bit_length() - 1, 17)]
    tiers = [ws._smem_plan(jm, n, n_state, cache_bits).smem for n in pads]
    keep = {pads[0], pads[-1]}
    for i in range(1, len(pads)):
        if tiers[i] != tiers[i - 1]:
            keep |= {pads[i - 1], pads[i]}
    return sorted(keep)


def search_cell(kernels, name, chk, hist):
    """`chk.check({}, hist, {})` as a main path that must launch
    wgl_search once and nothing else; every launch replayed through
    `compare`. Returns the result, the wall and the replayed passes."""
    res, wall, seen = run_path(kernels, lambda: chk.check({}, hist, {}))
    launches = {k: v[0] for k, v in seen.items()}
    assert launches == {k.name: int(k.name == "wgl_search")
                        for k in kernels}, (name, launches)
    passes = replay(kernels, seen, name)
    return res, wall, seen, passes


def search_line(name, kernels, seen, passes, wall, **fields) -> dict:
    """The printed line of a wgl_search cell: wall, kernel ms, steps and
    µs a step of its longest lane, scratch bytes, device idle."""
    k = next(k for k in kernels if k.name == "wgl_search")
    cell = k.cells[name]
    kms = cell["kernel_ms"]
    return {"phase": name, **fields, "wall_s": wall,
            "launches": {n: v[0] for n, v in seen.items() if v[0]},
            "kernel_ms": kms, "path_kernel_ms": seen["wgl_search"][1],
            "max_lane_steps": cell["max_lane_steps"],
            "us_per_step": cell["us_per_step"],
            "scratch_bytes": sum(p["scratch_bytes"] for p in
                                 passes["wgl_search"]),
            "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
            "device_idle": 1 - kms / 1000 / wall,
            "kernel_vs_plain": passes, "matches_plain": True}


# the JAX package's stress-50k budget (bench.py: max_steps 4,000,000),
# given to the checker as the time limit that buys that many steps
STRESS_MAX_STEPS = 4_000_000


def phase_main_stress(args, kernels):
    """BASELINE config 5 (bench.py stress-50k): one CAS-register history
    of 10 clients and 25,000 invocations (~50,000 ops, ~20,900 entries,
    n_pad 32768) through `linearizable(CASRegister(),
    algorithm="gpu_search").check`, budget 4,000,000 steps: one
    wgl_search launch and nothing else, the host search's verdict; then
    the same history with one impossible read planted at its first read:
    invalid, with the host search's op. Beside each, the same check under
    "auto"."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_host
    from jepsen_tpu_torch.ops.common import STEPS_PER_SEC_ESTIMATE
    from jepsen_tpu_torch.workloads.register import register_history

    t0 = time.perf_counter()
    hist = register_history(n_process=10, n_ops=25000, seed=args.seed)
    gen_s = time.perf_counter() - t0
    limit = STRESS_MAX_STEPS / STEPS_PER_SEC_ESTIMATE
    chk = linearizable(CASRegister(), algorithm="gpu_search",
                       time_limit=limit)
    assert chk._max_steps() == STRESS_MAX_STEPS
    for name, h in (("main_stress_50k", hist),
                    ("main_stress_50k_planted", planted(hist))):
        res, wall, seen, passes = search_cell(kernels, name, chk, h)
        auto, beside = auto_beside(
            kernels, f"{name}_auto",
            lambda: linearizable(CASRegister(), time_limit=limit).check(
                {}, h, {}))
        assert auto["valid"] == res["valid"], (name, auto["valid"])
        t1 = time.perf_counter()
        hr = wgl_host.analysis(CASRegister(), h)
        host_s = time.perf_counter() - t1
        assert res["valid"] == hr.valid, (name, res["valid"], hr.valid)
        if name.endswith("planted"):
            assert res["valid"] is False
            assert res["op"] == hr.op.to_dict(), (res["op"], hr.op)
        emit(search_line(name, kernels, seen, passes, wall, **beside,
                         ops=len(h), history_gen_s=gen_s,
                         valid=res["valid"],
                         steps=res["steps"], op=res.get("op"),
                         host_valid=hr.valid, host_steps=hr.steps,
                         host_s=host_s))


def phase_main_single_10k(args, kernels):
    """BASELINE.md's north-star history as ONE history: a CAS register,
    5 clients, 6,000 invocations (~5,000 entries, n_pad 8192) through
    `linearizable(CASRegister(), algorithm="gpu_search").check`: one
    wgl_search launch, the host search's verdict; beside it, "auto"."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_host
    from jepsen_tpu_torch.workloads.register import register_history

    hist = register_history(n_process=5, n_ops=6000, seed=args.seed)
    name = "main_single_10k"
    res, wall, seen, passes = search_cell(
        kernels, name, linearizable(CASRegister(), algorithm="gpu_search"),
        hist)
    auto, beside = auto_beside(
        kernels, f"{name}_auto",
        lambda: linearizable(CASRegister()).check({}, hist, {}))
    assert auto["valid"] == res["valid"], auto
    t1 = time.perf_counter()
    hr = wgl_host.analysis(CASRegister(), hist)
    host_s = time.perf_counter() - t1
    assert res["valid"] == hr.valid, (res["valid"], hr.valid)
    emit(search_line(name, kernels, seen, passes, wall, **beside,
                     ops=len(hist), valid=res["valid"], steps=res["steps"],
                     host_valid=hr.valid, host_s=host_s))


# queue_history(n_process=5, n_ops=1980, fifo=True) seeds (at --seed 0):
# the first 16 whose lane keeps n_state at 1024 (at most 1022 enqueues)
# and whose host search ends within 100,000 steps; 1,912-1,980 entries a
# key. Every such history is invalid: a crashed dequeue's value stays at
# the front of the queue.
FIFO_SEEDS = (0, 1, 3, 4, 5, 6, 7, 8, 9, 10, 11, 14, 15, 16, 17, 18)


def phase_main_fifo_long(args, kernels):
    """`independent.checker(linearizable(FIFOQueue(),
    algorithm="gpu_search"))` over 16 keys of ~1,900-2,000 entries (n_pad
    2048, past wgl_vec's 1024; rings of ~1,000 slots, n_state 1024): the
    whole batch in one wgl_search launch, every key's verdict the host
    search's; beside it, "auto"."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import entries
    from jepsen_tpu_torch.models import FIFOQueue
    from jepsen_tpu_torch.ops import wgl_host
    from jepsen_tpu_torch.workloads.queue import queue_history
    from jepsen_tpu_torch.workloads.register import interleave_keys

    per_key = [queue_history(n_process=5, n_ops=1980, fifo=True,
                             seed=1000 * args.seed + s) for s in FIFO_SEEDS]
    hist = interleave_keys(per_key, 5)
    name = "main_fifo_long"
    chk = independent.checker(linearizable(FIFOQueue(),
                                           algorithm="gpu_search"))
    res, wall, seen, passes = search_cell(kernels, name, chk, hist)
    results = res["results"]
    auto, beside = auto_beside(
        kernels, f"{name}_auto",
        lambda: independent.checker(linearizable(FIFOQueue())).check(
            {}, hist, {}))
    assert {k: r["valid"] for k, r in auto["results"].items()} \
        == {k: r["valid"] for k, r in results.items()}
    t1 = time.perf_counter()
    subs = independent._split(hist, list(range(len(per_key))))
    sizes = []
    for k in range(len(per_key)):
        es = entries(subs[k])
        sizes.append(len(es))
        hr = wgl_host.analysis(FIFOQueue(), es)
        assert results[k]["valid"] == hr.valid, (k, results[k]["valid"],
                                                  hr.valid)
        if hr.valid is False:
            assert results[k]["op"] == hr.op.to_dict(), k
    host_s = time.perf_counter() - t1
    emit(search_line(name, kernels, seen, passes, wall, **beside,
                     keys=len(per_key),
                     ops=len(hist), entries_per_key=sizes,
                     n_state=passes["wgl_search"][0]["n_state"],
                     verdicts=verdict_counts(r["valid"]
                                             for r in results.values()),
                     host_sample=len(per_key), host_s=host_s))


def phase_main_queue_pcomp(args, kernels):
    """BASELINE config 4 as ONE history (bench.py queue-10k-single-pcomp):
    an unordered queue, 5 clients, 5,000 invocations over 2,000 values,
    through `linearizable(UnorderedQueue()).check` under "auto" with every
    bar at 1 (the card half of the policy): split by value into
    micro-lanes, every one routed to wgl_vec (none to the host), valid.
    Beside it, the same check with the measured bars."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import entries
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.ops import pcomp
    from jepsen_tpu_torch.workloads.queue import queue_history

    hist = queue_history(n_process=5, n_ops=5000, n_values=2000,
                         seed=args.seed)
    chk = linearizable(UnorderedQueue())
    lanes = pcomp.split(UnorderedQueue(), entries(hist))
    routes = chk._route(UnorderedQueue(), [es for _, es in lanes])
    assert set(routes) == {"gpu_vec"}, set(routes)
    with card_bars(1):
        res, wall, seen = run_path(kernels, lambda: chk.check({}, hist, {}))
    launches = {k: v[0] for k, v in seen.items()}
    assert all((n > 0) == (k == "wgl_vec") for k, n in launches.items()), \
        launches
    assert res["valid"] is True, res
    captured = seen["wgl_vec"][2]
    real = int(((captured[0][0][-1] & 0xFFFF) > 0).sum())
    assert real == sum(len(es) > 0 for _, es in lanes), (real, len(lanes))
    passes = replay(kernels, seen, "main_queue_pcomp")
    auto, beside = auto_beside(kernels, "main_queue_pcomp_auto",
                               lambda: chk.check({}, hist, {}))
    assert auto["valid"] is True, auto
    kms = seen["wgl_vec"][1]
    emit({"phase": "main_queue_pcomp", "bars": "1 (the card half of auto)",
          **beside, "ops": len(hist),
          "micro_lanes": len(lanes),
          "longest_lane": max(len(es) for _, es in lanes),
          "routes": {r: routes.count(r) for r in set(routes)},
          "wall_s": wall, "launches": launches, "kernel_ms": kms,
          "device_idle": 1 - kms / 1000 / wall, "valid": res["valid"],
          "steps": res["steps"], "kernel_vs_plain": passes,
          "matches_plain": True})


def phase_lanes_per_block(kernel) -> None:
    """K1 at every lanes-a-block count of SWEEP_LANES that fits, beside
    its plan's, on the widest launch of the register and widest cells
    and on the register launch tiled to four times its width. Each
    result must equal the plan's bit for bit (the plan's equals the plain
    version's: `replay`; the tiled one equals the register launch's,
    tiled). Each launch also runs at a step budget of 0 (`cap0_ms`: the
    decode of its lanes and the write of its outputs, no step), equal to
    the plain version's."""
    import torch

    wv = kernel.mod
    reg = kernel.widest["main_register"]
    tiled = (torch.cat([reg[0]] * 4, 1).contiguous(),
             torch.cat([reg[1]] * 4).contiguous(), *reg[2:])
    rows = []
    for cell, launch in (("main_register", reg), ("main_register x4", tiled),
                         ("main_widest", kernel.widest["main_widest"])):
        packed, msteps, jm, n_pad, n_state, slots = launch
        plan = wv.launch_plan(packed, jm, n_pad, n_state, slots)
        fit = wv.launch_plan(packed, jm, n_pad, n_state, slots, wv.WARP)
        plan_ms, (small0, best0) = kernel_ms(wv, lambda: wv.search(*launch))
        cap0 = (packed, torch.zeros_like(msteps), jm, n_pad, n_state, slots)
        cap0_ms, (small, best) = kernel_ms(wv, lambda: wv.search(*cap0))
        small_p, best_p = wv.search_plain(*cap0)
        check_equal(kernel, f"{jm.name} at step budget 0", small, small_p,
                    best, best_p)
        if cell == "main_register":
            reg_out = small0, best0
        elif cell == "main_register x4":
            check_equal(kernel, "tiled", small0,
                        torch.cat([reg_out[0]] * 4, 1), best0,
                        torch.cat([reg_out[1]] * 4, 1))
        ms = {}
        for lanes in SWEEP_LANES:
            if lanes > fit.lanes:
                break
            ms[lanes], (small, best) = kernel_ms(
                wv, lambda: wv.search(*launch, lanes=lanes))
            check_equal(kernel, f"{jm.name} at {lanes} lanes a block",
                        small, small0, best, best0)
        rows.append({"cell": cell, "width": packed.shape[1], "n_pad": n_pad,
                     "max_lane_steps": int(small0[1].max()),
                     "plan_lanes": plan.lanes, "plan_ms": plan_ms,
                     "cap0_ms": cap0_ms,
                     "fit_lanes": fit.lanes, "ms_by_lanes": ms})
    kernel.lanes_sweep = rows
    emit({"phase": "lanes_per_block", "kernel": kernel.name,
          "launches": rows, "matches_plan": True})


class ClosureKernel(Kernel):
    """One closure kernel (or, with `library`, the product): the three
    share closure.py's hooks, LAUNCHES keyed by name."""

    def __init__(self, name, mod, replaces, library=False):
        super().__init__(name, mod, replaces)
        self.library = library

    def reset(self) -> None:
        for name in self.mod.LAUNCHES:
            self.mod.LAUNCHES[name] = 0
        self.mod.TIMED, self.mod.CAPTURE = [], []

    def collect(self) -> tuple:
        return (self.mod.LAUNCHES[self.name],
                sum(a.elapsed_time(b) for n, a, b in self.mod.TIMED
                    if n == self.name),
                self.mod.CAPTURE)


# GPU clock cycles the card spins (torch.cuda._sleep) before each timed
# closure or sim launch, ~2 ms: longer than the host takes to submit the
# launch, so the start event runs once it is queued and the events time
# the kernel, not the host's call into it (a wrapper call, its library
# lookup included, is tens of µs of host time: see `lookup_us`)
SPIN_CYCLES = 4_000_000


# timed launches of each closure or sim kernel (the median is kept)
SPIN_REPS = 5


def spin_ms(mod, fn, name: str | None = None, reps: int = SPIN_REPS):
    """Median ms of a kernel (its wrapper's events in `mod.TIMED`, of
    kernel `name` where the module has several, each launch queued
    behind a SPIN_CYCLES spin) over `reps` calls of fn() after one
    warm-up, and the last call's result."""
    import torch

    fn()
    mod.TIMED = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        out = fn()
    torch.cuda.synchronize()
    times = sorted(t[-2].elapsed_time(t[-1]) for t in mod.TIMED
                   if name is None or t[0] == name)
    mod.TIMED = None
    return times[len(times) // 2], out


def held(kernel, name, got, want) -> None:
    """Fold a kernel-vs-plain comparison of tensors into the kernel's
    max_abs_err; raise unless they are equal bit for bit."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.bfloat16:
            d = (g.float() - w.float()).abs()
        else:
            d = (g.long() - w.long()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
        if g.dtype != w.dtype or not torch.equal(g, w):
            err = max(err, 1.0)
    kernel.max_abs_err = max(kernel.max_abs_err, err)
    kernel.compared += 1
    if err:
        raise AssertionError(f"{kernel.name} {name}: kernel != plain "
                             f"(max abs err {err})")


def replay_closure(ck, captured) -> list:
    """Every bucket fixpoint a run captured (closure.CAPTURE), replayed
    through the kernels and their plain versions on the card as the
    fixpoint runs it: unpack once (its operand against unpack_plain),
    then round by round the product and the threshold pass refreshing
    the operand (its words, flag and operand against the plain version's
    on the same inputs, and the operand against unpack_plain of the new
    words), closure_word (its words and each matrix's rounds) against
    closure_word_plain, and closure_word's floor: its launch on the
    bucket's first matrix alone for one round (`floor_ms`). Raises on
    any difference. Returns per bucket: pad size, batch, rounds, and per
    kernel and the product the median ms of its launches summed over
    the bucket, the plain version's ms and the bound (bytes read and
    written once over HBM bandwidth; the product's 2*b*p^3 operations
    over the bf16 peak; closure_word's rounds x 32 x 32 x 2 int32
    operations a matrix over the int32 rate); and `per_launch`: unpack's
    launch and each round's threshold pass with its ms, bound, share of
    the bound and the bytes of the words that gained bits (the bound
    counts 16 operand bytes each)."""
    import torch

    cl = ck["unpack"].mod
    out = []
    for words0, p, rounds in captured:
        b = words0.shape[0]
        n_words = words0.numel()
        bucket = {"p": p, "b": b, "round_cap": rounds}
        if p == cl.MIN_PAD:
            w = words0.view(-1, 32)
            k_ms, (kw, kt) = spin_ms(
                cl, lambda: cl.closure_word(w, rounds), "closure_word")
            p_ms, (pw, pt) = cuda_ms(lambda: cl.closure_word_plain(w, rounds))
            held(ck["closure_word"], f"p {p}", (kw, kt), (pw, pt))
            one = w[:1].clone()
            f_ms, got = spin_ms(cl, lambda: cl.closure_word(one, 1),
                                "closure_word")
            held(ck["closure_word"], f"p {p} floor", got,
                 cl.closure_word_plain(one, 1))
            t_b = (8 * n_words + 4 * b) / HBM_BYTES_PER_S
            t_o = int(kt.sum()) * 32 * 32 * 2 / INT32_OPS_PER_S
            b_ms, b_by = bound_ms(t_b, t_o)
            bucket.update(rounds=int(kt.max()), closure_word={
                "launches": 1, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "floor_ms": f_ms})
            out.append(bucket)
            continue
        dev = words0.device
        figs = {name: {"launches": 0, "ms": 0.0, "plain_ms": 0.0,
                       "t_bytes": 0.0, "t_ops": 0.0}
                for name in ("unpack", "matmul", "or_threshold_pack")}

        def add(name, ms, plain, t_b, t_o=0.0):
            f = figs[name]
            f["launches"] += 1
            f["ms"] += ms
            f["plain_ms"] += plain
            f["t_bytes"] += t_b
            f["t_ops"] += t_o
            return 1000 * t_b

        words = words0.clone()
        u_ms, m = spin_ms(cl, lambda: cl.unpack(words, p), "unpack")
        up_ms, m_p = cuda_ms(lambda: cl.unpack_plain(words, p))
        held(ck["unpack"], f"p {p}", (m,), (m_p,))
        u_bytes = 4 * n_words + 2 * m.numel()
        u_bound = add("unpack", u_ms, up_ms, u_bytes / HBM_BYTES_PER_S)
        per_launch = {"shape": [b, p, p], "unpack": {
            "ms": u_ms, "bound_ms": u_bound, "share": u_bound / u_ms},
            "or_threshold_pack": []}
        ran = rounds
        for t in range(rounds):
            mm_ms, prod = spin_ms(cl, lambda: cl.matmul(m), "matmul")
            add("matmul", mm_ms, 0.0, 4 * m.numel() / HBM_BYTES_PER_S,
                2.0 * b * p ** 3 / BF16_FLOPS_PER_S)

            def otp(fn, operand):
                flag = torch.zeros(1, dtype=torch.int32, device=dev)
                return fn(prod, words, flag, operand=operand), flag

            op_p = m.clone()
            op_ms, (new_p, flag_p) = cuda_ms(
                lambda: otp(cl.or_threshold_pack_plain, op_p))
            # the pass rewrites the operand only where the words gained
            # bits, the same chunks with the same values every launch
            o_ms, (new, flag) = spin_ms(
                cl, lambda: otp(cl.or_threshold_pack, m), "or_threshold_pack")
            held(ck["or_threshold_pack"], f"p {p} round {t}",
                 (new, flag, m), (new_p, flag_p, op_p))
            held(ck["or_threshold_pack"], f"p {p} round {t} operand",
                 (m,), (cl.unpack_plain(new, p),))
            gained = int((words.view(torch.uint8)
                          != new.view(torch.uint8)).sum())
            o_bound = add("or_threshold_pack", o_ms, op_ms,
                          (2 * prod.numel() + 8 * n_words + 4 + 16 * gained)
                          / HBM_BYTES_PER_S)
            per_launch["or_threshold_pack"].append({
                "round": t, "ms": o_ms, "bound_ms": o_bound,
                "share": o_bound / o_ms, "gained_bytes": gained})
            words = new
            if not int(flag.item()):
                ran = t + 1
                break
        final, ran_p = cl.closure_block_plain(words0, p)
        held(ck["or_threshold_pack"], f"p {p} fixpoint", (words,), (final,))
        assert ran == ran_p, (ran, ran_p)
        bucket["rounds"] = ran
        figs["matmul"]["plain_ms"] = None  # no plain version: it is one
        for name, f in figs.items():
            b_ms, b_by = bound_ms(f.pop("t_bytes"), f.pop("t_ops"))
            bucket[name] = {**f, "bound_ms": b_ms, "bound_by": b_by}
        bucket["per_launch"] = per_launch
        out.append(bucket)
    return out


def closure_cell(ck, cell, seen, buckets) -> None:
    """Fold one main-path cell's closure launches into the kernels'
    rows: per kernel its launches and path ms in the run, and per bucket
    the replayed figures. The first cell that launches a kernel sets its
    top-level ms, plain ms and bound (sums over the cell's launches; the
    bound's kind is that of its largest bucket). The run's launches must
    be the fixpoint's: closure_word one a bucket of p 32, unpack one a
    bucket of p > 32, the product and or_threshold_pack one a round."""
    for k in ck.values():
        launched, path_ms, _ = seen[k.name]
        rows = [dict(bk[k.name], p=bk["p"], b=bk["b"], rounds=bk["rounds"])
                for bk in buckets if k.name in bk]
        want = sum(1 if k.name in ("closure_word", "unpack") else r["rounds"]
                   for r in rows)
        assert launched == want, (cell, k.name, launched, want)
        if not launched:
            continue
        k.cells[cell] = {"launches": launched, "path_kernel_ms": path_ms,
                         "kernel_ms": sum(r["ms"] for r in rows),
                         "bound_ms": sum(r["bound_ms"] for r in rows),
                         "buckets": rows}
        if k.ms is None:
            k.ms = sum(r["ms"] for r in rows)
            k.plain_ms = None if k.library \
                else sum(r["plain_ms"] for r in rows)
            k.bound_ms = sum(r["bound_ms"] for r in rows)
            k.bound_by = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
            k.shape = (f"{cell}: " + ", ".join(
                f"{r['launches']} x [{r['b']}, {r['p']}, {r['p']}]"
                for r in rows))


def digraph(n: int, seed: int, avg_deg: float = 4.0):
    """A seeded random digraph of average out-degree `avg_deg`, no
    self-loops (the JAX package's bench: bench.py cycle_closure)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < (avg_deg / n)
    np.fill_diagonal(a, False)
    return a


def phase_closure_vs_plain(args, ck) -> None:
    """closure.reach_batch on the card against reach_batch_plain on the
    card, bit for bit, and against the host DFS up to 1000 nodes: seeded
    digraphs of 7 to 10,000 nodes (every pad bucket from 32 to 16,384),
    one batch of 4096 matrices of 2-32 nodes (the one-word bucket), and
    a complete 600-node digraph (path counts past 256, rounded in bf16).
    Every bucket fixpoint is replayed through `replay_closure`."""
    import numpy as np

    from jepsen_tpu_torch.ops import closure_host

    cl = ck["unpack"].mod
    s = args.seed
    rng = np.random.default_rng(s)
    full = np.ones((600, 600), dtype=bool)
    np.fill_diagonal(full, False)
    cases = [(f"n{n}", [digraph(n, s * 7919 + n)])
             for n in (7, 32, 33, 100, 1000, 2500, 10000)]
    cases.append(("word_batch", [digraph(int(rng.integers(2, 33)),
                                         s * 7919 + 20000 + i)
                                 for i in range(4096)]))
    cases.append(("complete600", [full]))
    for name, mats in cases:
        cl.CAPTURE = []
        t0 = time.perf_counter()
        got = cl.reach_batch(mats, device="cuda")
        wall = time.perf_counter() - t0
        captured, cl.CAPTURE = cl.CAPTURE, None
        plain = cl.reach_batch_plain(mats, device="cuda")
        assert all(np.array_equal(g, q) for g, q in zip(got, plain)), name
        host = None
        if max(m.shape[0] for m in mats) <= 1000:
            host = all(np.array_equal(g, closure_host.reach(m))
                       for g, m in zip(got, mats))
            assert host, name
        if name == "complete600":
            assert got[0].all()
        buckets = replay_closure(ck, captured)
        emit({"phase": "closure_vs_plain", "case": name,
              "n": [m.shape[0] for m in mats[:4]], "matrices": len(mats),
              "wall_s": wall, "buckets": buckets,
              "cyclic_nodes": int(sum(np.diagonal(g).sum() for g in got)),
              "matches_plain": True, "matches_host": host})


def normalise(d):
    """A result dict as JSON carries it, ops by `to_dict`."""
    return json.loads(json.dumps(
        d, default=lambda o: o.to_dict() if hasattr(o, "to_dict") else str(o)))


# cycle cell -> the bucket fixpoints its run captured (closure.CAPTURE),
# which the mesh phase deals over several devices
CYCLE_CAPTURE: dict = {}


def phase_cycles(args, kernels, ck) -> None:
    """The cycle checker's three cells."""
    # the JAX package's list-append-5k bench history (bench.py:836): 2505
    # txns, one component of 2496 and two of 2-3 (the injections)
    phase_cycle(args, kernels, ck, "cycle_append", 5000, host=True)
    # 10,005 txns: the giant component in the pad-16384 bucket
    phase_cycle(args, kernels, ck, "cycle_append_20k", 20000)
    # strict serializability: realtime edges join every txn into one
    # component, so the one-word bucket is not launched
    phase_cycle(args, kernels, ck, "cycle_append_rt", 5000, realtime=True,
                components=1,
                expect=("unpack", "or_threshold_pack", "matmul"))


def phase_cycle(args, kernels, ck, name, n_ops, realtime=False,
                host=False, components=3,
                expect=("closure_word", "unpack", "or_threshold_pack",
                        "matmul")):
    """The port's cycle checker on one list-append history of `n_ops`
    ops (`list_append.simulate`, G1c and G-single injected) on the card
    through `cycle.checker(realtime=...).check`: the main path, with
    every count set to 0 just before and read just after. Checks the
    verdict (invalid, exactly G1c and G-single, `components` components)
    and, with `host`, that the whole dict equals the host DFS engine's.
    Every captured bucket fixpoint is replayed through `replay_closure`.
    Prints the wall split into extract, components, closure and hits +
    witnesses (anomalies.PHASES), kernel and product ms, launches,
    rounds per bucket and the device's idle share."""
    from jepsen_tpu_torch.checker import cycle
    from jepsen_tpu_torch.checker.cycle import anomalies
    from jepsen_tpu_torch.workloads import list_append

    t0 = time.perf_counter()
    hist = list_append.simulate(n_ops, seed=args.seed,
                                inject=("G1c", "G-single"))
    gen_s = time.perf_counter() - t0
    chk = cycle.checker(realtime=realtime)
    anomalies.PHASES = {}
    try:
        res, wall, seen = run_path(kernels,
                                   lambda: chk.check({}, hist, {}))
        split = anomalies.PHASES
    finally:
        anomalies.PHASES = None
    launches = {k: v[0] for k, v in seen.items()}
    for k in kernels:
        assert (launches[k.name] > 0) == (k.name in expect), (name, launches)
    assert res["valid"] is False, res["valid"]
    assert res["anomaly-types"] == ["G1c", "G-single"], res["anomaly-types"]
    if components is not None:
        assert res["component-count"] == components, res["component-count"]
    host_s = None
    if host:
        t1 = time.perf_counter()
        hr = cycle.checker(realtime=realtime, engine="host").check(
            {}, hist, {})
        host_s = time.perf_counter() - t1
        assert normalise(res) == normalise(hr), "card != host DFS"
    CYCLE_CAPTURE[name] = seen["unpack"][2]
    buckets = replay_closure(ck, seen["unpack"][2])
    closure_cell(ck, name, seen, buckets)
    # the run's own events also hold the host's call into each launch;
    # the device's share is that of the replayed launches (the same
    # launches, each timed alone)
    path_ms = {k: v[1] for k, v in seen.items() if v[0]}
    ms = {k: sum(bk[k]["ms"] for bk in buckets if k in bk) for k in path_ms}
    emit({"phase": name, "ops": len(hist), "realtime": realtime,
          "txns": res["node-count"], "components": res["component-count"],
          "history_gen_s": gen_s, "wall_s": wall, "split_s": split,
          "launches": launches, "kernel_ms": ms, "path_kernel_ms": path_ms,
          "device_idle": 1 - sum(ms.values()) / 1000 / wall,
          "buckets": buckets, "anomaly-types": res["anomaly-types"],
          "cycle-count": res["cycle-count"], "host_equal": host or None,
          "host_s": host_s, "matches_plain": True})


# -- the "auto" policy: crossover bars and whole-corpus parity ----------

# lanes of K2's scalar crossover batch: main_single_10k-sized histories
CROSSOVER_K2_LANES = 16
# seeds of the queue crossover pools (each pool keeps its hard lanes) and
# timed runs of each engine call (the median is kept): the measurement of
# `--only crossover`, whose bars GPU_BATCH_MIN holds (the median of three
# runs), and the shallower pass of the whole smoke run, which prints its
# bars beside the constants
CROSSOVER_QUEUE_SEEDS = 64
CROSSOVER_REPS = 7
SMOKE_CROSSOVER_QUEUE_SEEDS = 16
SMOKE_CROSSOVER_REPS = 2


def timed(fn, reps: int):
    """Median wall seconds of fn() over `reps` calls (each ending in a
    device sync), and the last result."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def crossover_lanes(args, queue_seeds: int = CROSSOVER_QUEUE_SEEDS) -> dict:
    """Per (card engine, model kind) key of GPU_BATCH_MIN, its model and
    hard lanes of the engine's own range and that kind: lanes that
    survive the native triage at TRIAGE_MAX_STEPS, and that `_route`
    sends to that engine.
      gpu_vec/scalar      register-late's keys (4096 keys of 64
                          invocations, each impossible read at a random
                          read);
      gpu_row/scalar      main_long's keys (64 keys of 3000);
      gpu_search/scalar   main_single_10k-sized histories;
      gpu_search/fifo     main_fifo_long's 16 keys (~2000 entries);
      gpu_vec/fifo        70-invocation fifo histories (rings <= 64);
      gpu_vec/unordered   800-invocation unordered-queue histories, 2 %
                          of dequeues corrupt;
      gpu_search/unordered  2500-invocation ones, 1 % corrupt."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.history import entries
    from jepsen_tpu_torch.models import CASRegister, FIFOQueue, UnorderedQueue
    from jepsen_tpu_torch.ops import wgl_native
    from jepsen_tpu_torch.workloads.queue import queue_history
    from jepsen_tpu_torch.workloads.register import (keyed_history,
                                                     register_history)

    lin = lin_module()

    def keyed(n_keys, n_ops, **kw):
        hist = keyed_history(n_keys, n_ops, n_process=5, bad_every=8,
                             seed=args.seed, **kw)
        subs = independent._split(hist, list(range(n_keys)))
        return [entries(subs[k]) for k in range(n_keys)]

    def queues(n_ops, fifo, corrupt=0.0, seeds=None):
        seeds = range(queue_seeds) if seeds is None else seeds
        return [entries(queue_history(n_process=5, n_ops=n_ops, fifo=fifo,
                                      corrupt=corrupt,
                                      seed=1000 * args.seed + s))
                for s in seeds]

    pools = {
        ("gpu_vec", "scalar"): (CASRegister(),
                                keyed(4096, 64, bad_read="random")),
        ("gpu_row", "scalar"): (CASRegister(), keyed(64, 3000)),
        ("gpu_search", "scalar"): (CASRegister(), [entries(register_history(
            n_process=5, n_ops=6000, seed=args.seed * 7919 + 9000 + i))
            for i in range(CROSSOVER_K2_LANES)]),
        ("gpu_search", "fifo-queue"): (FIFOQueue(), queues(
            1980, True, seeds=FIFO_SEEDS)),
        ("gpu_vec", "fifo-queue"): (FIFOQueue(), queues(70, True)),
        ("gpu_vec", "unordered-queue"): (UnorderedQueue(),
                                         queues(800, False, 0.02)),
        ("gpu_search", "unordered-queue"): (UnorderedQueue(),
                                            queues(2500, False, 0.01)),
    }
    assert set(pools) == set(lin.GPU_BATCH_MIN), set(lin.GPU_BATCH_MIN)
    out = {}
    for key, (model, ess) in pools.items():
        tri = wgl_native.analysis_batch(model, ess,
                                        max_steps=lin.TRIAGE_MAX_STEPS)
        hard = [es for es, r in zip(ess, tri) if r.valid == "unknown"]
        routes = lin.Linearizable(model)._route(model, hard)
        assert set(routes) == {key[0]}, (key, set(routes))
        assert lin.bar_kind(model) == key[1], key
        out[key] = (model, hard)
    return out


def phase_crossover(args, reps: int = CROSSOVER_REPS,
                    queue_seeds: int = CROSSOVER_QUEUE_SEEDS) -> dict:
    """The bars of "auto", measured: for each (card engine, model kind)
    key, the engine's whole `analysis_batch` (encode, launch, download:
    what "auto" pays) timed at 1 hard lane and at the full batch of its
    hard lanes, fitted as t_rt + L * slope_card; native's pooled
    `analysis_batch` on the same lanes gives slope_native. The bar is
    ceil(t_rt / (slope_native - slope_card)) where the card's slope is
    lower, else None (native always). Prints the measured bars beside
    GPU_BATCH_MIN."""
    import math

    from jepsen_tpu_torch.ops import wgl_native

    lin = lin_module()
    rows = {}
    bars = {}
    for (engine, kind), (model, lanes) in crossover_lanes(
            args, queue_seeds).items():
        mod = lin.ENGINES[engine]
        n = len(lanes)
        assert n >= 2, (engine, kind, n)

        def card(ess):
            return mod.analysis_batch(model, ess, device="cuda")

        t1, _ = timed(lambda: card(lanes[:1]), reps)
        tl, rs = timed(lambda: card(lanes), reps)
        tn, rn = timed(lambda: wgl_native.analysis_batch(model, lanes), reps)
        # a card unknown is one native finishes; a definite card verdict
        # must be native's
        assert all(a.valid == b.valid for a, b in zip(rs, rn)
                   if a.valid != "unknown"), (engine, kind)
        slope_card = (tl - t1) / (n - 1)
        t_rt = t1 - slope_card
        slope_native = tn / n
        bar = (max(1, math.ceil(t_rt / (slope_native - slope_card)))
               if slope_native > slope_card else None)
        name = f"{engine}/{kind}"
        bars[name] = bar
        rows[name] = {"lanes": n, "longest": max(len(es) for es in lanes),
                      "t_1_s": t1, "t_full_s": tl, "native_full_s": tn,
                      "t_rt_s": t_rt, "slope_card_s": slope_card,
                      "slope_native_s": slope_native, "bar": bar,
                      "constant": lin.GPU_BATCH_MIN[(engine, kind)],
                      "card_verdicts": verdict_counts(r.valid for r in rs),
                      "native_verdicts": verdict_counts(r.valid
                                                        for r in rn)}
    emit({"phase": "crossover", "cpu_count": os.cpu_count(),
          "native_workers": min(os.cpu_count() or 1,
                                wgl_native.MAX_WORKERS),
          "triage_max_steps": lin.TRIAGE_MAX_STEPS, "reps": reps,
          "queue_seeds": queue_seeds,
          "engines": rows, "measured_bars": bars,
          "GPU_BATCH_MIN": {f"{e}/{k}": b
                            for (e, k), b in lin.GPU_BATCH_MIN.items()}})
    return bars


CORPUS = os.path.join("tests", "fixtures", "linearizability_corpus.jsonl")


def phase_corpus(args) -> None:
    """Every case of the verdict corpus through each card engine that
    takes it (gpu_vec, gpu_row, gpu_search: one analysis_batch per model
    and engine, default budget), through the native engine and through
    "auto" (one check a case): each verdict is the corpus's — a card
    engine may instead answer "unknown" where its bounded memo runs out
    (counted apart, with the cases named, as tools/replay_parity.py skips
    deep cases for pallas_vec), "auto" and native never — and each
    invalid case's op is the host search's (for "auto" on a history it
    splits P-compositionally: the host search over the one lane of the
    split that holds the op refutes that lane at that op). Cases whose
    expected verdict is "unknown" are budgets of other engines and are
    counted as skipped, as PARITY.json counts them. Prints the counts
    beside PARITY.json's (pallas_vec 229, tpu 238, native 263)."""
    from jepsen_tpu_torch import carry, models
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import entries
    from jepsen_tpu_torch.models import jit as mjit
    from jepsen_tpu_torch.ops import pcomp, wgl_host, wgl_native

    lin = lin_module()
    model_of = {"cas-register": models.CASRegister,
                "register": models.Register, "mutex": models.Mutex,
                "unordered-queue": models.UnorderedQueue,
                "fifo-queue": models.FIFOQueue,
                "multi-register": models.MultiRegister}
    with open(os.path.join(HERE, CORPUS)) as fh:
        cases = [json.loads(line) for line in fh if line.strip()]
    with open(os.path.join(HERE, "PARITY.json")) as fh:
        parity = json.load(fh)["engines"]
    tally = {e: {"checked": 0, "matched": 0, "unknown": 0, "skipped": 0,
                 "ops_equal": 0, "mismatches": [], "unknown_cases": []}
             for e in (*lin.ENGINES, "native", "auto")}
    lanes = {e: {} for e in lin.ENGINES}
    prepared = []
    for case in cases:
        model = model_of[case["model"]]()
        hist = carry.history_from_dicts(case["history"])
        es = entries(hist)
        jm = mjit.for_model(model)
        definite = case["expected"] != "unknown"
        host = wgl_host.analysis(model, es) if definite else None
        prepared.append((case, model, hist, es, host))
        for e, mod in lin.ENGINES.items():
            if definite and jm is not None and mod.batch_eligible(jm, [es]):
                lanes[e].setdefault(case["model"], []).append(
                    len(prepared) - 1)
            else:
                tally[e]["skipped"] += 1

    def record(e, i, r, ref=None) -> None:
        """One engine's verdict on case i: the corpus's, or "unknown"
        from a card engine whose bounded memo or step budget ran out
        (counted, not a contradiction); an invalid verdict's op is the
        host search's (`ref`'s when given)."""
        case, _, _, _, host = prepared[i]
        ref = host if ref is None else ref
        t = tally[e]
        t["checked"] += 1
        if r["valid"] == case["expected"]:
            t["matched"] += 1
        elif r["valid"] == "unknown" and e in lin.ENGINES:
            t["unknown"] += 1
            t["unknown_cases"].append(case["name"])
        else:
            t["mismatches"].append((case["name"], r["valid"]))
        if r["valid"] is False and ref.valid is False \
                and r.get("op") == ref.op.to_dict():
            t["ops_equal"] += 1
        elif r["valid"] is False:
            t["mismatches"].append((case["name"], "op"))

    def split_ref(model, es, r):
        """For an invalid "auto" result on a history that splits
        P-compositionally, the host search over the lane of the split
        that holds r's op (which must refute that lane at that op); None
        when the history takes the whole search or r is not invalid."""
        if r["valid"] is not False or not pcomp.eligible(model):
            return None
        lanes = pcomp.split(model, es)
        if lanes is None:
            return None
        (lane,) = [(m, e) for m, e in lanes
                   if any(o.index == r["op"]["index"] for o in e.invokes)]
        return wgl_host.analysis(*lane)

    t0 = time.perf_counter()
    for e, by_model in lanes.items():
        for name, idx in by_model.items():
            rs = lin.ENGINES[e].analysis_batch(
                model_of[name](), [prepared[i][3] for i in idx],
                device="cuda")
            for i, r in zip(idx, rs):
                record(e, i, lin.Linearizable()._result(r))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, (case, model, hist, es, host) in enumerate(prepared):
        if host is None:
            tally["auto"]["skipped"] += 1
            tally["native"]["skipped"] += 1
            continue
        r = linearizable(model).check({}, hist, {})
        record("auto", i, r, split_ref(model, es, r))
        if wgl_native.eligible(model, es):
            record("native", i, lin.Linearizable()._result(
                wgl_native.analysis(model, es)))
        else:
            tally["native"]["skipped"] += 1
    auto_s = time.perf_counter() - t0
    reference = {"gpu_vec": ("pallas_vec", parity["pallas_vec"]["checked"]),
                 "gpu_search": ("tpu", parity["tpu"]["checked"]),
                 "native": ("native", parity["native"]["checked"])}
    emit({"phase": "corpus", "cases": len(cases), "card_s": card_s,
          "auto_s": auto_s, "engines": tally,
          "reference_checked": reference})
    for e, t in tally.items():
        assert not t["mismatches"], (e, t["mismatches"][:8])
        assert t["checked"] + t["skipped"] == len(cases), e


# -- the fuzz simulator (K4's counterpart) ---------------------------------

# bytes of one cluster's seven outputs per mop (kind, key, eff, pos, rlen)
# and per slot (coord, failed)
SIM_MOP_BYTES = 5 * 4
SIM_SLOT_BYTES = 4 + 1
# int32 operations a unit of the simulator's work costs, for its bound
# (`sim_work` counts the units). The hash hi(w, c, a, b) is four stages,
# each a murmur3 finalizer (three shift-xors, two multiplies): w's xors a
# constant in; a's, b's and c's multiply their index by a constant and xor
# it in, and c's masks to 31 bits. Hashes that share w (a cluster), then a
# (a slot, or an append's mop index), then b share those stages, so each
# stage is counted once where the function needs it.
SIM_FMIX_OPS = 8
SIM_W_STAGE_OPS = 1 + SIM_FMIX_OPS
SIM_STAGE_OPS = 2 + SIM_FMIX_OPS
SIM_LAST_STAGE_OPS = 3 + SIM_FMIX_OPS
# a rank pair (two valid appends of one key): a 64-bit (eff, mop) compare
# as two int32 compares, and the count's add
SIM_RANK_OPS = 3
# a visibility pair (a valid read and a valid append of its key): the
# delivery time against eff (< and ==), the mop indices, their
# combination and the minimum
SIM_VIS_OPS = 5
# a cascade step (one delivery rule on one valid append at one node other
# than its sender): the window's two compares, two node-bit tests, the
# update
SIM_STEP_OPS = 5
# threads a block the kernel is timed at beside its default
SIM_THREADS = (32, 64, 128, 256)
# the specs of tests/test_torch_fuzz.py, a spec of 16 nodes and 16 fault
# slots with one key and two mops a txn, and one of more keys than the
# kernel's 32 buckets and more mops than its default threads
SIM_SPECS = {
    "default": {},
    "small": dict(nodes=3, keys=5, txns=10, mops=3, faults=4),
    "wide": dict(nodes=7, keys=12, txns=30, mops=5, faults=10),
    "one_key": dict(nodes=2, keys=1, txns=6, mops=2, faults=2),
    "edge": dict(nodes=16, keys=1, txns=2, mops=2, faults=16),
    "many_keys": dict(nodes=5, keys=70, txns=40, mops=4, faults=8),
}


def sim_work(spec, scheds, wseeds, out) -> dict:
    """The work a launch's outputs need, counted from its inputs and its
    outputs (equal to the plain version's): hash stages (w once a
    cluster; a once a work slot and once a valid append with a packet
    test; b once a work mop and once an (append, node) pair with a packet
    test; c once a hash taken: coordinator and mop count a work slot, key
    a work mop, kind a mop its txn runs, jitter a work mop whose slot a
    clock fault gives an amplitude, one a packet test), rank pairs (sum
    over keys of a_k^2 valid appends), visibility pairs (r_k valid reads x
    a_k) and cascade steps (valid appends x (N - 1) x delivery rules:
    partition, kill, pause, corruption and packet slots). Packet tests are
    counted by replaying the cascade: a packet rule tests, and hashes,
    where its node bits and the time the rules before it left select."""
    import torch

    from jepsen_tpu_torch.fuzz import sim as sm
    from jepsen_tpu_torch.fuzz.schedule import (CLOCK, CORRUPT, KILL,
                                                PACKET, PARTITION, PAUSE)

    S, N, K, T, L = (scheds.shape[0], spec.nodes, spec.keys, spec.txns,
                     spec.mops)
    St, M, dev = spec.slots, spec.slots * spec.mops, scheds.device
    kind, key = out["kind"].reshape(S, M), out["key"].reshape(S, M)
    coord = out["coord"]
    fail = out["failed"][:, :, None].expand(S, St, L).reshape(S, M)
    vapp = (kind == sm.KIND_APPEND) & ~fail
    vread = (kind == sm.KIND_READ) & ~fail
    onehot = torch.nn.functional.one_hot(key.long(), K)
    a_k = (onehot * vapp[:, :, None]).sum(1)
    r_k = (onehot * vread[:, :, None]).sum(1)
    fam, msk = scheds[:, :, 0], scheds[:, :, 1]
    t0, t1, p0, p1 = (scheds[:, :, i] for i in (2, 3, 4, 5))
    sarr = torch.arange(St, device=dev)
    covers = (((msk[:, :, None] >> coord[:, None, :]) & 1) == 1) \
        & (t0[:, :, None] <= sarr) & (sarr < t1[:, :, None]) & (sarr < T)
    amp = ((fam == CLOCK)[:, :, None] & covers
           & (p1[:, :, None] > 0)).any(1)[:, :T]
    rules = sum((fam == f).sum(1) for f in (PARTITION, KILL, PAUSE, CORRUPT,
                                            PACKET))
    # the cascade replayed (sim_plain's rule order) to find packet tests
    send = coord[:, :, None].expand(S, St, L).reshape(S, M)[:, :, None]
    narr = torch.arange(N, device=dev)
    marr = torch.arange(M, device=dev)
    d = out["eff"].reshape(S, M)[:, :, None].expand(S, M, N).clone()
    remote = vapp[:, :, None] & (send != narr)
    tests = torch.zeros((S, M, N), dtype=torch.int32, device=dev)
    for f in range(spec.faults):
        fa, mk = fam[:, f, None, None], msk[:, f, None, None]
        a0, a1 = t0[:, f, None, None] * L, t1[:, f, None, None] * L
        q0, q1 = p0[:, f, None, None], p1[:, f, None, None]
        sb, rb = ((mk >> send) & 1) == 1, ((mk >> narr) & 1) == 1
        d = torch.where((fa == PARTITION) & (sb ^ rb) & (a0 <= d) & (d < a1),
                        a1, d)
        test = (fa == PACKET) & (sb | rb) & (a0 <= d) & (d < a1) & remote
        tests += test
        if bool(test.any()):
            hd = sm.hi_torch(wseeds[:, None, None], 170 + f,
                             marr[None, :, None], narr[None, None, :])
            drop = test & (hd % 16 < q0)
            d = torch.where(drop, d + 1 + (hd >> 4) % torch.clamp(q1 * L,
                                                                  min=1), d)
        d = torch.where(((fa == KILL) | (fa == PAUSE)) & rb & (a0 <= d)
                        & (d < a1), a1, d)
        d = torch.where((fa == CORRUPT) & rb & (key[:, :, None] == q0)
                        & (a0 - q1 * L <= d) & (d < a0), a0 + 1, d)
    work = {
        "a_stages": S * T + int((tests.sum(2) > 0).sum()),
        "b_stages": S * T * L + int((tests > 0).sum()),
        "c_stages": (2 * S * T + S * T * L
                     + int((kind[:, :T * L] != sm.KIND_PAD).sum())
                     + int(amp.sum()) * L + int(tests.sum())),
        "packet_tests": int(tests.sum()),
        "rank_pairs": int((a_k * a_k).sum()),
        "vis_pairs": int((r_k * a_k).sum()),
        "cascade_steps": int((vapp.sum(1) * (N - 1) * rules).sum())}
    work["ops"] = (S * SIM_W_STAGE_OPS
                   + (work["a_stages"] + work["b_stages"]) * SIM_STAGE_OPS
                   + work["c_stages"] * SIM_LAST_STAGE_OPS
                   + work["rank_pairs"] * SIM_RANK_OPS
                   + work["vis_pairs"] * SIM_VIS_OPS
                   + work["cascade_steps"] * SIM_STEP_OPS)
    return work


def sim_bound(spec, scheds, wseeds, out) -> tuple:
    """(seconds for the bytes, seconds for the operations, the work) of
    one launch: the schedules and seeds read once, the seven outputs
    written once, over HBM bandwidth; the int32 operations `sim_work`
    counts, over the int32 rate. Beside them in the work: the loop steps
    of the kernel's first design, one operation each (`old_ops`: 2 M^2 +
    M N F a cluster), which the bound counted before it counted the work,
    and that bound (`old_bound_ms`)."""
    S, M = scheds.shape[0], spec.slots * spec.mops
    nbytes = S * (4 * (6 * spec.faults + 1) + SIM_SLOT_BYTES * spec.slots
                  + SIM_MOP_BYTES * M)
    work = sim_work(spec, scheds, wseeds, out)
    work["old_ops"] = S * (2 * M * M + M * spec.nodes * spec.faults)
    work["old_bound_ms"] = bound_ms(nbytes / HBM_BYTES_PER_S,
                                    work["old_ops"] / INT32_OPS_PER_S)[0]
    return nbytes / HBM_BYTES_PER_S, work["ops"] / INT32_OPS_PER_S, work


def fuzz_batch(seed: int, n: int, spec=None):
    """The JAX package's bench batch (bench.py fuzz lane): DEFAULT_SPEC
    (or `spec`), random_schedule(seed + i), wseed (i * 2654435761 + seed)
    mod 2^31."""
    import numpy as np

    from jepsen_tpu_torch.fuzz.schedule import DEFAULT_SPEC, random_schedule

    scheds = np.stack([random_schedule(seed + i, spec or DEFAULT_SPEC)
                       for i in range(n)])
    wseeds = (np.arange(n, dtype=np.int64) * 2654435761 + seed) & 0x7FFFFFFF
    return scheds, wseeds


def sim_vs_plain(kernel, scheds, wseeds, spec, chunk: int = 1024,
                 sweep: bool = False) -> dict:
    """The kernel's launch on a batch replayed on the card and held bit
    for bit, on all seven outputs, against sim_plain on the same tensors,
    in chunks of `chunk` clusters; the kernel's median ms behind the spin
    (`spin_ms`), the plain version's ms summed over the chunks, and the
    bound (`sim_bound`). With `sweep`, the launch again at each of
    SIM_THREADS threads a block, each held and timed (`threads_ms`)."""
    import torch

    sm = kernel.mod
    s = torch.from_numpy(scheds).cuda()
    w = torch.from_numpy(wseeds.astype("int32")).cuda()
    ms, out = spin_ms(sm, lambda: sm.sim(s, w, spec))
    plain_ms = 0.0
    for a in range(0, s.shape[0], chunk):
        p_ms, want = cuda_ms(lambda: sm.sim_plain(s[a:a + chunk],
                                                  w[a:a + chunk], spec))
        plain_ms += p_ms
        held(kernel, f"clusters {a}..{a + chunk}",
             [out[k][a:a + chunk] for k in sm.OUTPUTS],
             [want[k] for k in sm.OUTPUTS])
    t_b, t_o, work = sim_bound(spec, s, w, out)
    b_ms, b_by = bound_ms(t_b, t_o)
    sms = torch.cuda.get_device_properties(s.device).multi_processor_count
    figs = {"clusters": s.shape[0],
            "threads": sm.block_threads(spec, s.shape[0], sms),
            "smem_bytes": sm.smem_bytes(spec), "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "share": b_ms / ms, "work": work, "matches_plain": True}
    if sweep:
        figs["threads_ms"] = {}
        try:
            for t in SIM_THREADS:
                sm.THREADS = t
                t_ms, got = spin_ms(sm, lambda: sm.sim(s, w, spec))
                held(kernel, f"threads {t}", [got[k] for k in sm.OUTPUTS],
                     [out[k] for k in sm.OUTPUTS])
                figs["threads_ms"][t] = t_ms
        finally:
            sm.THREADS = None
    return figs


def set_sim_row(kernel, cell, figs) -> None:
    if kernel.ms is None:
        kernel.ms, kernel.plain_ms = figs["kernel_ms"], figs["plain_ms"]
        kernel.bound_ms, kernel.bound_by = figs["bound_ms"], figs["bound_by"]
        kernel.shape = (f"[{figs['clusters']}, 8, 6] schedules: the {cell} "
                        "cell's launch")
    kernel.cells[cell] = figs
    sim_by_batch(kernel, figs)


def sim_by_batch(kernel, figs) -> None:
    """The kernel row's figures by batch size (`by_batch`)."""
    kernel.extra.setdefault("by_batch", {})[figs["clusters"]] = {
        "kernel_ms": figs["kernel_ms"], "bound_ms": figs["bound_ms"],
        "bound_by": figs["bound_by"], "share": figs["share"],
        "old_bound_ms": figs["work"]["old_bound_ms"],
        "threads_ms": figs.get("threads_ms")}


def phase_sim_specs(args, kernel) -> None:
    """The kernel against its plain version, bit for bit, at every spec
    of SIM_SPECS on 1024 seeded clusters (`fuzz_batch` of that spec)."""
    from jepsen_tpu_torch.fuzz.schedule import SimSpec

    for name, kw in SIM_SPECS.items():
        spec = SimSpec(**kw)
        figs = sim_vs_plain(kernel, *fuzz_batch(args.seed, 1024, spec), spec)
        emit({"phase": "sim_specs", "spec": name, **kw,
              **{k: figs[k] for k in ("clusters", "threads", "smem_bytes",
                                      "kernel_ms", "bound_ms", "share",
                                      "matches_plain")}})


def phase_fuzz(args, kernels, ck, kernel, name: str, n: int,
               score: bool, round_clusters: int | None = None) -> None:
    """The fuzz path on n seeded clusters (`fuzz_batch`): simulate_batch
    on the card (one sim launch), and with `score` the scoring through
    the cycle checker's closures on the card, as one main path; the
    launch replayed against the plain version bit for bit and timed at
    each of SIM_THREADS, the closure launches round by round, and the
    card's scores equal to the host DFS engine's scores (anomaly types,
    cycle counts and coverage keys: whole dicts). With `round_clusters`,
    one more sim launch on the first that many clusters of the seed (the
    fuzz loop's round) is held and timed beside it."""
    from jepsen_tpu_torch.fuzz import score_batch, simulate_batch
    from jepsen_tpu_torch.fuzz.schedule import DEFAULT_SPEC

    scheds, wseeds = fuzz_batch(args.seed, n)
    phases = {}

    def path():
        t0 = time.perf_counter()
        res = simulate_batch(scheds, wseeds)
        phases["simulate_s"] = time.perf_counter() - t0
        if not score:
            return res, None
        t0 = time.perf_counter()
        sc = score_batch(res, DEFAULT_SPEC, scheds=scheds)
        phases["score_s"] = time.perf_counter() - t0
        return res, sc

    (res, sc), wall, seen = run_path(kernels, path)
    launches = {k: v[0] for k, v in seen.items() if v[0]}
    assert launches.get("sim") == 1, launches
    assert len(res) == n
    figs = sim_vs_plain(kernel, scheds, wseeds, DEFAULT_SPEC, sweep=True)
    figs["launches"] = seen["sim"][0]
    figs["path_kernel_ms"] = seen["sim"][1]
    set_sim_row(kernel, name, figs)
    line = {"phase": name, "clusters": n, "wall_s": wall, **phases,
            "clusters_per_s": n / phases["simulate_s"],
            "launches": launches, "sim": figs}
    if round_clusters:
        small = sim_vs_plain(kernel, *fuzz_batch(args.seed, round_clusters),
                             DEFAULT_SPEC, sweep=True)
        sim_by_batch(kernel, small)
        line["sim_round"] = small
    device_ms = figs["kernel_ms"]
    if score:
        t0 = time.perf_counter()
        host = score_batch(res, DEFAULT_SPEC, scheds=scheds, engine="host")
        line["host_score_s"] = time.perf_counter() - t0
        assert sc == host, "card scores != host DFS scores"
        buckets = replay_closure(ck, seen["unpack"][2])
        closure_cell(ck, name, seen, buckets)
        device_ms += sum(bk[k]["ms"] for bk in buckets
                         for k in ("closure_word", "unpack", "matmul",
                                   "or_threshold_pack") if k in bk)
        types: dict = {}
        for x in sc:
            for t in x["anomaly-types"]:
                types[t] = types.get(t, 0) + 1
        line.update(anomalous=sum(not x["valid"] for x in sc),
                    anomaly_types=types,
                    coverage_keys=len({x["coverage"] for x in sc}),
                    host_equal=True, closure_buckets=buckets)
    line["device_ms"] = device_ms
    line["device_idle"] = 1 - device_ms / 1000 / wall
    emit(line)


def phase_fuzz_fixtures(args, kernels, kernel) -> None:
    """The 8 committed anomaly traces (tests/fixtures/fuzz_anomalies.jsonl)
    in one simulate_batch on the card (held against the plain version),
    then scored on the card: each trace's anomaly types, cycle count and
    coverage key are the fixture's."""
    import numpy as np

    from jepsen_tpu_torch.fuzz import score_batch, simulate_batch
    from jepsen_tpu_torch.fuzz.schedule import (DEFAULT_SPEC, SimSpec,
                                                schedule_from_lists)

    with open(os.path.join(HERE, "tests", "fixtures",
                           "fuzz_anomalies.jsonl")) as fh:
        cases = [json.loads(line) for line in fh if line.strip()]
    assert all(SimSpec(**c["spec"]) == DEFAULT_SPEC for c in cases)
    scheds = np.stack([schedule_from_lists(c["schedule"]) for c in cases])
    wseeds = np.array([c["wseed"] for c in cases], dtype=np.int64)

    def path():
        res = simulate_batch(scheds, wseeds)
        return score_batch(res, DEFAULT_SPEC, scheds=scheds)

    sc, wall, seen = run_path(kernels, path)
    assert seen["sim"][0] == 1
    for c, x in zip(cases, sc):
        assert x["anomaly-types"] == c["types"], (c["id"], x)
        assert x["coverage"] == c["coverage"], (c["id"], x["coverage"])
        assert x["cycle-count"] == c["cycle-count"], c["id"]
    figs = sim_vs_plain(kernel, scheds, (wseeds & 0x7FFFFFFF), DEFAULT_SPEC)
    figs["launches"] = seen["sim"][0]
    kernel.cells["fuzz_fixtures"] = figs
    emit({"phase": "fuzz_fixtures", "cases": len(cases), "wall_s": wall,
          "launches": {k: v[0] for k, v in seen.items() if v[0]},
          "types": [x["anomaly-types"] for x in sc], "sim": figs,
          "matches_fixtures": True})


def phase_fuzzing(args, kernels, ck, sim) -> None:
    """The sim kernel at every spec of SIM_SPECS, then the fuzz path's
    three cells."""
    phase_sim_specs(args, sim)
    # the JAX package's bench batch of 1024 clusters, simulated and
    # scored on the card, beside it the fuzz loop's round of 256
    # (FuzzLoop(clusters=256)); 16,384 clusters for throughput; the
    # committed anomaly traces
    phase_fuzz(args, kernels, ck, sim, "fuzz_sim_1024", 1024, score=True,
               round_clusters=256)
    phase_fuzz(args, kernels, ck, sim, "fuzz_sim_16384", 16384, score=False)
    phase_fuzz_fixtures(args, kernels, sim)


# -- linear, competition, the store, the journal and the fuzz loop --------

# per-case time limit of the linear and competition phase (s)
LINEAR_LIMIT_S = 2
# steps past which a K2 lane launched under competition is compared with
# the plain version under this common budget (its 2-s limit gives lanes
# 100,000 steps, ~30 s of the plain version's lockstep each)
COMPETITION_CAP = 2_000


def corpus_cases():
    """(case, fresh model, the port's history) for every corpus case."""
    from jepsen_tpu_torch import carry, models

    model_of = {"cas-register": models.CASRegister,
                "register": models.Register, "mutex": models.Mutex,
                "unordered-queue": models.UnorderedQueue,
                "fifo-queue": models.FIFOQueue,
                "multi-register": models.MultiRegister}
    with open(os.path.join(HERE, CORPUS)) as fh:
        cases = [json.loads(line) for line in fh if line.strip()]
    return [(c, model_of[c["model"]], carry.history_from_dicts(c["history"]))
            for c in cases]


def phase_linear(args, kernels, search) -> None:
    """Every corpus case through the `linear` algorithm on the host, then
    through `competition` on the card (linear raced against K2's
    counterpart where the model encodes), each at a LINEAR_LIMIT_S limit.
    linear: `linearizable(m, "linear").check`, or for the cases whose
    corpus verdict is "unknown" under their recorded `params.budget`,
    `linear.analysis` under that budget's max_configs: each verdict the
    corpus's, "unknown" counted apart. competition: one main path over
    every case (counts set to 0 before, read after `_drain_racers`,
    which must raise nothing); each definite verdict the corpus's (for
    the budget cases: the native search's); the winners' counts; after
    each check, the seconds until the abandoned K2 loser's thread is done
    and the card is idle; every captured K2 launch held against
    search_plain (`replay`, lanes past COMPETITION_CAP steps under it)."""
    import torch

    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.ops import linear, wgl_native

    lin = lin_module()
    cases = corpus_cases()
    t0 = time.perf_counter()
    tally = {"matched": 0, "unknown": 0, "unknown_cases": [],
             "mismatches": []}
    for case, model, hist in cases:
        budget = case["params"].get("budget")
        if case["expected"] == "unknown":
            d = lin.Linearizable()._result(linear.analysis(
                model(), hist, time_limit=LINEAR_LIMIT_S,
                max_configs=budget["max_configs"]))
        else:
            d = linearizable(model(), "linear",
                             time_limit=LINEAR_LIMIT_S).check({}, hist, {})
        if d["valid"] == case["expected"]:
            tally["matched"] += 1
        elif d["valid"] == "unknown":
            tally["unknown"] += 1
            tally["unknown_cases"].append(case["name"])
        else:
            tally["mismatches"].append((case["name"], d["valid"]))
    linear_s = time.perf_counter() - t0
    assert not tally["mismatches"], tally["mismatches"]

    wins0 = dict(lin.COMPETITION_WINS)
    busy: list = []
    check_s: list = []
    verdicts: list = []

    def path():
        for case, model, hist in cases:
            t1 = time.perf_counter()
            d = linearizable(model(), "competition",
                             time_limit=LINEAR_LIMIT_S).check({}, hist, {})
            t2 = time.perf_counter()
            for t in list(lin._abandoned_racers):
                if t.name == "competition-wgl_search":
                    t.join()
            torch.cuda.synchronize()
            check_s.append(t2 - t1)
            busy.append(time.perf_counter() - t2)
            verdicts.append(d["valid"])
        lin._drain_racers()

    _, wall, seen = run_path(kernels, path)
    launches = {k: v[0] for k, v in seen.items() if v[0]}
    assert launches.get("wgl_search", 0) >= 1, launches
    assert set(launches) == {"wgl_search"}, launches
    mismatches, undecided = [], []
    for (case, model, hist), v in zip(cases, verdicts):
        want = case["expected"]
        if want == "unknown":
            want = wgl_native.analysis(model(), hist).valid
        if v == "unknown":
            undecided.append(case["name"])
        elif v != want:
            mismatches.append((case["name"], v, want))
    assert not mismatches, mismatches
    wins = {k: lin.COMPETITION_WINS[k] - wins0[k] for k in wins0}
    passes = replay(kernels, seen, "competition", cap=COMPETITION_CAP)
    cell = search.cells["competition"]
    top = sorted(range(len(busy)), key=lambda i: -busy[i])[:5]
    emit({"phase": "linear", "nvidia_smi": args.smi, "cases": len(cases),
          "limit_s": LINEAR_LIMIT_S,
          "linear": {"wall_s": linear_s, **tally},
          "competition": {
              "wall_s": wall, "checks_s": sum(check_s),
              "busy_after_return_s": sum(busy),
              "busy_after_return_max_s": max(busy),
              "busiest": [(cases[i][0]["name"], busy[i]) for i in top],
              "winners": wins, "unknown": len(undecided),
              "unknown_cases": undecided, "launches": launches,
              "kernel_ms": seen["wgl_search"][1],
              "device_idle": 1 - seen["wgl_search"][1] / 1000 / wall,
              "kernel_vs_plain": {
                  "launches_compared": len(passes["wgl_search"]),
                  "shapes": len({search_shape(c)
                                 for c in seen["wgl_search"][2]}),
                  **{f: cell[f] for f in (
                      "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                      "bound_share_range", "capped_lanes")},
                  "cap": COMPETITION_CAP, "matches_plain": True}}})


# the store phase's sizes: the register cell's shape at half its keys
# (BASELINE.md:18 has 4096), the cycle_append history, the fuzz loop's
# round (FuzzLoop's default)
STORE_KEYS = 2048
STORE_INVOCATIONS = 64
STORE_CYCLE_OPS = 5000
STORE_FUZZ_CLUSTERS = 256


def store_files(root) -> dict:
    """Files under root by name: {basename: count}."""
    out: dict = {}
    for _, _, files in os.walk(root):
        for f in files:
            out[f] = out.get(f, 0) + 1
    return out


def json_normal(d):
    """A result dict as the journal's JSON carries it."""
    from jepsen_tpu_torch import store

    return json.loads(json.dumps(store._json_keys(d),
                                 default=store._json_default))


def store_test(td: str, name: str) -> dict:
    """A test map with a store dir under td and an analysis journal."""
    import datetime

    from jepsen_tpu_torch import store

    test = {"name": name, "store_dir": td,
            "start_time": store.time_str(datetime.datetime.now())}
    test["_analysis_journal"] = store.AnalysisJournal(test)
    return test


def store_register(args, kernels, td: str) -> dict:
    """STORE_KEYS register keys x 64 invocations (every 8th key with
    an impossible read) through independent.checker(linearizable(
    CASRegister(), "auto")) with every bar at 1 and a store dir and
    journal: run 1 writes results.edn and history.txt for every key and
    linear.svg for every invalid one, launching K1 (its launches
    replayed); run 2 with the same journal and run 3 with the journal
    read again from disk check no key, launch nothing and give run 1's
    dict."""
    from jepsen_tpu_torch import independent, store
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.workloads.register import keyed_history

    hist = keyed_history(STORE_KEYS, STORE_INVOCATIONS, n_process=5,
                         bad_every=8, seed=args.seed)
    chk = independent.checker(linearizable(CASRegister(), algorithm="auto"))
    test = store_test(td, "store_register")
    runs = []
    with card_bars(1):
        for label in ("run1", "run2", "run3"):
            if label == "run3":
                test["_analysis_journal"].close()
                test["_analysis_journal"] = store.AnalysisJournal(test)
            res, wall, seen = run_path(kernels,
                                       lambda: chk.check(test, hist, {}))
            runs.append((label, res, wall, seen))
    test["_analysis_journal"].close()
    (_, r1, w1, s1), (_, r2, w2, s2), (_, r3, w3, s3) = runs
    assert s1["wgl_vec"][0] >= 1, s1["wgl_vec"][0]
    for s in (s2, s3):
        assert not any(v[0] for v in s.values()), s
    assert r2 == r1, "run 2 (the same journal) != run 1"
    assert json_normal(r3) == json_normal(r1), "run 3 (journal from disk)"
    assert len(r1["failures"]) == STORE_KEYS // 8 and r1["valid"] is False
    files = store_files(store.path(test))
    assert files.get("results.edn") == STORE_KEYS, files
    assert files.get("history.txt") == STORE_KEYS, files
    assert files.get("linear.svg") == STORE_KEYS // 8, files
    svg = [r.get("counterexample_svg") for r in r1["results"].values()
           if r["valid"] is False]
    assert all(p and os.path.exists(p) for p in svg)
    passes = replay(kernels, s1, "store_register")
    return {"keys": STORE_KEYS, "files": files,
            "run1_wall_s": w1, "run2_wall_s": w2, "run3_wall_s": w3,
            "run1_launches": {k: v[0] for k, v in s1.items() if v[0]},
            "journal_lines": len(store.AnalysisJournal(test)),
            "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v}}


def store_cycle(args, kernels, ck, td: str) -> dict:
    """cycle_append's history (5,000 ops, G1c and G-single injected; op
    times 1 ms apart so the timeline draws every op) through
    `cycle.checker()` with a store dir and journal: run 1 launches K3
    (every bucket replayed) and journals each closure, run 2 with the
    journal launches no K3 kernel and gives run 1's dict; run 1 writes
    timeline-cycle.html with the witness cycles."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker import cycle
    from jepsen_tpu_torch.workloads import list_append

    hist = [o.with_(time=1_000_000 * i) for i, o in enumerate(
        list_append.simulate(STORE_CYCLE_OPS, seed=args.seed,
                             inject=("G1c", "G-single")))]
    chk = cycle.checker()
    test = store_test(td, "store_cycle")
    r1, w1, s1 = run_path(kernels, lambda: chk.check(test, hist, {}))
    n_closures = len(test["_analysis_journal"])
    r2, w2, s2 = run_path(kernels, lambda: chk.check(test, hist, {}))
    test["_analysis_journal"].close()
    assert any(s1[k][0] for k in ck), s1
    assert not any(v[0] for v in s2.values()), s2
    assert normalise(r2) == normalise(r1)
    assert r1["anomaly-types"] == ["G1c", "G-single"], r1["anomaly-types"]
    page = store.path(test, "timeline-cycle.html")
    with open(page) as fh:
        html = fh.read()
    assert 'class="witness"' in html
    buckets = replay_closure(ck, s1["unpack"][2])
    closure_cell(ck, "store_cycle", s1, buckets)
    return {"ops": len(hist), "run1_wall_s": w1, "run2_wall_s": w2,
            "closures_journaled": n_closures,
            "run1_launches": {k: v[0] for k, v in s1.items() if v[0]},
            "timeline_bytes": len(html),
            "witness_arrows": html.count("<line "),
            "buckets_replayed": len(buckets)}


@contextlib.contextmanager
def recorded_sim_batches():
    """The fuzz loop's simulate_batch, recording each batch it is given
    ((scheds, wseeds, spec)) into the list this yields."""
    import numpy as np

    from jepsen_tpu_torch.fuzz import loop

    batches: list = []
    real = loop.simulate_batch

    def recorded(scheds, wseeds, spec, **kw):
        batches.append((np.asarray(scheds), np.asarray(wseeds), spec))
        return real(scheds, wseeds, spec, **kw)

    loop.simulate_batch = recorded
    try:
        yield batches
    finally:
        loop.simulate_batch = real


def hold_sim_batches(sim, batches, cell: str, seen, what: str) -> list:
    """Each recorded fuzz-loop batch canonicalized as the loop launches
    it and held against sim_plain (`sim_vs_plain`); the cell's row entry,
    and the sim row's figures from the first batch if no earlier phase
    set them. Returns the per-batch figures."""
    import numpy as np

    from jepsen_tpu_torch.fuzz import sim as sim_mod
    from jepsen_tpu_torch.fuzz.schedule import canonicalize

    held_rounds = []
    for scheds, wseeds, spec in batches:
        s = np.stack([canonicalize(x, spec) for x in scheds])
        s, w = sim_mod._as_batch(s, wseeds, spec)
        figs = sim_vs_plain(sim, s, w.astype(np.int64), spec)
        held_rounds.append({k: figs[k] for k in (
            "clusters", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "share", "matches_plain")})
    sim.cells[cell] = {"launches": seen["sim"][0],
                       "path_kernel_ms": seen["sim"][1],
                       "rounds": held_rounds}
    if sim.ms is None:
        first = held_rounds[0]
        sim.ms, sim.plain_ms = first["kernel_ms"], first["plain_ms"]
        sim.bound_ms, sim.bound_by = first["bound_ms"], first["bound_by"]
        sim.shape = f"[{first['clusters']}, 8, 6] schedules: {what}"
    return held_rounds


def store_fuzz_loop(args, kernels, ck, sim, td: str) -> dict:
    """FuzzLoop(clusters=256, seed) on the card for 4 rounds (one main
    path: 4 sim launches, each round's batch held against sim_plain, the
    closure buckets replayed), and the same loop with engine="host" and
    score_engine="host": corpus.json and anomalies.jsonl byte-identical;
    the wall of each round."""
    from jepsen_tpu_torch.fuzz import loop

    def rounds(lp) -> list:
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            lp.run_round()
            walls.append(time.perf_counter() - t0)
        return walls

    card = loop.FuzzLoop(os.path.join(td, "card"),
                         clusters=STORE_FUZZ_CLUSTERS, seed=args.seed)
    with recorded_sim_batches() as batches:
        card_walls, wall, seen = run_path(kernels, lambda: rounds(card))
    host = loop.FuzzLoop(os.path.join(td, "host"),
                         clusters=STORE_FUZZ_CLUSTERS,
                         seed=args.seed, engine="host", score_engine="host")
    host_walls = rounds(host)
    for f in (loop.STATE_FILE, loop.ANOMALIES_FILE):
        with open(os.path.join(td, "card", f), "rb") as a, \
                open(os.path.join(td, "host", f), "rb") as b:
            assert a.read() == b.read(), f"card {f} != host {f}"
    assert seen["sim"][0] == 4, seen["sim"][0]
    held_rounds = hold_sim_batches(sim, batches, "store_fuzz_loop", seen,
                                   "the fuzz loop's first round")
    buckets = replay_closure(ck, seen["unpack"][2])
    closure_cell(ck, "store_fuzz_loop", seen, buckets)
    return {"clusters": STORE_FUZZ_CLUSTERS, "rounds": 4, "card_round_s": card_walls,
            "host_round_s": host_walls, "card_wall_s": wall,
            "launches": {k: v[0] for k, v in seen.items() if v[0]},
            "summary": {k: v for k, v in card.corpus.summary().items()},
            "corpus_identical": True, "sim_vs_plain": held_rounds,
            "closure_buckets_replayed": len(buckets)}


def phase_store(args, kernels, ck, sim) -> None:
    """The store, the analysis journal and the artifacts on three paths
    (`store_register`, `store_cycle`, `store_fuzz_loop`), each writing
    under a temporary directory removed after it; one line a path."""
    import tempfile

    for name, fn in (("store_register", lambda td: store_register(
                          args, kernels, td)),
                     ("store_cycle", lambda td: store_cycle(
                         args, kernels, ck, td)),
                     ("store_fuzz_loop", lambda td: store_fuzz_loop(
                         args, kernels, ck, sim, td))):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as td:
            emit({"phase": name, "nvidia_smi": args.smi, **fn(td)})


# -- online checking and the verdict daemon -----------------------------

# the JAX package's online bench stream (bench.py:1292-1312): 34 keys of
# 150 invocations by 5 processes over 5 values, appended key after key,
# advanced in windows of 512 ops
STREAM_KEYS = 34
STREAM_INVOCATIONS = 150
STREAM_WINDOW = 512
# its time-to-abort stream (bench.py:1316-1329): 4,000 list-append ops
# with a G1c injected at the middle, windows of 256
ABORT_OPS = 4000
ABORT_WINDOW = 256
# its daemon cell (bench.py:1138-1174): 100 mixed register histories
# from 5 clients
SERVE_HISTORIES = 100
SERVE_CLIENTS = 5


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def stream_history(seed: int) -> list:
    """The online bench's keyed CAS-register stream."""
    from jepsen_tpu_torch.history import index
    from jepsen_tpu_torch.independent import tuple_
    from jepsen_tpu_torch.workloads.register import register_history

    hist = []
    for k in range(STREAM_KEYS):
        for o in register_history(n_process=5, n_ops=STREAM_INVOCATIONS,
                                  n_values=5, cas=True, seed=seed + k):
            hist.append(o.with_(value=tuple_(k, o.value)))
    return index(hist)


def register_stream(kernels, hist, cell: str, expect) -> dict:
    """One run of the register stream through `WGLFrontier` over the
    registry's register workload on the card, a window of STREAM_WINDOW
    ops an advance: the path (counts reset before, read after; every
    search it launched replayed through `compare`), then each window's
    verdict against a one-shot `IndependentChecker.check` of that prefix
    under the same bars (outside the counted run). `expect`: the kernels
    the path must launch (None: any)."""
    from jepsen_tpu_torch.online import WGLFrontier
    from jepsen_tpu_torch.serve.registry import WORKLOAD_FACTORIES

    chk = WORKLOAD_FACTORIES["register"]()["checker"]
    test = {"name": cell}

    def stream():
        f = WGLFrontier(chk, test=test)
        out = []
        for start in range(0, len(hist), STREAM_WINDOW):
            f.extend(hist[start:start + STREAM_WINDOW])
            dirty = len(f._dirty)
            t0 = time.perf_counter()
            v = f.advance()
            out.append((len(f.ops), dirty, time.perf_counter() - t0, v))
        return out

    out, wall, seen = run_path(kernels, stream)
    launches = {k: v[0] for k, v in seen.items()}
    if expect is not None:
        for k in kernels:
            assert (launches[k.name] > 0) == (k.name in expect), (
                cell, launches)
    passes = replay(kernels, seen, cell)
    t0 = time.perf_counter()
    for n, _, _, v in out:
        assert json_normal(v) == json_normal(chk.check(test, hist[:n], {})), \
            (cell, n)
    one_shot_s = time.perf_counter() - t0
    final = out[-1][3]
    assert final["valid"] is True, final["valid"]
    lags = [lag for _, _, lag, _ in out]
    kernel_ms = sum(v[1] for v in seen.values())
    return {"windows": len(out), "wall_s": wall,
            "ops_per_s": len(hist) / wall,
            "advance_p50_ms": 1000 * percentile(lags, 0.5),
            "advance_p95_ms": 1000 * percentile(lags, 0.95),
            "advance_ms": [1000 * x for x in lags],
            "dirty_keys": [d for _, d, _, _ in out],
            "launches": {k: v for k, v in launches.items() if v},
            "kernel_ms": kernel_ms, "device_idle": 1 - kernel_ms / 1000 / wall,
            "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v},
            "one_shot_equal": True, "one_shot_s": one_shot_s}


def phase_online_register_stream(args, kernels) -> None:
    """The register stream with every bar at 1 (each window's dirty keys
    through K1) and beside it with the measured bars (the path users
    take); one line."""
    hist = stream_history(args.seed)
    with card_bars(1):
        card = register_stream(kernels, hist, "online_register_stream",
                               ("wgl_vec",))
    auto = register_stream(kernels, hist, "online_register_stream_auto",
                           None)
    emit({"phase": "online_register_stream", "nvidia_smi": args.smi,
          "ops": len(hist), "keys": STREAM_KEYS, "window": STREAM_WINDOW,
          "bars_1": card, "measured_bars": auto})


def phase_online_cycle_abort(args, kernels, ck) -> None:
    """The abort stream through `StreamSession(window=256,
    abort_on_invalid=True)` over `CycleFrontier(cycle.checker())` on the
    card: it must abort before the end with the G1c; every closure
    bucket it ran is replayed through `replay_closure` (K3's launches
    counted and timed per kernel, closure_word among them); each
    advance's dict must equal `CycleChecker.check` of that prefix."""
    from jepsen_tpu_torch.checker import cycle
    from jepsen_tpu_torch.history import index
    from jepsen_tpu_torch.online import CycleFrontier, StreamSession
    from jepsen_tpu_torch.workloads import list_append

    base = list_append.simulate(ABORT_OPS, seed=args.seed, inject=())
    h = list(base[:len(base) // 2])
    list_append.inject_g1c(h, proc=3, key_a=100_001, key_b=100_002)
    h = index(h + list(base[len(base) // 2:]))
    chk = cycle.checker()
    emitted: list = []
    lags: list = []

    def stream():
        frontier = CycleFrontier(chk)
        real = frontier.advance

        def timed_advance():
            t0 = time.perf_counter()
            v = real()
            lags.append(time.perf_counter() - t0)
            return v

        frontier.advance = timed_advance
        s = StreamSession(iter(h), frontier, window=ABORT_WINDOW,
                          abort_on_invalid=True, emit=emitted.append)
        return s, s.run()

    (s, final), wall, seen = run_path(kernels, stream)
    assert s.aborted and final["valid"] is False, final["valid"]
    assert s.consumed < len(h), (s.consumed, len(h))
    assert "G1c" in s.abort_info["anomaly-types"], s.abort_info
    buckets = replay_closure(ck, seen["unpack"][2])
    closure_cell(ck, "online_cycle_abort", seen, buckets)
    t0 = time.perf_counter()
    for rec in emitted:
        assert normalise(rec["verdict"]) == normalise(
            chk.check({}, h[:rec["prefix"]], {})), rec["prefix"]
    batch_s = time.perf_counter() - t0
    ms = {k: sum(bk[k]["ms"] for bk in buckets if k in bk)
          for k in ck if seen[k][0]}
    emit({"phase": "online_cycle_abort", "nvidia_smi": args.smi,
          "ops": len(h), "window": ABORT_WINDOW,
          "abort_prefix": s.abort_info["prefix"], "consumed": s.consumed,
          "consumed_fraction": s.consumed / len(h),
          "time_to_abort_s": wall, "advances": len(emitted),
          "advance_ms": [1000 * x for x in lags],
          "anomaly-types": s.abort_info["anomaly-types"],
          "launches": {k: v[0] for k, v in seen.items() if v[0]},
          "kernel_ms": ms, "device_idle": 1 - sum(ms.values()) / 1000 / wall,
          "buckets": len(buckets), "batch_equal": True,
          "batch_check_s": batch_s, "matches_plain": True})


def serve_histories(seed: int) -> list:
    """The daemon cell's submissions: (client, weight, history, valid),
    80 % linearizable, each of 1, 2 or 4 keys of three writes and a read
    (an impossible read in the rest), as bench.py builds them."""
    import random

    rng = random.Random(seed + 4242)
    out = []
    for i in range(SERVE_HISTORIES):
        good = rng.random() < 0.8
        hist, t = [], 0
        for k in range(rng.choice((1, 2, 4))):
            key = f"k{i}.{k}"
            for val in (1, 2, 3):
                hist.append({"process": k, "type": "invoke", "f": "write",
                             "value": [key, val], "time": t})
                hist.append({"process": k, "type": "ok", "f": "write",
                             "value": [key, val], "time": t + 1})
                t += 2
            hist.append({"process": k, "type": "invoke", "f": "read",
                         "value": [key, None], "time": t})
            hist.append({"process": k, "type": "ok", "f": "read",
                         "value": [key, 3 if good else 99], "time": t + 1})
            t += 2
        out.append((f"client-{i % SERVE_CLIENTS}",
                    1 + (i % SERVE_CLIENTS == 0), hist, good))
    return out


def serve_run(kernels, subs, cell: str, expect) -> dict:
    """The submissions through an in-process `VerdictDaemon` (a fresh
    queue under TMPDIR, the registry on the card): submit all, wait for
    every verdict; the path's counts reset before and read after, every
    search it launched replayed."""
    import tempfile

    from jepsen_tpu_torch.serve import DurableQueue, EngineRegistry
    from jepsen_tpu_torch.serve.daemon import VerdictDaemon

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as td:
        q = DurableQueue(td)
        dm = VerdictDaemon(q, EngineRegistry())

        def drive():
            dm.start()
            ids = [q.submit(c, "register", h, weight=w)
                   for c, w, h, _ in subs]
            return [q.wait_for_verdict(j, timeout=600) for j in ids]

        try:
            verdicts, wall, seen = run_path(kernels, drive)
        finally:
            dm.draining.set()
            dm.join(timeout=60)
    assert not dm.faulted, dm.last_fault
    for (_, _, _, good), v in zip(subs, verdicts):
        assert v is not None and v["valid"] is good, (good, v)
    launches = {k: v[0] for k, v in seen.items()}
    if expect is not None:
        for k in kernels:
            assert (launches[k.name] > 0) == (k.name in expect), (
                cell, launches)
    passes = replay(kernels, seen, cell)
    ops = sum(len(h) for _, _, h, _ in subs)
    kernel_ms = sum(v[1] for v in seen.values())
    return {"histories": len(subs), "ops": ops, "wall_s": wall,
            "ops_per_s": ops / wall,
            "launches": {k: v for k, v in launches.items() if v},
            "lanes_per_launch": [p["lanes"] for p in passes.get(
                "wgl_vec", [])],
            "kernel_ms": kernel_ms,
            "device_idle": 1 - kernel_ms / 1000 / wall,
            "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v}}


def bundle_ensure(td: str) -> dict:
    """`EngineBundle(td).ensure()` in a fresh process on the card: its
    result's warm flag, elapsed seconds and buckets, and the process's
    wall seconds."""
    code = ("import json, sys\n"
            "from jepsen_tpu_torch.serve.bundle import EngineBundle\n"
            "r = EngineBundle(sys.argv[1]).ensure()\n"
            "print(json.dumps({'warm': r['warm'], 'ensure_s': "
            "r['elapsed_s'], 'buckets': r['manifest']['buckets']}))\n")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code, td], cwd=HERE,
                         env={**os.environ, "PYTHONPATH": HERE},
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-2000:]
    return {**json.loads(out.stdout.strip().splitlines()[-1]),
            "process_s": wall}


def bundle_warm(kernels, ck) -> dict:
    """The bundle's warm pass in this process, as a main path (counts
    reset before, read after): each of K1, K5 and K2 launched once at
    n_pad 32 and once at 64, K3 once a pad (closure_word at 32, unpack,
    the product and the threshold pass at 64); every search replayed
    through `compare`, every closure bucket through `replay_closure`."""
    import tempfile

    from jepsen_tpu_torch.serve import EngineBundle, bundle

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bundle_") as td:
        out, wall, seen = run_path(kernels, EngineBundle(td).ensure)
    assert out["warm"] is False, out["warm"]
    assert out["manifest"]["buckets"] == bundle.DEFAULT_BUCKETS
    launches = {k: v[0] for k, v in seen.items()}
    for name in ("wgl_vec", "wgl_row", "wgl_search"):
        assert launches[name] == 2, launches
    passes = replay(kernels, seen, "serve_bundle_warm")
    buckets = replay_closure(ck, seen["unpack"][2])
    closure_cell(ck, "serve_bundle_warm", seen, buckets)
    return {"wall_s": wall, "ensure_s": out["elapsed_s"],
            "launches": {k: v for k, v in launches.items() if v},
            "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v},
            "closure_buckets": [(b["p"], b["rounds"]) for b in buckets]}


def serve_sacrifice(args) -> dict:
    """A cycle job that a dead daemon blamed (its attempt charged and
    in flight, then the queue reopened) runs last, in `python -m
    jepsen_tpu_torch.serve.sacrifice` on the card: K3 from the libraries
    this run built, its verdict committed by the child and absorbed by
    the daemon (G1c and G-single, as the batch check says)."""
    import tempfile

    from jepsen_tpu_torch.serve import DurableQueue, EngineRegistry, daemon

    hist = sacrifice_job(args.seed)
    saved = daemon.SUSPECT_BACKOFF_S
    daemon.SUSPECT_BACKOFF_S = 0.0
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sacr_") as td:
            q = DurableQueue(td)
            jid = q.submit("blamed", "cycle", hist)
            q.begin_attempts([jid])
            q = DurableQueue(td)
            assert q.suspect_ids() == [jid], q.suspect_ids()
            dm = daemon.VerdictDaemon(q, EngineRegistry())
            t0 = time.perf_counter()
            dm.start()
            try:
                v = q.wait_for_verdict(jid, timeout=300)
            finally:
                dm.draining.set()
                dm.join(timeout=60)
            wall = time.perf_counter() - t0
            attempts = q.attempts_of(jid)
    finally:
        daemon.SUSPECT_BACKOFF_S = saved
    assert not dm.faulted, dm.last_fault
    assert v is not None and v["valid"] is False, v
    assert v["anomaly-types"] == ["G1c", "G-single"], v["anomaly-types"]
    return {"ops": len(hist), "wall_s": wall, "attempts": attempts,
            "anomaly-types": v["anomaly-types"]}


def sacrifice_job(seed: int) -> list:
    """The blamed cycle job of `serve_sacrifice` and
    `sacrifice_in_process`: 400 list-append ops as the queue holds
    them."""
    from jepsen_tpu_torch.workloads import list_append

    return [o.to_dict() for o in list_append.simulate(400, seed=seed)]


def sacrifice_in_process(kernels, ck, seed: int) -> dict:
    """The sacrificial child's check (`sacrifice.run_one`) of the blamed
    job in this process on the card, as a main path (counts reset
    before, read after; every closure bucket replayed through
    `replay_closure`): the launches the child of `serve_sacrifice`
    makes on the same job, which that subprocess cannot report."""
    import tempfile

    from jepsen_tpu_torch.serve import DurableQueue, sacrifice

    hist = sacrifice_job(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sacr_") as td:
        jid = DurableQueue(td).submit("blamed", "cycle", hist)
        code, wall, seen = run_path(kernels,
                                    lambda: sacrifice.run_one(td, jid))
        v = DurableQueue(td).verdict(jid)
    assert code == 0, code
    assert v is not None and v["anomaly-types"] == ["G1c", "G-single"], v
    assert not any(seen[k.name][0] for k in wgl(kernels)), seen
    buckets = replay_closure(ck, seen["unpack"][2])
    closure_cell(ck, "serve_sacrifice", seen, buckets)
    return {"wall_s": wall,
            "launches": {k: v[0] for k, v in seen.items() if v[0]},
            "closure_buckets": [(b["p"], b["rounds"]) for b in buckets],
            "matches_plain": True}


def watch_in_process(kernels, ck, fixtures: str, expected: dict) -> dict:
    """`run_watch` on the three EDN fixtures in this process on the card,
    with the options the `watch` subprocesses get, as a main path
    (counts reset before, read after; every search replayed through
    `compare`, every closure bucket through `replay_closure`): the
    launches those subprocesses make, which they cannot report. Each
    return code and last streamed verdict as expected.json says.
    run_watch installs a SIGTERM handler of its own; this script's is
    put back after it."""
    import io
    import signal

    from jepsen_tpu_torch.online.watch import run_watch

    def drive():
        out = {}
        for name, exp in sorted(expected.items()):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = run_watch({"trace": os.path.join(fixtures, name),
                                  "workload": exp["workload"],
                                  "window": 16})
            out[name] = (code, buf.getvalue())
        return out

    saved = signal.getsignal(signal.SIGTERM)
    try:
        res, wall, seen = run_path(kernels, drive)
    finally:
        signal.signal(signal.SIGTERM, saved)
    for name, (code, out) in res.items():
        want = 1 if expected[name]["valid"] is False else 0
        assert code == want, (name, code)
        last = json.loads(out.strip().splitlines()[-1])
        assert last["valid"] == expected[name]["valid"], (name, last)
    passes = replay(kernels, seen, "serve_watch")
    buckets = replay_closure(ck, seen["unpack"][2])
    closure_cell(ck, "serve_watch", seen, buckets)
    return {"wall_s": wall,
            "exits": {name: code for name, (code, _) in res.items()},
            "launches": {k: v[0] for k, v in seen.items() if v[0]},
            "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v},
            "closure_buckets": [(b["p"], b["rounds"]) for b in buckets],
            "matches_plain": True}


def phase_serve_daemon(args, kernels, ck) -> None:
    """The daemon cell with every bar at 1 (each pack through K1) and
    beside it with the measured bars; the bundle's warm pass in this
    process (`bundle_warm`); a blamed job through the sacrificial
    subprocess (`serve_sacrifice`) and the child's check in this process
    (`sacrifice_in_process`); `run_watch` on the three EDN fixtures in
    this process (`watch_in_process`); then the bundle's ensure() in two
    fresh processes (stale, then warm), while `python -m
    jepsen_tpu_torch watch` runs on the three EDN fixtures on the card,
    each exit code as expected.json says. The subprocesses show the
    entry points' exit codes and verdicts; their launches are held in
    the in-process runs of the same work."""
    import tempfile

    subs = serve_histories(args.seed)
    with card_bars(1):
        card = serve_run(kernels, subs, "serve_daemon", ("wgl_vec",))
    auto = serve_run(kernels, subs, "serve_daemon_auto", None)
    warm_pass = bundle_warm(kernels, ck)
    sacrificed = serve_sacrifice(args)
    child = sacrifice_in_process(kernels, ck, args.seed)
    fixtures = os.path.join(HERE, "tests", "fixtures", "edn")
    with open(os.path.join(fixtures, "expected.json")) as f:
        expected = json.load(f)
    watched = watch_in_process(kernels, ck, fixtures, expected)
    env = {**os.environ, "PYTHONPATH": HERE}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "watch",
         os.path.join(fixtures, name), "--workload", exp["workload"],
         "--window", "16"], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, exp in sorted(expected.items())}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bundle_") as td:
            stale = bundle_ensure(td)
            warm = bundle_ensure(td)
        watch = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            want = 1 if expected[name]["valid"] is False else 0
            assert p.returncode == want, (name, p.returncode, err[-2000:])
            last = json.loads(out.strip().splitlines()[-1])
            assert last["valid"] == expected[name]["valid"], (name, last)
            watch[name] = {"exit": p.returncode, "last": last}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert stale["warm"] is False and warm["warm"] is True, (stale, warm)
    emit({"phase": "serve_daemon", "nvidia_smi": args.smi,
          "bars_1": card, "measured_bars": auto,
          "bundle": {"in_process": warm_pass, "stale": stale,
                     "warm": warm},
          "sacrifice": {**sacrificed, "in_process": child},
          "watch": {**watch, "in_process": watched},
          "subprocess_wall_s": time.perf_counter() - t0})


def phase_online(args, kernels, ck) -> None:
    phase_online_register_stream(args, kernels)
    phase_online_cycle_abort(args, kernels, ck)


# -- the multi-device engines over a repeated device list ---------------

# how many ways each engine is dealt: ["cuda:0"] * n (3 leaves empty
# lanes in K2's chunks and pads K1's 16 blocks to 18)
MESH_WAYS = (2, 3)
# register keys and invocations a key (half of main_register's keys)
MESH_KEYS = 2048
MESH_INVOCATIONS = 64


@contextlib.contextmanager
def mesh_route(n: int, lanes_min: int | None = None):
    """For the duration, `device.devices()` (every CUDA device) lists
    ["cuda:0"] * n, so the mesh routes open on one card and deal it n
    ways as they would deal n cards; with `lanes_min`, the WGL route's
    bar is pinned to it (JEPSEN_TPU_TORCH_MESH_LANES_MIN). Yields the
    list."""
    from jepsen_tpu_torch import device

    saved = device.devices
    listed = saved(["cuda:0"] * n)
    env = "JEPSEN_TPU_TORCH_MESH_LANES_MIN"
    env_saved = os.environ.get(env)
    device.devices = lambda spec=None: listed if spec is None \
        else saved(spec)
    if lanes_min is not None:
        os.environ[env] = str(lanes_min)
    try:
        yield listed
    finally:
        device.devices = saved
        if env_saved is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = env_saved


class MeshClosureKernel(ClosureKernel):
    """K3's row blocks: the unpack and threshold-pass launches of the
    sharded fixpoint, counted together (the product is torch.matmul)."""

    NAMES = ("unpack", "or_threshold_pack")

    def collect(self) -> tuple:
        return (sum(self.mod.LAUNCHES[n] for n in self.NAMES),
                sum(a.elapsed_time(b) for n, a, b in self.mod.TIMED
                    if n in self.NAMES),
                self.mod.CAPTURE)


def mesh_line(mk, cell, wall, one_wall, seen, **fields) -> dict:
    """A WGL mesh cell's printed line: the dealt wall against the
    one-device wall, the shards' launches, their kernel ms replayed,
    plain ms, bound and share."""
    c = mk.cells[cell]
    return {"phase": cell, "wall_s": wall, "one_device_wall_s": one_wall,
            "launches": seen[mk.name][0], "kernel_ms": c["kernel_ms"],
            "path_kernel_ms": c["path_kernel_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "bound_share": c["bound_ms"] / c["kernel_ms"],
            "per_launch": c["per_launch"], "capped_lanes": c["capped_lanes"],
            "matches_one_device": True, "matches_plain": True, **fields}


def phase_mesh_k2(args, kernels, mk) -> None:
    """K2's deal through the `wgl_mesh` route of
    `independent.checker(linearizable(..., algorithm="gpu_search"))`:
    MESH_KEYS register lanes over ["cuda:0"] * 2 and
    * 3, and main_fifo_long's 16 invalid fifo lanes over * 3 (the route's
    bar pinned to 1 for them); each dealt run a main path whose launches
    (one a chunk) are replayed through the kernel and the plain version
    (fifo lanes past the cell's cap compared under it), its result dict
    field for field the one-device run's."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister, FIFOQueue
    from jepsen_tpu_torch.workloads.queue import queue_history
    from jepsen_tpu_torch.workloads.register import (interleave_keys,
                                                      keyed_history)

    search = next(k for k in kernels if k.name == "wgl_search")
    reg = keyed_history(MESH_KEYS, MESH_INVOCATIONS, n_process=5,
                        bad_every=8, seed=args.seed)
    fifo = interleave_keys(
        [queue_history(n_process=5, n_ops=1980, fifo=True,
                       seed=1000 * args.seed + s) for s in FIFO_SEEDS], 5)
    cells = [("register", CASRegister, reg, MESH_WAYS, None),
             ("fifo_long", FIFOQueue, fifo, (3,), 1)]
    for name, model, hist, ways, lanes_min in cells:
        def check():
            return independent.checker(linearizable(
                model(), algorithm="gpu_search")).check({}, hist, {})

        one, one_wall, seen1 = run_path([search], check)
        replay([search], seen1, f"mesh_k2_{name}_one_device")
        for n in ways:
            cell = f"mesh_k2_{name}_x{n}"
            with mesh_route(n, lanes_min):
                res, wall, seen = run_path([mk], check)
            assert seen[mk.name][0] == n, (cell, seen[mk.name][0])
            replay([mk], seen, cell)
            assert normalise(res) == normalise(one), cell
            emit(mesh_line(mk, cell, wall, one_wall, seen, devices=n,
                           keys=len(res["results"]),
                           verdicts=verdict_counts(
                               r["valid"] for r in res["results"].values())))


def phase_mesh_k1(args, kernels, mk) -> None:
    """K1's block shards: MESH_KEYS register lanes (64 invocations,
    every 8th with an impossible first read; 16 blocks) through
    `wgl_vec.analysis_batch(..., devices=["cuda:0"] * n)`, n 2 and 3 (3
    pads the blocks to 18), each a main path whose shard
    launches are replayed through the kernel and the plain version, its
    results (verdict, steps, op, best linearization) the one-device
    run's."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.history import entries
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.ops import wgl_vec
    from jepsen_tpu_torch.workloads.register import keyed_history

    vec = next(k for k in kernels if k.name == "wgl_vec")
    hist = keyed_history(MESH_KEYS, MESH_INVOCATIONS, n_process=5,
                         bad_every=8, seed=args.seed)
    subs = independent._split(hist, list(range(MESH_KEYS)))
    ess = [entries(subs[k]) for k in range(MESH_KEYS)]
    model = CASRegister()
    one, one_wall, seen1 = run_path(
        [vec], lambda: wgl_vec.analysis_batch(model, ess))
    replay([vec], seen1, "mesh_k1_register_one_device")
    for n in MESH_WAYS:
        cell = f"mesh_k1_register_x{n}"
        devs = ["cuda:0"] * n
        res, wall, seen = run_path(
            [mk], lambda: wgl_vec.analysis_batch(model, ess, devices=devs))
        assert seen[mk.name][0] == n * seen1[vec.name][0], (cell, seen)
        replay([mk], seen, cell)
        assert res == one, cell
        emit(mesh_line(mk, cell, wall, one_wall, seen, devices=n,
                       blocks=sum(la[0].shape[1] for la in
                                  seen[mk.name][2][:n]) // wgl_vec.LANES,
                       verdicts=verdict_counts(r.valid for r in res)))


def replay_closure_mesh(mk, captured, devs) -> list:
    """Every captured bucket fixpoint run again with its rows dealt over
    `devs`, each shard launch checked as it runs: its unpack (once, and
    of the gathered words each round) and threshold pass against the
    plain version on the same inputs (words, flag and refreshed operand
    bit for bit), each timed behind the GPU spin with its bound (bytes
    read and written once over HBM bandwidth, 16 operand bytes a gained
    byte, of the real rows only: the zero rows that pad the shards are
    not the function's work); then the closed words and the rounds against
    `_closure_block_mesh_plain` and the words against `closure_block` on
    one device. Returns per bucket: pad size, batch, rounds, and per
    kernel its launches, ms, plain ms and bound."""
    import torch

    from jepsen_tpu_torch.device import devices
    from jepsen_tpu_torch.ops import closure as cl

    devs = devices(devs)
    out = []
    for words0, p, rounds in captured:
        words0 = words0.to(devs[0])
        figs = {n: {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "t_bytes": 0.0}
                for n in MeshClosureKernel.NAMES}

        def add(name, ms, plain_ms, nbytes):
            f = figs[name]
            f["launches"] += 1
            f["ms"] += ms
            f["plain_ms"] += plain_ms
            f["t_bytes"] += nbytes / HBM_BYTES_PER_S

        def real(w):
            # the real rows of `w` (a shard, or every shard gathered) per
            # row it holds: the bound counts no padding row
            return real_rows.get(w.data_ptr(), p) / w.shape[1]

        def unpack_fn(w, p):
            ms, got = spin_ms(cl, lambda: cl.unpack(w, p), "unpack")
            p_ms, want = cuda_ms(lambda: cl.unpack_plain(w, p))
            held(mk, f"p {p} unpack {tuple(w.shape)}", (got,), (want,))
            add("unpack", ms, p_ms,
                (4 * w.numel() + 2 * got.numel()) * real(w))
            return got

        def otp_fn(prod, words, flag, out, operand):
            op_p, flag_p = operand.clone(), flag.clone()
            p_ms, new_p = cuda_ms(lambda: cl.or_threshold_pack_plain(
                prod, words, flag_p, operand=op_p))
            # the pass writes the same operand chunks with the same
            # values every launch, so it is timed on `operand` itself
            ms, new = spin_ms(cl, lambda: cl.or_threshold_pack(
                prod, words, flag, operand=operand), "or_threshold_pack")
            held(mk, f"p {p} pass {tuple(words.shape)}",
                 (new, flag, operand), (new_p, flag_p, op_p))
            gained = int((words.view(torch.uint8)
                          != new.view(torch.uint8)).sum())
            add("or_threshold_pack", ms, p_ms, (2 * prod.numel()
                + 8 * words.numel()) * real(words) + 4 + 16 * gained)
            out.copy_(new)
            return out

        shards = cl._mesh_shards(words0, p, devs)
        r = cl.shard_rows(p, len(devs))
        real_rows = {w.data_ptr(): max(0, min(r, p - k * r))
                     for k, w in enumerate(shards)}
        ran = cl._squaring(shards, p, rounds, unpack_fn, otp_fn)
        got = cl._mesh_gather(shards, p, devs[0])
        want, ran_p = cl._closure_block_mesh_plain(words0, p, devs)
        held(mk, f"p {p} fixpoint", (got,), (want,))
        assert ran == ran_p, (p, ran, ran_p)
        held(mk, f"p {p} one device", (got,), (cl.closure_block(words0, p),))
        bucket = {"p": p, "b": words0.shape[0], "devices": len(devs),
                  "shard_rows": r, "rounds": ran}
        for name, f in figs.items():
            b_ms, b_by = bound_ms(f.pop("t_bytes"), 0.0)
            bucket[name] = {**f, "bound_ms": b_ms, "bound_by": b_by}
        out.append(bucket)
    return out


def mesh_closure_figs(buckets) -> dict:
    """Launches, ms, plain ms and bound of K3's shard launches summed
    over replayed buckets."""
    f = {k: sum(bk[n][k] for bk in buckets for n in MeshClosureKernel.NAMES)
         for k in ("launches", "ms", "plain_ms", "bound_ms")}
    f["bound_share"] = f["bound_ms"] / f["ms"] if f["ms"] else None
    return f


def phase_mesh_k3(args, kernels, mk) -> None:
    """K3's row blocks: the cycle checker's main path on cycle_append
    (5,000 ops, G1c and G-single) through the `closure_mesh` route over
    ["cuda:0"] * 2 and * 3 (its giant component is past `mesh_min_n`, so
    the whole batch, the one-word bucket too, is sharded), its dict the
    host DFS engine's and its launches the fixpoint's (unpack once a
    shard and once a round a shard, the threshold pass and the product
    once a round a shard); every bucket replayed shard launch by shard
    launch (`replay_closure_mesh`). Then cycle_append_20k's captured
    buckets (its run in the cycle phase, or one run here) dealt 2 and 3
    ways the same way: the kernel ms, bound and share of the K3 mesh
    row."""
    from jepsen_tpu_torch.checker import cycle
    from jepsen_tpu_torch.ops import closure
    from jepsen_tpu_torch.workloads import list_append

    hist = list_append.simulate(5000, seed=args.seed,
                                inject=("G1c", "G-single"))
    t0 = time.perf_counter()
    host = cycle.checker(engine="host").check({}, hist, {})
    host_s = time.perf_counter() - t0
    for n in MESH_WAYS:
        cell = f"mesh_k3_cycle_append_x{n}"
        with mesh_route(n) as devs:
            res, wall, seen = run_path(
                [mk], lambda: cycle.checker().check({}, hist, {}))
        assert normalise(res) == normalise(host), cell
        buckets = replay_closure_mesh(mk, seen[mk.name][2], devs)
        want = sum(n * (1 + 2 * bk["rounds"]) for bk in buckets)
        assert seen[mk.name][0] == want, (cell, seen[mk.name][0], want)
        figs = mesh_closure_figs(buckets)
        mk.cells[cell] = {"launches": seen[mk.name][0],
                          "path_kernel_ms": seen[mk.name][1], **figs}
        emit({"phase": cell, "devices": n, "wall_s": wall,
              "host_dfs_wall_s": host_s, "launches": seen[mk.name][0],
              "path_kernel_ms": seen[mk.name][1], **figs,
              "buckets": buckets, "anomaly-types": res["anomaly-types"],
              "matches_host": True, "matches_plain": True})
    captured = CYCLE_CAPTURE.get("cycle_append_20k")
    one_wall = None
    if captured is None:
        big = list_append.simulate(20000, seed=args.seed,
                                   inject=("G1c", "G-single"))
        closure.CAPTURE = []
        t0 = time.perf_counter()
        cycle.checker().check({}, big, {})
        one_wall = time.perf_counter() - t0
        captured, closure.CAPTURE = closure.CAPTURE, None
    for n in MESH_WAYS:
        cell = f"mesh_k3_20k_buckets_x{n}"
        t0 = time.perf_counter()
        buckets = replay_closure_mesh(mk, captured, ["cuda:0"] * n)
        figs = mesh_closure_figs(buckets)
        mk.cells[cell] = figs
        if mk.ms is None and n == MESH_WAYS[0]:
            mk.ms, mk.plain_ms = figs["ms"], figs["plain_ms"]
            mk.bound_ms, mk.bound_by = figs["bound_ms"], "bytes"
            mk.shape = (f"{cell}: " + ", ".join(
                f"[{bk['b']}, {bk['p']}, {bk['p']}] over {n}"
                for bk in buckets))
        emit({"phase": cell, "devices": n, "replay_s":
              time.perf_counter() - t0, "one_device_check_s": one_wall,
              **figs, "buckets": buckets, "matches_one_device": True,
              "matches_plain": True})


def phase_mesh_doctor(args, kernels, mk3) -> None:
    """`doctor.diagnose(devices=["cuda:0"] * 2)` as a main path: it must
    be ok; its K1 and K2 launches (per device and dealt) are replayed
    through the kernel and the plain version, its closure buckets shard
    launch by shard launch."""
    from jepsen_tpu_torch import doctor

    vec = next(k for k in kernels if k.name == "wgl_vec")
    search = next(k for k in kernels if k.name == "wgl_search")
    devs = ["cuda:0"] * 2
    report, wall, seen = run_path([vec, search, mk3],
                                  lambda: doctor.diagnose(devices=devs))
    assert report["ok"], report
    passes = replay([vec, search], seen, "mesh_doctor")
    buckets = replay_closure_mesh(mk3, seen[mk3.name][2], devs)
    emit({"phase": "mesh_doctor", "wall_s": wall, "report": report,
          "launches": {k: v[0] for k, v in seen.items()},
          "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v},
          "closure_buckets": [(b["p"], b["rounds"]) for b in buckets],
          "matches_plain": True})


def phase_mesh(args, kernels, meshk) -> None:
    """K2's deal, K1's block shards, K3's row blocks and the doctor,
    over ["cuda:0"] repeated (module docstring)."""
    t0 = time.perf_counter()
    phase_mesh_k2(args, kernels, meshk["K2 deal"])
    phase_mesh_k1(args, kernels, meshk["K1 mesh"])
    phase_mesh_k3(args, kernels, meshk["K3 mesh"])
    phase_mesh_doctor(args, kernels, meshk["K3 mesh"])
    emit({"phase": "mesh", "wall_s": time.perf_counter() - t0})


# -- the checkers that reach K3 through the cycle checker, the host
# checkers, analyze and fuzz ---------------------------------------------

# clients of every checker history, and the share of completions :info
CHECKER_CLIENTS = 5
CHECKER_INFO = 0.08
# every PLANT_EVERY-th key (adya, causal) or group (long_fork) is bad
PLANT_EVERY = 64
ADYA_KEYS = 8192
LONG_FORK_KEYS = 4096
CAUSAL_KEYS = 512
# keys of causal's history checked by spawned workers, and the workers
CAUSAL_PROCESS_KEYS = 64
CAUSAL_WORKERS = 2


def adya_history(n_keys: int, seed: int) -> list:
    """Insert pairs shaped like the JAX package's g2_gen (adya.py:32-54):
    per key two inserts by two of CHECKER_CLIENTS clients, both in
    flight at once, one into table b ((None, id)) and one into table a
    ((id, None)), ids unique over the history; one commits and the other
    fails, but on every PLANT_EVERY-th key both commit (a G2). Outside
    the planted keys CHECKER_INFO of the completions are :info. Values
    are KVTuple(key, (a_id, b_id))."""
    import random

    from jepsen_tpu_torch.history import Op, index
    from jepsen_tpu_torch.independent import tuple_

    rng = random.Random(seed)
    out = []
    for k in range(n_keys):
        procs = rng.sample(range(CHECKER_CLIENTS), 2)
        vals = [tuple_(k, (None, 2 * k + 1)), tuple_(k, (2 * k + 2, None))]
        winner = rng.randrange(2)
        planted = k % PLANT_EVERY == 0
        out += [Op(p, "invoke", "insert", v) for p, v in zip(procs, vals)]
        for i in rng.sample(range(2), 2):
            typ = "ok" if planted or i == winner else "fail"
            if not planted and rng.random() < CHECKER_INFO:
                typ = "info"
            out.append(Op(procs[i], typ, "insert", vals[i]))
    return [o.with_(time=o.index) for o in index(out)]


def long_fork_history(n_keys: int, seed: int, n: int = 2) -> list:
    """Ops shaped like the JAX package's LongForkGen (long_fork.py:66-103)
    over CHECKER_CLIENTS clients: a client writes the next key ([["w", k,
    1]]), then reads that key's group (each of its n keys, shuffled);
    with no read-back due, it first reads, with probability 0.5, a group
    another client has in flight. Clients interleave at random against
    a serializable store: a write takes effect as it completes, and a
    read sees the writes completed before it (no fork). CHECKER_INFO of
    the completions are :info (such a write never takes effect), but
    not the writes of every PLANT_EVERY-th group, which gets a fork
    after the run: two reads, each seeing one of its first two writes
    and not the other."""
    import random

    from jepsen_tpu_torch.history import Op, index

    rng = random.Random(seed)
    applied: set = set()
    pending: dict = {}   # client -> its open op
    mine: dict = {}      # client -> key whose group it reads back next
    done: set = set()
    nxt = 0
    out = []

    def group_read(k):
        lo = k - k % n
        ks = list(range(lo, lo + n))
        rng.shuffle(ks)
        return [["r", x, None] for x in ks]

    def planted_key(k):
        return (k // n) % PLANT_EVERY == 0

    while len(done) < CHECKER_CLIENTS:
        c = rng.choice([x for x in range(CHECKER_CLIENTS) if x not in done])
        if c in pending:
            o = pending.pop(c)
            info = rng.random() < CHECKER_INFO
            if o.f == "write":
                k = o.value[0][1]
                if info and not planted_key(k):
                    out.append(o.with_(type="info"))
                    continue
                applied.add(k)
                out.append(o.with_(type="ok"))
            elif info:
                out.append(o.with_(type="info"))
            else:
                out.append(o.with_(type="ok", value=[
                    ["r", x, 1 if x in applied else None]
                    for _, x, _ in o.value]))
            continue
        if mine.get(c) is not None:
            o = Op(c, "invoke", "read", group_read(mine.pop(c)))
        else:
            active = [k for x, k in mine.items() if k is not None]
            if active and rng.random() < 0.5:
                o = Op(c, "invoke", "read", group_read(rng.choice(active)))
            elif nxt < n_keys:
                mine[c] = nxt
                o = Op(c, "invoke", "write", [["w", nxt, 1]])
                nxt += 1
            else:
                done.add(c)
                continue
        pending[c] = o
        out.append(o)
    for g in range(0, n_keys // n, PLANT_EVERY):
        a, b = g * n, g * n + 1
        for seen in (a, b):
            c = rng.randrange(CHECKER_CLIENTS)
            txn = group_read(a)
            out.append(Op(c, "invoke", "read", txn))
            out.append(Op(c, "ok", "read", [
                ["r", x, 1 if x == seen else None] for _, x, _ in txn]))
    return [o.with_(time=o.index) for o in index(out)]


def causal_history(n_keys: int, seed: int) -> list:
    """Ops shaped like the JAX package's causal generator
    (causal.py:107-128): one worker a key runs ri w1 r w2 r (read-init,
    write 1, read, write 2, read) against a causally consistent
    register, CHECKER_CLIENTS workers at a time, interleaved at random,
    each op carrying its site position and the link to the last position
    its worker saw ("init" for a key's first op). CHECKER_INFO of the
    reads complete :info (an :info write would break the counter order
    the reference's model folds over, so writes complete ok). On every
    PLANT_EVERY-th key the last read is stale, and ok: 1 after w2.
    Values are KVTuple(key, value)."""
    import random

    from jepsen_tpu_torch.history import Op, index
    from jepsen_tpu_torch.independent import tuple_

    rng = random.Random(seed)
    script = [("read-init", None, 0), ("write", 1, 1), ("read", None, 1),
              ("write", 2, 2), ("read", None, 2)]
    work: dict = {}   # worker -> [key, step, link, open op or None]
    nxt = 0
    pos = 0
    out = []
    while nxt < n_keys or work:
        free = [w for w in range(CHECKER_CLIENTS) if w not in work]
        if free and nxt < n_keys:
            work[rng.choice(free)] = [nxt, 0, "init", None]
            nxt += 1
            continue
        w = rng.choice(sorted(work))
        st = work[w]
        k, step, link, o = st
        f, v_in, v_out = script[step]
        if o is None:
            pos += 1
            st[3] = Op(w, "invoke", f, tuple_(k, v_in),
                       extra={"position": pos, "link": link})
            out.append(st[3])
            continue
        stale = step == 4 and k % PLANT_EVERY == 0
        if stale:
            v_out = 1
        if f != "write" and not stale and rng.random() < CHECKER_INFO:
            out.append(o.with_(type="info"))
        else:
            out.append(o.with_(type="ok", value=tuple_(k, v_out)))
            st[2] = o.extra["position"]
        st[1], st[3] = step + 1, None
        if st[1] == len(script):
            del work[w]
    return [o.with_(time=o.index) for o in index(out)]


def bank_setfull_histories() -> tuple:
    """The JAX package's bank-setfull config (bench.py:403-465): 6,000
    bank ops over 8 accounts (30 % whole-state reads, else transfers that
    fail when the balance is short) with its test map, and 5,000
    set-full adds by 5 clients with a whole-set read every 50."""
    import random

    from jepsen_tpu_torch.history import Op

    rng = random.Random(3)
    accounts = list(range(8))
    balances = {a: 10 for a in accounts}
    hist = []
    t = 0
    for i in range(6000):
        p = i % 5
        if rng.random() < 0.3:
            hist.append(Op(p, "invoke", "read", None, time=t, index=t))
            t += 1
            hist.append(Op(p, "ok", "read", dict(balances), time=t, index=t))
        else:
            frm, to = rng.sample(accounts, 2)
            amt = 1 + rng.randrange(5)
            v = {"from": frm, "to": to, "amount": amt}
            hist.append(Op(p, "invoke", "transfer", v, time=t, index=t))
            t += 1
            if balances[frm] - amt >= 0:
                balances[frm] -= amt
                balances[to] += amt
                hist.append(Op(p, "ok", "transfer", v, time=t, index=t))
            else:
                hist.append(Op(p, "fail", "transfer", v, time=t, index=t))
        t += 1
    test_map = {"accounts": accounts, "total_amount": 80, "max_transfer": 5}
    sf_hist = []
    present = []
    t = 0
    for i in range(5000):
        p = i % 5
        sf_hist.append(Op(p, "invoke", "add", i, time=t, index=t))
        t += 1
        present.append(i)
        sf_hist.append(Op(p, "ok", "add", i, time=t, index=t))
        t += 1
        if i % 50 == 49:
            sf_hist.append(Op(p, "invoke", "read", None, time=t, index=t))
            t += 1
            sf_hist.append(Op(p, "ok", "read", list(present), time=t,
                              index=t))
            t += 1
    return hist, test_map, sf_hist


# closure_word buckets of a cell replayed through replay_closure (its
# median of SPIN_REPS launches, the plain version's time, the floor); the
# others are timed once each behind the spin (`replay_closures`)
TIMED_WORD_BUCKETS = 4
# the analyze cell's single register history (main_long's keys' size:
# past wgl_vec's 1024 entries, so wgl_row)
ANALYZE_SINGLE_INVOCATIONS = 3000
FUZZ_CMD_ROUNDS = 2
FUZZ_CMD_CLUSTERS = 256
K3_NAMES = ("closure_word", "unpack", "matmul", "or_threshold_pack")


def empty_launch_ms(reps: int = SPIN_REPS) -> float:
    """Median ms of an empty kernel's launch on the card (the spin with 0
    cycles, torch.cuda._sleep(0)), each timed with CUDA events behind a
    SPIN_CYCLES spin: the launch floor of any kernel."""
    import torch

    times = []
    for _ in range(reps + 1):
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(0)
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times[1:])
    return ms[len(ms) // 2]


def replay_closures(ck, captured) -> dict:
    """Every bucket fixpoint of a checkers cell replayed bit for bit: the
    first TIMED_WORD_BUCKETS one-word buckets and every wider bucket
    through `replay_closure` (each launch's median ms behind the spin,
    round by round, the plain versions timed, the bound), the other
    one-word buckets through closure_word timed once behind the spin and
    held against closure_word_plain on the same words (closed words and
    rounds). Returns the (p, matrices) of every bucket and per kernel
    its launches replayed, ms summed over them, and the plain ms and
    bound of the launches replay_closure timed."""
    cl = ck["unpack"].mod
    word = [c for c in captured if c[1] == cl.MIN_PAD]
    rows = replay_closure(ck, word[:TIMED_WORD_BUCKETS] + [
        c for c in captured if c[1] != cl.MIN_PAD])
    per: dict = {}
    for r in rows:
        for name in K3_NAMES:
            if name in r:
                f = per.setdefault(name, {"launches": 0, "ms": 0.0,
                                          "plain_ms": 0.0, "bound_ms": 0.0,
                                          "bound_by": r[name]["bound_by"]})
                f["launches"] += r[name]["launches"]
                for key in ("ms", "plain_ms", "bound_ms"):
                    f[key] += r[name][key] or 0.0
    for words0, p, rounds in word[TIMED_WORD_BUCKETS:]:
        w = words0.view(-1, 32)
        ms, got = spin_ms(cl, lambda: cl.closure_word(w, rounds),
                          "closure_word", reps=1)
        held(ck["closure_word"], f"p {p}", got,
             cl.closure_word_plain(w, rounds))
        f = per["closure_word"]
        f["launches"] += 1
        f["ms"] += ms
        f["plain_not_timed"] = f.get("plain_not_timed", 0) + 1
    return {"buckets": [(c[1], int(c[0].shape[0])) for c in captured],
            "per_kernel": per}


def checkers_cell(ck, cell, seen, closures, wall) -> dict:
    """Fold a checkers cell's closure launches into the K3 rows (its
    launches, the replayed figures; a row no earlier phase timed takes
    them) and return its line's figures, the device's idle share among
    them."""
    per = closures["per_kernel"]
    for name, k in ck.items():
        launched = seen[name][0]
        if not launched:
            continue
        f = per[name]
        assert f["launches"] == launched, (cell, name, f, launched)
        k.cells[cell] = {**f, "path_kernel_ms": seen[name][1]}
        if k.ms is None:
            k.ms, k.bound_ms, k.bound_by = f["ms"], f["bound_ms"], \
                f["bound_by"]
            k.plain_ms = None if k.library else f["plain_ms"]
            k.shape = f"{cell}: {launched} launches"
    words = [b for p, b in closures["buckets"] if p == 32]
    device_ms = sum(f["ms"] for f in per.values())
    return {"launches": {k: v[0] for k, v in seen.items() if v[0]},
            "closure_buckets": len(closures["buckets"]),
            "closure_word_batches": {
                "launches": len(words), "matrices": sum(words),
                "min": min(words, default=0), "max": max(words, default=0)},
            "wider_buckets": [(p, b) for p, b in closures["buckets"]
                              if p != 32],
            "k3": per, "device_ms": device_ms,
            "device_idle": 1 - device_ms / 1000 / wall,
            "matches_plain": True}


def checkers_adya(args, kernels, ck) -> dict:
    """adya_history(ADYA_KEYS) through `adya.g2_checker()` on the card:
    invalid, one illegal key and one G2 a planted key; the whole dict
    the same checker's on device="cpu"; the counts legacy=True's."""
    from jepsen_tpu_torch.workloads import adya

    h = adya_history(ADYA_KEYS, args.seed)
    res, wall, seen = run_path(kernels,
                               lambda: adya.g2_checker().check({}, h, {}))
    planted = ADYA_KEYS // PLANT_EVERY
    assert res["valid"] is False and res["illegal-count"] == planted, res
    assert res["anomaly-types"] == ["G2"], res["anomaly-types"]
    t0 = time.perf_counter()
    cpu = adya.g2_checker(device="cpu").check({}, h, {})
    cpu_s = time.perf_counter() - t0
    assert normalise(res) == normalise(cpu), "card != cpu"
    t0 = time.perf_counter()
    legacy = adya.g2_checker(legacy=True).check({}, h, {})
    legacy_s = time.perf_counter() - t0
    counts = ("key-count", "legal-count", "illegal-count", "illegal")
    assert {k: legacy[k] for k in counts} == {k: res[k] for k in counts}
    closures = replay_closures(ck, seen["unpack"][2])
    return {"keys": ADYA_KEYS, "ops": len(h), "wall_s": wall,
            "cpu_s": cpu_s, "legacy_s": legacy_s,
            "illegal-count": res["illegal-count"],
            "anomaly-types": res["anomaly-types"],
            **checkers_cell(ck, "checkers_adya_g2", seen, closures, wall)}


def checkers_long_fork(args, kernels, ck) -> dict:
    """long_fork_history(LONG_FORK_KEYS) through `long_fork.checker(2)`
    on the card: invalid with forks; the dict the same checker's on
    device="cpu"; its validity legacy=True's."""
    from jepsen_tpu_torch.workloads import long_fork

    h = long_fork_history(LONG_FORK_KEYS, args.seed)
    res, wall, seen = run_path(
        kernels, lambda: long_fork.checker(2).check({}, h, {}))
    assert res["valid"] is False and res["forks"], res["valid"]
    t0 = time.perf_counter()
    cpu = long_fork.checker(2, device="cpu").check({}, h, {})
    cpu_s = time.perf_counter() - t0
    assert normalise(res) == normalise(cpu), "card != cpu"
    t0 = time.perf_counter()
    legacy = long_fork.checker(2, legacy=True).check({}, h, {})
    legacy_s = time.perf_counter() - t0
    assert legacy["valid"] is res["valid"], legacy["valid"]
    closures = replay_closures(ck, seen["unpack"][2])
    return {"keys": LONG_FORK_KEYS, "groups": LONG_FORK_KEYS // 2,
            "ops": len(h), "wall_s": wall, "cpu_s": cpu_s,
            "legacy_s": legacy_s, "forks": len(res["forks"]),
            "legacy_forks": len(legacy["forks"]),
            "anomaly-types": res["anomaly-types"],
            **{k: res[k] for k in ("reads-count", "early-read-count",
                                   "late-read-count")},
            **checkers_cell(ck, "checkers_long_fork", seen, closures, wall)}


def checkers_causal(args, kernels, ck, h) -> tuple:
    """causal_history(CAUSAL_KEYS) through `causal.checker()` on the card
    (a key a thread, the causal replay and the cycle checker composed
    in two more): the planted keys fail; the dict the one on
    device="cpu". Returns the line and the card's dict."""
    from jepsen_tpu_torch.workloads import causal

    res, wall, seen = run_path(
        kernels, lambda: causal.checker().check({}, h, {}))
    want = list(range(0, CAUSAL_KEYS, PLANT_EVERY))
    assert sorted(res["failures"]) == want, res["failures"]
    t0 = time.perf_counter()
    cpu = causal.checker(device="cpu").check({}, h, {})
    cpu_s = time.perf_counter() - t0
    assert normalise(res) == normalise(cpu), "card != cpu"
    closures = replay_closures(ck, seen["unpack"][2])
    k3 = sum(seen[k][0] for k in ("closure_word", "unpack",
                                  "or_threshold_pack"))
    return {"keys": CAUSAL_KEYS, "ops": len(h), "wall_s": wall,
            "cpu_s": cpu_s, "failures": len(res["failures"]),
            "k3_launches_a_key": k3 / CAUSAL_KEYS,
            **checkers_cell(ck, "checkers_causal", seen, closures, wall)}


def checkers_causal_processes(args, kernels, ck, h) -> dict:
    """The first CAUSAL_PROCESS_KEYS keys of the causal history under
    independent.checker(causal's composed checker, processes=
    CAUSAL_WORKERS): spawned workers, each opening its own CUDA context
    (their device None resolved there), against the thread path on the
    same keys (a main path of its own, replayed). This process launches
    nothing on the process path; the workers' launches cannot be
    counted from here."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.workloads import causal

    sub = [o for o in h if not independent.is_tuple(o.value)
           or o.value.key < CAUSAL_PROCESS_KEYS]
    threads = causal.checker()
    want, t_wall, t_seen = run_path(kernels,
                                    lambda: threads.check({}, sub, {}))
    closures = replay_closures(ck, t_seen["unpack"][2])
    checkers_cell(ck, "checkers_causal_threads", t_seen, closures, t_wall)
    procs = independent.checker(threads.checker, processes=CAUSAL_WORKERS)
    got, wall, seen = run_path(kernels, lambda: procs.check({}, sub, {}))
    assert not any(v[0] for v in seen.values()), seen
    assert got == want, "processes != threads"
    return {"keys": CAUSAL_PROCESS_KEYS, "workers": CAUSAL_WORKERS,
            "wall_s": wall, "threads_wall_s": t_wall,
            "threads_launches": {k: v[0] for k, v in t_seen.items() if v[0]},
            "threads_closure_buckets": len(closures["buckets"]),
            "failures": len(got["failures"]), "equal_threads": True}


def checkers_bank_setfull(kernels) -> dict:
    """The bank-setfull config through bank.checker() and set_full() on
    the host: both valid, nothing launched."""
    from jepsen_tpu_torch.checker import set_full
    from jepsen_tpu_torch.workloads import bank

    hist, test_map, sf = bank_setfull_histories()
    (b, f), wall, seen = run_path(kernels, lambda: (
        bank.checker().check(test_map, hist, {}),
        set_full().check({}, sf, {})))
    assert b["valid"] is True and f["valid"] is True, (b["valid"],
                                                       f["valid"])
    assert not any(v[0] for v in seen.values()), seen
    return {"ops": len(hist) + len(sf), "wall_s": wall,
            "ops_per_s": (len(hist) + len(sf)) / wall,
            "bank_reads": b["read-count"], "set_stable": f["stable_count"]}


def results_files(root) -> dict:
    """Every results file under a store: relative path -> bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.startswith("results."):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def analyze_store(kernels, td, name, hist, chk, argv, test_fn) -> dict:
    """The run that writes a store (chk.check with the store dir, then
    the history, test and results saved as the runner saves them) and
    `single_test_cmd(test_fn)["analyze"]` over it on the card, a main
    path each: equal exit codes and results files (results.json and
    every results.edn), every launch of both replayed."""
    import datetime

    from jepsen_tpu_torch import cli, store

    test = {"name": name, "store_dir": td, "history": hist,
            "start_time": store.time_str(datetime.datetime.now())}
    res, w1, s1 = run_path(kernels, lambda: chk.check(test, hist, {}))
    test["results"] = res
    store.save_1(test)
    store.save_2(test)
    rc1 = 1 if res["valid"] is False else 0
    before = results_files(td)
    rc2, w2, s2 = run_path(kernels, lambda: cli.run_cli(
        cli.single_test_cmd(test_fn),
        ["analyze", "--store-dir", td, "--device", "cuda", *argv]))
    assert rc2 == rc1, (rc1, rc2)
    after = results_files(td)
    assert after == before, sorted(
        k for k in after if after[k] != before.get(k))
    out = {}
    for label, seen in (("run", s1), ("analyze", s2)):
        passes = replay(kernels, seen, f"checkers_analyze_{name}_{label}")
        out[label] = {"launches": {k: v[0] for k, v in seen.items()
                                   if v[0]},
                      "kernel_vs_plain": {k: len(v) for k, v in
                                          passes.items() if v}}
    return {"exit": rc1, "results_files": len(after), "run_wall_s": w1,
            "analyze_wall_s": w2, **out}


def checkers_analyze(args, kernels) -> dict:
    """`analyze` on two stores on the card: STORE_KEYS register keys
    x 64 invocations (every 8th key bad) written by the port's
    IndependentChecker with every bar at 1 (K1), analysed with the
    suite's checker (`--checker` would replace the per-key checker with
    one linearizable over the whole keyed history, in both packages);
    and one register history of ANALYZE_SINGLE_INVOCATIONS
    invocations written by linearizable() (K5), analysed with
    `--checker linearizable`."""
    import tempfile

    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.workloads.register import (keyed_history,
                                                     register_history)

    out = {}
    with card_bars(1), tempfile.TemporaryDirectory(
            prefix="chip_smoke_analyze_") as td:
        hist = keyed_history(STORE_KEYS, STORE_INVOCATIONS, n_process=5,
                             bad_every=8, seed=args.seed)
        out["register"] = analyze_store(
            kernels, os.path.join(td, "keyed"), "checkers_analyze", hist,
            independent.checker(linearizable(CASRegister(),
                                             algorithm="auto")), [],
            lambda o: {"name": "checkers_analyze", "checker":
                       independent.checker(linearizable(
                           CASRegister(), algorithm="auto",
                           device=o["device"]))})
        hist = register_history(n_process=5, n_ops=ANALYZE_SINGLE_INVOCATIONS,
                                seed=args.seed)
        out["single"] = analyze_store(
            kernels, os.path.join(td, "single"), "checkers_analyze_single",
            hist, linearizable(CASRegister()), ["--checker", "linearizable"],
            lambda o: {"name": "checkers_analyze_single",
                       "model": CASRegister()})
    assert out["register"]["exit"] == 1 and out["single"]["exit"] == 0
    assert out["register"]["analyze"]["launches"].get("wgl_vec")
    assert out["single"]["analyze"]["launches"].get("wgl_row")
    return out


def checkers_fuzz_cmd(args, kernels, ck, sim) -> dict:
    """`python -m jepsen_tpu_torch fuzz` in a subprocess on the card, the
    command in this process on the card (a main path: every sim launch
    held against sim_plain behind the spin, every closure bucket
    replayed) and with --device cpu: exit 0 each, corpus.json and
    anomalies.jsonl byte-identical."""
    import io
    import tempfile

    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.fuzz import loop

    argv = ["--rounds", str(FUZZ_CMD_ROUNDS), "--clusters",
            str(FUZZ_CMD_CLUSTERS), "--seed", str(args.seed)]

    def in_process(d, *extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.run_cli(cli.fuzz_cmd(),
                             ["fuzz", "--corpus-dir", d, *argv, *extra])
        return rc, json.loads(buf.getvalue())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fuzz_") as td:
        dirs = {k: os.path.join(td, k) for k in ("sub", "card", "cpu")}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch", "fuzz",
             "--corpus-dir", dirs["sub"], *argv], cwd=HERE,
            env={**os.environ, "PYTHONPATH": HERE}, capture_output=True,
            text=True, timeout=300)
        sub_s = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-3000:]
        with recorded_sim_batches() as batches:
            (rc, summary), wall, seen = run_path(
                kernels, lambda: in_process(dirs["card"]))
        t0 = time.perf_counter()
        rc_cpu, _ = in_process(dirs["cpu"], "--device", "cpu")
        cpu_s = time.perf_counter() - t0
        assert rc == rc_cpu == 0, (rc, rc_cpu)
        for f in (loop.STATE_FILE, loop.ANOMALIES_FILE):
            blobs = set()
            for d in dirs.values():
                with open(os.path.join(d, f), "rb") as fh:
                    blobs.add(fh.read())
            assert len(blobs) == 1, f"{f} differs"
    assert seen["sim"][0] == FUZZ_CMD_ROUNDS, seen["sim"][0]
    held_rounds = hold_sim_batches(sim, batches, "checkers_fuzz_cmd", seen,
                                   "the fuzz command's first round")
    closures = replay_closures(ck, seen["unpack"][2])
    return {"rounds": FUZZ_CMD_ROUNDS, "clusters": FUZZ_CMD_CLUSTERS,
            "subprocess_s": sub_s, "wall_s": wall, "cpu_s": cpu_s,
            "corpus_identical": True, "sim_vs_plain": held_rounds,
            "summary": {k: summary[k] for k in (
                "clusters-run", "coverage-buckets", "entries", "anomalies",
                "anomaly-types")},
            **checkers_cell(ck, "checkers_fuzz_cmd", seen, closures, wall)}


def phase_checkers(args, kernels, ck, sim) -> None:
    """The checkers that reach K3 through the cycle checker, the host
    checkers, analyze and fuzz: one line a cell (module docstring), and
    the empty kernel's launch floor beside closure_word's row."""
    t0 = time.perf_counter()
    floor = empty_launch_ms()
    ck["closure_word"].extra["empty_kernel_ms"] = floor
    emit({"phase": "checkers_launch_floor", "empty_kernel_ms": floor,
          "nvidia_smi": args.smi})
    emit({"phase": "checkers_adya_g2", **checkers_adya(args, kernels, ck)})
    emit({"phase": "checkers_long_fork",
          **checkers_long_fork(args, kernels, ck)})
    h = causal_history(CAUSAL_KEYS, args.seed)
    emit({"phase": "checkers_causal",
          **checkers_causal(args, kernels, ck, h)})
    emit({"phase": "checkers_causal_processes",
          **checkers_causal_processes(args, kernels, ck, h)})
    emit({"phase": "checkers_bank_setfull",
          **checkers_bank_setfull(kernels)})
    emit({"phase": "checkers_analyze", **checkers_analyze(args, kernels)})
    emit({"phase": "checkers_fuzz_cmd",
          **checkers_fuzz_cmd(args, kernels, ck, sim)})
    emit({"phase": "checkers", "wall_s": time.perf_counter() - t0})


# The runner phase: the etcd suite end to end on simulated members (one
# process a node, over LocalRemote), the README's 5 nodes, and etcd's
# own workload unchanged (etcd.py:340-353: 10 threads a key, 300 ops a
# key). The README's 15 workers (--concurrency 3n) cannot run it: 10
# threads a key must divide the workers (ConcurrentGenerator asserts a
# multiple, in both packages). So 20 workers (4n): 2 keys in flight.
RUNNER_NODES = [f"n{i}" for i in range(1, 6)]
RUNNER_CONCURRENCY = "4n"
RUNNER_TIME_LIMIT = 15
PLANTED_TIME_LIMIT = 5
# keys of the planted run whose reads go stale once (both among the first
# three keys the workers take, 2 at a time, so reached within the limit)
PLANTED_KEYS = (1, 2)
RESUME_TIME_LIMIT = 20
# seconds after the first op of the resumed cell's first session that it
# gets its SIGTERM; the drain ends when the nemesis's current 5-s sleep of
# etcd's schedule does (at 10 s), so the resumed session runs the
# remaining ~10 s
RESUME_SIGTERM_S = 5.0

RESUME_SCRIPT = """
import json, sys
from jepsen_tpu_torch import cli
from jepsen_tpu_torch.dbs import etcd, etcd_sim
cfg = json.load(open(sys.argv[1]))
c = etcd_sim.local_cluster(cfg["root"], cfg["nodes"], ports=cfg["ports"])
fn = etcd_sim.local_test_fn(c)
sys.exit(cli.run_cli(cli.single_test_cmd(fn, opt_spec=etcd._opt_spec),
                     sys.argv[2:]))
"""


def runner_argv(command: str, store_dir: str, time_limit: int,
                device: str, *extra) -> list:
    return [command, *extra,
            *[a for n in RUNNER_NODES for a in ("--node", n)],
            "--concurrency", RUNNER_CONCURRENCY,
            "--time-limit", str(time_limit),
            "--store-dir", store_dir, "--device", device]


def runner_cmd(cluster, client=None) -> dict:
    """single_test_cmd over the etcd suite on `cluster` (as the suite's
    `test` subcommand builds it), `client` in place of the suite's."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.dbs import etcd, etcd_sim

    return cli.single_test_cmd(etcd_sim.local_test_fn(cluster, client=client),
                               opt_spec=etcd._opt_spec)


def stop_members(root: str) -> None:
    """SIGKILL every simulated member whose pidfile is under root (a run
    tears its members down itself; this is the backstop)."""
    import glob
    import signal

    for pidfile in glob.glob(os.path.join(root, "nodes", "*", "opt", "etcd",
                                          "etcd.pid")):
        with contextlib.suppress(OSError, ValueError):
            with open(pidfile) as f:
                os.kill(int(f.read().strip()), signal.SIGKILL)


class RunnerWall:
    """The wall of one `test` run split into its steps: provision
    (`db.cycle`), `run_case` (the workers), `save_1`, analyze (the check
    and `save_2`) and teardown (after the analysis: the logs, the
    members' teardown), by wrapping the functions `core.run` calls."""

    def __init__(self):
        self.s: dict = {}
        self._saved = []

    def _wrap(self, obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
                self.s[key + "_end"] = time.perf_counter()

        self._saved.append((obj, attr, fn))
        setattr(obj, attr, timed)

    def __enter__(self):
        from jepsen_tpu_torch import core, db, store

        self._wrap(db, "cycle", "provision_s")
        self._wrap(core, "run_case", "run_case_s")
        self._wrap(store, "save_1", "save_1_s")
        self._wrap(core, "analyze", "analyze_s")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        for obj, attr, fn in reversed(self._saved):
            setattr(obj, attr, fn)
        last = max((v for k, v in self.s.items() if k.endswith("_end")),
                   default=self.t0)
        self.split = {k: v for k, v in self.s.items()
                      if not k.endswith("_end")}
        self.split["teardown_s"] = end - last
        self.split["wall_s"] = end - self.t0
        return False


class StaleReads:
    """A client wrapper that plants stale reads: on each key of `keys`,
    one read answers, without asking the cluster, a value `a` the key
    held before a later acknowledged write Y of another value, where
    every op that could have written `a` was acknowledged before Y was
    invoked (none failed indeterminately, none is in flight) — so the
    register cannot hold `a` at that read, and the checker must refute
    exactly those keys. Every write and cas on those keys goes through
    the wrapper (its clones share the record); `margin_s` keeps the
    order of the record's clock times that of the history. Once a read
    finds such an `a` whose Y may not have been acknowledged `margin_s`
    ago yet, `a` is reserved: until the stale read is planted, a write
    or cas of `a` on that key fails without being sent (a failed op
    took no effect), so 10 threads a key writing 5 values cannot keep
    every `a` in play."""

    def __init__(self, inner, keys, margin_s: float = 0.1, shared=None):
        import threading

        self.inner, self.keys, self.margin_s = inner, set(keys), margin_s
        self.shared = shared or {"lock": threading.Lock(), "writes": {},
                                 "planted": {}, "reserved": {}}

    def open(self, test, node):
        return StaleReads(self.inner.open(test, node), self.keys,
                          self.margin_s, self.shared)

    def setup(self, test):
        self.inner.setup(test)

    def teardown(self, test):
        self.inner.teardown(test)

    def close(self, test):
        self.inner.close(test)

    def _stale_value(self, writes, now):
        """A value no op can have left in the register by `now`, or
        None."""
        m = self.margin_s
        acked = [w for w in writes if w["type"] == "ok"
                 and w["done"] + m < now]
        for y in sorted(acked, key=lambda w: -w["done"]):
            for a in {w["value"] for w in acked} - {y["value"]}:
                could = [w for w in writes if w["value"] == a
                         and w["type"] != "fail"]
                if all(w["type"] == "ok" and w["done"] + m < y["inv"]
                       for w in could):
                    return a
        return None

    def invoke(self, test, op):
        from jepsen_tpu_torch.independent import tuple_

        k, v = op.value
        sh = self.shared
        if k not in self.keys:
            return self.inner.invoke(test, op)
        if op.f == "read":
            with sh["lock"]:
                a = None
                if k not in sh["planted"]:
                    writes = sh["writes"].get(k, [])
                    a = self._stale_value(writes, time.monotonic())
                    if a is not None:
                        sh["planted"][k] = a
                        sh["reserved"].pop(k, None)
                    elif k not in sh["reserved"]:
                        r = self._stale_value(writes, float("inf"))
                        if r is not None:
                            sh["reserved"][k] = r
            if a is not None:
                return op.with_(type="ok", value=tuple_(k, a))
            return self.inner.invoke(test, op)
        w = {"value": v if op.f == "write" else v[1], "inv": time.monotonic(),
             "done": None, "type": None}
        with sh["lock"]:
            if sh["reserved"].get(k, object()) == w["value"]:
                return op.with_(type="fail", error="reserved")
            sh["writes"].setdefault(k, []).append(w)
        out = self.inner.invoke(test, op)
        with sh["lock"]:
            w["done"], w["type"] = time.monotonic(), out.type
        return out


def runner_history(run_dir: str) -> dict:
    """Counts of a stored run's history: client ops invoked and
    completed (by type), nemesis ops, and the WAL's session epochs."""
    from jepsen_tpu_torch import store

    hist = store.load_history({
        "name": os.path.basename(os.path.dirname(run_dir)),
        "start_time": os.path.basename(run_dir),
        "store_dir": os.path.dirname(os.path.dirname(run_dir))})
    client = [o for o in hist if isinstance(o.process, int)]
    by_type: dict = {}
    for o in client:
        by_type[o.type] = by_type.get(o.type, 0) + 1
    epochs = set()
    with open(os.path.join(run_dir, store.WAL_FILE)) as f:
        for line in f:
            with contextlib.suppress(ValueError):
                epochs.add(json.loads(line).get("_epoch", 0))
    return {"ops": len(hist), "invoked": by_type.get("invoke", 0),
            "completed": len(client) - by_type.get("invoke", 0),
            "by_type": by_type,
            "nemesis_ops": len(hist) - len(client),
            "wal_epochs": sorted(epochs)}


def runner_results(run_dir: str) -> tuple:
    """The stored results: the verdict, the per-key verdicts of the
    linearizability check, and the number of results files."""
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    keys = {k: r["linear"]["valid"]
            for k, r in results["indep"]["results"].items()}
    files = sum(1 for d, _, fs in os.walk(run_dir) for f in fs
                if f.startswith("results."))
    return results, keys, files


def runner_verdict(results: dict, indep) -> dict:
    """Hold a stored run's verdict: the per-key linearizability check
    (`indep`) is `indep`, and the composed verdict is the merge of it and
    the perf checker's, which is "unknown" exactly when matplotlib (its
    graphs) is not installed, as on a host with no plotting library.
    The fields a runner line records."""
    import importlib.util

    from jepsen_tpu_torch.checker import merge_valid

    perf = results["perf"]
    plots = importlib.util.find_spec("matplotlib") is not None
    assert results["indep"]["valid"] is indep, (
        results["indep"]["valid"], results["indep"].get("failures"))
    if plots:
        assert perf["valid"] is True, perf
    else:
        assert perf["valid"] == "unknown" and (
            "No module named 'matplotlib'" in json.dumps(perf)), perf
    assert results["valid"] == merge_valid([perf["valid"], indep]), results[
        "valid"]
    return {"valid": results["valid"], "indep_valid": indep,
            "perf_valid": perf["valid"], "matplotlib": plots}


def runner_line(kernels, cell, rc, wall, seen, **fields) -> dict:
    """A runner cell's line: exit code, wall, launches per kernel, each
    launch replayed against its plain version, kernel ms, idle share."""
    passes = replay(kernels, seen, cell)
    kernel_ms = sum(v[1] for v in seen.values())
    # the run's events also span other threads' launches queued between
    # a launch's two events (a key a thread); the replay times each alone
    replayed_ms = sum(p["kernel_ms"] for v in passes.values() for p in v)
    return {"phase": cell, "exit": rc, "wall_s": wall,
            "launches": {k: v[0] for k, v in seen.items() if v[0]},
            "kernel_vs_plain": {k: len(v) for k, v in passes.items() if v},
            "kernel_ms": kernel_ms, "replayed_kernel_ms": replayed_ms,
            "device_idle": 1 - kernel_ms / 1000 / wall if wall > 0 else None,
            "device_idle_replayed": 1 - replayed_ms / 1000 / wall
            if wall > 0 else None,
            **fields}


def runner_etcd_sim(args, kernels, td: str) -> str:
    """`test` on the README's cluster, every bar at 1: exit 0, valid,
    at least one K1 or K5 launch; then `analyze` over its store under
    bars 1 and the committed bars, each giving the run's per-key
    verdicts. Returns the store dir."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.dbs import etcd_sim

    root = os.path.join(td, "etcd_sim")
    sd = os.path.join(root, "store")
    cluster = etcd_sim.local_cluster(root, RUNNER_NODES)
    argv = runner_argv("test", sd, RUNNER_TIME_LIMIT, args.runner_device)
    try:
        with card_bars(1), RunnerWall() as rw:
            rc, wall, seen = run_path(kernels, lambda: cli.run_cli(
                runner_cmd(cluster), argv))
    finally:
        stop_members(root)
    run_dir = os.path.realpath(os.path.join(sd, "etcd", "latest"))
    results, keys, files = runner_results(run_dir)
    counts = runner_history(run_dir)
    verdict = runner_verdict(results, True)
    assert rc == 0, rc
    assert seen["wgl_vec"][0] + seen["wgl_row"][0] > 0, "no K1/K5 launch"
    emit(runner_line(
        kernels, "runner_etcd_sim", rc, wall, seen,
        nodes=len(RUNNER_NODES), concurrency=4 * len(RUNNER_NODES),
        time_limit_s=RUNNER_TIME_LIMIT, bars=1, split=rw.split,
        **counts, ops_per_s=counts["completed"] / rw.split["run_case_s"],
        keys=len(keys), verdicts=verdict_counts(keys.values()),
        **verdict, results_files=files))
    for label, bars in (("bars_1", 1), ("committed", None)):
        with card_bars(bars) if bars else contextlib.nullcontext():
            rc2, wall2, seen2 = run_path(kernels, lambda: cli.run_cli(
                runner_cmd(cluster),
                runner_argv("analyze", sd, RUNNER_TIME_LIMIT,
                            args.runner_device)))
        again, keys2, _ = runner_results(run_dir)
        assert rc2 == rc and keys2 == keys, (label, rc2)
        emit(runner_line(kernels, f"runner_etcd_sim_analyze_{label}", rc2,
                         wall2, seen2, bars=bars or "committed",
                         keys=len(keys2), same_verdicts=True))
    return sd


def runner_etcd_planted(args, kernels, td: str) -> None:
    """A short run whose client plants one stale read on each of
    PLANTED_KEYS: `test` exits 1, valid False, failing keys exactly
    those, each with its counterexample op."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.dbs import etcd, etcd_sim

    root = os.path.join(td, "planted")
    sd = os.path.join(root, "store")
    cluster = etcd_sim.local_cluster(root, RUNNER_NODES)
    client = StaleReads(etcd.EtcdClient(), PLANTED_KEYS)
    argv = runner_argv("test", sd, PLANTED_TIME_LIMIT, args.runner_device)
    try:
        with card_bars(1), RunnerWall() as rw:
            rc, wall, seen = run_path(kernels, lambda: cli.run_cli(
                runner_cmd(cluster, client=client), argv))
    finally:
        stop_members(root)
    run_dir = os.path.realpath(os.path.join(sd, "etcd", "latest"))
    results, keys, files = runner_results(run_dir)
    failing = sorted(int(k) for k, v in keys.items() if v is False)
    verdict = runner_verdict(results, False)
    assert rc == 1 and results["valid"] is False, (rc, results["valid"])
    assert failing == sorted(PLANTED_KEYS), failing
    for k in PLANTED_KEYS:
        assert results["indep"]["results"][str(k)]["linear"].get("op"), k
    emit(runner_line(
        kernels, "runner_etcd_planted", rc, wall, seen,
        time_limit_s=PLANTED_TIME_LIMIT, split=rw.split,
        **runner_history(run_dir), keys=len(keys),
        verdicts=verdict_counts(keys.values()), failing_keys=failing,
        planted_keys=list(PLANTED_KEYS), **verdict, results_files=files))


def runner_etcd_resume(args, kernels, td: str) -> None:
    """The same test in a subprocess (RESUME_SCRIPT), SIGTERMed
    RESUME_SIGTERM_S after its first op: exit 143, WAL and checkpoint
    saved, members left running; then `resume` here on the card: exit
    0, valid, the history the first session's ops then the second's."""
    import glob
    import signal

    from jepsen_tpu_torch import cli, store
    from jepsen_tpu_torch.dbs import etcd_sim

    root = os.path.join(td, "resume")
    sd = os.path.join(root, "store")
    cluster = etcd_sim.local_cluster(root, RUNNER_NODES)
    script = os.path.join(root, "session.py")
    cfg = os.path.join(root, "cfg.json")
    with open(script, "w") as f:
        f.write(RESUME_SCRIPT)
    with open(cfg, "w") as f:
        json.dump({"root": root, "nodes": RUNNER_NODES,
                   "ports": cluster["ports"]}, f)
    argv = runner_argv("test", sd, RESUME_TIME_LIMIT, args.runner_device)
    wal_glob = os.path.join(sd, "etcd", "*", store.WAL_FILE)
    try:
        t0 = time.perf_counter()
        with open(os.path.join(root, "session1.log"), "w") as log:
            p = subprocess.Popen([sys.executable, script, cfg, *argv],
                                 cwd=HERE, stdout=log, stderr=log,
                                 env={**os.environ, "PYTHONPATH": HERE})
            try:
                deadline = time.monotonic() + 180
                while not (glob.glob(wal_glob)
                           and os.path.getsize(glob.glob(wal_glob)[0])):
                    assert p.poll() is None, "session 1 ended early"
                    assert time.monotonic() < deadline, "no op in 180 s"
                    time.sleep(0.05)
                first_op_s = time.perf_counter() - t0
                time.sleep(RESUME_SIGTERM_S)
                p.send_signal(signal.SIGTERM)
                rc1 = p.wait(timeout=120)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        session1_s = time.perf_counter() - t0
        wal = os.path.realpath(glob.glob(wal_glob)[0])
        run_dir = os.path.dirname(wal)
        with open(wal) as f:
            first = [json.loads(ln) for ln in f if ln.strip()]
        assert rc1 == 143, rc1
        assert os.path.exists(os.path.join(run_dir, store.CKPT_FILE))
        with card_bars(1), RunnerWall() as rw:
            rc2, wall, seen = run_path(kernels, lambda: cli.run_cli(
                runner_cmd(cluster),
                runner_argv("resume", sd, RESUME_TIME_LIMIT,
                            args.runner_device, run_dir)))
    finally:
        stop_members(root)
    results, keys, files = runner_results(run_dir)
    verdict = runner_verdict(results, True)
    assert rc2 == 0, rc2
    hist = store.load_history({"name": "etcd",
                               "start_time": os.path.basename(run_dir),
                               "store_dir": sd})
    drop = ("index", "_epoch", "_kv")
    assert [{k: v for k, v in json.loads(json.dumps(o.to_dict())).items()
             if k not in drop} for o in hist[:len(first)]] == [
        {k: v for k, v in d.items() if k not in drop} for d in first]
    counts = runner_history(run_dir)
    assert counts["wal_epochs"] == [0, 1], counts["wal_epochs"]
    emit(runner_line(
        kernels, "runner_etcd_resume", rc2, wall, seen,
        session1={"exit": rc1, "wall_s": session1_s,
                  "first_op_s": first_op_s, "sigterm_after_s":
                  RESUME_SIGTERM_S, "ops": len(first)},
        time_limit_s=RESUME_TIME_LIMIT, split=rw.split, **counts,
        session2_ops=counts["ops"] - len(first), keys=len(keys),
        verdicts=verdict_counts(keys.values()), **verdict,
        results_files=files))


def phase_runner(args, kernels, resume: bool = True) -> None:
    """The test runner end to end on the etcd suite's simulated cluster:
    runner_etcd_sim (and analyze over its store), runner_etcd_planted,
    and with `resume` runner_etcd_resume (~30 s: the whole script runs it
    only under `--only runner`, to stay inside its 1200-s limit);
    one line a cell."""
    import tempfile

    t0 = time.perf_counter()
    ks = wgl(kernels)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as td:
        runner_etcd_sim(args, ks, td)
        runner_etcd_planted(args, ks, td)
        if resume:
            runner_etcd_resume(args, ks, td)
    emit({"phase": "runner", "wall_s": time.perf_counter() - t0,
          "nvidia_smi": args.smi})


# The faults phase: the fault layer (nemesis/combined.py) under the etcd
# suite on the runner phase's cluster and workload (5 members, 20
# workers, 10 threads and 300 ops a key, every bar at 1). Partition and
# packet faults are recorded and healed on the no-op network (members
# of the simulator share one state file and no links); kill, pause and
# corruption act on the member processes and their logs; clock faults go
# to the recipe's recording setter (etcd_sim.recording_clock), never to
# this machine's clock.
FAULTS_TIME_LIMIT = 15
FAULTS_STABILITY_S = 3.0
FAULTS_FAMILIES = ("kill", "pause", "partition", "clock", "corruption")
FAULTS_INTERVAL = 1.5
FAULTS_OPS = 8
# the composed cell's fault families that must have fired
FAULTS_SEEN = {"kill", "pause", "partition", "corruption"}
# the fuzz-to-replay cell: one fuzz-loop round of FuzzLoop's default 256
# clusters, its entry with the most fault families rendered with a
# txn-slot of 0.5 s (DEFAULT_SPEC's 24 slots: ~12 s of faults)
REPLAY_CLUSTERS = 256
REPLAY_INTERVAL = 0.5


def faults_cmd(cluster, pids: dict) -> dict:
    """single_test_cmd over the etcd suite on `cluster` with the faults'
    suite options (fault_ops, the stability window), each member's pid
    appended to pids[node] after every start of it (setup and each
    restart)."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.dbs import etcd, etcd_sim

    base = etcd_sim.local_test_fn(cluster, suite_opts={
        "fault_ops": FAULTS_OPS, "stability_period": FAULTS_STABILITY_S})

    def test_fn(opts):
        t = base(opts)
        db, start = t["db"], t["db"].start

        def recorded(test, node):
            start(test, node)
            with open(db._pidfile(test, node)) as f:
                pids.setdefault(node, []).append(int(f.read().strip()))

        db.start = recorded
        return t

    return cli.single_test_cmd(test_fn, opt_spec=etcd._opt_spec)


def nemesis_events(run_dir: str) -> list:
    """The (f, value) of each nemesis op the stored run invoked, in order
    (one nemesis worker: each invocation is followed by its completion),
    a corruption spec's path left out (the document's is a placeholder
    the run fills from its corrupt_paths)."""
    from jepsen_tpu_torch import store

    hist = store.load_history({
        "name": os.path.basename(os.path.dirname(run_dir)),
        "start_time": os.path.basename(run_dir),
        "store_dir": os.path.dirname(os.path.dirname(run_dir))})
    ops = [o for o in hist if o.process == "nemesis"]
    assert len(ops) % 2 == 0, len(ops)
    return [event(o.f, json.loads(json.dumps(o.value))) for o in ops[0::2]]


def event(f, value) -> tuple:
    if f == "corrupt-file":
        value = [{k: v for k, v in s.items() if k != "path"}
                 for s in value or []]
    return f, value


def faults_run(args, kernels, td: str, name: str, *extra) -> dict:
    """One `test` on a fresh cluster of RUNNER_NODES with every bar at 1
    and `extra` arguments: its exit code, wall, launches (`seen`), wall
    split, run dir, results, per-key verdicts, member pids, clock setter
    calls and native finishes."""
    from jepsen_tpu_torch import cli
    from jepsen_tpu_torch.dbs import etcd_sim

    lin = lin_module()
    root = os.path.join(td, name)
    sd = os.path.join(root, "store")
    cluster = etcd_sim.local_cluster(root, RUNNER_NODES)
    pids: dict = {}
    argv = runner_argv("test", sd, FAULTS_TIME_LIMIT, args.runner_device,
                       *extra)
    f0 = lin.NATIVE_FINISH
    try:
        with card_bars(1), RunnerWall() as rw:
            rc, wall, seen = run_path(kernels, lambda: cli.run_cli(
                faults_cmd(cluster, pids), argv))
    finally:
        stop_members(root)
    run_dir = os.path.realpath(os.path.join(sd, "etcd", "latest"))
    with open(os.path.join(run_dir, "results.json")) as f:
        results = json.load(f)
    return {"rc": rc, "wall": wall, "seen": seen, "split": rw.split,
            "run_dir": run_dir, "results": results,
            "keys": {k: r["linear"]["valid"] for k, r in
                     results["workload"]["indep"]["results"].items()},
            "pids": pids, "clock_sets": cluster.get("clock_sets", []),
            "native": lin.NATIVE_FINISH - f0}


def faults_line(kernels, cell, run: dict, **fields) -> dict:
    """Hold a fault cell's run (exit 0, every key True on the card, no
    unknown, the recovery checker valid with its figures apart from the
    per-key and perf verdicts) and return its line: runner_line's
    figures, the ops, the faults that fired, K1's lanes at the cap and
    native finishes."""
    keys, split, results = run["keys"], run["split"], run["results"]
    counts = runner_history(run["run_dir"])
    verdicts = verdict_counts(keys.values())
    rec = results["recovery"]
    assert run["rc"] == 0, run["rc"]
    assert keys and all(v is True for v in keys.values()), verdicts
    assert rec["valid"] is True, rec
    seen = run["seen"]
    assert seen["wgl_vec"][0] + seen["wgl_row"][0] > 0, "no K1/K5 launch"
    wl = results["workload"]
    verdict = runner_verdict(wl, True)
    fired: dict = {}
    for f, _ in nemesis_events(run["run_dir"]):
        fired[f] = fired.get(f, 0) + 1
    line = runner_line(
        kernels, cell, run["rc"], run["wall"], seen, nodes=len(RUNNER_NODES),
        concurrency=4 * len(RUNNER_NODES), time_limit_s=FAULTS_TIME_LIMIT,
        stability_s=FAULTS_STABILITY_S, bars=1, split=split, **counts,
        ops_per_s=counts["completed"] / split["run_case_s"],
        keys=len(keys), verdicts=verdicts, **verdict,
        workload_valid=wl["valid"], composed_valid=results["valid"],
        recovery={k: rec[k] for k in ("valid", "faults_seen",
                                      "post_heal_ok_count", "unhealed")},
        nemesis_fired=fired,
        kill_pause_corrupt={f: fired.get(f, 0)
                            for f in ("kill", "pause", "corrupt-file")},
        member_pids=run["pids"], clock_sets=len(run["clock_sets"]),
        native_finish=run["native"], **fields)
    line["capped_lanes"] = {k.name: k.cells[cell]["capped_lanes"]
                            for k in wgl(kernels) if cell in k.cells}
    return line


def faults_etcd_composed(args, kernels, td: str) -> None:
    """`test --nemesis kill,pause,partition,clock,corruption --seed 0`:
    held by faults_line, the families of FAULTS_SEEN seen by the
    recovery checker, a member's pid changed by a kill and restart, and
    the run's nemesis ops a prefix of materialize_schedule's events for
    the same options, then its final ops."""
    from jepsen_tpu_torch.nemesis import combined

    run = faults_run(
        args, kernels, td, "composed", "--nemesis", ",".join(FAULTS_FAMILIES),
        "--seed", str(args.seed), "--nemesis-interval", str(FAULTS_INTERVAL))
    doc = combined.materialize_schedule(
        faults=list(FAULTS_FAMILIES), seed=args.seed,
        interval=FAULTS_INTERVAL, fault_ops=FAULTS_OPS, nodes=RUNNER_NODES)
    events = [event(e["f"], e["value"]) for e in doc["events"]]
    final = [event(e["f"], e["value"]) for e in doc["final"]]
    got = nemesis_events(run["run_dir"])
    main = len(got) - len(final)
    assert 0 < main <= len(events), (len(got), len(events))
    assert got[:main] == events[:main], (got, events)
    assert got[main:] == final, (got[main:], final)
    seen_fams = run["results"]["recovery"]["faults_seen"]
    assert FAULTS_SEEN <= {f for f, n in seen_fams.items() if n}, seen_fams
    restarted = sorted(n for n, ps in run["pids"].items()
                       if len(set(ps)) > 1)
    assert restarted, run["pids"]
    emit(faults_line(
        kernels, "faults_etcd_composed", run,
        nemesis=",".join(FAULTS_FAMILIES), seed=args.seed,
        interval_s=FAULTS_INTERVAL, fault_ops=FAULTS_OPS,
        schedule_events_run=main, schedule_events=len(events),
        schedule_prefix=True, final_ops=[f for f, _ in final],
        restarted_members=restarted))


def faults_fuzz_replay(args, kernels, ck, sim, td: str) -> None:
    """One fuzz-loop round on the card (K4, then K3 in the score batch:
    every launch held against its plain version), its corpus entry with
    the most fault families (the lowest id on ties) rendered by
    to_nemesis_doc onto RUNNER_NODES, then `test --nemesis-schedule` of
    that document: held by faults_line, the run's nemesis ops the
    document's events then its final ops."""
    from jepsen_tpu_torch.fuzz import loop
    from jepsen_tpu_torch.fuzz.schedule import (dump_schedule_file,
                                                families_of,
                                                schedule_from_lists)

    lp = loop.FuzzLoop(os.path.join(td, "corpus"), clusters=REPLAY_CLUSTERS,
                       seed=args.seed)
    with recorded_sim_batches() as batches:
        stats, round_s, fseen = run_path(kernels, lp.run_round)
    assert fseen["sim"][0] == 1, fseen["sim"][0]
    held_rounds = hold_sim_batches(sim, batches, "faults_fuzz_replay", fseen,
                                   "the faults phase's fuzz round")
    buckets = replay_closure(ck, fseen["unpack"][2])
    closure_cell(ck, "faults_fuzz_replay", fseen, buckets)
    best = min(lp.corpus.entries(), key=lambda e: (-len(families_of(
        schedule_from_lists(e["schedule"], lp.spec))), e["id"]))
    path = os.path.join(td, "schedule.json")
    doc = dump_schedule_file(
        path, schedule_from_lists(best["schedule"], lp.spec), lp.spec,
        nodes=RUNNER_NODES, interval=REPLAY_INTERVAL, seed=args.seed)
    run = faults_run(args, wgl(kernels), td, "replay",
                     "--nemesis-schedule", path)
    want = [event(e["f"], e["value"]) for e in doc["events"] + doc["final"]]
    got = nemesis_events(run["run_dir"])
    assert got == want, (got, want)
    emit(faults_line(
        kernels, "faults_fuzz_replay", run,
        fuzz_round={**stats, "wall_s": round_s,
                    "launches": {k: v[0] for k, v in fseen.items() if v[0]},
                    "sim_vs_plain": held_rounds,
                    "closure_buckets_replayed": len(buckets)},
        entry=best["id"], entry_families=doc["faults"],
        schedule_span_s=sum(e["dt"] for e in doc["events"]),
        schedule_events=len(doc["events"]), final_ops=len(doc["final"]),
        replayed_exactly=True))


def phase_faults(args, kernels, ck, sim) -> None:
    """The fault layer end to end: faults_etcd_composed, then
    faults_fuzz_replay; one line a cell."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as td:
        faults_etcd_composed(args, wgl(kernels), td)
        faults_fuzz_replay(args, kernels, ck, sim, td)
    emit({"phase": "faults", "wall_s": time.perf_counter() - t0,
          "nvidia_smi": args.smi})


def lookup_us(mod, reps: int = 20) -> dict:
    """Host µs of one lookup of kernel module `mod`'s library through
    its `build`: "cached", as every wrapper makes it at each launch, and
    "source_read", with the source read and hashed again, as each launch
    did before `_build` handed back loaded libraries."""
    import torch

    from jepsen_tpu_torch.ops import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, clear in (("cached", False), ("source_read", True)):
        mod.build(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            if clear:
                _build._loaded.clear()
            mod.build(dev)
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def build_all(kernels) -> None:
    """Build every kernel source at once (one nvcc each, and g++ for the
    native search, started together) and print each build's seconds and
    ptxas registers and spills."""
    from jepsen_tpu_torch.ops import _build

    from jepsen_tpu_torch.ops import wgl_native

    mods = {k.mod.__name__.rsplit(".", 1)[1]: k.mod for k in kernels}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods) + 1) as ex:
        native = ex.submit(wgl_native.build)
        list(ex.map(lambda m: m.build("cuda"), mods.values()))
        native.result()
    wall = time.perf_counter() - t0
    emit({"phase": "build", "source": "wgl_native.cpp", "wall_s": wall,
          "compiler": "g++", "seconds": _build.BUILD_SECONDS.get(
              "wgl_native")})
    for name, mod in mods.items():
        log = _build.BUILD_LOG.get(name, "")
        emit({"phase": "build", "source": f"{name}.cu", "wall_s": wall,
              "kernels": [k.name for k in kernels
                          if k.mod is mod and not k.library],
              "nvcc_seconds": _build.BUILD_SECONDS.get(name),
              "ptxas": [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln],
              "lookup_us": lookup_us(mod)})


def run(args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "jepsen_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(jepsen_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from jepsen_tpu_torch.device import describe
    from jepsen_tpu_torch.fuzz import sim as sim_mod
    from jepsen_tpu_torch.ops import closure, wgl_row, wgl_search, wgl_vec

    smi = nvidia_smi()
    args.smi = smi
    args.runner_device = "cuda"
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device": kind,
          "capability": describe("cuda")["capability"],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    vec = Kernel("wgl_vec", wgl_vec, "jepsen_tpu/ops/wgl_pallas_vec.py:163")
    row = Kernel("wgl_row", wgl_row, "jepsen_tpu/ops/wgl_pallas.py:84")
    search = Kernel("wgl_search", wgl_search, "jepsen_tpu/ops/wgl_tpu.py:160")
    k3 = "jepsen_tpu/ops/closure_tpu.py"
    ck = {"closure_word": ClosureKernel("closure_word", closure, f"{k3}:98"),
          "unpack": ClosureKernel("unpack", closure, f"{k3}:85"),
          "or_threshold_pack": ClosureKernel("or_threshold_pack", closure,
                                             f"{k3}:89"),
          "matmul": ClosureKernel("matmul", closure, f"{k3}:88",
                                  library=True)}
    sim = Kernel("sim", sim_mod, "jepsen_tpu/fuzz/sim.py:115")
    kernels = [vec, row, search, *ck.values(), sim]
    meshk = {"K1 mesh": Kernel("K1 mesh", wgl_vec,
                               "jepsen_tpu/ops/wgl_pallas_vec.py:848"),
             "K2 deal": Kernel("K2 deal", wgl_search,
                               "jepsen_tpu/ops/wgl_tpu.py:639"),
             "K3 mesh": MeshClosureKernel("K3 mesh", closure, f"{k3}:157")}
    build_all(kernels)
    if args.only == "crossover":
        phase_crossover(args)
        print(smi, flush=True)
        return 0
    if args.only == "closure":
        phase_closure_vs_plain(args, ck)
        phase_cycles(args, kernels, ck)
        emit({"kernels": [k.row() for k in ck.values() if not k.library]})
        print(smi, flush=True)
        return 0
    if args.only == "fuzz":
        phase_fuzzing(args, kernels, ck, sim)
        emit({"kernels": [k.row() for k in (*ck.values(), sim)
                          if not k.library]})
        print(smi, flush=True)
        return 0
    if args.only == "linear":
        phase_linear(args, kernels, search)
        emit({"kernels": [search.row()]})
        print(smi, flush=True)
        return 0
    if args.only == "store":
        phase_store(args, kernels, ck, sim)
        emit({"kernels": [k.row() for k in (vec, *ck.values(), sim)
                          if not k.library]})
        print(smi, flush=True)
        return 0
    if args.only == "online":
        phase_online(args, kernels, ck)
        emit({"kernels": [k.row() for k in (vec, *ck.values())
                          if not k.library]})
        print(smi, flush=True)
        return 0
    if args.only == "serve":
        phase_serve_daemon(args, kernels, ck)
        emit({"kernels": [k.row() for k in (vec, row, search, *ck.values())
                          if not k.library]})
        print(smi, flush=True)
        return 0
    if args.only == "mesh":
        phase_mesh(args, kernels, meshk)
        emit({"kernels": [k.row() for k in (vec, search, *meshk.values())]})
        print(smi, flush=True)
        return 0
    if args.only == "checkers":
        phase_checkers(args, kernels, ck, sim)
        emit({"kernels": [k.row() for k in (vec, row, *ck.values(), sim)
                          if not k.library]})
        print(smi, flush=True)
        return 0
    if args.only == "runner":
        phase_runner(args, kernels)
        emit({"kernels": [k.row() for k in (vec, row, search)]})
        print(smi, flush=True)
        return 0
    if args.only == "faults":
        phase_faults(args, kernels, ck, sim)
        emit({"kernels": [k.row() for k in (vec, row, *ck.values(), sim)
                          if not k.library]})
        print(smi, flush=True)
        return 0

    phase_kernel_vs_plain(args, vec)
    phase_row_vs_plain(args, row)
    phase_search_vs_plain(args, search)
    phase_search_tiers(args, search)
    # ops per key count invocations; each is two history events, so 64
    # and 1000 give the ~128- and ~2000-event keys of the reference sizes
    main_path(args, kernels, "main_register", 4096, 64, 8, host_sample=64)
    # the same keys with each impossible read at a random read instead of
    # the first: deep searches behind it, the regime where K1's bounded
    # memo costs steps and verdicts may go unknown
    main_path(args, kernels, "main_register_late", 4096, 64, 8,
              host_sample=64, bad_read="random")
    # the same under "auto" with the measured bars (native triage and
    # finish below gpu_vec's bar), and with every bar at 1 (gpu_vec whole,
    # then the native finish of its unknowns): no unknown either way
    main_path(args, kernels, "main_register_late_auto", 4096, 64, 8,
              host_sample=64, bad_read="random", algorithm="auto",
              expect=None)
    main_path(args, kernels, "main_register_late_card", 4096, 64, 8,
              host_sample=64, bad_read="random", algorithm="auto",
              expect=("wgl_vec",), bars=1)
    main_path(args, kernels, "main_widest", 512, 1000, 0, host_sample=8)
    # keys of ~2500 entries (a register test not split by key): past
    # wgl_vec's 1024, so wgl_row; beside it the same under "auto"
    main_path(args, kernels, "main_long", 64, 3000, 8, host_sample=8,
              algorithm="gpu_row", expect=("wgl_row",))
    main_path(args, kernels, "main_long_auto", 64, 3000, 8, host_sample=8,
              algorithm="auto", expect=None)
    phase_mixed(args, kernels)
    phase_single(args, kernels)
    phase_lanes_per_block(vec)
    # past wgl_row's 4064 entries and wgl_vec's fifo ring: wgl_search
    phase_main_stress(args, kernels)
    phase_main_single_10k(args, kernels)
    phase_main_fifo_long(args, kernels)
    # the register cell's 4096 keys through gpu_search: one K2 launch of
    # many more lanes than the card has SMs, one block a lane
    main_path(args, kernels, "main_register_search", 4096, 64, 8,
              host_sample=64, algorithm="gpu_search",
              expect=("wgl_search",))
    phase_main_queue_pcomp(args, kernels)
    first = search.cells["main_stress_50k"]
    search.extra = {
        "max_lane_steps": first["max_lane_steps"],
        "us_per_step": first["us_per_step"],
        "scratch_bytes": first["per_launch"][0]["scratch_bytes"],
        # µs a step of the longest lane and the plan, at each main-path
        # shape
        "by_shape": {cell: {
            "us_per_step": search.cells[cell]["us_per_step"],
            "max_lane_steps": search.cells[cell]["max_lane_steps"],
            "kernel_ms": search.cells[cell]["kernel_ms"],
            "bound_ms": search.cells[cell]["bound_ms"],
            **{k: search.cells[cell]["per_launch"][0][k]
               for k in ("n_pad", "lanes", "smem_bytes", "lanes_per_block",
                         "smem_tables", "scratch_bytes", "bound_share")}}
            for cell in ("main_stress_50k", "main_single_10k",
                         "main_fifo_long")}}

    phase_crossover(args, SMOKE_CROSSOVER_REPS, SMOKE_CROSSOVER_QUEUE_SEEDS)
    phase_corpus(args)
    phase_linear(args, kernels, search)

    phase_closure_vs_plain(args, ck)
    phase_cycles(args, kernels, ck)

    phase_fuzzing(args, kernels, ck, sim)
    phase_store(args, kernels, ck, sim)

    phase_online(args, kernels, ck)
    phase_serve_daemon(args, kernels, ck)

    phase_mesh(args, kernels, meshk)

    phase_checkers(args, kernels, ck, sim)

    phase_runner(args, kernels, resume=False)

    phase_faults(args, kernels, ck, sim)

    mm = ck["matmul"]
    emit({"kernels": [k.row() for k in (*kernels, *meshk.values())
                      if not k.library],
          "matmul": {"call": "torch.matmul (bf16, the closure's product)",
                     "launches": mm.launches, "ms": mm.ms,
                     "bound_ms": mm.bound_ms, "bound_by": mm.bound_by,
                     "cells": mm.cells}})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("crossover", "closure", "fuzz",
                                       "linear", "store", "online",
                                       "serve", "mesh", "checkers",
                                       "runner", "faults"),
                    help="build, run these phases alone (crossover: the "
                    "crossover bars; closure: closure_vs_plain and the "
                    "three cycle cells, every closure launch replayed; "
                    "fuzz: the sim kernel at six specs and the three fuzz "
                    "cells; linear: the corpus through linear and "
                    "competition; store: the register cell, cycle_append "
                    "and the fuzz loop with a store and journal; online: "
                    "the register stream and the cycle abort stream; "
                    "serve: the verdict daemon, the bundle and watch; "
                    "mesh: K2's deal, K1's block shards, K3's row blocks "
                    "and the doctor over a repeated device list; checkers: "
                    "adya, long_fork, causal (threads and spawned "
                    "workers), bank-setfull, analyze and fuzz; runner: the "
                    "etcd suite's test, analyze and resume on simulated "
                    "members; faults: the etcd suite under a composed "
                    "fault package and under a fuzz-found schedule) and "
                    "print their lines and the nvidia-smi "
                    "line (no smoke result)")
    return run(ap.parse_args())


if __name__ == "__main__":
    sys.exit(main())
