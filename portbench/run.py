"""The benchmark of jepsen_tpu_torch: histories checked to an exact
verdict on one card, one caller after another.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. A cell of BENCHMARK.json names a
configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`: the plant, the pool of histories); its
per-layer metrics are readers (`metrics/<name>.py`). All three are
found by name. A configuration names, as "module:attribute", the
generator of its histories ("generator", given the configuration's
"history" parameters, the traffic and a seed), the entry its checks go
through ("entry", portbench/entries.py), the judge of their answers
("judge", portbench/compare.py) and the program's counters its metrics
read ("counters"). So a cell, a configuration, a metric, or a
configuration of another kind, is added as files and entries alone.

A run:

1. Set-up: the process pinned to a fixed half of its cores; torch and
   the CUDA context; the port, with the calibration record of `auto` at
   CALIB_CACHE inside the checkout (its first run measures the
   crossover, later runs read it; the port keeps its built libraries in
   jepsen_tpu_torch/ops/_build/); the pool of histories from the seed.
   Then the collector is run and the pool is frozen out of its scans
   (`gc.freeze`): the pool holds several histories where a user's
   process holds one. Last, one warm check of the pool's first history,
   which also leaves the collector as a check leaves it for the next.
2. The window: one caller checks the pool's histories one after another,
   never the same one twice in a row, through the configuration's entry,
   and keeps of each check the judge's compact digest of its answers. It
   closes at the end of the last check that started within `--seconds`.
3. `--trace 0` reports the cell's end-to-end metrics (END_TO_END: ops
   checked per second over the window's whole span, the 95th percentile
   of a check's wall, the set-up's seconds). `--trace 1` runs the window
   under `torch.profiler`, with the kernels' CUDA events and captured
   launches on and the collector's runs timed (`Collector`), and reports
   the cell's per-layer metrics instead.
4. After the window the device's peak memory is read, the program's
   state freed, and every answer of every check is held against the
   plain reference by the configuration's judge. A history met again
   must launch the same kernels (every module of jepsen_tpu_torch that
   counts its launches in LAUNCHES), move the configuration's counters
   as far and count the same steps as the first time. Each number
   compared is printed with its limit, as the last lines of standard
   error and under the result line's last key, "compared"; before them,
   each check's wall, the process's CPU seconds in it and, traced, the
   collector's seconds in it, and the host's steal share, for a look at
   a spread.

The last line of standard output is the result: correct, attempted
(checks in the window), failed (checks with a wrong answer), metrics,
device. A run without CUDA, without the port, or with `jax`, `jaxlib`,
`flax` or the JAX package `jepsen_tpu` loaded once the window has
closed, exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the calibration record of "auto", at a fixed path inside the checkout
CALIB_CACHE = os.path.join(HERE, "_cache", "calibration.json")
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "jepsen_tpu")
#: pool history i of seed s is made from seed s * POOL_STRIDE + i
POOL_STRIDE = 1009

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4
EXIT_NO_PORT = 5


@dataclass
class Check:
    """One check of the window."""

    pool: int            # which history of the pool
    events: int          # its events (invocations and completions)
    start: float         # time.perf_counter() at the call
    end: float           # ...and when the verdict came back
    result: object       # the judge's digest of what the check returned
    work: tuple          # (launches of each kernel, counters, steps)
    cpu_s: float = 0.0   # the process's CPU seconds (all threads) in it
    gc_s: float | None = None  # the collector's seconds in it (traced)

    @property
    def wall_s(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """Everything a metric reader may read of one run."""

    cell: dict
    config: dict
    traffic: dict
    checks: list                 # Check, the window's
    span_s: float                # the window's whole span
    setup_s: float
    trace: object = None         # devtrace.DeviceTrace (traced runs)
    kernels: dict = field(default_factory=dict)  # name -> KernelLog
    counters: dict = field(default_factory=dict)  # name -> window's growth


@dataclass
class KernelLog:
    """A kernel module's launches in a traced window: `timed`, the CUDA
    event pairs of every launch; `captured`, the arguments of the
    launches of the window's first pass over the pool (the first
    len(captured) of `timed`)."""

    module: object
    timed: list
    captured: list


def die(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def find_cell(root: str, name: str) -> tuple:
    """(benchmark, cell, config, traffic) of workload `name`."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     cell["traffic"] + ".json"))
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") that this cell
    reports: those that list it under "workloads", or list none."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def load_reader(root: str, name: str):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load(ref: str):
    """The attribute that "module:attribute" names (attributes may be
    dotted), its module imported."""
    module, _, attr = ref.partition(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def forbidden_modules() -> list:
    """Top-level names of FORBIDDEN modules loaded in this process,
    compared whole (jepsen_tpu_torch is not jepsen_tpu)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def pool_seed(seed: int, i: int) -> int:
    return seed * POOL_STRIDE + i


def make_pool(config: dict, traffic: dict, seed: int) -> list:
    """The traffic's pool of histories, as the configuration's generator
    makes them, from `seed`."""
    if traffic.get("callers", 1) != 1:
        raise ValueError("the harness drives one caller")
    n = int(traffic["pool"])
    if not 2 <= n < POOL_STRIDE:
        raise ValueError(f"a pool holds 2 to {POOL_STRIDE - 1} histories")
    generate = load(config["generator"])
    return [generate(config["history"], traffic, pool_seed(seed, i))
            for i in range(n)]


def kernel_modules() -> dict:
    """Short name -> module, of every module of the program that counts
    its kernel launches (LAUNCHES): jepsen_tpu_torch.ops's, all imported,
    and any other that is loaded."""
    import pkgutil

    import jepsen_tpu_torch.ops as ops

    for m in pkgutil.iter_modules(ops.__path__):
        if not m.name.startswith("_"):
            importlib.import_module(f"{ops.__name__}.{m.name}")
    return {name.rsplit(".", 1)[1]: m
            for name, m in sorted(sys.modules.items())
            if name.startswith("jepsen_tpu_torch.")
            and hasattr(m, "LAUNCHES")}


def launches(mods: dict) -> tuple:
    out = []
    for m in mods.values():
        n = m.LAUNCHES
        out.append(tuple(sorted(n.items())) if isinstance(n, dict) else n)
    return tuple(out)


def counters(config: dict) -> dict:
    """The configuration's program counters, name -> value now."""
    return {name: load(ref)
            for name, ref in config.get("counters", {}).items()}


class Collector:
    """The seconds the interpreter's cyclic garbage collector runs, on
    the host's clock, while it is entered (a `gc.callbacks` hook)."""

    def __init__(self):
        self.s = 0.0
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def run_check(entry, history, pool_i: int, sync, mods: dict, config: dict,
              record=None, digest=None, collector=None) -> Check:
    """One check of `history` through `entry`, timed from the call to
    the verdict on the host, with the work it did (and the collector's
    seconds in it, where `collector` is given); its result kept as
    `digest(result)` where given."""
    before = launches(mods), counters(config)
    gc0 = collector.s if collector is not None else None
    cpu0 = time.process_time()
    start = time.perf_counter()
    if record is None:
        result = entry.check(history)
    else:
        with record:
            result = entry.check(history)
    sync()
    end = time.perf_counter()
    cpu = time.process_time() - cpu0
    after = launches(mods), counters(config)
    work = (tuple(_growth(a, b) for a, b in zip(after[0], before[0])),
            tuple(after[1][k] - before[1][k] for k in sorted(after[1])),
            entry.steps(result))
    if digest is not None:
        result = digest(result)
    gc_s = collector.s - gc0 if collector is not None else None
    return Check(pool_i, len(history), start, end, result, work, cpu, gc_s)


def _growth(after, before):
    """Launches between two readings of one module's LAUNCHES (a count,
    or a tuple of (kernel, count) pairs)."""
    if isinstance(after, tuple):
        return tuple((k, v - dict(before).get(k, 0)) for k, v in after)
    return after - before


def cpu_times() -> list | None:
    """The machine's CPU time counters (user, nice, system, idle, iowait,
    irq, softirq, steal), from /proc/stat; None where unreadable."""
    try:
        with open("/proc/stat") as fh:
            return [int(x) for x in fh.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def p95(values) -> float:
    """The 95th percentile of `values` (statistics.quantiles, inclusive:
    the sample's own 95th percentile)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


END_TO_END = {
    "ops_checked_per_s": lambda run: (
        sum(c.events for c in run.checks) / run.span_s),
    "check_p95_ms": lambda run: 1000 * p95([c.wall_s for c in run.checks]),
    "setup_s": lambda run: run.setup_s,
}


def nvidia_smi() -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def window(check, n_pool: int, seconds: float, record=None) -> tuple:
    """The window's checks and its span: `check(k, context)` of pool
    histories 1, 2, ..., 0, 1, ... (the warm check took 0), each started
    while fewer than `seconds` have passed. `record(i)`, where given, is
    the context the window's i-th check runs in."""
    checks = []
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds:
        k = (i + 1) % n_pool
        checks.append(check(k, record(i) if record else None))
        i += 1
    return checks, checks[-1].end - w0


def traced_window(check, n_pool: int, seconds: float, on_card: bool,
                  mods: dict) -> tuple:
    """The window under `torch.profiler` (CPU and, on the card, CUDA
    activity), the window and each check in a named range, and every
    launch of a kernel module that times and captures them (TIMED,
    CAPTURE) timed by its CUDA events, the launches of the first pass
    over the pool captured: (checks, span, DeviceTrace,
    {module: KernelLog})."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .devtrace import CHECK, WINDOW, DeviceTrace

    mods = {n: m for n, m in mods.items()
            if hasattr(m, "TIMED") and hasattr(m, "CAPTURE")}
    for m in mods.values():
        m.TIMED, m.CAPTURE = [], []
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    captured: dict = {}

    def record(i):
        if i == n_pool:
            for name, m in mods.items():
                captured[name], m.CAPTURE = m.CAPTURE, None
        return record_function(CHECK)

    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            checks, span = window(check, n_pool, seconds, record)
    kernels = {}
    for name, m in mods.items():
        kernels[name] = KernelLog(m, m.TIMED,
                                  captured.get(name, m.CAPTURE) or [])
        m.TIMED = m.CAPTURE = None
    return checks, span, DeviceTrace.from_profile(prof), kernels


def judge(judge_, raw: list, results: list, works: list) -> tuple:
    """The numbers compared, each with its limit, and each check's wrong
    answers: every check's answers (`results`, (pool index, result))
    against the reference's for its history in `raw`, by the
    configuration's judge, and the work of each meeting of a history
    (`works`) against its first."""
    want = {i: judge_.expected(raw[i])
            for i in sorted({i for i, _ in results})}
    wrong_by_check = [judge_.wrong(r, want[i]) for i, r in results]
    first: dict = {}
    repeats = sum(1 for i, w in works if first.setdefault(i, w) != w)
    compared = {
        "wrong_answers": {"value": sum(wrong_by_check), "limit": 0,
                          "of": sum(judge_.answers(want[i])
                                    for i, _ in results)},
        "repeat_mismatches": {"value": repeats, "limit": 0,
                              "of": len(works)},
    }
    return compared, wrong_by_check


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pin() -> None:
    """Pin this process, and every thread it starts after, to the upper
    half of the cores it may run on: a fixed set, which the scheduler
    does not move it off."""
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[len(cores) // 2:])


def main(argv=None, root: str = ROOT, device=None) -> int:
    """One run (module docstring). `device` is for the harness's own
    tests: a device name makes the run skip its look for a card, and the
    pinning, and check there (the port's plain versions on "cpu")."""
    t0 = time.perf_counter()
    if device is None:
        pin()
    args = parse(argv)
    bench, cell, config, traffic = find_cell(root, args.workload)
    import torch

    on_card = device is None
    if on_card:
        chips = int(cell["chips"])
        if not torch.cuda.is_available():
            die(EXIT_NO_CARD, "no CUDA device")
        if torch.cuda.device_count() < chips:
            die(EXIT_NO_CARD, f"{torch.cuda.device_count()} CUDA devices, "
                f"the cell asks for {chips}")
        torch.cuda.set_device(0)
        torch.zeros(1, device="cuda")  # the CUDA context
    os.makedirs(os.path.dirname(CALIB_CACHE), exist_ok=True)
    os.environ["JEPSEN_TPU_TORCH_CALIB_CACHE"] = CALIB_CACHE
    try:
        import jepsen_tpu_torch  # noqa: F401
    except ImportError as e:
        die(EXIT_NO_PORT, f"the port does not import: {e}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    entry = load(config["entry"])(config, device)
    judge_ = load(config["judge"])(config)
    entry.setup(on_card)
    # the events themselves are made again for the reference after the
    # window: the window's process holds only what a checker's would
    pool = [entry.prepare(h) for h in make_pool(config, traffic, args.seed)]
    mods = kernel_modules()
    # the pool lives through the window: the collector leaves it be, so
    # the window's collections scan the program's own objects and not the
    # pool's extra histories. The warm check comes after, so the window's
    # first check meets the collector as every later one does, and not
    # fresh from a full collection
    gc.collect()
    gc.freeze()
    collector = Collector() if args.trace else None

    def check(k, record=None):
        return run_check(entry, pool[k], k, sync, mods, config, record,
                         judge_.digest, collector)

    warm = check(0)
    setup_s = time.perf_counter() - t0

    cpu0, count0 = cpu_times(), counters(config)
    if args.trace:
        with collector:
            checks, span, trace, kernels = traced_window(
                check, len(pool), args.seconds, on_card, mods)
    else:
        checks, span = window(check, len(pool), args.seconds)
        trace, kernels = None, {}
    cpu1, count1 = cpu_times(), counters(config)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(cell, config, traffic, checks, span, setup_s, trace, kernels,
              {k: count1[k] - count0[k] for k in count0})

    metrics = {}
    for m in cell_metrics(bench, cell,
                          "per_layer" if args.trace else "end_to_end"):
        name = m["name"]
        value = (load_reader(root, name)(run) if args.trace
                 else END_TO_END[name](run))
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    smi = nvidia_smi() if on_card else None
    if smi:
        device_info["name_and_power_limit"] = smi
    breakdown = None
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps()}

    # the program's state goes before the reference runs
    results = [(c.pool, c.result) for c in [warm] + checks]
    works = [(c.pool, c.work) for c in [warm] + checks]
    for c in [warm] + checks:
        c.result = None
    del entry, pool, run, kernels, check
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    compared, wrong_by_check = judge(
        judge_, make_pool(config, traffic, args.seed), results, works)
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    forbidden = forbidden_modules()
    if forbidden:
        die(EXIT_FORBIDDEN, "modules loaded that the benchmark may not "
            f"load: {', '.join(forbidden)}")
    out = {"correct": correct, "attempted": len(checks),
           "failed": sum(1 for w in wrong_by_check[1:] if w),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    print(json.dumps(out), flush=True)
    # what a look for the cause of a spread starts from: each check's wall,
    # the process's CPU seconds and (traced) the collector's seconds in it,
    # in order, and the share of the machine's CPU time its host took back
    # (steal) over the window
    steal = None
    if cpu0 and cpu1:
        d = [b - a for a, b in zip(cpu0, cpu1)]
        steal = d[7] / max(1, sum(d))
    gc_line = ("; gc s: " + " ".join(f"{c.gc_s:.3f}" for c in checks)
               if args.trace else "")
    print("window walls s: " + " ".join(f"{c.wall_s:.3f}" for c in checks)
          + "; cpu s: " + " ".join(f"{c.cpu_s:.3f}" for c in checks)
          + gc_line + f"; steal share: {steal}", file=sys.stderr, flush=True)
    for name, v in compared.items():
        print(f"compared {name} {v['value']} limit {v['limit']} "
              f"(of {v['of']})", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
