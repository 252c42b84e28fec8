"""Command-line runner of the port: `python -m jepsen_tpu_torch watch`,
`serve`, `doctor` and `fuzz`, and `single_test_cmd`'s `test`, `analyze`
and `resume` for a suite's own main (the port's copy of the parts of
`jepsen_tpu.cli` these subcommands use):

    from jepsen_tpu_torch import cli

    def my_test(opts): ...   # a test map: name, checker, ...

    if __name__ == "__main__":
        cli.main(cli.single_test_cmd(my_test))

Exit codes, as the JAX package's: 0 success, 1 a definite falsification,
254 bad arguments or an unknown command, 255 an internal error (a fault
of the card included), and 143 when a SIGTERM drained a run (saved for
`resume`) or the daemon.

`test`, `analyze`, `resume`, `watch`, `serve` and `fuzz` take
`--device`: the default is the card (raising when CUDA is absent, before
any node is provisioned or any store read); `--device cpu` runs the
kernels' plain versions. `doctor` examines a device list (every card by
default, `--devices`, or `--mesh N` CPU entries) and exits 0 when it is
healthy, 1 otherwise. `serve` serves the store's web UI (`web.py`), or
with `--daemon` the resident verdict service.
"""

from __future__ import annotations

import argparse
import logging
import sys
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("jepsen_tpu_torch.cli")

#: The reference's default cluster (cli.clj:17)
DEFAULT_NODES = ["n1", "n2", "n3", "n4", "n5"]


class CliError(Exception):
    """Bad arguments: exits 254."""


class _Parser(argparse.ArgumentParser):
    """argparse, but option errors raise CliError (exit 254) instead of
    argparse's exit(2). conflict_handler="resolve" lets a suite's
    opt_spec redefine a standard option."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("conflict_handler", "resolve")
        super().__init__(*args, **kwargs)

    def error(self, message):
        raise CliError(message)


@dataclass
class Subcommand:
    """One CLI subcommand (the reference's subcommand-spec map,
    cli.clj:229-243): `opt_fn` transforms the parsed options before
    `run`."""

    run: Callable[[dict], int | None]
    opt_spec: Callable[[argparse.ArgumentParser], None] | None = None
    opt_fn: Callable[[dict], dict] | None = None
    usage: str | None = None
    extra_opts: list = field(default_factory=list)


def _device_opt(p) -> None:
    p.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="Where the checks run: the card (default; raises without "
        "CUDA) or cpu (the kernels' plain versions)")


def run_cli(subcommands: dict, argv: list[str]) -> int:
    """Dispatch a subcommand; returns the process exit code."""
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO, format="%(levelname)s [%(name)s] %(message)s")
    command = argv[0] if argv else None
    if command not in subcommands:
        print(f"Usage: {sys.argv[0]} COMMAND [OPTIONS ...]")
        print("Commands:", ", ".join(sorted(subcommands)))
        return 254
    sub = subcommands[command]
    parser = _Parser(prog=f"{sys.argv[0]} {command}", description=sub.usage)
    if sub.opt_spec is not None:
        sub.opt_spec(parser)
    for add in sub.extra_opts:
        add(parser)
    try:
        try:
            opts = vars(parser.parse_args(argv[1:]))
            if sub.opt_fn is not None:
                opts = sub.opt_fn(opts)
            code = sub.run(opts)
        except CliError as e:
            print(str(e), file=sys.stderr)
            return 254
        return int(code) if code else 0
    except SystemExit as e:  # argparse --help, or a run fn calling sys.exit
        if isinstance(e.code, int) or e.code is None:
            return e.code or 0
        print(e.code, file=sys.stderr)
        return 255
    except Exception:  # noqa: BLE001
        log.exception("internal error:")
        return 255


def main(subcommands: dict, argv: list[str] | None = None) -> None:
    sys.exit(run_cli(subcommands, sys.argv[1:] if argv is None else argv))


# ---------------------------------------------------------------------------
# The standard test options (cli.clj:54-225)

def test_opt_spec(parser: argparse.ArgumentParser) -> None:
    """The standard test options (cli.clj:54-92)."""
    parser.add_argument(
        "-n", "--node", action="append", default=None, metavar="HOSTNAME",
        help="Node to run the test on; repeat for multiple nodes.",
    )
    parser.add_argument(
        "--nodes", default=None, metavar="NODE_LIST",
        help="Comma-separated list of node hostnames.",
    )
    parser.add_argument(
        "--nodes-file", default=None, metavar="FILENAME",
        help="File containing node hostnames, one per line.",
    )
    parser.add_argument("--username", default="root", help="Username for logins")
    parser.add_argument("--password", default="root", help="Password for sudo")
    parser.add_argument(
        "--strict-host-key-checking", action="store_true", default=False,
        help="Whether to check host keys",
    )
    parser.add_argument(
        "--ssh-private-key", default=None, metavar="FILE",
        help="Path to an SSH identity file",
    )
    parser.add_argument(
        "--dummy-ssh", action="store_true", default=False,
        help="Don't actually SSH; pretend every command succeeds "
        "(control.clj *dummy* mode)",
    )
    parser.add_argument(
        "--concurrency", default="1n", metavar="NUMBER",
        help="How many workers? An integer, optionally followed by n "
        "to multiply by the node count (e.g. 3n).",
    )
    parser.add_argument(
        "--test-count", type=int, default=1, metavar="NUMBER",
        help="How many times to repeat the test",
    )
    parser.add_argument(
        "--time-limit", type=int, default=60, metavar="SECONDS",
        help="How long the main body of the test runs, in seconds",
    )
    parser.add_argument(
        "--store-dir", default=None, metavar="DIR",
        help="Root directory for test results (default ./store)",
    )
    # SUPPRESS, not None: test maps do test.update(opts), and a
    # present-but-None key would clobber a suite's own value
    parser.add_argument(
        "--nemesis", default=argparse.SUPPRESS, metavar="SPEC",
        help="Fault mode: a suite registry name, or a comma-separated "
        "list of fault families. Suites may redefine this option.",
    )
    parser.add_argument(
        "--nemesis-interval", type=float, default=argparse.SUPPRESS,
        metavar="SECONDS",
        help="Seconds between scheduled nemesis operations (default 10)",
    )
    parser.add_argument(
        "--nemesis-schedule", default=argparse.SUPPRESS, metavar="FILE",
        help="Replay an exact fault schedule from a JSON schedule document",
    )
    parser.add_argument(
        "--seed", type=int, default=argparse.SUPPRESS, metavar="N",
        help="Seed the nemesis package's RNG so the fault schedule is "
        "reproducible",
    )
    parser.add_argument(
        "--checker", default=argparse.SUPPRESS, metavar="NAME",
        help="Replace the suite's checker with a registered one "
        "(jepsen_tpu_torch.checker.REGISTRY): linearizable, cycle, "
        "timeline, clock, perf, recovery, unbridled-optimism",
    )


def parse_concurrency(opts: dict, key: str = "concurrency") -> dict:
    """\"3n\" -> 3 * node count; plain integers parse directly
    (cli.clj:130-145)."""
    c = str(opts.get(key, "1n"))
    unit = 1
    if c.endswith("n"):
        unit = len(opts.get("nodes") or [])
        c = c[:-1]
    try:
        n = int(c)
    except ValueError:
        raise CliError(
            f"--concurrency {opts.get(key)!r} should be an integer "
            "optionally followed by n"
        ) from None
    opts[key] = n * unit
    return opts


def parse_nodes(opts: dict) -> dict:
    """Merge --node/--nodes/--nodes-file into a single :nodes list
    (cli.clj:147-182)."""
    node = opts.pop("node", None)
    nodes = opts.pop("nodes", None)
    nodes_file = opts.pop("nodes_file", None)
    out: list[str] = []
    if nodes_file:
        with open(nodes_file) as f:
            out.extend(line.strip() for line in f if line.strip())
    if nodes:
        out.extend(s.strip() for s in str(nodes).split(",") if s.strip())
    if node:
        out.extend(node)
    opts["nodes"] = out or list(DEFAULT_NODES)
    return opts


def rename_ssh_options(opts: dict) -> dict:
    """Collect ssh-related options under an :ssh map (cli.clj:200-216)."""
    opts["ssh"] = {
        "username": opts.pop("username", "root"),
        "password": opts.pop("password", "root"),
        "strict_host_key_checking": opts.pop("strict_host_key_checking", False),
        "private_key_path": opts.pop("ssh_private_key", None),
        "dummy": opts.pop("dummy_ssh", False),
    }
    return opts


def test_opt_fn(opts: dict) -> dict:
    """The standard transform chain (cli.clj:218-225)."""
    return parse_concurrency(parse_nodes(rename_ssh_options(opts)))


def _apply_checker(test_map: dict, opts: dict) -> dict:
    """--checker NAME replaces the suite's checker with a registered one
    (checker.resolve, on opts["device"]); absent leaves the suite's
    choice alone."""
    name = opts.get("checker")
    if isinstance(name, str):
        from . import checker as checker_mod

        test_map["checker"] = checker_mod.resolve(
            name, device=opts.get("device"))
    return test_map


def _verdict_code(test) -> int:
    """A definite False or a missing verdict fails (1); "unknown" passes
    (cli.clj:362: keywords are truthy)."""
    valid = (test.get("results") or {}).get("valid")
    return 1 if valid is False or valid is None else 0


def _run_test(test_fn, opts) -> int:
    """The `test` subcommand body (cli.clj:355-364): run --test-count
    times; exit 1 if any run's results are invalid. The device is
    resolved first, so without CUDA and without `--device cpu` this
    raises before the test map is built or a node touched."""
    from . import core
    from .device import resolve

    resolve(opts.get("device"))
    for _ in range(int(opts.get("test_count", 1))):
        test_map = _apply_checker(test_fn(dict(opts)), opts)
        if opts.get("store_dir"):
            test_map.setdefault("store_dir", opts["store_dir"])
        if _verdict_code(core.run(test_map)):
            return 1
    return 0


def _run_analyze(test_fn, opts) -> int:
    """The `analyze` subcommand (cli.clj:366-397): rebuild the test from
    the options (fresh checkers), attach the latest stored history,
    analyse it again — no cluster needed. The device is resolved first,
    so without CUDA and without `--device cpu` this raises before
    anything is read."""
    from . import core, store
    from .device import resolve

    resolve(opts.get("device"))
    cli_test = _apply_checker(test_fn(dict(opts)), opts)
    stored = store.latest(store_dir=opts.get("store_dir"))
    if stored is None:
        raise RuntimeError("Not sure what the last test was")
    if stored.get("name") != cli_test.get("name"):
        raise RuntimeError(
            f"Stored test ({stored.get('name')}) and CLI test "
            f"({cli_test.get('name')}) have different names; aborting"
        )
    test = {k: v for k, v in stored.items() if k != "results"}
    test.update(cli_test)
    test["history"] = stored["history"]
    test["start_time"] = stored["start_time"]
    if opts.get("store_dir"):
        test["store_dir"] = opts["store_dir"]
    test = core.analyze(test)
    core.log_results(test)
    return _verdict_code(test)


def _resume_opt_spec(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "run_dir", nargs="?", default=None, metavar="RUN_DIR",
        help="A store/<name>/<time> run directory to resume "
        "(default: the latest run in the store).",
    )


def _run_resume(test_fn, opts) -> int:
    """The `resume` subcommand: reload a preempted run's checkpoint and
    torn-tail-tolerant WAL, heal every fault left in the active-fault
    ledger, and continue to the original time budget (core.resume).
    Exit codes match `test`; a second preemption exits 143 with the
    state saved for another resume. The device is resolved first."""
    import os

    from . import core, store
    from .device import resolve

    resolve(opts.get("device"))
    run_dir = opts.pop("run_dir", None)
    store_dir = opts.get("store_dir")
    if run_dir:
        d = os.path.abspath(run_dir)
        if not os.path.isdir(d):
            raise CliError(f"no such run directory: {run_dir}")
        time_s = os.path.basename(d)
        name = os.path.basename(os.path.dirname(d))
        store_dir = store_dir or os.path.dirname(os.path.dirname(d))
    else:
        found = store._resolve_latest(store_dir)
        if found is None:
            raise RuntimeError("Not sure what the last test was")
        name, time_s = found
    test_map = _apply_checker(test_fn(dict(opts)), opts)
    if test_map.get("name") != name:
        raise RuntimeError(
            f"Stored run ({name}) and CLI test ({test_map.get('name')}) "
            "have different names; aborting")
    test_map["start_time"] = time_s
    if store_dir:
        test_map["store_dir"] = store_dir
    return _verdict_code(core.resume(test_map))


def single_test_cmd(
    test_fn: Callable[[dict], dict],
    opt_spec: Callable[[argparse.ArgumentParser], None] | None = None,
    opt_fn: Callable[[dict], dict] | None = None,
    usage: str | None = None,
) -> dict:
    """`test` + `analyze` + `resume` subcommands for a test-map
    constructor (cli.clj:323-397), with the standard options and
    `--device`. opt_spec adds suite-specific options; opt_fn composes
    after test_opt_fn."""
    fn = (lambda o: opt_fn(test_opt_fn(o))) if opt_fn else test_opt_fn
    extra = [_device_opt] + ([opt_spec] if opt_spec else [])
    return {
        "test": Subcommand(
            run=lambda opts: _run_test(test_fn, opts),
            opt_spec=test_opt_spec,
            extra_opts=extra,
            opt_fn=fn,
            usage=usage or "Run a test with standard options.",
        ),
        "analyze": Subcommand(
            run=lambda opts: _run_analyze(test_fn, opts),
            opt_spec=test_opt_spec,
            extra_opts=extra,
            opt_fn=fn,
            usage="Re-analyze the latest stored history with fresh checkers.",
        ),
        "resume": Subcommand(
            run=lambda opts: _run_resume(test_fn, opts),
            opt_spec=test_opt_spec,
            extra_opts=extra + [_resume_opt_spec],
            opt_fn=fn,
            usage="Resume a preempted run from its checkpoint: heal "
            "leftover faults, reload the WAL, continue to the original "
            "time budget.",
        ),
    }


def serve_cmd() -> dict:
    """The `serve` subcommand: the web UI over the store (cli.clj:306-321),
    or, with ``--daemon``, the resident verdict service (serve/): warmed
    kernels behind the durable check queue."""

    def opt_spec(p):
        p.add_argument("-b", "--host", default="127.0.0.1", help="Bind host")
        p.add_argument("-p", "--port", type=int, default=8181,
                       help="Bind port")
        p.add_argument(
            "--store-dir", default=None, metavar="DIR",
            help="Root directory for test results (default ./store)")
        p.add_argument(
            "--daemon", action="store_true",
            help="Run the resident verdict daemon (submit/verdict/stream "
            "API) instead of the web UI")
        p.add_argument(
            "--queue-dir", default=None, metavar="DIR",
            help="[daemon] Durable queue directory (default "
            "<store-dir>/serve-queue)")
        p.add_argument(
            "--bundle-dir", default=None, metavar="DIR",
            help="[daemon] Engine bundle directory; 'off' disables "
            "(default <queue-dir>/bundle)")
        p.add_argument(
            "--max-pending", type=int, default=None, metavar="N",
            help="[daemon] Admission bound: reject submissions past N "
            "pending jobs (HTTP 429 + Retry-After)")
        p.add_argument(
            "--max-attempts", type=int, default=None, metavar="N",
            help="[daemon] Dead-letter bound: quarantine a job whose check "
            "has crashed the worker N times (default 3)")

    def run(opts):
        from . import web

        # Preimport before the socket goes up: the first import of core
        # loads torch, and a SIGTERM arriving during those seconds would
        # hit the default disposition instead of the drain handler.
        from .core import DrainSignal  # noqa: F401

        if opts.get("daemon"):
            from .serve.daemon import run_daemon

            return run_daemon(opts)
        server = web.serve(
            host=opts["host"], port=opts["port"], store_dir=opts.get("store_dir")
        )
        log.info("Listening on http://%s:%s/", opts["host"], server.server_port)
        # SIGTERM drains and exits 143 so process managers see a clean
        # signal-shaped stop; ctrl-C still exits 0
        return web.serve_until_signal(server)

    return {"serve": Subcommand(run=run, opt_spec=opt_spec,
                                extra_opts=[_device_opt])}


def watch_cmd() -> dict:
    """The `watch` subcommand: stream a history WAL or foreign trace
    (Jepsen EDN, OTLP-ish span JSONL) through the online frontiers,
    printing one JSON verdict line per window. With a state dir the
    verdicts are crash-safe: a killed watch resumed over the same stream
    re-emits nothing and misses nothing."""

    def opt_spec(p):
        p.add_argument(
            "trace", metavar="PATH",
            help="history WAL (history.wal.jsonl), Jepsen EDN history, "
            "or span-log JSONL")
        p.add_argument(
            "--follow", action="store_true",
            help="Tail the WAL for appended ops instead of reading it once "
            "(native WALs only)")
        p.add_argument(
            "--window", type=int, default=256, metavar="N",
            help="Ops per verdict window (the lag bound)")
        p.add_argument(
            "--workload", default="cycle", metavar="NAME",
            help="Registry workload that rehydrates + checks the ops "
            "(cycle, register)")
        p.add_argument(
            "--state-dir", default=None, metavar="DIR",
            help="Durable session state: the fsync'd verdict log and the "
            "closure/per-key memo journal (resume after a kill)")
        p.add_argument(
            "--abort-on-invalid", action="store_true",
            help="Stop consuming at the first definite falsification")
        p.add_argument(
            "--max-ops", type=int, default=None, metavar="N",
            help="Stop after N ops (a deterministic end for a tailed "
            "stream)")
        p.add_argument(
            "--poll", type=float, default=0.05, metavar="SECONDS",
            help="Tail poll interval")
        p.add_argument(
            "--deadline-ms", type=int, default=None, metavar="MS",
            help="Wall-clock budget per verdict window: keys that do not "
            "fit get 'unknown: deadline' this window and are retried on "
            "the next")

    def run(opts):
        from .online.watch import run_watch

        try:
            return run_watch(opts)
        except ValueError as e:
            raise CliError(str(e)) from e

    return {"watch": Subcommand(
        run=run, opt_spec=opt_spec, extra_opts=[_device_opt],
        usage="Stream a WAL or foreign trace through the online checker "
        "frontiers; one JSON verdict line per window, exit 1 on a "
        "definite falsification.")}


def doctor_cmd() -> dict:
    """The `doctor` subcommand: examine a device list — topology,
    per-device K2 parity against the host search, the dealt K2, K1's
    block shards and K3's row blocks against the host, memory headroom
    (jepsen_tpu_torch/doctor.py) — printing the report as JSON."""

    def opt_spec(p):
        p.add_argument(
            "--mesh", type=int, default=None, metavar="N",
            help="Examine N CPU entries (the plain versions dealt N ways, "
            "the counterpart of a virtual CPU mesh)")
        p.add_argument(
            "--devices", default=None, metavar="LIST",
            help="Comma-separated devices to examine, repeats allowed "
            "(e.g. cuda:0,cuda:0); default every CUDA device")
        p.add_argument(
            "--closure-n", type=int, default=100, metavar="N",
            help="Side of the biggest closure parity matrix")

    def run(opts):
        import json

        from .doctor import diagnose

        if opts.get("mesh") is not None and opts.get("devices"):
            raise CliError("give --mesh or --devices, not both")
        devices = None
        if opts.get("mesh") is not None:
            if opts["mesh"] < 1:
                raise CliError("--mesh takes a positive count")
            devices = ["cpu"] * opts["mesh"]
        elif opts.get("devices"):
            devices = [d.strip() for d in opts["devices"].split(",")]
        try:
            report = diagnose(devices=devices,
                              closure_n=opts.get("closure_n", 100))
        except ValueError as e:
            raise CliError(str(e)) from e
        print(json.dumps(report, indent=2, sort_keys=True))
        return 0 if report["ok"] else 1

    return {"doctor": Subcommand(
        run=run, opt_spec=opt_spec,
        usage="Examine a device list: topology, per-device parity, the "
        "dealt and sharded paths' parity, memory headroom.")}


def fuzz_cmd() -> dict:
    """The `fuzz` subcommand: coverage-guided fault-schedule fuzzing over
    batched simulated clusters (fuzz/loop.py). Each round simulates
    --clusters seeded clusters in one launch of the sim kernel, scores
    every trace through the cycle checker's closures, and keeps
    schedules that hit new coverage buckets; discovered anomalies land
    in <corpus-dir>/anomalies.jsonl. Prints the corpus summary as
    JSON."""

    def opt_spec(p):
        p.add_argument(
            "--corpus-dir", default="store/fuzz", metavar="DIR",
            help="Corpus directory (checkpointed each round; resumes)")
        p.add_argument(
            "--rounds", type=int, default=4, metavar="N",
            help="Total rounds the corpus should reach (a resumed corpus "
            "runs only the remainder)")
        p.add_argument(
            "--clusters", type=int, default=256, metavar="N",
            help="Simulated clusters per round (one launch)")
        p.add_argument(
            "--seed", type=int, default=0, metavar="N",
            help="Fuzz seed: the whole run is a pure function of it")
        p.add_argument(
            "--families", default=None, metavar="LIST",
            help="Comma-separated fault families to draw schedules from "
            "(default: all six)")
        p.add_argument(
            "--engine", default=None, choices=("host",),
            help="Simulate on the host (the JAX package's host engine) "
            "instead of the sim kernel on --device")
        p.add_argument(
            "--fuzz-nodes", type=int, default=None, metavar="N",
            help="Simulated nodes per cluster (default 5)")
        p.add_argument(
            "--keys", type=int, default=None, metavar="N",
            help="Keys per simulated workload (default 8)")
        p.add_argument(
            "--txns", type=int, default=None, metavar="N",
            help="Transactions per simulated cluster (default 24)")
        p.add_argument(
            "--fault-slots", type=int, default=None, metavar="N",
            help="Fault slots per schedule (default 8)")
        p.add_argument(
            "--deadline-ms", type=int, default=None, metavar="MS",
            help="Wall-clock budget per round's scoring: traces whose "
            "closures don't fit score unknown (never kept)")

    def run(opts):
        import json

        from .fuzz.loop import run_fuzz

        summary = run_fuzz({
            "corpus_dir": opts["corpus_dir"],
            "rounds": opts.get("rounds"),
            "clusters": opts.get("clusters"),
            "seed": opts.get("seed"),
            "families": opts.get("families"),
            "engine": opts.get("engine"),
            "device": opts.get("device"),
            "nodes_n": opts.get("fuzz_nodes"),
            "keys": opts.get("keys"),
            "txns": opts.get("txns"),
            "fault_slots": opts.get("fault_slots"),
            "deadline_ms": opts.get("deadline_ms"),
        })
        print(json.dumps(summary, indent=2, sort_keys=True))
        return 0

    return {"fuzz": Subcommand(
        run=run, opt_spec=opt_spec, extra_opts=[_device_opt],
        usage="Coverage-guided fault-schedule fuzzing over batched "
        "simulated clusters; anomalies accumulate in the corpus.")}
