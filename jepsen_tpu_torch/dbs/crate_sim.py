"""A hermetic CrateDB lookalike: the HTTP _sql endpoint over the shared
mini SQL engine (crdb_sim.execute), with Crate's implicit `_version`
MVCC column managed by the engine. Every statement autocommits under
the shared flock (Crate has no multi-statement transactions — its
optimistic concurrency rides _version checks, which is exactly what the
crate suite exercises).

The port's copy of `jepsen_tpu/dbs/crate_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the crate suite on simulated nodes on this machine
(`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import crdb_sim
from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _reply(self, status: int, body: dict):
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))
        length = int(self.headers.get("Content-Length") or 0)
        try:
            stmt = json.loads(self.rfile.read(length) or b"{}")["stmt"]
        except (json.JSONDecodeError, KeyError):
            return self._reply(400, {"error": {"message": "bad request"}})

        def run(data):
            try:
                cols, rows, tag = crdb_sim.execute(data, stmt)
            except crdb_sim.SqlError as e:
                return ("error", e), None
            rowcount = 0
            parts = tag.split()
            if parts and parts[-1].isdigit():
                rowcount = int(parts[-1])
            # pure reads don't rewrite the state file (a full json dump
            # under the global lock per SELECT would dominate latency)
            new = None if tag.startswith("SELECT") else data
            return ("ok", (cols, rows, rowcount)), new

        kind, payload = self.store.transact(run)
        if kind == "error":
            e = payload
            code = 4091 if e.sqlstate == "23505" else 5000
            return self._reply(409 if e.sqlstate == "23505" else 400, {
                "error": {"message": f"duplicate key: {e.message}"
                          if e.sqlstate == "23505" else e.message,
                          "code": code}})
        cols, rows, rowcount = payload
        self._reply(200, {"cols": cols, "rows": [list(r) for r in rows],
                          "rowcount": rowcount})


def parse_args(argv):
    p = argparse.ArgumentParser(description="crate _sql sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=4200)
    p.add_argument("--name", default="sim")
    # real CrateDB's settings syntax: -Ckey=value (repeatable)
    p.add_argument("-C", action="append", default=[], dest="settings")
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    settings = dict(s.split("=", 1) for s in args.settings if "=" in s)
    port = int(settings.get("http.port", args.port))
    name = settings.get("node.name", args.name)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"crate-sim {name} serving on {port}, "
          f"data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """A crate-shaped tar.gz whose `crate` binary launches this sim.
    Starting a node that already runs does nothing, as for a real
    `crate` under start-stop-daemon."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.crate_sim", "crate", "crate-sim",
        data_path, mean_latency=mean_latency, python=python,
        pidfile="crate.pid",
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the crate suite against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under
    "crate")."""
    return sim_cluster(root, nodes, ports, "crate", "crate-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `crate.crate_test` on a `local_cluster` (`simbase.sim_test_fn`): the
    suite's nemesis on the no-op network (partitions recorded and
    healed), the dirty-read and lost-updates workloads' final reads
    behind their quiesce and readiness gate; fs-break refused."""
    def make(opts):
        from . import crate

        return crate.crate_test(opts)

    return sim_test_fn(cluster, "crate", make)


if __name__ == "__main__":
    serve()
