"""A hermetic Mesos master/slave lookalike — liveness scenery for the
chronos suite's real topology (reference:
chronos/src/jepsen/mesosphere.clj:57-119 starts
mesos-master on the first 3 sorted nodes and mesos-slave on the rest).

The chronos SIM executes job commands itself (standing in for the
Mesos agents), so this daemon's observable surface is its process
lifecycle: the suite's readiness gating probes it, the kill-mesos-*
nemeses stop/restart it, and log snarfing collects its log. It serves
the two endpoints real tooling pokes: GET /state (role + leader
metadata, master's state.json shape) and GET /health (204).

The port's copy of `jepsen_tpu/dbs/mesos_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax)."""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class Handler(BaseHTTPRequestHandler):
    role: str = "master"
    name: str = "sim"
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(),
                                        fmt % args))
        sys.stdout.flush()

    def _reply(self, status: int, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))
        if self.path.startswith("/health"):
            return self._reply(204, b"")
        if self.path.startswith("/state"):
            return self._reply(200, json.dumps({
                "version": "0.23.0",
                "hostname": self.name,
                "role": self.role,
                "activated_slaves": 1,
            }).encode())
        return self._reply(404, b'{"error": "no route"}')


def parse_args(argv):
    p = argparse.ArgumentParser(description="mesos master/slave sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)  # uniform sim surface
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=5050)
    p.add_argument("--name", default="sim")
    p.add_argument("--role", default="master",
                   choices=["master", "slave"])
    # real mesos flags, tolerated (mesosphere.clj:77-119)
    p.add_argument("--zk", default=None)
    p.add_argument("--master", default=None)
    p.add_argument("--quorum", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.role = args.role
    Handler.name = args.name
    Handler.mean_latency = args.mean_latency
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"mesos-{args.role} sim {args.name} serving on {args.port}")
    sys.stdout.flush()
    httpd.serve_forever()


if __name__ == "__main__":
    serve()
