"""A placeholder daemon for non-client-facing cluster roles.

Multi-daemon systems put processes beside the SQL/client server that
tests must be able to start, health-check, kill, and restart
independently — tidb's pd-server and tikv-server
(tidb/src/tidb/db.clj:14-31), mysql cluster's ndb_mgmd
and ndbd (mysql-cluster/src/jepsen/mysql_cluster.clj:
53-57). Their internal protocols aren't what the framework checks;
what matters is the PROCESS TOPOLOGY: distinct pids, distinct ports,
distinct logs, ordered bring-up, and component-targeted fault
injection. This sim binds the role's port, answers `ping` with
`pong\n` (the readiness probe), and otherwise just stays alive.

The port is taken from whichever of the real binaries' addressing
flags appears (so suite daemon args can mirror the reference verbatim):
`--port N`, `--client-urls http://0.0.0.0:N` (pd-server), or
`--addr 0.0.0.0:N` (tikv-server / ndbd-style). Unknown flags are
accepted and ignored, like the real binaries' rich option surfaces.

The port's copy of `jepsen_tpu/dbs/role_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax).
"""

from __future__ import annotations

import argparse
import socketserver
import sys


class Handler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            while True:
                line = self.rfile.readline()
                if not line:
                    return
                if line.strip().lower() == b"ping":
                    self.wfile.write(b"pong\n")
                else:
                    self.wfile.write(b"ok\n")
        except OSError:
            pass


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def _port_from_args(args) -> int:
    if args.port is not None:
        return args.port
    for url in (args.client_urls, args.addr):
        if url:
            tail = url.rsplit(":", 1)[-1].strip("/")
            if tail.isdigit():
                return int(tail)
    raise SystemExit("role_sim: no --port/--client-urls/--addr given")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--client-urls", dest="client_urls", default=None)
    p.add_argument("--addr", default=None)
    p.add_argument("--role", default="role")
    # shared launcher-script flags + the real binaries' surfaces
    p.add_argument("--data", default=None)
    p.add_argument("--mean-latency", dest="mean_latency", type=float,
                   default=0.0)
    args, _unknown = p.parse_known_args(argv)
    port = _port_from_args(args)
    srv = Server(("0.0.0.0", port), Handler)
    print(f"role_sim {args.role} listening on {port}", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


if __name__ == "__main__":
    main(sys.argv[1:])
