"""A hermetic Chronos lookalike: the scheduler API subset the chronos
suite drives — POST /scheduler/iso8601 with an R<count>/<start>/PT<n>S
repeating schedule, GET /scheduler/jobs — and, crucially, it actually
RUNS each job's shell command at the scheduled times (with bash, like
real Chronos executes on Mesos agents), so the suite's read-runs path
(parsing the run files jobs write) works identically against the sim
and a real cluster.

With --zk-port, the scheduler API is GATED on the local zookeeper
being reachable: real Chronos keeps its state and leader election in
zk (mesosphere.clj:38-46's zk:// URI), so a node that loses zk
answers 500 until it returns — which makes the suite's kill-zk
component nemesis observable at the client, not just in the process
table.

The port's copy of `jepsen_tpu/dbs/chronos_sim.py`: its members import
nothing of `jepsen_tpu` (they load neither torch nor jax), each launcher
starts nothing when its daemon already runs on the node, and it adds the
recipe that runs the chronos suite on simulated nodes on this machine
(`local_cluster`, `local_test_fn`), every job's command and run files
under its node's directory."""

from __future__ import annotations

import argparse
import datetime
import json
import os
import random
import re
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import Store, sim_cluster, sim_test_fn


def parse_iso8601_interval(s: str) -> tuple:
    """R<count>/<start>/PT<interval>S -> (count, start_epoch,
    interval_s)."""
    m = re.fullmatch(r"R(\d*)/([^/]+)/PT(\d+(?:\.\d+)?)S", s)
    if not m:
        raise ValueError(f"bad schedule {s!r}")
    count = int(m.group(1)) if m.group(1) else 1 << 30
    start = datetime.datetime.fromisoformat(
        m.group(2).replace("Z", "+00:00")).timestamp()
    return count, start, float(m.group(3))


class Runner(threading.Thread):
    """Executes one job's command at each scheduled time."""

    def __init__(self, job: dict):
        super().__init__(daemon=True)
        self.job = job

    def run(self):
        count, start, interval = parse_iso8601_interval(
            self.job["schedule"])
        for i in range(count):
            target = start + i * interval
            delay = target - time.time()
            if delay > 0:
                time.sleep(delay)
            try:
                subprocess.run(["bash", "-c", self.job["command"]],
                               timeout=300)
            except (OSError, subprocess.TimeoutExpired):
                pass


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    zk_port: int | None = None
    _zk_cache: tuple = (0.0, True)  # (checked_at, ok) — shared, racy-ok
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _zk_ok(self) -> bool:
        """TCP probe of the node's zookeeper, cached ~0.5s."""
        if self.zk_port is None:
            return True
        import socket

        checked, ok = Handler._zk_cache
        now = time.monotonic()
        if now - checked < 0.5:
            return ok
        try:
            with socket.create_connection(("127.0.0.1", self.zk_port),
                                          timeout=0.5):
                ok = True
        except OSError:
            ok = False
        Handler._zk_cache = (now, ok)
        return ok

    def _reply(self, status: int, body) -> None:
        payload = (body if isinstance(body, bytes)
                   else json.dumps(body).encode())
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))
        if not self.path.startswith("/scheduler/iso8601"):
            return self._reply(404, {"error": "no route"})
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)  # always drain: HTTP/1.1
        # keep-alive would parse an unread body as the next request
        if not self._zk_ok():
            return self._reply(500, {"error": "lost zookeeper"})
        try:
            job = json.loads(body)
            parse_iso8601_interval(job["schedule"])  # validate
        except (json.JSONDecodeError, KeyError, ValueError) as e:
            return self._reply(400, {"error": str(e)})

        def record(data):
            jobs = dict(data.get("jobs") or {})
            jobs[str(job["name"])] = job
            new = dict(data)
            new["jobs"] = jobs
            return None, new

        self.store.transact(record)
        Runner(job).start()
        self._reply(204, b"")

    def do_GET(self):
        if not self.path.startswith("/scheduler/jobs"):
            return self._reply(404, {"error": "no route"})
        if not self._zk_ok():
            return self._reply(500, {"error": "lost zookeeper"})

        def read(data):
            return list((data.get("jobs") or {}).values()), None

        self._reply(200, self.store.transact(read))


def parse_args(argv):
    p = argparse.ArgumentParser(description="chronos scheduler sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=4400)
    p.add_argument("--name", default="sim")
    p.add_argument("--master", default=None)  # mesos flag, tolerated
    p.add_argument("--zk-port", dest="zk_port", type=int, default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    Handler.zk_port = args.zk_port
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"chronos-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """The mesosphere-stack archive (mesosphere.clj + chronos.clj):
    zookeeper, mesos-master, mesos-slave, and chronos launchers —
    every role the real topology runs, sharing one state file. Starting
    a daemon that already runs on its node does nothing, as for a real
    binary under start-stop-daemon."""
    from .simbase import build_multi_sim_archive

    return build_multi_sim_archive(
        dest, "chronos-sim",
        {
            "chronos": "jepsen_tpu_torch.dbs.chronos_sim",
            "zookeeper-server": "jepsen_tpu_torch.dbs.zk_sim",
            "mesos-master": "jepsen_tpu_torch.dbs.mesos_sim",
            "mesos-slave": "jepsen_tpu_torch.dbs.mesos_sim",
        },
        data_path, mean_latency=mean_latency, python=python,
        pidfile={"chronos": "chronos.pid",
                 "zookeeper-server": "zookeeper.pid",
                 "mesos-master": "mesos-master.pid",
                 "mesos-slave": "mesos-slave.pid"},
    )


#: the settings of the stack's other daemons' ports (chronos's is the
#: suite's "ports")
ROLE_PORTS = ("zk_ports", "mesos_ports")


def local_cluster(root: str, nodes, ports: dict | None = None,
                  role_ports: dict | None = None) -> dict:
    """The test-map entries that run the chronos suite against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under
    "chronos"): each node's chronos port (`ports`), its zookeeper and
    mesos ports (`role_ports`, {setting of ROLE_PORTS: {node: port}}),
    and its job directory, <node dir>/jobs, where the jobs' commands
    write their run files; free ports where not given."""
    c = sim_cluster(root, nodes, ports, "chronos", "chronos-sim",
                    build_archive, roles=ROLE_PORTS, role_ports=role_ports)
    remote = c["remote"]
    c["chronos"]["job_dir"] = lambda n: os.path.join(remote.node_dir(n),
                                                     "jobs")
    return c


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `chronos.chronos_test` on a `local_cluster` (`simbase.sim_test_fn`):
    zookeeper, mesos (master on the first three sorted nodes, slave on the
    rest) and chronos brought up in that order, the suite's nemesis on
    the no-op network (partitions recorded and healed), the component
    killers acting on the node's daemons by pidfile; fs-break refused."""
    def make(opts):
        from . import chronos

        return chronos.chronos_test(opts)

    return sim_test_fn(cluster, "chronos", make)


if __name__ == "__main__":
    serve()
