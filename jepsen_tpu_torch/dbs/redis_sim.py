"""A hermetic RESP server covering both redis-like registers (GET/SET —
the raftis suite's surface, raftis.clj:37-42) and disque-like job
queues (ADDJOB/GETJOB/ACKJOB — disque.clj:141-152), plus PING and
CLUSTER MEET. Studied from the reference suites' command usage, not
copied.

Shared flock-guarded JSON state across member processes, like the other
sims. Job state: enqueued ids per queue plus an in-flight set — GETJOB
moves a job to in-flight with a timestamp, ACKJOB deletes it, and jobs
in-flight longer than RETRY_S are REDELIVERED on the next GETJOB
(disque's at-least-once semantics: a consumer that crashes between
GETJOB and ACKJOB must not strand the job).

The port's copy of `jepsen_tpu/dbs/redis_sim.py` (the disque job
commands included): it imports nothing of `jepsen_tpu`, and adds the
recipe that runs the raftis suite on simulated nodes on this machine
(`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import random
import socketserver
import sys
import time

from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn

RETRY_S = 1.0  # in-flight jobs older than this are redelivered


class Handler(socketserver.StreamRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0

    # -- wire -------------------------------------------------------------

    def _read_command(self) -> list | None:
        line = self.rfile.readline()
        if not line:
            return None
        line = line.strip()
        if not line.startswith(b"*"):
            # inline command
            return [p.decode() for p in line.split()]
        n = int(line[1:])
        args = []
        for _ in range(n):
            hdr = self.rfile.readline().strip()
            assert hdr.startswith(b"$"), hdr
            size = int(hdr[1:])
            args.append(self.rfile.read(size).decode())
            self.rfile.read(2)
        return args

    def _simple(self, s: str) -> None:
        self.wfile.write(b"+" + s.encode() + b"\r\n")

    def _error(self, s: str) -> None:
        self.wfile.write(b"-" + s.encode() + b"\r\n")

    def _bulk(self, s) -> None:
        if s is None:
            self.wfile.write(b"$-1\r\n")
            return
        b = s if isinstance(s, bytes) else str(s).encode()
        self.wfile.write(b"$%d\r\n%s\r\n" % (len(b), b))

    def _array(self, items) -> None:
        if items is None:
            self.wfile.write(b"*-1\r\n")
            return
        self.wfile.write(b"*%d\r\n" % len(items))
        for it in items:
            if isinstance(it, (list, tuple)):
                self._array(it)
            else:
                self._bulk(it)

    # -- dispatch ---------------------------------------------------------

    def handle(self):
        while True:
            try:
                args = self._read_command()
            except (ConnectionError, OSError, AssertionError):
                return
            if args is None:
                return
            if self.mean_latency > 0:
                time.sleep(random.expovariate(1.0 / self.mean_latency))
            cmd = args[0].upper()
            try:
                fn = getattr(self, f"cmd_{cmd.lower()}", None)
                if fn is None:
                    self._error(f"ERR unknown command '{cmd}'")
                else:
                    fn(args[1:])
                self.wfile.flush()
            except (ConnectionError, OSError):
                return

    # -- commands ---------------------------------------------------------

    def cmd_ping(self, args):
        self._simple("PONG")

    def cmd_set(self, args):
        k, v = args[0], args[1]

        def put(data):
            kv = dict(data.get("kv") or {})
            kv[k] = v
            new = dict(data)
            new["kv"] = kv
            return None, new

        self.store.transact(put)
        self._simple("OK")

    def cmd_get(self, args):
        k = args[0]

        def get(data):
            return (data.get("kv") or {}).get(k), None

        self._bulk(self.store.transact(get))

    def cmd_cluster(self, args):
        # CLUSTER MEET <ip> <port> — membership is implicit (shared
        # state), so meeting always succeeds
        self._simple("OK")

    def cmd_addjob(self, args):
        # ADDJOB <queue> <body> <ms-timeout> [...params]
        queue, body = args[0], args[1]

        def add(data):
            counter = int(data.get("job_counter") or 0) + 1
            job_id = f"D-{counter:08d}"
            jobs = dict(data.get("jobs") or {})
            jobs[job_id] = {"queue": queue, "body": body, "state": "queued"}
            queues = dict(data.get("queues") or {})
            queues[queue] = list(queues.get(queue) or []) + [job_id]
            new = dict(data)
            new["jobs"], new["queues"], new["job_counter"] = (
                jobs, queues, counter)
            return job_id, new

        self._bulk(self.store.transact(add))

    def cmd_getjob(self, args):
        # GETJOB [TIMEOUT ms] [COUNT n] FROM queue [queue ...]
        timeout_ms = 0
        count = 1
        queues: list = []
        i = 0
        while i < len(args):
            a = args[i].upper()
            if a == "TIMEOUT":
                timeout_ms = int(args[i + 1])
                i += 2
            elif a == "COUNT":
                count = int(args[i + 1])
                i += 2
            elif a == "FROM":
                queues = args[i + 1:]
                break
            else:
                i += 1

        def take(data):
            out = []
            jobs = dict(data.get("jobs") or {})
            qmap = dict(data.get("queues") or {})
            now = time.time()
            # redeliver in-flight jobs whose consumer went quiet
            for jid, job in jobs.items():
                if (job.get("state") == "active"
                        and now - job.get("taken_at", 0) > RETRY_S
                        and jid not in (qmap.get(job["queue"]) or [])):
                    qmap[job["queue"]] = (list(qmap.get(job["queue"]) or [])
                                          + [jid])
            for q in queues:
                pending = list(qmap.get(q) or [])
                while pending and len(out) < count:
                    jid = pending.pop(0)
                    if jid not in jobs:
                        continue  # acked while redelivery-queued: drop
                    job = dict(jobs[jid])
                    job["state"] = "active"
                    job["taken_at"] = now
                    jobs[jid] = job
                    out.append((q, jid, job["body"]))
                qmap[q] = pending
                if len(out) >= count:
                    break
            if not out and not any(
                j.get("state") == "active" for j in jobs.values()
            ):
                return None, None
            new = dict(data)
            new["jobs"], new["queues"] = jobs, qmap
            return out or None, new

        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            got = self.store.transact(take)
            if got is not None:
                return self._array([list(j) for j in got])
            if time.monotonic() >= deadline:
                return self._array(None)
            time.sleep(0.005)

    def cmd_ackjob(self, args):
        def ack(data):
            jobs = dict(data.get("jobs") or {})
            qmap = dict(data.get("queues") or {})
            n = 0
            for jid in args:
                if jid in jobs:
                    # drop from the job table AND any queue the
                    # redelivery scan may have put it back on — a
                    # dangling id would poison later GETJOBs
                    q = jobs[jid]["queue"]
                    if jid in (qmap.get(q) or []):
                        qmap[q] = [j for j in qmap[q] if j != jid]
                    del jobs[jid]
                    n += 1
            new = dict(data)
            new["jobs"], new["queues"] = jobs, qmap
            return n, new

        n = self.store.transact(ack)
        self.wfile.write(b":%d\r\n" % n)


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="redis/disque RESP sim",
                                allow_abbrev=False)
    p.add_argument("config_file", nargs="?", default=None)  # disque-server X
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=7711)
    p.add_argument("--name", default="sim")
    p.add_argument("--cluster", default=None)  # raftis flag, tolerated
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server(("127.0.0.1", args.port), Handler)
    print(f"redis-sim {args.name} serving RESP on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, binary: str = "disque-server",
                  mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.redis_sim", binary, f"{binary}-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the raftis suite against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under
    "raftis"): this simulator's archive with a `raftis` binary."""
    return sim_cluster(
        root, nodes, ports, "raftis", "raftis-sim",
        lambda dest, data: build_archive(dest, data, binary="raftis"))


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    raftis suite (`raftis.raftis_test`) on a `local_cluster`
    (`simbase.sim_test_fn`). The suite's nemesis (--nemesis, partitions
    by default, on the suite's 5-s start/stop cycle) runs on the no-op
    network; start-kill acts on the simulated nodes; start-stop's
    `killall raftis` finds no process of that name (the nodes are Python
    processes); fs-break is refused."""
    def make(opts):
        from . import raftis

        return raftis.raftis_test(opts)

    return sim_test_fn(cluster, "raftis", make)

if __name__ == "__main__":
    serve()
