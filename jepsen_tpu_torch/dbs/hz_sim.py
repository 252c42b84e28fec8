"""A hermetic Hazelcast lookalike: an HTTP/JSON server exposing the
distributed data structures the hazelcast suite drives — queue, lock,
atomic long, atomic reference, id-generator, and maps (reference
behavior: hazelcast/src/jepsen/hazelcast.clj:155-346 —
cited for parity, not copied; the reference uses the Hazelcast Java
client against a JVM server, this speaks plain HTTP).

Like etcd_sim/zk_sim, every member process shares one flock-guarded
JSON state file, so the simulated cluster is linearizable by
construction; a --mean-latency knob adds exponential jitter so recorded
histories have real concurrency windows.

Semantics matched to Hazelcast's structures:
  - queue: FIFO put / poll-with-timeout (IQueue.put / IQueue.poll)
  - lock:  tryLock(wait-ms) with session ownership + reentrancy count,
           unlock by non-owner is an IllegalMonitorState error
  - atomic-long: incrementAndGet
  - atomic-ref:  get / compareAndSet
  - id-gen: block-allocated ids — each server process claims blocks of
            BLOCK ids from shared state and hands them out locally
            (unique but non-contiguous, like IdGenerator)
  - map: get / putIfAbsent / replace(key, old, new)

The port's copy of `jepsen_tpu/dbs/hz_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the hazelcast suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn

ID_BLOCK = 10_000


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    # id-generator block state, local to this server process
    _id_lock = threading.Lock()
    _id_next = 0
    _id_limit = 0

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _jitter(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))

    def _reply(self, status: int, body: dict):
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _error(self, status: int, kind: str, message: str = ""):
        self._reply(status, {"error": kind, "message": message})

    # -- dispatch ---------------------------------------------------------

    def do_POST(self):
        self._jitter()
        length = int(self.headers.get("Content-Length") or 0)
        try:
            req = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._error(400, "bad-json")
        parts = [p for p in self.path.split("/") if p]
        if len(parts) != 2:
            return self._error(404, "no-route", self.path)
        kind, verb = parts
        name = f"op_{kind}_{verb}".replace("-", "_")
        handler = getattr(self, name, None)
        if handler is None:
            return self._error(404, "no-route", self.path)
        handler(req)

    def do_GET(self):
        if self.path == "/health":
            return self._reply(200, {"status": "ok"})
        self._error(404, "no-route", self.path)

    # -- queue ------------------------------------------------------------

    def op_queue_put(self, req):
        name, value = req.get("name", "default"), req["value"]

        def put(data):
            qs = dict(data.get("queues") or {})
            qs[name] = list(qs.get(name) or []) + [value]
            new = dict(data)
            new["queues"] = qs
            return None, new

        self.store.transact(put)
        self._reply(200, {"ok": True})

    def op_queue_poll(self, req):
        name = req.get("name", "default")
        timeout_ms = req.get("timeout_ms", 0)
        deadline = time.monotonic() + timeout_ms / 1000.0

        def poll(data):
            q = list((data.get("queues") or {}).get(name) or [])
            if not q:
                return None, None
            head, rest = q[0], q[1:]
            new = dict(data)
            qs = dict(new.get("queues") or {})
            qs[name] = rest
            new["queues"] = qs
            return head, new

        while True:
            got = self.store.transact(poll)
            if got is not None or time.monotonic() >= deadline:
                return self._reply(200, {"value": got})
            time.sleep(0.001)

    # -- lock -------------------------------------------------------------

    def op_lock_acquire(self, req):
        name = req.get("name", "default")
        session = req["session"]
        timeout_ms = req.get("timeout_ms", 0)
        deadline = time.monotonic() + timeout_ms / 1000.0

        def try_lock(data):
            locks = dict(data.get("locks") or {})
            cur = locks.get(name)
            if cur is None or cur["owner"] == session:
                locks[name] = {"owner": session,
                               "count": (cur["count"] + 1) if cur else 1}
                new = dict(data)
                new["locks"] = locks
                return True, new
            return False, None

        while True:
            if self.store.transact(try_lock):
                return self._reply(200, {"acquired": True})
            if time.monotonic() >= deadline:
                return self._reply(200, {"acquired": False})
            time.sleep(0.005)

    def op_lock_release(self, req):
        name = req.get("name", "default")
        session = req["session"]

        def unlock(data):
            locks = dict(data.get("locks") or {})
            cur = locks.get(name)
            if cur is None or cur["owner"] != session:
                return False, None
            if cur["count"] > 1:
                locks[name] = {"owner": session, "count": cur["count"] - 1}
            else:
                del locks[name]
            new = dict(data)
            new["locks"] = locks
            return True, new

        if self.store.transact(unlock):
            return self._reply(200, {"released": True})
        # Hazelcast throws IllegalMonitorStateException here
        self._error(409, "not-lock-owner",
                    "Current thread is not owner of the lock!")

    # -- atomic long ------------------------------------------------------

    def op_atomic_long_inc(self, req):
        name = req.get("name", "default")

        def inc(data):
            longs = dict(data.get("atomic_longs") or {})
            v = int(longs.get(name) or 0) + 1
            longs[name] = v
            new = dict(data)
            new["atomic_longs"] = longs
            return v, new

        self._reply(200, {"value": self.store.transact(inc)})

    # -- atomic reference -------------------------------------------------

    def op_atomic_ref_get(self, req):
        name = req.get("name", "default")

        def get(data):
            return (data.get("atomic_refs") or {}).get(name), None

        self._reply(200, {"value": self.store.transact(get)})

    def op_atomic_ref_cas(self, req):
        name = req.get("name", "default")
        old, new_v = req.get("old"), req.get("new")

        def cas(data):
            refs = dict(data.get("atomic_refs") or {})
            if refs.get(name) != old:
                return False, None
            refs[name] = new_v
            new = dict(data)
            new["atomic_refs"] = refs
            return True, new

        self._reply(200, {"swapped": self.store.transact(cas)})

    # -- id generator -----------------------------------------------------

    def op_id_gen_new(self, req):
        cls = type(self)
        with cls._id_lock:
            if cls._id_next >= cls._id_limit:
                def claim(data):
                    base = int(data.get("id_gen_block") or 0)
                    new = dict(data)
                    new["id_gen_block"] = base + 1
                    return base * ID_BLOCK, new

                cls._id_next = self.store.transact(claim)
                cls._id_limit = cls._id_next + ID_BLOCK
            v = cls._id_next
            cls._id_next += 1
        self._reply(200, {"value": v})

    # -- map --------------------------------------------------------------

    def op_map_get(self, req):
        name, key = req.get("name", "default"), str(req["key"])

        def get(data):
            return ((data.get("maps") or {}).get(name) or {}).get(key), None

        self._reply(200, {"value": self.store.transact(get)})

    def op_map_put_if_absent(self, req):
        name, key = req.get("name", "default"), str(req["key"])
        value = req["value"]

        def pia(data):
            maps = dict(data.get("maps") or {})
            m = dict(maps.get(name) or {})
            if key in m:
                return m[key], None  # existing value, no write
            m[key] = value
            maps[name] = m
            new = dict(data)
            new["maps"] = maps
            return None, new

        self._reply(200, {"previous": self.store.transact(pia)})

    def op_map_replace(self, req):
        name, key = req.get("name", "default"), str(req["key"])
        old, new_v = req["old"], req["new"]

        def rep(data):
            maps = dict(data.get("maps") or {})
            m = dict(maps.get(name) or {})
            if m.get(key) != old:
                return False, None
            m[key] = new_v
            maps[name] = m
            new = dict(data)
            new["maps"] = maps
            return True, new

        self._reply(200, {"replaced": self.store.transact(rep)})


def parse_args(argv):
    p = argparse.ArgumentParser(description="hazelcast-like sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=5701)
    p.add_argument("--name", default="sim")
    p.add_argument("--members", default=None)  # tolerated, unused
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"hz-sim {args.name} serving on {args.port}, data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """A hazelcast-server-shaped tar.gz whose binary launches this sim
    (installed through the suite's normal install_archive path)."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.hz_sim", "hazelcast-server",
        "hazelcast-sim", data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the hazelcast suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "hazelcast")."""
    return sim_cluster(root, nodes, ports, "hazelcast", "hazelcast-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `hazelcast.hazelcast_test` on a `local_cluster`
    (`simbase.sim_test_fn`): `install_jdk` false (this simulator's
    archive brings its interpreter; `osdist.install_jdk` is apt on this
    machine), and the suite's partition nemesis (majority-ring by
    default) on the no-op network, so partitions are recorded and healed
    without changing traffic; fs-break refused."""
    def make(opts):
        from . import hazelcast

        return hazelcast.hazelcast_test(opts)

    return sim_test_fn(cluster, "hazelcast", make,
                       extra={"install_jdk": False})


if __name__ == "__main__":
    serve()
