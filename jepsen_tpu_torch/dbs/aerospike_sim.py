"""A hermetic Aerospike lookalike: speaks the v2/type-3 message wire
(aerospike_proto's subset) — reads return (generation, bins), writes
bump generation, GENERATION_EQUAL writes fail with result code 3 on a
mismatch. Records keyed by digest hex in the shared flock store.

The port's copy of `jepsen_tpu/dbs/aerospike_sim.py`: it imports
nothing of `jepsen_tpu` (a member process loads neither torch nor jax),
and adds the recipe that runs the aerospike suite on simulated nodes on
this machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import random
import socketserver
import struct
import sys
import time

from . import aerospike_proto as ap
from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn


class Handler(socketserver.BaseRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.request.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client went away")
            buf += chunk
        return buf

    def handle(self):
        self.request.settimeout(120.0)
        try:
            while True:
                header = self._read_exact(8)
                length = int.from_bytes(header[2:8], "big")
                payload = self._read_exact(length)
                if self.mean_latency > 0:
                    time.sleep(random.expovariate(1.0 / self.mean_latency))
                reply = self._dispatch(payload)
                self.request.sendall(
                    struct.pack(">BB", 2, 3)
                    + len(reply).to_bytes(6, "big") + reply)
        except (ConnectionError, TimeoutError, OSError, struct.error):
            return

    @staticmethod
    def _parse(payload: bytes) -> tuple:
        (hdr_sz, info1, info2, _i3, _unused, _res, generation, _ttl,
         _txn, n_fields, n_ops) = struct.unpack(">BBBBBBIIIHH",
                                                payload[:22])
        pos = hdr_sz
        digest = b""
        for _ in range(n_fields):
            (size,) = struct.unpack_from(">I", payload, pos)
            ftype = payload[pos + 4]
            data = payload[pos + 5:pos + 4 + size]
            if ftype == ap.FIELD_DIGEST:
                digest = data
            pos += 4 + size
        ops = []
        for _ in range(n_ops):
            (size,) = struct.unpack_from(">I", payload, pos)
            op_type, btype, _ver, name_len = struct.unpack_from(
                ">BBBB", payload, pos + 4)
            name = payload[pos + 8:pos + 8 + name_len].decode()
            value = payload[pos + 8 + name_len:pos + 4 + size]
            ops.append((op_type, btype, name, value))
            pos += 4 + size
        return info1, info2, generation, digest.hex(), ops

    @staticmethod
    def _reply(result: int, generation: int = 0,
               bins: dict | None = None) -> bytes:
        op_blobs = []
        for name, (btype, data) in (bins or {}).items():
            nb = name.encode()
            body = struct.pack(">BBBB", ap.OP_READ, btype, 0,
                               len(nb)) + nb + data
            op_blobs.append(struct.pack(">I", len(body)) + body)
        body = struct.pack(
            ">BBBBBBIIIHH", 22, 0, 0, 0, 0, result, generation, 0, 0, 0,
            len(op_blobs))
        return body + b"".join(op_blobs)

    def _dispatch(self, payload: bytes) -> bytes:
        info1, info2, generation, digest, ops = self._parse(payload)
        if info1 & ap.INFO1_READ:
            def read(data):
                return (data.get("records") or {}).get(digest), None

            rec = self.store.transact(read)
            if rec is None:
                return self._reply(ap.RESULT_NOT_FOUND)
            bins = {name: (btype, bytes.fromhex(vhex))
                    for name, (btype, vhex) in rec["bins"].items()}
            return self._reply(ap.RESULT_OK, rec["generation"], bins)

        if info2 & ap.INFO2_WRITE:
            def write(data):
                records = dict(data.get("records") or {})
                rec = records.get(digest)
                if info2 & ap.INFO2_GENERATION:
                    cur = rec["generation"] if rec else 0
                    if cur != generation:
                        return ap.RESULT_GENERATION, None
                new_bins = dict(rec["bins"]) if rec else {}
                for op_type, btype, name, value in ops:
                    if op_type == ap.OP_WRITE:
                        new_bins[name] = (btype, value.hex())
                    elif op_type == ap.OP_APPEND:
                        old = new_bins.get(name)
                        prior = bytes.fromhex(old[1]) if old else b""
                        new_bins[name] = (btype, (prior + value).hex())
                records[digest] = {
                    "generation": (rec["generation"] + 1) if rec else 1,
                    "bins": new_bins,
                }
                new = dict(data)
                new["records"] = records
                return ap.RESULT_OK, new

            result = self.store.transact(write)
            return self._reply(result)
        return self._reply(ap.RESULT_OK)


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="aerospike wire sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--name", default="sim")
    p.add_argument("--config-file", default=None)  # asd flag, tolerated
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server(("127.0.0.1", args.port), Handler)
    print(f"aerospike-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """An aerospike-shaped tar.gz whose `asd` binary launches this sim.
    Starting a node that already runs does nothing, as for a real `asd`
    under start-stop-daemon: the kill nemesis's restart starts every
    node it names, live ones too."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.aerospike_sim", "asd", "aerospike-sim",
        data_path, mean_latency=mean_latency, python=python,
        pidfile="aerospike.pid",
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the aerospike suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "aerospike")."""
    return sim_cluster(root, nodes, ports, "aerospike", "aerospike-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `aerospike.aerospike_test` on a `local_cluster`
    (`simbase.sim_test_fn`): the suite's nemesis on the no-op network
    (partitions recorded and healed); start-kill and `pause` (SIGSTOP
    by pidfile) act on a node's one simulator process. fs-break and
    `pause-net` are refused before any node command: pause-net's
    `tc qdisc add dev eth0 root netem` would delay this machine's own
    interface."""
    def make(opts):
        from . import aerospike

        return aerospike.aerospike_test(opts)

    return sim_test_fn(cluster, "aerospike", make, refused={
        "pause-net": "its netem delay would act on this machine's eth0"})


if __name__ == "__main__":
    serve()
