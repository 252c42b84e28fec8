"""A hermetic ZooKeeper lookalike: a socket server speaking the jute
protocol subset in dbs/zk_proto.py (handshake, create/delete/exists/
getData/setData/ping/close) plus the `ruok` four-letter word.

Like dbs/etcd_sim.py, this is the test double that lets the zookeeper
suite exercise its real code paths — archive install, daemon lifecycle,
binary wire protocol, version-CAS — on one machine with no network.
All member processes share one flock-guarded JSON state file, so the
simulated ensemble is linearizable by construction; --mean-latency adds
jitter for real concurrency windows.

Accepts zkServer-ish flags plus the sim's own (--port, --data).

The port's copy of `jepsen_tpu/dbs/zk_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the zookeeper suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`).
"""

from __future__ import annotations

import argparse
import base64
import random
import socket
import socketserver
import struct
import sys
import time

from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn
from . import zk_proto as P


def _node(data: bytes, version: int = 0) -> dict:
    return {"data": base64.b64encode(data).decode(), "version": version}


def _data_of(node: dict) -> bytes:
    return base64.b64decode(node["data"])


def _stat_of(node: dict) -> dict:
    d = _data_of(node)
    return {"version": node["version"], "dataLength": len(d)}


class Handler(socketserver.BaseRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0

    def _jitter(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))

    def handle(self):
        sock = self.request
        sock.settimeout(30)
        try:
            head = P._recv_exact(sock, 4)
        except (ConnectionError, OSError):
            return
        if head == b"ruok":  # four-letter word, unframed
            try:
                sock.sendall(b"imok")
            except OSError:
                pass
            return
        try:
            (n,) = struct.unpack(">i", head)
            connect = P.Reader(P._recv_exact(sock, n))
            connect.int32()  # protocolVersion
            connect.int64()  # lastZxidSeen
            session_timeout = connect.int32()
            # ConnectResponse
            resp = (P.Writer().int32(0).int32(session_timeout)
                    .int64(random.getrandbits(62)).buffer(b"\x00" * 16))
            P.write_frame(sock, resp.bytes_())
            while True:
                self._serve_one(sock)
        except (ConnectionError, OSError, P.ZkError):
            return

    def _serve_one(self, sock: socket.socket) -> None:
        r = P.Reader(P.read_frame(sock))
        xid = r.int32()
        opcode = r.int32()
        self._jitter()
        if opcode == P.OP_CLOSE:
            P.write_frame(
                sock, P.Writer().int32(xid).int64(0).int32(P.OK).bytes_()
            )
            raise ConnectionError("closed")
        err, payload = self._dispatch(opcode, r)
        out = P.Writer().int32(xid).int64(0).int32(err).bytes_() + payload
        P.write_frame(sock, out)

    def _dispatch(self, opcode: int, r: P.Reader) -> tuple[int, bytes]:
        if opcode == P.OP_PING:
            return P.OK, b""

        if opcode == P.OP_CREATE:
            path = r.ustring() or ""
            data = r.buffer() or b""

            def create(state):
                if path in state:
                    return (P.ERR_NODE_EXISTS, b""), None
                new = dict(state)
                new[path] = _node(data)
                return (P.OK, P.Writer().ustring(path).bytes_()), new

            return self.store.transact(create)

        if opcode == P.OP_DELETE:
            path = r.ustring() or ""
            version = r.int32()

            def delete(state):
                node = state.get(path)
                if node is None:
                    return (P.ERR_NO_NODE, b""), None
                if version != -1 and node["version"] != version:
                    return (P.ERR_BAD_VERSION, b""), None
                new = dict(state)
                del new[path]
                return (P.OK, b""), new

            return self.store.transact(delete)

        if opcode == P.OP_EXISTS:
            path = r.ustring() or ""

            def exists(state):
                node = state.get(path)
                if node is None:
                    return (P.ERR_NO_NODE, b""), None
                return (P.OK, P.pack_stat(_stat_of(node))), None

            return self.store.transact(exists)

        if opcode == P.OP_GET_DATA:
            path = r.ustring() or ""

            def get_data(state):
                node = state.get(path)
                if node is None:
                    return (P.ERR_NO_NODE, b""), None
                out = (P.Writer().buffer(_data_of(node)).bytes_()
                       + P.pack_stat(_stat_of(node)))
                return (P.OK, out), None

            return self.store.transact(get_data)

        if opcode == P.OP_SET_DATA:
            path = r.ustring() or ""
            data = r.buffer() or b""
            version = r.int32()

            def set_data(state):
                node = state.get(path)
                if node is None:
                    return (P.ERR_NO_NODE, b""), None
                if version != -1 and node["version"] != version:
                    return (P.ERR_BAD_VERSION, b""), None
                new = dict(state)
                new[path] = _node(data, node["version"] + 1)
                return (P.OK, P.pack_stat(_stat_of(new[path]))), new

            return self.store.transact(set_data)

        return P.ERR_UNIMPLEMENTED, b""


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="ZooKeeper jute-subset simulator",
                                allow_abbrev=False)
    p.add_argument("--data", required=True, help="shared JSON state file")
    p.add_argument("--port", type=int, default=2181)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--name", default="zk-sim")
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server((args.host, args.port), Handler)
    print(f"zk-sim {args.name} serving on {args.host}:{args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """An archive whose `zkserver` binary launches this simulator
    (installed through the suite's normal install_archive path)."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.zk_sim", "zkserver", "zookeeper-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the zookeeper suite against
    simulated nodes on this machine (`simbase.sim_cluster`): the suite's
    settings under "zk", each node's port under its "client_ports"."""
    return sim_cluster(root, nodes, ports, "zk", "zookeeper-sim",
                       build_archive, ports_key="client_ports")


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    zookeeper suite (`zookeeper.zk_test`) on a `local_cluster`
    (`simbase.sim_test_fn`): its partition nemesis on the no-op network,
    fs-break refused."""
    def make(opts):
        from . import zookeeper

        return zookeeper.zk_test(opts)

    return sim_test_fn(cluster, "zk", make)


if __name__ == "__main__":
    serve()
