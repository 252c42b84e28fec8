"""A hermetic RabbitMQ lookalike: the AMQP 0-9-1 server subset
amqp_proto speaks — PLAIN handshake, channel open, queue
declare/purge, publisher confirms, basic.publish (method + header +
body frames), basic.get with and without auto-ack, basic.reject.
Queues are FIFO lists of base64 bodies in the shared flock store.

Unacked deliveries are PERSISTED in the shared store under a
per-connection owner token (data["unacked"]); a reject-with-requeue
or the connection dying puts them back at the HEAD of the shared
queue — the broker behavior that makes the distributed-semaphore
pattern (hold the unacked message = hold the mutex,
rabbitmq.clj:185-263) unsafe under partitions: the broker requeues a
"held" semaphore the moment it declares the holder's connection dead.
Owner tokens are prefixed with this node's port, and serve() requeues
any leftovers under its own prefix at startup — a killed broker
process recovers its connections' unacked persistent messages on
restart exactly like a durable RabbitMQ node, so a kill nemesis
cannot silently lose the semaphore and leave the workload checking a
trivially-valid all-fail history.

The port's copy of `jepsen_tpu/dbs/amqp_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the rabbitmq suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import base64
import random
import socketserver
import struct
import sys
import time

from . import amqp_proto as aq
from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn


def _release_unacked(store: Store, token: str, entries: list,
                     requeue: bool) -> None:
    """Drop `entries` ([queue, body_b64] pairs) from `token`'s
    persisted unacked set, prepending each to its queue if requeueing
    — one transaction for atomicity with concurrent getters."""

    def rel(data):
        new = dict(data)
        un = {k: list(v) for k, v in
              (data.get("unacked") or {}).items()}
        mine = list(un.get(token) or [])
        queues = dict(data.get("queues") or {})
        for queue, body in entries:
            if [queue, body] in mine:
                mine.remove([queue, body])
                if requeue:
                    queues[queue] = ([body]
                                     + list(queues.get(queue) or []))
        if mine:
            un[token] = mine
        else:
            un.pop(token, None)
        new["unacked"] = un
        new["queues"] = queues
        return None, new

    store.transact(rel)


def _recover_unacked(store: Store, port: int) -> int:
    """Requeue every unacked delivery owned by a connection of THIS
    node (token prefix "<port>:") — run at broker startup, when any
    such connection is necessarily dead. This is durable-RabbitMQ
    crash recovery: persistent messages that were delivered but never
    acked come back on restart."""
    prefix = f"{port}:"

    def rec(data):
        un = {k: list(v) for k, v in
              (data.get("unacked") or {}).items()}
        queues = dict(data.get("queues") or {})
        n = 0
        for token in [t for t in un if t.startswith(prefix)]:
            for queue, body in un.pop(token):
                queues[queue] = [body] + list(queues.get(queue) or [])
                n += 1
        new = dict(data)
        new["unacked"] = un
        new["queues"] = queues
        return n, new

    return store.transact(rec)


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

    def _read_frame(self) -> tuple:
        header = self._read_exact(7)
        ftype, channel, size = struct.unpack(">BHI", header)
        payload = self._read_exact(size)
        self._read_exact(1)
        return ftype, channel, payload

    def _send_frame(self, ftype: int, channel: int,
                    payload: bytes) -> None:
        self.request.sendall(struct.pack(">BHI", ftype, channel,
                                         len(payload))
                             + payload + bytes([aq.FRAME_END]))

    def _send_method(self, channel: int, cm: tuple,
                     args: bytes = b"") -> None:
        self._send_frame(aq.FRAME_METHOD, channel,
                         struct.pack(">HH", *cm) + args)

    def handle(self):
        import uuid

        self.request.settimeout(120.0)
        confirms = False
        publish_seq = 0
        # This connection's owner token in the store's "unacked" area
        # (port-prefixed so a restarted node can find its orphans),
        # plus the in-memory delivery-tag -> store-entry map.
        self.token = (f"{self.server.server_address[1]}:"
                      f"{uuid.uuid4().hex[:12]}")
        self.unacked = {}
        self.next_tag = 1
        try:
            if self._read_exact(8) != b"AMQP\x00\x00\x09\x01":
                return
            self._send_method(0, aq.CONN_START,
                              struct.pack(">BB", 0, 9)
                              + struct.pack(">I", 0)
                              + aq.longstr(b"PLAIN")
                              + aq.longstr(b"en_US"))
            self._read_frame()  # start-ok: accept anyone
            self._send_method(0, aq.CONN_TUNE,
                              struct.pack(">HIH", 0, 131072, 0))
            self._read_frame()  # tune-ok
            self._read_frame()  # open
            self._send_method(0, aq.CONN_OPEN_OK, aq.shortstr(""))

            while True:
                ftype, channel, payload = self._read_frame()
                if ftype != aq.FRAME_METHOD:
                    continue
                cm = struct.unpack_from(">HH", payload)
                args = payload[4:]
                if self.mean_latency > 0:
                    time.sleep(random.expovariate(1.0 / self.mean_latency))
                if cm == aq.CH_OPEN:
                    self._send_method(channel, aq.CH_OPEN_OK,
                                      struct.pack(">I", 0))
                elif cm == aq.Q_DECLARE:
                    queue, _ = aq.read_shortstr(args, 2)

                    def declare(data):
                        queues = dict(data.get("queues") or {})
                        if queue not in queues:
                            queues[queue] = []
                            new = dict(data)
                            new["queues"] = queues
                            return None, new
                        return None, None

                    self.store.transact(declare)
                    self._send_method(channel, aq.Q_DECLARE_OK,
                                      aq.shortstr(queue)
                                      + struct.pack(">II", 0, 0))
                elif cm == aq.Q_PURGE:
                    queue, _ = aq.read_shortstr(args, 2)

                    def purge(data):
                        queues = dict(data.get("queues") or {})
                        n = len(queues.get(queue) or [])
                        queues[queue] = []
                        new = dict(data)
                        new["queues"] = queues
                        return n, new

                    n = self.store.transact(purge)
                    self._send_method(channel, aq.Q_PURGE_OK,
                                      struct.pack(">I", n))
                elif cm == aq.CONFIRM_SELECT:
                    confirms = True
                    self._send_method(channel, aq.CONFIRM_SELECT_OK)
                elif cm == aq.BASIC_PUBLISH:
                    pos = 2
                    _exchange, pos = aq.read_shortstr(args, pos)
                    routing_key, pos = aq.read_shortstr(args, pos)
                    ftype, _ch, header = self._read_frame()
                    _cls, _w, size = struct.unpack_from(">HHQ", header)
                    body = b""
                    while len(body) < size:
                        ftype, _ch, chunk = self._read_frame()
                        body += chunk

                    def enqueue(data):
                        queues = dict(data.get("queues") or {})
                        queues[routing_key] = (
                            list(queues.get(routing_key) or [])
                            + [base64.b64encode(body).decode()])
                        new = dict(data)
                        new["queues"] = queues
                        return None, new

                    self.store.transact(enqueue)
                    if confirms:
                        publish_seq += 1
                        self._send_method(
                            channel, aq.BASIC_ACK,
                            struct.pack(">QB", publish_seq, 0))
                elif cm == aq.BASIC_GET:
                    queue, pos = aq.read_shortstr(args, 2)
                    no_ack = bool(args[pos]) if pos < len(args) else True

                    def take(data):
                        queues = dict(data.get("queues") or {})
                        q = list(queues.get(queue) or [])
                        if not q:
                            return None, None
                        head, rest = q[0], q[1:]
                        queues[queue] = rest
                        new = dict(data)
                        new["queues"] = queues
                        if not no_ack:
                            # the delivery stays PERSISTED under this
                            # connection's owner token until acked,
                            # rejected, or recovered (module docstring)
                            un = {k: list(v) for k, v in
                                  (data.get("unacked") or {}).items()}
                            un[self.token] = (un.get(self.token) or
                                              []) + [[queue, head]]
                            new["unacked"] = un
                        return head, new

                    got = self.store.transact(take)
                    if got is None:
                        self._send_method(channel, aq.BASIC_GET_EMPTY,
                                          aq.shortstr(""))
                    else:
                        tag = self.next_tag
                        self.next_tag += 1
                        if not no_ack:
                            self.unacked[tag] = (queue, got)
                        body = base64.b64decode(got)
                        self._send_method(
                            channel, aq.BASIC_GET_OK,
                            struct.pack(">QB", tag, 0)
                            + aq.shortstr("") + aq.shortstr(queue)
                            + struct.pack(">I", 0))
                        self._send_frame(
                            aq.FRAME_HEADER, channel,
                            struct.pack(">HHQ", 60, 0, len(body))
                            + struct.pack(">H", 0))
                        if body:  # zero-length bodies carry NO body
                            # frame (AMQP 0-9-1 §4.2.6; readers stop
                            # at the header's body-size)
                            self._send_frame(aq.FRAME_BODY, channel,
                                             body)
                elif cm == aq.BASIC_REJECT:
                    tag, = struct.unpack_from(">Q", args)
                    requeue = bool(args[8]) if len(args) > 8 else False
                    held = self.unacked.pop(tag, None)
                    if held is not None:
                        _release_unacked(self.store, self.token,
                                         [held], requeue)
                    # basic.reject has no -ok reply
                elif cm == aq.CONN_CLOSE:
                    return
        except (ConnectionError, TimeoutError, OSError, struct.error):
            return
        finally:
            # the broker requeues everything an expiring connection
            # still held — the semaphore-breaking behavior under test
            if self.unacked:
                try:
                    _release_unacked(self.store, self.token,
                                     list(self.unacked.values()), True)
                except OSError:
                    pass


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="rabbitmq AMQP sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=5672)
    p.add_argument("--name", default="sim")
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    recovered = _recover_unacked(Handler.store, args.port)
    if recovered:
        print(f"amqp-sim recovered {recovered} unacked deliveries")
    srv = Server(("127.0.0.1", args.port), Handler)
    print(f"amqp-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """A rabbitmq-shaped tar.gz whose `rabbitmq-server` binary launches
    this sim. Starting a node that already runs does nothing, as for a
    real broker under start-stop-daemon: a second broker on a live
    node's port would requeue the live one's held deliveries at its
    start (`_recover_unacked`) before it failed to bind."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.amqp_sim", "rabbitmq-server",
        "rabbitmq-sim", data_path, mean_latency=mean_latency,
        python=python, pidfile="rabbitmq.pid",
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the rabbitmq suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "rabbitmq")."""
    return sim_cluster(root, nodes, ports, "rabbitmq", "rabbitmq-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `rabbitmq.rabbitmq_test` (the queue or the mutex workload) on a
    `local_cluster` (`simbase.sim_test_fn`): the suite's nemesis on the
    no-op network (partitions recorded and healed, so no holder's
    connection is cut by one); start-kill SIGKILLs a node's one broker
    process, whose restart requeues its dead connections' deliveries
    (`_recover_unacked`); fs-break refused."""
    def make(opts):
        from . import rabbitmq

        return rabbitmq.rabbitmq_test(opts)

    return sim_test_fn(cluster, "rabbitmq", make)


if __name__ == "__main__":
    serve()
