"""RabbitMQ test suite: a durable queue driven with confirmed
publishes and auto-ack gets, checked with total-queue (reference:
rabbitmq/src/jepsen/rabbitmq.clj:1-263), plus the
distributed-semaphore mutex workload (rabbitmq.clj:185-263): ONE
message in a durable queue, where holding the unacked delivery is
holding the lock and release is a reject-with-requeue — checked
against the linearizable mutex model, which is exactly how the
pattern's unsafety shows up (the broker requeues a partitioned
holder's message, so a second acquire succeeds with no intervening
release).

The determinacy taxonomy follows the reference: a publish whose
confirm never arrives is :info (the broker may have it); an empty get
is a definite :fail :exhausted; values ride the framework codec
(EDN-in-the-reference, JSON here — rabbitmq.clj:111,157). The mutex
client's taxonomy is the reference's too: acquires that time out or
hit channel errors are :fail, releases report :ok even on errors
because a dead channel requeues — the release "takes effect" either
way (rabbitmq.clj:218-259).

The port's copy of `jepsen_tpu/dbs/rabbitmq.py`. The mutex workload's
checker is `linearizable(Mutex())` on the one unkeyed history, which
`auto` routes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries), K5
(`ops/csrc/wgl_row.cu`, up to 4,064) or K2 (`ops/csrc/wgl_search.cu`),
or to the native search below the committed bars; the test map's
`device` (the CLI's `--device`; None = the card) goes to that checker.
The queue workload's total-queue checker runs on the host.
`amqp_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`."""

from __future__ import annotations

import itertools
import logging
import socket
import threading
import time

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, codec, generator as gen, osdist
from ..history import Op
from ..models import Mutex
from . import amqp_proto as aq
from .common import ArchiveDB, SuiteCfg, ready_gated_final

log = logging.getLogger("jepsen_tpu_torch.dbs.rabbitmq")

PORT = 5672
QUEUE = "jepsen.queue"
SEMAPHORE = "jepsen.semaphore"


_suite = SuiteCfg("rabbitmq", PORT, "/opt/rabbitmq")
node_host = _suite.host
node_port = _suite.port


class RabbitMQDB(ArchiveDB):
    """rabbitmq-server per node (rabbitmq.clj:40-99's apt/cluster
    bring-up condensed to the archive+daemon path)."""

    binary = "rabbitmq-server"
    log_name = "rabbitmq.log"
    pid_name = "rabbitmq.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        return ["--port", str(node_port(test, node))]

    def probe_ready(self, test, node) -> bool:
        conn = aq.AmqpConn(node_host(test, node), node_port(test, node),
                           timeout=2.0, connect_timeout=2.0)
        conn.close()
        return True


class QueueClient(client.Client):
    """Confirmed enqueues / auto-ack dequeues / drain
    (rabbitmq.clj:126-183)."""

    def __init__(self, conn: aq.AmqpConn | None = None):
        self.conn = conn

    def open(self, test, node):
        conn = aq.AmqpConn(node_host(test, node), node_port(test, node))
        conn.queue_declare(QUEUE, durable=True)
        conn.confirm_select()
        return QueueClient(conn)

    def _dequeue(self, op: Op) -> Op:
        body = self.conn.get(QUEUE)
        if body is None:
            return op.with_(type="fail", error="exhausted")
        return op.with_(type="ok", value=codec.decode(body))

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "enqueue":
                ok = self.conn.publish(QUEUE, codec.encode(op.value))
                return op.with_(type="ok" if ok else "fail")
            if op.f == "dequeue":
                return self._dequeue(op)
            if op.f == "drain":
                values = []
                deadline = time.monotonic() + 10.0
                try:
                    while time.monotonic() < deadline:
                        body = self.conn.get(QUEUE)
                        if body is None:
                            return op.with_(type="ok", value=values)
                        values.append(codec.decode(body))
                    return op.with_(type="info", error="drain-timeout",
                                    value=values)
                except (aq.AmqpError, ConnectionError, socket.timeout,
                        TimeoutError, OSError) as e:
                    # keep what was already auto-acked
                    return op.with_(type="info", error=str(e),
                                    value=values)
            raise ValueError(f"unknown op {op.f!r}")
        except aq.AmqpError as e:
            return op.with_(type="info", error=str(e))
        except (socket.timeout, TimeoutError):
            return op.with_(type="info", error="timeout")
        except (ConnectionError, OSError) as e:
            return op.with_(type="info", error=str(e))

    def close(self, test):
        if self.conn:
            self.conn.close()


def queue_gen() -> gen.Generator:
    counter = itertools.count()

    def enqueue(test, process):
        return {"type": "invoke", "f": "enqueue", "value": next(counter)}

    return gen.mix([enqueue, {"type": "invoke", "f": "dequeue"}])


class MutexClient(client.Client):
    """The distributed-semaphore mutex (rabbitmq.clj:188-263): one
    message seeded into a durable queue; acquire = basic.get WITHOUT
    auto-ack (holding the unacked delivery is holding the lock),
    release = basic.reject with requeue. Seeding happens exactly once
    across all workers (the reference's shared `enqueued?` atom,
    :198-205): purge, publish one body, confirmed."""

    def __init__(self, conn: aq.AmqpConn | None = None,
                 seeded: threading.Event | None = None):
        self.conn = conn
        self.tag: int | None = None
        # shared across every opened copy (open() is called on the
        # prototype, like the reference's one (mutex) record)
        self._seeded = seeded or threading.Event()
        self._seed_lock = threading.Lock()

    def open(self, test, node):
        addr = (node_host(test, node), node_port(test, node))
        conn = aq.AmqpConn(*addr)
        conn.queue_declare(SEMAPHORE, durable=True)
        with self._seed_lock:
            if not self._seeded.is_set():
                conn.confirm_select()
                conn.queue_purge(SEMAPHORE)
                if not conn.publish(SEMAPHORE, b""):
                    raise RuntimeError(
                        "couldn't enqueue initial semaphore message!")
                self._seeded.set()
                # the seeding connection has confirms on; that only
                # affects publish, which the mutex never does again
        c = MutexClient(conn, self._seeded)
        c._seed_lock = self._seed_lock
        c._addr = addr
        return c

    def _reconnect(self) -> None:
        """Fresh connection after a channel error (the reference
        reopens its channel the same way, rabbitmq.clj:231-234). Any
        delivery the old connection held is requeued by the broker."""
        try:
            self.conn.close()
        except OSError:
            pass
        try:
            self.conn = aq.AmqpConn(*self._addr)
            self.conn.queue_declare(SEMAPHORE, durable=True)
        except (aq.AmqpError, ConnectionError, socket.timeout,
                TimeoutError, OSError):
            pass  # next op will fail and retry

    def invoke(self, test, op: Op) -> Op:
        if op.f == "acquire":
            if self.tag is not None:
                return op.with_(type="fail", error="already-held")
            try:
                got = self.conn.get_unacked(SEMAPHORE)
            except (aq.AmqpError, ConnectionError, socket.timeout,
                    TimeoutError, OSError) as e:
                # an errored acquire did not hand us a tag; whatever
                # the broker took it will requeue when this channel
                # dies — the reference calls these :fail (:222-241)
                self._reconnect()
                return op.with_(type="fail", error=str(e) or "timeout")
            if got is None:
                return op.with_(type="fail", error="empty")
            self.tag = got[0]
            return op.with_(type="ok", value=self.tag)
        if op.f == "release":
            if self.tag is None:
                return op.with_(type="fail", error="not-held")
            tag, self.tag = self.tag, None
            try:
                self.conn.reject(tag, requeue=True)
            except (aq.AmqpError, ConnectionError, socket.timeout,
                    TimeoutError, OSError) as e:
                # still :ok — a dead channel requeues the delivery, so
                # the lock IS released either way (rabbitmq.clj:245-259)
                self._reconnect()
                return op.with_(type="ok", error=str(e) or "timeout")
            return op.with_(type="ok")
        raise ValueError(f"unknown op {op.f!r}")

    def close(self, test):
        # dropping the connection releases any held delivery (the
        # broker requeues it)
        if self.conn:
            self.conn.close()


def mutex_gen() -> gen.Generator:
    """Each process alternates acquire/release forever — the reference
    test's (gen/each (gen/seq (cycle [acquire release]))),
    rabbitmq_test.clj:30-34 — built from the same combinators."""

    def alternating():
        return gen.seq(itertools.cycle(
            [{"type": "invoke", "f": "acquire"},
             {"type": "invoke", "f": "release"}]))

    return gen.each(alternating)


def rabbitmq_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = RabbitMQDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    workload = opts.get("workload", "queue")
    if workload == "mutex":
        # rabbitmq_test.clj:18-43: the Semaphore client against the
        # linearizable mutex model under a partition nemesis — the
        # workload EXPECTS to catch the pattern's unsafety on a real
        # broker. The reference paces each process at 180 s because
        # its partitions run 100 s; the cadence scales with
        # time-limit here.
        delay = opts.get("mutex_delay")
        if delay is None:
            delay = max(1.0, opts.get("time_limit", 60) / 20)
        test.update(
            {
                "name": "rabbitmq mutex",
                "os": osdist.debian,
                "db": db_,
                "client": MutexClient(),
                "nemesis": cmn.pick_nemesis(db_, opts),
                "generator": gen.phases(
                    gen.time_limit(
                        opts.get("time_limit", 60),
                        gen.nemesis(
                            gen.start_stop(5, 15),
                            gen.delay(delay, mutex_gen()),
                        ),
                    ),
                    gen.log("Healing cluster"),
                    gen.nemesis(gen.once({"type": "info", "f": "stop"})),
                ),
                "checker": checker_mod.compose({
                    "perf": checker_mod.perf_checker(),
                    "timeline": checker_mod.timeline_html(),
                    "linear": checker_mod.linearizable(
                        Mutex(), device=opts.get("device")),
                }),
            }
        )
        return test
    test.update(
        {
            "name": "rabbitmq queue",
            "os": osdist.debian,
            "db": db_,
            "client": QueueClient(),
            "nemesis": cmn.pick_nemesis(db_, opts),
            "generator": gen.phases(
                gen.time_limit(
                    opts.get("time_limit", 60),
                    gen.nemesis(
                        gen.start_stop(10, 10),
                        gen.stagger(opts.get("stagger", 1 / 10),
                                    queue_gen()),
                    ),
                ),
                gen.log("Healing cluster"),
                gen.nemesis(gen.once({"type": "info", "f": "stop"})),
                gen.sleep(opts.get("quiesce", 10)),
                ready_gated_final(
                    db_,
                    gen.clients(gen.each(
                        lambda: gen.once(
                            {"type": "invoke", "f": "drain"}))),
                    opts),
            ),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "queue": checker_mod.total_queue(),
            }),
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--archive-url", dest="archive_url", default=None)
    p.add_argument("--workload", default="queue",
                   choices=["queue", "mutex"])
    p.add_argument("--mutex-delay", dest="mutex_delay", type=float,
                   default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(rabbitmq_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
