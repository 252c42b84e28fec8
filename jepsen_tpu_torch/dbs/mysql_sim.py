"""A hermetic MySQL-protocol server over the shared mini SQL engine —
the test double for the galera / percona / mysql-cluster / tidb suites.

Transactions hold the shared flock from BEGIN to COMMIT (bounded wait);
contention surfaces as error 1213 with the exact
"Deadlock found when trying to get lock; try restarting transaction"
message the suites' txn-abort taxonomy matches on (galera.clj /
postgres_rds.clj both key on this string). Duplicate keys are 1062,
parse errors 1064 — the MySQL-side shapes of the engine's SQLSTATEs.

Auth: accepts any user with mysql_native_password (including empty
passwords) — it's a test double, not a fortress.

The port's copy of `jepsen_tpu/dbs/mysql_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the galera and percona suites on simulated nodes on
this machine (`local_cluster`, `local_test_fn`).
"""

from __future__ import annotations

import argparse
import os
import random
import socketserver
import struct
import sys
import time

from . import crdb_sim, mysql_proto as mp
from .simbase import (Store, StoreTxn, build_sim_archive, sim_cluster,
                      sim_test_fn)

TXN_LOCK_TIMEOUT = 2.0
SESSION_IDLE_TIMEOUT = 120.0

_SQLSTATE_TO_MYSQL = {
    "40001": (mp.ER_LOCK_DEADLOCK, mp.DEADLOCK_MSG, "40001"),
    "23505": (mp.ER_DUP_ENTRY, "Duplicate entry for key 'PRIMARY'",
              "23000"),
    "42P01": (mp.ER_NO_SUCH_TABLE, "Table doesn't exist", "42S02"),
}


def _to_mysql_error(e: crdb_sim.SqlError) -> bytes:
    code, msg, state = _SQLSTATE_TO_MYSQL.get(
        e.sqlstate, (mp.ER_PARSE_ERROR, e.message, "42000"))
    return mp.err_packet(code, msg, state)


class Handler(socketserver.BaseRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0

    def handle(self):
        self.request.settimeout(SESSION_IDLE_TIMEOUT)
        io = mp.PacketIO(self.request)
        txn = StoreTxn(self.store)
        try:
            # handshake v10: 8+12-byte nonce, protocol 41 caps
            nonce = os.urandom(20).replace(b"\x00", b"\x01")
            greeting = (
                b"\x0a" + b"jepsen-tpu-mysql-sim\x00"
                + struct.pack("<I", os.getpid() & 0xFFFFFFFF)
                + nonce[:8] + b"\x00"
                + struct.pack("<H", 0xF7FF)      # caps low
                + b"\x21"                        # charset
                + struct.pack("<H", 0x0002)      # status
                + struct.pack("<H", 0x000F)      # caps high (plugin auth)
                + bytes([21]) + b"\x00" * 10
                + nonce[8:20] + b"\x00"
                + b"mysql_native_password\x00"
            )
            io.write_packet(greeting)
            io.read_packet()  # handshake response: accept anyone
            io.write_packet(mp.ok_packet())

            while True:
                io.reset_seq()
                payload = io.read_packet()
                io.seq = 1
                if not payload or payload[0] == 0x01:  # COM_QUIT
                    return
                if payload[0] != 0x03:  # only COM_QUERY
                    io.write_packet(mp.err_packet(
                        1047, f"unsupported command {payload[0]}"))
                    continue
                sql = payload[1:].decode()
                if self.mean_latency > 0:
                    time.sleep(random.expovariate(1.0 / self.mean_latency))
                txn = self._statement(io, sql, txn)
        except (ConnectionError, TimeoutError, OSError,
                mp.MySqlProtocolError):
            pass
        finally:
            txn.rollback()

    def _statement(self, io: mp.PacketIO, sql: str,
                   txn: StoreTxn) -> StoreTxn:
        s = sql.strip().rstrip(";").strip().upper()
        try:
            if s in ("BEGIN", "START TRANSACTION"):
                if not txn.active and not txn.begin(
                        timeout=TXN_LOCK_TIMEOUT):
                    raise crdb_sim.SqlError("40001", mp.DEADLOCK_MSG)
                io.write_packet(mp.ok_packet())
                return txn
            if s == "COMMIT":
                if txn.active:
                    txn.commit()
                io.write_packet(mp.ok_packet())
                return txn
            if s == "ROLLBACK":
                txn.rollback()
                io.write_packet(mp.ok_packet())
                return txn
            if s.startswith("SET "):  # isolation levels etc: accepted
                io.write_packet(mp.ok_packet())
                return txn
            if txn.active:
                cols, rows, tag = crdb_sim.execute(txn.data, sql)
            else:
                one = StoreTxn(self.store)
                if not one.begin(timeout=TXN_LOCK_TIMEOUT):
                    raise crdb_sim.SqlError("40001", mp.DEADLOCK_MSG)
                try:
                    cols, rows, tag = crdb_sim.execute(one.data, sql)
                    if tag.startswith("SELECT"):
                        one.rollback()  # reads don't rewrite the state
                    else:
                        one.commit()
                except BaseException:
                    one.rollback()
                    raise
            self._send_result(io, cols, rows, tag)
        except crdb_sim.SqlError as e:
            io.write_packet(_to_mysql_error(e))
        return txn

    @staticmethod
    def _send_result(io: mp.PacketIO, cols, rows, tag) -> None:
        if not cols:
            affected = 0
            parts = tag.split()
            if parts and parts[-1].isdigit():
                affected = int(parts[-1])
            io.write_packet(mp.ok_packet(affected))
            return
        io.write_packet(mp.lenenc_int(len(cols)))
        for c in cols:
            io.write_packet(mp.column_packet(c))
        io.write_packet(mp.eof_packet())
        for row in rows:
            io.write_packet(mp.row_packet(row))
        io.write_packet(mp.eof_packet())


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="mysql-protocol sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=3306)
    p.add_argument("--name", default="sim")
    # flags various launchers pass, tolerated:
    p.add_argument("--wsrep-cluster-address", default=None)
    p.add_argument("--ndb-connectstring", default=None)
    p.add_argument("--store", default=None)
    p.add_argument("--path", default=None)
    # the real mysqld accepts a rich flag surface (--ndb-nodeid,
    # --datadir, ...); unknown flags are ignored, not fatal
    args, _unknown = p.parse_known_args(argv)
    return args


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server(("127.0.0.1", args.port), Handler)
    print(f"mysql-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, binary: str = "mysqld",
                  mean_latency: float = 0.0,
                  python: str | None = None,
                  pidfile: str | None = None) -> str:
    """A tar.gz whose `binary` launches this sim. With `pidfile` (the
    suite's, relative to the daemon's directory), starting a node that
    already runs does nothing, as for a real mysqld under
    start-stop-daemon."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.mysql_sim", binary, f"{binary}-sim",
        data_path, mean_latency=mean_latency, python=python,
        pidfile=pidfile,
    )


#: the suites whose every node runs this sim alone, as its `mysqld`
SUITES = ("galera", "percona")


def local_cluster(root: str, nodes, ports: dict | None = None,
                  suite: str = "galera") -> dict:
    """The test-map entries that run the galera or percona suite (`suite`)
    against simulated nodes on this machine (`simbase.sim_cluster`,
    settings under the suite's name; "suite" names it)."""
    assert suite in SUITES, suite

    def build(dest, data_path):
        return build_archive(dest, data_path, pidfile=f"{suite}.pid")

    return {**sim_cluster(root, nodes, ports, suite, f"{suite}-sim", build),
            "suite": suite}


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    cluster's suite (`galera.galera_test` or `percona.percona_test`) on a
    `local_cluster` (`simbase.sim_test_fn`): the suite's nemesis on the
    no-op network (partitions recorded and healed; start-kill acts on a
    node's one simulator process); fs-break refused."""
    suite = cluster.get("suite", "galera")

    def make(opts):
        import importlib

        mod = importlib.import_module(f"{__package__}.{suite}")
        return getattr(mod, f"{suite}_test")(opts)

    return sim_test_fn(cluster, suite, make)


if __name__ == "__main__":
    serve()
