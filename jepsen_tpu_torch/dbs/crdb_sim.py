"""A hermetic CockroachDB lookalike: a PostgreSQL-wire-protocol server
with a miniature SQL engine and serializable transactions, so the
cockroachdb suite's real code paths (pgwire client, txn retry loops,
SQLSTATE 40001 handling, archive install, daemon lifecycle) run on one
machine with no network access.

Like the other sims, all member processes share one flock-guarded JSON
state file. Serializability comes from pessimistic global locking:
BEGIN takes the flock (bounded wait — contention surfaces as SQLSTATE
40001, the class of CockroachDB's 'restart transaction' errors, which
is exactly what the suite's with_txn_retry machinery expects to see:
cockroachdb/src/jepsen/cockroach/client.clj:131-161 —
cited for behavioral parity, not copied); COMMIT writes the snapshot
back and releases.

The SQL subset is the statement shapes the suites issue: CREATE/DROP
TABLE, INSERT (multi-row, with or without a column list), SELECT of
columns / * / max(col) with WHERE conjunctions of `col = lit` and
`col % n = m` predicates, UPDATE with rowcount tags, DELETE, BEGIN/
COMMIT/ROLLBACK, and cluster_logical_timestamp() for the monotonic
workload.

The port's copy of `jepsen_tpu/dbs/crdb_sim.py`: it imports nothing of
`jepsen_tpu`, and adds the recipe that runs the cockroachdb and
postgres-rds suites on simulated nodes on this machine
(`local_cluster`, `local_test_fn`; the clock nemeses go to
`simbase.RecordingClockTools`).
"""

from __future__ import annotations

import argparse
import random
import re
import socketserver
import struct
import sys
import time

from . import pg_proto
from .simbase import (RecordingClockTools, Store, StoreTxn,
                      build_sim_archive, free_port)

TXN_LOCK_TIMEOUT = 2.0
# Must comfortably exceed basic_test's default quiesce wait (30 s) or
# the one-shot final read of sets/monotonic lands on a closed socket.
SESSION_IDLE_TIMEOUT = 120.0

_RESTART_MSG = "restart transaction: retry txn (lock contention)"


class SqlError(Exception):
    def __init__(self, sqlstate: str, message: str):
        super().__init__(message)
        self.sqlstate = sqlstate
        self.message = message


# ---------------------------------------------------------------------------
# Mini SQL engine. State shape:
#   {"tables": {name: {"cols": [...], "rows": [[...], ...]}},
#    "hlc": int}


_LIT = r"(?:-?\d+|'(?:[^']*)'|NULL|TRUE|FALSE)"


def _parse_lit(tok: str):
    t = tok.strip()
    u = t.upper()
    if u == "NULL":
        return None
    if u == "TRUE":
        return True
    if u == "FALSE":
        return False
    if t.startswith("'"):
        return t[1:-1]
    try:
        return int(t)
    except ValueError:
        # unsupported literal (float, bareword, ...) — a proper
        # ErrorResponse, not a dead connection
        raise SqlError("42601", f"can't parse literal: {t!r}") from None


def _fmt(v) -> str | None:
    """Text-format pgwire encoding."""
    if v is None:
        return None
    if v is True:
        return "t"
    if v is False:
        return "f"
    return str(v)


class _Cond:
    """One WHERE conjunct: col = lit, or col % n = m."""

    def __init__(self, col: str, mod: int | None, rhs):
        self.col = col
        self.mod = mod
        self.rhs = rhs

    def matches(self, row: dict) -> bool:
        v = row.get(self.col)
        if self.mod is not None:
            return v is not None and v % self.mod == self.rhs
        return v == self.rhs


def _parse_where(clause: str | None) -> list:
    if not clause:
        return []
    conds = []
    for part in re.split(r"\s+and\s+", clause.strip(), flags=re.I):
        m = re.fullmatch(
            rf"(\w+)\s*%\s*(\d+)\s*=\s*({_LIT})", part.strip(), flags=re.I)
        if m:
            conds.append(_Cond(m.group(1).lower(), int(m.group(2)),
                               _parse_lit(m.group(3))))
            continue
        m = re.fullmatch(rf"(\w+)\s*=\s*({_LIT})", part.strip(), flags=re.I)
        if m:
            conds.append(_Cond(m.group(1).lower(), None,
                               _parse_lit(m.group(2))))
            continue
        raise SqlError("42601", f"can't parse WHERE conjunct: {part!r}")
    return conds


def _table(data: dict, name: str) -> dict:
    t = (data.get("tables") or {}).get(name)
    if t is None:
        raise SqlError("42P01", f'relation "{name}" does not exist')
    return t


def _rows_as_dicts(t: dict):
    for row in t["rows"]:
        yield dict(zip(t["cols"], row))


def execute(data: dict, sql: str) -> tuple:
    """Run one statement against the state dict IN PLACE. Returns
    (columns, rows, tag) with rows already text-encoded."""
    s = sql.strip().rstrip(";").strip()

    # -- DDL -------------------------------------------------------------
    m = re.fullmatch(r"drop\s+table\s+(if\s+exists\s+)?(\w+)", s, re.I)
    if m:
        data.setdefault("tables", {})
        if m.group(2).lower() in data["tables"]:
            del data["tables"][m.group(2).lower()]
        elif not m.group(1):
            raise SqlError("42P01",
                           f'relation "{m.group(2)}" does not exist')
        return [], [], "DROP TABLE"

    m = re.fullmatch(r"create\s+table\s+(if\s+not\s+exists\s+)?(\w+)\s*"
                     r"\((.*)\)", s, re.I | re.S)
    if m:
        name = m.group(2).lower()
        data.setdefault("tables", {})
        if name in data["tables"]:
            if m.group(1):
                return [], [], "CREATE TABLE"
            raise SqlError("42P07", f'relation "{name}" already exists')
        cols = []
        pkey = None
        for coldef in m.group(3).split(","):
            word = coldef.strip().split()
            if not word or word[0].lower() in ("primary", "unique",
                                               "constraint", "index"):
                continue  # table-level constraint, not a column
            cols.append(word[0].lower())
            # inline `<col> <type> primary key`
            if "primary" in (w.lower() for w in word[1:]):
                pkey = word[0].lower()
        # legacy convention: an `id` column acts as the key even
        # without a declared constraint (matches the old hardcoded
        # duplicate check, which several suites rely on)
        if pkey is None and "id" in cols:
            pkey = "id"
        data["tables"][name] = {"cols": cols, "rows": [], "pkey": pkey}
        return [], [], "CREATE TABLE"

    # `alter table t split at values (k)` — CockroachDB's range-split
    # hint (cockroach/client.clj:304-311). The sim records the split
    # point per table (sharding is internal, so data is unaffected) and
    # rejects re-splitting with the server's message, which the split
    # nemesis pattern-matches (nemesis.clj:295-299).
    m = re.fullmatch(r"alter\s+table\s+(\w+)\s+split\s+at\s+values\s*"
                     rf"\(\s*({_LIT})\s*\)", s, re.I)
    if m:
        t = _table(data, m.group(1).lower())
        k = _parse_lit(m.group(2))
        splits = t.setdefault("splits", [])
        if k in splits:
            raise SqlError("XX000", "range is already split")
        splits.append(k)
        return [], [], "ALTER TABLE"

    # crate-style implicit MVCC column: `alter table t add _version`
    # gives every row a server-managed _version (1 on insert, bumped on
    # every update) that WHERE clauses may check optimistically
    m = re.fullmatch(r"alter\s+table\s+(\w+)\s+add\s+_version", s, re.I)
    if m:
        t = _table(data, m.group(1).lower())
        if "_version" not in t["cols"]:
            t["cols"].append("_version")
            t["rows"] = [row + [1] for row in t["rows"]]
        return [], [], "ALTER TABLE"

    # -- INSERT ----------------------------------------------------------
    m = re.fullmatch(r"insert\s+into\s+(\w+)\s*(?:\(([^)]*)\)\s*)?"
                     r"values\s*(.+)", s, re.I | re.S)
    if m:
        t = _table(data, m.group(1).lower())
        cols = ([c.strip().lower() for c in m.group(2).split(",")]
                if m.group(2) else t["cols"])
        count = 0
        for tup in re.finditer(r"\(([^)]*)\)", m.group(3)):
            vals = [_parse_lit(v) for v in tup.group(1).split(",")]
            if len(vals) != len(cols):
                raise SqlError("42601", "column/value count mismatch")
            by_col = dict(zip(cols, vals))
            if "_version" in t["cols"] and "_version" not in by_col:
                by_col["_version"] = 1  # server-managed MVCC column
            row = [by_col.get(c) for c in t["cols"]]
            # duplicate check on the declared primary key column
            pk = t.get("pkey")
            if pk and pk in by_col and any(
                r.get(pk) == by_col[pk] for r in _rows_as_dicts(t)
            ):
                raise SqlError(
                    "23505", "duplicate key value violates unique constraint")
            t["rows"].append(row)
            count += 1
        return [], [], f"INSERT 0 {count}"

    # -- SELECT ----------------------------------------------------------
    # `for update` row locking is a no-op here: every transaction holds
    # the global lock anyway
    s_nolock = re.sub(r"\s+for\s+update\s*$", "", s, flags=re.I)
    m = re.fullmatch(r"select\s+(.+?)\s+from\s+(\w+)"
                     r"(?:\s+where\s+(.+))?", s_nolock, re.I | re.S)
    if m:
        t = _table(data, m.group(2).lower())
        conds = _parse_where(m.group(3))
        rows = [r for r in _rows_as_dicts(t)
                if all(c.matches(r) for c in conds)]
        expr = m.group(1).strip()
        agg = re.fullmatch(r"max\s*\(\s*(\w+)\s*\)(?:\s+as\s+(\w+))?",
                           expr, re.I)
        if agg:
            col = agg.group(1).lower()
            vals = [r[col] for r in rows if r.get(col) is not None]
            out = max(vals) if vals else None
            name = (agg.group(2) or "max").lower()
            return [name], [(_fmt(out),)], "SELECT 1"
        if expr == "*":
            cols = t["cols"]
        else:
            cols = [c.strip().lower() for c in expr.split(",")]
        out_rows = [tuple(_fmt(r.get(c)) for c in cols) for r in rows]
        return cols, out_rows, f"SELECT {len(out_rows)}"

    # SELECT without FROM: functions / literals
    m = re.fullmatch(r"select\s+(.+)", s, re.I | re.S)
    if m:
        expr = m.group(1).strip()
        if re.fullmatch(r"cluster_logical_timestamp\s*\(\s*\)", expr, re.I):
            data["hlc"] = int(data.get("hlc") or 0) + 1
            # cockroach returns a decimal <walltime>.<logical>
            return (["cluster_logical_timestamp"],
                    [(f"{data['hlc']}.0000000000",)], "SELECT 1")
        if re.fullmatch(r"now\s*\(\s*\)", expr, re.I):
            return ["now"], [(str(time.time()),)], "SELECT 1"
        if re.fullmatch(r"\d+", expr):
            return ["?column?"], [(expr,)], "SELECT 1"
        raise SqlError("42601", f"can't parse SELECT expr: {expr!r}")

    # -- UPDATE ----------------------------------------------------------
    m = re.fullmatch(r"update\s+(\w+)\s+set\s+(.+?)"
                     r"(?:\s+where\s+(.+))?", s, re.I | re.S)
    if m:
        t = _table(data, m.group(1).lower())
        # quote-aware assignment scan (commas may appear INSIDE string
        # literals, so splitting the clause on "," would mangle them)
        sets = []  # (col, fn(row-dict) -> value)
        set_clause = m.group(2).strip()
        assign_re = re.compile(
            rf"(\w+)\s*=\s*({_LIT}|\w+\s*[+-]\s*\d+)\s*(?:,\s*|$)", re.I)
        pos = 0
        while pos < len(set_clause):
            sm = assign_re.match(set_clause, pos)
            if not sm:
                raise SqlError("42601",
                               f"can't parse SET: {set_clause[pos:]!r}")
            col, rhs = sm.group(1).lower(), sm.group(2).strip()
            am = re.fullmatch(r"(\w+)\s*([+-])\s*(\d+)", rhs)
            if am and am.group(1).lower() == col:
                # arithmetic in place: col = col [+-] n (bank's
                # in-place transfer shape)
                delta = int(am.group(3))
                if am.group(2) == "-":
                    delta = -delta
                sets.append((col,
                             lambda rd, col=col, delta=delta:
                             (rd.get(col) or 0) + delta))
            else:
                lit = _parse_lit(rhs)
                sets.append((col, lambda rd, lit=lit: lit))
            pos = sm.end()
        conds = _parse_where(m.group(3))
        count = 0
        for i, row in enumerate(t["rows"]):
            rd = dict(zip(t["cols"], row))
            if all(c.matches(rd) for c in conds):
                for col, fn in sets:
                    rd[col] = fn(rd)
                if "_version" in t["cols"]:
                    rd["_version"] = (rd.get("_version") or 0) + 1
                t["rows"][i] = [rd.get(c) for c in t["cols"]]
                count += 1
        return [], [], f"UPDATE {count}"

    # -- DELETE ----------------------------------------------------------
    m = re.fullmatch(r"delete\s+from\s+(\w+)(?:\s+where\s+(.+))?", s,
                     re.I | re.S)
    if m:
        t = _table(data, m.group(1).lower())
        conds = _parse_where(m.group(2))
        keep, dropped = [], 0
        for row in t["rows"]:
            rd = dict(zip(t["cols"], row))
            if all(c.matches(rd) for c in conds):
                dropped += 1
            else:
                keep.append(row)
        t["rows"] = keep
        return [], [], f"DELETE {dropped}"

    raise SqlError("42601", f"can't parse statement: {s!r}")


# ---------------------------------------------------------------------------
# pgwire server


def _msg(t: bytes, payload: bytes = b"") -> bytes:
    return t + struct.pack("!i", 4 + len(payload)) + payload


def _error_response(sqlstate: str, message: str) -> bytes:
    fields = (b"SERROR\x00"
              + b"C" + sqlstate.encode() + b"\x00"
              + b"M" + message.encode() + b"\x00\x00")
    return _msg(b"E", fields)


def _row_description(cols: list) -> bytes:
    body = struct.pack("!h", len(cols))
    for c in cols:
        body += c.encode() + b"\x00"
        body += struct.pack("!ihihih", 0, 0, 25, -1, -1, 0)  # oid 25 = text
    return _msg(b"T", body)


def _data_row(row: tuple) -> bytes:
    body = struct.pack("!h", len(row))
    for v in row:
        if v is None:
            body += struct.pack("!i", -1)
        else:
            b = v.encode()
            body += struct.pack("!i", len(b)) + b
    return _msg(b"D", body)


class Handler(socketserver.BaseRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0

    def _read_exact(self, n: int) -> bytes:
        return pg_proto._read_exact(self.request, n)

    def handle(self):
        self.request.settimeout(SESSION_IDLE_TIMEOUT)
        txn = StoreTxn(self.store)
        aborted = False  # txn hit an error; only ROLLBACK accepted
        try:
            # startup (possibly preceded by an SSLRequest)
            while True:
                (length,) = struct.unpack("!i", self._read_exact(4))
                payload = self._read_exact(length - 4)
                (code,) = struct.unpack("!i", payload[:4])
                if code == pg_proto.SSL_REQUEST:
                    self.request.sendall(b"N")
                    continue
                break  # StartupMessage; params ignored (trust auth)
            self.request.sendall(_msg(b"R", struct.pack("!i", 0)))
            self.request.sendall(
                _msg(b"S", b"server_version\x00jepsen-tpu-crdb-sim\x00"))
            self.request.sendall(_msg(b"Z", b"I"))

            while True:
                t = self._read_exact(1)
                (length,) = struct.unpack("!i", self._read_exact(4))
                payload = self._read_exact(length - 4)
                if t == b"X":
                    return
                if t != b"Q":
                    self.request.sendall(_error_response(
                        "0A000", f"unsupported message {t!r}"))
                    self.request.sendall(_msg(b"Z", b"I"))
                    continue
                sql = payload.rstrip(b"\x00").decode()
                if self.mean_latency > 0:
                    time.sleep(random.expovariate(1.0 / self.mean_latency))
                txn, aborted = self._statement(sql, txn, aborted)
        except (ConnectionError, TimeoutError, OSError):
            pass
        finally:
            txn.rollback()

    def _statement(self, sql: str, txn: StoreTxn, aborted: bool) -> tuple:
        s = sql.strip().rstrip(";").strip().upper()
        out = []
        try:
            if s in ("BEGIN", "START TRANSACTION"):
                if not txn.active:
                    if not txn.begin(timeout=TXN_LOCK_TIMEOUT):
                        raise SqlError("40001", _RESTART_MSG)
                out.append(_msg(b"C", b"BEGIN\x00"))
                aborted = False
            elif s == "COMMIT":
                if aborted:
                    txn.rollback()
                    out.append(_msg(b"C", b"ROLLBACK\x00"))
                    aborted = False
                else:
                    if txn.active:
                        txn.commit()
                    out.append(_msg(b"C", b"COMMIT\x00"))
            elif s == "ROLLBACK":
                txn.rollback()
                aborted = False
                out.append(_msg(b"C", b"ROLLBACK\x00"))
            elif aborted:
                raise SqlError(
                    "25P02",
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block")
            elif txn.active:
                cols, rows, tag = execute(txn.data, sql)
                if cols:
                    out.append(_row_description(cols))
                    out.extend(_data_row(r) for r in rows)
                out.append(_msg(b"C", tag.encode() + b"\x00"))
            else:
                # autocommit: one bounded-wait txn around the statement
                one = StoreTxn(self.store)
                if not one.begin(timeout=TXN_LOCK_TIMEOUT):
                    raise SqlError("40001", _RESTART_MSG)
                try:
                    cols, rows, tag = execute(one.data, sql)
                    one.commit()
                except BaseException:
                    one.rollback()
                    raise
                if cols:
                    out.append(_row_description(cols))
                    out.extend(_data_row(r) for r in rows)
                out.append(_msg(b"C", tag.encode() + b"\x00"))
        except SqlError as e:
            out.append(_error_response(e.sqlstate, e.message))
            if txn.active:
                aborted = True
        status = b"T" if txn.active else b"I"
        if txn.active and aborted:
            status = b"E"
        out.append(_msg(b"Z", status))
        self.request.sendall(b"".join(out))
        return txn, aborted


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="cockroachdb pgwire sim",
                                allow_abbrev=False)
    p.add_argument("command", nargs="?", default="start")  # `cockroach start`
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=26257)
    p.add_argument("--name", default="sim")
    # cockroach flags tolerated for command-line compatibility:
    p.add_argument("--join", default=None)
    p.add_argument("--insecure", action="store_true")
    p.add_argument("--store", default=None)
    p.add_argument("--http-port", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server(("127.0.0.1", args.port), Handler)
    print(f"crdb-sim {args.name} serving pgwire on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """A cockroach-shaped tar.gz whose `cockroach` binary launches this
    sim (installed through the suite's normal install_archive path).
    Starting a node that already runs does nothing, as for a real
    cockroach binary (the skews' `Restarting` starts every node, most
    of them live)."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.crdb_sim", "cockroach", "cockroach-sim",
        data_path, mean_latency=mean_latency, python=python,
        pidfile="cockroach.pid",
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the cockroachdb suite against
    simulated nodes on this machine, one process a node: a LocalRemote
    whose nodes are directories under root/nodes, this simulator's
    archive as the tarball (all nodes share root/shared/state.json),
    and each node's pgwire port (`ports` = {node: port} to reuse a
    cluster's; else free ports)."""
    import os

    from ..control import LocalRemote

    remote = LocalRemote(root=os.path.join(root, "nodes"))
    archive = build_archive(os.path.join(root, "crdb-sim.tar.gz"),
                            os.path.join(root, "shared", "state.json"))
    ports = ports or {n: free_port() for n in nodes}
    return {
        "remote": remote,
        "tarball": f"file://{archive}",
        "ports": ports,
        "cockroach": {
            "addr_fn": lambda n: "127.0.0.1",
            "ports": ports,
            "dir": lambda n: os.path.join(remote.node_dir(n), "opt",
                                          "crdb"),
            "sudo": None,
        },
    }


def local_test_fn(cluster: dict, suite_opts: dict | None = None,
                  client=None):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    cockroachdb suite (`cockroach_workloads.cockroach_test`) on a
    `local_cluster`: the command's options, with `suite_opts` (options
    the CLI has no flag for, such as "threads_per_key", "ops_per_key" or
    "quiesce") and the cluster's entries over them, go to the
    constructor; then the OS is none (there is no real node to
    provision). The suite's nemesis (--nemesis, --nemesis2) runs on the
    no-op network: partitions and slowing are recorded and healed but
    change no traffic; start-kill and the split nemesis act on the
    simulated nodes; the clock nemeses go to `RecordingClockTools`
    (cluster["clock_calls"]); start-stop's `killall cockroach` finds no
    process of that name (the nodes are Python processes). The fs-break
    modes raise `cli.CliError` before anything runs on a node: their
    FUSE layer would mount over the nodes' data as the caller. `client`
    replaces the workload's client."""
    def test_fn(opts: dict) -> dict:
        from .. import net
        from ..cli import CliError
        from . import cockroach_workloads, common

        opts = {**opts, **(suite_opts or {}),
                "remote": cluster["remote"],
                "cockroach": cluster["cockroach"],
                "tarball": cluster["tarball"],
                "clock_tools": RecordingClockTools(
                    cluster.setdefault("clock_calls", []))}
        fs = set(common.FSFAULT_NEMESIS_NAMES)
        for name in (opts.get("nemesis"), opts.get("nemesis2")):
            if name in fs:
                raise CliError(f"--nemesis {name}: the simulated cluster "
                               "cannot mount the FUSE fault layer")
        t = cockroach_workloads.cockroach_test(opts)
        t.update({"os": None, "net": net.noop})
        if client is not None:
            t["client"] = client
        return t

    return test_fn


if __name__ == "__main__":
    serve()
