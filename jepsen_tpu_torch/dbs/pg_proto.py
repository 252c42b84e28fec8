"""Minimal PostgreSQL wire-protocol (v3) client — the transport the
cockroachdb suite uses to reach real CockroachDB nodes (which speak
pgwire on port 26257) and the in-repo crdb_sim.

The reference suite goes through clojure.java.jdbc + the Postgres JDBC
driver (cockroachdb/src/jepsen/cockroach/client.clj:46-69); there is no
Postgres driver baked into this environment, so we implement the small
protocol subset the suites need: startup (trust or cleartext-password
auth), simple Query, text-format results, SQLSTATE-carrying errors.

Protocol reference: PostgreSQL docs "Frontend/Backend Protocol". Only
the simple-query flow is implemented — every suite statement is a
single 'Q' message; results arrive as RowDescription / DataRow* /
CommandComplete, bracketed by ReadyForQuery.

The port's copy of `jepsen_tpu/dbs/pg_proto.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import socket
import struct


PROTOCOL_V3 = 196608        # 3 << 16
SSL_REQUEST = 80877103


class PgError(Exception):
    """Server ErrorResponse. sqlstate is the 5-char class code ('C'
    field) — '40001' is serialization_failure, cockroach's 'restart
    transaction' class."""

    def __init__(self, sqlstate: str | None, message: str,
                 severity: str = "ERROR"):
        super().__init__(f"{severity} {sqlstate}: {message}")
        self.sqlstate = sqlstate
        self.message = message
        self.severity = severity

    @property
    def retryable(self) -> bool:
        return self.sqlstate == "40001"


class PgProtocolError(Exception):
    pass


class Result:
    """One statement's outcome: column names, text rows (None for SQL
    NULL), and the CommandComplete tag (e.g. 'UPDATE 2')."""

    def __init__(self, columns: list, rows: list, tag: str):
        self.columns = columns
        self.rows = rows
        self.tag = tag

    @property
    def rowcount(self) -> int:
        """Rows affected, parsed off the tag (INSERT's tag is
        'INSERT <oid> <rows>')."""
        parts = self.tag.split()
        try:
            return int(parts[-1])
        except (ValueError, IndexError):
            return 0

    def scalars(self) -> list:
        return [r[0] for r in self.rows]

    def __repr__(self):
        return f"Result({self.tag!r}, {len(self.rows)} rows)"


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("pg connection closed mid-message")
        buf += chunk
    return buf


def read_message(sock: socket.socket) -> tuple:
    """(type_byte, payload) — payload excludes the length word."""
    t = _read_exact(sock, 1)
    (length,) = struct.unpack("!i", _read_exact(sock, 4))
    return t, _read_exact(sock, length - 4)


def _cstr(payload: bytes, off: int) -> tuple:
    end = payload.index(b"\x00", off)
    return payload[off:end].decode(), end + 1


def parse_error(payload: bytes) -> PgError:
    fields = {}
    off = 0
    while off < len(payload) and payload[off] != 0:
        code = chr(payload[off])
        value, off = _cstr(payload, off + 1)
        fields[code] = value
    return PgError(fields.get("C"), fields.get("M", ""),
                   fields.get("S", "ERROR"))


class PgConn:
    """One pgwire connection. Not thread-safe (one worker per client,
    like the reference's one JDBC conn per worker)."""

    def __init__(self, host: str, port: int, user: str = "root",
                 database: str = "jepsen", password: str | None = None,
                 timeout: float = 10.0, connect_timeout: float = 30.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)
        self._startup(user, database, password)

    # -- session setup ----------------------------------------------------

    def _startup(self, user: str, database: str,
                 password: str | None) -> None:
        params = (f"user\x00{user}\x00database\x00{database}\x00\x00"
                  .encode())
        msg = struct.pack("!ii", 8 + len(params), PROTOCOL_V3) + params
        self.sock.sendall(msg)
        while True:
            t, payload = read_message(self.sock)
            if t == b"R":
                (auth,) = struct.unpack("!i", payload[:4])
                if auth == 0:
                    continue  # AuthenticationOk
                if auth == 3:  # cleartext password
                    if password is None:
                        raise PgProtocolError("server wants a password")
                    body = password.encode() + b"\x00"
                    self.sock.sendall(
                        b"p" + struct.pack("!i", 4 + len(body)) + body)
                    continue
                raise PgProtocolError(f"unsupported auth method {auth}")
            if t in (b"S", b"K", b"N"):  # params, key data, notice
                continue
            if t == b"E":
                raise parse_error(payload)
            if t == b"Z":
                return
            raise PgProtocolError(f"unexpected startup message {t!r}")

    # -- queries ----------------------------------------------------------

    def query(self, sql: str) -> Result:
        """Run one statement via simple Query; raise PgError on server
        error (after draining to ReadyForQuery so the connection stays
        usable — the JDBC driver does the same)."""
        body = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!i", 4 + len(body)) + body)
        columns: list = []
        rows: list = []
        tag = ""
        error: PgError | None = None
        while True:
            t, payload = read_message(self.sock)
            if t == b"T":
                columns = self._parse_row_description(payload)
            elif t == b"D":
                rows.append(self._parse_data_row(payload))
            elif t == b"C":
                tag, _ = _cstr(payload, 0)
            elif t == b"E":
                error = parse_error(payload)
            elif t in (b"N", b"S"):
                continue
            elif t == b"I":  # EmptyQueryResponse
                tag = ""
            elif t == b"Z":
                if error is not None:
                    raise error
                return Result(columns, rows, tag)
            else:
                raise PgProtocolError(f"unexpected message {t!r}")

    @staticmethod
    def _parse_row_description(payload: bytes) -> list:
        (n,) = struct.unpack("!h", payload[:2])
        cols = []
        off = 2
        for _ in range(n):
            name, off = _cstr(payload, off)
            off += 18  # tableoid i32, attnum i16, typoid i32, typlen i16,
            #            typmod i32, format i16
            cols.append(name)
        return cols

    @staticmethod
    def _parse_data_row(payload: bytes) -> tuple:
        (n,) = struct.unpack("!h", payload[:2])
        vals = []
        off = 2
        for _ in range(n):
            (length,) = struct.unpack("!i", payload[off:off + 4])
            off += 4
            if length < 0:
                vals.append(None)
            else:
                vals.append(payload[off:off + length].decode())
                off += length
        return tuple(vals)

    def close(self) -> None:
        try:
            self.sock.sendall(b"X" + struct.pack("!i", 4))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
