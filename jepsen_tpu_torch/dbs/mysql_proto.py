"""Minimal MySQL client/server wire protocol — the transport for the
galera, percona, mysql-cluster, and tidb suites (all MySQL-protocol
systems; the reference drives them through clojure.java.jdbc + the
MariaDB/MySQL JDBC drivers, e.g. galera.clj:86-93).

Implemented subset: protocol-41 handshake with mysql_native_password
auth, COM_QUERY with text resultsets, OK/ERR packets (including the
1213 deadlock code whose message — "Deadlock found when trying to get
lock; try restarting transaction" — is the exact string the suites'
txn-abort taxonomy matches on), COM_QUIT.

Packet framing: 3-byte little-endian length + 1-byte sequence id.

The port's copy of `jepsen_tpu/dbs/mysql_proto.py`: it imports nothing
of `jepsen_tpu` (the simulators' member processes load it).
"""

from __future__ import annotations

import hashlib
import socket
import struct

CLIENT_LONG_PASSWORD = 0x00000001
CLIENT_FOUND_ROWS = 0x00000002
CLIENT_PROTOCOL_41 = 0x00000200
CLIENT_SECURE_CONNECTION = 0x00008000
CLIENT_PLUGIN_AUTH = 0x00080000
CLIENT_CONNECT_WITH_DB = 0x00000008
CLIENT_TRANSACTIONS = 0x00002000

DEADLOCK_MSG = ("Deadlock found when trying to get lock; "
                "try restarting transaction")

ER_DUP_ENTRY = 1062
ER_LOCK_DEADLOCK = 1213
ER_PARSE_ERROR = 1064
ER_NO_SUCH_TABLE = 1146


class MySqlError(Exception):
    def __init__(self, code: int, message: str, sqlstate: str = "HY000"):
        super().__init__(f"({code}) {message}")
        self.code = code
        self.message = message
        self.sqlstate = sqlstate

    @property
    def deadlock(self) -> bool:
        return self.code == ER_LOCK_DEADLOCK


class MySqlProtocolError(Exception):
    pass


def scramble_native(password: str, nonce: bytes) -> bytes:
    """mysql_native_password: SHA1(pw) XOR SHA1(nonce + SHA1(SHA1(pw)))."""
    if not password:
        return b""
    p1 = hashlib.sha1(password.encode()).digest()
    p2 = hashlib.sha1(p1).digest()
    mix = hashlib.sha1(nonce + p2).digest()
    return bytes(a ^ b for a, b in zip(p1, mix))


def lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < 1 << 16:
        return b"\xfc" + struct.pack("<H", n)
    if n < 1 << 24:
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def lenenc_str(b: bytes) -> bytes:
    return lenenc_int(len(b)) + b


def read_lenenc_int(buf: bytes, pos: int) -> tuple:
    first = buf[pos]
    if first < 0xFB:
        return first, pos + 1
    if first == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if first == 0xFD:
        return (struct.unpack_from("<I", buf[pos + 1:pos + 4] + b"\x00")[0],
                pos + 4)
    if first == 0xFE:
        return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9
    raise MySqlProtocolError(f"bad lenenc int 0x{first:02x}")


class PacketIO:
    """Framed packet reader/writer over a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.seq = 0

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("mysql connection closed")
            buf += chunk
        return buf

    def read_packet(self) -> bytes:
        header = self._read_exact(4)
        length = header[0] | (header[1] << 8) | (header[2] << 16)
        self.seq = (header[3] + 1) & 0xFF
        return self._read_exact(length)

    def write_packet(self, payload: bytes) -> None:
        header = struct.pack("<I", len(payload))[:3] + bytes([self.seq])
        self.seq = (self.seq + 1) & 0xFF
        self.sock.sendall(header + payload)

    def reset_seq(self) -> None:
        self.seq = 0


def parse_err(payload: bytes) -> MySqlError:
    (code,) = struct.unpack_from("<H", payload, 1)
    pos = 3
    sqlstate = "HY000"
    if pos < len(payload) and payload[pos:pos + 1] == b"#":
        sqlstate = payload[pos + 1:pos + 6].decode()
        pos += 6
    return MySqlError(code, payload[pos:].decode(errors="replace"),
                      sqlstate)


class Result:
    def __init__(self, columns: list, rows: list, affected: int = 0):
        self.columns = columns
        self.rows = rows
        self.affected = affected

    @property
    def rowcount(self) -> int:
        return self.affected

    def scalars(self) -> list:
        return [r[0] for r in self.rows]


class MySqlConn:
    """One MySQL-protocol connection. Not thread-safe."""

    def __init__(self, host: str, port: int, user: str = "jepsen",
                 password: str = "", database: str = "",
                 timeout: float = 10.0, connect_timeout: float = 30.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)
        self.io = PacketIO(self.sock)
        self._handshake(user, password, database)

    def _handshake(self, user: str, password: str, database: str) -> None:
        payload = self.io.read_packet()
        if payload[0] == 0xFF:
            raise parse_err(payload)
        if payload[0] != 10:
            raise MySqlProtocolError(f"unsupported protocol {payload[0]}")
        pos = 1
        end = payload.index(b"\x00", pos)  # server version
        pos = end + 1 + 4                  # thread id
        nonce1 = payload[pos:pos + 8]
        pos += 8 + 1                       # filler
        pos += 2 + 1 + 2 + 2               # caps low, charset, status, caps hi
        pos += 1 + 10                      # auth data len + reserved
        nonce2 = payload[pos:pos + 12]     # 13 bytes incl NUL; use 12
        nonce = nonce1 + nonce2

        # CLIENT_FOUND_ROWS: UPDATE reports MATCHED rows, so a CAS
        # write of an identical value still counts (the JDBC drivers
        # the reference suites ride set this too)
        caps = (CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS
                | CLIENT_PROTOCOL_41 | CLIENT_SECURE_CONNECTION
                | CLIENT_PLUGIN_AUTH | CLIENT_TRANSACTIONS)
        if database:
            caps |= CLIENT_CONNECT_WITH_DB
        auth = scramble_native(password, nonce)
        resp = struct.pack("<IIB23x", caps, 1 << 24, 33)
        resp += user.encode() + b"\x00"
        resp += bytes([len(auth)]) + auth
        if database:
            resp += database.encode() + b"\x00"
        resp += b"mysql_native_password\x00"
        self.io.write_packet(resp)

        payload = self.io.read_packet()
        if payload[0] == 0xFF:
            raise parse_err(payload)
        if payload[0] == 0xFE:
            # AuthSwitchRequest (e.g. a server defaulting to
            # caching_sha2_password): switch to the requested plugin
            # when it's mysql_native_password, else give up cleanly
            end = payload.index(b"\x00", 1)
            plugin = payload[1:end].decode()
            if plugin != "mysql_native_password":
                raise MySqlProtocolError(
                    f"unsupported auth plugin {plugin!r}")
            new_nonce = payload[end + 1:].rstrip(b"\x00")
            self.io.write_packet(scramble_native(password, new_nonce))
            payload = self.io.read_packet()
            if payload[0] == 0xFF:
                raise parse_err(payload)
        if payload[0] not in (0x00,):
            raise MySqlProtocolError(
                f"unexpected auth reply 0x{payload[0]:02x}")

    def query(self, sql: str) -> Result:
        self.io.reset_seq()
        self.io.write_packet(b"\x03" + sql.encode())
        payload = self.io.read_packet()
        if payload[0] == 0xFF:
            raise parse_err(payload)
        if payload[0] == 0x00:  # OK packet
            affected, pos = read_lenenc_int(payload, 1)
            return Result([], [], affected)
        # resultset
        n_cols, _ = read_lenenc_int(payload, 0)
        columns = []
        for _ in range(n_cols):
            col = self.io.read_packet()
            columns.append(self._parse_column(col))
        eof = self.io.read_packet()
        if eof[0] != 0xFE:
            raise MySqlProtocolError("expected EOF after columns")
        rows = []
        while True:
            payload = self.io.read_packet()
            if payload[0] == 0xFE and len(payload) < 9:
                return Result(columns, rows)
            if payload[0] == 0xFF:
                raise parse_err(payload)
            row = []
            pos = 0
            for _ in range(n_cols):
                if payload[pos] == 0xFB:  # NULL
                    row.append(None)
                    pos += 1
                else:
                    length, pos = read_lenenc_int(payload, pos)
                    row.append(payload[pos:pos + length].decode())
                    pos += length
            rows.append(tuple(row))

    @staticmethod
    def _parse_column(payload: bytes) -> str:
        # catalog, schema, table, org_table, name, org_name (lenenc strs)
        pos = 0
        out = ""
        for i in range(5):
            length, pos = read_lenenc_int(payload, pos)
            s = payload[pos:pos + length]
            pos += length
            if i == 4:
                out = s.decode()
        return out

    def close(self) -> None:
        try:
            self.io.reset_seq()
            self.io.write_packet(b"\x01")  # COM_QUIT
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Server-side helpers (for the sim)


def ok_packet(affected: int = 0) -> bytes:
    return b"\x00" + lenenc_int(affected) + lenenc_int(0) + b"\x02\x00\x00\x00"


def err_packet(code: int, message: str, sqlstate: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#"
            + sqlstate.encode()[:5].ljust(5, b"0") + message.encode())


def eof_packet() -> bytes:
    return b"\xfe\x00\x00\x02\x00"


def column_packet(name: str) -> bytes:
    b = name.encode()
    return (lenenc_str(b"def") + lenenc_str(b"") + lenenc_str(b"")
            + lenenc_str(b"") + lenenc_str(b) + lenenc_str(b)
            + b"\x0c" + struct.pack("<HIBHB", 33, 255, 0xFD, 0, 0)
            + b"\x00\x00")


def row_packet(row) -> bytes:
    out = b""
    for v in row:
        if v is None:
            out += b"\xfb"
        else:
            out += lenenc_str(str(v).encode())
    return out
