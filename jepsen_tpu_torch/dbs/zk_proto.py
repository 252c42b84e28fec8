"""Minimal ZooKeeper wire protocol (jute) — client side.

The zookeeper suite needs exactly what the reference's avout zk-atom
uses (zookeeper/src/jepsen/zookeeper.clj:78-104): a
session, create, getData, setData-with-version (optimistic CAS), and
ping. This implements that subset of the ZooKeeper 3.4 protocol from the
jute IDL: length-framed packets, a ConnectRequest handshake, then
xid/opcode request frames. No external ZK library exists in this
environment, so the framework carries its own client.

All multi-byte integers are big-endian. Strings and buffers are
length-prefixed (-1 = null).

The port's copy of `jepsen_tpu/dbs/zk_proto.py`: the same frames, byte
for byte.
"""

from __future__ import annotations

import socket
import struct
import threading

# Opcodes (zookeeper.h)
OP_CREATE = 1
OP_DELETE = 2
OP_EXISTS = 3
OP_GET_DATA = 4
OP_SET_DATA = 5
OP_PING = 11
OP_CLOSE = -11

XID_PING = -2

# Error codes
OK = 0
ERR_UNIMPLEMENTED = -6
ERR_NO_NODE = -101
ERR_NODE_EXISTS = -110
ERR_BAD_VERSION = -103

#: world:anyone ACL with all perms (0x1f)
OPEN_ACL_UNSAFE = [(0x1F, "world", "anyone")]

STAT_STRUCT = struct.Struct(">qqqqiiiqiiq")  # 68 bytes


class ZkError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"zookeeper error {code}")
        self.code = code


class NoNode(ZkError):
    def __init__(self):
        super().__init__(ERR_NO_NODE, "no node")


class NodeExists(ZkError):
    def __init__(self):
        super().__init__(ERR_NODE_EXISTS, "node exists")


class BadVersion(ZkError):
    def __init__(self):
        super().__init__(ERR_BAD_VERSION, "bad version")


_ERRS = {ERR_NO_NODE: NoNode, ERR_NODE_EXISTS: NodeExists,
         ERR_BAD_VERSION: BadVersion}


def err_for(code: int) -> ZkError:
    cls = _ERRS.get(code)
    return cls() if cls else ZkError(code)


# ---------------------------------------------------------------------------
# jute primitives

class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def int32(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">i", v))
        return self

    def int64(self, v: int) -> "Writer":
        self.parts.append(struct.pack(">q", v))
        return self

    def bool_(self, v: bool) -> "Writer":
        self.parts.append(b"\x01" if v else b"\x00")
        return self

    def buffer(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.int32(-1)
        self.int32(len(b))
        self.parts.append(b)
        return self

    def ustring(self, s: str | None) -> "Writer":
        return self.buffer(None if s is None else s.encode())

    def acls(self, acls) -> "Writer":
        self.int32(len(acls))
        for perms, scheme, ident in acls:
            self.int32(perms).ustring(scheme).ustring(ident)
        return self

    def bytes_(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ZkError(0, "short packet")
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def bool_(self) -> bool:
        return self._take(1) != b"\x00"

    def buffer(self) -> bytes | None:
        n = self.int32()
        return None if n < 0 else self._take(n)

    def ustring(self) -> str | None:
        b = self.buffer()
        return None if b is None else b.decode()

    def stat(self) -> dict:
        (czxid, mzxid, ctime, mtime, version, cversion, aversion,
         ephemeral_owner, data_length, num_children, pzxid) = (
            STAT_STRUCT.unpack(self._take(STAT_STRUCT.size)))
        return {
            "czxid": czxid, "mzxid": mzxid, "ctime": ctime, "mtime": mtime,
            "version": version, "cversion": cversion, "aversion": aversion,
            "ephemeralOwner": ephemeral_owner, "dataLength": data_length,
            "numChildren": num_children, "pzxid": pzxid,
        }


def pack_stat(stat: dict) -> bytes:
    return STAT_STRUCT.pack(
        stat.get("czxid", 0), stat.get("mzxid", 0), stat.get("ctime", 0),
        stat.get("mtime", 0), stat.get("version", 0),
        stat.get("cversion", 0), stat.get("aversion", 0),
        stat.get("ephemeralOwner", 0), stat.get("dataLength", 0),
        stat.get("numChildren", 0), stat.get("pzxid", 0),
    )


def read_frame(sock: socket.socket) -> bytes:
    head = _recv_exact(sock, 4)
    (n,) = struct.unpack(">i", head)
    if n < 0 or n > 64 * 1024 * 1024:
        raise ZkError(0, f"bad frame length {n}")
    return _recv_exact(sock, n)


def write_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">i", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(n)
        if not b:
            raise ConnectionError("connection closed")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


# ---------------------------------------------------------------------------
# Client connection

class ZkConn:
    """One ZooKeeper session over one socket. Synchronous, lock-guarded:
    requests are matched to responses by xid in order."""

    def __init__(self, host: str, port: int = 2181,
                 timeout: float = 5.0, session_timeout_ms: int = 10_000):
        self.timeout = timeout
        self._lock = threading.Lock()
        self._xid = 0
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        # ConnectRequest: protocolVersion, lastZxidSeen, timeOut,
        # sessionId, passwd
        req = (Writer().int32(0).int64(0).int32(session_timeout_ms)
               .int64(0).buffer(b"\x00" * 16).bytes_())
        write_frame(self.sock, req)
        resp = Reader(read_frame(self.sock))
        resp.int32()  # protocolVersion
        self.negotiated_timeout = resp.int32()
        self.session_id = resp.int64()
        resp.buffer()  # passwd

    def _call(self, opcode: int, payload: bytes, xid: int | None = None
              ) -> Reader:
        with self._lock:
            if xid is None:
                self._xid += 1
                xid = self._xid
            write_frame(
                self.sock,
                Writer().int32(xid).int32(opcode).bytes_() + payload,
            )
            r = Reader(read_frame(self.sock))
        got_xid = r.int32()
        r.int64()  # zxid
        err = r.int32()
        if got_xid != xid:
            raise ZkError(0, f"xid mismatch: sent {xid}, got {got_xid}")
        if err != OK:
            raise err_for(err)
        return r

    def create(self, path: str, data: bytes = b"",
               acls=OPEN_ACL_UNSAFE, flags: int = 0) -> str:
        payload = (Writer().ustring(path).buffer(data).acls(acls)
                   .int32(flags).bytes_())
        return self._call(OP_CREATE, payload).ustring() or path

    def exists(self, path: str) -> dict | None:
        try:
            r = self._call(OP_EXISTS,
                           Writer().ustring(path).bool_(False).bytes_())
            return r.stat()
        except NoNode:
            return None

    def get_data(self, path: str) -> tuple[bytes, dict]:
        r = self._call(OP_GET_DATA,
                       Writer().ustring(path).bool_(False).bytes_())
        data = r.buffer() or b""
        return data, r.stat()

    def set_data(self, path: str, data: bytes, version: int = -1) -> dict:
        payload = (Writer().ustring(path).buffer(data)
                   .int32(version).bytes_())
        return self._call(OP_SET_DATA, payload).stat()

    def delete(self, path: str, version: int = -1) -> None:
        self._call(OP_DELETE, Writer().ustring(path).int32(version).bytes_())

    def ping(self) -> None:
        self._call(OP_PING, b"", xid=XID_PING)

    def close(self) -> None:
        try:
            with self._lock:
                write_frame(
                    self.sock, Writer().int32(self._xid + 1)
                    .int32(OP_CLOSE).bytes_()
                )
        except OSError:
            pass
        finally:
            try:
                self.sock.close()
            except OSError:
                pass
