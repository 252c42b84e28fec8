"""Minimal RESP (REdis Serialization Protocol) client — the transport
for the raftis suite (redis GET/SET on a replicated register) and the
disque suite (ADDJOB/GETJOB/ACKJOB). The reference goes through carmine
and jedisque (raftis.clj:5, disque.clj:26-28); neither has a Python
equivalent baked into this environment, so we speak the wire protocol
directly: inline command arrays out, simple-string / error / integer /
bulk / array replies back.

The port's copy of `jepsen_tpu/dbs/redis_proto.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import socket


class RespError(Exception):
    """Server '-ERR ...' reply."""


class RespConn:
    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(timeout)
        self._buf = b""

    # -- wire -------------------------------------------------------------

    def _send(self, *args) -> None:
        parts = [b"*%d\r\n" % len(args)]
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            parts.append(b"$%d\r\n%s\r\n" % (len(b), b))
        self.sock.sendall(b"".join(parts))

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("resp connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("resp connection closed")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RespError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            if n < 0:
                return None
            data = self._read_exact(n)
            self._read_exact(2)  # trailing \r\n
            return data
        if t == b"*":
            n = int(rest)
            if n < 0:
                return None
            return [self._read_reply() for _ in range(n)]
        raise RespError(f"bad reply type {line!r}")

    # -- public -----------------------------------------------------------

    def call(self, *args):
        self._send(*args)
        return self._read_reply()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
