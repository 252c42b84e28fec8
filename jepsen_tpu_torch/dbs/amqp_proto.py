"""Minimal AMQP 0-9-1 client — the transport for the rabbitmq suite
(the reference rides langohr/the Java client, rabbitmq.clj:1-263).

Implemented subset: connection handshake (PLAIN auth), channel open,
queue declare/purge, publisher confirms (confirm.select + basic.ack
tracking), basic.publish (method + content header + body frames),
basic.get with auto-ack. Frames are type(1) channel(2) size(4) payload
0xCE; methods are class-id(2) method-id(2) + packed arguments.

The port's copy of `jepsen_tpu/dbs/amqp_proto.py`."""

from __future__ import annotations

import socket
import struct

FRAME_METHOD = 1
FRAME_HEADER = 2
FRAME_BODY = 3
FRAME_END = 0xCE

# (class, method)
CONN_START = (10, 10)
CONN_START_OK = (10, 11)
CONN_TUNE = (10, 30)
CONN_TUNE_OK = (10, 31)
CONN_OPEN = (10, 40)
CONN_OPEN_OK = (10, 41)
CONN_CLOSE = (10, 50)
CH_OPEN = (20, 10)
CH_OPEN_OK = (20, 11)
Q_DECLARE = (50, 10)
Q_DECLARE_OK = (50, 11)
Q_PURGE = (50, 30)
Q_PURGE_OK = (50, 31)
BASIC_PUBLISH = (60, 40)
BASIC_GET = (60, 70)
BASIC_GET_OK = (60, 71)
BASIC_GET_EMPTY = (60, 72)
BASIC_ACK = (60, 80)
BASIC_REJECT = (60, 90)
CONFIRM_SELECT = (85, 10)
CONFIRM_SELECT_OK = (85, 11)


class AmqpError(Exception):
    pass


def shortstr(s: str) -> bytes:
    b = s.encode()
    return bytes([len(b)]) + b


def longstr(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


def read_shortstr(buf: bytes, pos: int) -> tuple:
    n = buf[pos]
    return buf[pos + 1:pos + 1 + n].decode(), pos + 1 + n


class AmqpConn:
    def __init__(self, host: str, port: int, user: str = "guest",
                 password: str = "guest", vhost: str = "/",
                 timeout: float = 5.0, connect_timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)
        self._handshake(user, password, vhost)
        self._channel_open = False
        self._confirms = False
        self._publish_seq = 0

    # -- framing ----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("amqp connection closed")
            buf += chunk
        return buf

    def _read_frame(self) -> tuple:
        header = self._read_exact(7)
        ftype, channel, size = struct.unpack(">BHI", header)
        payload = self._read_exact(size)
        end = self._read_exact(1)
        if end[0] != FRAME_END:
            raise AmqpError("bad frame end")
        return ftype, channel, payload

    def _send_frame(self, ftype: int, channel: int,
                    payload: bytes) -> None:
        self.sock.sendall(struct.pack(">BHI", ftype, channel,
                                      len(payload))
                          + payload + bytes([FRAME_END]))

    def _send_method(self, channel: int, cm: tuple,
                     args: bytes = b"") -> None:
        self._send_frame(FRAME_METHOD, channel,
                         struct.pack(">HH", *cm) + args)

    def _expect_method(self, want: tuple) -> bytes:
        ftype, _ch, payload = self._read_frame()
        if ftype != FRAME_METHOD:
            raise AmqpError(f"expected method frame, got {ftype}")
        cm = struct.unpack_from(">HH", payload)
        if cm == CONN_CLOSE:
            code, = struct.unpack_from(">H", payload, 4)
            text, _ = read_shortstr(payload, 6)
            raise AmqpError(f"connection closed ({code}): {text}")
        if cm != want:
            raise AmqpError(f"expected {want}, got {cm}")
        return payload[4:]

    # -- connection -------------------------------------------------------

    def _handshake(self, user: str, password: str, vhost: str) -> None:
        self.sock.sendall(b"AMQP\x00\x00\x09\x01")
        self._expect_method(CONN_START)
        creds = b"\x00" + user.encode() + b"\x00" + password.encode()
        args = (struct.pack(">I", 0)          # empty client props table
                + shortstr("PLAIN") + longstr(creds) + shortstr("en_US"))
        self._send_method(0, CONN_START_OK, args)
        self._expect_method(CONN_TUNE)
        self._send_method(0, CONN_TUNE_OK,
                          struct.pack(">HIH", 0, 131072, 0))
        self._send_method(0, CONN_OPEN,
                          shortstr(vhost) + shortstr("") + b"\x00")
        self._expect_method(CONN_OPEN_OK)
        self._send_method(1, CH_OPEN, shortstr(""))
        self._expect_method(CH_OPEN_OK)
        self._channel_open = True

    # -- operations -------------------------------------------------------

    def queue_declare(self, queue: str, durable: bool = True) -> None:
        bits = 0x02 if durable else 0
        args = (struct.pack(">H", 0) + shortstr(queue) + bytes([bits])
                + struct.pack(">I", 0))
        self._send_method(1, Q_DECLARE, args)
        self._expect_method(Q_DECLARE_OK)

    def queue_purge(self, queue: str) -> int:
        args = struct.pack(">H", 0) + shortstr(queue) + b"\x00"
        self._send_method(1, Q_PURGE, args)
        payload = self._expect_method(Q_PURGE_OK)
        return struct.unpack_from(">I", payload)[0]

    def confirm_select(self) -> None:
        self._send_method(1, CONFIRM_SELECT, b"\x00")
        self._expect_method(CONFIRM_SELECT_OK)
        self._confirms = True

    def publish(self, queue: str, body: bytes,
                persistent: bool = True) -> bool:
        """Publish to the default exchange; with confirms enabled,
        True once the broker acks (rabbitmq.clj:155-164)."""
        args = (struct.pack(">H", 0) + shortstr("") + shortstr(queue)
                + b"\x00")
        self._send_method(1, BASIC_PUBLISH, args)
        # content header: class 60, weight 0, body size, flags
        flags = 0
        prop_payload = b""
        if persistent:
            flags |= 1 << 12                      # delivery-mode prop
            prop_payload = bytes([2])
        header = (struct.pack(">HHQ", 60, 0, len(body))
                  + struct.pack(">H", flags) + prop_payload)
        self._send_frame(FRAME_HEADER, 1, header)
        self._send_frame(FRAME_BODY, 1, body)
        if not self._confirms:
            return True
        self._publish_seq += 1
        payload = self._expect_method(BASIC_ACK)
        tag, = struct.unpack_from(">Q", payload)
        return tag >= self._publish_seq or bool(payload[8] & 1)

    def _basic_get(self, queue: str, no_ack: bool):
        """basic.get: (delivery_tag, body), or None when empty."""
        args = (struct.pack(">H", 0) + shortstr(queue)
                + (b"\x01" if no_ack else b"\x00"))
        self._send_method(1, BASIC_GET, args)
        ftype, _ch, payload = self._read_frame()
        cm = struct.unpack_from(">HH", payload)
        if cm == BASIC_GET_EMPTY:
            return None
        if cm != BASIC_GET_OK:
            raise AmqpError(f"unexpected get reply {cm}")
        tag, _redelivered = struct.unpack_from(">QB", payload, 4)
        ftype, _ch, header = self._read_frame()
        if ftype != FRAME_HEADER:
            raise AmqpError("expected content header")
        _cls, _weight, size = struct.unpack_from(">HHQ", header)
        body = b""
        while len(body) < size:
            ftype, _ch, chunk = self._read_frame()
            if ftype != FRAME_BODY:
                raise AmqpError("expected body frame")
            body += chunk
        return tag, body

    def get(self, queue: str):
        """Auto-ack basic.get: body bytes, or None when empty
        (langohr's lb/get, rabbitmq.clj:110)."""
        r = self._basic_get(queue, no_ack=True)
        return None if r is None else r[1]

    def get_unacked(self, queue: str):
        """basic.get WITHOUT auto-ack: (delivery_tag, body), or None
        when empty. The broker holds the message against this
        connection until it is acked/rejected — or the connection
        dies, at which point it requeues. This is the primitive under
        the distributed-semaphore pattern (rabbitmq.clj:185-226:
        holding the unacked delivery IS holding the mutex)."""
        return self._basic_get(queue, no_ack=False)

    def reject(self, delivery_tag: int, requeue: bool = True) -> None:
        """basic.reject (no -ok reply in AMQP 0-9-1): releases an
        unacked delivery, requeueing it when asked (lb/reject,
        rabbitmq.clj:250)."""
        args = struct.pack(">Q", delivery_tag) + bytes([1 if requeue
                                                        else 0])
        self._send_method(1, BASIC_REJECT, args)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
