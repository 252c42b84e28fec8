"""Minimal Aerospike wire protocol — the transport for the aerospike
suite's cas-register and counter workloads (the reference drives the
Java client, aerospike/src/aerospike/support.clj; the semantics that
matter are generation-checked writes: read returns (generation, bins),
write can demand GENERATION_EQUAL and fails with result code 3 on a
lost race).

Message layout (v2 type-3 'message' protos):
  proto header: version(1)=2, type(1)=3, length(6, big-endian)
  msg header:   header_sz(1)=22, info1, info2, info3, unused,
                result_code, generation(u32), record_ttl(u32),
                transaction_ttl(u32), n_fields(u16), n_ops(u16)
  fields:       size(u32 incl. type byte), type(1), data
                (0=namespace, 1=set, 4=ripemd160 key digest)
  ops:          size(u32), op(1) (1=read, 2=write), bin_type(1),
                version(1), name_len(1), name, value

Integers travel as 8-byte big-endian bin type 1; blobs/strings as type
3/4 raw bytes. Key digest = RIPEMD160(set + type_byte + key-bytes).

The port's copy of `jepsen_tpu/dbs/aerospike_proto.py`. The key digest
uses this module's own RIPEMD-160 (`ripemd160`), never `hashlib`'s:
OpenSSL 3 keeps RIPEMD-160 in its legacy provider, so
`hashlib.new("ripemd160")` raises `unsupported hash type` on hosts that
do not load it.
"""

from __future__ import annotations

import socket
import struct

INFO1_READ = 0x01
INFO1_GET_ALL = 0x02
INFO2_WRITE = 0x01
INFO2_GENERATION = 0x04   # write iff generation matches

FIELD_NAMESPACE = 0
FIELD_SET = 1
FIELD_DIGEST = 4

OP_READ = 1
OP_WRITE = 2
OP_APPEND = 9

BIN_TYPE_INTEGER = 1
BIN_TYPE_STRING = 3

RESULT_OK = 0
RESULT_NOT_FOUND = 2
RESULT_GENERATION = 3


class AerospikeError(Exception):
    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"result code {code}")
        self.code = code


def key_digest(set_name: str, key) -> bytes:
    """RIPEMD160 over set + key-type byte + key bytes (the client
    contract every aerospike driver implements)."""
    if isinstance(key, int):
        kb = b"\x01" + struct.pack(">q", key)
    else:
        kb = b"\x03" + str(key).encode()
    return ripemd160(set_name.encode() + kb)


# RIPEMD-160 (Dobbertin, Bosselaers, Preneel, 1996): two parallel lines
# of five 16-step rounds over little-endian 32-bit words. Per line: the
# message word each step reads, its left rotation, and each round's
# constant; the right line runs the round functions in reverse order.
_R_LEFT = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
    3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
    1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
    4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13)
_R_RIGHT = (
    5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
    6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
    15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
    8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
    12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11)
_S_LEFT = (
    11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
    7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
    11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
    11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
    9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6)
_S_RIGHT = (
    8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
    9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
    9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
    15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
    8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11)
_K_LEFT = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
_K_RIGHT = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
_MASK = 0xFFFFFFFF


def _f(rnd: int, x: int, y: int, z: int) -> int:
    if rnd == 0:
        return x ^ y ^ z
    if rnd == 1:
        return (x & y) | (~x & z)
    if rnd == 2:
        return (x | ~y) ^ z
    if rnd == 3:
        return (x & z) | (y & ~z)
    return x ^ (y | ~z)


def _rol(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & _MASK


def ripemd160(data: bytes) -> bytes:
    """The 20-byte RIPEMD-160 digest of `data`."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    msg = (bytes(data) + b"\x80" + b"\x00" * ((55 - len(data)) % 64)
           + struct.pack("<Q", 8 * len(data)))
    for off in range(0, len(msg), 64):
        x = struct.unpack_from("<16I", msg, off)
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for j in range(80):
            rnd = j // 16
            t = _rol((al + _f(rnd, bl, cl, dl) + x[_R_LEFT[j]]
                      + _K_LEFT[rnd]) & _MASK, _S_LEFT[j]) + el
            al, el, dl, cl, bl = el, dl, _rol(cl, 10), bl, t & _MASK
            t = _rol((ar + _f(4 - rnd, br, cr, dr) + x[_R_RIGHT[j]]
                      + _K_RIGHT[rnd]) & _MASK, _S_RIGHT[j]) + er
            ar, er, dr, cr, br = er, dr, _rol(cr, 10), br, t & _MASK
        h = [(h[1] + cl + dr) & _MASK, (h[2] + dl + er) & _MASK,
             (h[3] + el + ar) & _MASK, (h[4] + al + br) & _MASK,
             (h[0] + bl + cr) & _MASK]
    return struct.pack("<5I", *h)


def _field(ftype: int, data: bytes) -> bytes:
    return struct.pack(">IB", len(data) + 1, ftype) + data


def _encode_bin_value(v) -> tuple:
    if isinstance(v, int):
        return BIN_TYPE_INTEGER, struct.pack(">q", v)
    return BIN_TYPE_STRING, str(v).encode()


def _op(op_type: int, name: str, value=None) -> bytes:
    nb = name.encode()
    if value is None:
        body = struct.pack(">BBBB", op_type, 0, 0, len(nb)) + nb
    else:
        btype, vb = _encode_bin_value(value)
        body = struct.pack(">BBBB", op_type, btype, 0, len(nb)) + nb + vb
    return struct.pack(">I", len(body)) + body


def decode_bin(btype: int, data: bytes):
    if btype == BIN_TYPE_INTEGER:
        return struct.unpack(">q", data)[0]
    return data.decode(errors="replace")


def build_message(info1: int, info2: int, generation: int,
                  fields: list, ops: list) -> bytes:
    body = struct.pack(
        ">BBBBBBIIIHH", 22, info1, info2, 0, 0, 0, generation, 0, 1000,
        len(fields), len(ops))
    body += b"".join(fields) + b"".join(ops)
    return struct.pack(">BB", 2, 3) + len(body).to_bytes(6, "big") + body


def parse_message(payload: bytes) -> tuple:
    """(result_code, generation, bins, n_fields_skipped)."""
    (hdr_sz, _i1, _i2, _i3, _unused, result, generation, _ttl, _txn,
     n_fields, n_ops) = struct.unpack(">BBBBBBIIIHH", payload[:22])
    pos = hdr_sz
    for _ in range(n_fields):
        (size,) = struct.unpack_from(">I", payload, pos)
        pos += 4 + size
    bins = {}
    for _ in range(n_ops):
        (size,) = struct.unpack_from(">I", payload, pos)
        op_type, btype, _ver, name_len = struct.unpack_from(
            ">BBBB", payload, pos + 4)
        name = payload[pos + 8:pos + 8 + name_len].decode()
        value = payload[pos + 8 + name_len:pos + 4 + size]
        bins[name] = decode_bin(btype, value) if value else None
        pos += 4 + size
    return result, generation, bins


class AerospikeConn:
    def __init__(self, host: str, port: int, namespace: str = "jepsen",
                 set_name: str = "jepsen", timeout: float = 5.0,
                 connect_timeout: float = 10.0):
        self.namespace = namespace
        self.set_name = set_name
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("aerospike connection closed")
            buf += chunk
        return buf

    def _roundtrip(self, msg: bytes) -> tuple:
        self.sock.sendall(msg)
        header = self._read_exact(8)
        version, mtype = header[0], header[1]
        length = int.from_bytes(header[2:8], "big")
        payload = self._read_exact(length)
        if version != 2 or mtype != 3:
            raise AerospikeError(-1, f"bad proto {version}/{mtype}")
        return parse_message(payload)

    def _key_fields(self, key) -> list:
        return [
            _field(FIELD_NAMESPACE, self.namespace.encode()),
            _field(FIELD_SET, self.set_name.encode()),
            _field(FIELD_DIGEST, key_digest(self.set_name, key)),
        ]

    def get(self, key) -> tuple:
        """(generation, bins) or (None, None) when absent."""
        msg = build_message(INFO1_READ | INFO1_GET_ALL, 0, 0,
                            self._key_fields(key), [])
        result, generation, bins = self._roundtrip(msg)
        if result == RESULT_NOT_FOUND:
            return None, None
        if result != RESULT_OK:
            raise AerospikeError(result)
        return generation, bins

    def put(self, key, bins: dict, expected_generation: int | None = None
            ) -> None:
        """Write bins; with expected_generation, demand
        GENERATION_EQUAL (raises AerospikeError code 3 on mismatch)."""
        info2 = INFO2_WRITE
        generation = 0
        if expected_generation is not None:
            info2 |= INFO2_GENERATION
            generation = expected_generation
        ops = [_op(OP_WRITE, name, v) for name, v in bins.items()]
        msg = build_message(0, info2, generation,
                            self._key_fields(key), ops)
        result, _gen, _bins = self._roundtrip(msg)
        if result != RESULT_OK:
            raise AerospikeError(result)

    def append(self, key, bins: dict) -> None:
        """Append to string bins (the set workload's primitive:
        aerospike/set.clj:35 appends \" v\" to one bin with s/append!)."""
        ops = [_op(OP_APPEND, name, v) for name, v in bins.items()]
        msg = build_message(0, INFO2_WRITE, 0,
                            self._key_fields(key), ops)
        result, _gen, _bins = self._roundtrip(msg)
        if result != RESULT_OK:
            raise AerospikeError(result)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
