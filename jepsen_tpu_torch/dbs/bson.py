"""Minimal BSON encoder/decoder — just the types the mongodb suites
exchange: documents, arrays, strings, booleans, null, int32/int64,
doubles. (The reference rides the monger/Java driver's codecs; there is
no Python BSON library baked into this environment.)

The port's copy of `jepsen_tpu/dbs/bson.py`: the same type tags, the
same int32/int64/double choice and key order, byte for byte."""

from __future__ import annotations

import struct


def encode(doc: dict) -> bytes:
    body = b"".join(_encode_element(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _encode_element(key: str, v) -> bytes:
    k = key.encode() + b"\x00"
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + k + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + k + struct.pack("<i", v)
        return b"\x12" + k + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + k + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"\x02" + k + struct.pack("<i", len(b) + 1) + b + b"\x00"
    if v is None:
        return b"\x0a" + k
    if isinstance(v, dict):
        return b"\x03" + k + encode(v)
    if isinstance(v, (list, tuple)):
        return b"\x04" + k + encode(
            {str(i): x for i, x in enumerate(v)})
    raise TypeError(f"can't BSON-encode {type(v)}")


def decode(data: bytes, pos: int = 0) -> tuple:
    """(doc, next_pos)."""
    (length,) = struct.unpack_from("<i", data, pos)
    end = pos + length - 1  # excl. trailing NUL
    pos += 4
    doc: dict = {}
    while pos < end:
        t = data[pos]
        pos += 1
        key_end = data.index(b"\x00", pos)
        key = data[pos:key_end].decode()
        pos = key_end + 1
        if t == 0x01:
            (v,) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif t == 0x02:
            (slen,) = struct.unpack_from("<i", data, pos)
            v = data[pos + 4:pos + 4 + slen - 1].decode()
            pos += 4 + slen
        elif t in (0x03, 0x04):
            v, pos = decode(data, pos)
            if t == 0x04:
                v = [v[str(i)] for i in range(len(v))]
        elif t == 0x08:
            v = data[pos] == 1
            pos += 1
        elif t == 0x0A:
            v = None
        elif t == 0x10:
            (v,) = struct.unpack_from("<i", data, pos)
            pos += 4
        elif t == 0x12:
            (v,) = struct.unpack_from("<q", data, pos)
            pos += 8
        else:
            raise ValueError(f"unsupported BSON type 0x{t:02x}")
        doc[key] = v
    return doc, end + 1
