"""Value serialization for clients stashing structured values inside
databases (reference: jepsen.codec, codec.clj:9-29 — EDN over bytes;
here JSON over UTF-8, the ecosystem-native equivalent).

None encodes to zero bytes and zero bytes decode to None, exactly like
the reference's nil round-trip. Tuples survive a round-trip as lists
(JSON has one sequence type), which matches how histories and the store
already normalize values.

The port's copy of `jepsen_tpu/codec.py` (the rabbitmq suite's queue
values ride it)."""

from __future__ import annotations

import json


def encode(obj) -> bytes:
    """Serialize an object to bytes (codec.clj:9-15)."""
    if obj is None:
        return b""
    return json.dumps(obj).encode("utf-8")


def decode(data) -> object:
    """Deserialize bytes (or str/bytearray/memoryview) to an object
    (codec.clj:17-29)."""
    if data is None:
        return None
    if isinstance(data, str):
        data = data.encode("utf-8")
    data = bytes(data)
    if not data:
        return None
    return json.loads(data.decode("utf-8"))
