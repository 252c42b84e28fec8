"""Minimal MongoDB wire protocol (OP_MSG, opcode 2013) — the transport
for the mongodb suites. Commands are BSON documents with `$db`; replies
are single body-section BSON documents with an `ok` field (the
reference rides monger/the Java driver, mongodb_smartos/core.clj:25).

The port's copy of `jepsen_tpu/dbs/mongo_proto.py`.
"""

from __future__ import annotations

import itertools
import socket
import struct

from . import bson

OP_MSG = 2013


class MongoError(Exception):
    def __init__(self, doc: dict):
        super().__init__(doc.get("errmsg", str(doc)))
        self.code = doc.get("code")
        self.doc = doc


class MongoConn:
    _request_ids = itertools.count(1)

    def __init__(self, host: str, port: int, timeout: float = 5.0,
                 connect_timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("mongo connection closed")
            buf += chunk
        return buf

    def command(self, db: str, cmd: dict) -> dict:
        """Run one command; raises MongoError when ok != 1."""
        body = dict(cmd)
        body["$db"] = db
        payload = b"\x00\x00\x00\x00"  # flags
        payload += b"\x00"             # section kind 0: body
        payload += bson.encode(body)
        req_id = next(self._request_ids)
        header = struct.pack("<iiii", 16 + len(payload), req_id, 0, OP_MSG)
        self.sock.sendall(header + payload)

        (length,) = struct.unpack("<i", self._read_exact(4))
        rest = self._read_exact(length - 4)
        _resp_id, _reply_to, opcode = struct.unpack_from("<iii", rest, 0)
        if opcode != OP_MSG:
            raise MongoError({"errmsg": f"unexpected opcode {opcode}"})
        # flags (4) + section kind (1)
        doc, _ = bson.decode(rest, 12 + 4 + 1)
        if doc.get("ok") != 1 and doc.get("ok") != 1.0:
            raise MongoError(doc)
        return doc

    # -- convenience wrappers -------------------------------------------

    def find_one(self, db: str, coll: str, filter_: dict):
        out = self.command(db, {"find": coll, "filter": filter_,
                                "limit": 1})
        batch = out["cursor"]["firstBatch"]
        return batch[0] if batch else None

    def find_all(self, db: str, coll: str, filter_: dict | None = None):
        out = self.command(db, {"find": coll, "filter": filter_ or {}})
        return out["cursor"]["firstBatch"]

    def insert(self, db: str, coll: str, docs: list, w="majority") -> dict:
        return self.command(db, {
            "insert": coll, "documents": docs,
            "writeConcern": {"w": w},
        })

    def find_and_modify(self, db: str, coll: str, query: dict | None
                        = None, sort: dict | None = None,
                        remove: bool = False) -> dict:
        cmd: dict = {"findAndModify": coll, "query": query or {}}
        if sort:
            cmd["sort"] = sort
        if remove:
            cmd["remove"] = True
        return self.command(db, cmd)

    def update(self, db: str, coll: str, q: dict, u: dict,
               upsert: bool = False, w="majority") -> dict:
        """Returns the server reply; reply['n'] is matched docs."""
        return self.command(db, {
            "update": coll,
            "updates": [{"q": q, "u": u, "upsert": upsert}],
            "writeConcern": {"w": w},
        })

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
