"""Minimal RethinkDB client driver: the V0_4/JSON wire protocol and the
ReQL term builders the rethinkdb suite uses (reference:
rethinkdb/src/jepsen/rethinkdb/document_cas.clj drives the clojure
rethinkdb driver; this builds the same term trees by hand).

Wire: magic V0_4 (0x400c2d20) + authkey + JSON-protocol magic
(0x7e6970c7), then NUL-terminated "SUCCESS"; queries are
8-byte token + length + JSON [START, term, opts]; replies are
token + length + JSON {t: type, r: [...]}.

The port's copy of `jepsen_tpu/dbs/rethink_proto.py`: the same term
trees and frames, byte for byte.
"""

from __future__ import annotations

import itertools
import json
import socket
import struct

V0_4 = 0x400C2D20
PROTOCOL_JSON = 0x7E6970C7

START = 1
SUCCESS_ATOM = 1
SUCCESS_SEQUENCE = 2
CLIENT_ERROR = 16
COMPILE_ERROR = 17
RUNTIME_ERROR = 18

# term types (ql2 protocol)
MAKE_ARRAY = 2
VAR = 10
ERROR = 12
DB = 14
TABLE = 15
GET = 16
EQ = 17
GET_FIELD = 31
UPDATE = 53
INSERT = 56
DB_CREATE = 57
TABLE_CREATE = 60
BRANCH = 65
FUNC = 69
DEFAULT = 92
RECONFIGURE = 176


class ReqlError(Exception):
    def __init__(self, rtype: int, message: str):
        super().__init__(message)
        self.rtype = rtype


def datum(v):
    """Literal values; arrays must become MAKE_ARRAY terms."""
    if isinstance(v, (list, tuple)):
        return [MAKE_ARRAY, [datum(x) for x in v]]
    if isinstance(v, dict):
        return {k: datum(x) for k, x in v.items()}
    return v


def db(name):
    return [DB, [name]]


def table(db_term, name, read_mode=None):
    opts = {"read_mode": read_mode} if read_mode else {}
    return [TABLE, [db_term, name], opts] if opts else [TABLE,
                                                        [db_term, name]]


def get(table_term, key):
    return [GET, [table_term, key]]


def insert(table_term, doc, conflict=None):
    opts = {"conflict": conflict} if conflict else {}
    args = [table_term, datum(doc)]
    return [INSERT, args, opts] if opts else [INSERT, args]


def update(sel_term, patch_or_func):
    return [UPDATE, [sel_term, patch_or_func]]


def get_field(term, field):
    return [GET_FIELD, [term, field]]


def eq(a, b):
    return [EQ, [a, b]]


def branch(cond, then, otherwise):
    return [BRANCH, [cond, datum(then), otherwise]]


def error(msg):
    return [ERROR, [msg]]


def func(param_id, body):
    return [FUNC, [[MAKE_ARRAY, [param_id]], body]]


def var(param_id):
    return [VAR, [param_id]]


def default(term, fallback):
    return [DEFAULT, [term, fallback]]


def db_create(name):
    return [DB_CREATE, [name]]


def table_create(db_term, name, replicas=None):
    opts = {"replicas": replicas} if replicas else {}
    return ([TABLE_CREATE, [db_term, name], opts] if opts
            else [TABLE_CREATE, [db_term, name]])


def reconfigure(table_term, shards: int, replicas: dict,
                primary_replica_tag: str):
    """r.table(...).reconfigure({shards, replicas: {tag: n...},
    primary_replica_tag}) — the topology-change call the reconfigure
    nemesis drives (rethinkdb.clj:180-194)."""
    return [RECONFIGURE, [table_term],
            {"shards": shards,
             "replicas": datum(replicas),
             "primary_replica_tag": primary_replica_tag}]


class ReqlConn:
    _tokens = itertools.count(1)

    def __init__(self, host: str, port: int, auth_key: str = "",
                 timeout: float = 5.0, connect_timeout: float = 10.0):
        self.sock = socket.create_connection((host, port),
                                             timeout=connect_timeout)
        self.sock.settimeout(timeout)
        key = auth_key.encode()
        self.sock.sendall(struct.pack("<I", V0_4)
                          + struct.pack("<I", len(key)) + key
                          + struct.pack("<I", PROTOCOL_JSON))
        greeting = b""
        while not greeting.endswith(b"\x00"):
            chunk = self.sock.recv(64)
            if not chunk:
                raise ConnectionError("rethinkdb handshake EOF")
            greeting += chunk
        if b"SUCCESS" not in greeting:
            raise ReqlError(CLIENT_ERROR, greeting.decode(errors="replace"))

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rethinkdb connection closed")
            buf += chunk
        return buf

    def run(self, term):
        """Run one term; returns the response payload (atom value, or a
        list for sequences)."""
        token = next(self._tokens)
        q = json.dumps([START, term, {}]).encode()
        self.sock.sendall(struct.pack("<q", token)
                          + struct.pack("<I", len(q)) + q)
        r_token = struct.unpack("<q", self._read_exact(8))[0]
        if r_token != token:
            raise ReqlError(CLIENT_ERROR, "token mismatch")
        (length,) = struct.unpack("<I", self._read_exact(4))
        resp = json.loads(self._read_exact(length))
        t = resp["t"]
        if t == SUCCESS_ATOM:
            return resp["r"][0]
        if t == SUCCESS_SEQUENCE:
            return resp["r"]
        raise ReqlError(t, str(resp.get("r")))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
