"""A hermetic MongoDB lookalike: an OP_MSG server handling the command
subset the mongodb suites drive — ping, hello/isMaster, insert, update
(exact-match filters, upsert, n-matched reporting), find, and
replSetInitiate/replSetGetStatus as accepted no-ops (membership is
implicit in the shared state). Collections live in the flock-guarded
JSON store as {db.coll: [docs]}.

The port's copy of `jepsen_tpu/dbs/mongo_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the mongodb suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import random
import socketserver
import struct
import sys
import time

from . import bson, mongo_proto
from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn


def _matches(doc: dict, q: dict) -> bool:
    return all(doc.get(k) == v for k, v in q.items())


class Handler(socketserver.BaseRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.request.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client went away")
            buf += chunk
        return buf

    def handle(self):
        self.request.settimeout(120.0)
        try:
            while True:
                (length,) = struct.unpack("<i", self._read_exact(4))
                rest = self._read_exact(length - 4)
                req_id, _reply_to, opcode = struct.unpack_from("<iii",
                                                               rest, 0)
                if opcode != mongo_proto.OP_MSG:
                    return
                cmd, _ = bson.decode(rest, 12 + 4 + 1)
                if self.mean_latency > 0:
                    time.sleep(random.expovariate(1.0 / self.mean_latency))
                reply = self._dispatch(cmd)
                payload = b"\x00\x00\x00\x00\x00" + bson.encode(reply)
                header = struct.pack("<iiii", 16 + len(payload), 0,
                                     req_id, mongo_proto.OP_MSG)
                self.request.sendall(header + payload)
        except (ConnectionError, TimeoutError, OSError, ValueError):
            return

    def _dispatch(self, cmd: dict) -> dict:
        db = cmd.get("$db", "admin")
        name = next(iter(cmd))
        if name in ("ping", "hello", "isMaster", "ismaster"):
            return {"ok": 1, "isWritablePrimary": True}
        if name in ("replSetInitiate", "replSetGetStatus"):
            return {"ok": 1, "members": []}
        if name == "insert":
            return self._insert(db, cmd)
        if name == "update":
            return self._update(db, cmd)
        if name == "find":
            return self._find(db, cmd)
        if name == "findAndModify":
            return self._find_and_modify(db, cmd)
        return {"ok": 0, "errmsg": f"no such command: '{name}'",
                "code": 59}

    def _find_and_modify(self, db: str, cmd: dict) -> dict:
        """Only the remove-oldest shape the logger workload uses
        (mongodb_rocks.clj:113-121: sort + remove=true)."""
        key = f"{db}.{cmd['findAndModify']}"
        q = cmd.get("query") or {}
        sort = cmd.get("sort") or {}
        if not cmd.get("remove"):
            return {"ok": 0, "errmsg": "only remove supported"}

        def fam(data):
            colls = dict(data.get("colls") or {})
            coll = list(colls.get(key) or [])
            hits = [d for d in coll if _matches(d, q)]
            if sort:
                field, direction = next(iter(sort.items()))
                # docs missing the sort field order last regardless
                # of direction (so they are never the victim while a
                # sortable doc exists)
                present = [d for d in hits if d.get(field) is not None]
                absent = [d for d in hits if d.get(field) is None]
                present.sort(key=lambda d: d[field],
                             reverse=direction < 0)
                hits = present + absent
            if not hits:
                return {"ok": 1, "value": None}, None
            victim = hits[0]
            coll.remove(victim)
            colls[key] = coll
            new = dict(data)
            new["colls"] = colls
            return {"ok": 1, "value": victim}, new

        return self.store.transact(fam)

    def _insert(self, db: str, cmd: dict) -> dict:
        key = f"{db}.{cmd['insert']}"
        docs = cmd["documents"]

        def ins(data):
            colls = dict(data.get("colls") or {})
            coll = list(colls.get(key) or [])
            for d in docs:
                if "_id" in d and any(
                        x.get("_id") == d["_id"] for x in coll):
                    return {"ok": 1, "n": 0, "writeErrors": [
                        {"code": 11000,
                         "errmsg": "E11000 duplicate key error"}]}, None
                coll.append(d)
            colls[key] = coll
            new = dict(data)
            new["colls"] = colls
            return {"ok": 1, "n": len(docs)}, new

        return self.store.transact(ins)

    def _update(self, db: str, cmd: dict) -> dict:
        key = f"{db}.{cmd['update']}"
        spec = cmd["updates"][0]
        q, u, upsert = spec["q"], spec["u"], spec.get("upsert", False)

        def upd(data):
            colls = dict(data.get("colls") or {})
            coll = list(colls.get(key) or [])
            n = 0
            for i, doc in enumerate(coll):
                if _matches(doc, q):
                    replacement = dict(u)
                    if "_id" in doc and "_id" not in replacement:
                        replacement["_id"] = doc["_id"]
                    coll[i] = replacement
                    n += 1
                    break  # multi:false semantics
            upserted = 0
            if n == 0 and upsert:
                coll.append(dict(u))
                upserted = 1
            colls[key] = coll
            new = dict(data)
            new["colls"] = colls
            return ({"ok": 1, "n": n + upserted,
                     "nModified": n}, new if (n or upserted) else None)

        return self.store.transact(upd)

    def _find(self, db: str, cmd: dict) -> dict:
        key = f"{db}.{cmd['find']}"
        q = cmd.get("filter") or {}
        limit = cmd.get("limit") or 0

        def rd(data):
            coll = (data.get("colls") or {}).get(key) or []
            out = [d for d in coll if _matches(d, q)]
            if limit:
                out = out[:limit]
            return out, None

        batch = self.store.transact(rd)
        return {"ok": 1, "cursor": {"id": 0, "ns": key,
                                    "firstBatch": batch}}


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="mongodb OP_MSG sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=27017)
    p.add_argument("--name", default="sim")
    # mongod flags tolerated:
    p.add_argument("--replSet", default=None)
    p.add_argument("--dbpath", default=None)
    p.add_argument("--storageEngine", default=None)
    p.add_argument("--bind_ip", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server(("127.0.0.1", args.port), Handler)
    print(f"mongo-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.mongo_sim", "mongod", "mongod-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the mongodb suites against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under
    "mongodb")."""
    return sim_cluster(root, nodes, ports, "mongodb", "mongod-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `mongodb.mongodb_test` on a `local_cluster` (`simbase.sim_test_fn`):
    --workload and --flavor come from the command line; the suite's
    nemesis (or a composed package) on the no-op network; start-stop's
    `killall mongod` finds no process (the members are Python
    processes); a composed package's clock faults go to
    `etcd_sim.recording_clock` (cluster["clock_sets"]); fs-break
    refused."""
    from .etcd_sim import recording_clock

    def make(opts):
        from . import mongodb

        return mongodb.mongodb_test(opts)

    return sim_test_fn(cluster, "mongodb", make, {
        "set_time_fn": recording_clock(cluster.setdefault("clock_sets",
                                                          []))})


if __name__ == "__main__":
    serve()
