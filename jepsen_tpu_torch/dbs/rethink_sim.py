"""A hermetic RethinkDB lookalike: the V0_4/JSON wire protocol plus a
mini ReQL interpreter covering the term trees the rethinkdb suite
issues — db/table create, get, insert (conflict=update|error), update
with a literal patch or a FUNC body (branch/eq/get_field/error — the
CAS shape), get_field with DEFAULT fallback. State lives in the shared
flock-guarded store as {dbs: {db: {tbl: {id: row}}}}.

The port's copy of `jepsen_tpu/dbs/rethink_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the rethinkdb suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import json
import random
import socketserver
import struct
import sys
import time

from . import rethink_proto as rp
from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn


class Abort(Exception):
    """r.error() raised inside an update function."""


class Interp:
    """Evaluate one query term against a state snapshot; mutations
    rewrite the snapshot in place and set self.dirty."""

    def __init__(self, data: dict):
        self.data = data
        self.dirty = False
        self.scope: dict = {}

    def _dbs(self):
        return self.data.setdefault("dbs", {})

    def eval(self, term):
        if not isinstance(term, list):
            if isinstance(term, dict):
                return {k: self.eval(v) for k, v in term.items()}
            return term
        ttype, args = term[0], term[1] if len(term) > 1 else []
        opts = term[2] if len(term) > 2 else {}
        fn = getattr(self, f"t_{ttype}", None)
        if fn is None:
            raise rp.ReqlError(rp.COMPILE_ERROR,
                               f"unsupported term {ttype}")
        return fn(args, opts)

    # -- structure --------------------------------------------------------

    def t_2(self, args, opts):  # MAKE_ARRAY
        return [self.eval(a) for a in args]

    def t_14(self, args, opts):  # DB
        return ("db", self.eval(args[0]))

    def t_57(self, args, opts):  # DB_CREATE
        name = self.eval(args[0])
        if name in self._dbs():
            raise rp.ReqlError(rp.RUNTIME_ERROR,
                               f"Database `{name}` already exists")
        self._dbs()[name] = {}
        self.dirty = True
        return {"dbs_created": 1}

    def t_60(self, args, opts):  # TABLE_CREATE
        _, dbname = self.eval(args[0])
        name = self.eval(args[1])
        tables = self._dbs().setdefault(dbname, {})
        if name in tables:
            raise rp.ReqlError(rp.RUNTIME_ERROR,
                               f"Table `{name}` already exists")
        tables[name] = {}
        self.dirty = True
        return {"tables_created": 1}

    def t_176(self, args, opts):  # RECONFIGURE
        """Topology change (rethinkdb.clj:180-194's r.reconfigure).
        The sim keeps the replica map as table metadata — data stays
        shared-store-global like a fully replicated table — and
        answers {reconfigured: 1} like a healthy cluster."""
        _, dbname, tname = self.eval(args[0])
        replicas = self.eval(opts.get("replicas") or {})
        primary = self.eval(opts.get("primary_replica_tag"))
        if primary is not None and replicas and primary not in replicas:
            raise rp.ReqlError(
                rp.RUNTIME_ERROR,
                f"Could not find any servers with server tag "
                f"`{primary}`")
        topo = self.data.setdefault("topology", {})
        topo[f"{dbname}.{tname}"] = {"shards": self.eval(
            opts.get("shards", 1)), "replicas": replicas,
            "primary": primary}
        self.dirty = True
        return {"reconfigured": 1}

    def t_15(self, args, opts):  # TABLE
        _, dbname = self.eval(args[0])
        name = self.eval(args[1])
        tbl = (self._dbs().get(dbname) or {}).get(name)
        if tbl is None:
            raise rp.ReqlError(rp.RUNTIME_ERROR,
                               f"Table `{dbname}.{name}` does not exist")
        return ("table", dbname, name)

    def t_16(self, args, opts):  # GET
        _, dbname, tname = self.eval(args[0])
        key = self.eval(args[1])
        return ("row", dbname, tname, key)

    # -- reads ------------------------------------------------------------

    def _row(self, sel):
        _, dbname, tname, key = sel
        return self._dbs()[dbname][tname].get(str(key))

    def t_31(self, args, opts):  # GET_FIELD
        target = self.eval(args[0])
        field = self.eval(args[1])
        if isinstance(target, tuple) and target[0] == "row":
            target = self._row(target)
        if target is None:
            raise rp.ReqlError(rp.RUNTIME_ERROR,
                               "Cannot perform get_field on a "
                               "non-object non-sequence `null`")
        if field not in target:
            raise rp.ReqlError(rp.RUNTIME_ERROR, f"No attribute `{field}`")
        return target[field]

    def t_92(self, args, opts):  # DEFAULT
        try:
            return self.eval(args[0])
        except rp.ReqlError:
            return self.eval(args[1])

    def t_17(self, args, opts):  # EQ
        return self.eval(args[0]) == self.eval(args[1])

    def t_12(self, args, opts):  # ERROR
        raise Abort(self.eval(args[0]))

    def t_65(self, args, opts):  # BRANCH
        if self.eval(args[0]):
            return self.eval(args[1])
        return self.eval(args[2])

    def t_10(self, args, opts):  # VAR
        return self.scope[self.eval(args[0])]

    # -- writes -----------------------------------------------------------

    def t_56(self, args, opts):  # INSERT
        _, dbname, tname = self.eval(args[0])
        doc = self.eval(args[1])
        tbl = self._dbs()[dbname][tname]
        key = str(doc["id"])
        conflict = opts.get("conflict", "error")
        if key in tbl:
            if conflict == "update":
                tbl[key] = {**tbl[key], **doc}
                self.dirty = True
                return {"inserted": 0, "replaced": 1, "errors": 0}
            return {"inserted": 0, "errors": 1,
                    "first_error": "Duplicate primary key"}
        tbl[key] = doc
        self.dirty = True
        return {"inserted": 1, "replaced": 0, "errors": 0}

    def t_53(self, args, opts):  # UPDATE
        sel = self.eval(args[0])
        patch = args[1]
        rows = []
        if isinstance(sel, tuple) and sel[0] == "row":
            _, dbname, tname, key = sel
            row = self._dbs()[dbname][tname].get(str(key))
            if row is not None:
                rows = [(str(key), row)]
            tbl = self._dbs()[dbname][tname]
        elif isinstance(sel, tuple) and sel[0] == "table":
            _, dbname, tname = sel
            tbl = self._dbs()[dbname][tname]
            rows = list(tbl.items())
        else:
            raise rp.ReqlError(rp.RUNTIME_ERROR, "can't update that")
        replaced = 0
        errors = 0
        first_error = None
        for key, row in rows:
            try:
                if (isinstance(patch, list) and patch
                        and patch[0] == rp.FUNC):
                    params = self.eval(patch[1][0])
                    self.scope[params[0]] = row
                    delta = self.eval(patch[1][1])
                else:
                    delta = self.eval(patch)
                new = {**row, **delta}
                if new != row:
                    tbl[key] = new
                    self.dirty = True
                    replaced += 1
            except Abort as e:
                errors += 1
                first_error = str(e)
        out = {"replaced": replaced, "errors": errors, "unchanged":
               len(rows) - replaced - errors, "skipped": 0}
        if first_error:
            out["first_error"] = first_error
        return out


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
            (magic,) = struct.unpack("<I", self._read_exact(4))
            if magic != rp.V0_4:
                self.request.sendall(b"ERROR: bad magic\x00")
                return
            (key_len,) = struct.unpack("<I", self._read_exact(4))
            self._read_exact(key_len)  # auth key accepted
            self._read_exact(4)        # protocol magic
            self.request.sendall(b"SUCCESS\x00")
            while True:
                token = struct.unpack("<q", self._read_exact(8))[0]
                (length,) = struct.unpack("<I", self._read_exact(4))
                qtype, term, _opts = json.loads(self._read_exact(length))
                if self.mean_latency > 0:
                    time.sleep(random.expovariate(1.0 / self.mean_latency))
                if qtype != rp.START:
                    self._reply(token, rp.CLIENT_ERROR,
                                [f"unsupported query type {qtype}"])
                    continue

                def run(data):
                    interp = Interp(data)
                    try:
                        out = interp.eval(term)
                        return (rp.SUCCESS_ATOM, out), \
                            (data if interp.dirty else None)
                    except rp.ReqlError as e:
                        return (e.rtype, str(e)), None
                    except Abort as e:
                        return (rp.RUNTIME_ERROR, str(e)), None

                rtype, payload = self.store.transact(run)
                self._reply(token, rtype, [payload])
        except (ConnectionError, TimeoutError, OSError,
                json.JSONDecodeError):
            return

    def _reply(self, token: int, rtype: int, r: list) -> None:
        body = json.dumps({"t": rtype, "r": r}).encode()
        self.request.sendall(struct.pack("<q", token)
                             + struct.pack("<I", len(body)) + body)


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def parse_args(argv):
    p = argparse.ArgumentParser(description="rethinkdb ReQL sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=28015)
    p.add_argument("--name", default="sim")
    # rethinkdb launcher flags tolerated:
    p.add_argument("--driver-port", dest="driver_port", type=int,
                   default=None)
    p.add_argument("--join", default=None)
    p.add_argument("--directory", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    port = args.driver_port or args.port
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    srv = Server(("127.0.0.1", port), Handler)
    print(f"rethink-sim {args.name} serving on {port}, data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.rethink_sim", "rethinkdb", "rethinkdb-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the rethinkdb suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "rethinkdb")."""
    return sim_cluster(root, nodes, ports, "rethinkdb", "rethinkdb-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `rethinkdb.rethinkdb_test` on a `local_cluster`
    (`simbase.sim_test_fn`): the suite's nemesis on the no-op network, so
    the reconfigure workload keeps `ReconfigureNemesis` (its topology
    changes reach the simulators) beside partitions that are recorded and
    healed; fs-break refused."""
    def make(opts):
        from . import rethinkdb

        return rethinkdb.rethinkdb_test(opts)

    return sim_test_fn(cluster, "rethinkdb", make)


if __name__ == "__main__":
    serve()
