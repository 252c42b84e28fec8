"""CrateDB test suite: optimistic-concurrency workloads over the HTTP
_sql endpoint using Crate's implicit `_version` MVCC column (reference:
crate/src/jepsen/crate/{core,lost_updates,
version_divergence}.clj — the reference drives Crate's shaded-postgres
JDBC; this speaks the HTTP _sql API, Crate's other first-class client
surface).

Workloads:
  - version-divergence: registers read as (value, _version); the
    multiversion checker demands every _version maps to exactly ONE
    value across all reads (version_divergence.clj:98-115)
  - lost-updates: per-key element sets grown by read + write-back
    guarded by `where _version = ?` — a lost update drops an
    acknowledged element (lost_updates.clj:1-148)

The hermetic backend is crate_sim: the shared mini SQL engine behind a
tiny HTTP _sql wrapper, with `_version` managed by the engine.

The port's copy of `jepsen_tpu/dbs/crate.py`: every workload is checked
on the host (the multiversion checker, elasticsearch's dirty-read
checker, and the set checker a key) and reaches no kernel; it takes the
dirty-read workload's checker and generator from the port's own
`elasticsearch`. `crate_sim.local_test_fn` runs the suite on simulated
nodes over `LocalRemote`.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import socket
import urllib.error
import urllib.request

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, generator as gen, independent
from .. import osdist
from ..checker import Checker
from ..history import Op, ops as _ops
from .common import ArchiveDB, SuiteCfg, ready_gated_final, \
    once as _once, shared_flag as _shared_flag
# shared with the elasticsearch suite — identical workload shape and
# anomaly definition (no circular import: elasticsearch doesn't import
# crate)
from .elasticsearch import DirtyReadChecker as _EsDirtyReadChecker
from .elasticsearch import dirty_rw_gen as _es_dirty_rw_gen

log = logging.getLogger("jepsen_tpu_torch.dbs.crate")

PORT = 4200
RETRIES = 16


_suite = SuiteCfg("crate", PORT, "/opt/crate")
node_host = _suite.host
node_port = _suite.port


class CrateDB(ArchiveDB):
    """Tarball install + daemon (crate/core.clj:278-336). Daemon args
    use real CrateDB's -C settings syntax (the sim accepts them too)."""

    binary = "crate"
    log_name = "crate.log"
    pid_name = "crate.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        return [f"-Chttp.port={node_port(test, node)}",
                f"-Cnode.name={node}",
                "-Cnetwork.host=0.0.0.0"]

    def probe_ready(self, test, node) -> bool:
        conn = CrateConn(node_host(test, node), node_port(test, node),
                         timeout=2.0)
        try:
            conn.sql("select 1")
            return True
        except CrateError:
            return False


class CrateError(Exception):
    def __init__(self, message: str, code: int | None = None):
        super().__init__(message)
        self.code = code


class CrateConn:
    """HTTP _sql endpoint: POST {"stmt": ...} -> {cols, rows,
    rowcount}."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.base = f"http://{host}:{port}/_sql"
        self.timeout = timeout

    def sql(self, stmt: str) -> dict:
        req = urllib.request.Request(
            self.base, data=json.dumps({"stmt": stmt}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError as e:
            try:
                body = json.load(e)
            except (json.JSONDecodeError, ValueError):
                raise CrateError(f"HTTP {e.code}") from e
            err = body.get("error") or {}
            raise CrateError(err.get("message", str(body)),
                             err.get("code")) from e


def _ensure_version_column(conn, table: str) -> None:
    """Real CrateDB has an implicit _version system column on every
    table; the sim's engine materializes one on request. Best-effort:
    real Crate rejects the alter, which is fine."""
    try:
        conn.sql(f"alter table {table} add _version")
    except CrateError:
        pass


class VersionRegisterClient(client.Client):
    """Registers read with their _version (version_divergence.clj:
    50-92): read → (value, _version) tuple per key; write → upsert."""

    def __init__(self, conn=None, flag=None):
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        conn = CrateConn(node_host(test, node), node_port(test, node))
        me = VersionRegisterClient(conn, self.flag)

        def create():
            conn.sql("drop table if exists registers")
            conn.sql("create table registers (id int primary key, "
                     "value int)")
            _ensure_version_column(conn, "registers")

        _once(self.flag, create)
        return me

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        try:
            if op.f == "read":
                res = self.conn.sql(
                    f"select value, _version from registers where id = {k}")
                if not res["rows"]:
                    return op.with_(
                        type="ok",
                        value=independent.tuple_(k, (None, None)))
                value, version = res["rows"][0]
                return op.with_(
                    type="ok",
                    value=independent.tuple_(
                        k, (int(value) if value is not None else None,
                            int(version))))
            if op.f == "write":
                n = self.conn.sql(
                    f"update registers set value = {v} where id = {k}"
                )["rowcount"]
                if n == 0:
                    try:
                        self.conn.sql(
                            f"insert into registers (id, value) "
                            f"values ({k}, {v})")
                    except CrateError as e:
                        if "duplicate" not in str(e).lower():
                            raise
                        self.conn.sql(
                            f"update registers set value = {v} "
                            f"where id = {k}")
                return op.with_(type="ok")
            raise ValueError(f"unknown op {op.f!r}")
        except CrateError as e:
            if "no master" in str(e):
                return op.with_(type="fail", error="no-master")
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))
        except (socket.timeout, TimeoutError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        pass


class MultiversionChecker(Checker):
    """Every observed _version must map to exactly one value
    (version_divergence.clj:94-115)."""

    def check(self, test, history, opts=None) -> dict:
        by_version: dict = {}
        for o in _ops(history):
            if not (o.is_ok and o.f == "read"):
                continue
            k, (value, version) = o.value
            if version is None:
                continue
            by_version.setdefault((k, version), set()).add(value)
        multis = {str(kv): sorted(vs, key=str)
                  for kv, vs in by_version.items() if len(vs) > 1}
        return {"valid": not multis, "multis": multis}


class LostUpdatesClient(client.Client):
    """Per-key element sets stored as comma-joined strings, grown with
    an optimistic `where _version = ?` write-back loop
    (lost_updates.clj:32-120). Version conflicts retry; exhausting
    retries is a definite :fail."""

    def __init__(self, conn=None, flag=None):
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        conn = CrateConn(node_host(test, node), node_port(test, node))
        me = LostUpdatesClient(conn, self.flag)

        def create():
            conn.sql("drop table if exists sets")
            conn.sql("create table sets (id int primary key, "
                     "elements string)")
            _ensure_version_column(conn, "sets")

        _once(self.flag, create)
        return me

    def invoke(self, test, op: Op) -> Op:
        k, v = op.value
        try:
            if op.f == "add":
                for _ in range(RETRIES):
                    res = self.conn.sql(
                        f"select elements, _version from sets "
                        f"where id = {k}")
                    if not res["rows"]:
                        try:
                            self.conn.sql(
                                f"insert into sets (id, elements) "
                                f"values ({k}, '{v}')")
                            return op.with_(type="ok")
                        except CrateError as e:
                            if "duplicate" in str(e).lower():
                                continue  # raced the insert; retry
                            raise
                    elements, version = res["rows"][0]
                    new = f"{elements},{v}" if elements else str(v)
                    n = self.conn.sql(
                        f"update sets set elements = '{new}' "
                        f"where id = {k} and _version = {int(version)}"
                    )["rowcount"]
                    if n == 1:
                        return op.with_(type="ok")
                return op.with_(type="fail", error="retries-exhausted")
            if op.f == "read":
                res = self.conn.sql(
                    f"select elements from sets where id = {k}")
                elements = (res["rows"][0][0] or "") if res["rows"] else ""
                values = sorted(int(x) for x in elements.split(",") if x)
                return op.with_(type="ok",
                                value=independent.tuple_(k, values))
            raise ValueError(f"unknown op {op.f!r}")
        except CrateError as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))
        except (socket.timeout, TimeoutError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        pass


class DirtyReadClient(client.Client):
    """crate/dirty_read.clj:40-95: writes insert ids; reads probe a
    specific id (:ok iff present); refresh flushes the table; the
    strong read selects every id. Checked with the shared dirty-read
    set algebra (same anomaly family as the elasticsearch workload)."""

    def __init__(self, conn=None, flag=None):
        self.conn = conn
        self.flag = flag or _shared_flag()

    def open(self, test, node):
        conn = CrateConn(node_host(test, node), node_port(test, node))
        me = DirtyReadClient(conn, self.flag)

        def create():
            conn.sql("drop table if exists dirty_read")
            conn.sql("create table dirty_read (id int primary key)")

        _once(self.flag, create)
        return me

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                self.conn.sql(
                    f"insert into dirty_read (id) values ({op.value})")
                return op.with_(type="ok")
            if op.f == "read":
                rows = self.conn.sql(
                    f"select id from dirty_read where id = {op.value}"
                )["rows"]
                return op.with_(type="ok" if rows else "fail")
            if op.f == "refresh":
                try:
                    self.conn.sql("refresh table dirty_read")
                except CrateError as e:
                    # the sim's engine doesn't know the statement (no
                    # refresh lag there); any OTHER failure is real and
                    # must not masquerade as a successful refresh
                    if "can't parse statement" not in str(e):
                        return op.with_(type="fail", error=str(e))
                return op.with_(type="ok")
            if op.f == "strong-read":
                ids = sorted(int(r[0]) for r in self.conn.sql(
                    "select id from dirty_read")["rows"])
                return op.with_(type="ok", value=ids)
            raise ValueError(f"unknown op {op.f!r}")
        except (CrateError, socket.timeout, TimeoutError, OSError) as e:
            crash = "info" if op.f == "write" else "fail"
            return op.with_(type=crash, error=str(e))

    def close(self, test):
        pass


def workloads(opts: dict | None = None) -> dict:

    opts = opts or {}
    n_keys = opts.get("keys", 4)
    ops_per_key = opts.get("ops_per_key", 30)

    def vd_r(test, process):
        return {"type": "invoke", "f": "read", "value": None}

    def vd_w(test, process):
        return {"type": "invoke", "f": "write", "value": random.randrange(5)}

    counter = itertools.count()

    return {
        "version-divergence": {
            "client": VersionRegisterClient(),
            "during": independent.concurrent_generator(
                2, itertools.count(),
                lambda k: gen.limit(40, gen.stagger(
                    0.05, gen.mix([vd_r, vd_w])))),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "multiversion": MultiversionChecker(),
            }),
        },
        "dirty-read": {
            "client": DirtyReadClient(),
            "during": gen.stagger(
                0.02, _es_dirty_rw_gen()),
            "final": gen.each(lambda: gen.seq([
                gen.once({"type": "invoke", "f": "refresh"}),
                gen.once({"type": "invoke", "f": "strong-read"}),
            ])),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "dirty-read": _EsDirtyReadChecker(),
            }),
        },
        "lost-updates": {
            "client": LostUpdatesClient(),
            # a FIXED key set so the final phase can read every key
            "during": independent.concurrent_generator(
                2, iter(range(n_keys)),
                lambda k: gen.limit(
                    ops_per_key,
                    gen.stagger(
                        0.05,
                        lambda t, p: {"type": "invoke", "f": "add",
                                      "value": next(counter)}))),
            "final": gen.seq([
                {"type": "invoke", "f": "read",
                 "value": independent.tuple_(k, None)}
                for k in range(n_keys)
            ]),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "sets": independent.checker(checker_mod.set_checker()),
            }),
        },
    }


def crate_test(opts: dict) -> dict:
    from ..testlib import noop_test

    wl = workloads(opts)[opts.get("workload", "version-divergence")]
    db_ = CrateDB(archive_url=opts.get("archive_url"))
    generator = gen.time_limit(
        opts.get("time_limit", 60),
        gen.nemesis(gen.start_stop(10, 10), wl["during"]),
    )
    if wl.get("final") is not None:
        generator = gen.phases(
            generator,
            gen.nemesis(gen.once({"type": "info", "f": "stop"})),
            gen.sleep(opts.get("quiesce", 10)),
            ready_gated_final(db_, gen.clients(wl["final"]), opts),
        )
    test = noop_test()
    test.update(opts)
    test.update(
        {
            "name": f"crate {opts.get('workload', 'version-divergence')}",
            "os": osdist.debian,
            "db": db_,
            "client": wl["client"],
            "nemesis": cmn.pick_nemesis(db_, opts),
            "generator": generator,
            "checker": wl["checker"],
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--workload", default="version-divergence",
                   choices=sorted(workloads().keys()))
    p.add_argument("--archive-url", dest="archive_url", default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(crate_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
