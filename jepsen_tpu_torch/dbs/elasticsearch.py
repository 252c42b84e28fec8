"""Elasticsearch test suite: version-CAS register and set workloads
over the REST API (reference:
elasticsearch/src/jepsen/elasticsearch/{core,sets}.clj
— the reference drives the Java TransportClient; this speaks REST,
which covers the same index/get/search/versioning semantics).

Workloads:
  - register: a document whose _version drives CAS (core.clj's
    cas-set-client shape) — read = GET, write = unconditional index,
    cas = GET then index with ?version
  - set: op_type=create documents, final read = _refresh + _search
    (sets.clj:50-87) — catches ES's near-real-time search losing
    acknowledged writes
  - dirty-read: dirty_read.clj's reads of in-flight ids against one
    strong read a client

The port's copy of `jepsen_tpu/dbs/elasticsearch.py`. The register's
checker is `linearizable` on the one unkeyed CAS-register history,
which `auto` routes to K1 (`ops/csrc/wgl_vec.cu`, up to 1,024 entries)
or K5 (`ops/csrc/wgl_row.cu`), or to the native search below the
committed bars; the test map's `device` (the CLI's `--device`; None =
the card) goes to that checker. set and dirty-read reach only host
checkers. `es_sim.local_test_fn` runs the suite on simulated nodes
over `LocalRemote`.
"""

from __future__ import annotations

import itertools
import json
import logging
import random
import socket
import urllib.error
import urllib.parse
import urllib.request

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, generator as gen, models, osdist
from ..history import Op
from .common import ArchiveDB, SuiteCfg, ready_gated_final

log = logging.getLogger("jepsen_tpu_torch.dbs.elasticsearch")

PORT = 9200
INDEX = "jepsen"
DOC_TYPE = "register"
REG_ID = "0"


_suite = SuiteCfg("elasticsearch", PORT, "/opt/elasticsearch")
node_host = _suite.host
node_port = _suite.port


class EsDB(ArchiveDB):
    """Tarball install + daemon (core.clj:212-296). Daemon args use
    real Elasticsearch's -E settings syntax (the sim accepts them
    too)."""

    binary = "elasticsearch"
    log_name = "es.log"
    pid_name = "es.pid"

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    def daemon_args(self, test, node) -> list:
        return ["-E", f"http.port={node_port(test, node)}",
                "-E", f"node.name={node}"]

    def probe_ready(self, test, node) -> bool:
        url = (f"http://{node_host(test, node)}:{node_port(test, node)}"
               "/_cluster/health")
        with urllib.request.urlopen(url, timeout=2) as resp:
            return resp.status == 200


class EsConn:
    """One node's REST endpoint."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.base = f"http://{host}:{port}"
        self.timeout = timeout

    def request(self, method: str, path: str, body=None, query=None):
        url = self.base + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if data:
            req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.load(resp)

    def get_doc(self, doc_id: str):
        """(source, version) or (None, 0)."""
        try:
            body = self.request("GET",
                                f"/{INDEX}/{DOC_TYPE}/{doc_id}")
            return body["_source"], int(body["_version"])
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None, 0
            raise

    def index_doc(self, doc_id: str, source: dict, version=None,
                  create=False) -> bool:
        """True on success, False on version conflict (409)."""
        query = {}
        if version is not None:
            query["version"] = version
        if create:
            query["op_type"] = "create"
        try:
            self.request("PUT", f"/{INDEX}/{DOC_TYPE}/{doc_id}",
                         body=source, query=query or None)
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return False
            raise

    def refresh(self) -> None:
        self.request("POST", f"/{INDEX}/_refresh")

    def search_all(self, page_size: int = 10000,
                   sort_field: str | None = None) -> list:
        """Every document. With sort_field (an INDEXED source field —
        real Elasticsearch rejects sorting on _id), results paginate
        via search_after so >10k-doc indexes aren't silently truncated;
        without one, a single size-capped request is issued (the set
        workload's scale)."""
        if sort_field is None:
            resp = self.request("POST", f"/{INDEX}/_search",
                                body={"query": {"match_all": {}},
                                      "size": page_size})
            return [h["_source"] for h in resp["hits"]["hits"]]
        out = []
        after = None
        while True:
            body = {"query": {"match_all": {}}, "size": page_size,
                    "sort": [{sort_field: "asc"}]}
            if after is not None:
                body["search_after"] = [after]
            resp = self.request("POST", f"/{INDEX}/_search", body=body)
            hits = resp["hits"]["hits"]
            out.extend(h["_source"] for h in hits)
            if len(hits) < page_size:
                return out
            last = hits[-1]["_source"].get(sort_field)
            if last is None or last == after:
                return out  # server ignored the cursor: stop honestly
            after = last


class RegisterClient(client.Client):
    """Version-CAS register in one document. Reads :fail on error;
    writes/cas crash to :info; a 409 conflict is a definite :fail."""

    def __init__(self, conn: EsConn | None = None, timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        return RegisterClient(
            EsConn(node_host(test, node), node_port(test, node),
                   timeout=self.timeout), timeout=self.timeout)

    def invoke(self, test, op: Op) -> Op:
        crash = "fail" if op.f == "read" else "info"
        try:
            if op.f == "read":
                source, _ = self.conn.get_doc(REG_ID)
                value = source["value"] if source else None
                return op.with_(type="ok", value=value)
            if op.f == "write":
                self.conn.index_doc(REG_ID, {"value": op.value})
                return op.with_(type="ok")
            if op.f == "cas":
                old, new = op.value
                source, version = self.conn.get_doc(REG_ID)
                if source is None or source["value"] != old:
                    return op.with_(type="fail")
                ok = self.conn.index_doc(REG_ID, {"value": new},
                                         version=version)
                return op.with_(type="ok" if ok else "fail")
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            return op.with_(type=crash, error="timeout")
        except (urllib.error.URLError, OSError) as e:
            return op.with_(type=crash, error=str(e))


class SetClient(client.Client):
    """op_type=create documents; final read refreshes then searches
    (sets.clj:50-87). An indeterminate add is :info — the document may
    have been indexed."""

    def __init__(self, conn: EsConn | None = None, timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        return SetClient(
            EsConn(node_host(test, node), node_port(test, node),
                   timeout=self.timeout), timeout=self.timeout)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add":
                ok = self.conn.index_doc(str(op.value),
                                         {"num": op.value}, create=True)
                return op.with_(type="ok" if ok else "fail")
            if op.f == "read":
                self.conn.refresh()
                values = sorted(
                    d["num"] for d in
                    self.conn.search_all(sort_field="num")
                    if "num" in d)
                return op.with_(type="ok", value=values)
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error="timeout")
        except (urllib.error.URLError, OSError) as e:
            crash = "fail" if op.f == "read" else "info"
            return op.with_(type=crash, error=str(e))


class DirtyReadClient(client.Client):
    """dirty_read.clj:32-104: writers index docs by id; readers GET
    in-flight ids (:ok when found); the final phase refreshes and does
    one strong read (search-all) per client. A read that shows a value
    absent from EVERY strong read observed a write that never
    committed."""

    def __init__(self, conn: EsConn | None = None, timeout: float = 5.0):
        self.conn = conn
        self.timeout = timeout

    def open(self, test, node):
        return DirtyReadClient(
            EsConn(node_host(test, node), node_port(test, node),
                   timeout=self.timeout), timeout=self.timeout)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "write":
                self.conn.index_doc(str(op.value), {"id": op.value})
                return op.with_(type="ok")
            if op.f == "read":
                source, _ = self.conn.get_doc(str(op.value))
                return op.with_(type="ok" if source else "fail")
            if op.f == "refresh":
                self.conn.refresh()
                return op.with_(type="ok")
            if op.f == "strong-read":
                ids = sorted(d["id"] for d in
                             self.conn.search_all(sort_field="id")
                             if "id" in d)
                return op.with_(type="ok", value=ids)
            raise ValueError(f"unknown op {op.f!r}")
        except (socket.timeout, TimeoutError):
            # reads/refresh/strong-read have no side effects: definite
            # :fail (the module-wide read convention); only writes are
            # indeterminate
            crash = "info" if op.f == "write" else "fail"
            return op.with_(type=crash, error="timeout")
        except (urllib.error.URLError, OSError) as e:
            crash = "info" if op.f == "write" else "fail"
            return op.with_(type=crash, error=str(e))


class DirtyReadChecker(checker_mod.Checker):
    """dirty_read.clj:106-156: dirty = ok reads absent from every
    strong read (saw an uncommitted write); lost = ok writes absent
    from every strong read; nodes agree when all strong reads match."""

    def check(self, test, history, opts=None) -> dict:
        from ..history import ops as _ops

        writes, reads, strong = set(), set(), []
        strong_attempted = 0
        for o in _ops(history):
            if o.f == "strong-read" and o.is_invoke:
                strong_attempted += 1
            if not o.is_ok:
                continue
            if o.f == "write":
                writes.add(o.value)
            elif o.f == "read":
                reads.add(o.value)
            elif o.f == "strong-read":
                strong.append(set(o.value))
        if not strong or len(strong) < strong_attempted:
            # a node whose strong read never completed is exactly the
            # suspect node — partial coverage can't prove anything
            return {"valid": "unknown",
                    "error": f"only {len(strong)}/{strong_attempted} "
                             "strong reads completed"}
        on_all = set.intersection(*strong)
        on_some = set.union(*strong)
        dirty = reads - on_some
        lost = writes - on_some
        return {
            "valid": not dirty and not lost and on_all == on_some,
            "nodes_agree": on_all == on_some,
            "read_count": len(reads),
            "on_all_count": len(on_all),
            "on_some_count": len(on_some),
            "not_on_all": sorted(on_some - on_all)[:10],
            "dirty": sorted(dirty)[:10],
            "lost": sorted(lost)[:10],
            "some_lost": sorted(writes - on_all)[:10],
        }


def dirty_rw_gen():
    """Writers emit sequential ids; readers probe recently in-flight
    ids (dirty_read.clj:160-189)."""
    import collections
    import threading

    counter = itertools.count()
    recent: collections.deque = collections.deque(maxlen=32)
    lock = threading.Lock()

    def w(test, process):
        v = next(counter)
        with lock:
            recent.append(v)
        return {"type": "invoke", "f": "write", "value": v}

    def rd(test, process):
        with lock:
            v = random.choice(list(recent)) if recent else 0
        return {"type": "invoke", "f": "read", "value": v}

    return gen.mix([w, rd, rd])


def r(test, process):
    return {"type": "invoke", "f": "read", "value": None}


def w(test, process):
    return {"type": "invoke", "f": "write", "value": random.randrange(5)}


def cas(test, process):
    return {"type": "invoke", "f": "cas",
            "value": (random.randrange(5), random.randrange(5))}


def workloads(device=None) -> dict:
    """The suite's workloads; `device` goes to the register's
    linearizable checker (None = the card)."""
    return {
        "register": {
            "client": RegisterClient(),
            "during": gen.stagger(0.1, gen.mix([r, w, cas])),
            "model": models.CASRegister(),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "linear": checker_mod.linearizable(
                    device=device),
            }),
        },
        "dirty-read": {
            "client": DirtyReadClient(),
            "during": gen.stagger(0.02, dirty_rw_gen()),
            # es_test wraps finals in gen.clients (set-workload
            # convention)
            "final": gen.each(lambda: gen.seq([
                gen.once({"type": "invoke", "f": "refresh"}),
                gen.once({"type": "invoke", "f": "strong-read"}),
            ])),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "dirty-read": DirtyReadChecker(),
            }),
        },
        "set": {
            "client": SetClient(),
            "during": gen.stagger(
                0.05,
                gen.seq({"type": "invoke", "f": "add", "value": x}
                        for x in itertools.count()),
            ),
            "final": gen.each(
                lambda: gen.once({"type": "invoke", "f": "read"})),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "set": checker_mod.set_checker(),
            }),
        },
    }


def es_test(opts: dict) -> dict:
    from ..testlib import noop_test

    wl = workloads(opts.get("device"))[opts.get("workload", "register")]
    db_ = EsDB(archive_url=opts.get("archive_url"))
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
            "name": f"elasticsearch {opts.get('workload', 'register')}",
            "os": osdist.debian,
            "db": db_,
            "client": wl["client"],
            "nemesis": cmn.pick_nemesis(db_, opts),
            "model": wl.get("model"),
            "generator": generator,
            "checker": wl["checker"],
        }
    )
    return test


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p)
    p.add_argument("--workload", default="register",
                   choices=sorted(workloads().keys()))
    p.add_argument("--archive-url", dest="archive_url", default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(es_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
