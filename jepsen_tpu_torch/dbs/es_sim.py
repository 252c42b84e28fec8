"""A hermetic Elasticsearch lookalike: the REST subset the
elasticsearch suite drives — document PUT with internal version CAS
(?version=N → 409 on mismatch), op_type=create, GET by id, _refresh,
_search (match_all), and _cluster/health (reference behavior:
elasticsearch/src/jepsen/elasticsearch/{core,sets}.clj — the reference
uses the Java TransportClient; the suite here speaks REST, which is
what a TPU-era deployment would use anyway).

Shared flock-guarded JSON state across member processes. A "refresh
lag" knob (--refresh-lag) makes _search miss recent writes until
_refresh is called, reproducing ES's near-real-time search semantics
(the thing the sets test exists to catch).

The port's copy of `jepsen_tpu/dbs/es_sim.py`: it imports nothing of
`jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the elasticsearch suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    refresh_lag: bool = True
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _jitter(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))

    def _reply(self, status: int, body: dict):
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _parts(self):
        u = urllib.parse.urlparse(self.path)
        return [p for p in u.path.split("/") if p], \
            urllib.parse.parse_qs(u.query)

    def do_GET(self):
        self._jitter()
        parts, _q = self._parts()
        if parts[:2] == ["_cluster", "health"]:
            return self._reply(200, {"status": "green"})
        if len(parts) == 3:  # /{index}/{type}/{id}
            index, _type, doc_id = parts

            def read(data):
                docs = (data.get("indices") or {}).get(index) or {}
                return docs.get(doc_id), None

            doc = self.store.transact(read)
            if doc is None:
                return self._reply(
                    404, {"found": False, "_id": doc_id})
            return self._reply(200, {
                "found": True, "_id": doc_id,
                "_version": doc["version"], "_source": doc["source"],
            })
        self._reply(404, {"error": "no route"})

    def do_POST(self):
        self._jitter()
        parts, q = self._parts()
        if parts and parts[-1] == "_refresh":

            def refresh(data):
                new = dict(data)
                new["refreshed_at"] = int(data.get("seq") or 0)
                return None, new

            self.store.transact(refresh)
            return self._reply(200, {"_shards": {"failed": 0}})
        if parts and parts[-1] == "_search":
            index = parts[0] if len(parts) > 1 else None
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                body = {}
            if not isinstance(body, dict):
                body = {}

            def search(data):
                docs = (data.get("indices") or {}).get(index) or {}
                horizon = (int(data.get("refreshed_at") or 0)
                           if self.refresh_lag else float("inf"))
                hits = [
                    {"_id": i, "_source": d["source"],
                     "_version": d["version"]}
                    for i, d in docs.items()
                    if d["seq"] <= horizon
                ]
                sort = body.get("sort") or []
                field = None
                for entry in sort:
                    if isinstance(entry, dict) and entry:
                        field = next(iter(entry))
                        break
                if field:
                    def sort_key(h, field=field):
                        return (h["_source"].get(field)
                                if field != "_id" else str(h["_id"]))

                    hits.sort(key=lambda h: (sort_key(h) is None,
                                             sort_key(h)))
                    after = body.get("search_after")
                    if after:
                        hits = [h for h in hits
                                if sort_key(h) is not None
                                and sort_key(h) > after[0]]
                size = body.get("size")
                if isinstance(size, int) and size >= 0:
                    hits = hits[:size]
                return hits, None

            hits = self.store.transact(search)
            return self._reply(200, {
                "hits": {"total": len(hits), "hits": hits}})
        # POST /{index}/{type}/{id} is index-like too
        self._index_doc(parts, q)

    def do_PUT(self):
        self._jitter()
        parts, q = self._parts()
        self._index_doc(parts, q)

    def _index_doc(self, parts, q):
        if len(parts) != 3:
            return self._reply(400, {"error": "bad doc path"})
        index, _type, doc_id = parts
        length = int(self.headers.get("Content-Length") or 0)
        try:
            source = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._reply(400, {"error": "bad json"})
        want_version = q.get("version")
        create_only = q.get("op_type", [""])[0] == "create"

        def write(data):
            indices = dict(data.get("indices") or {})
            docs = dict(indices.get(index) or {})
            cur = docs.get(doc_id)
            if create_only and cur is not None:
                return (409, {"error": "version_conflict_engine_exception",
                              "reason": "document already exists"}), None
            if want_version is not None:
                want = int(want_version[0])
                if cur is None or cur["version"] != want:
                    return (409, {
                        "error": "version_conflict_engine_exception",
                        "reason": f"current version "
                                  f"[{cur['version'] if cur else 0}] is "
                                  f"different than the one provided "
                                  f"[{want}]"}), None
            seq = int(data.get("seq") or 0) + 1
            docs[doc_id] = {
                "source": source,
                "version": (cur["version"] + 1) if cur else 1,
                "seq": seq,
            }
            indices[index] = docs
            new = dict(data)
            new["indices"] = indices
            new["seq"] = seq
            return (200 if cur else 201, {
                "_id": doc_id, "_version": docs[doc_id]["version"],
                "result": "updated" if cur else "created"}), new

        status, body = self.store.transact(write)
        self._reply(status, body)


def parse_args(argv):
    p = argparse.ArgumentParser(description="elasticsearch REST sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=9200)
    p.add_argument("--name", default="sim")
    p.add_argument("--no-refresh-lag", action="store_true")
    # real elasticsearch's settings syntax: -E key=value (repeatable)
    p.add_argument("-E", action="append", default=[], dest="settings")
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    settings = dict(s.split("=", 1) for s in args.settings if "=" in s)
    port = int(settings.get("http.port", args.port))
    name = settings.get("node.name", args.name)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    Handler.refresh_lag = not args.no_refresh_lag
    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"es-sim {name} serving on {port}, data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.es_sim", "elasticsearch", "es-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the elasticsearch suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "elasticsearch")."""
    return sim_cluster(root, nodes, ports, "elasticsearch", "es-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `elasticsearch.es_test` on a `local_cluster` (`simbase.sim_test_fn`):
    the suite's nemesis on the no-op network, the dirty-read and set
    workloads' final reads behind their quiesce and readiness gate;
    fs-break refused."""
    def make(opts):
        from . import elasticsearch

        return elasticsearch.es_test(opts)

    return sim_test_fn(cluster, "elasticsearch", make)


if __name__ == "__main__":
    serve()
