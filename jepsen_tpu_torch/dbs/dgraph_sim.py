"""A hermetic Dgraph lookalike: the HTTP API subset the dgraph suite
drives — /alter (schema accepted), /mutate with set/delete JSON and
optional upsert query+cond, /query with a tiny DQL subset (func:
has(pred) | eq(pred, val), fields uid + predicates), /commit, /health,
and /state (zero's group/tablet map, for the tablet-mover nemesis).

Storage is MVCC over the shared flock store, reproducing dgraph's
transaction model (reference client:
dgraph/src/jepsen/dgraph/client.clj:66-103):

- every node is a VERSION CHAIN [[commit_ts, preds-or-None], ...];
- a transaction's first request is assigned a start_ts and reads the
  snapshot as of that ts (snapshot isolation — reads may be stale but
  are internally consistent);
- /mutate?startTs=N&commitNow=false stages writes in the txn record;
- /commit?startTs=N detects write-write conflicts via CONFLICT KEYS —
  one per written uid plus one per written (predicate, value) pair,
  which is how dgraph's @upsert index directive turns concurrent
  insert-if-absent races into aborts — and answers HTTP 409
  "Transaction has been aborted. Please retry." like the real server;
- /mutate without startTs (or with commitNow=true) is a one-shot
  atomic transaction, preserving the non-transactional clients.

The port's copy of `jepsen_tpu/dbs/dgraph_sim.py`: it imports nothing of
`jepsen_tpu`, and adds the recipe that runs the dgraph suite on
simulated nodes on this machine (`local_cluster`, `local_test_fn`).
"""

from __future__ import annotations

import argparse
import json
import random
import re
import sys
import time
import urllib.parse
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import (RecordingClockTools, Store, build_sim_archive,
                      sim_cluster, sim_test_fn)

ABORTED = "Transaction has been aborted. Please retry."


def parse_func(query: str) -> tuple:
    """(func_name, pred, value|None, fields) from the one-block DQL
    shape `{ q(func: eq(value, 5)) { uid value } }`."""
    m = re.search(
        r"func:\s*(\w+)\s*\(\s*(\w+)\s*(?:,\s*([^)\s]+))?\s*\)", query)
    if not m:
        raise ValueError(f"can't parse query func: {query!r}")
    fm = re.search(r"\)\s*\)?\s*\{([^}]*)\}", query)
    fields = fm.group(1).split() if fm else ["uid"]
    value = m.group(3)
    if value is not None:
        value = value.strip("\"'")
        try:
            value = int(value)
        except ValueError:
            pass
    return m.group(1), m.group(2), value, fields


def snapshot(data: dict, ts: int, overlay: dict | None = None) -> dict:
    """Materialize {uid: preds} as of commit-ts <= ts, with a txn's own
    staged writes overlaid (None = staged delete)."""
    view = {}
    for uid, chain in (data.get("nodes") or {}).items():
        preds = None
        for cts, p in chain:
            if cts <= ts:
                preds = p
            else:
                break
        if preds is not None:
            view[uid] = preds
    for uid, preds in (overlay or {}).items():
        if preds is None:
            view.pop(uid, None)
        else:
            view[uid] = preds
    return view


def run_query(view: dict, query: str) -> list:
    func, pred, value, fields = parse_func(query)
    out = []
    for uid, preds in view.items():
        if func == "has" and pred not in preds:
            continue
        if func == "eq" and preds.get(pred) != value:
            continue
        # uid(0x..) is single-argument: the uid lands in the pred slot
        if func == "uid" and uid != pred:
            continue
        row = {}
        for f in fields:
            if f == "uid":
                row["uid"] = uid
            elif f in preds:
                row[f] = preds[f]
        out.append(row)
    return out


INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


def json_number(v):
    """Dgraph's HTTP surface decodes JSON numbers the way Go's
    encoding/json does — through float64 — so integers beyond 2^53
    lose precision, and values whose float64 image falls outside int64
    convert the way amd64's cvttsd2si does: to INT64_MIN (the x86
    "integer indefinite"), NOT a clip to the nearest bound. Clipping
    would make exactly 2^63-1 round-trip cleanly (float rounds it up
    to 2^63, the clip brings it back) and hide the anomaly at the one
    boundary the dgraph `types` workload most wants to probe
    (types.clj:1-2)."""
    if isinstance(v, bool) or not isinstance(v, int):
        return v
    if -(1 << 53) <= v <= (1 << 53):
        return v
    as_float = float(v)
    if as_float >= float(1 << 63) or as_float < float(INT64_MIN):
        return INT64_MIN
    return int(as_float)


def conflict_keys(touched: dict, upsert_preds: set) -> list:
    """Conflict keys for a txn's EXPLICITLY-written triples: one per
    touched uid, plus one per (pred, value) pair whose predicate has
    the @upsert index directive — dgraph only materializes index-level
    conflicts for @upsert predicates, which is what turns concurrent
    insert-if-absent races into aborts without making every shared
    value a false conflict."""
    keys = []
    for uid, preds in touched.items():
        keys.append(f"u:{uid}")
        for p, v in (preds or {}).items():
            if p in upsert_preds:
                keys.append(f"pv:{p}={v!r}")
    return keys


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _reply(self, status: int, body: dict) -> None:
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        path = urllib.parse.urlparse(self.path).path
        if path == "/health":
            return self._reply(200, {"status": "healthy"})
        if path == "/state":
            # Zero's state: every predicate seen so far, assigned to
            # one of two groups by hash — enough surface for the
            # tablet-mover nemesis (dgraph/nemesis.clj:50-86).
            def rd(data):
                preds = set()
                for chain in (data.get("nodes") or {}).values():
                    for _, p in chain:
                        preds.update((p or {}).keys())
                moved = data.get("tablet_groups") or {}
                groups: dict = {"1": {"tablets": {}}, "2": {"tablets": {}}}
                for p in sorted(preds):
                    # Stable across processes and runs (hash() is
                    # PYTHONHASHSEED-randomized; the sim must be
                    # deterministic for every node process).
                    g = moved.get(p) or str(
                        1 + (zlib.crc32(p.encode()) % 2))
                    groups.setdefault(g, {"tablets": {}})
                    groups[g]["tablets"][p] = {
                        "predicate": p, "groupId": int(g)}
                return {"groups": groups,
                        "leader": data.get("leader") or "n1"}, None

            return self._reply(200, self.store.transact(rd))
        self._reply(404, {"errors": [{"message": "no route"}]})

    def do_POST(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        params = dict(urllib.parse.parse_qsl(parsed.query))
        length = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._reply(400, {"errors": [{"message": "bad json"}]})
        if path == "/alter":
            return self._alter(body)
        if path == "/query":
            return self._query(body, params)
        if path == "/mutate":
            return self._mutate(body, params)
        if path == "/commit":
            return self._commit(params)
        if path == "/moveTablet":
            return self._move_tablet(params)
        self._reply(404, {"errors": [{"message": "no route"}]})

    # -- transactional plumbing --------------------------------------

    @staticmethod
    def _txn(data: dict, start_ts: int) -> dict | None:
        return (data.get("txns") or {}).get(str(start_ts))

    def _alter(self, body: dict) -> None:
        """Record which predicates carry @upsert (used for index-level
        conflict keys); schemas merge like dgraph's alter."""
        schema = body.get("schema") or ""
        ups = [m.group(1)
               for m in re.finditer(r"(\w+)\s*:[^\n.]*@upsert", schema)]

        def al(data):
            if not ups:
                return {"data": {"code": "Success"}}, None
            new = dict(data)
            new["upsert_preds"] = sorted(
                set(new.get("upsert_preds") or []) | set(ups))
            return {"data": {"code": "Success"}}, new

        self._reply(200, self.store.transact(al))

    def _query(self, body: dict, params: dict) -> None:
        start_ts = int(params.get("startTs") or 0)
        transactional = "startTs" in params

        def rd(data):
            new = None
            if start_ts:
                ts = start_ts
            elif transactional:
                # startTs=0 from a txn's first contact: assign its
                # start_ts, like dgraph returns extensions.txn.start_ts.
                # No txn record yet — it's created lazily by the first
                # staged mutate, so read-only txns leave no garbage.
                ts = int(data.get("ts") or 0) + 1
                new = dict(data)
                new["ts"] = ts
            else:
                # Legacy non-transactional read: current snapshot, no
                # state write (the read hot path stays pure).
                ts = int(data.get("ts") or 0)
            # Only a transactional read may overlay staged writes — a
            # legacy read at ts == an open txn's start_ts must not see
            # that txn's uncommitted data.
            txn = (self._txn(data, ts) or {}) if transactional else {}
            view = snapshot(data, ts, txn.get("writes"))
            try:
                return (run_query(view, body["query"]), ts), new
            except ValueError as e:
                return (e, ts), new

        out, ts = self.store.transact(rd)
        if isinstance(out, Exception):
            return self._reply(400, {"errors": [{"message": str(out)}]})
        return self._reply(200, {
            "data": {"q": out},
            "extensions": {"txn": {"start_ts": ts}},
        })

    def _mutate(self, body: dict, params: dict) -> None:
        sets = body.get("set") or []
        dels = body.get("delete") or []
        upsert_query = body.get("query")
        cond = body.get("cond")
        start_ts = int(params.get("startTs") or 0)
        # Auto-commit when asked explicitly, or when the caller isn't
        # transactional at all (no startTs AND no commitNow param — the
        # legacy one-shot clients). startTs=0&commitNow=false is a
        # txn's FIRST staged mutate: assign its start_ts below.
        commit_now = (params.get("commitNow", "").lower() == "true"
                      or ("commitNow" not in params and not start_ts))

        def mut(data):
            new = dict(data)
            ts = start_ts
            if not ts:
                ts = int(data.get("ts") or 0) + 1
                new["ts"] = ts
            txns = dict(new.get("txns") or {})
            txn = dict(txns.get(str(ts)) or {"writes": {}, "touched": {}})
            writes = dict(txn["writes"])
            # touched = only the explicitly-written (pred, value) pairs
            # per uid — the conflict surface (merged old preds in
            # `writes` exist for MVCC visibility, not conflicts).
            touched = {u: dict(p) if p is not None else None
                       for u, p in (txn.get("touched") or {}).items()}
            view = snapshot(data, ts, writes)

            if upsert_query is not None:
                found = run_query(view, upsert_query)
                if cond is not None:
                    m = re.search(r"eq\(len\(\w+\),\s*(\d+)\)", cond)
                    want = int(m.group(1)) if m else 0
                    if len(found) != want:
                        return ({"data": {"code": "Success", "uids": {}},
                                 "extensions": {"txn": {"start_ts": ts}}},
                                new if new != data else None)

            uids = {}
            counter = int(new.get("uid_counter") or 0)
            for i, triple in enumerate(sets):
                uid = triple.get("uid")
                if uid is None:
                    counter += 1
                    uid = f"0x{counter:x}"
                    uids[f"blank-{i}"] = uid
                explicit = {k: json_number(v)
                            for k, v in triple.items() if k != "uid"}
                merged = dict(view.get(uid) or {})
                merged.update(explicit)
                writes[uid] = merged
                t = dict(touched.get(uid) or {})
                t.update(explicit)
                touched[uid] = t
            for triple in dels:
                uid = triple.get("uid")
                if uid is not None and uid in view:
                    writes[uid] = None
                    touched[uid] = None
            new["uid_counter"] = counter

            if commit_now:
                err, new2 = _apply_commit(new, ts, writes, touched)
                if err:
                    return ({"_status": 409,
                             "errors": [{"message": err}]}, None)
                # Commit-on-last-mutate finishes the txn: drop any
                # staged record so a later /commit can't replay it.
                if str(ts) in (new2.get("txns") or {}):
                    txns2 = dict(new2["txns"])
                    txns2.pop(str(ts))
                    new2 = dict(new2)
                    new2["txns"] = txns2
                return ({"data": {"code": "Success", "uids": uids},
                         "extensions": {"txn": {"start_ts": ts}}}, new2)
            txn["writes"] = writes
            txn["touched"] = touched
            txns[str(ts)] = txn
            new["txns"] = txns
            return ({"data": {"code": "Success", "uids": uids},
                     "extensions": {"txn": {"start_ts": ts}}}, new)

        out = self.store.transact(mut)
        status = out.pop("_status", 200)
        self._reply(status, out)

    def _commit(self, params: dict) -> None:
        start_ts = int(params.get("startTs") or 0)
        abort = params.get("abort", "").lower() == "true"

        def com(data):
            txns = dict(data.get("txns") or {})
            txn = txns.pop(str(start_ts), None)
            new = dict(data)
            new["txns"] = txns
            if txn is None or abort:
                # Read-only commit or abort/discard: both succeed (a
                # read-only txn has no record — see _query — and
                # dgraph's discard of a finished txn is a no-op).
                return ({"data": {"code": "Success"}}, new)
            err, new2 = _apply_commit(new, start_ts, txn["writes"],
                                      txn.get("touched") or txn["writes"])
            if err:
                return ({"_status": 409,
                         "errors": [{"message": err}]}, new)
            return ({"data": {"code": "Success"},
                     "extensions": {"txn": {"start_ts": start_ts,
                                            "commit_ts": new2["ts"]}}},
                    new2)

        out = self.store.transact(com)
        status = out.pop("_status", 200)
        self._reply(status, out)

    def _move_tablet(self, params: dict) -> None:
        pred = params.get("tablet")
        group = params.get("group")

        def mv(data):
            new = dict(data)
            moved = dict(new.get("tablet_groups") or {})
            moved[pred] = str(group)
            new["tablet_groups"] = moved
            return {"data": {"code": "Success",
                             "message": f"moved {pred} to {group}"}}, new

        self._reply(200, self.store.transact(mv))


def _apply_commit(data: dict, start_ts: int, writes: dict,
                  touched: dict):
    """Conflict-check the txn's explicit writes against commits after
    start_ts; on success append new versions at a fresh commit_ts.
    Returns (error-message-or-None, new-data)."""
    upsert_preds = set(data.get("upsert_preds") or [])
    ckeys = dict(data.get("ckeys") or {})
    keys = conflict_keys(touched, upsert_preds)
    for key in keys:
        if ckeys.get(key, 0) > start_ts:
            return ABORTED, None
    if not writes:
        return None, data
    commit_ts = int(data.get("ts") or 0) + 1
    new = dict(data)
    new["ts"] = commit_ts
    nodes = dict(new.get("nodes") or {})
    for uid, preds in writes.items():
        chain = list(nodes.get(uid) or [])
        chain.append([commit_ts, preds])
        nodes[uid] = chain
    new["nodes"] = nodes
    for key in keys:
        ckeys[key] = commit_ts
    new["ckeys"] = ckeys
    return None, new


def parse_args(argv):
    p = argparse.ArgumentParser(description="dgraph HTTP sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--name", default="sim")
    # dgraph alpha flags tolerated:
    p.add_argument("--zero", default=None)
    p.add_argument("--my", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"dgraph-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.dgraph_sim", "dgraph", "dgraph-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the dgraph suite against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under
    "dgraph")."""
    return sim_cluster(root, nodes, ports, "dgraph", "dgraph-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    dgraph suite (`dgraph.dgraph_test`) on a `local_cluster`
    (`simbase.sim_test_fn`). The suite's nemesis (the default partition
    of random halves, or the failure-mode flags' composed one) runs on
    the no-op network; the alpha and zero killers, the alpha fixer and
    the tablet mover act on the simulated nodes; the clock skew goes to
    `RecordingClockTools` (cluster["clock_calls"]); fs-break is
    refused."""
    def make(opts):
        from . import dgraph

        return dgraph.dgraph_test(opts)

    return sim_test_fn(cluster, "dgraph", make, {
        "clock_tools": RecordingClockTools(cluster.setdefault(
            "clock_calls", []))})

if __name__ == "__main__":
    serve()
