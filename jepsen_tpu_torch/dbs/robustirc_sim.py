"""A hermetic RobustIRC lookalike: the HTTP session API the robustirc
suite drives (robustirc.clj:102-135) — POST /robustirc/v1/session
creating {Sessionid, Sessionauth}, POST .../<sid>/message appending an
IRC line to the network-wide log (deduplicated by ClientMessageId,
RobustIRC's at-most-once contract), GET .../<sid>/messages returning
the whole log as a JSON array (the real server streams newline-JSON;
an array is the same payload without chunking).

The port's copy of `jepsen_tpu/dbs/robustirc_sim.py`: it imports nothing
of `jepsen_tpu` (a member process loads neither torch nor jax), and adds
the recipe that runs the robustirc suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import json
import random
import secrets
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import Store, build_sim_archive, sim_cluster, sim_test_fn

PREFIX = "/robustirc/v1"


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _reply(self, status: int, body) -> None:
        payload = (body if isinstance(body, bytes)
                   else json.dumps(body).encode())
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _jitter(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))

    def do_POST(self):
        self._jitter()
        path = urllib.parse.urlparse(self.path).path
        if not path.startswith(PREFIX):
            return self._reply(404, {"error": "no route"})
        parts = [p for p in path[len(PREFIX):].split("/") if p]
        if parts == ["session"]:
            sid = secrets.token_hex(8)
            auth = secrets.token_hex(16)

            def create(data):
                sessions = dict(data.get("sessions") or {})
                sessions[sid] = auth
                new = dict(data)
                new["sessions"] = sessions
                return None, new

            self.store.transact(create)
            return self._reply(200, {"Sessionid": sid,
                                     "Sessionauth": auth,
                                     "Prefix": "robustirc-sim"})
        if len(parts) == 2 and parts[1] == "message":
            sid = parts[0]
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length))
            except json.JSONDecodeError:
                return self._reply(400, {"error": "bad json"})
            auth = self.headers.get("X-Session-Auth")

            def post(data):
                if (data.get("sessions") or {}).get(sid) != auth:
                    return 401, None
                msgs = list(data.get("messages") or [])
                mid = body.get("ClientMessageId")
                # at-most-once is scoped PER SESSION — different
                # clients may reuse ids
                if mid is not None and any(
                        m.get("ClientMessageId") == mid
                        and m.get("Session") == sid for m in msgs):
                    return 200, None  # duplicate
                msgs.append({"Id": {"Id": len(msgs)},
                             "Session": sid,
                             "Data": body.get("Data", ""),
                             "ClientMessageId": mid})
                new = dict(data)
                new["messages"] = msgs
                return 200, new

            status = self.store.transact(post)
            return self._reply(status, {} if status == 200
                               else {"error": "bad session"})
        self._reply(404, {"error": "no route"})

    def do_GET(self):
        self._jitter()
        path = urllib.parse.urlparse(self.path).path
        parts = [p for p in path[len(PREFIX):].split("/") if p]
        if len(parts) == 2 and parts[1] == "messages":
            sid = parts[0]
            auth = self.headers.get("X-Session-Auth")

            def read(data):
                if (data.get("sessions") or {}).get(sid) != auth:
                    return None, None
                return list(data.get("messages") or []), None

            msgs = self.store.transact(read)
            if msgs is None:
                return self._reply(401, {"error": "bad session"})
            return self._reply(200, msgs)
        self._reply(404, {"error": "no route"})


def parse_args(argv):
    p = argparse.ArgumentParser(description="robustirc sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=13001)
    p.add_argument("--name", default="sim")
    p.add_argument("-network_name", default=None)  # tolerated
    p.add_argument("-peer_addr", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    httpd = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"robustirc-sim {args.name} serving on {args.port}, "
          f"data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """A robustirc-shaped tar.gz whose `robustirc` binary launches this
    sim. Starting a node that already runs does nothing, as for a real
    `robustirc` under start-stop-daemon."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.robustirc_sim", "robustirc",
        "robustirc-sim", data_path, mean_latency=mean_latency,
        python=python, pidfile="robustirc.pid",
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the robustirc suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "robustirc")."""
    return sim_cluster(root, nodes, ports, "robustirc", "robustirc-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `robustirc.robustirc_test` on a `local_cluster`
    (`simbase.sim_test_fn`): the suite's nemesis on the no-op network
    (partitions recorded and healed), the final reads behind their
    quiesce and readiness gate; fs-break refused."""
    def make(opts):
        from . import robustirc

        return robustirc.robustirc_test(opts)

    return sim_test_fn(cluster, "robustirc", make)


if __name__ == "__main__":
    serve()
