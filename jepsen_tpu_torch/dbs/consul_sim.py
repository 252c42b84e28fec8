"""A hermetic Consul lookalike: the /v1/kv subset the consul suite
drives — base64-encoded values with CreateIndex/ModifyIndex, ?cas=index
check-and-set, X-Consul-Index headers — plus /v1/status/leader
(reference behavior: consul/src/jepsen/consul.clj:66-146 — studied for
parity, not copied).

Like the other sims, member processes share one flock-guarded JSON
state file; every op takes the exclusive lock, so the simulated cluster
is linearizable by construction.

The port's copy of `jepsen_tpu/dbs/consul_sim.py`: it imports nothing
of `jepsen_tpu`, and adds the recipe that runs the consul suite on
simulated agents on this machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import base64
import json
import random
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import Store, build_sim_archive, free_port

KV_PREFIX = "/v1/kv/"


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        sys.stdout.write("%s - %s\n" % (self.address_string(), fmt % args))
        sys.stdout.flush()

    def _jitter(self):
        if self.mean_latency > 0:
            time.sleep(random.expovariate(1.0 / self.mean_latency))

    def _reply(self, status: int, body, headers: dict | None = None):
        payload = (body if isinstance(body, bytes)
                   else json.dumps(body).encode())
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(payload)

    def _key(self) -> str | None:
        path = urllib.parse.urlparse(self.path).path
        if not path.startswith(KV_PREFIX):
            return None
        return urllib.parse.unquote(path[len(KV_PREFIX):])

    def do_GET(self):
        self._jitter()
        path = urllib.parse.urlparse(self.path).path
        if path == "/v1/status/leader":
            return self._reply(200, "127.0.0.1:8300")
        k = self._key()
        if k is None:
            return self._reply(404, {})

        def read(data):
            kv = data.get("kv") or {}
            return kv.get(k), None

        entry = self.store.transact(read)
        if entry is None:
            return self._reply(404, b"", {"X-Consul-Index": 1})
        body = [{
            "CreateIndex": entry["create"],
            "ModifyIndex": entry["modify"],
            "Key": k,
            "Flags": 0,
            "Value": entry["value"],  # already base64
        }]
        self._reply(200, body, {"X-Consul-Index": entry["modify"]})

    def do_PUT(self):
        self._jitter()
        k = self._key()
        if k is None:
            return self._reply(404, {})
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length)
        value = base64.b64encode(raw).decode()
        query = urllib.parse.parse_qs(
            urllib.parse.urlparse(self.path).query)
        cas = query.get("cas")

        def put(data):
            kv = dict(data.get("kv") or {})
            next_index = int(data.get("index") or 0) + 1
            cur = kv.get(k)
            if cas is not None:
                want = int(cas[0])
                # consul cas semantics: 0 means "create only"; else the
                # ModifyIndex must match
                if want == 0 and cur is not None:
                    return False, None
                if want != 0 and (cur is None or cur["modify"] != want):
                    return False, None
            kv[k] = {
                "create": cur["create"] if cur else next_index,
                "modify": next_index,
                "value": value,
            }
            new = dict(data)
            new["kv"] = kv
            new["index"] = next_index
            return True, new

        ok = self.store.transact(put)
        self._reply(200, b"true" if ok else b"false")


def parse_args(argv):
    p = argparse.ArgumentParser(description="consul kv sim",
                                allow_abbrev=False)
    p.add_argument("command", nargs="?", default="agent")  # `consul agent`
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("-http-port", dest="http_port", type=int, default=None)
    # consul agent flags tolerated for command-line compatibility:
    p.add_argument("-server", action="store_true")
    p.add_argument("-bootstrap", action="store_true")
    p.add_argument("-bind", default=None)
    p.add_argument("-client", default=None)
    p.add_argument("-join", default=None)
    p.add_argument("-node", default="sim")
    p.add_argument("-data-dir", default=None)
    p.add_argument("-log-level", default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    port = args.http_port or args.port
    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    print(f"consul-sim {args.node} serving on {port}, "
          f"data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.consul_sim", "consul", "consul-sim",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the consul suite against simulated
    agents on this machine, one process a node: a LocalRemote whose
    nodes are directories under root/nodes, this simulator's archive
    (all agents share root/shared/state.json), and each agent's HTTP
    port (`ports` = {node: port} to reuse a cluster's; else free
    ports)."""
    import os

    from ..control import LocalRemote

    remote = LocalRemote(root=os.path.join(root, "nodes"))
    archive = build_archive(os.path.join(root, "consul-sim.tar.gz"),
                            os.path.join(root, "shared", "state.json"))
    ports = ports or {n: free_port() for n in nodes}
    return {
        "remote": remote,
        "archive_url": f"file://{archive}",
        "ports": ports,
        "consul": {
            "addr_fn": lambda n: "127.0.0.1",
            "ports": ports,
            "dir": lambda n: os.path.join(remote.node_dir(n), "opt",
                                          "consul"),
            "sudo": None,
        },
    }


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    consul suite (`consul.consul_test`) on a `local_cluster`: the
    command's options, with the cluster's entries over them, go to the
    constructor; then the OS is none (there is no real node to
    provision), a named --nemesis does nothing and the network is none,
    as the etcd recipe (`etcd_sim.local_test_fn`) has it. The fs-break
    modes raise `cli.CliError` before anything runs on a node: their
    FUSE layer would mount over the agents' data as the caller."""
    def test_fn(opts: dict) -> dict:
        from .. import nemesis
        from ..cli import CliError
        from . import common, consul

        opts = {**opts, "remote": cluster["remote"],
                "consul": cluster["consul"],
                "archive_url": cluster["archive_url"]}
        if opts.get("nemesis") in common.FSFAULT_NEMESIS_NAMES:
            raise CliError(f"--nemesis {opts['nemesis']}: the simulated "
                           "cluster cannot mount the FUSE fault layer")
        t = consul.consul_test(opts)
        t.update({"os": None, "net": None, "nemesis": nemesis.noop})
        return t

    return test_fn


if __name__ == "__main__":
    serve()
