"""A hermetic etcd lookalike: an HTTP server speaking the subset of the
etcd v2 keys API that the etcd suite's client uses (GET/PUT/DELETE on
/v2/keys, prevValue/prevExist compare-and-swap, errorCodes 100/101/105),
plus /version.

This is NOT part of the framework proper — it is the test double that
lets the etcd suite run its real code paths (archive install, daemon
start/stop, HTTP client taxonomy) on one machine with no network access
(SURVEY.md §4.2's "in-process fake backend" idea, lifted to a real
process behind a real socket). It accepts etcd's own command-line flags
(--name, --listen-client-urls, --initial-cluster, ...) so the DB layer
can launch it exactly as it would launch etcd
(etcd/src/jepsen/etcd.clj:62-74 — cited for parity, not
copied).

"Cluster consistency" is modeled by all member processes sharing one
flock-guarded JSON state file: every op takes an exclusive lock, so the
simulated cluster is linearizable by construction. A latency knob
(--mean-latency) adds jitter so histories have real concurrency windows.

The port's copy of `jepsen_tpu/dbs/etcd_sim.py`: it imports nothing of
`jepsen_tpu`.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .simbase import Store, build_sim_archive, free_port

KEYS_PREFIX = "/v2/keys/"


def _etcd_error(code: int, message: str, cause: str) -> dict:
    return {"errorCode": code, "message": message, "cause": cause, "index": 0}


class Handler(BaseHTTPRequestHandler):
    store: Store = None  # type: ignore[assignment]
    mean_latency: float = 0.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet; daemon log gets stdout
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

    def _key(self) -> str | None:
        path = urllib.parse.urlparse(self.path).path
        if not path.startswith(KEYS_PREFIX):
            return None
        return urllib.parse.unquote(path[len(KEYS_PREFIX):])

    def do_GET(self):
        self._jitter()
        if urllib.parse.urlparse(self.path).path == "/version":
            return self._reply(
                200, {"etcdserver": "jepsen-tpu-sim", "etcdcluster": "2.3.0"}
            )
        k = self._key()
        if k is None:
            return self._reply(404, _etcd_error(100, "Key not found", self.path))

        def read(data):
            if k in data:
                return (200, {"action": "get",
                              "node": {"key": "/" + k, "value": data[k]}}), None
            return (404, _etcd_error(100, "Key not found", "/" + k)), None

        status, body = self.store.transact(read)
        self._reply(status, body)

    def do_PUT(self):
        self._jitter()
        k = self._key()
        if k is None:
            return self._reply(404, _etcd_error(100, "Key not found", self.path))
        length = int(self.headers.get("Content-Length") or 0)
        form = urllib.parse.parse_qs(self.rfile.read(length).decode())
        value = (form.get("value") or [None])[0]
        prev_value = (form.get("prevValue") or [None])[0]
        prev_exist = (form.get("prevExist") or [None])[0]
        if value is None:
            return self._reply(
                400, _etcd_error(200, "Value is Required in POST form", "")
            )

        def write(data):
            node = {"key": "/" + k, "value": value}
            if prev_value is not None:
                if k not in data:
                    return (404, _etcd_error(100, "Key not found", "/" + k)), None
                if data[k] != prev_value:
                    return (
                        412,
                        _etcd_error(
                            101,
                            "Compare failed",
                            f"[{prev_value} != {data[k]}]",
                        ),
                    ), None
                new = dict(data)
                new[k] = value
                return (200, {"action": "compareAndSwap", "node": node}), new
            if prev_exist == "false" and k in data:
                return (412, _etcd_error(105, "Key already exists", "/" + k)), None
            if prev_exist == "true" and k not in data:
                return (404, _etcd_error(100, "Key not found", "/" + k)), None
            new = dict(data)
            new[k] = value
            return (200, {"action": "set", "node": node}), new

        status, body = self.store.transact(write)
        self._reply(status, body)

    def do_DELETE(self):
        self._jitter()
        k = self._key()
        if k is None:
            return self._reply(404, _etcd_error(100, "Key not found", self.path))

        def rm(data):
            if k not in data:
                return (404, _etcd_error(100, "Key not found", "/" + k)), None
            new = dict(data)
            del new[k]
            return (200, {"action": "delete", "node": {"key": "/" + k}}), new

        status, body = self.store.transact(rm)
        self._reply(status, body)


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="etcd v2 keys-API simulator",
        # etcd flags we accept-and-ignore arrive as --flag value pairs
        allow_abbrev=False,
    )
    p.add_argument("--data", required=True, help="shared JSON state file")
    p.add_argument("--mean-latency", type=float, default=0.0,
                   help="mean exponential per-request latency, seconds")
    p.add_argument("--name", default="sim")
    p.add_argument("--listen-client-urls", default="http://127.0.0.1:2379")
    # etcd flags tolerated for command-line compatibility:
    for flag in ("--advertise-client-urls", "--listen-peer-urls",
                 "--initial-advertise-peer-urls", "--initial-cluster",
                 "--initial-cluster-state", "--log-output"):
        p.add_argument(flag, default=None)
    return p.parse_args(argv)


def serve(argv=None) -> None:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    url = urllib.parse.urlparse(args.listen_client_urls.split(",")[0])
    host, port = url.hostname or "127.0.0.1", url.port or 2379
    Handler.store = Store(args.data)
    Handler.mean_latency = args.mean_latency
    httpd = ThreadingHTTPServer((host, port), Handler)
    print(f"etcd-sim {args.name} serving on {host}:{port}, data={args.data}")
    sys.stdout.flush()
    httpd.serve_forever()


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """Build an etcd-shaped tar.gz whose `etcd` binary is a script
    launching this simulator with a shared state file. Installed via the
    suite's normal install_archive path (file:// URL)."""
    return build_sim_archive(
        dest, "jepsen_tpu_torch.dbs.etcd_sim", "etcd", "etcd-sim-linux-amd64",
        data_path, mean_latency=mean_latency, python=python,
    )


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the etcd suite against simulated
    members on this machine, one process a node: a LocalRemote whose
    nodes are directories under root/nodes, this simulator's archive
    (all members share root/shared/state.json), and each member's client
    and peer ports (`ports` = {"client": {node: port}, "peer": {...}}
    to reuse a cluster's, as a resumed run must; else free ports)."""
    import os

    from ..control import LocalRemote

    remote = LocalRemote(root=os.path.join(root, "nodes"))
    archive = build_archive(os.path.join(root, "etcd-sim.tar.gz"),
                            os.path.join(root, "shared", "state.json"))
    ports = ports or {kind: {n: free_port() for n in nodes}
                      for kind in ("client", "peer")}
    return {
        "remote": remote,
        "archive_url": f"file://{archive}",
        "ports": ports,
        "etcd": {
            "addr_fn": lambda n: "127.0.0.1",
            "client_ports": ports["client"],
            "peer_ports": ports["peer"],
            "dir": lambda n: os.path.join(remote.node_dir(n), "opt", "etcd"),
            "sudo": None,
        },
    }


def recording_clock(record: list):
    """A clock setter for the clock fault family (`set_time_fn(test,
    node, t)`) that appends (node, t) to `record` and sets no clock:
    the simulated members share this machine's clock, and
    `nemesis.set_time` would set it (`LocalRemote` runs `sudo` commands
    as the caller)."""
    def set_time(test, node, t) -> None:
        record.append((node, t))

    return set_time


def local_test_fn(cluster: dict, suite_opts: dict | None = None,
                  client=None):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    etcd suite (`etcd.etcd_test`) on a `local_cluster`: the command's
    options, with `suite_opts` (options the CLI has no flag for, such as
    "threads_per_key", "ops_per_key", "fault_ops" or
    "stability_period") and the cluster's entries over them, go to the
    constructor; then the OS is none (there is no real node to
    provision). A named --nemesis does nothing and the network is none.
    A composed fault package (--nemesis fault families or
    --nemesis-schedule) keeps its nemesis on the no-op network: kill,
    pause and corruption act on the member processes and their files,
    partition and packet faults are recorded and healed but change no
    traffic, and clock faults always go to `recording_clock`
    (cluster["clock_sets"]). The fs-break modes raise `cli.CliError`
    before anything runs on a node: their FUSE layer would mount over
    the members' data as the caller, and the recipe's nemesis could not
    inject through it. `client` replaces the suite's client (a wrapper
    around `etcd.EtcdClient`, say)."""
    def test_fn(opts: dict) -> dict:
        from .. import nemesis, net
        from ..cli import CliError
        from . import common, etcd

        opts = {**opts, **(suite_opts or {}),
                "remote": cluster["remote"], "etcd": cluster["etcd"],
                "archive_url": cluster["archive_url"],
                "set_time_fn": recording_clock(
                    cluster.setdefault("clock_sets", []))}
        if opts.get("nemesis") in common.FSFAULT_NEMESIS_NAMES:
            raise CliError(f"--nemesis {opts['nemesis']}: the simulated "
                           "cluster cannot mount the FUSE fault layer")
        t = etcd.etcd_test(opts)
        if "fault_families" in t:
            t.update({"os": None, "net": net.noop})
        else:
            t.update({"os": None, "net": None, "nemesis": nemesis.noop})
        if client is not None:
            t["client"] = client
        return t

    return test_fn


if __name__ == "__main__":
    serve()
