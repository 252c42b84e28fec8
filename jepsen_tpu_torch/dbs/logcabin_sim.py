"""A hermetic LogCabin lookalike. LogCabin's client surface in the
reference suite is the ON-NODE `treeops` binary driven over SSH
(logcabin.clj:163-210) — so this sim ships an archive with two
programs:

  - logcabind: a placeholder daemon (binds its port so readiness and
    kill/restart nemeses have something real to act on)
  - treeops:   the CLI with the reference's exact contract:
                 treeops -c <servers> -q -t <s> read <path>
                 echo -n v  | treeops ... write <path>
                 echo -n v2 | treeops ... -p <path>:<v1> write <path>
               conditional writes print "Error: ... CAS failed ..." and
               exit nonzero on mismatch

The tree lives in the shared flock-guarded store, so every node's
treeops sees one linearizable namespace.

The port's copy of `jepsen_tpu/dbs/logcabin_sim.py`: it imports nothing
of `jepsen_tpu` (a `treeops` process loads neither torch nor jax), and
adds the recipe that runs the logcabin suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`)."""

from __future__ import annotations

import argparse
import os
import shlex
import socketserver
import sys
import tarfile
import tempfile

from .simbase import Store, sim_cluster, sim_test_fn


# ---------------------------------------------------------------------------
# treeops CLI


def treeops_main(argv) -> int:
    p = argparse.ArgumentParser(prog="treeops", allow_abbrev=False)
    p.add_argument("-c", dest="cluster", default=None)
    p.add_argument("-q", action="store_true")
    p.add_argument("-t", dest="timeout", default=None)
    p.add_argument("-p", dest="predicate", default=None)
    p.add_argument("--data", required=True)
    p.add_argument("command", choices=["read", "write", "remove"])
    p.add_argument("path")
    args = p.parse_args(argv)
    store = Store(args.data)

    if args.command == "read":
        def read(data):
            return (data.get("tree") or {}).get(args.path), None

        value = store.transact(read)
        if value is None:
            print(f"Error: {args.path} does not exist", file=sys.stderr)
            return 1
        sys.stdout.write(value)
        return 0

    if args.command == "write":
        value = sys.stdin.read()
        want = None
        if args.predicate:
            pred_path, _, want = args.predicate.partition(":")
            if pred_path != args.path:
                print("Error: predicate path mismatch", file=sys.stderr)
                return 1

        def write(data):
            tree = dict(data.get("tree") or {})
            if want is not None and tree.get(args.path) != want:
                return False, None
            tree[args.path] = value
            new = dict(data)
            new["tree"] = tree
            return True, new

        if store.transact(write):
            return 0
        print("Error: CAS failed: content doesn't match", file=sys.stderr)
        return 1

    def remove(data):
        tree = dict(data.get("tree") or {})
        tree.pop(args.path, None)
        new = dict(data)
        new["tree"] = tree
        return None, new

    store.transact(remove)
    return 0


# ---------------------------------------------------------------------------
# placeholder daemon


class _Ping(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            self.request.sendall(b"logcabin-sim\n")
        except OSError:
            pass


def serve(argv=None) -> None:
    p = argparse.ArgumentParser(description="logcabin daemon sim",
                                allow_abbrev=False)
    p.add_argument("--data", required=True)
    p.add_argument("--mean-latency", type=float, default=0.0)
    p.add_argument("--port", type=int, default=5254)
    p.add_argument("--name", default="sim")
    p.add_argument("--bootstrap", action="store_true")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", args.port), _Ping)
    srv.allow_reuse_address = True
    srv.daemon_threads = True
    print(f"logcabin-sim {args.name} on {args.port}, data={args.data}")
    sys.stdout.flush()
    srv.serve_forever()


def build_archive(dest: str, data_path: str, python: str | None = None
                  ) -> str:
    """Archive with both logcabind and treeops launchers sharing one
    state file."""
    python = python or sys.executable
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    daemon = (
        "#!/bin/bash\n"
        f"export PYTHONPATH={shlex.quote(repo_root)}:$PYTHONPATH\n"
        f"exec {shlex.quote(python)} -m jepsen_tpu_torch.dbs.logcabin_sim "
        f"--data {shlex.quote(data_path)} \"$@\"\n"
    )
    treeops = (
        "#!/bin/bash\n"
        f"export PYTHONPATH={shlex.quote(repo_root)}:$PYTHONPATH\n"
        f"exec {shlex.quote(python)} -c "
        "'import sys; from jepsen_tpu_torch.dbs.logcabin_sim import "
        "treeops_main; sys.exit(treeops_main(sys.argv[1:]))' "
        f"--data {shlex.quote(data_path)} \"$@\"\n"
    )
    os.makedirs(os.path.dirname(os.path.abspath(dest)) or ".",
                exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        top = os.path.join(td, "logcabin-sim")
        os.makedirs(top)
        for name, script in (("logcabind", daemon), ("treeops", treeops)):
            path = os.path.join(top, name)
            with open(path, "w") as f:
                f.write(script)
            os.chmod(path, 0o755)
        with tarfile.open(dest, "w:gz") as tar:
            tar.add(top, arcname="logcabin-sim")
    return dest


def local_cluster(root: str, nodes, ports: dict | None = None) -> dict:
    """The test-map entries that run the logcabin suite against
    simulated nodes on this machine, one daemon process a node
    (`simbase.sim_cluster`, settings under "logcabin"): this simulator's
    archive holds logcabind and treeops, and every node's treeops shares
    root/shared/state.json."""
    return sim_cluster(root, nodes, ports, "logcabin", "logcabin-sim",
                       build_archive)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs the
    logcabin suite (`logcabin.logcabin_test`) on a `local_cluster`
    (`simbase.sim_test_fn`). Each op is a `treeops` process on its node
    over `LocalRemote`. The suite's nemesis (--nemesis, partitions by
    default, on its start/stop cycle) runs on the no-op network;
    start-kill acts on the simulated daemons; start-stop's `killall
    logcabind` finds no process of that name (the daemons are Python
    processes); fs-break is refused."""
    def make(opts):
        from . import logcabin

        return logcabin.logcabin_test(opts)

    return sim_test_fn(cluster, "logcabin", make)

if __name__ == "__main__":
    serve()
