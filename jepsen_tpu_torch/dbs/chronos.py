"""Chronos test suite: schedule repeating jobs, record their actual
runs, and verify every promised execution happened within its window
(reference: chronos/src/jepsen/chronos.clj:1-270 and
chronos/checker.clj:1-321).

Jobs are shell commands that log their own invocation times to
tempfiles on the node (chronos.clj:109-117); the final :read collects
those run files from every node via the control plane
(chronos.clj:161-172). The checker derives each job's target windows
[t, t+epsilon+forgiveness] from its schedule and greedily matches runs
to targets — a target with no run is a missed execution
(checker.clj:30-90's model, with a greedy matcher in place of the
reference's constraint solver).

The port's copy of `jepsen_tpu/dbs/chronos.py`: `ChronosChecker` runs
on the host and the suite reaches no kernel. Its job directory (the
suite settings' "job_dir") may also be a function of the node, as "dir"
is: `chronos_sim.local_test_fn` keeps every node's run files under that
node's directory of `LocalRemote` (the JAX package's is one path for
every node)."""

from __future__ import annotations

import datetime
import itertools
import json
import logging
import random
import socket
import time
import urllib.error
import urllib.request

from .. import checker as checker_mod
from . import common as cmn
from .. import cli, client, generator as gen, osdist
from ..checker import Checker
from ..history import Op, ops as _ops
from ..util import real_pmap
from .common import SuiteCfg, ready_gated_final

log = logging.getLogger("jepsen_tpu_torch.dbs.chronos")

PORT = 4400
EPSILON_FORGIVENESS = 5  # let chronos miss deadlines by a few seconds


_suite = SuiteCfg("chronos", PORT, "/opt/chronos")
node_host = _suite.host
node_port = _suite.port


def job_dir(test, node=None) -> str:
    """The directory the jobs' commands write their run files into: the
    settings' "job_dir", called with `node` when it is a function."""
    d = _suite.cfg(test).get("job_dir", "/tmp/chronos-test")
    return d(node) if callable(d) else d


MASTER_COUNT = 3          # mesosphere.clj:17
ZK_PORT = 2181
MESOS_PORT = 5050


class ChronosDB(cmn.MultiDaemonDB):
    """The real mesosphere stack per the reference: zookeeper on every
    node, mesos-master on the first MASTER_COUNT sorted nodes and
    mesos-slave on the rest (mesosphere.clj:57-119's role split),
    chronos on every node (chronos.clj:56-83 layers it over
    mesosphere/db). Bring-up is readiness-gated in dependency order
    zk -> mesos -> chronos; teardown reverses it (chronos.clj:73-78
    stops chronos first, then the mesosphere teardown). The chronos
    sim gates its scheduler API on the node's zookeeper, so the
    kill-zk nemesis is client-observable."""

    binary = "chronos"
    log_name = "chronos.log"
    pid_name = "chronos.pid"

    ROLES = ("zk", "mesos-master", "mesos-slave", "chronos")
    ROLE_TAG = {"zk": "zookeeper", "mesos-master": "mesos-master",
                "mesos-slave": "mesos-slave", "chronos": "chronos"}
    ROLE_BIN = {"zk": "zookeeper-server",
                "mesos-master": "mesos-master",
                "mesos-slave": "mesos-slave", "chronos": "chronos"}
    STOP_ORDER = ("chronos", "mesos-slave", "mesos-master", "zk")

    def __init__(self, archive_url: str | None = None,
                 ready_timeout: float = 60.0):
        super().__init__(_suite, archive_url, ready_timeout)

    # ---- role placement (mesosphere.clj:60-71,93-100) ----

    def masters(self, test) -> list:
        return sorted(test["nodes"])[:MASTER_COUNT]

    def role_nodes(self, test, role) -> list:
        if role == "mesos-master":
            return self.masters(test)
        if role == "mesos-slave":
            return [n for n in sorted(test["nodes"])
                    if n not in self.masters(test)]
        return list(test["nodes"])

    def role_port(self, test, node, role) -> int:
        if role == "chronos":
            return node_port(test, node)
        if role == "zk":
            ports = _suite.cfg(test).get("zk_ports")
            return ports[node] if ports else ZK_PORT
        ports = _suite.cfg(test).get("mesos_ports")
        return ports[node] if ports else MESOS_PORT

    def zk_uri(self, test) -> str:
        """zk://host:port,.../mesos (mesosphere.clj:38-46)."""
        return "zk://" + ",".join(
            f"{node_host(test, n)}:{self.role_port(test, n, 'zk')}"
            for n in test["nodes"]) + "/mesos"

    def role_args(self, test, node, role) -> list:
        port = self.role_port(test, node, role)
        if role == "zk":
            return ["--port", str(port)]
        if role == "mesos-master":
            quorum = len(self.masters(test)) // 2 + 1
            return ["--port", str(port), "--role", "master",
                    "--zk", self.zk_uri(test), "--quorum", str(quorum)]
        if role == "mesos-slave":
            return ["--port", str(port), "--role", "slave",
                    "--master", self.zk_uri(test)]
        return ["--port", str(port),
                "--zk-port", str(self.role_port(test, node, "zk")),
                "--master", self.zk_uri(test)]

    # the base-class single-daemon surface (shared start-kill /
    # hammer-time nemeses) targets the chronos scheduler itself
    def daemon_args(self, test, node) -> list:
        return self.role_args(test, node, "chronos")

    def probe_ready(self, test, node) -> bool:
        url = (f"http://{node_host(test, node)}:{node_port(test, node)}"
               "/scheduler/jobs")
        with urllib.request.urlopen(url, timeout=2) as resp:
            return resp.status == 200

    def setup(self, test, node) -> None:
        remote = test["remote"]
        remote.exec(node, ["mkdir", "-p", job_dir(test, node)],
                    check=False)
        self.install(test, node)
        self.start_component(test, node, "zk")
        self._await_ports(test, "zk", self.ready_timeout)
        for mesos_role in ("mesos-master", "mesos-slave"):
            if node in self.role_nodes(test, mesos_role):
                self.start_component(test, node, mesos_role)
        self._await_ports(test, "mesos-master", self.ready_timeout)
        self.start_component(test, node, "chronos")
        self.await_ready(test, node)

    def teardown(self, test, node) -> None:
        super().teardown(test, node)
        test["remote"].exec(node, ["rm", "-rf", job_dir(test, node)],
                            check=False)


def interval_str(job: dict) -> str:
    """R<count>/<ISO start>/PT<interval>S (chronos.clj:102-107)."""
    start = datetime.datetime.fromtimestamp(
        job["start"], tz=datetime.timezone.utc)
    return (f"R{job['count']}/{start.isoformat()}"
            f"/PT{job['interval']}S")


def command(job: dict, test, node=None) -> str:
    """Shell command logging name + invocation + completion times
    (chronos.clj:109-117), into `node`'s job directory."""
    d = job_dir(test, node)
    return (f"MEW=$(mktemp -p {d}); "
            f"echo \"{job['name']}\" >> $MEW; "
            "date -u +%s.%N >> $MEW; "
            f"sleep {job['duration']}; "
            "date -u +%s.%N >> $MEW;")


def job_to_json(job: dict, test, node=None) -> dict:
    return {
        "name": str(job["name"]),
        "command": command(job, test, node),
        "schedule": interval_str(job),
        "scheduleTimeZone": "UTC",
        "owner": "jepsen@jepsen.io",
        "epsilon": f"PT{job['epsilon']}S",
        "mem": 1, "disk": 1, "cpus": 0.001, "async": False,
    }


def read_runs(test) -> list:
    """Collect every run record from every node's job files
    (chronos.clj:143-172). Files are parsed INDIVIDUALLY — a job still
    mid-sleep has only [name, start] in its file, and concatenating
    everything would shift later records out of alignment."""
    remote = test["remote"]
    sep = "==JEPSEN-FILE=="

    def read_node(node):
        d = job_dir(test, node)
        out = remote.exec(
            node,
            f'for f in {d}/*; do echo "{sep}"; cat "$f"; echo; done '
            "2>/dev/null || true",
            check=False).out
        runs = []
        for block in out.split(sep):
            lines = [ln for ln in block.splitlines() if ln.strip()]
            if len(lines) < 2:
                continue
            try:
                runs.append({
                    "node": str(node),
                    "name": int(lines[0]),
                    "start": float(lines[1]),
                    "end": (float(lines[2])
                            if len(lines) > 2 else None),
                })
            except ValueError:
                continue
        return runs

    out = []
    for runs in real_pmap(read_node, test["nodes"]):
        out.extend(runs)
    return out


class ChronosClient(client.Client):
    """add-job POSTs the schedule; read collects run files
    (chronos.clj:174-196)."""

    def __init__(self, node=None):
        self.node = node

    def open(self, test, node):
        return ChronosClient(node)

    def invoke(self, test, op: Op) -> Op:
        try:
            if op.f == "add-job":
                body = json.dumps(job_to_json(op.value, test,
                                              self.node)).encode()
                req = urllib.request.Request(
                    f"http://{node_host(test, self.node)}:"
                    f"{node_port(test, self.node)}/scheduler/iso8601",
                    data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=20):
                    pass
                return op.with_(type="ok")
            if op.f == "read":
                # runs carry EPOCH times, so the read moment must be
                # epoch too (Op.time is relative to test start)
                return op.with_(type="ok", value={
                    "time": time.time(),
                    "runs": read_runs(test),
                })
            raise ValueError(f"unknown op {op.f!r}")
        except (ConnectionError, socket.timeout, TimeoutError) as e:
            return op.with_(type="fail", error=str(e))
        except (urllib.error.URLError, OSError) as e:
            return op.with_(type="fail", error=str(e))


class ChronosChecker(Checker):
    """Match runs to each job's target windows (checker.clj:30-199,
    greedy instead of loco). A job's targets are every scheduled start
    before the final read (minus epsilon+duration slack); each needs a
    run beginning within [target, target+epsilon+forgiveness]."""

    def check(self, test, history, opts=None) -> dict:
        jobs = [o.value for o in _ops(history)
                if o.is_ok and o.f == "add-job"]
        read_time = None
        runs = None
        for o in _ops(history):
            if o.is_ok and o.f == "read":
                if not isinstance(o.value, dict):
                    # a pre-dict-format store: no epoch read time was
                    # recorded, so targets can't be derived honestly
                    return {"valid": "unknown",
                            "error": "read lacks epoch timestamp"}
                runs = o.value["runs"]
                read_time = o.value["time"]
        if runs is None:
            return {"valid": "unknown", "error": "no run read"}

        runs_by_job: dict = {}
        for run in runs:
            runs_by_job.setdefault(run["name"], []).append(run)

        job_results = {}
        all_valid = True
        for job in jobs:
            targets = []
            finish = read_time - job["epsilon"] - job["duration"]
            for i in range(job["count"]):
                t = job["start"] + i * job["interval"]
                if t > finish:
                    break
                targets.append(t)
            available = sorted(
                r["start"] for r in runs_by_job.get(job["name"], []))
            used = [False] * len(available)
            solo = []
            for t in targets:
                hit = None
                for i, s in enumerate(available):
                    if used[i]:
                        continue
                    if t <= s <= t + job["epsilon"] + EPSILON_FORGIVENESS:
                        hit = i
                        break
                if hit is None:
                    solo.append(t)
                else:
                    used[hit] = True
            extra = used.count(False)
            ok = not solo
            all_valid = all_valid and ok
            job_results[job["name"]] = {
                "valid": ok,
                "targets": len(targets),
                "runs": len(available),
                "missed_targets": solo[:10],
                "extra_runs": extra,
            }
        return {"valid": all_valid, "jobs": job_results}


def add_job_gen():
    """Non-overlapping repeating jobs a few seconds out
    (chronos.clj:194-217)."""
    ids = itertools.count(1)

    def g(test, process):
        head_start = test.get("chronos_head_start", 10)
        duration = random.randrange(test.get("chronos_max_duration", 10))
        epsilon = 10 + random.randrange(20)
        interval = (1 + duration + epsilon + EPSILON_FORGIVENESS
                    + random.randrange(30))
        return {
            "type": "invoke",
            "f": "add-job",
            "value": {
                "name": next(ids),
                "start": time.time() + head_start,
                "count": 1 + random.randrange(
                    test.get("chronos_max_count", 99)),
                "duration": duration,
                "epsilon": epsilon,
                "interval": interval,
            },
        }

    return g


def chronos_test(opts: dict) -> dict:
    from ..testlib import noop_test

    db_ = ChronosDB(archive_url=opts.get("archive_url"))
    test = noop_test()
    test.update(opts)
    # component killers per stack role (the tidb/NDB surface): kill
    # one node's zookeeper/mesos daemon while the rest keep serving
    extra = {
        f"kill-{role}": (lambda role=role: cmn.ComponentKiller(
            db_, role))
        for role in ("zk", "mesos-master", "mesos-slave", "chronos")
    }
    test.update(
        {
            "name": "chronos",
            "os": osdist.debian,
            "db": db_,
            "client": ChronosClient(),
            "nemesis": cmn.pick_nemesis(db_, opts, extra=extra),
            "generator": gen.phases(
                gen.time_limit(
                    opts.get("time_limit", 120),
                    gen.nemesis(
                        gen.start_stop(20, 20),
                        gen.stagger(opts.get("stagger", 5),
                                    add_job_gen()),
                    ),
                ),
                gen.nemesis(gen.once({"type": "info", "f": "stop"})),
                gen.sleep(opts.get("quiesce", 15)),
                ready_gated_final(
                    db_,
                    gen.clients(gen.once(
                        {"type": "invoke", "f": "read"})),
                    opts),
            ),
            "checker": checker_mod.compose({
                "perf": checker_mod.perf_checker(),
                "chronos": ChronosChecker(),
            }),
        }
    )
    return test


COMPONENT_NEMESES = ("kill-zk", "kill-mesos-master",
                     "kill-mesos-slave", "kill-chronos")


def _opt_spec(p) -> None:
    cmn.nemesis_opt(p, names=cmn.NEMESIS_NAMES + COMPONENT_NEMESES)
    p.add_argument("--archive-url", dest="archive_url", default=None)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(chronos_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
