"""TiDB test suite: register, bank, and sets workloads over the MySQL
protocol (reference: tidb/src/tidb/{core,db,register,
bank,sets,sql}.clj; clients live in mysql_common.py).

The deployment is the real TRIPLE: every node runs pd-server (placement
driver, client port 2379 / peer port 2380), tikv-server (storage,
20160), and tidb-server (SQL, 4000), brought up in order — pd on every
node, then tikv once the pd quorum answers, then tidb (tidb/db.clj:
14-223; the reference synchronizes between stages with fixed sleeps,
here each stage polls every node's ports until ready). Each component
has its own pid/log, and the kill-pd / kill-tikv / kill-tidb nemeses
target them independently — a tikv kill must leave the node's
tidb-server alive (replicated reads keep serving), which
tests/test_torch_mysql_suites.py exercises end-to-end.

Hermetic runs install dbs/tidb_sim's archive: pd/tikv as role
placeholders with real pids/ports/logs, tidb as the MySQL-protocol sim.

The port's copy of `jepsen_tpu/dbs/tidb.py`. The register workload's
checker is `linearizable(device=...)` under `models.CASRegister()`
(`mysql_common.make_sql_suite`), which reaches K1 (`ops/csrc/wgl_vec.cu`)
on the card; bank and sets are checked on the host.
`tidb_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`.
"""

from __future__ import annotations

from .. import cli
from ..control import util as cu
from .mysql_common import make_sql_suite

PD_CLIENT_PORT = 2379
PD_PEER_PORT = 2380
TIKV_PORT = 20160

ROLES = ("pd", "tikv", "tidb")
_ROLE_TAG = {"pd": "jepsen-pd", "tikv": "jepsen-kv", "tidb": "jepsen-db"}
_ROLE_BIN = {"pd": "pd-server", "tikv": "tikv-server",
             "tidb": "tidb-server"}


def _make_db(suite):
    from .common import MultiDaemonDB

    class TidbDB(MultiDaemonDB):
        """pd/tikv/tidb triple per node, ordered readiness-gated
        bring-up (tidb/db.clj:76-223). The base-class single-daemon
        surface (binary/pid_name/start) points at the SQL daemon, so
        the shared start-kill/hammer-time nemeses keep working — they
        hit tidb-server while pd and tikv stay up."""

        binary = "tidb-server"
        log_name = "jepsen-db.log"
        pid_name = "jepsen-db.pid"

        ROLES = ROLES
        ROLE_TAG = _ROLE_TAG
        ROLE_BIN = _ROLE_BIN
        # reference stop! order: tidb, tikv, pd (db.clj:123-128)
        STOP_ORDER = ("tidb", "tikv", "pd")

        def __init__(self, archive_url=None, ready_timeout=60.0):
            super().__init__(suite, archive_url, ready_timeout)

        # ---- per-role addressing ----

        def role_port(self, test, node, role) -> int:
            if role == "tidb":
                return suite.port(test, node)
            ports = suite.cfg(test).get(f"{role}_ports")
            if ports:
                return ports[node]
            return PD_CLIENT_PORT if role == "pd" else TIKV_PORT

        def pd_peer_port(self, test, node) -> int:
            ports = suite.cfg(test).get("pd_peer_ports")
            return ports[node] if ports else PD_PEER_PORT

        def pd_endpoints(self, test) -> str:
            return ",".join(
                f"{suite.host(test, n)}:{self.role_port(test, n, 'pd')}"
                for n in test["nodes"])

        def role_args(self, test, node, role) -> list:
            d = suite.dir(test, node)
            host = suite.host(test, node)
            if role == "pd":
                i = list(test["nodes"]).index(node) + 1
                initial = ",".join(
                    f"pd{k + 1}=http://{suite.host(test, n)}:"
                    f"{self.pd_peer_port(test, n)}"
                    for k, n in enumerate(test["nodes"]))
                cport = self.role_port(test, node, "pd")
                return [
                    "--name", f"pd{i}",
                    "--data-dir", f"{d}/pd{i}",
                    "--client-urls", f"http://0.0.0.0:{cport}",
                    "--peer-urls",
                    f"http://0.0.0.0:{self.pd_peer_port(test, node)}",
                    "--advertise-client-urls", f"http://{host}:{cport}",
                    "--advertise-peer-urls",
                    f"http://{host}:{self.pd_peer_port(test, node)}",
                    "--initial-cluster", initial,
                ]
            if role == "tikv":
                i = list(test["nodes"]).index(node) + 1
                kport = self.role_port(test, node, "tikv")
                return [
                    "--pd", self.pd_endpoints(test),
                    "--addr", f"0.0.0.0:{kport}",
                    "--advertise-addr", f"{host}:{kport}",
                    "--data-dir", f"{d}/tikv{i}",
                ]
            return ["--port", str(suite.port(test, node)),
                    "--store", "tikv",
                    "--path", self.pd_endpoints(test)]

        # base-class hook: start() launches self.binary with these —
        # identical to start_component(..., "tidb")
        def daemon_args(self, test, node) -> list:
            return self.role_args(test, node, "tidb")

        # ---- ordered bring-up (db.clj:76-223) ----

        def setup(self, test, node) -> None:
            remote = test["remote"]
            d = suite.dir(test, node)
            cu.install_archive(remote, node, self.resolve_url(test), d,
                               sudo=suite.sudo(test))
            self.start_component(test, node, "pd")
            self._await_ports(test, "pd", self.ready_timeout)
            self.start_component(test, node, "tikv")
            self._await_ports(test, "tikv", self.ready_timeout)
            self.start_component(test, node, "tidb")
            self.await_ready(test, node)

        def probe_ready(self, test, node) -> bool:
            from .mysql_common import probe_mysql_ready

            return probe_mysql_ready(suite, test, node)

    return TidbDB


from .common import ComponentKiller  # noqa: E402 — shared with ndb

COMPONENT_NEMESES = ("kill-pd", "kill-tikv", "kill-tidb")


def _extra_nemeses(db) -> dict:
    return {
        f"kill-{role}": (lambda role=role: ComponentKiller(db, role))
        for role in ROLES
    }


def _daemon_args(suite, test, node) -> list:
    # retained for factory-API compatibility; the triple DB overrides
    # daemon_args with its per-role builder
    pd = ",".join(f"{suite.host(test, n)}:{PD_CLIENT_PORT}"
                  for n in test["nodes"])
    return ["--port", str(suite.port(test, node)),
            "--store", "tikv", "--path", pd]


suite, TidbDB, workloads, tidb_test, _opt_spec = make_sql_suite(
    "tidb", 4000, "tidb-server", _daemon_args,
    ("register", "bank", "sets"),
    db_cls=_make_db,
    extra_nemeses=_extra_nemeses,
    extra_nemesis_names=COMPONENT_NEMESES)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(tidb_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
