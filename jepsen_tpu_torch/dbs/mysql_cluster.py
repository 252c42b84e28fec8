"""MySQL Cluster (NDB) test suite: bank and sets workloads over the
MySQL protocol (reference:
mysql-cluster/src/jepsen/mysql_cluster.clj:1-227;
clients live in mysql_common.py).

The deployment is the real ROLE SPLIT: ndb_mgmd (management, port
1186) on every node, ndbd (storage) on the FIRST FOUR nodes only
(mysql_cluster.clj:100-103's ndbd-nodes), and mysqld (SQL, 3306) on
every node — with the reference's node-id bands (mgmd +1, ndbd +11,
mysqld +21; mysql_cluster.clj:53-73) and distinct data dirs, brought
up in order: mgmd everywhere, then ndbd once the management quorum
answers, then mysqld (the reference synchronizes between stages;
here each stage polls ports). The kill-mgmd / kill-ndbd / kill-mysqld
nemeses target roles independently — killing an ndbd must leave the
node's mysqld serving, which tests/test_torch_mysql_suites.py
exercises.

Hermetic runs install dbs/mysql_cluster_sim's archive: mgmd/ndbd as
role placeholders with real pids/ports/logs, mysqld as the
MySQL-protocol sim.

The port's copy of `jepsen_tpu/dbs/mysql_cluster.py`: its bank and sets
workloads are checked on the host and reach no kernel.
`mysql_cluster_sim.local_test_fn` runs the suite on simulated nodes over
`LocalRemote`.
"""

from __future__ import annotations

from .. import cli
from ..control import util as cu
from .mysql_common import make_sql_suite

MGMD_PORT = 1186
NDBD_PORT = 2202
# reference node-id bands (mysql_cluster.clj:57-73)
MGMD_ID_OFFSET = 1
NDBD_ID_OFFSET = 11
MYSQLD_ID_OFFSET = 21
NDBD_NODE_COUNT = 4  # ndbd runs on the first four nodes only

ROLES = ("mgmd", "ndbd", "mysqld")
_ROLE_TAG = {"mgmd": "jepsen-mgmd", "ndbd": "jepsen-ndbd",
             "mysqld": "jepsen-mysqld"}
_ROLE_BIN = {"mgmd": "ndb_mgmd", "ndbd": "ndbd", "mysqld": "mysqld"}
_ROLE_OFFSET = {"mgmd": MGMD_ID_OFFSET, "ndbd": NDBD_ID_OFFSET,
                "mysqld": MYSQLD_ID_OFFSET}


def _make_db(suite):
    from .common import MultiDaemonDB

    class MysqlClusterDB(MultiDaemonDB):
        """mgmd/ndbd/mysqld per node with the reference's ordered
        bring-up (mysql_cluster.clj:140-199). The base-class
        single-daemon surface points at mysqld, so the shared
        start-kill/hammer-time nemeses hit the SQL daemon while the
        management and storage roles stay up."""

        binary = "mysqld"
        log_name = "jepsen-mysqld.log"
        pid_name = "jepsen-mysqld.pid"

        ROLES = ROLES
        ROLE_TAG = _ROLE_TAG
        ROLE_BIN = _ROLE_BIN
        # reference stop order: mysqld, ndbd, mgmd
        # (mysql_cluster.clj:201-207)
        STOP_ORDER = ("mysqld", "ndbd", "mgmd")

        def __init__(self, archive_url=None, ready_timeout=60.0):
            super().__init__(suite, archive_url, ready_timeout)

        # ---- role topology ----

        def node_id(self, test, node, role) -> int:
            return _ROLE_OFFSET[role] + list(test["nodes"]).index(node)

        def role_nodes(self, test, role) -> list:
            if role == "ndbd":
                return list(test["nodes"])[:NDBD_NODE_COUNT]
            return list(test["nodes"])

        def role_port(self, test, node, role) -> int:
            if role == "mysqld":
                return suite.port(test, node)
            ports = suite.cfg(test).get(f"{role}_ports")
            if ports:
                return ports[node]
            return MGMD_PORT if role == "mgmd" else NDBD_PORT

        def connect_string(self, test) -> str:
            return ",".join(
                f"{suite.host(test, n)}:{self.role_port(test, n, 'mgmd')}"
                for n in test["nodes"])

        def role_args(self, test, node, role) -> list:
            d = suite.dir(test, node)
            nid = self.node_id(test, node, role)
            port = self.role_port(test, node, role)
            if role == "mgmd":
                return [f"--ndb-nodeid={nid}",
                        "--port", str(port),
                        "--configdir", f"{d}/cluster"]
            if role == "ndbd":
                return [f"--ndb-nodeid={nid}",
                        "--port", str(port),
                        f"--ndb-connectstring={self.connect_string(test)}",
                        "--datadir", f"{d}/data"]
            return ["--port", str(port),
                    f"--ndb-nodeid={nid}",
                    f"--ndb-connectstring={self.connect_string(test)}",
                    "--datadir", f"{d}/mysql"]

        def daemon_args(self, test, node) -> list:
            return self.role_args(test, node, "mysqld")

        # ---- ordered bring-up (mysql_cluster.clj:140-199) ----

        def setup(self, test, node) -> None:
            remote = test["remote"]
            d = suite.dir(test, node)
            cu.install_archive(remote, node, self.resolve_url(test), d,
                               sudo=suite.sudo(test))
            self.start_component(test, node, "mgmd")
            self._await_ports(test, "mgmd", self.ready_timeout)
            if node in self.role_nodes(test, "ndbd"):
                self.start_component(test, node, "ndbd")
            self._await_ports(test, "ndbd", self.ready_timeout)
            self.start_component(test, node, "mysqld")
            self.await_ready(test, node)

        def probe_ready(self, test, node) -> bool:
            from .mysql_common import probe_mysql_ready

            return probe_mysql_ready(suite, test, node)

    return MysqlClusterDB


from .common import ComponentKiller  # noqa: E402 — shared with tidb

COMPONENT_NEMESES = ("kill-mgmd", "kill-ndbd", "kill-mysqld")


def _extra_nemeses(db) -> dict:
    return {
        f"kill-{role}": (lambda role=role: ComponentKiller(db, role))
        for role in ROLES
    }


def _daemon_args(suite, test, node) -> list:
    # retained for factory-API compatibility; the role DB overrides
    # daemon_args with its per-role builder
    mgmt = suite.host(test, test["nodes"][0])
    return ["--port", str(suite.port(test, node)),
            f"--ndb-connectstring={mgmt}"]


suite, MysqlClusterDB, workloads, mysql_cluster_test, _opt_spec = \
    make_sql_suite("mysql-cluster", 3306, "mysqld", _daemon_args,
                   ("bank", "sets"),
                   db_cls=_make_db,
                   extra_nemeses=_extra_nemeses,
                   extra_nemesis_names=COMPONENT_NEMESES)


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(mysql_cluster_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
