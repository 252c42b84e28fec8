"""Hermetic MySQL Cluster (NDB) archive: the mgmd/ndbd/mysqld ROLES.

The real deployment runs three process types with distinct node-id
bands and data dirs (mysql-cluster/src/jepsen/
mysql_cluster.clj:53-57,140-168): ndb_mgmd (management, port 1186),
ndbd (storage, on the first four nodes), and mysqld (SQL, 3306). The
archive mirrors that shape: `ndb_mgmd` and `ndbd` are role
placeholders (dbs/role_sim — real pids, ports, logs; kill/restart
targets), `mysqld` is the MySQL-protocol sim. All three share the same
state file, standing in for NDB's replicated storage.

The port's copy of `jepsen_tpu/dbs/mysql_cluster_sim.py`: its members
import nothing of `jepsen_tpu` (they load neither torch nor jax), each
launcher starts nothing when its daemon already runs on the node, and
it adds the recipe that runs the mysql-cluster suite on simulated nodes
on this machine (`local_cluster`, `local_test_fn`).
"""

from __future__ import annotations

from .simbase import build_multi_sim_archive, sim_cluster, sim_test_fn

#: the settings of the management and storage daemons' ports (the SQL
#: port is the suite's "ports")
ROLE_PORTS = ("mgmd_ports", "ndbd_ports")


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """The role split's archive. Starting a daemon that already runs on
    its node does nothing, as for a real binary under
    start-stop-daemon."""
    return build_multi_sim_archive(
        dest, "mysql-cluster-sim",
        {
            "ndb_mgmd": "jepsen_tpu_torch.dbs.role_sim",
            "ndbd": "jepsen_tpu_torch.dbs.role_sim",
            "mysqld": "jepsen_tpu_torch.dbs.mysql_sim",
        },
        data_path, mean_latency=mean_latency, python=python,
        pidfile={"ndb_mgmd": "jepsen-mgmd.pid", "ndbd": "jepsen-ndbd.pid",
                 "mysqld": "jepsen-mysqld.pid"},
    )


def local_cluster(root: str, nodes, ports: dict | None = None,
                  role_ports: dict | None = None) -> dict:
    """The test-map entries that run the mysql-cluster suite against
    simulated nodes on this machine (`simbase.sim_cluster`, settings
    under "mysql-cluster"): each node's SQL port (`ports`), and its mgmd
    and ndbd ports (`role_ports`, {setting of ROLE_PORTS: {node:
    port}}); free ports where not given."""
    return sim_cluster(root, nodes, ports, "mysql-cluster",
                       "mysql-cluster-sim", build_archive, roles=ROLE_PORTS,
                       role_ports=role_ports)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `mysql_cluster.mysql_cluster_test` on a `local_cluster`
    (`simbase.sim_test_fn`): mgmd, ndbd (on the first four nodes) and
    mysqld brought up in that order, the suite's nemesis on the no-op
    network (partitions recorded and healed), the kill-mgmd/kill-ndbd/
    kill-mysqld and start-kill nemeses acting on the node's daemons by
    pidfile; sudo none; fs-break refused."""
    def make(opts):
        from . import mysql_cluster

        return mysql_cluster.mysql_cluster_test(opts)

    return sim_test_fn(cluster, "mysql-cluster", make)
