"""Hermetic tidb cluster archive: the pd/tikv/tidb TRIPLE.

The real deployment runs three daemons per node with ordered bring-up
(tidb/src/tidb/db.clj:14-223: pd quorum, then tikv,
then tidb). The archive mirrors that shape: `pd-server` and
`tikv-server` are role placeholders (dbs/role_sim — real pids, ports,
logs; kill/restart targets), `tidb-server` is the MySQL-protocol sim
(dbs/mysql_sim) that actually serves SQL. All three share the same
state file, standing in for tikv's replicated store.

The port's copy of `jepsen_tpu/dbs/tidb_sim.py`: its members import
nothing of `jepsen_tpu` (they load neither torch nor jax), each
launcher starts nothing when its daemon already runs on the node, and
it adds the recipe that runs the tidb suite on simulated nodes on this
machine (`local_cluster`, `local_test_fn`).
"""

from __future__ import annotations

from .simbase import build_multi_sim_archive, sim_cluster, sim_test_fn

#: the settings of the triple's other daemons' ports (the SQL port is
#: the suite's "ports")
ROLE_PORTS = ("pd_ports", "pd_peer_ports", "tikv_ports")


def build_archive(dest: str, data_path: str, mean_latency: float = 0.0,
                  python: str | None = None) -> str:
    """The triple's archive. Starting a daemon that already runs on its
    node does nothing, as for a real binary under start-stop-daemon:
    the kill nemeses' restarts start only the dead."""
    return build_multi_sim_archive(
        dest, "tidb-sim",
        {
            "pd-server": "jepsen_tpu_torch.dbs.role_sim",
            "tikv-server": "jepsen_tpu_torch.dbs.role_sim",
            "tidb-server": "jepsen_tpu_torch.dbs.mysql_sim",
        },
        data_path, mean_latency=mean_latency, python=python,
        pidfile={"pd-server": "jepsen-pd.pid",
                 "tikv-server": "jepsen-kv.pid",
                 "tidb-server": "jepsen-db.pid"},
    )


def local_cluster(root: str, nodes, ports: dict | None = None,
                  role_ports: dict | None = None) -> dict:
    """The test-map entries that run the tidb suite against simulated
    nodes on this machine (`simbase.sim_cluster`, settings under "tidb"):
    each node's SQL port (`ports`), and its pd client, pd peer and tikv
    ports (`role_ports`, {setting of ROLE_PORTS: {node: port}}), all on
    this machine's one address; free ports where not given."""
    return sim_cluster(root, nodes, ports, "tidb", "tidb-sim",
                       build_archive, roles=ROLE_PORTS,
                       role_ports=role_ports)


def local_test_fn(cluster: dict):
    """A test-map constructor for `cli.single_test_cmd` that runs
    `tidb.tidb_test` on a `local_cluster` (`simbase.sim_test_fn`): pd,
    tikv and tidb brought up in that order on every node, the suite's
    nemesis on the no-op network (partitions recorded and healed), the
    kill-pd/kill-tikv/kill-tidb and start-kill nemeses acting on the
    node's daemons by pidfile; sudo none; fs-break refused."""
    def make(opts):
        from . import tidb

        return tidb.tidb_test(opts)

    return sim_test_fn(cluster, "tidb", make)
