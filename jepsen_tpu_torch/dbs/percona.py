"""Percona XtraDB Cluster test suite: bank, sets, and dirty-reads
workloads over the MySQL protocol (reference:
percona/src/jepsen/percona.clj:1-362 and
percona/dirty_reads.clj; clients live in mysql_common.py — Percona's
suite is the Galera pattern on Percona's distribution).

The port's copy of `jepsen_tpu/dbs/percona.py`: its workloads are checked
on the host and reach no kernel. `mysql_sim.local_test_fn` runs the
suite on simulated nodes over `LocalRemote`."""

from __future__ import annotations

from .. import cli
from .mysql_common import make_sql_suite


def _daemon_args(suite, test, node) -> list:
    # the first node bootstraps a NEW cluster (empty gcomm://, the
    # --wsrep-new-cluster semantics of galera.clj:110-111); the rest
    # join it — without this a fresh real cluster can never form a
    # primary component
    primary = test["nodes"][0]
    gcomm = ("" if node == primary
             else ",".join(suite.host(test, n) for n in test["nodes"]
                           if n != node))
    return ["--port", str(suite.port(test, node)),
            f"--wsrep-cluster-address=gcomm://{gcomm}"]


suite, PerconaDB, workloads, percona_test, _opt_spec = make_sql_suite(
    "percona", 3306, "mysqld", _daemon_args,
    ("bank", "sets", "dirty-reads"))


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(percona_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
