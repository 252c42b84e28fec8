"""MariaDB Galera Cluster test suite: bank, sets, and dirty-reads
workloads over the MySQL protocol (reference:
galera/src/jepsen/galera.clj:1-383 and
galera/dirty_reads.clj:1-120; clients live in mysql_common.py).

The real path installs a mariadb+galera archive whose mysqld is started
with a wsrep gcomm:// cluster address (galera.clj:34-73); the hermetic
path runs dbs/mysql_sim through the same daemon machinery.

The port's copy of `jepsen_tpu/dbs/galera.py`: its workloads are checked
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


suite, GaleraDB, workloads, galera_test, _opt_spec = make_sql_suite(
    "galera", 3306, "mysqld", _daemon_args,
    ("bank", "sets", "dirty-reads"))


def main(argv=None) -> None:
    cli.main(
        {**cli.single_test_cmd(galera_test, opt_spec=_opt_spec),
         **cli.serve_cmd()},
        argv,
    )


if __name__ == "__main__":
    main()
