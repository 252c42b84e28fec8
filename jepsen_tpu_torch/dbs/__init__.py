"""Per-database test suites (reference: the per-DB projects, SURVEY.md
§1 L9 / §2.1; the port's copy of `jepsen_tpu/dbs/`, all 23 of its
suites).

Each suite module supplies, like its reference counterpart:
  - a DB implementation (install/start/teardown through the control plane)
  - a Client with the suite's exception-determinacy taxonomy
  - op generators and a `*_test(opts)` test-map constructor
  - a `main()` built from cli.single_test_cmd + cli.serve_cmd

A suite runs against a real cluster over SSH, or on one machine against
its in-repo protocol simulator through the same code paths (install
archive → daemon → wire protocol), one process a node.
"""

#: suite-module registry: every suite of the JAX package, and the port's
#: module for it
SUITES = {
    "aerospike": "jepsen_tpu_torch.dbs.aerospike",
    "chronos": "jepsen_tpu_torch.dbs.chronos",
    "cockroachdb": "jepsen_tpu_torch.dbs.cockroach_workloads",
    "consul": "jepsen_tpu_torch.dbs.consul",
    "crate": "jepsen_tpu_torch.dbs.crate",
    "dgraph": "jepsen_tpu_torch.dbs.dgraph",
    "disque": "jepsen_tpu_torch.dbs.disque",
    "elasticsearch": "jepsen_tpu_torch.dbs.elasticsearch",
    "etcd": "jepsen_tpu_torch.dbs.etcd",
    "galera": "jepsen_tpu_torch.dbs.galera",
    "hazelcast": "jepsen_tpu_torch.dbs.hazelcast",
    "logcabin": "jepsen_tpu_torch.dbs.logcabin",
    "mongodb-rocks": "jepsen_tpu_torch.dbs.mongodb",
    "mongodb-smartos": "jepsen_tpu_torch.dbs.mongodb",
    "mysql-cluster": "jepsen_tpu_torch.dbs.mysql_cluster",
    "percona": "jepsen_tpu_torch.dbs.percona",
    "postgres-rds": "jepsen_tpu_torch.dbs.postgres_rds",
    "rabbitmq": "jepsen_tpu_torch.dbs.rabbitmq",
    "raftis": "jepsen_tpu_torch.dbs.raftis",
    "rethinkdb": "jepsen_tpu_torch.dbs.rethinkdb",
    "robustirc": "jepsen_tpu_torch.dbs.robustirc",
    "tidb": "jepsen_tpu_torch.dbs.tidb",
    "zookeeper": "jepsen_tpu_torch.dbs.zookeeper",
}
