"""Per-database test suites (reference: the per-DB projects, SURVEY.md
§1 L9 / §2.1; the port's copy of `jepsen_tpu/dbs/`, sixteen suites so far).

Each suite module supplies, like its reference counterpart:
  - a DB implementation (install/start/teardown through the control plane)
  - a Client with the suite's exception-determinacy taxonomy
  - op generators and a `*_test(opts)` test-map constructor
  - a `main()` built from cli.single_test_cmd + cli.serve_cmd

A suite runs against a real cluster over SSH, or on one machine against
its in-repo protocol simulator through the same code paths (install
archive → daemon → wire protocol), one process a node.
"""

#: suite-module registry: the suites the port has, and their modules
SUITES = {
    "aerospike": "jepsen_tpu_torch.dbs.aerospike",
    "cockroachdb": "jepsen_tpu_torch.dbs.cockroach_workloads",
    "consul": "jepsen_tpu_torch.dbs.consul",
    "dgraph": "jepsen_tpu_torch.dbs.dgraph",
    "disque": "jepsen_tpu_torch.dbs.disque",
    "elasticsearch": "jepsen_tpu_torch.dbs.elasticsearch",
    "etcd": "jepsen_tpu_torch.dbs.etcd",
    "hazelcast": "jepsen_tpu_torch.dbs.hazelcast",
    "logcabin": "jepsen_tpu_torch.dbs.logcabin",
    "mongodb-rocks": "jepsen_tpu_torch.dbs.mongodb",
    "mongodb-smartos": "jepsen_tpu_torch.dbs.mongodb",
    "postgres-rds": "jepsen_tpu_torch.dbs.postgres_rds",
    "rabbitmq": "jepsen_tpu_torch.dbs.rabbitmq",
    "raftis": "jepsen_tpu_torch.dbs.raftis",
    "rethinkdb": "jepsen_tpu_torch.dbs.rethinkdb",
    "zookeeper": "jepsen_tpu_torch.dbs.zookeeper",
}
