"""Distribution: sharding state, membership, cluster API, replication (the
port's copy of `weaviate_tpu/cluster/`).

Reference: usecases/sharding (virtual-shard ring), usecases/cluster
(membership + schema 2PC), usecases/replica (per-op 2PC), and
adapters/handlers/rest/clusterapi (internal node-to-node HTTP). The wire
formats are the JAX package's, so port nodes and JAX nodes form one
cluster; a port node keeps its shards on its own device (`ClusterNode`'s
`device`).
"""

from weaviate_tpu_torch.cluster.sharding import ShardingState, ShardingConfig

__all__ = [
    "ShardingState",
    "ShardingConfig",
    "ClusterNode",
    "ClusterState",
]


def __getattr__(name):
    # lazy: ClusterNode pulls in the whole db/schema graph
    if name == "ClusterNode":
        from weaviate_tpu_torch.cluster.node import ClusterNode

        return ClusterNode
    if name == "ClusterState":
        from weaviate_tpu_torch.cluster.membership import ClusterState

        return ClusterState
    raise AttributeError(name)
