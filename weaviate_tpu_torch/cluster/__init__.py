"""The port's copy of the sharding state (reference usecases/sharding, the
virtual-shard ring). Membership, the cluster API and replication are not
ported yet (ROADMAP queue 1 item 15)."""

from weaviate_tpu_torch.cluster.sharding import ShardingState, ShardingConfig

__all__ = ["ShardingState", "ShardingConfig"]
