"""The shard over the port's vector index (reference
adapters/repos/db/shard.go): LSM object store, docID counter, inverted
index and vector index. The class index and the DB above it are not
ported yet."""

from weaviate_tpu_torch.db.shard import SearchResult, Shard

__all__ = ["Shard", "SearchResult"]
