"""The port's DB core (reference adapters/repos/db): db.DB (repo.go) ->
ClassIndex per class (index.go) -> Shard (shard.go) over the port's vector
index. Each takes a `device` keyword; the default is the CUDA card."""

from weaviate_tpu_torch.db.db import DB
from weaviate_tpu_torch.db.class_index import ClassIndex
from weaviate_tpu_torch.db.shard import Shard, SearchResult

__all__ = ["DB", "ClassIndex", "Shard", "SearchResult"]
