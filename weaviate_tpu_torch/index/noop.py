"""Null vector index for classes with skip=true (reference: vector/noop)."""

from __future__ import annotations

from weaviate_tpu_torch.index.interface import VectorIndex


class NoopIndex(VectorIndex):
    def __init__(self, config=None):
        self.config = config

    def add(self, doc_id, vector):
        pass

    def delete(self, *doc_ids):
        pass

    def search_by_vector(self, vector, k, allow_list=None):
        raise ValueError(
            "class is configured with skip=true: vector search is not possible"
        )

    def search_by_vector_distance(self, vector, target_distance, max_limit, allow_list=None):
        raise ValueError(
            "class is configured with skip=true: vector search is not possible"
        )

    def update_user_config(self, updated):
        self.config = updated

    def flush(self):
        pass

    def drop(self):
        pass

    def shutdown(self):
        pass
