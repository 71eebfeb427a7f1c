"""The VectorIndex seam (the port's own copy of
`weaviate_tpu/index/interface.py`).

Reference: adapters/repos/db/vector_index.go:23-40. Everything above the
index passes (vector, k, allowList) down and gets (ids, dists) back, with
a batched twin (`search_by_vectors`) because the device path is
batch-first.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import numpy as np


class AllowList(abc.ABC):
    """Filter result container (reference helpers/allow_list.go:19-29)."""

    @abc.abstractmethod
    def contains(self, doc_id: int) -> bool: ...

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def to_array(self) -> np.ndarray:
        """Sorted uint64 array of allowed doc ids."""

    @abc.abstractmethod
    def contains_array(self, doc_ids: np.ndarray) -> np.ndarray:
        """Vectorized membership test -> bool array (device mask building)."""


class VectorIndex(abc.ABC):
    """Per-shard vector index (vector_index.go:23-40)."""

    # -- metric plumbing shared by the concrete indexes (hnsw metrics.go
    # parity); relies on self.shard_path / self.shard_name / self.metrics,
    # which every persistent index sets in __init__ --------------------------

    def _metric_labels(self) -> tuple[str, str]:
        """(class_name, shard_name). The owning Shard sets `class_name`
        after construction so labels match the shard-level families exactly
        (the on-disk dir is lowercased and would mislabel); the path-derived
        value is only the standalone-index fallback."""
        import os

        path = getattr(self, "shard_path", "") or ""
        cls = getattr(self, "class_name", "") or (
            os.path.basename(os.path.dirname(path.rstrip("/"))) or "")
        return cls, getattr(self, "shard_name", "") or os.path.basename(path)

    def _obs_index(self, op: str, step: str, t0: float, ops: int = 0) -> None:
        import time

        m = getattr(self, "metrics", None)
        if m is None:
            return
        cls, shard = self._metric_labels()
        m.vector_index_durations.labels(op, step, cls, shard).observe(
            (time.perf_counter() - t0) * 1000.0)
        if ops:
            m.vector_index_ops.labels(op, cls, shard).inc(ops)

    @abc.abstractmethod
    def add(self, doc_id: int, vector: np.ndarray) -> None: ...

    def add_batch(self, doc_ids: Sequence[int], vectors: np.ndarray) -> None:
        for d, v in zip(doc_ids, vectors):
            self.add(int(d), v)

    @abc.abstractmethod
    def delete(self, *doc_ids: int) -> None: ...

    @abc.abstractmethod
    def search_by_vector(
        self, vector: np.ndarray, k: int, allow_list: Optional[AllowList] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (doc_ids uint64 [<=k], dists float32 [<=k]) sorted ascending."""

    def search_by_vectors(
        self, vectors: np.ndarray, k: int, allow_list: Optional[AllowList] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN [B, D] -> ([B, k] ids, [B, k] dists); default loops."""
        ids, ds = [], []
        for v in vectors:
            i, d = self.search_by_vector(v, k, allow_list)
            pad = k - len(i)
            if pad:
                # sentinel = uint64 max; consumers treat dist==inf as absent
                i = np.concatenate([i, np.full(pad, np.iinfo(np.uint64).max, np.uint64)])
                d = np.concatenate([d, np.full(pad, np.inf, np.float32)])
            ids.append(i)
            ds.append(d)
        return np.stack(ids), np.stack(ds)

    @abc.abstractmethod
    def search_by_vector_distance(
        self,
        vector: np.ndarray,
        target_distance: float,
        max_limit: int,
        allow_list: Optional[AllowList] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """All results within target_distance (search.go:90-157 semantics)."""

    @abc.abstractmethod
    def update_user_config(self, updated) -> None: ...

    @abc.abstractmethod
    def flush(self) -> None:
        """Flush WAL/commit-log state to disk."""

    @abc.abstractmethod
    def drop(self) -> None: ...

    @abc.abstractmethod
    def shutdown(self) -> None: ...

    def post_startup(self) -> None:
        """Prefill device/cache state after restore (startup.go:169-174)."""

    def list_files(self) -> list[str]:
        """Files to include in a backup (hnsw/backup.go ListFiles)."""
        return []

    def contains(self, doc_id: int) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def distancer_name(self) -> str:
        return "l2-squared"

    def compressed(self) -> bool:
        return False
