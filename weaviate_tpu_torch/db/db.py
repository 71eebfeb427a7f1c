# The port's copy of weaviate_tpu/db/db.py, its imports pointed at the port.
"""DB: the per-node database root — class name -> ClassIndex.

Reference: adapters/repos/db/repo.go (db.DB) + migrator.go (schema-change ->
storage ops). The reference's central batch job queue + worker pool
(repo.go:110-117) has no analog here because the TPU write path is already
batch-first (vectors land as one device write per chunk, not one job per
vector).

The port's DB differs in one keyword: `device`, resolved here (so a DB
asked for the card raises at once when torch sees none) and passed through
every ClassIndex to its Shards. The default is the CUDA card; pass
device="cpu" to run on the CPU.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.cluster.sharding import ShardingConfig, ShardingState
from weaviate_tpu_torch.db.class_index import ClassIndex
from weaviate_tpu_torch.entities.schema import ClassDef


class DB:
    def __init__(
        self,
        root_path: str,
        node_name: str = "node-0",
        remote_client=None,
        metrics=None,
        node_names: Optional[list[str]] = None,
        replicator=None,
        finder=None,
        store_opts: Optional[dict] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.root_path = root_path
        self.node_name = node_name
        self.node_names = node_names or [node_name]
        self.remote = remote_client
        self.replicator = replicator
        self.finder = finder
        self.metrics = metrics
        self.store_opts = store_opts  # LSM tuning (memtable size, idle flush)
        self.indexes: dict[str, ClassIndex] = {}
        self._lock = threading.RLock()
        os.makedirs(root_path, exist_ok=True)

    # -- migrator (migrator.go) ----------------------------------------------

    def add_class(
        self,
        class_def: ClassDef,
        vector_config,
        sharding_state: Optional[ShardingState] = None,
    ) -> ClassIndex:
        with self._lock:
            if class_def.name in self.indexes:
                return self.indexes[class_def.name]
            if sharding_state is None:
                cfg = ShardingConfig.from_dict(
                    getattr(class_def, "sharding_config", None), len(self.node_names)
                )
                sharding_state = ShardingState(class_def.name, cfg, self.node_names)
            idx = ClassIndex(
                class_def,
                vector_config,
                self.root_path,
                sharding_state=sharding_state,
                node_name=self.node_name,
                remote_client=self.remote,
                metrics=self.metrics,
                invert_cfg=getattr(class_def, "inverted_index_config", None),
                replicator=self.replicator,
                finder=self.finder,
                store_opts=self.store_opts,
                device=self.device,
            )
            self.indexes[class_def.name] = idx
            return idx

    def drop_class(self, class_name: str) -> None:
        with self._lock:
            idx = self.indexes.pop(class_name, None)
            if idx is not None:
                idx.drop()

    def update_class(self, class_def: ClassDef) -> None:
        idx = self.indexes.get(class_def.name)
        if idx is not None:
            idx.update_schema(class_def)

    def update_vector_config(self, class_name: str, cfg) -> None:
        idx = self.indexes.get(class_name)
        if idx is not None:
            idx.update_vector_config(cfg)

    def update_sharding_state(self, class_name: str, state: ShardingState) -> None:
        """Adopt a rebuilt sharding state (replication-factor change)."""
        idx = self.indexes.get(class_name)
        if idx is not None:
            idx.sharding_state = state

    def set_replication(self, replicator, finder) -> None:
        """Late-bind the replication coordinator (it needs the in-process
        cluster API facade, which needs this DB — configure-api wiring
        order, configure_api.go:105)."""
        self.replicator = replicator
        self.finder = finder
        for idx in self.indexes.values():
            idx.replicator = replicator
            idx.finder = finder

    # -- access --------------------------------------------------------------

    def get_index(self, class_name: str) -> Optional[ClassIndex]:
        return self.indexes.get(class_name)

    def object_by_uuid_any_class(self, uuid: str, include_vector: bool = True):
        """Cross-class lookup (legacy /v1/objects/{id} without class)."""
        for idx in self.indexes.values():
            obj = idx.object_by_uuid(uuid, include_vector)
            if obj is not None:
                return obj, idx
        return None, None

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        for idx in list(self.indexes.values()):
            idx.flush()

    def shutdown(self) -> None:
        for idx in list(self.indexes.values()):
            idx.shutdown()

    def post_startup(self) -> None:
        for idx in list(self.indexes.values()):
            idx.post_startup()

    def reindex_missing_filterable(self) -> dict[str, dict[str, int]]:
        """Startup reindexer (INDEX_MISSING_TEXT_FILTERABLE_AT_STARTUP):
        backfill filterable postings on every local shard. -> per-class
        {prop: docs} for what was rebuilt."""
        out: dict[str, dict[str, int]] = {}
        for idx in list(self.indexes.values()):
            merged: dict[str, int] = {}
            for shard in idx.shards.values():
                for prop, n in shard.reindex_missing_filterable().items():
                    merged[prop] = merged.get(prop, 0) + n
            if merged:
                out[idx.class_name] = merged
        return out
