# The port's copy of weaviate_tpu/db/class_index.py, its imports pointed at the port.
"""ClassIndex: one logical index per class, scatter-gather over shards.

Reference: adapters/repos/db/index.go — holds the class's shards, routes
single-object ops by the sharding ring (PhysicalShard of the uuid), fans
searches out over all shards (errgroup fan-out index.go:967) and merges by
distance (index.go:1040). The `Incoming*` twins (clusterapi entry points for
remote shards) are exposed as the same methods here; the remote transport
(weaviate_tpu_torch.cluster) calls them on the owning node.

The port's ClassIndex differs in one keyword: `device`, passed to every
Shard it builds; None (the default) is the CUDA card.
"""

from __future__ import annotations

import os
import threading
import uuid as uuidlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.cluster.sharding import ShardingConfig, ShardingState
from weaviate_tpu_torch.db.shard import SearchResult, Shard
from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.entities.schema import ClassDef
from weaviate_tpu_torch.entities.storobj import StorObj


def _merge_shard_results(
    all_results: list, b: int, k: int
) -> list[list[SearchResult]]:
    """Per-query merge of shard result lists: concatenate, sort by distance
    (None last), truncate to k — shared by the sync and async search paths
    so their merge semantics cannot diverge."""
    merged: list[list[SearchResult]] = []
    for qi in range(b):
        rows: list[SearchResult] = []
        for shard_res in all_results:
            rows.extend(shard_res[qi])
        rows.sort(key=lambda r: (r.distance if r.distance is not None else np.inf))
        merged.append(rows[:k])
    return merged


class ClassIndex:
    def __init__(
        self,
        class_def: ClassDef,
        vector_config,
        root_path: str,
        sharding_state: Optional[ShardingState] = None,
        node_name: str = "node-0",
        remote_client=None,
        metrics=None,
        invert_cfg: Optional[dict] = None,
        replicator=None,
        finder=None,
        store_opts: Optional[dict] = None,
        device=None,
    ):
        self.class_def = class_def
        self.device = device  # passed to every Shard: None is the card
        self.class_name = class_def.name
        self.vector_config = vector_config
        self.path = os.path.join(root_path, class_def.name.lower())
        self.node_name = node_name
        self.remote = remote_client  # cluster transport for non-local shards
        self.replicator = replicator  # usecases/replica.Replicator (writes 2PC)
        self.finder = finder          # usecases/replica.Finder (consistent reads)
        self.metrics = metrics
        self.invert_cfg = invert_cfg
        self.store_opts = store_opts
        self.sharding_state = sharding_state or ShardingState(
            class_def.name, ShardingConfig(desired_count=1), [node_name]
        )
        self.shards: dict[str, Shard] = {}
        self._lock = threading.RLock()
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix=f"idx-{self.class_name}")
        for name in self.sharding_state.all_physical_shards():
            if self.sharding_state.is_local(name, node_name):
                self._load_shard(name)

    def _load_shard(self, name: str) -> Shard:
        s = Shard(
            name,
            os.path.join(self.path, name),
            self.class_def,
            self.vector_config,
            metrics=self.metrics,
            invert_cfg=self.invert_cfg,
            store_opts=self.store_opts,
            device=self.device,
        )
        self.shards[name] = s
        return s

    # -- routing -------------------------------------------------------------

    def shard_for(self, uuid: str) -> str:
        return self.sharding_state.physical_shard(uuidlib.UUID(uuid).bytes)

    def _local_shard(self, name: str) -> Optional[Shard]:
        return self.shards.get(name)

    def _group_by_shard(self, uuids: Sequence[str]) -> dict[str, list[int]]:
        groups: dict[str, list[int]] = {}
        for i, u in enumerate(uuids):
            groups.setdefault(self.shard_for(u), []).append(i)
        return groups

    def _replicated(self, shard_name: str) -> bool:
        """True when the shard has >1 replica and a replication coordinator
        is wired — writes then take the 2PC path, reads the Finder path."""
        return (
            self.replicator is not None
            and len(self.sharding_state.belongs_to_nodes(shard_name)) > 1
        )

    # -- single-object ops (index.go putObject / objectByID / deleteObject) --

    def put_object(self, obj: StorObj, cl: Optional[str] = None) -> StorObj:
        name = self.shard_for(obj.uuid)
        if self._replicated(name):
            times = self.replicator.put_object(self.class_name, name, obj, cl)
            if isinstance(times, dict):
                # report the stored times (creation preserved on update)
                obj.creation_time_unix = times.get("creationTimeUnix", obj.creation_time_unix)
                obj.last_update_time_unix = times.get("lastUpdateTimeUnix", obj.last_update_time_unix)
            return obj
        shard = self._local_shard(name)
        if shard is not None:
            return shard.put_object(obj)
        return self.remote.put_object(self.class_name, name, obj)

    def object_by_uuid(
        self, uuid: str, include_vector: bool = True, cl: Optional[str] = None
    ) -> Optional[StorObj]:
        name = self.shard_for(uuid)
        if self.finder is not None and len(self.sharding_state.belongs_to_nodes(name)) > 1:
            return self.finder.get_object(self.class_name, name, uuid, cl, include_vector)
        shard = self._local_shard(name)
        if shard is not None:
            return shard.object_by_uuid(uuid, include_vector)
        return self.remote.get_object(self.class_name, name, uuid, include_vector)

    def exists(self, uuid: str, cl: Optional[str] = None) -> bool:
        name = self.shard_for(uuid)
        if self.finder is not None and len(self.sharding_state.belongs_to_nodes(name)) > 1:
            return self.finder.exists(self.class_name, name, uuid, cl)
        shard = self._local_shard(name)
        if shard is not None:
            return shard.exists(uuid)
        return self.remote.exists(self.class_name, name, uuid)

    def delete_object(self, uuid: str, cl: Optional[str] = None) -> bool:
        name = self.shard_for(uuid)
        if self._replicated(name):
            return self.replicator.delete_object(self.class_name, name, uuid, cl)
        shard = self._local_shard(name)
        if shard is not None:
            return shard.delete_object(uuid)
        return self.remote.delete_object(self.class_name, name, uuid)

    def merge_object(
        self, uuid: str, props: dict, vector=None, cl: Optional[str] = None,
        meta: Optional[dict] = None
    ) -> Optional[StorObj]:
        name = self.shard_for(uuid)
        if self._replicated(name):
            ok = self.replicator.merge_object(
                self.class_name, name, uuid, props, vector, cl, meta=meta)
            return self.object_by_uuid(uuid, cl=cl) if ok else None
        shard = self._local_shard(name)
        if shard is not None:
            return shard.merge_object(uuid, props, vector, meta=meta)
        return self.remote.merge_object(
            self.class_name, name, uuid, props, vector, meta=meta)

    # -- batch (index.go:424 putObjectBatch, groups by PhysicalShard) --------

    def put_batch(
        self, objs: Sequence[StorObj], cl: Optional[str] = None
    ) -> list[Optional[Exception]]:
        groups = self._group_by_shard([o.uuid for o in objs])
        errs: list[Optional[Exception]] = [None] * len(objs)

        def run(name: str, idxs: list[int]):
            batch = [objs[i] for i in idxs]
            if self._replicated(name):
                try:
                    sub = self.replicator.put_batch(self.class_name, name, batch, cl)
                    sub = [RuntimeError(e) if e else None for e in sub]
                except Exception as e:  # noqa: BLE001 — per-batch fault isolation
                    sub = [e] * len(batch)
            else:
                shard = self._local_shard(name)
                if shard is not None:
                    sub = shard.put_batch(batch)
                else:
                    sub = self.remote.put_batch(self.class_name, name, batch)
            for i, e in zip(idxs, sub):
                errs[i] = e

        futs = [self._pool.submit(run, n, idxs) for n, idxs in groups.items()]
        for f in futs:
            f.result()
        return errs

    def delete_by_filter(
        self, flt: Optional[LocalFilter], dry_run: bool = False, cl: Optional[str] = None
    ) -> dict:
        """Batch delete (batch delete-by-filter REST op): -> per-uuid results."""
        results = []
        for name in self.sharding_state.all_physical_shards():
            shard = self._local_shard(name)
            if self._replicated(name):
                if shard is not None:
                    uuids = shard.find_uuids(flt)
                else:
                    uuids = [
                        r["id"]
                        for r in self.remote.delete_by_filter(self.class_name, name, flt, True)
                    ]
                for u in uuids:
                    if dry_run:
                        results.append({"id": u, "status": "DRYRUN"})
                    else:
                        ok = self.replicator.delete_object(self.class_name, name, u, cl)
                        results.append({"id": u, "status": "SUCCESS" if ok else "FAILED"})
            elif shard is not None:
                for u in shard.find_uuids(flt):
                    if dry_run:
                        results.append({"id": u, "status": "DRYRUN"})
                    else:
                        ok = shard.delete_object(u)
                        results.append({"id": u, "status": "SUCCESS" if ok else "FAILED"})
            elif self.remote is not None:
                results.extend(
                    self.remote.delete_by_filter(self.class_name, name, flt, dry_run)
                )
        return {"matches": len(results), "objects": results}

    # -- search (index.go:967 objectVectorSearch fan-out + merge) ------------

    def _all_shard_targets(self):
        """-> [(name, local_shard_or_None)] for every physical shard."""
        out = []
        for name in self.sharding_state.all_physical_shards():
            out.append((name, self._local_shard(name)))
        return out

    def single_local_shard(self):
        """The one local shard when this class is a single-local-shard
        layout — the layout the shard-level serving lanes (query coalescer,
        gRPC raw batch lane, async deferred hydration) require; None
        otherwise (multi-shard / remote layouts fan out per shard)."""
        targets = self._all_shard_targets()
        if len(targets) == 1 and targets[0][1] is not None:
            return targets[0][1]
        return None

    def object_vector_search(
        self,
        vectors: np.ndarray,
        k: int,
        flt: Optional[LocalFilter] = None,
        target_distance: Optional[float] = None,
        include_vector: bool = False,
    ) -> list[list[SearchResult]]:
        """Batched scatter-gather: every shard scores the whole query batch in
        one device dispatch; per-query merge-sort by distance, truncate to k."""
        q = np.asarray(vectors, dtype=np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        b = q.shape[0]
        targets = self._all_shard_targets()

        def run(name, shard):
            if shard is not None:
                return shard.object_vector_search(
                    q, k, flt, target_distance, include_vector
                )
            return self.remote.search_shard(
                self.class_name, name, q, k, flt, target_distance, include_vector
            )

        if len(targets) == 1:
            all_results = [run(*targets[0])]
        else:
            futs = [self._pool.submit(run, n, s) for n, s in targets]
            all_results = [f.result() for f in futs]
        return _merge_shard_results(all_results, b, k)

    def keyword_search_batch(
        self, queries: list[str], limit: int, offset: int = 0,
        properties=None, include_vector: bool = False,
    ):
        """Batched plain-BM25 lane (device dense rows): engages only on a
        single-local-shard layout — multi-shard scatter-gather would need a
        per-shard batch + merge, which the per-query path already does.
        None -> caller falls back to per-query searches."""
        targets = self._all_shard_targets()
        if len(targets) != 1 or targets[0][1] is None:
            return None
        return targets[0][1].keyword_search_batch(
            queries, limit, offset=offset, properties=properties,
            include_vector=include_vector)

    def object_vector_search_async(
        self, vectors: np.ndarray, k: int, include_vector: bool = False
    ):
        """Deferred-hydration twin of object_vector_search for the
        unfiltered batched path: a single local shard enqueues its device
        dispatch now so concurrent requests overlap device compute with
        hydration; multi-shard / remote / no-async-index layouts run the
        shard searches concurrently on the pool (the sync path's
        parallelism — an inline per-shard fallback would serialize them)."""
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        targets = self._all_shard_targets()
        fins = []
        for name, shard in targets:
            if shard is None:
                fut = self._pool.submit(
                    self.remote.search_shard, self.class_name, name, q, k,
                    None, None, include_vector)
                fins.append(fut.result)
            elif len(targets) == 1 and hasattr(
                    shard.vector_index, "search_by_vectors_async"):
                fins.append(shard.object_vector_search_async(q, k, include_vector))
            else:
                fut = self._pool.submit(
                    shard.object_vector_search, q, k, None, None, include_vector)
                fins.append(fut.result)

        def done() -> list[list[SearchResult]]:
            return _merge_shard_results([f() for f in fins], b, k)

        return done

    def is_consistent(self, uuid: str, update_time: int) -> bool:
        """_additional.isConsistent: replicated shards digest-compare every
        replica; unreplicated objects are trivially consistent."""
        return self.are_consistent([(uuid, update_time)])[0]

    def are_consistent(self, pairs: list[tuple[str, int]]) -> list[bool]:
        """Batch isConsistent (finder.go CheckConsistency/DigestObjects):
        pairs grouped by shard, one digest request per replica per shard."""
        out = [True] * len(pairs)
        if self.finder is None:
            return out
        groups: dict[str, list[int]] = {}
        for i, (u, _) in enumerate(pairs):
            name = self.shard_for(u)
            if self.finder is not None and len(
                    self.sharding_state.belongs_to_nodes(name)) > 1:
                groups.setdefault(name, []).append(i)
        for name, idxs in groups.items():
            verdicts = self.finder.check_consistency_many(
                self.class_name, name, [pairs[i] for i in idxs])
            for i, v in zip(idxs, verdicts):
                out[i] = v
        return out

    def aggregate_count(self, flt=None) -> int:
        """Cluster-wide matching-doc count (the meta-count fast path: ships
        integers, never objects)."""
        targets = self._all_shard_targets()

        def run(name, shard):
            if shard is not None:
                return len(shard.find_doc_ids(flt))
            return self.remote.count_shard_filtered(self.class_name, name, flt)

        if len(targets) == 1:
            return run(*targets[0])
        futs = [self._pool.submit(run, n, s) for n, s in targets]
        return sum(f.result() for f in futs)

    def aggregate_columns(self, flt=None, props: tuple = ()) -> dict:
        """Referenced property columns across every physical shard (local
        reads + remote :aggregations column requests) — the data plane of
        Aggregate (index.go's aggregation scatter-gather). Ships columns,
        never whole objects, so coordinator memory/network are bounded by
        the properties the query names."""
        targets = self._all_shard_targets()
        props = list(props)

        def run(name, shard):
            if shard is not None:
                return shard.aggregate_columns(flt, props)
            return self.remote.aggregate_shard_columns(
                self.class_name, name, flt, props)

        if len(targets) == 1:
            parts = [run(*targets[0])]
        else:
            futs = [self._pool.submit(run, n, s) for n, s in targets]
            parts = [f.result() for f in futs]
        merged: dict = {"count": sum(p["count"] for p in parts),
                        "cols": {p: [] for p in props}}
        for part in parts:
            for p in props:
                merged["cols"][p].extend(part["cols"].get(p, []))
        return merged

    def object_search(
        self,
        limit: int,
        flt: Optional[LocalFilter] = None,
        keyword_ranking: Optional[dict] = None,
        offset: int = 0,
        include_vector: bool = False,
        cursor_after: Optional[str] = None,
        sort: Optional[list[dict]] = None,
    ) -> list[SearchResult]:
        if sort and cursor_after is not None:
            raise ValueError(
                "sort cannot be combined with the 'after' cursor (cursor "
                "pagination is uuid-ordered)"
            )
        targets = self._all_shard_targets()

        def run(name, shard):
            if shard is not None:
                return shard.object_search(
                    limit + offset, flt, keyword_ranking, 0, include_vector,
                    cursor_after, sort,
                )
            return self.remote.search_shard_objects(
                self.class_name, name, limit + offset, flt, keyword_ranking,
                include_vector, cursor_after, sort,
            )

        if len(targets) == 1:
            rows = run(*targets[0])
        else:
            futs = [self._pool.submit(run, n, s) for n, s in targets]
            rows = [r for f in futs for r in f.result()]
        if keyword_ranking:
            rows.sort(key=lambda r: -(r.score or 0.0))
        elif sort:
            # class-level merge of per-shard sorted pages (index.go merge)
            from weaviate_tpu_torch.db.sorter import sort_results

            rows = sort_results(rows, sort)
        elif cursor_after is not None:
            rows.sort(key=lambda r: r.obj.uuid)
        return rows[offset : offset + limit]

    # -- stats / lifecycle ---------------------------------------------------

    def object_count(self) -> int:
        total = sum(s.object_count() for s in self.shards.values())
        if self.remote is not None:
            for name in self.sharding_state.all_physical_shards():
                if self._local_shard(name) is None:
                    total += self.remote.object_count(self.class_name, name)
        return total

    def update_schema(self, class_def: ClassDef) -> None:
        with self._lock:
            self.class_def = class_def
            for s in self.shards.values():
                s.update_schema(class_def)

    def update_vector_config(self, cfg) -> None:
        with self._lock:
            for s in self.shards.values():
                s.update_vector_config(cfg)
            self.vector_config = cfg

    def shards_status(self) -> list[dict]:
        return [
            {"name": n, "status": s.status, "objectCount": s.object_count()}
            for n, s in sorted(self.shards.items())
        ]

    def flush(self) -> None:
        for s in self.shards.values():
            s.flush()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False)
        for s in self.shards.values():
            s.shutdown()

    def drop(self) -> None:
        self._pool.shutdown(wait=False)
        for s in self.shards.values():
            s.drop()
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)

    def post_startup(self) -> None:
        for s in self.shards.values():
            s.post_startup()
