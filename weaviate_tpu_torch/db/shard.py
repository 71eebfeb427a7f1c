# The port's copy of weaviate_tpu/db/shard.py, its imports pointed at the port.
"""Shard: the smallest complete storage unit.

Reference: adapters/repos/db/shard.go — one shard = LSM store + indexcounter
(docID allocator) + inverted index + vector index (+ per-geo-prop indexes),
with the read path of shard_read.go (objectVectorSearch: filters ->
buildAllowList -> vectorIndex.SearchByVector -> hydrate winners) and the
write path of shard_write_put.go / shard_write_batch_objects.go.

Device-first deltas from the reference:
- the vector write path is batch-first: a batch import stages host-side and
  lands on the device as chunked writes, instead of the reference's
  goroutine-pool of single-vector inserts (shard_write_batch_objects.go:220);
- the read path is batched end-to-end: N concurrent queries ride ONE device
  dispatch ([B, N] distance block + masked top-k).

The port's Shard is the JAX package's over the port's index
(`weaviate_tpu_torch.index.new_vector_index`), with one difference in
signature: an explicit `device` keyword, passed through to the index, that
defaults to the CUDA card (pass device="cpu" to run on the CPU).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import uuid as uuidlib

from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.entities.filters import GeoRange, LocalFilter
from weaviate_tpu_torch.entities.schema import ClassDef, DataType
from weaviate_tpu_torch.entities.storobj import StorObj
from weaviate_tpu_torch.index import new_vector_index
from weaviate_tpu_torch.monitoring import incidents, memory, perf, quality, tracing
from weaviate_tpu_torch.monitoring.metrics import record_device_fallback
# request-lifecycle robustness (stdlib-only module — no import cycle even
# though serving/coalescer.py imports this file): deadline fail-fast +
# the device circuit breaker that routes reads to the host fallback plane
from weaviate_tpu_torch.serving import robustness
# named fault-injection point db.shard.search (testing/faults.py)
from weaviate_tpu_torch.testing import faults, sanitizers
from weaviate_tpu_torch.inverted.bm25 import BM25Searcher
from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.inverted.searcher import FilterSearcher
from weaviate_tpu_torch.storage.bitmap import Bitmap
from weaviate_tpu_torch.storage.docid import Counter
from weaviate_tpu_torch.storage.lsm import STRATEGY_REPLACE, Store

# shard status (entities/storagestate)
STATUS_READY = "READY"
STATUS_READONLY = "READONLY"


class ShardReadOnlyError(RuntimeError):
    pass


class SearchResult:
    """One search hit: the object + additional result props
    (the reference's search.Result / _additional map).

    `obj` materializes LAZILY from the raw storage image when the hit was
    hydrated from disk: the gRPC fast path serializes thousands of winners
    per batch straight from `raw_pristine()` and never needs a StorObj (or
    even its field slots) built per result."""

    __slots__ = ("_obj", "_raw", "_include_vector", "distance", "certainty",
                 "score", "explain_score", "shard", "additional")

    def __init__(self, obj: Optional[StorObj] = None,
                 distance: Optional[float] = None,
                 certainty: Optional[float] = None,
                 score: Optional[float] = None,
                 explain_score: Optional[str] = None,
                 shard: str = "", additional: Optional[dict] = None,
                 raw: Optional[bytes] = None, include_vector: bool = False):
        if obj is None and raw is None:
            # the old dataclass made obj required — keep construction-time
            # failure at the buggy call site, not a NoneType blowup later
            raise TypeError("SearchResult requires obj or raw")
        self._obj = obj
        self._raw = raw
        self._include_vector = include_vector
        self.distance = distance
        self.certainty = certainty
        self.score = score
        self.explain_score = explain_score
        self.shard = shard
        self.additional = additional if additional is not None else {}

    @property
    def obj(self) -> StorObj:
        if self._obj is None and self._raw is not None:
            self._obj = StorObj.from_binary(self._raw, self._include_vector)
        return self._obj

    @obj.setter
    def obj(self, value: StorObj) -> None:
        self._obj = value
        self._raw = None

    def raw_pristine(self) -> Optional[bytes]:
        """The hit's storage image when it is still byte-faithful: either
        the object was never materialized, or it was and is unmutated."""
        if self._obj is None:
            return self._raw
        return self._obj.raw_if_pristine()

    def __repr__(self) -> str:
        return (f"SearchResult(obj={self._obj!r}, distance={self.distance}, "
                f"shard={self.shard!r})")


def filter_signature(flt: Optional[LocalFilter]) -> Optional[str]:
    """Stable content key for a filter: "" for no filter, None when the
    filter cannot be keyed (unserializable). ONE definition shared by the
    shard's allowList cache and the query coalescer's lane keys, so two
    requests that coalesce into a lane are exactly the requests that would
    resolve to the same cached allowList."""
    if flt is None:
        return ""
    try:
        return json.dumps(flt.to_dict(), sort_keys=True, default=str)
    except Exception:  # noqa: BLE001 — unhashable filter content
        return None


def _uuid_bytes(u: str) -> bytes:
    # canonical-form fast path (cheaper than uuid.UUID); anything else — braces,
    # urn: prefix — takes the full parser. The 32-hex-after-dash-strip check
    # keeps malformed ids raising instead of silently hashing to a bogus key
    if len(u) == 36:
        h = u.replace("-", "")
        if len(h) == 32:
            try:
                b = bytes.fromhex(h)
                # fromhex skips ASCII whitespace — 16 decoded bytes proves
                # all 32 chars were hex digits
                if len(b) == 16:
                    return b
            except ValueError:
                pass
    return uuidlib.UUID(u).bytes


class Shard:
    # allowList-cache LRU capacity (build_allow_list; surfaced by
    # debug_health so /debug/index can report occupancy vs the bound)
    _ALLOW_CACHE_CAP = 16

    def __init__(
        self,
        name: str,
        path: str,
        class_def: ClassDef,
        vector_config,
        metrics=None,
        invert_cfg: Optional[dict] = None,
        store_opts: Optional[dict] = None,
        device=None,
    ):
        self.name = name
        self.path = path
        self.class_def = class_def
        self.metrics = metrics
        os.makedirs(path, exist_ok=True)
        self.store = Store(os.path.join(path, "lsm"), **(store_opts or {}))
        # objects bucket keyed by uuid bytes; docid bucket docID -> uuid bytes
        # (reference: helpers.ObjectsBucketLSM + docid lookup)
        self.objects = self.store.create_or_load_bucket("objects", STRATEGY_REPLACE)
        self.docid_lookup = self.store.create_or_load_bucket("docid_lookup", STRATEGY_REPLACE)
        self.counter = Counter(os.path.join(path, "indexcount"))
        self.invert_cfg = invert_cfg
        self.inverted = InvertedIndex(self.store, class_def)
        self.vector_index = new_vector_index(
            vector_config, path, name, device=device, metrics=metrics,
            class_name=self.class_def.name)
        self._geo_indexes: dict[str, object] = {}
        self._init_geo_indexes()
        self.searcher = FilterSearcher(
            self.inverted, class_def, geo_search=self._geo_search
        )
        self.bm25 = BM25Searcher(self.inverted, class_def, invert_cfg,
                                 gen_fn=self._locked_gen)
        self.bm25_device = self._maybe_device_bm25()
        # background per-bucket pair compaction (segment_group_compaction.go)
        self.store.start_compaction_cycle()
        self.status = STATUS_READY
        self._deleted: dict[str, int] = {}  # uuid -> deletion ms (digests)
        # allowList cache: filter-content key -> (write generation, Bitmap,
        # inserting tenant) — the tenant bounds each tenant's share at
        # eviction time (see build_allow_list)
        self._write_gen = 0
        self._allow_cache: dict[str, tuple[int, Bitmap, str]] = {}
        self._lock = sanitizers.register_lock(
            threading.RLock(), "db.shard")
        # memory providers (monitoring/memory.py): the allowList cache's
        # host byte weight and the packed device filter words cached on
        # its bitmaps become /debug/memory components, sized by the same
        # helpers debug_health() reports
        memory.register_host_provider(self, memory.shard_host_components)
        memory.register_device_provider(self, memory.shard_device_components)

    # -- geo props (propertyspecific/ + vector/geo) --------------------------

    def _init_geo_indexes(self) -> None:
        for prop in self.class_def.properties:
            pt = prop.primitive_type()
            if pt is not None and pt.base is DataType.GEO_COORDINATES:
                if prop.name in self._geo_indexes:
                    continue  # keep the live instance (open handle + buffer)
                from weaviate_tpu_torch.index.geo import GeoIndex

                self._geo_indexes[prop.name] = GeoIndex(
                    os.path.join(self.path, f"geo.{prop.name}")
                )

    def _geo_search(self, prop_name: str, geo: GeoRange) -> Bitmap:
        idx = self._geo_indexes.get(prop_name)
        if idx is None:
            return Bitmap()
        return idx.within_range(geo.latitude, geo.longitude, geo.distance_max)

    # -- schema migration ----------------------------------------------------

    def update_schema(self, class_def: ClassDef) -> None:
        with self._lock:
            self._write_gen += 1  # filterable backfill mutates the inverted index
            self.class_def = class_def
            self.inverted.update_schema(class_def)
            self._init_geo_indexes()
            self.searcher = FilterSearcher(self.inverted, class_def, geo_search=self._geo_search)
            self.bm25 = BM25Searcher(self.inverted, class_def, self.invert_cfg,
                                     gen_fn=self._locked_gen)
            self.bm25_device = self._maybe_device_bm25()

    def _maybe_device_bm25(self):
        """Device BM25 engine when opted in (invertedIndexConfig.bm25.device
        or WEAVIATE_TPU_BM25_DEVICE=1); None keeps the host MaxScore path.
        The port has no device BM25 engine yet: asking for one raises."""
        bm = (self.invert_cfg or {}).get("bm25") or {}
        env = os.environ.get("WEAVIATE_TPU_BM25_DEVICE", "").strip().lower()
        env_on = env not in ("", "0", "false", "off", "no")
        if not (bm.get("device") or env_on):
            return None
        raise ValueError("device BM25 (inverted/bm25_device.py) is not ported yet: "
                         "ROADMAP queue 1 item 11")

    def update_vector_config(self, cfg) -> None:
        self.vector_index.update_user_config(cfg)

    # -- status (entities/storagestate, shard_status.go) ---------------------

    def set_status(self, status: str) -> None:
        self.status = status

    def _check_writable(self) -> None:
        if self.status == STATUS_READONLY:
            raise ShardReadOnlyError(f"shard {self.name} is read-only")

    # -- write path ----------------------------------------------------------

    def put_object(self, obj: StorObj, preserve_times: bool = False) -> StorObj:
        """Upsert (shard_write_put.go:putObject): allocate a fresh docID,
        clean up the previous version's inverted/vector entries, write LSM
        object + lookup, update inverted + geo + vector index.

        preserve_times=True keeps the object's wire timestamps untouched —
        the replica apply path, where the COORDINATOR stamps times once so
        every replica stores identical values and digests converge
        (otherwise each replica's local clock would make read repair
        ping-pong forever)."""
        with self._lock:
            self._check_writable()
            self._write_gen += 1
            key = _uuid_bytes(obj.uuid)
            self._deleted.pop(obj.uuid, None)
            prev_raw = self.objects.get(key)
            if prev_raw is not None:
                prev = StorObj.from_binary(prev_raw)
                # creation time always survives an update; the update time is
                # either stamped here (local write) or kept from the wire
                # (coordinator-stamped replica apply)
                obj.creation_time_unix = prev.creation_time_unix
                if not preserve_times:
                    obj.last_update_time_unix = int(time.time() * 1000)
                self._cleanup_previous(prev)
            doc_id = self.counter.get_and_inc()
            obj.doc_id = doc_id
            self.objects.put(key, obj.to_binary())
            self.docid_lookup.put(struct.pack("<Q", doc_id), key)
            self.inverted.add_object(doc_id, obj.properties)
            self._geo_add(doc_id, obj.properties)
            if obj.vector is not None:
                self.vector_index.add(doc_id, obj.vector)
            return obj

    def _cleanup_previous(self, prev: StorObj) -> None:
        self.inverted.delete_object(prev.doc_id, prev.properties)
        self._geo_delete(prev.doc_id, prev.properties)
        self.docid_lookup.delete(struct.pack("<Q", prev.doc_id))
        self.vector_index.delete(prev.doc_id)

    def _geo_add(self, doc_id: int, props: dict) -> None:
        for name, idx in self._geo_indexes.items():
            v = props.get(name)
            if isinstance(v, dict) and "latitude" in v and "longitude" in v:
                idx.add(doc_id, float(v["latitude"]), float(v["longitude"]))

    def _geo_delete(self, doc_id: int, props: dict) -> None:
        for name, idx in self._geo_indexes.items():
            if isinstance(props.get(name), dict):
                idx.delete(doc_id)

    def put_batch(
        self, objs: Sequence[StorObj], preserve_times: bool = False
    ) -> list[Optional[Exception]]:
        """Batch import (shard_write_batch_objects.go): LSM + inverted per
        object host-side, vectors land on the device as ONE batched add.
        preserve_times: see put_object (replica apply path)."""
        with self._lock:
            self._check_writable()
            self._write_gen += 1
            errs: list[Optional[Exception]] = [None] * len(objs)
            fresh_ids: list[int] = []
            fresh_vecs: list[np.ndarray] = []
            staged_pos: dict[int, int] = {}  # doc_id -> index into fresh_*
            dim: Optional[int] = None
            # staged LSM/inverted writes: each bucket takes the whole batch
            # in ONE call (single lock + WAL write; postings grouped per
            # term) instead of per-object puts
            obj_puts: dict[bytes, bytes] = {}
            doc_puts: dict[int, tuple[bytes, bytes]] = {}  # doc -> (key8, key)
            inv_items: dict[int, tuple[dict, int]] = {}  # doc -> (props, idx)
            for i, obj in enumerate(objs):
                try:
                    key = _uuid_bytes(obj.uuid)
                    self._deleted.pop(obj.uuid, None)
                    # a duplicate uuid within this batch must see the staged
                    # (not yet written) earlier version as its previous state
                    prev_raw = obj_puts.get(key)
                    if prev_raw is None:
                        prev_raw = self.objects.get(key)
                    if prev_raw is not None:
                        prev = StorObj.from_binary(prev_raw)
                        obj.creation_time_unix = prev.creation_time_unix
                        if not preserve_times:
                            obj.last_update_time_unix = int(time.time() * 1000)
                        self._cleanup_previous(prev)
                        inv_items.pop(prev.doc_id, None)
                        doc_puts.pop(prev.doc_id, None)
                        # the earlier version's vector was never device-added,
                        # so vector_index.delete above was a no-op
                        pos = staged_pos.pop(prev.doc_id, None)
                        if pos is not None:
                            fresh_ids[pos] = -1
                    doc_id = self.counter.get_and_inc()
                    obj.doc_id = doc_id
                    obj_puts[key] = obj.to_binary()
                    doc_puts[doc_id] = (struct.pack("<Q", doc_id), key)
                    inv_items[doc_id] = (obj.properties, i)
                    self._geo_add(doc_id, obj.properties)
                    if obj.vector is not None:
                        if dim is None:
                            dim = int(np.asarray(obj.vector).shape[0])
                        if int(np.asarray(obj.vector).shape[0]) == dim:
                            staged_pos[doc_id] = len(fresh_ids)
                            fresh_ids.append(doc_id)
                            fresh_vecs.append(np.asarray(obj.vector, dtype=np.float32))
                        else:
                            self.vector_index.add(doc_id, obj.vector)
                except Exception as e:  # per-object error isolation (batch semantics)
                    errs[i] = e
            try:
                self.objects.put_many(obj_puts.items())
                self.docid_lookup.put_many(doc_puts.values())
                inv_errs = self.inverted.add_objects_batch(
                    [(d, p) for d, (p, _) in inv_items.items()])
            except Exception as e:  # noqa: BLE001 — store-level IO failure
                # the batched writes sit outside the per-object try: report
                # the failure on every object instead of aborting the caller,
                # and skip the device add (LSM state is incomplete)
                for _, i in inv_items.values():
                    if errs[i] is None:
                        errs[i] = e
                return errs
            for d, (_, i) in inv_items.items():
                e = inv_errs.get(d)
                if e is not None:
                    errs[i] = e
                    pos = staged_pos.pop(d, None)
                    if pos is not None:
                        fresh_ids[pos] = -1  # match add_object-failure semantics
            if any(d >= 0 for d in fresh_ids):
                keep = [j for j, d in enumerate(fresh_ids) if d >= 0]
                fresh_ids = [fresh_ids[j] for j in keep]
                fresh_vecs = [fresh_vecs[j] for j in keep]
                try:
                    self.vector_index.add_batch(fresh_ids, np.stack(fresh_vecs))
                except Exception:
                    # keep per-object error isolation: retry row-by-row so one
                    # bad vector doesn't fail the whole batch post-LSM-write
                    by_doc = {o.doc_id: i for i, o in enumerate(objs)}
                    for d, v in zip(fresh_ids, fresh_vecs):
                        try:
                            self.vector_index.add(d, v)
                        except Exception as e:
                            errs[by_doc[d]] = e
            return errs

    def delete_object(self, uuid: str, deletion_time: Optional[int] = None) -> bool:
        """deletion_time (ms) is coordinator-stamped on replicated deletes so
        digests can order a deletion against concurrent writes; locally we
        stamp now. Tombstone times are in-memory only (v1.19 reference
        parity: deletes are not durable conflict-resolution state)."""
        with self._lock:
            self._check_writable()
            self._write_gen += 1
            key = _uuid_bytes(uuid)
            raw = self.objects.get(key)
            if raw is None:
                return False
            prev = StorObj.from_binary(raw)
            self._cleanup_previous(prev)
            self.objects.delete(key)
            self._deleted[uuid] = deletion_time or int(time.time() * 1000)
            return True

    def deletion_time(self, uuid: str) -> Optional[int]:
        """ms timestamp of a known deletion, for digest comparison."""
        return self._deleted.get(uuid)

    def merge_object(self, uuid: str, props: dict, vector=None,
                     update_time: Optional[int] = None,
                     meta: Optional[dict] = None) -> Optional[StorObj]:
        """PATCH semantics (objects.Manager.MergeObject): shallow-merge props.
        update_time is coordinator-stamped on replicated merges (see
        put_object preserve_times). meta merges into the object's underscore
        metadata (classification stamps, entities/storobj meta json)."""
        with self._lock:
            raw = self.objects.get(_uuid_bytes(uuid))
            if raw is None:
                return None
            obj = StorObj.from_binary(raw)
            merged = dict(obj.properties)
            merged.update(props)
            obj.properties = merged
            if meta:
                obj.meta = {**obj.meta, **meta}
            if vector is not None:
                obj.vector = np.asarray(vector, dtype=np.float32)
            if update_time is not None:
                obj.last_update_time_unix = update_time
                return self.put_object(obj, preserve_times=True)
            return self.put_object(obj)

    # -- read path -----------------------------------------------------------

    def object_by_uuid(self, uuid: str, include_vector: bool = True) -> Optional[StorObj]:
        raw = self.objects.get(_uuid_bytes(uuid))
        return StorObj.from_binary(raw, include_vector) if raw is not None else None

    def multi_get(self, uuids: Sequence[str], include_vector: bool = False) -> list[Optional[StorObj]]:
        return [self.object_by_uuid(u, include_vector) for u in uuids]

    def exists(self, uuid: str) -> bool:
        return self.objects.get(_uuid_bytes(uuid)) is not None

    def object_count(self) -> int:
        return self.inverted.doc_count()

    def vector_count(self) -> int:
        return len(self.vector_index)

    def objects_by_doc_ids(
        self, doc_ids: Sequence[int], include_vector: bool = False
    ) -> list[Optional[StorObj]]:
        """Hydrate winners (storobj.ObjectsByDocID, storage_object.go:211):
        one multi-get per store (single lock acquisition each), lazy
        decode — the same batched plane the vector path's _hydrate_batch
        uses, shared by BM25 / listing / aggregation hydration."""
        keys = self.docid_lookup.multi_get(
            [struct.pack("<Q", int(d)) for d in doc_ids])
        raws = self.objects.multi_get(keys)
        return [StorObj.from_binary(r, include_vector) if r is not None else None
                for r in raws]

    def _locked_gen(self) -> int:
        """Write generation observed UNDER the shard lock: mutators hold the
        lock for their whole body and bump the generation first, so a value
        read here can never correspond to a mid-flight mutation. Readers
        cache with a read-compute-reread protocol: if the two reads agree,
        no mutation overlapped the compute."""
        with self._lock:
            return self._write_gen

    def build_allow_list(self, flt: Optional[LocalFilter]) -> Optional[Bitmap]:
        """filters -> allowList (shard_read.go:377 buildAllowList).

        Cached per filter CONTENT for the current write generation: the
        serving path constructs a fresh LocalFilter/Bitmap per request, so
        without this the inverted-index evaluation AND the device-words
        pack (which caches on the Bitmap object — index/gpu.py
        _allow_words) re-run on every query of a repeated filter. Any
        write bumps the generation and invalidates; the double generation
        read refuses to cache when a write overlapped the evaluation.

        Tenant-fair eviction: entries remember the inserting tenant
        (robustness.effective_tenant, class-name default), and when the
        LRU is full the victim comes from the tenant holding the MOST
        entries, oldest of that tenant first — an abusive tenant issuing
        unique filters evicts its own cold entries instead of every other
        tenant's hot ones (the admission-queue starvation bug, replayed
        at the cache layer). With a single tenant (the anonymous
        same-class common case) this degenerates to exactly the old
        global LRU."""
        if flt is None:
            return None
        key = filter_signature(flt)
        if key is None:  # unhashable filter: just evaluate
            return self.searcher.doc_ids(flt)
        gen = self._locked_gen()
        hit = self._allow_cache.get(key)
        if hit is not None and hit[0] == gen:
            # LRU move-to-end on hit (dict preserves insertion order): a hot
            # filter inserted FIRST must outlive cold one-offs — plain FIFO
            # evicted exactly the entries worth keeping. pop+reinsert races
            # benignly between reader threads (both re-insert the same hit).
            self._allow_cache.pop(key, None)
            self._allow_cache[key] = hit
            return hit[1]
        allow = self.searcher.doc_ids(flt)
        if self._locked_gen() == gen:
            tenant = robustness.effective_tenant(self.class_def.name) or ""
            # small LRU: hot filters are few
            if len(self._allow_cache) >= self._ALLOW_CACHE_CAP:
                try:
                    self._allow_cache.pop(self._allow_evict_key(tenant))
                except (StopIteration, KeyError, IndexError, RuntimeError,
                        ValueError):
                    pass  # concurrent readers emptied/mutated it first
            self._allow_cache[key] = (gen, allow, tenant)
        return allow

    def _allow_evict_key(self, inserting: str) -> str:
        """The allowList-cache victim: the LRU entry of the tenant with
        the most cached entries (the inserting tenant wins ties — its own
        new entry is about to join its share). Snapshot-iterates so a
        concurrent reader's benign move-to-end can at worst pick a
        slightly stale victim, never raise."""
        entries = list(self._allow_cache.items())
        counts: dict[str, int] = {}
        for _, (_, _, t) in entries:
            counts[t] = counts.get(t, 0) + 1
        counts[inserting] = counts.get(inserting, 0) + 1
        heaviest = max(counts, key=lambda t: (counts[t], t == inserting))
        for k, (_, _, t) in entries:
            if t == heaviest:
                return k  # oldest = least recently used under move-to-end
        return entries[0][0]  # heaviest only has the not-yet-inserted entry

    def object_vector_search(
        self,
        vectors: np.ndarray,
        k: int,
        flt: Optional[LocalFilter] = None,
        target_distance: Optional[float] = None,
        include_vector: bool = False,
    ) -> list[list[SearchResult]]:
        """Batched vector search (shard_read.go:223 objectVectorSearch),
        [B, D] queries in one device dispatch -> per-query hydrated results.
        Phase timings land in the filtered-vector breakdown histograms
        (shard_read.go:236-287 instrumentation parity) AND, when a trace is
        active, in the dispatch record (monitoring/tracing.py): the
        coalescer's record when this call is a coalesced lane flush, else a
        single-rider record on the current request's trace.

        Robustness gates (serving/robustness.py): an expired deadline
        fails fast BEFORE any device work; with the circuit breaker open
        the read serves from the index's host fallback plane instead of
        dispatching doomed device work; a device error on dispatch feeds
        the breaker and — when a host plane exists — degrades to it for
        THIS request too, so a single flaky dispatch costs a retry's
        latency, not an error."""
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        robustness.check_deadline("shard.search")
        faults.fire("db.shard.search")
        br = robustness.get_breaker()
        if br is not None and self._has_host_plane() and not br.allow():
            return self._host_fallback_search(
                q, k, flt, target_distance, include_vector, "breaker_open")
        rec = None
        dispatched = [False]  # set by impl AFTER real device work succeeds
        try:
            rec = tracing.dispatch_record(q.shape[0])
            out = self._vector_search_impl(
                q, k, flt, target_distance, include_vector, rec, dispatched)
        except Exception as e:
            if br is not None and robustness.is_device_error(e):
                br.record_failure(e)
                if self._has_host_plane():
                    tracing.annotate_current(
                        "device_error_fallback", f"{type(e).__name__}: {e}")
                    return self._host_fallback_search(
                        q, k, flt, target_distance, include_vector,
                        "device_error", cause=e)
            raise
        else:
            # only a real DEVICE dispatch may feed the breaker's success
            # side: an empty-allowList early return (zero device work) or
            # a device-less index (hnsw, no host plane) must not
            # reset the consecutive-failure count — or close an OPEN
            # breaker without a probe — while the device is down
            if br is not None and dispatched[0] and self._has_host_plane():
                self._record_device_success(br)
            return out
        finally:
            # the direct path owns its record; a coalesced record is
            # finished by the coalescer after scatter (it knows the riders)
            if rec is not None and rec.owned:
                rec.finish()

    def _record_device_success(self, br) -> None:
        """Feed the breaker's success side, and release THIS index's host
        fallback copy — a multi-GB host materialization at serving scale —
        once the device serves it again with the breaker CLOSED. Per-shard
        on purpose: the global OPEN->CLOSED transition happens on ONE
        shard's dispatch, but every shard that served during the degraded
        window holds its own copy; each frees it on its own first healthy
        dispatch (the shards holding copies are exactly the ones taking
        traffic). Steady-state cost: one getattr returning None."""
        br.record_success()
        vidx = self.vector_index
        if getattr(vidx, "_host_rows_cache", None) is not None \
                and br.state() == robustness.STATE_CLOSED:
            release = getattr(vidx, "release_host_fallback_cache", None)
            if release is not None:
                release()

    def _vector_search_impl(
        self, q: np.ndarray, k: int, flt, target_distance,
        include_vector: bool, rec, dispatched=None,
    ) -> list[list[SearchResult]]:
        m = self.metrics
        cls = self.class_def.name
        t0 = time.perf_counter()
        allow = self.build_allow_list(flt)
        t1 = time.perf_counter()
        filter_ms = (t1 - t0) * 1000.0 if flt is not None else None
        if filter_ms is not None:
            if rec is not None:
                rec.phase("filter", filter_ms)
            if m is not None:
                m.filtered_vector_filter.labels(cls, self.name).observe(
                    filter_ms)
        if allow is not None and len(allow) == 0:
            return [[] for _ in range(q.shape[0])]
        t1 = time.perf_counter()
        if target_distance is not None:
            row_ids, row_dists = self._search_by_vectors_distance(
                q, target_distance, k, allow)
            if dispatched is not None:
                dispatched[0] = True
            lock_wait = self._pop_lock_wait()
            # widening runs several dispatches; the popped shape (and so
            # the ledger/roofline facts) describes the LAST round
            shape = self._pop_dispatch_shape()
            # target-distance rounds are ragged re-dispatches of the same
            # rows — not a representative recall sample; drop the pin
            self._pop_audit_snap()
            t2 = time.perf_counter()
            # pad the ragged per-row results back to one rectangle so the
            # winners hydrate in ONE batched pass (inf marks absent slots,
            # exactly the device kernels' padding convention)
            width = max((len(r) for r in row_ids), default=0)
            ids = np.zeros((q.shape[0], width), dtype=np.uint64)
            dists = np.full((q.shape[0], width), np.inf, dtype=np.float32)
            for i, (ri, rd) in enumerate(zip(row_ids, row_dists)):
                ids[i, : len(ri)] = ri
                dists[i, : len(ri)] = rd
            hydrated = self._hydrate_batch(ids, dists, include_vector)
            t3 = time.perf_counter()
            if rec is not None:
                rec.phase("device_search", (t2 - t1) * 1000.0)
                rec.phase("hydrate", (t3 - t2) * 1000.0)
            if shape is not None:
                if filter_ms is not None:
                    shape.filter_ms = filter_ms
                shape.hydrate_ms = (t3 - t2) * 1000.0
            self._trace_dispatch_facts(rec, q.shape[0], k, lock_wait, shape)
            if m is not None:
                m.filtered_vector_search.labels(cls, self.name).observe(
                    (t2 - t1) * 1000.0)
                m.filtered_vector_objects.labels(cls, self.name).observe(
                    (t3 - t2) * 1000.0)
                m.vector_index_ops.labels("search", cls, self.name).inc(q.shape[0])
                m.query_dimensions.labels("nearVector", "search", cls).inc(
                    int(q.shape[0] * q.shape[1]))
            return hydrated
        ids, dists = self.vector_index.search_by_vectors(q, k, allow)
        if dispatched is not None:
            dispatched[0] = True
        lock_wait = self._pop_lock_wait()
        shape = self._pop_dispatch_shape()
        self._maybe_audit(self._pop_audit_snap(), q, k, allow, ids, dists)
        t2 = time.perf_counter()
        hydrated = self._hydrate_batch(ids, dists, include_vector)
        t3 = time.perf_counter()
        if rec is not None:
            rec.phase("device_search", (t2 - t1) * 1000.0)
            rec.phase("hydrate", (t3 - t2) * 1000.0)
        if shape is not None:
            if filter_ms is not None:
                shape.filter_ms = filter_ms
            shape.hydrate_ms = (t3 - t2) * 1000.0
        self._trace_dispatch_facts(rec, q.shape[0], k, lock_wait, shape)
        if m is not None:
            m.filtered_vector_search.labels(cls, self.name).observe((t2 - t1) * 1000.0)
            m.filtered_vector_objects.labels(cls, self.name).observe(
                (t3 - t2) * 1000.0)
            m.vector_index_ops.labels("search", cls, self.name).inc(q.shape[0])
            m.query_dimensions.labels("nearVector", "search", cls).inc(
                int(q.shape[0] * q.shape[1]))
        return hydrated

    def _has_host_plane(self) -> bool:
        """Does this shard's index expose a host fallback read plane
        (index/gpu.py search_by_vectors_host)? The breaker only gates
        indexes that have one — failing fast with no fallback would be
        strictly worse than trying the device."""
        return hasattr(self.vector_index, "search_by_vectors_host")

    def _host_fallback_search(
        self, q: np.ndarray, k: int, flt, target_distance,
        include_vector: bool, reason: str,
        cause: Optional[BaseException] = None,
    ) -> list[list[SearchResult]]:
        """Serve a read from the index's host fallback plane (breaker open,
        or a device error on this dispatch with a host plane available).
        Counted per reason in weaviate_device_fallback_total — a fleet
        serving at host speed is a capacity incident and must be visible
        on a dashboard, not only in tail latency."""
        record_device_fallback("db.shard.search", reason, cause,
                               log=reason != "breaker_open")
        # journal the degradation (monitoring/incidents.py): burst-
        # coalesced per reason, so a breaker-open stretch reads as one
        # counted entry in the incident bundle's tail, not a ring wipe
        incidents.emit("device_fallback", scope=reason)
        hs = getattr(self.vector_index, "search_by_vectors_host", None)
        if hs is None:  # caller checked; defensive for foreign indexes
            if cause is not None:
                raise cause
            raise RuntimeError(
                f"shard {self.name}: no host fallback plane available")
        allow = self.build_allow_list(flt)
        if allow is not None and len(allow) == 0:
            return [[] for _ in range(q.shape[0])]
        try:
            ids, dists = hs(q, k, allow)
        except Exception:
            if cause is not None:
                # the fallback itself failed (device unreadable even for
                # the bulk row fetch): surface the ORIGINAL dispatch error
                raise cause from None
            raise
        if target_distance is not None:
            dists = np.asarray(dists, dtype=np.float32).copy()
            dists[dists > float(target_distance)] = np.inf
        tracing.annotate_current("host_fallback", reason)
        return self._hydrate_batch(ids, dists, include_vector)

    def _pop_audit_snap(self):
        """The pinned IndexSnapshot this thread's last dispatch read —
        None unless an auditor was configured at dispatch time. Popped
        UNCONDITIONALLY (a TLS getattr, the _pop_lock_wait cost class) so
        an auditor torn down between dispatch and finalize cannot leave a
        stale pin for a LATER request to pop — that would audit query B
        against query A's snapshot. Must run on the DISPATCHING thread,
        like the lock wait and the dispatch shape."""
        pop = getattr(self.vector_index, "pop_audit_snapshot", None)
        return pop() if pop is not None else None

    def _maybe_audit(self, snap, q, k: int, allow, ids, dists) -> None:
        """Shadow-recall sample capture at finalize: offer this completed
        live search (its snapshot pinned at dispatch) to the auditor's
        sampler. Strictly subordinate — sampling, row budgets, and
        drop-not-queue admission all live in the auditor; an auditing
        failure must never break serving."""
        aud = quality.get_auditor()
        if aud is None or snap is None:
            return
        try:
            aud.maybe_capture(self.vector_index, snap, q, k, allow, ids,
                              dists, class_name=self.class_def.name,
                              shard=self.name)
        except Exception:  # noqa: BLE001 — auditing must never break serving
            pass

    def _pop_lock_wait(self) -> Optional[float]:
        """ms this thread's last snapshot read waited on the index write
        lock (0.0 = the lock-free fast path), or None when the index has no
        snapshot plane (hnsw)."""
        pop = getattr(self.vector_index, "pop_read_lock_wait", None)
        return pop() if pop is not None else None

    def _pop_dispatch_shape(self):
        """This thread's last dispatch's costmodel.DispatchShape (None
        while the tracer is down, or for indexes without the perf plane —
        hnsw). Must be popped on the DISPATCHING thread, like the
        lock wait."""
        pop = getattr(self.vector_index, "pop_dispatch_shape", None)
        return pop() if pop is not None else None

    def _trace_dispatch_facts(self, rec, rows: int, k: int,
                              lock_wait_ms: Optional[float] = None,
                              shape=None) -> None:
        """Dispatch-level facts for the trace: the padded width (what the
        jit cache is keyed on — padding waste = 1 - rows/padded), whether
        this (index, padded, k) shape is the first sighting since tracing
        began (a proxy for "this dispatch paid the compile"), the index
        snapshot generation the dispatch read (`snapshot_gen` — correlates
        a slow query with a concurrent write burst), and the ms the
        snapshot read waited on the writer lock (`lock_wait_ms`, 0.0 on the
        lock-free fast path).

        Called for EVERY dispatch while the tracer is up — even when this
        one carries no sampled rider (rec None): under sampling, the
        dispatch that actually pays a shape's compile is usually an
        unsampled one, and skipping registration would make the NEXT
        sampled dispatch of the warm shape falsely read first-seen."""
        if tracing.get_tracer() is None:
            return
        vidx = self.vector_index
        pw = getattr(vidx, "padded_width", None)
        padded = pw(rows) if pw is not None else rows
        first = tracing.note_shape((id(vidx), int(padded), int(k)))
        if shape is not None:
            # perf attribution is FULL-coverage like shape registration:
            # every dispatch feeds the rolling window (duty cycle, window
            # roofline, ledger percentiles) even when no rider was sampled
            # — trace sampling thins /debug/traces, never /debug/perf
            w = perf.get_window()
            if w is not None:
                try:
                    w.record_dispatch(shape, rows=rows)
                except Exception:  # noqa: BLE001 — must not break serving
                    pass
        if rec is not None:
            rec.fact(padded_rows=int(padded), shard=self.name,
                     class_name=self.class_def.name,
                     jit_shape_first_seen=bool(first))
            sg = getattr(vidx, "snapshot_gen", None)
            if sg is not None:
                rec.fact(snapshot_gen=int(sg))
            if lock_wait_ms is not None:
                rec.fact(lock_wait_ms=round(float(lock_wait_ms), 3))
            if shape is not None:
                rec.attach_shape(shape)

    def _search_by_vectors_distance(
        self, q: np.ndarray, target: float, max_limit: int, allow
    ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Batched target-distance search: the iterative limit-doubling of
        VectorIndex.search_by_vector_distance (search.go:90-157), except
        every round is ONE bucketed device dispatch over the rows that still
        need widening — B rows cost ~1 dispatch instead of B dispatch
        chains. -> ragged ([ids...], [dists...]) per row, ascending."""
        b = q.shape[0]
        out_ids: list = [None] * b
        out_dists: list = [None] * b
        vidx = self.vector_index
        live = len(vidx)
        pending = list(range(b))
        limit = 64
        while pending:
            kk = min(limit, max_limit)
            ids, dists = vidx.search_by_vectors(q[pending], kk, allow)
            nxt: list[int] = []
            for j, row in enumerate(pending):
                rd = np.asarray(dists[j], dtype=np.float32)
                got = ~np.isinf(rd)
                rid, rd = np.asarray(ids[j])[got], rd[got]
                if rid.size == 0:
                    out_ids[row], out_dists[row] = rid, rd
                elif ((rd > target).any()
                      or rid.size >= min(max_limit, live)
                      # fewer results than asked => the reachable set (e.g.
                      # a small allowList) is exhausted; widening further
                      # would re-dispatch the identical search. This also
                      # subsumes the per-row loop's limit>=max_limit stop:
                      # at kk == max_limit a full row hits the size branch
                      # above, a short row is exhausted here.
                      or rid.size < kk):
                    keep = rd <= target
                    out_ids[row] = rid[keep][:max_limit]
                    out_dists[row] = rd[keep][:max_limit]
                else:
                    nxt.append(row)
            pending = nxt
            limit *= 2
        return out_ids, out_dists

    def object_vector_search_async(
        self, vectors: np.ndarray, k: int, include_vector: bool = False,
        flt: Optional[LocalFilter] = None,
    ):
        """Batched kNN with deferred hydration: the device dispatch is
        enqueued immediately against the index's published snapshot and
        `finalize() -> hydrated results` materializes later, so concurrent
        requests overlap device compute with another request's hydration
        instead of serializing both under the index lock (the depth-2
        pipeline the index bench uses, extended to the serving stack).

        Filtered searches ride the same two-phase pipeline when the index
        supports snapshot dispatch (`async_supports_filters`): the
        allowList builds HERE, on the submitting thread — its cost lands
        in the `filter` phase, never inside a lock a reader could convoy
        on. Indexes without it (hnsw) fall back to the sync path; the
        mesh index serves filtered lanes here too (async_supports_filters
        on MeshVectorIndex).

        With the fused dispatch (index/gpu.py, the default) finalize()'s
        one packed fetch already carries FINAL doc ids — the slot->doc
        translation runs on device inside the search program — so the
        host work between fetch and hydration is dtype views, and the
        perf ledger's gather_hop stage measures just that.

        Robustness gates mirror object_vector_search: deadline fail-fast
        at enqueue, breaker-open reads return a host-fallback closure
        (still ONE batched host pass for a whole coalesced lane), and a
        device error at enqueue or finalize feeds the breaker and
        degrades to the host plane when one exists."""
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        robustness.check_deadline("shard.search")
        faults.fire("db.shard.search")
        vidx = self.vector_index
        dispatch = getattr(vidx, "search_by_vectors_async", None)
        if dispatch is None or (
                flt is not None
                and not getattr(vidx, "async_supports_filters", False)):
            res = self.object_vector_search(q, k, flt, None, include_vector)
            return lambda: res
        br = robustness.get_breaker()
        if br is not None and self._has_host_plane() and not br.allow():
            return lambda: self._host_fallback_search(
                q, k, flt, None, include_vector, "breaker_open")
        m = self.metrics
        cls = self.class_def.name
        filter_ms = None
        allow = None
        if flt is not None:
            t0 = time.perf_counter()
            allow = self.build_allow_list(flt)
            filter_ms = (time.perf_counter() - t0) * 1000.0
            if m is not None:
                m.filtered_vector_filter.labels(cls, self.name).observe(
                    filter_ms)
            if allow is not None and len(allow) == 0:
                empty: list[list[SearchResult]] = [
                    [] for _ in range(q.shape[0])]
                return lambda: empty
        try:
            finalize = (dispatch(q, k, allow) if allow is not None
                        else dispatch(q, k))
        except Exception as e:
            if br is not None and robustness.is_device_error(e):
                br.record_failure(e)
                if self._has_host_plane():
                    # rebind before capture: Python CLEARS the except
                    # variable when the handler exits, and this closure
                    # runs later on another thread
                    err = e
                    return lambda: self._host_fallback_search(
                        q, k, flt, None, include_vector, "device_error",
                        cause=err)
            raise
        lock_wait = self._pop_lock_wait()
        # popped HERE, on the dispatching thread (the TLS does not follow
        # the flusher/pool handoff); the closure carries it to done(),
        # where finalize() will have stamped the device timings
        shape = self._pop_dispatch_shape()
        # audit-snapshot pin: same thread-handoff rule — popped at
        # dispatch, carried into done() where the live answer exists
        audit_snap = self._pop_audit_snap()

        def done() -> list[list[SearchResult]]:
            # observe only the time BLOCKED on the device result — wall time
            # since dispatch includes deliberate deferral (the two-phase
            # traverser enqueues every group before finalizing any) and
            # would pollute the same histogram the sync path feeds. The
            # trace phases use the same convention (device_search = blocked
            # time), so sync and async dispatches compare on one scale.
            rec = None
            try:
                rec = tracing.dispatch_record(q.shape[0])
                if rec is not None and filter_ms is not None:
                    rec.phase("filter", filter_ms)
                t0 = time.perf_counter()
                try:
                    ids, dists = finalize()
                except Exception as e:
                    if br is not None and robustness.is_device_error(e):
                        br.record_failure(e)
                        if self._has_host_plane():
                            tracing.annotate_current(
                                "device_error_fallback",
                                f"{type(e).__name__}: {e}")
                            return self._host_fallback_search(
                                q, k, flt, None, include_vector,
                                "device_error", cause=e)
                    raise
                if br is not None:
                    # this closure exists only when the index dispatched
                    # async device work (hnsw takes the sync path), so
                    # a finalize() success IS a device success
                    self._record_device_success(br)
                self._maybe_audit(audit_snap, q, k, allow, ids, dists)
                t1 = time.perf_counter()
                hydrated = self._hydrate_batch(ids, dists, include_vector)
                t2 = time.perf_counter()
                if rec is not None:
                    rec.phase("device_search", (t1 - t0) * 1000.0)
                    rec.phase("hydrate", (t2 - t1) * 1000.0)
                if shape is not None:
                    if filter_ms is not None:
                        shape.filter_ms = filter_ms
                    shape.hydrate_ms = (t2 - t1) * 1000.0
                self._trace_dispatch_facts(rec, q.shape[0], k, lock_wait,
                                           shape)
                if m is not None:
                    m.filtered_vector_search.labels(cls, self.name).observe(
                        (t1 - t0) * 1000.0)
                    m.filtered_vector_objects.labels(cls, self.name).observe(
                        (t2 - t1) * 1000.0)
                    m.vector_index_ops.labels("search", cls, self.name).inc(q.shape[0])
                    m.query_dimensions.labels("nearVector", "search", cls).inc(
                        int(q.shape[0] * q.shape[1]))
                return hydrated
            finally:
                if rec is not None and rec.owned:
                    rec.finish()

        return done

    def debug_health(self) -> dict:
        """Per-shard introspection for ``GET /debug/index``: object count,
        allowList-cache occupancy, and the vector index's health snapshot
        (index/gpu.py and index/mesh.py health(); indexes without the API — hnsw —
        report just their type). Lock-free racy reads — introspection,
        not an invariant."""
        out = {
            "objects": self.object_count(),
            "status": self.status,
            # byte sizes come from the ledger's shared sizing helpers
            # (monitoring/memory.py) — the SAME functions /debug/memory's
            # host providers call, so the two endpoints can never disagree
            "allow_cache": {"entries": len(self._allow_cache),
                            "capacity": self._ALLOW_CACHE_CAP,
                            "bytes": memory.allow_cache_bytes(self),
                            "device_words_bytes":
                                memory.allow_words_device_bytes(self)},
            "host_fallback_cache_bytes": memory.host_rows_cache_bytes(
                self.vector_index),
            "auditor_rows_bytes": memory.auditor_rows_bytes(
                quality.get_auditor(), self.vector_index),
        }
        vh = getattr(self.vector_index, "health", None)
        out["vector_index"] = vh() if vh is not None else {
            "type": type(self.vector_index).__name__,
            "live": len(self.vector_index),
        }
        return out

    def raw_plane_ready(self) -> bool:
        """Cheap pre-check for the raw serving lane, BEFORE any device work:
        the packed native plane serves exactly only when both point-get
        buckets are segment-resident (empty memtables) and the native
        library loads — checked first so an ineligible batch never runs the
        device kNN twice (once here, once on the general path)."""
        from weaviate_tpu_torch.storage import lsm_native

        if not lsm_native.available():
            return False
        for b in (self.docid_lookup, self.objects):
            with b._lock:
                if len(b._mem) or not b._segments:
                    return False
        return True

    def search_raw_packed(self, q: np.ndarray, k: int):
        """Raw serving lane: device kNN + packed native hydration, with NO
        per-result Python objects — the value arena feeds the native reply
        marshaller directly (reply_native.build_batch_reply_packed).
        -> (val_buf, val_offs, flags, flat_dists, counts) or None when the
        packed plane can't serve exactly (memtables busy, native
        unavailable); the caller uses the general path. Callers should
        gate on raw_plane_ready() first to avoid duplicate device work."""
        m = self.metrics
        cls = self.class_def.name
        rec = None
        try:
            rec = tracing.dispatch_record(q.shape[0])
            t1 = time.perf_counter()
            ids, dists = self.vector_index.search_by_vectors(q, k)
            lock_wait = self._pop_lock_wait()
            shape = self._pop_dispatch_shape()
            self._maybe_audit(self._pop_audit_snap(), q, k, None, ids,
                              dists)
            t2 = time.perf_counter()
            out = self.hydrate_raw_packed(ids, dists)
            t3 = time.perf_counter()
            if rec is not None:
                rec.phase("device_search", (t2 - t1) * 1000.0)
                rec.phase("hydrate", (t3 - t2) * 1000.0)
            if shape is not None:
                shape.hydrate_ms = (t3 - t2) * 1000.0
            self._trace_dispatch_facts(rec, q.shape[0], k, lock_wait, shape)
            if m is not None:
                m.filtered_vector_search.labels(cls, self.name).observe((t2 - t1) * 1000.0)
                m.filtered_vector_objects.labels(cls, self.name).observe(
                    (t3 - t2) * 1000.0)
                m.vector_index_ops.labels("search", cls, self.name).inc(q.shape[0])
                m.query_dimensions.labels("nearVector", "search", cls).inc(
                    int(q.shape[0] * q.shape[1]))
            return out
        finally:
            if rec is not None and rec.owned:
                rec.finish()

    def hydrate_raw_packed(self, ids, dists):
        """Packed twin of _hydrate_batch: docid -> uuid -> image entirely in
        buffer space; one call's value arena IS the next call's key buffer."""
        dists = np.asarray(dists, dtype=np.float32)
        ids = np.asarray(ids)
        valid = ~np.isinf(dists)
        counts = valid.sum(axis=1).astype(np.int64)
        flat_ids = ids[valid].astype("<u8")
        key_offs = np.arange(flat_ids.size + 1, dtype=np.int64) * 8
        r1 = self.docid_lookup.multi_get_packed(flat_ids.tobytes(), key_offs)
        if r1 is None:
            return None
        ubuf, uoffs, _ = r1
        r2 = self.objects.multi_get_packed(ubuf, uoffs)
        if r2 is None:
            return None
        vbuf, voffs, vflags = r2
        return vbuf, voffs, vflags, dists[valid], counts

    def _hydrate_batch(
        self, ids, dists, include_vector: bool
    ) -> list[list[SearchResult]]:
        """All queries' winners in one pass: one valid-mask over [B, k], one
        LSM multi-get per store (docid -> uuid key -> image, single lock
        acquisition each), lazy StorObj wrappers. The per-result Python work
        is one object alloc + one SearchResult. Under the fused dispatch
        `ids`/`dists` arrive as VIEWS into the search's one packed device
        fetch (final doc ids translated on device — index/gpu.py) — the
        np.asarray normalizations below are no-ops there, and this method
        is the first host code that looks at per-row content at all."""
        dists = np.asarray(dists, dtype=np.float32)
        ids = np.asarray(ids)
        valid = ~np.isinf(dists)
        counts = valid.sum(axis=1)
        flat_ids = ids[valid]
        flat_d = dists[valid].tolist()
        keys = [struct.pack("<Q", int(d)) for d in flat_ids]
        ukeys = self.docid_lookup.multi_get(keys)
        raws = self.objects.multi_get(ukeys)
        name = self.name
        out_all: list[list[SearchResult]] = []
        pos = 0
        for c in counts.tolist():
            # raw images ride the SearchResult; StorObj materializes only if
            # a consumer touches .obj (the gRPC fast path never does)
            out_all.append([
                SearchResult(raw=raws[j], include_vector=include_vector,
                             distance=flat_d[j], shard=name)
                for j in range(pos, pos + c)
                if raws[j] is not None  # deleted between search + hydration
            ])
            pos += c
        return out_all

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
        """BM25 / filter-only / list search (search.go objectSearch)."""
        if keyword_ranking:
            allow = self.build_allow_list(flt)
            engine = self.bm25_device if self.bm25_device is not None else self.bm25
            hits = engine.search(
                keyword_ranking.get("query", ""),
                limit + offset,
                properties=keyword_ranking.get("properties") or None,
                allow_list=allow,
                additional_explanations=keyword_ranking.get("additionalExplanations", False),
            )
            hits = hits[offset : offset + limit]
            objs = self.objects_by_doc_ids([h[0] for h in hits], include_vector)
            out = []
            for (doc_id, score, explain), obj in zip(hits, objs):
                if obj is None:
                    continue
                out.append(
                    SearchResult(
                        obj=obj,
                        score=float(score),
                        explain_score=str(explain) if explain else None,
                        shard=self.name,
                    )
                )
            return out
        if flt is not None:
            bm = self.searcher.doc_ids(flt)
            doc_ids = bm.to_array()
        else:
            doc_ids = self.inverted.all_doc_ids().to_array()
        if cursor_after is not None:
            # cursor iteration is by uuid ordering (reference cursor api)
            return self._list_after(doc_ids, cursor_after, limit, include_vector)
        if sort:
            # LSM-backed sort (adapters/repos/db/sorter/): order ALL matching
            # doc ids by sort keys without full hydration, page afterwards
            from weaviate_tpu_torch.db.sorter import Sorter

            ordered = Sorter(self).sort_doc_ids(
                [int(i) for i in doc_ids], sort, offset + limit
            )
            take = np.asarray(ordered[offset : offset + limit], dtype=np.int64)
            objs = self.objects_by_doc_ids([int(i) for i in take], include_vector)
            return [SearchResult(obj=o, shard=self.name) for o in objs if o is not None]
        take = doc_ids[offset : offset + limit]
        objs = self.objects_by_doc_ids([int(i) for i in take], include_vector)
        return [SearchResult(obj=o, shard=self.name) for o in objs if o is not None]

    def keyword_search_batch(
        self,
        queries: list[str],
        limit: int,
        offset: int = 0,
        properties=None,
        include_vector: bool = False,
    ) -> Optional[list[list[SearchResult]]]:
        """Batched plain-BM25 lane: Q queries -> one device dispatch + one
        fetch (inverted/bm25_device.py search_batch). None when the device
        engine is off/unavailable — callers run the per-query path.
        Offset is applied to the RANKED hits before hydration — identical
        paging to object_search's keyword branch, so a doc deleted between
        scoring and hydration shortens the page rather than shifting it."""
        if self.bm25_device is None:
            return None
        hit_lists = self.bm25_device.search_batch(queries, limit + offset,
                                                  properties=properties)
        if hit_lists is None:
            return None
        out: list[list[SearchResult]] = []
        for hits in hit_lists:
            hits = hits[offset:offset + limit]
            objs = self.objects_by_doc_ids([h[0] for h in hits], include_vector)
            rows = []
            for (doc_id, score, _), obj in zip(hits, objs):
                if obj is None:
                    continue
                rows.append(SearchResult(obj=obj, score=float(score),
                                         shard=self.name))
            out.append(rows)
        return out

    def _list_after(self, doc_ids, after_uuid: str, limit: int, include_vector: bool):
        objs = self.objects_by_doc_ids([int(i) for i in doc_ids], include_vector)
        pairs = sorted((o.uuid, o) for o in objs if o is not None)
        out = []
        for u, o in pairs:
            if after_uuid and u <= after_uuid:
                continue
            out.append(SearchResult(obj=o, shard=self.name))
            if len(out) >= limit:
                break
        return out

    def find_doc_ids(self, flt: Optional[LocalFilter]) -> Bitmap:
        """Doc IDs matching a filter (batch delete-by-filter support)."""
        if flt is None:
            return self.inverted.all_doc_ids()
        return self.searcher.doc_ids(flt)

    def find_objects(self, flt: Optional[LocalFilter],
                     include_vector: bool = True) -> list[StorObj]:
        """Hydrated objects matching a filter (None = all live) — the data
        plane shared by Aggregate (local and clusterapi :aggregations) and
        uuid listing."""
        ids = self.find_doc_ids(flt).to_array()
        objs = self.objects_by_doc_ids([int(i) for i in ids], include_vector)
        return [o for o in objs if o is not None]

    def find_uuids(self, flt: Optional[LocalFilter]) -> list[str]:
        return [o.uuid for o in self.find_objects(flt, include_vector=False)]

    def aggregate_columns(self, flt: Optional[LocalFilter],
                          props: list[str]) -> dict:
        """Row-aligned property columns for Aggregate pushdown: ships only
        the referenced columns (count + raw values, None kept for row
        alignment) instead of whole objects, bounding coordinator memory and
        the wire to the columns the query names while keeping
        median/mode/topOccurrences/groupBy exact (the reference pushes
        per-shard aggregation down and merges)."""
        objs = self.find_objects(flt, include_vector=False)
        return {
            "count": len(objs),
            "cols": {p: [o.properties.get(p) for o in objs] for p in props},
        }

    def reindex_missing_filterable(self) -> dict[str, int]:
        """Backfill filterable postings for docs indexed before their prop's
        indexFilterable flag was on (INDEX_MISSING_TEXT_FILTERABLE_AT_STARTUP;
        reference: inverted_reindexer_missing_text_filterable.go). Detection
        is per-doc (null-bucket coverage), so partially-indexed props — flag
        flipped mid-life — backfill exactly their pre-flip docs.
        -> {prop: docs indexed}."""
        with self._lock:
            missing = self.inverted.unindexed_filterable(self.object_count())
            if not missing:
                return {}
            union = None
            for bm in missing.values():
                union = bm if union is None else union.or_(bm)
            doc_ids = [int(i) for i in union.to_array()]

            def rows():
                step = 512
                for s in range(0, len(doc_ids), step):
                    chunk = doc_ids[s : s + step]
                    objs = self.objects_by_doc_ids(chunk, include_vector=False)
                    for did, o in zip(chunk, objs):
                        if o is not None:
                            yield did, o.properties

            return self.inverted.backfill_filterable(missing, rows())

    # -- lifecycle -----------------------------------------------------------

    def flush(self) -> None:
        self.store.flush_all()
        self.vector_index.flush()
        for g in self._geo_indexes.values():
            g.flush()

    def shutdown(self) -> None:
        self.store.shutdown()
        self.vector_index.shutdown()
        for g in self._geo_indexes.values():
            g.shutdown()

    def drop(self) -> None:
        self.vector_index.drop()
        for g in self._geo_indexes.values():
            g.drop()
        self.store.drop()
        self.counter.drop()
        import shutil

        shutil.rmtree(self.path, ignore_errors=True)

    def paused_writes(self):
        """Hold the shard's write lock around a file copy: no write, flush,
        or WAL truncation can interleave (the reference's pause-compaction-
        and-commitlog window, adapters/repos/db/backup.go)."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            with self._lock:
                with self.store.compaction_paused():
                    self.flush()
                    yield

        return _ctx()

    def list_files(self) -> list[str]:
        """Files to copy for a backup (shard_backup.go ListBackupFiles)."""
        out = self.store.list_files()
        out.extend(self.vector_index.list_files())
        if os.path.exists(self.counter.path):
            out.append(self.counter.path)
        return out

    def post_startup(self) -> None:
        self.vector_index.post_startup()
