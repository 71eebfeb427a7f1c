"""The mesh-sharded vector index ("hnsw_tpu_mesh"): the port of
`weaviate_tpu/index/mesh.py`.

One logical shard's vectors are spread over an ordered list of torch
devices (`parallel/mesh_search.make_mesh`), one [n_loc, D] slab each, and
every operation runs over all slabs from one process (the steps in
`parallel/mesh_search.py`):

- insert: rows are placed by level-fill (`_assign_balanced`: the emptiest
  slabs are topped up first) and land as one run per slab at the slab's
  own offset;
- search: per slab, the scan of its tier and a local top-k on its own
  device, enqueued without a host synchronisation; the slabs' candidate
  blocks go to the lead device (slab 0's), where one reselect merges
  them; the fused dispatch translates each slab's winners through its own
  slot->doc column before the merge, so finalize is ONE device->host
  fetch and dtype views, as on one device;
- delete: each slab tombstones the global rows inside it;
- filters: the allowList becomes packed words per slab, ANDed into each
  slab's validity mask on its device;
- growth: every slab doubles, into new tensors (maintainance.go:31).

Reads are SNAPSHOT-ISOLATED (docs/concurrency.md, docs/mesh_serving.md):
writers publish an immutable MeshSnapshot with one reference swap; readers
grab it without the index lock and run the whole two-phase dispatch
(enqueue on the snapshot, fetch outside any lock). The reference's write
steps never donate their inputs, so a published snapshot pins the slabs it
was built from. Here a write copies any slab the published snapshot holds
before it lands (`_own`) and writes in place only into slabs no snapshot
has seen; growth, compression and compaction build new slabs: deletes,
growth, compression and compaction never tear an in-flight dispatch.

Durability is the single-device index's VectorLog (add and delete
records, a torn tail tolerated). The log is placement-independent, so a
shard restarts onto another slab count and the replay re-balances; a
single-device shard's directory opens as a mesh, and the JAX package's
mesh and this one read each other's logs.

Tiers, in the reference's order (`_dispatch_search`):
  - uncompressed: IVF when trained and enabled; else K1 per slab when
    `_gmin_plan` allows (l2/dot/cosine, slabs of 16384 rows or more,
    batches of 8 or more, a resident-tile plan for the depth: the port's
    `gmin_scan.resident_plan` stands where the reference's VMEM plan
    `fits_vmem` stood), over an f32 store or a bf16 one (`storeDtype`);
    else the chunked exact scan (manhattan and hamming always);
  - PQ (l2/dot/cosine only; compression downcasts the store to bf16, the
    per-slab rescore source, and moves the f32 rows to host memory):
    bits 4, the funnel per slab with the byte-LUT stage 1; codes only
    (`rescore: false`), K2 per slab when `pq_gmin.eligible_rg` allows;
    otherwise the reconstruction scan per slab, rescored against the bf16
    slab when `rescore` is on.
The mesh has no gather tier (small allowLists run the masked scan) and no
PCA prefilter. IVF trains one k-means codebook over every slab's rows,
off the lock from a pinned snapshot, and gives each slab its own balanced
bucket table of the slab's rows (one shared padded width).

`KernelState`, `guarded_kernel_call`, `_gmin_broken`, `_gmin_validated`
and the per-kernel failure domains of the reference are not ported (the
port's rules): a kernel's failed launch raises KernelLaunchError or
KernelCallError, and a device error feeds the Shard's breaker, whose host
plane (`search_by_vectors_host`) is the reference's.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from weaviate_tpu_torch.compress.pq import ProductQuantizer, pack_codes4
from weaviate_tpu_torch.config.config import PQ4_FUNNEL_C_BUCKETS, PQ4_FUNNEL_RESCORE_BUCKETS
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.index.gpu import (VectorLog, _bucket_b, _fetch_packed,
                                          _prep_bulk_run, _snap_top_p,
                                          fused_dispatch_enabled, ivf_settings)
from weaviate_tpu_torch.index.interface import AllowList, VectorIndex
from weaviate_tpu_torch.monitoring import costmodel, memory, quality, tracing
from weaviate_tpu_torch.monitoring.costmodel import (TIER_EXACT, TIER_PQ_ADC4, TIER_PQ_CODES,
                                                     TIER_PQ_RESCORE, DispatchShape)
from weaviate_tpu_torch.ops import gmin_scan, pq_gmin
from weaviate_tpu_torch.ops import ivf as ivf_ops
from weaviate_tpu_torch.ops import pq4 as pq4_ops
from weaviate_tpu_torch.ops.topk import unpack_fused, unpack_topk
from weaviate_tpu_torch.parallel.mesh_search import (
    _MESH_SCAN_CHUNK, make_mesh, mesh_delete_step, mesh_grow, mesh_insert_step,
    mesh_search_gmin_step, mesh_search_ivf_step, mesh_search_pq4_step,
    mesh_search_pq_gmin_step, mesh_search_pq_step, mesh_search_step,
    mesh_write_pairs_step, mesh_write_rows_step, replicate)
# the recall-guarded probe-depth and funnel caps share the single-device
# controller; it imports nothing from the index layer, so no cycle
from weaviate_tpu_torch.serving import controller
from weaviate_tpu_torch.storage.bitmap import Bitmap, allowed_mask, pack_allow_words
from weaviate_tpu_torch.testing import faults, sanitizers

_log = logging.getLogger(__name__)

_MIN_LOC = 1024       # minimum slab rows (a power of two, a multiple of 32)
_FLUSH_CHUNK = 8192   # staged rows that trigger a flush


def _pow2_at_least(n: int, floor: int) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _copy(lst: Optional[list]) -> Optional[list]:
    return None if lst is None else list(lst)


def _first(lst: Optional[list]):
    return None if not lst else lst[0]


class MeshSnapshot:
    """An immutable view of the mesh index state, published atomically.

    The single-device IndexSnapshot's contract (index/gpu.py): the
    constructor copies REFERENCES under the write lock, and the per-slab
    lists themselves, so a later write that swaps a slab leaves this view
    alone; a slab this view holds is never written (the index copies it
    first, `MeshVectorIndex._own`); ``host_tombs`` is copy-on-write;
    ``slot_to_doc`` is written only at rows past this view's per-slab
    counts; ``counts`` is copied outright."""

    __slots__ = (
        "gen", "dim", "n_dev", "n_loc", "counts", "n_total", "live", "store", "sq_norms",
        "tombs", "slot_to_doc", "slot_to_doc_dev", "host_tombs", "allow_token",
        "compressed", "pq", "codes", "recon_norms", "pq4", "codes4", "recon_norms4",
        "opq_rot", "host_vecs", "ivf_centroids", "ivf_buckets", "ivf_meta",
    )

    def __init__(self, gen: int, idx: "MeshVectorIndex"):
        self.gen = gen
        self.dim = idx.dim
        self.n_dev = idx.n_dev
        self.n_loc = idx.n_loc
        self.counts = idx._counts.copy()
        self.n_total = int(self.counts.sum())
        self.live = idx.live
        self.store = _copy(idx._store)
        self.sq_norms = _copy(idx._sq_norms)
        self.tombs = _copy(idx._tombs)
        self.slot_to_doc = idx._slot_to_doc
        self.slot_to_doc_dev = _copy(idx._s2d_dev)
        self.host_tombs = idx._host_tombs
        self.allow_token = idx._allow_token
        self.compressed = idx.compressed
        self.pq = idx._pq
        self.codes = _copy(idx._codes)
        self.recon_norms = _copy(idx._recon_norms)
        self.pq4 = idx._pq4
        self.codes4 = _copy(idx._codes4)
        self.recon_norms4 = _copy(idx._recon_norms4)
        self.opq_rot = _copy(idx._opq_rot_dev)
        self.host_vecs = idx._host_vecs
        self.ivf_centroids = _copy(idx._ivf_centroids)
        self.ivf_buckets = _copy(idx._ivf_buckets)
        self.ivf_meta = idx._ivf_meta


class MeshVectorIndex(VectorIndex):
    # serving layers key off this: filtered lanes ride the coalesced
    # two-phase dispatch instead of falling back to the sync pool
    async_supports_filters = True

    _HOST_SCAN_CHUNK = 65536  # rows per host-fallback scan block

    def __init__(
        self,
        config: vi.HnswUserConfig,
        shard_path: str,
        shard_name: str = "",
        device=None,
        persist: bool = True,
        metrics=None,
        class_name: str = "",
        mesh=None,
        initial_capacity_per_shard: Optional[int] = None,
        dim_hint: Optional[int] = None,
    ):
        """`device` picks the kind of mesh (the card by default, "cpu" on
        request) when `mesh` does not name the devices outright;
        `config.mesh_devices` (meshDevices) is its slab count, 0 for all."""
        self.config = config
        self.metric = config.distance
        self.shard_path = shard_path
        self.shard_name = shard_name
        self.class_name = class_name
        self.metrics = metrics
        self.mesh = (make_mesh(devices=mesh) if mesh is not None
                     else make_mesh(config.mesh_devices or None, device=device))
        self.n_dev = len(self.mesh)
        self.device = self.mesh[0]  # the lead device: the merge and the fetch
        self.dtype = torch.bfloat16 if config.store_dtype == "bfloat16" else torch.float32
        self._lock = sanitizers.register_lock(threading.RLock(), "index.mesh")
        self._init_loc = _pow2_at_least(initial_capacity_per_shard or _MIN_LOC, 32)
        self.dim: Optional[int] = None
        self.n_loc = 0               # slab rows per device
        self.live = 0
        self._store: Optional[list] = None     # per slab [n_loc, D] self.dtype
        self._sq_norms: Optional[list] = None  # per slab [n_loc] f32 (l2)
        self._tombs: Optional[list] = None     # per slab [n_loc] bool
        self._s2d_dev: Optional[list] = None   # per slab [n_loc] int64, -1 unwritten
        self._counts = np.zeros(self.n_dev, dtype=np.int64)
        self._slot_to_doc = np.zeros(0, dtype=np.int64)  # global row -> doc
        self._host_tombs = np.zeros(0, dtype=bool)  # COW: snapshots pin copies
        self._doc_to_row: dict[int, int] = {}
        self._pending: dict[int, np.ndarray] = {}
        self._pending_tombs: list[int] = []
        # snapshot plane (docs/mesh_serving.md): readers are lock-free on
        # the published MeshSnapshot; staged/published generations drive
        # the republish-on-read slow path
        self._snap: Optional[MeshSnapshot] = None
        self._snap_gen = 0
        self._staged_gen = 0
        self._published_gen = -1  # != staged: the first read publishes
        self._staged_t0: Optional[float] = None
        self._read_local = threading.local()
        self._inflight = 0
        self._inflight_lock = sanitizers.register_lock(threading.Lock(), "index.mesh.inflight")
        self._inflight_gauge = None
        self._host_rows_cache = None  # (gen, rows, sq) breaker-path cache
        # device generation: compact/drop re-create the slabs; an off-lock
        # IVF trainer must abandon results targeted at a dead epoch
        self._device_epoch = 0
        # IVF plane: stats lock is leaf-level, ordered after index.mesh
        self._ivf_lock = sanitizers.register_lock(threading.Lock(), "index.mesh.ivf")
        self._ivf_stats = {"dispatches": 0, "probed_rows": 0, "base_rows": 0}
        self._ivf_centroids_host: Optional[np.ndarray] = None  # [nlist, D] f32
        self._ivf_centroids: Optional[list] = None  # per-slab replicas
        self._ivf_buckets: Optional[list] = None    # per slab [nlist, cap_p] int32
        self._ivf_assign = np.zeros(0, dtype=np.int32)  # per-row partition
        self._ivf_fills: Optional[np.ndarray] = None    # [n_dev, nlist] bucket fills
        self._ivf_cap_p = 0
        self._ivf_meta = None             # (nlist, cap_p, gen)
        self._ivf_dirty = False
        self._ivf_trained_n = 0
        self._ivf_gen = 0
        self._ivf_backlog = None          # rows written during off-lock training
        # PQ state: codes and ||recon||^2 shard like the store; the (bf16)
        # store stays resident as the per-slab rescore source
        self.compressed = False
        self._pq: Optional[ProductQuantizer] = None
        self._codes: Optional[list] = None         # per slab [n_loc, M]
        self._recon_norms: Optional[list] = None   # per slab [n_loc] f32
        self._pq4: Optional[ProductQuantizer] = None  # the 4-bit rung (16 centroids)
        self._codes4: Optional[list] = None        # per slab [n_loc, M/2] uint8
        self._recon_norms4: Optional[list] = None  # per slab [n_loc] f32
        self._opq_rot_dev: Optional[list] = None   # per-slab replicas of [D, D] f32
        self._host_vecs: Optional[np.ndarray] = None  # [cap, D] f32 (compressed only)
        self._pq_path = os.path.join(shard_path, "pq.npz") if shard_path else ""
        self._pq4_path = os.path.join(shard_path, "pq4.npz") if shard_path else ""
        # a quantizer's codebook and rotation on each device of the mesh
        self._pq_replicas: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._restoring = False
        # identity token for the per-allowList packed-words cache
        self._allow_token = object()
        # host-memory provider (monitoring/memory.py): slot map, PQ host
        # rows and staged rows become /debug/memory host components
        memory.register_host_provider(self, memory.index_host_components)
        self._log = VectorLog(os.path.join(shard_path, "vector.log")) if persist else None
        if dim_hint is not None:
            self._init_device(int(dim_hint))
        if self._log is not None:
            self._restore()

    # -- lifecycle -----------------------------------------------------------

    def _restore(self) -> None:
        """Replay the vector log (startup.go:56 analog). Placement is
        recomputed at replay time, so the same log restores onto any mesh;
        a persisted pq.npz re-enters compressed mode."""
        self._restoring = True
        try:
            replay_stats: dict = {}
            for op, ids, vecs in VectorLog.replay_batches(self._log.path, stats=replay_stats):
                if op == "add":
                    self._bulk_stage_add(ids, vecs)
                else:
                    self._stage_delete(int(ids), log=False)
            VectorLog.report_replay_stats(self._log.path, replay_stats)
            self.last_replay_stats = replay_stats
            if self._pq_path and os.path.exists(self._pq_path):
                self._flush_pending()
                if self.live > 0:
                    self._enable_pq(ProductQuantizer.load(self._pq_path, device=self.device),
                                    [st.float() for st in self._store], save=False)
        finally:
            self._restoring = False

    def post_startup(self) -> None:
        self.flush()

    # -- memory ledger stamping (monitoring/memory.py) -----------------------

    def _memory_components(self) -> dict:
        """Byte sizes of the slab buffers from shapes and dtypes (no sync):
        per-slab buffers summed over the slabs, replicated ones counted
        once (the reference's global sizes; the ledger divides by ndev for
        the per-device headroom)."""
        comps: dict = {}
        for name, lst in (("store", self._store),
                          ("sq_norms", self._sq_norms),
                          ("tombs", self._tombs),
                          ("slot_to_doc", self._s2d_dev),
                          ("pq_codes", self._codes),
                          ("recon_norms", self._recon_norms),
                          ("pq4_codes", self._codes4),
                          ("pq4_norms", self._recon_norms4),
                          ("ivf_buckets", self._ivf_buckets)):
            b = sum(memory.array_bytes(t) for t in lst) if lst else 0
            if b:
                comps[name] = b
        for name, lst in (("opq_rot", self._opq_rot_dev),
                          ("ivf_centroids", self._ivf_centroids)):
            b = memory.array_bytes(_first(lst))
            if b:
                comps[name] = b
        return comps

    def _stamp_memory(self) -> None:
        """Every method that binds a slab buffer flows through here."""
        led = memory.get_ledger()
        if led is not None:
            led.stamp_device(self, self._memory_components(), ndev=self.n_dev)

    # -- device plumbing -----------------------------------------------------

    def _zeros(self, shape, dtype, fill=0) -> list:
        return [torch.full(shape, fill, dtype=dtype, device=d) for d in self.mesh]

    def _init_device(self, dim: int) -> None:
        self.dim = dim
        self.n_loc = self._init_loc
        cap = self.n_dev * self.n_loc
        self._store = self._zeros((self.n_loc, dim), self.dtype)
        self._sq_norms = self._zeros((self.n_loc,), torch.float32)
        self._tombs = self._zeros((self.n_loc,), torch.bool, False)
        self._s2d_dev = self._zeros((self.n_loc,), torch.int64, -1)
        self._slot_to_doc = np.full(cap, -1, dtype=np.int64)
        self._host_tombs = np.zeros(cap, dtype=bool)
        self._ivf_assign = np.full(cap, -1, dtype=np.int32)
        self._device_epoch += 1
        if self._ivf_centroids_host is not None:
            self._ivf_dirty = True
        if self.compressed and self._pq is not None:
            # a device reset in compressed mode (compact) re-creates the
            # code slabs too; _write_balanced re-encodes rows as they land
            self._codes = self._zeros((self.n_loc, self._pq.segments), self._pq.code_dtype)
            self._recon_norms = self._zeros((self.n_loc,), torch.float32)
            if self._pq4 is not None:
                self._codes4 = self._zeros((self.n_loc, self._pq4.segments // 2), torch.uint8)
                self._recon_norms4 = self._zeros((self.n_loc,), torch.float32)
            self._host_vecs = np.zeros((cap, dim), np.float32)
        self._stamp_memory()

    def _grow(self, needed_per_shard: int) -> None:
        new_loc = self.n_loc
        while new_loc < needed_per_shard:
            new_loc *= 2
        if new_loc == self.n_loc:
            return
        old_loc = self.n_loc
        self._store = mesh_grow(self._store, new_loc, 0)
        self._sq_norms = mesh_grow(self._sq_norms, new_loc, 0)
        self._tombs = mesh_grow(self._tombs, new_loc, False)
        self._s2d_dev = mesh_grow(self._s2d_dev, new_loc, -1)
        if self.compressed:
            self._codes = mesh_grow(self._codes, new_loc, 0)
            self._recon_norms = mesh_grow(self._recon_norms, new_loc, 0)
            if self._codes4 is not None:
                self._codes4 = mesh_grow(self._codes4, new_loc, 0)
                self._recon_norms4 = mesh_grow(self._recon_norms4, new_loc, 0)
            hv = np.zeros((self.n_dev * new_loc, self.dim), np.float32)
            for s in range(self.n_dev):
                hv[s * new_loc: s * new_loc + old_loc] = self._host_vecs[
                    s * old_loc: (s + 1) * old_loc]
            self._host_vecs = hv
        cap = self.n_dev * new_loc
        # remap global rows: slab-local offsets are preserved. Fresh host
        # arrays every grow: published snapshots keep the old ones.
        s2d = np.full(cap, -1, dtype=np.int64)
        ht = np.zeros(cap, dtype=bool)
        ia = np.full(cap, -1, dtype=np.int32)
        for s in range(self.n_dev):
            c = int(self._counts[s])
            s2d[s * new_loc: s * new_loc + c] = self._slot_to_doc[s * old_loc: s * old_loc + c]
            ht[s * new_loc: s * new_loc + old_loc] = self._host_tombs[
                s * old_loc: (s + 1) * old_loc]
            ia[s * new_loc: s * new_loc + old_loc] = self._ivf_assign[
                s * old_loc: (s + 1) * old_loc]
        self._slot_to_doc = s2d
        self._host_tombs = ht
        self._ivf_assign = ia
        occ = np.flatnonzero((s2d >= 0) & ~ht)
        self._doc_to_row = dict(zip(s2d[occ].tolist(), occ.tolist()))
        # staged-but-unflushed tombstone rows move with their slab
        self._pending_tombs = [(r // old_loc) * new_loc + (r % old_loc)
                               for r in self._pending_tombs]
        if self._ivf_backlog is not None:
            self._ivf_backlog = [((g // old_loc) * new_loc + (g % old_loc), r)
                                 for g, r in self._ivf_backlog]
        self.n_loc = new_loc
        led = memory.get_ledger()
        if led is not None:
            led.note_write_shape(("mesh_grow", self.n_dev, new_loc, self.dim or 0,
                                  self.compressed))
        self._stamp_memory()

    def _own(self, attr: str, snap_attr: str, slabs) -> list:
        """The per-slab list `attr`, each slab of `slabs` that the published
        snapshot holds replaced by a copy first: a write then lands only in
        slabs no snapshot has seen (the reference's non-donating writes)."""
        lst = getattr(self, attr)
        held = getattr(self._snap, snap_attr) if self._snap is not None else None
        if held:
            for s in slabs:
                if held[s] is lst[s]:
                    lst[s] = lst[s].clone()
        return lst

    # -- staging -------------------------------------------------------------

    def _mark_dead(self, row: int) -> None:
        """Tombstone `row` in the host mask, copy-on-write: a published
        snapshot referencing the current mask keeps its version."""
        snap = self._snap
        if snap is not None and snap.host_tombs is self._host_tombs:
            self._host_tombs = self._host_tombs.copy()
        self._host_tombs[row] = True

    def _stage_add(self, doc_id: int, vector: np.ndarray, log: bool = True) -> None:
        vector = np.asarray(vector, dtype=np.float32)
        if self.metric == vi.DISTANCE_COSINE:
            nrm = float(np.linalg.norm(vector))
            if nrm > 0:
                vector = vector / nrm
        if self.dim is None:
            self._init_device(int(vector.shape[0]))
        elif vector.shape[0] != self.dim:
            raise ValueError(f"dim mismatch: index has {self.dim}, got {vector.shape[0]}")
        old = self._doc_to_row.pop(doc_id, None)
        if old is not None:
            self._pending_tombs.append(old)
            self._mark_dead(old)  # a dead row must not resurrect via _grow
            self.live -= 1
        if doc_id in self._pending:
            self.live -= 1
        self._pending[doc_id] = vector
        self.live += 1
        self._staged_gen += 1
        self._mark_staged()
        if log and self._log is not None:
            self._log.append_add(doc_id, vector)
        if len(self._pending) >= _FLUSH_CHUNK:
            self._flush_pending()

    def _bulk_stage_add(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Restore-path bulk staging: a run of add records feeds the
        staging buffer in one dict update with _stage_add's semantics;
        small runs and docs the index already knows take the per-record
        path."""
        if len(ids) < 256:
            for d, v in zip(ids.tolist(), vecs):
                self._stage_add(int(d), v, log=False)
            return
        if self.dim is None:
            self._init_device(int(np.asarray(vecs).shape[1]))
        elif np.asarray(vecs).shape[1] != self.dim:
            raise ValueError(
                f"dim mismatch: index has {self.dim}, got {np.asarray(vecs).shape[1]}")
        d2r = self._doc_to_row
        ids64, vecs, known = _prep_bulk_run(
            ids, vecs, self.metric, lambda d: d in d2r or d in self._pending)
        if known:
            for i in known:
                self._stage_add(int(ids64[i]), vecs[i], log=False)
            keep = np.ones(len(ids64), bool)
            keep[known] = False
            ids64, vecs = ids64[keep], vecs[keep]
            if len(ids64) == 0:
                return
        self._pending.update(zip(ids64.tolist(), vecs))
        self.live += len(ids64)
        self._staged_gen += 1
        self._mark_staged()
        if len(self._pending) >= _FLUSH_CHUNK:
            self._flush_pending()

    def _stage_delete(self, doc_id: int, log: bool = True) -> None:
        row = self._doc_to_row.pop(doc_id, None)
        if row is None:
            if doc_id in self._pending:
                del self._pending[doc_id]
                self.live -= 1
                self._staged_gen += 1
                self._mark_staged()
                if log and self._log is not None:
                    self._log.append_delete(doc_id)
            return
        self._pending_tombs.append(row)
        self._mark_dead(row)  # a dead row must not resurrect via _grow
        self.live -= 1
        self._staged_gen += 1
        self._mark_staged()
        if log and self._log is not None:
            self._log.append_delete(doc_id)

    def _assign_balanced(self, count: int) -> list[np.ndarray]:
        """Split `count` new rows over slabs so slab fills equalize (the
        chip-level analog of the virtual-shard ring's even spread,
        usecases/sharding/state.go:261): slab s takes a contiguous run of
        the rows, in slab order."""
        counts = self._counts.copy()
        takes = np.zeros(self.n_dev, dtype=np.int64)
        remaining = count
        # level-fill: repeatedly top up the emptiest slabs
        while remaining > 0:
            order = np.argsort(counts + takes)
            lo = order[0]
            if self.n_dev > 1:
                second = counts[order[1]] + takes[order[1]]
                gap = int(second - (counts[lo] + takes[lo]))
                step = max(1, min(remaining, gap if gap > 0 else remaining // self.n_dev + 1))
            else:
                step = remaining
            takes[lo] += step
            remaining -= step
        out, off = [], 0
        for s in range(self.n_dev):
            out.append(np.arange(off, off + int(takes[s])))
            off += int(takes[s])
        return out

    def _flush_pending(self) -> None:
        """Land staged adds and tombstones on the slabs. A PURE staging
        drain (no compression, no IVF training), so the read path's
        republish can call it."""
        led = memory.get_ledger()
        if self._pending:
            t0 = time.perf_counter()
            rows = np.stack(list(self._pending.values()))
            docs = np.array(list(self._pending.keys()), dtype=np.int64)
            self._write_balanced(docs, rows)
            self._pending.clear()
            if led is not None:
                led.note_write("add", "flush", (time.perf_counter() - t0) * 1000.0,
                               rows=rows.shape[0], bytes_moved=rows.shape[0] * (self.dim or 0) * 4)
        if self._pending_tombs:
            t0 = time.perf_counter()
            rows = np.array(self._pending_tombs, dtype=np.int64)
            slabs = np.unique(rows // self.n_loc).tolist()
            mesh_delete_step(self._own("_tombs", "tombs", slabs), rows, self.n_loc)
            if led is not None:
                led.note_write("delete", "apply_tombstones",
                               (time.perf_counter() - t0) * 1000.0,
                               rows=len(self._pending_tombs))
            self._pending_tombs.clear()
            self._stamp_memory()

    def _maybe_autocompress(self) -> None:
        """Declarative pq.enabled compresses once enough data exists to fit
        codebooks (the single-device trigger). Reached only from flush(),
        compress() and update_user_config."""
        if not (self.config.pq.enabled and not self.compressed and not self._restoring
                and self.live >= max(256, self.config.pq.centroids)):
            return
        try:
            self._compress_locked()
        except vi.ConfigValidationError as e:
            # a pq config that only turns out invalid once dims are known
            # must not turn every later add or search into an error
            self.config.pq.enabled = False
            _log.warning("declared pq config is invalid (%s); auto-disabling "
                         "compression for this index", e)

    def _write_balanced(self, docs: np.ndarray, rows: np.ndarray) -> None:
        """Land [count, D] f32 rows across the slabs: one run per slab at
        its own offset, the slot->doc ids beside them, and under PQ the
        rows' codes (encode on write)."""
        assign = self._assign_balanced(rows.shape[0])
        self._grow(max(int(self._counts[s]) + len(assign[s]) for s in range(self.n_dev)))
        slabs = [s for s in range(self.n_dev) if len(assign[s])]
        offsets = self._counts.copy()
        chunks = [rows[a[0]: a[-1] + 1] if len(a) else None for a in assign]
        mesh_insert_step(self._own("_store", "store", slabs),
                         self._own("_sq_norms", "sq_norms", slabs), chunks, offsets,
                         self.metric == vi.DISTANCE_L2)
        # the device translation columns land the same rows, so the fused
        # dispatch's on-device slot->doc stays in lockstep with the host map
        mesh_write_pairs_step(self._own("_s2d_dev", "slot_to_doc_dev", slabs),
                              [docs[a[0]: a[-1] + 1] if len(a) else None for a in assign],
                              offsets)
        if self.compressed:
            codes = [self._pq.encode(ch) if ch is not None else None for ch in chunks]
            mesh_write_rows_step(
                self._own("_codes", "codes", slabs),
                self._own("_recon_norms", "recon_norms", slabs), codes,
                [self._pq.recon_sq_norms(c) if c is not None else None for c in codes], offsets)
            if self._pq4 is not None:
                c4 = [self._pq4.encode(ch) if ch is not None else None for ch in chunks]
                mesh_write_rows_step(
                    self._own("_codes4", "codes4", slabs),
                    self._own("_recon_norms4", "recon_norms4", slabs),
                    [pack_codes4(c) if c is not None else None for c in c4],
                    [self._pq4.recon_sq_norms(c) if c is not None else None for c in c4],
                    offsets)
        for s in slabs:
            take = len(assign[s])
            base = s * self.n_loc + int(self._counts[s])
            grows = np.arange(base, base + take)
            d = docs[assign[s]]
            self._slot_to_doc[grows] = d
            self._doc_to_row.update(zip(d.tolist(), grows.tolist()))
            if self.compressed:
                self._host_vecs[grows] = chunks[s]
            if self._ivf_backlog is not None:
                # an off-lock k-means fit is in flight: queue the rows, the
                # trainer (or its finally block) assigns them
                self._ivf_backlog.append((grows, chunks[s]))
            elif self._ivf_centroids_host is not None:
                self._ivf_assign[grows] = ivf_ops.assign_partitions(
                    chunks[s], self._ivf_centroids_host)
                self._ivf_dirty = True
            self._counts[s] += take
        self._stamp_memory()

    # -- product quantization (mesh twin of the single-device compression) ---

    def compress(self) -> None:
        with self._lock:
            self._flush_pending()
            self._compress_locked()

    def _occupied_rows(self, slabs: list) -> torch.Tensor:
        """The live rows of per-slab [n_loc, D] f32 tensors, slab order,
        on the lead device (the rows a codebook is fit on)."""
        parts = []
        for s, t in enumerate(slabs):
            base = s * self.n_loc
            c = int(self._counts[s])
            keep = np.flatnonzero((self._slot_to_doc[base: base + c] >= 0)
                                  & ~self._host_tombs[base: base + c])
            parts.append(t[torch.from_numpy(keep).to(t.device)].to(self.device))
        return torch.cat(parts)

    def _compress_locked(self) -> None:
        if self.compressed:
            return
        if self.metric not in vi.MATMUL_DISTANCES:
            # the mesh PQ scan is the reconstruction matmul; the LUT scan
            # the single-device index keeps for manhattan has no mesh twin,
            # and silently wrong distances are worse than an error
            raise vi.ConfigValidationError(
                f"pq on hnsw_tpu_mesh supports l2-squared/dot/cosine, not {self.metric}")
        if self.live == 0:
            raise RuntimeError("compress requires imported vectors to fit on")
        host = [st.float() for st in self._store]
        pqc = self.config.pq
        pq = ProductQuantizer(dim=self.dim, segments=pqc.segments, centroids=pqc.centroids,
                              metric=self.metric, encoder=pqc.encoder.type,
                              distribution=pqc.encoder.distribution, rotation=pqc.rotation,
                              device=self.device)
        pq.fit(self._occupied_rows(host))
        self._enable_pq(pq, host, save=True)

    def _obtain_pq4(self, pq: ProductQuantizer, vecs_n: torch.Tensor) -> ProductQuantizer:
        """The 4-bit rung's quantizer: the persisted pq4.npz during restore
        (the same codebook across restarts); a file that does not fit only
        costs a refit with the pinned rotation."""
        if self._restoring and self._pq4_path and os.path.exists(self._pq4_path):
            try:
                pq4q = ProductQuantizer.load(self._pq4_path, device=self.device)
                if pq4q.segments == pq.segments and pq4q.centroids == pq4_ops.C4:
                    return pq4q
                _log.warning("persisted pq4.npz does not match the pq config (segments "
                             "%d vs %d, centroids %d); refitting",
                             pq4q.segments, pq.segments, pq4q.centroids)
            except Exception as e:  # noqa: BLE001 — a refit beats a dead shard
                _log.warning("could not load persisted pq4.npz (%s); refitting", e)
        pq4q = ProductQuantizer(dim=self.dim, segments=pq.segments, centroids=pq4_ops.C4,
                                metric=self.metric, encoder=vi.PQ_ENCODER_KMEANS,
                                distribution=self.config.pq.encoder.distribution,
                                rotation=vi.PQ_ROTATION_NONE, device=self.device)
        pq4q.fit(vecs_n, rotation_matrix=pq.rotation_matrix)
        return pq4q

    def _enable_pq(self, pq: ProductQuantizer, host: list, save: bool) -> None:
        """Encode every slab (host: per-slab [n_loc, D] f32 tensors; dead
        and padding rows encode garbage the masks hide) and switch to
        compressed mode. The store stays resident as the per-slab rescore
        source, downcast to bf16 when it was f32 (the single-device index's
        drop-the-float-cache move, mesh-shaped); the f32 rows move to host
        memory, so compact()'s log rewrite never persists bf16-rounded
        data."""
        t0 = time.perf_counter()
        codes = [pq.encode(h).to(h.device) for h in host]
        norms = [pq.recon_sq_norms(c.to(pq.device)).to(c.device) for c in codes]
        self._pq = pq
        self._codes, self._recon_norms = codes, norms
        if self.config.pq.bits == 4:
            # the 4-bit rung: a 16-centroid quantizer fit in the SAME
            # rotated space (the 8-bit fit's OPQ matrix pinned), each slab
            # funnelling its nibble-packed codes
            pq4q = self._obtain_pq4(pq, self._occupied_rows(host))
            c4 = [pq4q.encode(h) for h in host]
            self._pq4 = pq4q
            self._codes4 = [pack_codes4(c).to(h.device) for c, h in zip(c4, host)]
            self._recon_norms4 = [pq4q.recon_sq_norms(c).to(h.device) for c, h in zip(c4, host)]
            self._opq_rot_dev = (replicate(pq4q.rotation_dev(), self.mesh)
                                 if pq4q.rotation_matrix is not None else None)
        else:
            self._pq4 = self._codes4 = self._recon_norms4 = self._opq_rot_dev = None
        self._host_vecs = np.concatenate([h.cpu().numpy() for h in host])
        if self.dtype == torch.float32:
            self.dtype = torch.bfloat16
            self._store = [st.to(torch.bfloat16) for st in self._store]
        self.compressed = True
        # compressed mode has no IVF tier (the PQ tiers own the scan)
        self._ivf_reset()
        self._staged_gen += 1
        self._mark_staged()
        if save and self._pq_path:
            pq.save(self._pq_path)
        if save and self._pq4_path and self._pq4 is not None:
            self._pq4.save(self._pq4_path)
        led = memory.get_ledger()
        if led is not None:
            led.note_write("compress", "compress", (time.perf_counter() - t0) * 1000.0,
                           rows=self.live,
                           bytes_moved=sum(memory.array_bytes(c) for c in self._codes))
        self._stamp_memory()

    def _pq_consts(self, pq: ProductQuantizer) -> dict:
        """Per-slab replicas of a quantizer's device operands: the bf16
        codebook (the kernels'), the f32 one and its [M*C, ds] flat view
        (the exact-ADC rescores), the rotation (or None). Built once per
        quantizer; the quantizer's own copies serve its device."""
        got = self._pq_replicas.get(pq)
        if got is None:
            cb = pq.codebook_dev()
            got = {"cb_bf16": replicate(pq.codebook_bf16(), self.mesh),
                   "cb": replicate(cb, self.mesh),
                   "flat": replicate(cb.reshape(-1, pq.ds), self.mesh),
                   "rot": replicate(pq.rotation_dev(), self.mesh)}
            self._pq_replicas[pq] = got
        return got

    # -- VectorIndex ---------------------------------------------------------

    def add(self, doc_id: int, vector: np.ndarray) -> None:
        with self._lock:
            self._stage_add(int(doc_id), vector)

    def add_batch(self, doc_ids: Sequence[int], vectors: np.ndarray) -> None:
        """Bulk import: fresh unique doc_ids take the vectorized balanced
        write; collisions take per-row staging."""
        doc_arr = np.asarray(doc_ids, dtype=np.int64)
        vectors = np.asarray(vectors, dtype=np.float32)
        with self._lock:
            collides = bool(self._pending) or (bool(self._doc_to_row) and bool(np.isin(
                doc_arr, np.fromiter(self._doc_to_row.keys(), dtype=np.int64)).any()))
            fresh = (not collides and vectors.ndim == 2
                     and np.unique(doc_arr).size == doc_arr.size)
            if not fresh:
                for d, v in zip(doc_arr, vectors):
                    self._stage_add(int(d), v)
                return
            if self.metric == vi.DISTANCE_COSINE:
                norms = np.linalg.norm(vectors, axis=1, keepdims=True)
                norms[norms == 0] = 1.0
                vectors = vectors / norms
            if self.dim is None:
                self._init_device(int(vectors.shape[1]))
            elif vectors.shape[1] != self.dim:
                raise ValueError(f"dim mismatch: index has {self.dim}, got {vectors.shape[1]}")
            if self._log is not None and not self._restoring:
                self._log.append_add_batch(doc_arr, vectors)
            self._write_balanced(doc_arr, vectors)
            self.live += doc_arr.size
            self._staged_gen += 1
            self._mark_staged()

    def delete(self, *doc_ids: int) -> None:
        with self._lock:
            for d in doc_ids:
                self._stage_delete(int(d))

    def contains(self, doc_id: int) -> bool:
        with self._lock:
            return doc_id in self._doc_to_row or doc_id in self._pending

    def __len__(self) -> int:
        return self.live

    def distancer_name(self) -> str:
        return self.metric

    def _prep_queries(self, vectors: np.ndarray) -> tuple[np.ndarray, int]:
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if self.metric == vi.DISTANCE_COSINE:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            q = q / norms
        bb = _bucket_b(b)
        if bb != b:
            q = np.concatenate([q, np.zeros((bb - b, q.shape[1]), np.float32)])
        return q, b

    def padded_width(self, b: int) -> int:
        """The query-batch bucket `b` pads to: the coalescer packs lanes up
        to this width for free."""
        return _bucket_b(max(int(b), 1))

    def _allow_words(self, snap: MeshSnapshot, allow_list: AllowList) -> list:
        """Per-slab packed filter words (int32 bits) for `snap`, cached ON
        the (immutable) allowList per index state, keyed on (allow_token,
        n_total, capacity): deletions alone do not rotate the key, but a
        stale mask only re-admits tombstoned rows the tomb masks kill
        anyway."""
        cap = snap.n_dev * snap.n_loc
        key = (snap.allow_token, snap.n_total, cap)
        cached = getattr(allow_list, "_words_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        mask = np.zeros(cap, dtype=bool)
        occupied = (snap.slot_to_doc >= 0) & ~snap.host_tombs
        if occupied.any():
            docs = snap.slot_to_doc[occupied]
            if isinstance(allow_list, Bitmap):
                mask[occupied] = allowed_mask(allow_list, docs)
            else:
                mask[occupied] = allow_list.contains_array(docs.astype(np.uint64))
        words = torch.from_numpy(pack_allow_words(mask, cap).view(np.int32))
        per = snap.n_loc // 32
        out = [words[s * per: (s + 1) * per].to(d) for s, d in enumerate(self.mesh)]
        try:
            allow_list._words_cache = (key, out)
        except AttributeError:
            pass
        return out

    # -- snapshot plane (docs/mesh_serving.md) -------------------------------

    def _mark_staged(self) -> None:
        """Stamp the first staging moment of the current unpublished batch
        (ledger publish-lag attribution; nothing when the ledger is down)."""
        if self._staged_t0 is None and memory.get_ledger() is not None:
            self._staged_t0 = time.perf_counter()

    def _publish_snapshot(self) -> None:
        """Build and atomically publish a MeshSnapshot. Caller holds _lock."""
        if self._ivf_dirty:
            self._ivf_rebuild_buckets()
        self._snap_gen += 1
        self._snap = MeshSnapshot(self._snap_gen, self)
        self._published_gen = self._staged_gen
        m = self.metrics
        if m is not None:
            m.index_snapshot_gen.labels(*self._metric_labels()).set(self._snap_gen)
        self._stamp_memory()
        led = memory.get_ledger()
        if led is not None and self._staged_t0 is not None:
            led.note_publish((time.perf_counter() - self._staged_t0) * 1000.0)
        self._staged_t0 = None

    def _read_snapshot(self) -> MeshSnapshot:
        """The current MeshSnapshot, lock-free when nothing is staged: one
        reference load and one generation compare. Staged writes take the
        slow path: drain staging under the lock, republish, serve."""
        snap = self._snap
        if snap is not None and self._published_gen == self._staged_gen:
            self._read_local.lock_wait_ms = 0.0
            return snap
        t0 = time.perf_counter()
        with self._lock:
            wait_ms = (time.perf_counter() - t0) * 1000.0
            self._flush_pending()
            if self._snap is None or self._published_gen != self._staged_gen:
                self._publish_snapshot()
            snap = self._snap
        self._read_local.lock_wait_ms = wait_ms
        m = self.metrics
        if m is not None:
            m.index_lock_wait.labels(*self._metric_labels()).observe(wait_ms)
        return snap

    def pop_read_lock_wait(self) -> float:
        """Lock wait of the calling thread's last snapshot read, then 0."""
        w = getattr(self._read_local, "lock_wait_ms", 0.0)
        self._read_local.lock_wait_ms = 0.0
        return w

    @property
    def snapshot_gen(self) -> int:
        snap = self._snap
        return snap.gen if snap is not None else 0

    def _track_inflight(self, delta: int) -> None:
        with self._inflight_lock:
            self._inflight += delta
            n = self._inflight
        m = self.metrics
        if m is None:
            return
        g = self._inflight_gauge
        if g is None:
            g = m.index_inflight_dispatches.labels(*self._metric_labels())
            self._inflight_gauge = g
        g.set(n)

    def pop_dispatch_shape(self):
        """The DispatchShape of the calling thread's last dispatch (the
        serving layer hands it to the perf tracer), then None."""
        shape = getattr(self._read_local, "dispatch_shape", None)
        self._read_local.dispatch_shape = None
        return shape

    def pop_audit_snapshot(self):
        """The snapshot the calling thread's last dispatch answered from
        (set only while the quality auditor is up), then None."""
        snap = getattr(self._read_local, "audit_snap", None)
        self._read_local.audit_snap = None
        return snap

    # -- IVF plane (per-slab balanced buckets, one shared codebook) ----------

    def _ivf_nlist(self, s, n: int) -> int:
        if s.nlist > 0:
            return max(1, min(s.nlist, max(n // 8, 1)))
        target = 2 ** int(math.ceil(math.log2(max(n / 256.0, 16.0))))
        return int(max(16, min(target, 4096, max(n // 32, 16))))

    def _ivf_maybe_train(self) -> None:
        """Train or retrain the shared k-means codebook when warranted.
        Called from flush() AFTER the lock is released: the training fetch
        and fit run against a pinned snapshot, never under the index lock."""
        s = ivf_settings()
        if (s is None or self._restoring or self.compressed or self.dim is None
                or self.metric not in ivf_ops.MATMUL_METRICS
                or self.live < max(s.min_n, 256)):
            return
        if (self._ivf_centroids_host is not None
                and self.live < self._ivf_trained_n * (1.0 + s.retrain_growth)):
            return
        self._ivf_train(s)

    def _ivf_train(self, s) -> None:
        """Off-lock (re)clustering: pin a snapshot, fetch and fit outside
        the lock while concurrent writes queue into _ivf_backlog, then
        install under the lock iff the device epoch is unchanged."""
        snap = self._read_snapshot()
        if snap.dim is None or snap.n_total == 0:
            return
        epoch = self._device_epoch
        with self._lock:
            if self._ivf_backlog is not None:
                return  # another trainer is in flight
            self._ivf_backlog = []
        t0 = time.perf_counter()
        try:
            # maintenance fetch, off-lock, against the pinned snapshot
            slots, parts = [], []
            for dev in range(snap.n_dev):
                base = dev * snap.n_loc
                c = int(snap.counts[dev])
                keep = np.flatnonzero(~snap.host_tombs[base: base + c])
                slots.append(base + keep)
                parts.append(snap.store[dev][:c].float().cpu().numpy()[keep])
            rows = np.concatenate(parts)
            n = rows.shape[0]
            if n < 2:
                return
            nlist = self._ivf_nlist(s, n)
            cent = ivf_ops.kmeans_fit(rows, nlist, iters=s.train_iters, seed=self._ivf_gen,
                                      sample=min(len(rows), max(s.train_sample, nlist * 16)))
            if self.metric == vi.DISTANCE_COSINE:
                nrm = np.linalg.norm(cent, axis=1, keepdims=True)
                nrm[nrm == 0] = 1.0
                cent = cent / nrm
            # one shared spill capacity across slabs so the per-slab
            # balanced assignments share one padded bucket width
            max_per = max((int(sl.size) for sl in slots), default=0)
            cap_t = int(ivf_ops.bucket_capacity(np.array([int(1.25 * max_per / nlist) + 1])))
            a_snap = np.full(snap.n_dev * snap.n_loc, -1, dtype=np.int32)
            off = 0
            for sl in slots:
                if sl.size:
                    a_snap[sl] = ivf_ops.balanced_assign(rows[off:off + sl.size], cent, cap_t)
                off += sl.size
            with self._lock:
                if (self._device_epoch != epoch or self.dim != snap.dim
                        or self.n_loc < snap.n_loc):
                    return  # slabs were re-created under us: abandon
                assign = np.full(self.n_dev * self.n_loc, -1, dtype=np.int32)
                for dev in range(snap.n_dev):
                    assign[dev * self.n_loc: dev * self.n_loc + snap.n_loc] = a_snap[
                        dev * snap.n_loc:(dev + 1) * snap.n_loc]
                for g, r in self._ivf_backlog:
                    assign[g] = ivf_ops.assign_partitions(np.asarray(r, np.float32), cent)
                self._ivf_backlog = None
                self._ivf_assign = assign
                self._ivf_centroids_host = cent
                self._ivf_centroids = replicate(torch.from_numpy(np.ascontiguousarray(cent)),
                                                self.mesh)
                self._ivf_cap_p = cap_t
                self._ivf_trained_n = n
                self._ivf_gen += 1
                self._ivf_dirty = True
                self._staged_gen += 1
                self._mark_staged()
                self._stamp_memory()
            led = memory.get_ledger()
            if led is not None:
                led.note_write("ivf", "recluster", (time.perf_counter() - t0) * 1000.0, rows=n)
        finally:
            with self._lock:
                bl, self._ivf_backlog = self._ivf_backlog, None
                if bl and self._ivf_centroids_host is not None:
                    # install aborted after writes queued: classify the
                    # leftovers against whatever codebook is current
                    for g, r in bl:
                        self._ivf_assign[g] = ivf_ops.assign_partitions(
                            np.asarray(r, np.float32), self._ivf_centroids_host)
                    self._ivf_dirty = True

    def _ivf_rebuild_buckets(self) -> None:
        """Rebuild every slab's [nlist, cap_p] bucket table from the per-row
        assignments (one shared padded width). Caller holds _lock."""
        cent = self._ivf_centroids_host
        if cent is None or self.dim is None:
            self._ivf_dirty = False
            return
        nlist = cent.shape[0]
        per_dev = []
        for dev in range(self.n_dev):
            a = self._ivf_assign[dev * self.n_loc:(dev + 1) * self.n_loc].copy()
            a[self._host_tombs[dev * self.n_loc:(dev + 1) * self.n_loc]] = -1
            per_dev.append(a)
        fills = np.stack([np.bincount(a[a >= 0], minlength=nlist) for a in per_dev])
        # shared capacity: never below what any slab needs, never below the
        # training-time spill cap (keeps the table shape monotonic)
        cap_shared = max(int(ivf_ops.bucket_capacity(fills.reshape(-1))),
                         int(self._ivf_cap_p or 0))
        self._ivf_buckets = [torch.from_numpy(ivf_ops.build_buckets(a, nlist, cap_shared)[0])
                             .to(d) for a, d in zip(per_dev, self.mesh)]
        self._ivf_fills = fills
        self._ivf_cap_p = cap_shared
        self._ivf_meta = (nlist, cap_shared, self._ivf_gen)
        self._ivf_dirty = False
        self._stamp_memory()

    def _ivf_reset(self) -> None:
        """Drop the clustering (compact, compress and drop)."""
        self._ivf_centroids_host = None
        self._ivf_centroids = None
        self._ivf_buckets = None
        self._ivf_assign = np.zeros(0, dtype=np.int32)
        self._ivf_fills = None
        self._ivf_cap_p = 0
        self._ivf_meta = None
        self._ivf_dirty = False
        self._ivf_trained_n = 0

    def ivf_stats(self) -> dict:
        with self._ivf_lock:
            st = dict(self._ivf_stats)
        st["probed_fraction"] = (round(st["probed_rows"] / st["base_rows"], 4)
                                 if st["base_rows"] else None)
        return st

    def _ivf_plan(self, snap: MeshSnapshot, k: int) -> Optional[int]:
        """-> the effective top_p when the partition-pruned tier applies to
        this snapshot, else None (full scan)."""
        if snap.ivf_buckets is None or snap.ivf_meta is None or snap.compressed:
            return None
        s = ivf_settings()
        if s is None or self.metric not in ivf_ops.MATMUL_METRICS:
            return None
        nlist, cap_p, _gen = snap.ivf_meta
        req = min(s.top_p if s.top_p > 0 else max(1, nlist // 16), nlist)
        eff = max(1, min(req, controller.ivf_top_p_cap(req)))
        if eff < nlist:
            eff = min(_snap_top_p(eff), nlist)
        while eff < nlist and eff * cap_p < 4 * k:
            nxt = _snap_top_p(min(eff * 2, nlist))
            eff = nlist if nxt <= eff else nxt
        return eff

    def _funnel_budgets(self, k: int, n: int):
        """Controller-guarded funnel budgets planned against ONE slab (n =
        n_loc): each slab funnels its own rows, so the whole-mesh
        candidate pool is n_dev x rg4 * 16. The floors mirror the
        single-device index: the controller may only cut work, never break
        top-k coverage."""
        c_top = PQ4_FUNNEL_C_BUCKETS[-1]
        rc_top = PQ4_FUNNEL_RESCORE_BUCKETS[-1]
        c_cap = controller.funnel_c_cap(c_top)
        rc_cap = controller.funnel_rescore_cap(rc_top)
        if c_cap < 4 * k:
            c_cap = c_top
        if rc_cap < 2 * k:
            rc_cap = rc_top
        return pq4_ops.plan_funnel(k, n, c_cap, rc_cap)

    # -- search dispatch (two-phase: enqueue on the snapshot, fetch later) ---

    def dispatch_tier(self, snap: MeshSnapshot, allow_list: Optional[AllowList] = None) -> str:
        """The tier a dispatch against `snap` takes (quality auditor
        attribution). The mesh has no gather tier: small filtered reads
        run the full masked scan."""
        if snap.compressed:
            if snap.codes4 is not None and snap.pq4 is not None:
                return TIER_PQ_ADC4
            return TIER_PQ_RESCORE if self.config.pq.rescore else TIER_PQ_CODES
        return TIER_EXACT

    def _dispatch_search(self, snap: MeshSnapshot, vectors: np.ndarray, k: int,
                         allow_list: Optional[AllowList] = None):
        """Enqueue one whole-mesh search against `snap` and return the
        finalize closure: per slab the scan, the local top-k and (fused)
        the slot->doc translation, each on its own device; the merge on the
        lead device; finalize is one packed fetch and dtype views. No
        locks anywhere."""
        if snap.dim is None or snap.live == 0 or snap.n_total == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            empty = (np.zeros((b, 0), dtype=np.uint64), np.zeros((b, 0), dtype=np.float32))
            return lambda: empty
        if np.shape(vectors)[-1] != snap.dim:
            raise ValueError(f"dim mismatch: index has {snap.dim}, got {np.shape(vectors)[-1]}")
        faults.fire("index.mesh.dispatch")
        shape = None
        t_enq0 = time.perf_counter() if tracing.get_tracer() is not None else 0.0
        q, b = self._prep_queries(vectors)
        qs = replicate(torch.from_numpy(q), self.mesh)  # one upload per distinct device
        chunk = min(snap.n_loc, _MESH_SCAN_CHUNK)
        kk = max(1, min(k, snap.live, chunk))
        use_allow = allow_list is not None
        words = self._allow_words(snap, allow_list) if use_allow else None
        fused = fused_dispatch_enabled()
        s2d = snap.slot_to_doc_dev
        bpr_store = snap.dim * snap.store[0].element_size()

        if snap.compressed:
            rescore = self.config.pq.rescore
            packed_dev = None
            funnel_budgets = None
            pc = self._pq_consts(snap.pq)
            if snap.codes4 is not None and snap.pq4 is not None:
                # the 4-bit rung: per-slab three-stage funnel (byte-LUT scan
                # -> 8-bit ADC re-rank -> exact rescore against the slab's
                # own store rows), budgets recall-guarded per slab
                rg4, rc = self._funnel_budgets(kk, snap.n_loc)
                if rc >= kk:
                    packed_dev = mesh_search_pq4_step(
                        snap.codes4, snap.codes, snap.recon_norms4, snap.recon_norms,
                        snap.tombs, snap.counts, words, self._pq_consts(snap.pq4)["cb"],
                        pc["flat"], snap.store, qs, snap.opq_rot or [None] * snap.n_dev, s2d,
                        kk, self.metric, use_allow, rg4, rc, fused, self.mesh)
                    funnel_budgets = (rg4, rc)
            if packed_dev is None and not rescore:
                # codes-only tier: K2 per slab where its shape rule allows
                packed_dev = self._pq_gmin_step_or_none(snap, q, qs, kk, words, use_allow,
                                                        fused)
            if packed_dev is None:
                nchunks_eff = max(1, snap.n_loc // chunk)
                pool_target = self.config.pq.rescore_limit or 1024
                r_chunk = min(max(2 * kk, -(-pool_target // nchunks_eff), 64), 256, chunk)
                # the concatenated per-slab pool must cover k
                r_chunk = max(r_chunk, min(-(-kk // nchunks_eff), chunk))
                packed_dev = mesh_search_pq_step(
                    snap.codes, snap.recon_norms, snap.tombs, snap.counts, words,
                    pc["cb_bf16"], snap.store, qs, pc["rot"], s2d, kk, r_chunk, self.metric,
                    use_allow, rescore, fused, self.mesh)
            if t_enq0:
                if funnel_budgets is not None:
                    rg4_s, rc_s = funnel_budgets
                    shape = DispatchShape(
                        TIER_PQ_ADC4, n=snap.n_total, dim=snap.dim, batch=b,
                        batch_padded=q.shape[0], bytes_per_row=snap.pq4.segments // 2,
                        k=int(kk), ndev=snap.n_dev,
                        extra={
                            # per-slab budgets x n_dev: whole-dispatch
                            # survivor counts
                            "funnel_c": rg4_s * 16 * snap.n_dev,
                            "funnel_rescore": rc_s * snap.n_dev,
                            "funnel_stage2_bytes_per_row": snap.pq.segments,
                            "funnel_stage3_bytes_per_row": bpr_store,
                        })
                else:
                    shape = DispatchShape(
                        TIER_PQ_RESCORE if rescore else TIER_PQ_CODES, n=snap.n_total,
                        dim=snap.dim, batch=b, batch_padded=q.shape[0],
                        bytes_per_row=bpr_store if rescore else snap.pq.segments,
                        k=int(kk), ndev=snap.n_dev)
        else:
            top_p = self._ivf_plan(snap, kk)
            if top_p is not None:
                nlist, cap_p, _gen = snap.ivf_meta
                packed_dev = mesh_search_ivf_step(
                    snap.store, snap.tombs, snap.counts, words, snap.ivf_centroids,
                    snap.ivf_buckets, qs, s2d, kk, self.metric, use_allow, top_p, fused,
                    self.mesh)
                with self._ivf_lock:
                    st = self._ivf_stats
                    st["dispatches"] += 1
                    st["probed_rows"] += snap.n_dev * top_p * cap_p
                    st["base_rows"] += int(snap.n_total)
                if t_enq0:
                    probed = snap.n_dev * top_p * cap_p + nlist
                    shape = DispatchShape(
                        TIER_EXACT, n=probed, dim=snap.dim, batch=b, batch_padded=q.shape[0],
                        bytes_per_row=bpr_store, k=int(kk), ndev=snap.n_dev,
                        extra={"ivf": True, "ivf_top_p": top_p, "ivf_nlist": nlist,
                               "probed_fraction": round(
                                   min(probed / max(snap.n_total, 1), 1.0), 4)})
            else:
                packed_dev = self._gmin_step_or_none(snap, q, qs, kk, words, use_allow, fused)
                if packed_dev is None:
                    packed_dev = mesh_search_step(
                        snap.store, snap.sq_norms, snap.tombs, snap.counts, words, qs, s2d,
                        kk, self.metric, use_allow, self.metric == vi.DISTANCE_L2, fused,
                        self.mesh)
                if t_enq0:
                    shape = DispatchShape(
                        TIER_EXACT, n=snap.n_total, dim=snap.dim, batch=b,
                        batch_padded=q.shape[0], bytes_per_row=bpr_store, k=int(kk),
                        ndev=snap.n_dev)

        if shape is not None:
            shape.backend = costmodel.detect_backend(self.device)
            shape.t_start = t_enq0
            shape.enqueue_ms = (time.perf_counter() - t_enq0) * 1000.0
            if fused:
                shape.fused = True
                shape.translate_ms = 0.0
            self._read_local.dispatch_shape = shape
        if quality.get_auditor() is not None:
            # the shadow audit must re-read the SAME snapshot this dispatch
            # answered from: at most one pin per serving thread
            self._read_local.audit_snap = snap
        self._track_inflight(1)
        done = [False]
        slot_to_doc = snap.slot_to_doc

        def finish():
            packed = _fetch_packed(packed_dev, shape)
            if fused:
                ids, dists = unpack_fused(packed)
                return ids[:b], dists[:b]
            top, idx = unpack_topk(packed)
            top, idx = top[:b], idx[:b]
            t0 = time.perf_counter() if shape is not None else 0.0
            ids = np.where(idx >= 0, slot_to_doc[np.clip(idx, 0, None)], -1)
            if shape is not None:
                shape.translate_ms = (time.perf_counter() - t0) * 1000.0
            return ids.astype(np.uint64), top.astype(np.float32)

        def finalize():
            try:
                faults.fire("index.mesh.finalize")
                if shape is None:
                    return finish()
                if shape.fetches:
                    shape.fetches = 0  # a retried finalize re-counts
                t0 = time.perf_counter()
                out = finish()
                t1 = time.perf_counter()
                shape.finalize_ms = (t1 - t0) * 1000.0
                shape.t_end = t1
                return out
            finally:
                if not done[0]:
                    done[0] = True
                    self._track_inflight(-1)

        return finalize

    def search_by_vectors(self, vectors: np.ndarray, k: int,
                          allow_list: Optional[AllowList] = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        snap = self._read_snapshot()
        return self._dispatch_search(snap, vectors, k, allow_list)()

    def search_by_vectors_async(self, vectors: np.ndarray, k: int,
                                allow_list: Optional[AllowList] = None):
        """Two-phase dispatch for the serving coalescer: enqueue the whole
        mesh search now (lock-free, on the current snapshot) and return the
        finalize closure; filtered lanes ride the same path."""
        snap = self._read_snapshot()
        return self._dispatch_search(snap, vectors, k, allow_list)

    # -- the kernels' shape rules --------------------------------------------

    def _gmin_plan(self, b: int, kk: int, snap: Optional[MeshSnapshot] = None):
        """-> (rg, active_g) when K1 per slab takes this shape (metric,
        slab size, batch, and a resident-tile plan for the depth and the
        live slices, `gmin_scan.resident_plan`, where the reference asks
        its VMEM plan `fits_vmem`), else None. A pure gate, no kernel
        runs."""
        n_loc = snap.n_loc if snap is not None else self.n_loc
        dim = snap.dim if snap is not None else self.dim
        counts = snap.counts if snap is not None else self._counts
        if self.config.exact_topk:
            return None
        if self.metric not in vi.MATMUL_DISTANCES:
            return None
        if n_loc < 16384 or b < 8:
            return None
        ncols_l = n_loc // gmin_scan.G
        rg = min(max(32, 2 * kk), 128, ncols_l)
        if rg < kk:
            return None
        active_g = max(1, -(-int(counts.max()) // ncols_l))
        if gmin_scan.resident_plan(dim, active_g) is None:
            return None
        return rg, active_g

    def _pq_gmin_rg(self, snap: MeshSnapshot, b: int, kk: int) -> Optional[tuple[int, int]]:
        """-> (rg, active_g) when K2 per slab takes this shape
        (`pq_gmin.eligible_rg`, its tile plan `codes_plan`), else None."""
        ncols_l = snap.n_loc // gmin_scan.G
        active_g = max(1, -(-int(snap.counts.max()) // ncols_l)) if ncols_l else 1
        rg = pq_gmin.eligible_rg(self.config.exact_topk, self.metric, snap.pq, b, ncols_l, kk,
                                 snap.dim)
        return None if rg is None else (rg, active_g)

    def _pq_gmin_step_or_none(self, snap: MeshSnapshot, q: np.ndarray, qs: list, kk: int,
                              words, use_allow: bool, fused: bool):
        """K2 per slab (the codes-only tier), or None for the
        reconstruction scan when its shape rule refuses."""
        plan = self._pq_gmin_rg(snap, q.shape[0], kk)
        if plan is None:
            return None
        rg, active_g = plan
        pc = self._pq_consts(snap.pq)
        return mesh_search_pq_gmin_step(
            snap.codes, snap.recon_norms, snap.tombs, snap.counts, words, pc["cb_bf16"],
            pc["flat"], qs, pc["rot"], snap.slot_to_doc_dev, kk, self.metric, use_allow, rg,
            active_g, fused, self.mesh)

    def _gmin_step_or_none(self, snap: MeshSnapshot, q: np.ndarray, qs: list, kk: int,
                           words, use_allow: bool, fused: bool):
        """K1 per slab (over an f32 or a bf16 store), or None for the
        chunked scan when `_gmin_plan` refuses."""
        plan = self._gmin_plan(q.shape[0], kk, snap)
        if plan is None:
            return None
        rg, active_g = plan
        return mesh_search_gmin_step(
            snap.store, snap.sq_norms, snap.tombs, snap.counts, words, qs,
            snap.slot_to_doc_dev, kk, self.metric, use_allow, rg, active_g, fused, self.mesh)

    # -- host fallback plane (breaker-degraded serving + shadow audits) ------

    def _snap_prefix_slots(self, snap: MeshSnapshot) -> np.ndarray:
        """Global rows of every written slot in `snap`, slab order (the
        per-slab counts prefixes concatenated), tombstoned rows included
        (the caller masks them)."""
        if snap.dim is None or snap.n_total == 0:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([np.arange(dev * snap.n_loc, dev * snap.n_loc + int(snap.counts[dev]))
                               for dev in range(snap.n_dev)])

    def host_rows(self, snap: MeshSnapshot) -> tuple[np.ndarray, np.ndarray]:
        """(rows f32 [n, D], sq_norms f32 [n]) of `snap`'s written slots:
        the quality auditor's ground truth. Compressed mode serves the f32
        host copy (the device store is bf16 by then)."""
        slots = self._snap_prefix_slots(snap)
        if snap.compressed and snap.host_vecs is not None:
            rows = snap.host_vecs[slots]
        else:
            rows = np.concatenate([snap.store[s][: int(snap.counts[s])].float().cpu().numpy()
                                   for s in range(snap.n_dev)])
        sq = np.einsum("ij,ij->i", rows, rows, dtype=np.float32)
        return rows, sq

    def _host_fallback_rows(self, snap: MeshSnapshot):
        """host_rows cached per snapshot generation for the breaker path:
        one fetch per generation while degraded."""
        cached = self._host_rows_cache
        if cached is not None and cached[0] == snap.gen:
            return cached[1], cached[2]
        rows, sq = self.host_rows(snap)
        self._host_rows_cache = (snap.gen, rows, sq)
        return rows, sq

    def release_host_fallback_cache(self) -> None:
        """Drop the breaker-path row cache (called on breaker recovery)."""
        self._host_rows_cache = None

    def search_by_vectors_host(self, vectors: np.ndarray, k: int,
                               allow_list: Optional[AllowList] = None
                               ) -> tuple[np.ndarray, np.ndarray]:
        """Pure-host scan over the current snapshot (the breaker's degraded
        serving path)."""
        snap = self._read_snapshot()
        if snap.dim is None or snap.n_total == 0 or snap.live == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            return np.zeros((b, 0), dtype=np.uint64), np.zeros((b, 0), dtype=np.float32)
        rows, sq = self._host_fallback_rows(snap)
        return self._host_search_snap(snap, vectors, k, allow_list, rows, sq)

    def search_by_vectors_host_pinned(self, snap: MeshSnapshot, vectors: np.ndarray, k: int,
                                      allow_list: Optional[AllowList] = None, rows=None,
                                      sq_norms=None, deadline: Optional[float] = None
                                      ) -> tuple[np.ndarray, np.ndarray]:
        """Host scan against a PINNED snapshot (the quality auditor's shadow
        re-execution reads the exact state the live dispatch saw)."""
        if snap.dim is None or snap.n_total == 0 or snap.live == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            return np.zeros((b, 0), dtype=np.uint64), np.zeros((b, 0), dtype=np.float32)
        if rows is None or sq_norms is None:
            rows, sq_norms = self.host_rows(snap)
        return self._host_search_snap(snap, vectors, k, allow_list, rows, sq_norms, deadline)

    def _host_search_snap(self, snap: MeshSnapshot, vectors, k, allow_list, rows, row_sq,
                          deadline: Optional[float] = None):
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if self.metric == vi.DISTANCE_COSINE:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            q = q / norms
        slots = self._snap_prefix_slots(snap)
        live = ~snap.host_tombs[slots]
        docs = snap.slot_to_doc[slots]
        if allow_list is not None:
            if isinstance(allow_list, Bitmap):
                live = live & allowed_mask(allow_list, docs)
            else:
                live = live & allow_list.contains_array(docs.astype(np.uint64))
        n = slots.size
        n_live = int(live.sum())
        if n_live == 0:
            return (np.zeros((q.shape[0], 0), dtype=np.uint64),
                    np.zeros((q.shape[0], 0), dtype=np.float32))
        q_sq = (q ** 2).sum(1)[:, None] if self.metric == vi.DISTANCE_L2 else None
        chunk = (4096 if self.metric in (vi.DISTANCE_MANHATTAN, vi.DISTANCE_HAMMING)
                 else self._HOST_SCAN_CHUNK)
        d = np.empty((q.shape[0], n), dtype=np.float32)
        for s in range(0, n, chunk):
            if deadline is not None and time.perf_counter() > deadline:
                raise quality.AuditDeadlineExceeded(
                    f"host scan over audit budget at row {s}/{n}")
            e = min(s + chunk, n)
            blk = rows[s:e]
            if self.metric == vi.DISTANCE_L2:
                d[:, s:e] = np.maximum(q_sq - 2.0 * (q @ blk.T) + row_sq[s:e][None, :], 0.0)
            elif self.metric == vi.DISTANCE_DOT:
                d[:, s:e] = -(q @ blk.T)
            elif self.metric == vi.DISTANCE_COSINE:
                d[:, s:e] = 1.0 - q @ blk.T
            elif self.metric == vi.DISTANCE_MANHATTAN:
                d[:, s:e] = np.abs(q[:, None, :] - blk[None, :, :]).sum(-1)
            else:
                d[:, s:e] = (q[:, None, :] != blk[None, :, :]).sum(-1)
        d[:, ~live] = np.inf
        kk = min(max(int(k), 1), n_live)
        idx = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        top = np.take_along_axis(d, idx, axis=1)
        order = np.argsort(top, axis=1, kind="stable")
        top = np.take_along_axis(top, order, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        ids = np.where(np.isinf(top), -1, docs[idx])
        return ids.astype(np.uint64), top.astype(np.float32)

    # -- health (GET /debug/index) -------------------------------------------

    def _ivf_health(self) -> dict:
        s = ivf_settings()
        out: dict = {"enabled": s is not None, "trained": self._ivf_centroids_host is not None}
        if self._ivf_centroids_host is not None:
            nlist, cap_p, gen = self._ivf_meta or (
                self._ivf_centroids_host.shape[0], self._ivf_cap_p or 0, self._ivf_gen)
            out.update({"nlist": int(nlist), "cap_p": int(cap_p), "gen": int(gen),
                        "trained_n": self._ivf_trained_n, "pca_dim": 0})
            fills = self._ivf_fills
            if fills is not None:
                flat = fills.reshape(-1)
                mean = float(flat.mean()) if flat.size else 0.0
                total = int(flat.sum())
                out["buckets"] = {
                    "fill_min": int(flat.min()) if flat.size else 0,
                    "fill_mean": round(mean, 1),
                    "fill_max": int(flat.max()) if flat.size else 0,
                    "empty": int((flat == 0).sum()),
                    "padding_waste": round(1.0 - total / max(flat.size * cap_p, 1), 4),
                    "imbalance": round(float(flat.max()) / mean, 2) if mean > 0 else None,
                    "fill_histogram": np.histogram(
                        flat, bins=8, range=(0, max(cap_p, 1)))[0].tolist(),
                    "per_device_rows": fills.sum(axis=1).tolist(),
                }
        out["probes"] = self.ivf_stats()
        return out

    def health(self) -> dict:
        """Mesh diagnostics for GET /debug/index: the single-device keys
        plus the per-device breakdown."""
        with self._lock:
            counts = self._counts.copy()
            slots = int(counts.sum())
            tombs = int(self._host_tombs.sum())
            comps = self._memory_components()
            slab_bytes_total = sum(comps.values())
            per_device = []
            for dev in range(self.n_dev):
                sl = slice(dev * self.n_loc, dev * self.n_loc + self.n_loc)
                per_device.append({
                    "device": dev,
                    "rows": int(counts[dev]),
                    "tombstones": int(self._host_tombs[sl].sum()) if self._host_tombs.size else 0,
                    "slab_bytes": slab_bytes_total // self.n_dev,
                })
            return {
                "type": "hnsw_tpu_mesh",
                "metric": self.metric,
                "dim": self.dim,
                "devices": self.n_dev,
                "rows_per_device": self.n_loc,
                "capacity": self.n_dev * self.n_loc,
                "slots": slots,
                "live": self.live,
                "tombstones": tombs,
                "tombstone_fraction": round(tombs / max(slots, 1), 4),
                "pending_adds": len(self._pending),
                "pending_tombstones": len(self._pending_tombs),
                "snapshot_gen": self.snapshot_gen,
                "staged_gen": self._staged_gen,
                "published_gen": self._published_gen,
                "staged_lag": self._staged_gen - max(self._published_gen, 0),
                "per_device": per_device,
                "compressed": self.compressed,
                # rescore=false serves raw ADC distances: surfaced, not just
                # documented
                "pq": None if self._pq is None else {
                    "segments": self._pq.segments,
                    "centroids": self._pq.centroids,
                    "rotation": bool(self.config.pq.rotation),
                    "rescore": bool(self.config.pq.rescore),
                    "code_dtype": str(self._pq.code_dtype).replace("torch.", ""),
                },
                "ivf": self._ivf_health(),
                "host_fallback_cache": {
                    "resident": self._host_rows_cache is not None,
                    "gen": (self._host_rows_cache[0]
                            if self._host_rows_cache is not None else None),
                    "bytes": memory.host_rows_cache_bytes(self),
                },
                "memory": {
                    "device_components": comps,
                    "host_components": memory.index_host_components(self),
                },
            }

    # -- single-vector entry points ------------------------------------------

    def search_by_vector(self, vector: np.ndarray, k: int,
                         allow_list: Optional[AllowList] = None
                         ) -> tuple[np.ndarray, np.ndarray]:
        ids, dists = self.search_by_vectors(np.asarray(vector)[None, :], k, allow_list)
        keep = dists[0] != np.inf
        return ids[0][keep], dists[0][keep]

    def search_by_vector_distance(self, vector: np.ndarray, target_distance: float,
                                  max_limit: int, allow_list: Optional[AllowList] = None
                                  ) -> tuple[np.ndarray, np.ndarray]:
        """Doubling-limit loop (search.go:90-157 semantics)."""
        limit = 64
        while True:
            ids, dists = self.search_by_vector(vector, min(limit, max_limit), allow_list)
            if len(ids) == 0:
                return ids, dists
            beyond = dists > target_distance
            if beyond.any() or len(ids) >= min(max_limit, self.live):
                keep = dists <= target_distance
                return ids[keep][:max_limit], dists[keep][:max_limit]
            if limit >= max_limit:
                return ids[:max_limit], dists[:max_limit]
            limit *= 2

    # -- config / maintenance ------------------------------------------------

    def update_user_config(self, updated: vi.HnswUserConfig) -> None:
        with self._lock:
            vi.validate_config_update(self.config, updated)
            was_enabled = self.config.pq.enabled
            if updated.pq.enabled and not was_enabled:
                # reject what is knowable NOW instead of deferring the
                # failure into the compression trigger
                if self.metric not in vi.MATMUL_DISTANCES:
                    raise vi.ConfigValidationError(
                        f"pq on hnsw_tpu_mesh supports l2-squared/dot/cosine, not {self.metric}")
                if (self.dim is not None and updated.pq.segments > 0
                        and self.dim % updated.pq.segments != 0):
                    raise vi.ConfigValidationError(
                        f"pq.segments ({updated.pq.segments}) must divide vector dims "
                        f"({self.dim})")
            prev = self.config
            self.config = updated
            # pq.enabled flipped on triggers compression (compress.go)
            if updated.pq.enabled and not was_enabled and not self.compressed:
                try:
                    self._flush_pending()
                    if self.live > 0:
                        self._compress_locked()
                except Exception:
                    # a failed pq-enable must not stick: a committed but
                    # uncompressed config would re-run the fit on every flush
                    self.config = prev
                    raise

    def flush(self) -> None:
        with self._lock:
            self._flush_pending()
            self._maybe_autocompress()
            if self._log is not None:
                self._log.flush()
        # IVF (re)training fetches and fits OFF the lock, from a pinned
        # snapshot; concurrent writes queue into the backlog
        self._ivf_maybe_train()

    def compact(self) -> None:
        """Condense: drop tombstoned slots, rewrite the log, rebuild
        balanced (condensor.go analog). In-flight dispatches keep their
        pinned snapshots: the rebuild swaps whole slabs, never mutates
        them."""
        with self._lock:
            self._flush_pending()
            if self.dim is None or not self._doc_to_row:
                return
            total = int(self._counts.sum())
            if len(self._doc_to_row) == total:
                return
            t_compact0 = time.perf_counter()
            rows = np.array(sorted(self._doc_to_row.values()), dtype=np.int64)
            docs = self._slot_to_doc[rows]
            # compressed mode rewrites the log from the f32 host copy: the
            # device store is bf16 by then and must not degrade durable data
            if self.compressed:
                store_host = self._host_vecs[rows]
            else:
                store_host = np.concatenate(
                    [st.float().cpu().numpy() for st in self._store])[rows]
            if self._log is not None:
                self._log.rewrite(docs, store_host)
            # mapping rebuild invalidates any packed-words cache keyed on it
            self._allow_token = object()
            self._ivf_reset()
            dim = self.dim
            self.dim = None
            self.n_loc = 0
            self.live = 0
            self._counts = np.zeros(self.n_dev, dtype=np.int64)
            self._doc_to_row.clear()
            self._slot_to_doc = np.zeros(0, dtype=np.int64)
            self._store = self._sq_norms = self._tombs = self._s2d_dev = None
            self._host_tombs = np.zeros(0, dtype=bool)
            self._init_device(dim)
            self._restoring = True
            try:
                self.add_batch(docs, store_host)
            finally:
                self._restoring = False
            self._staged_gen += 1
            self._mark_staged()
            led = memory.get_ledger()
            if led is not None:
                led.note_write("compact", "compact", (time.perf_counter() - t_compact0) * 1000.0,
                               rows=self.live)

    def drop(self) -> None:
        with self._lock:
            if self._log is not None:
                self._log.close()
                try:
                    os.remove(self._log.path)
                except FileNotFoundError:
                    pass
                self._log = None
            self._store = self._sq_norms = self._tombs = self._s2d_dev = None
            self._codes = self._recon_norms = self._codes4 = self._recon_norms4 = None
            self._opq_rot_dev = None
            self._host_vecs = None
            self._pq = self._pq4 = None
            self.compressed = False
            if self._pq_path:
                try:
                    os.remove(self._pq_path)
                except FileNotFoundError:
                    pass
            self.dim = None
            self.n_loc = 0
            self.live = 0
            self._counts = np.zeros(self.n_dev, dtype=np.int64)
            self._slot_to_doc = np.zeros(0, dtype=np.int64)
            self._host_tombs = np.zeros(0, dtype=bool)
            self._doc_to_row.clear()
            self._pending.clear()
            self._pending_tombs.clear()
            self._snap = None
            self._host_rows_cache = None
            self._ivf_reset()
            self._device_epoch += 1
            self._staged_gen += 1
            self._stamp_memory()  # zero this index's device components

    def shutdown(self) -> None:
        with self._lock:
            self._flush_pending()
            if self._log is not None:
                self._log.flush()
                self._log.close()

    def list_files(self) -> list[str]:
        out = [self._log.path] if self._log is not None else []
        if self._pq_path and os.path.exists(self._pq_path):
            out.append(self._pq_path)  # backups must carry the codebook
        return out
