"""The GPU vector index ("hnsw_tpu" / "flat"): the port of
`weaviate_tpu/index/tpu.py`, single device, uncompressed and
PQ-compressed, with an f32 or a bf16 store (`storeDtype`).

The interface contract is the reference's (vector_index.go:23-40:
(vector, k, allowList) -> (ids, dists)); the device does the work in
batches:

- uncompressed, the shard's vectors live on the card as one padded
  [capacity, D] f32 tensor, with an [capacity] f32 row-norm vector (l2),
  a [capacity] bool tombstone mask and a [capacity] int64 slot->doc
  column;
- a query batch of 8 rows or more runs the group-min fast scan
  (ops/gmin_scan.py, the hand-written Hopper kernel K1) and an exact f32
  rescore; smaller batches, `exactTopK`, and the manhattan and hamming
  metrics run the chunked exact scan (`_search_full`);
- allowLists below `flatSearchCutoff` take the gather tier: only the
  allowed rows are scored (flat_search.go:19 semantics);
- queries go up through a pool of staging buffers (pinned host memory on
  the card, uploaded without blocking on the dispatch's stream); a buffer
  goes back to the pool only after its dispatch's fetch, so a later
  checkout never overwrites rows the copy has not read;
- on the card an unfiltered dispatch of the group-min tiers replays one
  CUDA graph per staging entry (`_DispatchGraph`): the chain of launches
  after the upload, captured once its key (`_graph_key`: what the gmin
  launch reads, the batch bucket) has served `_GRAPH_AFTER` eager
  dispatches unchanged, dropped when a write makes it stale; recaptures
  reuse the entry's memory pool (`_GraphPool`), and the pools are counted
  against a share of the card's memory. A read-only stretch
  pays one graph launch a dispatch where the eager chain paid ~38
  launches, each waiting for the interpreter lock;
- each dispatch ends in ONE device->host transfer (`_fetch_packed`). With the fused-dispatch
  toggle on (the default) it already carries final doc ids
  (ops/topk.translate_pack); off (`FUSED_DISPATCH_ENABLED=false` or
  `set_fused_enabled(False)`, the staged dispatch), it carries slot
  indices (ops/topk.pack_topk) that finalize translates on the host
  through the snapshot's slot->doc mirror;
- reads are snapshot-isolated: writers publish an immutable IndexSnapshot
  with one reference swap, readers grab it lock-free and run the whole
  two-phase dispatch (enqueue, then finalize) on it.

Compression (compress.go analog; `compress()`, a `pq` block declared at
creation, or `update_user_config` turning `pq.enabled` on). The codebook
is fit on the stored rows, every row is encoded on the card, and the f32
store is dropped: the card keeps [capacity, M] codes and their ||recon||^2,
the f32 rows move to host memory (the gather tier and restarts read
them), and `pq.rescore` (the default) keeps a bf16 copy of the rows on
the card. `pq.bits` 4 adds a nibble-packed 16-centroid quantizer. Search
then takes, in this order (`_dispatch_full_pq`):
  1. bits 4: the three-stage funnel (ops/pq4.py, kernel K3);
  2. rescore: the fast scan over the bf16 copy (K1's bf16 instantiation)
     and an exact rescore of its rows;
  3. codes only: the ADC group-min scan (ops/pq_gmin.py, kernel K2) and
     an exact-ADC rescore;
  4. codes only, shapes K2 does not take (B < 8, C > 256, exactTopK):
     the chunked reconstruction scan (`_search_pq_recon`);
  5. manhattan: the chunked LUT scan (`_search_pq`).
The codebook persists as `pq.npz` (and `pq4.npz`) in the reference's
layout; a restart replays `vector.log` and re-encodes against it, so a
compressed shard restarts in either package.

The IVF scan plane (`IVF_ENABLED`, or `set_ivf_config`; ops/ivf.py).
Once min_n rows exist the write path trains a clustered layout on the
host (k-means centroids, balanced padded partition buckets, optionally
a PCA prefilter basis); later rows are assigned as they land and fold
into the buckets before the next publish, and growth by retrain_growth,
or a compaction, retrains. A dispatch past the gather tier then probes
the top_p nearest partitions and scores only their rows, on every tier
(exact, bf16 store, PQ rescore, PQ codes, the 4-bit funnel), fused or
staged (`_dispatch_ivf`).

Writes and snapshots. The JAX package replaces every device array on
every write. Here two kinds of write stay in place, because no published
snapshot can see what they change:
  - new rows (store, row norms, codes, the bf16 copy, host rows,
    slot->doc) land only at slots >= self.n, and every published snapshot
    has n <= self.n. A snapshot masks every slot at or past its own n (the
    scan's bias and valid mask, the gather tier's slot list, the
    translation's slot indices all stay below it), so a row written there
    cannot change its answers. On the card the write is also ordered on
    the stream after every dispatch already enqueued.
  - the block layouts of the rescore gathers are rebuilt when the write
    generation moves (a snapshot carries the generation it was published
    at).
Everything a snapshot does read changes out of place: tombstones are
cloned before a delete sets them, and growth and compression allocate
new tensors.

Durability: an append-only binary vector log per shard (add/delete
records), replayed at startup, in the JAX package's on-disk format
(magic WTVL, v2, per-record checksums), so a shard written by either
package restores in the other. `compact()` drops tombstoned slots and
rewrites the log; under PQ it re-encodes against the codebooks it has.

The shard's hooks: the host fallback plane the device circuit breaker
serves from (`search_by_vectors_host`, exact numpy brute force over the
published snapshot), the per-thread dispatch facts the shard pops for its
traces and the quality auditor (`pop_read_lock_wait`,
`pop_dispatch_shape`, `pop_audit_snapshot`), and `health()`.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import math
import os
import struct
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from weaviate_tpu_torch.compress.pq import (ProductQuantizer, build_lut, lut_scan_block,
                                            pack_codes4)
from weaviate_tpu_torch.config.config import (IVF_TOP_P_BUCKETS, PQ4_FUNNEL_C_BUCKETS,
                                              PQ4_FUNNEL_RESCORE_BUCKETS, RESCORE_R_BUCKETS,
                                              IvfConfig, _bool, ivf_from_env)
from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.index.interface import AllowList, VectorIndex
from weaviate_tpu_torch.monitoring import (costmodel, incidents, memory, profiling, quality,
                                           tracing)
from weaviate_tpu_torch.ops import gmin_scan, pq4, pq_gmin
from weaviate_tpu_torch.ops import ivf as ivf_ops
from weaviate_tpu_torch.ops.distances import DISTANCE_FNS
from weaviate_tpu_torch.ops.topk import (bitmap_to_mask, merge_top_k, pack_topk,
                                         rescore_distances, smallest_k,
                                         translate_pack, unpack_fused, unpack_topk)
# the self-tuning control plane (serving/controller.py): its recall-guarded
# budgets cap the chunked scan's candidate depth (_rescore_r), the codes
# tier's candidate pool and the 4-bit funnel's two stages; unconfigured,
# each cap is one comparison that returns the ladder's top bucket.
# controller imports nothing from the index layer, so no cycle.
from weaviate_tpu_torch.serving import controller
from weaviate_tpu_torch.storage.bitmap import (Bitmap, allowed_mask,
                                               pack_allow_words)
from weaviate_tpu_torch.testing import faults, sanitizers

_log = logging.getLogger(__name__)

_CHUNK = 8192          # rows per device write
_MIN_CAPACITY = 16384
_LOG_ADD = 1
_LOG_DELETE = 2
_LOG_MAGIC = b"WTVL"
_LOG_VERSION = 2  # v2 = per-record checksums + skip-ahead corrupt-region replay

# query-batch padding buckets: the JAX package's compile-shape buckets,
# kept so both packages route a batch to the same tier (_use_gmin reads
# the padded width)
_B_BUCKETS = (1, 4, 16, 64, 256, 1024)

# rows of the store scored per chunked-scan step: bounds the [B, chunk]
# distance block
_SCAN_CHUNK = 131072
# rows of the code matrix scored per LUT-scan step
_PQ_SCAN_CHUNK = 32768

# -- fused-dispatch toggle ----------------------------------------------------
# On (the default), every dispatch translates slots to doc ids on the card
# and finalize() only reads the fetched buffer. Off, the staged dispatch:
# each tier returns the packed [B, 2k] slots and finalize() translates them
# on the host through the snapshot's slot->doc mirror (the JAX package's
# A/B control, `index/tpu.py:117-165`).
_fused_override: Optional[bool] = None
_fused_env: Optional[bool] = None
_fused_token: Optional[object] = None


def set_fused_enabled(on: Optional[bool]) -> Optional[object]:
    """Override the fused-dispatch toggle process-wide. None reverts to the
    FUSED_DISPATCH_ENABLED environment default, re-read fresh. Returns a
    token naming THIS override: unset_fused_enabled(token) reverts it only
    while it is still the current one."""
    global _fused_override, _fused_token, _fused_env
    _fused_override = on
    _fused_token = object() if on is not None else None
    if on is None:
        _fused_env = None  # revert means re-read the environment
    return _fused_token


def unset_fused_enabled(token: Optional[object]) -> None:
    """Revert set_fused_enabled's override iff `token` is the current one
    (a newer override wins); a None token is a no-op."""
    global _fused_override, _fused_token, _fused_env
    if token is not None and token is _fused_token:
        _fused_override = None
        _fused_token = None
        _fused_env = None


def fused_dispatch_enabled() -> bool:
    global _fused_env
    if _fused_override is not None:
        return _fused_override
    if _fused_env is None:
        _fused_env = _bool(os.environ, "FUSED_DISPATCH_ENABLED", True)
    return _fused_env


# -- IVF scan-plane toggle ----------------------------------------------------
# The fused toggle's shape: the App applies Config.ivf here at init (token-
# scoped, so a torn-down App reverts only its own setting); bare-library
# indexes read the IVF_* environment through config's own parser. Disabled
# (the default), ivf_settings() is None and every IVF hook (write-path
# training, dispatch planning, health) is one comparison.
_ivf_override: Optional[IvfConfig] = None
_ivf_env: Optional[IvfConfig] = None
_ivf_token: Optional[object] = None


def set_ivf_config(cfg: Optional[IvfConfig]) -> Optional[object]:
    """Install a process-wide IvfConfig override. None reverts to the IVF_*
    environment default, re-read fresh. Returns a token for
    unset_ivf_config."""
    global _ivf_override, _ivf_token, _ivf_env
    _ivf_override = cfg
    _ivf_token = object() if cfg is not None else None
    if cfg is None:
        _ivf_env = None
    return _ivf_token


def unset_ivf_config(token: Optional[object]) -> None:
    """Revert set_ivf_config's override iff `token` is still current."""
    global _ivf_override, _ivf_token, _ivf_env
    if token is not None and token is _ivf_token:
        _ivf_override = None
        _ivf_token = None
        _ivf_env = None


def ivf_settings() -> Optional[IvfConfig]:
    """The active IVF settings, or None when the plane is disabled."""
    global _ivf_env
    s = _ivf_override
    if s is not None:
        return s if s.enabled else None
    if _ivf_env is None:
        _ivf_env = ivf_from_env()
    return _ivf_env if _ivf_env.enabled else None


def _snap_top_p(v: int) -> int:
    """Largest IVF_TOP_P_BUCKETS entry <= v (min the first bucket); past
    the ladder's top, pow2 steps (one value per octave)."""
    top = IVF_TOP_P_BUCKETS[-1]
    if v > top:
        p = top
        while p * 2 <= v:
            p *= 2
        return int(p)
    best = IVF_TOP_P_BUCKETS[0]
    for b in IVF_TOP_P_BUCKETS:
        if b <= v:
            best = b
    return int(best)


def _bucket_rows(n: int) -> int:
    """n snapped up to a power of two, min 128 (the reference's row
    buckets; the IVF prefilter's survivor count)."""
    b = 128
    while b < n:
        b *= 2
    return b


def _bucket_b(b: int) -> int:
    for s in _B_BUCKETS:
        if b <= s:
            return s
    return ((b + 1023) // 1024) * 1024


def _grow(t: Optional[torch.Tensor], new_cap: int, fill) -> Optional[torch.Tensor]:
    """A new [new_cap, ...] tensor holding t's rows then `fill`: growth
    never touches the tensor a published snapshot holds."""
    if t is None:
        return None
    out = torch.full((new_cap, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def _valid_slots(tombs, n, base, chunk, allow_words, use_allow):
    """[chunk] bool: slots base.. of this chunk that are below n, not
    tombstoned and allowed."""
    lane = torch.arange(chunk, device=tombs.device)
    valid = (lane + base < n) & ~tombs[base: base + chunk]
    if use_allow:
        valid = valid & bitmap_to_mask(allow_words[base // 32: (base + chunk) // 32], chunk)
    return valid


class _PinnedStage:
    """A pinned host staging buffer of the query pool, the CUDA graph of
    the gmin dispatch captured for it (`_DispatchGraph`) and the memory
    pool its graphs are captured into (`_GraphPool`). A dispatch has the
    entry to itself until its blocking fetch is done, on the stream its
    upload ran on: by then the upload has read the buffer, and no replay
    of the graph's static buffers is in flight."""

    __slots__ = ("buf", "graph", "pool")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.graph: Optional[_DispatchGraph] = None
        self.pool: Optional[_GraphPool] = None

    @property
    def shape(self) -> tuple:
        return tuple(self.buf.shape)

    @property
    def nbytes(self) -> int:
        return self.buf.nbytes


# how a dispatch ran its device work (the dispatch's `graph` fact)
GRAPH_EAGER, GRAPH_CAPTURE, GRAPH_REPLAY = "eager", "capture", "replay"
# the tiers whose dispatch is one full scan (`_dispatch_scan`): the store,
# or the PQ tier's bf16 rescore copy
_FULL_SCAN_TIERS = (costmodel.TIER_EXACT, costmodel.TIER_PQ_RESCORE)

# the graphs of one device hold at most this share of its memory in their
# private pools; a bucket whose pools would pass it stays eager
_GRAPH_MEM_SHARE = 1 / 16

# captures take turns, process-wide, on one side stream per device: a
# stream may capture one graph at a time, and pooled streams are shared
# between indexes
_capture_lock = threading.Lock()
_capture_streams: dict = {}
# the bytes the live graphs' pools hold, per device
_graph_bytes: dict = {}
_graph_bytes_lock = threading.Lock()


@contextlib.contextmanager
def _no_collection():
    """No cyclic garbage collection in this block: one run on a capturing
    thread may free a CUDA graph of unreachable objects, a call the
    capture forbids on its thread, and that invalidates the capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _graph_budget(device: torch.device) -> int:
    """The bytes the graphs' pools may hold on `device`."""
    return int(torch.cuda.get_device_properties(device).total_memory * _GRAPH_MEM_SHARE)


def _graph_fits(device: torch.device, nbytes: int) -> bool:
    """Whether `nbytes` more of graph pools fit `device`'s budget."""
    return _graph_bytes.get(device, 0) + nbytes <= _graph_budget(device)


def _unbook_graph(device: torch.device, booked: list) -> None:
    with _graph_bytes_lock:
        _graph_bytes[device] -= booked[0]


class _GraphPool:
    """The private memory pool that the CUDA graphs of one staging entry
    are captured into, one after another: a recapture shares the pool of
    the graph it replaces (`capture_begin(pool=...)`), which `graph` keeps
    alive until then, since torch lets a capture share only a pool that a
    live graph holds. So a key that writes replace costs no new device
    memory. A graph pool that goes is reserved memory the allocator frees
    only when it runs short, so a bucket makes at most `_STAGE_POOL_CAP`
    of them and passes them from entry to entry. What it holds is counted
    against its device's budget while it lives."""

    __slots__ = ("graph", "booked", "__weakref__")

    def __init__(self, device: torch.device):
        self.graph = None
        self.booked = [0]
        weakref.finalize(self, _unbook_graph, device, self.booked)

    def book(self, graph, device: torch.device) -> tuple[int, bool]:
        """Keep `graph`, just captured into the pool, as its holder. -> (the
        bytes the pool's segments hold now, whether they are counted
        against `device`'s budget: not when their growth would pass it)."""
        self.graph = graph
        pool = tuple(graph.pool())
        nbytes = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                     if s["device"] == device.index and tuple(s["segment_pool_id"]) == pool)
        with _graph_bytes_lock:
            grow = nbytes - self.booked[0]
            if grow > 0 and not _graph_fits(device, grow):
                return nbytes, False
            _graph_bytes[device] = _graph_bytes.get(device, 0) + grow
            self.booked[0] = nbytes
            return nbytes, True


class _GraphBucket:
    """What `_graph_mode` knows of one (padded batch, dim) bucket: the
    graph key last seen and the eager dispatches it has served, the bytes
    of the bucket's last graph pool, the pools made for it and those no
    entry holds."""

    __slots__ = ("key", "served", "nbytes", "made", "spare")

    def __init__(self):
        self.key, self.served, self.nbytes, self.made = None, 0, 0, 0
        self.spare: list = []


class _DispatchGraph:
    """One gmin dispatch captured as a CUDA graph: from the static query
    input `q`, the scan bias, K1, the group top-k, the block gather and
    rescore, the final top-k and the packing, ending in the static packed
    output `out`. `holds` keeps alive every tensor whose address the graph
    baked in, so none is freed while it can replay; `gen` is the snapshot
    generation it was captured on, and a later publish makes it stale.
    `kept` is false for a graph whose pool its device's budget refused: it
    serves the dispatch that captured it, and it and its pool go when that
    dispatch's entry is released. The upload into `q` stays outside: a
    pinned buffer a capture copied from carries the capture stream, and
    its free while another capture runs there invalidates that capture."""

    __slots__ = ("key", "gen", "graph", "q", "out", "holds", "kept")

    def __init__(self, key: tuple, gen: int, graph, q: torch.Tensor, out: torch.Tensor,
                 holds: tuple, kept: bool):
        self.key = key
        self.gen = gen
        self.graph = graph
        self.q = q
        self.out = out
        self.holds = holds
        self.kept = kept


def _clock() -> tuple[int, int]:
    """(perf_counter_ns, the calling thread's CPU ns): a dispatch step's
    edge, on the clock the tracer's spans use."""
    return time.perf_counter_ns(), time.thread_time_ns()


def _step(name: str, since: tuple[int, int], steps=()) -> tuple:
    """One step of a dispatch, from `since` (a _clock()) to now, as the
    tracer's dispatch record takes it (costmodel.DispatchShape.spans)."""
    t, c = _clock()
    return (name, since[0], t, c - since[1], tuple(steps))


# timing event pairs an index keeps for reuse
_EVENT_POOL_CAP = 16


def _fetch_packed(packed: torch.Tensor, shape=None) -> np.ndarray:
    """The ONE blocking device->host fetch of a dispatch's finalize (on the
    card it waits for the dispatch's stream, the upload of its queries
    included). With a perf shape attached (tracer up), stamps the fetch
    duration as the ledger's `fetch` stage and the `index.fetch` step, and
    on the card the device's time between the dispatch's two CUDA events
    (`device_ms`): the second is recorded here, after the last kernel and
    before the copy. Without a shape this is exactly the copy. The
    sanitizer's device-sync plane patches this function."""
    if shape is None:
        return packed.cpu().numpy()
    if shape.events is not None:
        if profiling.hold_off():  # else a profiler session began: no reading
            try:
                shape.events[1].record(torch.cuda.current_stream(packed.device))
            finally:
                profiling.let_go()
        else:
            if len(shape.events[2]) < _EVENT_POOL_CAP:
                shape.events[2].append(shape.events[:2])
            shape.events = None
    since = _clock()
    t0 = time.perf_counter()
    out = packed.cpu().numpy()
    shape.fetches += 1  # the fused-dispatch invariant counts these
    shape.t_fetch = time.perf_counter()
    shape.fetch_ms = (shape.t_fetch - t0) * 1000.0
    # duty-cycle anchor: the in-flight interval ends HERE, not at the perf
    # window's record call (hydration runs in between)
    shape.t_fetch_mono = time.monotonic()
    shape.spans.append(_step("index.fetch", since))
    if shape.events is not None:
        before, after, pool = shape.events
        shape.events = None
        if profiling.hold_off():
            try:
                after.synchronize()  # complete already: the copy came after it
                shape.device_ms = before.elapsed_time(after)
            finally:
                profiling.let_go()
        if len(pool) < _EVENT_POOL_CAP:
            pool.append((before, after))
    return out


def _pack(top: torch.Tensor, idx: torch.Tensor, s2d: Optional[torch.Tensor]) -> torch.Tensor:
    """A tier's ([B, k] dists, [B, k] slot idx) -> its one fetchable
    buffer: translated on the device when s2d is the doc-id column (the
    fused layout), the staged [B, 2k] slots when it is None."""
    return translate_pack(top, idx, s2d) if s2d is not None else pack_topk(top, idx)


def _search_full(store, sq_norms, tombs, n, q, allow_words, k, metric, use_allow,
                 active_chunks=None, rescore_r=0):
    """Full-store masked kNN: a loop over store chunks, each one [B, chunk]
    distance block and a per-chunk top-k, merged exactly.

    The store is f32, or the bf16 rescore copy of a compressed index;
    the scan scores the query rounded to the store's type, as the JAX
    package does. rescore_r > 0 keeps the top max(k, rescore_r)
    candidates of the scan and rescores them exactly in f32 against the
    f32 query before the final top-k. Candidates whose scan distance was
    +inf (dead slots) stay +inf through the rescore. -> ([B, k] dists,
    [B, k] slot idx int32, -1 for missing)."""
    cap, _ = store.shape
    chunk = min(cap, _SCAN_CHUNK)
    nchunks = cap // chunk
    if active_chunks is not None:
        nchunks = max(1, min(nchunks, active_chunks))
    b = q.shape[0]
    dev = store.device
    qd = q.to(store.dtype)
    kk = max(k, rescore_r) if rescore_r else k
    top = torch.full((b, kk), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, kk), -1, dtype=torch.int64, device=dev)
    for ci in range(nchunks):
        base = ci * chunk
        valid = _valid_slots(tombs, n, base, chunk, allow_words, use_allow)
        norms = sq_norms[base: base + chunk] if sq_norms is not None else None
        d = DISTANCE_FNS[metric](qd, store[base: base + chunk], norms)
        d = torch.where(valid[None, :], d, float("inf"))
        td, li = smallest_k(d, kk)
        top, idx = merge_top_k(top, idx, td, li + base, kk)
    if rescore_r:
        cand = store[torch.clamp(idx, 0, cap - 1)]  # [B, R, D]
        ed = rescore_distances(cand, q, metric)
        ed = torch.where(torch.isinf(top), float("inf"), ed)
        top, pos = smallest_k(ed, k)
        idx = torch.gather(idx, 1, pos)
    idx = torch.where(torch.isinf(top), -1, idx).to(torch.int32)
    return top, idx


def _score_rows(sub, q, rows, tombs, k, metric):
    """Gather tier (flat_search.go:19 analog): score only the allowList's
    rows. sub [R, D] f32 holds them (gathered from the store, or uploaded
    from the host rows of a compressed index), rows [R] int64 their store
    slots; the dispatching snapshot's tombs mask them on the device. ->
    ([B, k] dists, [B, k] positions into rows, -1 for missing)."""
    dists = DISTANCE_FNS[metric](q.to(sub.dtype), sub, None)
    live = ~tombs[rows]
    masked = torch.where(live[None, :], dists, float("inf"))
    top, idx = smallest_k(masked, k)
    return top, torch.where(torch.isinf(top), -1, idx)


def _search_pq_recon(codes, recon_norms, tombs, n, pq, q, allow_words, k, r_chunk, metric,
                     use_allow, active_chunks=None):
    """The codes-only scan for the shapes K2 does not take (matmul metrics):
    each store chunk's codes rebuild a [chunk, D] bf16 block from the bf16
    codebook, scored by one product with the bf16-rounded (rotated) query
    in f32 (ADC distance = distance to the reconstruction, segments being
    disjoint dims); each chunk keeps its top r_chunk, and the pool of
    every chunk's winners gives the final top-k. -> ([B, k] ADC dists,
    [B, k] slot idx int32, -1 missing)."""
    cap, m = codes.shape
    chunk = min(cap, _SCAN_CHUNK)
    nchunks = cap // chunk
    if active_chunks is not None:
        nchunks = max(1, min(nchunks, active_chunks))
    qr = q.float()
    rot = pq.rotation_dev()
    if rot is not None:
        qr = qr @ rot
    qd = qr.to(torch.bfloat16).float()
    q_sq = torch.sum(qr ** 2, dim=-1, keepdim=True)
    cb = pq.codebook_bf16()
    tds, lis = [], []
    for ci in range(nchunks):
        base = ci * chunk
        recon = pq_gmin.reconstruct(codes[base: base + chunk], cb).float()
        qx = qd @ recon.T
        if metric == vi.DISTANCE_L2:
            d = torch.clamp(q_sq - 2.0 * qx + recon_norms[base: base + chunk][None, :], min=0.0)
        elif metric == vi.DISTANCE_DOT:
            d = -qx
        else:  # cosine: queries normalized; recon approximates unit rows
            d = 1.0 - qx
        valid = _valid_slots(tombs, n, base, chunk, allow_words, use_allow)
        d = torch.where(valid[None, :], d, float("inf"))
        td, li = smallest_k(d, r_chunk)
        tds.append(td)
        lis.append(li + base)
    top, pos = smallest_k(torch.cat(tds, dim=1), k)
    idx = torch.gather(torch.cat(lis, dim=1), 1, pos)
    return top, torch.where(torch.isinf(top), -1, idx).to(torch.int32)


def _search_pq(codes, tombs, n, lut, allow_words, r, use_allow, active_chunks=None):
    """The LUT scan (manhattan): the code matrix in chunks, each scored by
    the additive LUT gather (compress/pq.lut_scan_block,
    product_quantization.go:56-75 LookUp), with an exact merge of the
    top-r slots across chunks. -> ([B, r] ADC dists, [B, r] slot idx
    int32, -1 missing)."""
    cap, _ = codes.shape
    chunk = min(cap, _PQ_SCAN_CHUNK)
    nchunks = cap // chunk
    if active_chunks is not None:
        nchunks = max(1, min(nchunks, active_chunks))
    b = lut.shape[0]
    dev = codes.device
    top = torch.full((b, r), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, r), -1, dtype=torch.int64, device=dev)
    for ci in range(nchunks):
        base = ci * chunk
        valid = _valid_slots(tombs, n, base, chunk, allow_words, use_allow)
        d = lut_scan_block(codes[base: base + chunk], lut)
        d = torch.where(valid[None, :], d, float("inf"))
        td, li = smallest_k(d, r)
        top, idx = merge_top_k(top, idx, td, li + base, r)
    return top, torch.where(torch.isinf(top), -1, idx).to(torch.int32)


def _prep_bulk_run(ids: np.ndarray, vecs: np.ndarray, metric: str, known_fn):
    """Restore-run preparation: f32 cast, cosine normalization, keep-last
    dedup of in-run duplicate docs, and the indices of docs the index
    already knows (those take the per-record path so their old slots
    tombstone). -> (ids int64 [n], vecs f32 [n, d], known_indices list)."""
    vecs = np.asarray(vecs, np.float32)
    if metric == vi.DISTANCE_COSINE:
        nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
        nrm[nrm == 0] = 1.0
        vecs = vecs / nrm
    ids64 = ids.astype(np.int64)
    if len(np.unique(ids64)) != len(ids64):
        _, last_rev = np.unique(ids64[::-1], return_index=True)
        order = np.sort(len(ids64) - 1 - last_rev)
        ids64, vecs = ids64[order], vecs[order]
    known = [i for i, d in enumerate(ids64.tolist()) if known_fn(d)]
    return ids64, vecs, known


class VectorLog:
    """Append-only durability log for the device store (commit-log analog).

    v2 record layout (header magic WTVL, version 2):
      ADD:    op(1)=1 | doc_id(<Q) | dim(<I) | ck(<I) | dim x <f4 payload
      DELETE: op(1)=2 | doc_id(<Q) | ck(<I)
    where ck is the 32-bit additive byte checksum of every record byte
    EXCEPT the ck field itself. An additive sum (not crc32) is deliberate:
    it detects any single flipped byte, and the vectorized replay can
    verify a million records with two numpy row-sums instead of a Python
    crc loop. The checksum is what makes mid-log corruption DETECTABLE,
    which in turn makes skip-ahead replay safe: on a bad record, replay
    scans forward for the next offset where a whole record parses AND
    checksums (false resync ~2^-32 per candidate) and continues from
    there, counting the skipped bytes — the flat-store analog of the
    reference's corrupt-region repair (corrupt_commit_logs_fixer.go:1),
    which replays around damage rather than abandoning everything after
    it. v1 logs (no checksum) still replay with the old
    stop-at-first-bad-record behavior.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fresh = True
        if os.path.exists(path):
            # a crash can leave a torn/corrupt tail; anything appended after
            # an unreadable region would be durably written yet unreachable —
            # silent data loss on the next restart. For v2 logs the cut point
            # is the end of the LAST valid record (mid-file damage stays in
            # place for skip-ahead replay to route around); for v1 logs it is
            # the first bad record, as before.
            size = os.path.getsize(path)
            valid = self._valid_prefix_len(path)
            if valid < size:
                cut = valid
                if self._version(path) >= 2:
                    cut = max(valid, self._last_valid_end(path))
                with open(path, "r+b") as f:
                    f.truncate(cut)
                fresh = cut == 0
            else:
                fresh = valid == 0
            if not fresh and self._version(path) < 2:
                # one-time in-place upgrade: appends always write v2
                # checksummed records, and mixing formats within one file
                # would make v1 replay mis-parse every appended vector
                # (checksum bytes read as payload) — rewrite the whole log
                # as v2 before reusing it.
                self._upgrade_v1(path)
        self._f = open(path, "ab")
        if fresh:
            self._f.write(_LOG_MAGIC + struct.pack("<H", _LOG_VERSION))
            self._f.flush()

    @staticmethod
    def report_replay_stats(path: str, stats: dict) -> None:
        """Warn the operator when a replay skipped corrupt bytes (the JAX
        package's wording, so both packages report a damaged log alike)."""
        if stats.get("skipped_bytes"):
            import logging

            logging.getLogger(__name__).warning(
                "vector log %s: skipped %d corrupt byte(s) across %d "
                "region(s) during replay; records inside the damage are "
                "lost, everything outside it was recovered",
                path, stats["skipped_bytes"], stats.get("skipped_regions", 0))

    @staticmethod
    def _upgrade_v1(path: str) -> None:
        tmp = path + ".upgrade"
        with open(tmp, "wb") as f:
            f.write(_LOG_MAGIC + struct.pack("<H", _LOG_VERSION))
            for op, doc_id, vec in VectorLog.replay(path):
                if op == "add":
                    f.write(VectorLog._enc_add(doc_id, vec))
                else:
                    head = struct.pack("<BQ", _LOG_DELETE, doc_id)
                    f.write(head + struct.pack("<I", VectorLog._sum32(head)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- format helpers ------------------------------------------------------

    @staticmethod
    def _version(path: str) -> int:
        with open(path, "rb") as f:
            head = f.read(6)
        if len(head) < 6 or head[:4] != _LOG_MAGIC:
            return 0
        return struct.unpack_from("<H", head, 4)[0]

    @staticmethod
    def _sum32(*parts) -> int:
        s = 0
        for p in parts:
            s += int(np.frombuffer(p, np.uint8).sum(dtype=np.uint64))
        return s & 0xFFFFFFFF

    @staticmethod
    def _enc_add(doc_id: int, v: np.ndarray) -> bytes:
        head = struct.pack("<BQI", _LOG_ADD, doc_id, v.shape[0])
        payload = v.tobytes()
        return head + struct.pack("<I", VectorLog._sum32(head, payload)) + payload

    @staticmethod
    def _validate_v2(data, off: int, n: int):
        """If a valid v2 record starts at off, return (op, end); else None."""
        op = data[off]
        if op == _LOG_ADD:
            if off + 17 > n:
                return None
            dim, ck = struct.unpack_from("<II", data, off + 9)
            if not 0 < dim <= 65536:
                return None
            end = off + 17 + 4 * dim
            if end > n:
                return None
            if VectorLog._sum32(data[off : off + 13], data[off + 17 : end]) != ck:
                return None
            return (_LOG_ADD, end)
        if op == _LOG_DELETE:
            if off + 13 > n:
                return None
            (ck,) = struct.unpack_from("<I", data, off + 9)
            if VectorLog._sum32(data[off : off + 9]) != ck:
                return None
            return (_LOG_DELETE, off + 13)
        return None

    @staticmethod
    def _resync_v2(data, buf: np.ndarray, off: int, n: int):
        """Smallest off' >= off where a whole v2 record parses and checksums,
        or None. Candidate positions (op byte is 1 or 2) are found with one
        vectorized pass per 1 MiB window; each candidate pays one record-sized
        checksum, so the scan cost is bounded by the damaged span, not the
        log size."""
        pos = off
        while pos < n:
            win = min(pos + (1 << 20), n)
            cands = np.flatnonzero((buf[pos:win] == _LOG_ADD) | (buf[pos:win] == _LOG_DELETE))
            for idx in cands.tolist():
                p = pos + idx
                if VectorLog._validate_v2(data, p, n) is not None:
                    return p
            pos = win
        return None

    @staticmethod
    def _valid_prefix_len(path: str) -> int:
        """Byte length of the longest parseable record prefix. 0 means the
        header itself is unusable (the file must be re-initialized). Scans
        record HEADERS only (seek past payloads), so a multi-GB log costs one
        sequential header walk, not a whole-file read. Does NOT verify
        checksums — it bounds where the cheap walk stops, not data integrity
        (replay re-verifies every record)."""
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            head = f.read(6)
            if len(head) < 6 or head[:4] != _LOG_MAGIC:
                return 0
            v2 = struct.unpack_from("<H", head, 4)[0] >= 2
            add_hdr = 17 if v2 else 13
            del_len = 13 if v2 else 9
            off = 6
            while off < size:
                f.seek(off)
                hdr = f.read(add_hdr)
                if not hdr:
                    return off
                op = hdr[0]
                if op == _LOG_ADD:
                    if len(hdr) < add_hdr:
                        return off
                    (dim,) = struct.unpack_from("<I", hdr, 9)
                    if v2 and not 0 < dim <= 65536:
                        return off
                    end = off + add_hdr + 4 * dim
                    if end > size:
                        return off
                    off = end
                elif op == _LOG_DELETE:
                    if len(hdr) < del_len:
                        return off
                    off += del_len
                else:
                    return off
            return off

    @staticmethod
    def _last_valid_end(path: str) -> int:
        """End offset of the last valid v2 record anywhere in the file (the
        truncation point that preserves recoverable data past mid-file
        damage). Walks record offsets only; vectors are never materialized."""
        with open(path, "rb") as f:
            data = f.read()
        n = len(data)
        if n < 6 or data[:4] != _LOG_MAGIC:
            return 0
        buf = np.frombuffer(data, np.uint8)
        off, last = 6, 6
        while off < n:
            v = VectorLog._validate_v2(data, off, n)
            if v is None:
                nxt = VectorLog._resync_v2(data, buf, off + 1, n)
                if nxt is None:
                    return last
                off = nxt
                continue
            off = last = v[1]
        return last

    # -- appends -------------------------------------------------------------

    def append_add(self, doc_id: int, vector: np.ndarray) -> None:
        v = np.ascontiguousarray(vector, dtype=np.float32)
        self._f.write(self._enc_add(doc_id, v))

    @staticmethod
    def _enc_add_batch(doc_ids: np.ndarray, vectors: np.ndarray) -> bytes:
        """ADD records of a whole batch, the bytes _enc_add gives each row,
        with the per-record checksums computed as two numpy row-sums."""
        n, dim = vectors.shape
        rec_len = 17 + 4 * dim
        buf = np.zeros((n, rec_len), np.uint8)
        buf[:, 0] = _LOG_ADD
        buf[:, 1:9] = np.asarray(doc_ids).astype("<u8").view(np.uint8).reshape(n, 8)
        buf[:, 9:13] = np.frombuffer(struct.pack("<I", dim), np.uint8)
        buf[:, 17:] = np.ascontiguousarray(vectors, dtype="<f4").view(np.uint8).reshape(n, 4 * dim)
        sums = buf[:, :13].sum(axis=1, dtype=np.uint64) + buf[:, 17:].sum(axis=1, dtype=np.uint64)
        buf[:, 13:17] = (sums & 0xFFFFFFFF).astype("<u4").view(np.uint8).reshape(n, 4)
        return buf.tobytes()

    def append_add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        """Vectorized bulk append: one write() for the whole batch."""
        self._f.write(self._enc_add_batch(doc_ids, vectors))

    def append_delete(self, doc_id: int) -> None:
        head = struct.pack("<BQ", _LOG_DELETE, doc_id)
        self._f.write(head + struct.pack("<I", self._sum32(head)))

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.flush()
        finally:
            self._f.close()

    @staticmethod
    def replay(path: str, stats: Optional[dict] = None):
        """Yield ('add', doc_id, vec) / ('delete', doc_id, None). v2 logs
        verify per-record checksums and SKIP corrupt regions (resuming at the
        next valid record, with the loss counted in `stats`); v1 logs keep
        the old stop-at-first-bad-record behavior. A torn tail is tolerated
        either way (corrupt_commit_logs_fixer.go behavior)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != _LOG_MAGIC or len(data) < 6:
            return
        if struct.unpack_from("<H", data, 4)[0] >= 2:
            yield from VectorLog._replay_v2(data, stats, batched=False)
            return
        off = 6
        n = len(data)
        while off < n:
            try:
                op = data[off]
                if op == _LOG_ADD:
                    doc_id, dim = struct.unpack_from("<QI", data, off + 1)
                    start = off + 13
                    end = start + dim * 4
                    if end > n:
                        return  # torn write
                    vec = np.frombuffer(data, "<f4", count=dim, offset=start).copy()
                    yield ("add", doc_id, vec)
                    off = end
                elif op == _LOG_DELETE:
                    (doc_id,) = struct.unpack_from("<Q", data, off + 1)
                    yield ("delete", doc_id, None)
                    off += 9
                else:
                    return  # corrupt record type: stop replay
            except struct.error:
                return

    @staticmethod
    def replay_batches(path: str, stats: Optional[dict] = None):
        """Vectorized replay: maximal runs of same-dim add records parse as
        ONE numpy view — ('add', ids [n] u64, vecs [n, dim] f32) — with
        ('delete', doc_id, None) singles in order. Same corruption tolerance
        as replay(); restores parse the log ~10x faster this way."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != _LOG_MAGIC or len(data) < 6:
            return
        if struct.unpack_from("<H", data, 4)[0] >= 2:
            yield from VectorLog._replay_v2(data, stats, batched=True)
            return
        buf = np.frombuffer(data, np.uint8)
        off = 6
        n = len(data)
        while off < n:
            try:
                op = data[off]
                if op == _LOG_ADD:
                    if off + 13 > n:
                        return  # torn header
                    doc_id, dim = struct.unpack_from("<QI", data, off + 1)
                    rec = 13 + 4 * dim
                    max_run = (n - off) // rec
                    if max_run == 0:
                        return  # torn vector payload
                    view = buf[off : off + max_run * rec].reshape(max_run, rec)
                    ok = view[:, 0] == _LOG_ADD
                    dim_b = np.frombuffer(struct.pack("<I", dim), np.uint8)
                    ok &= (view[:, 9:13] == dim_b).all(axis=1)
                    run = max_run if bool(ok.all()) else max(1, int(np.argmin(ok)))
                    sel = view[:run]
                    ids = np.ascontiguousarray(sel[:, 1:9]).view("<u8").ravel()
                    vecs = np.ascontiguousarray(sel[:, 13:]).view("<f4").reshape(run, dim)
                    yield ("add", ids, vecs)
                    off += run * rec
                elif op == _LOG_DELETE:
                    if off + 9 > n:
                        return
                    (doc_id,) = struct.unpack_from("<Q", data, off + 1)
                    yield ("delete", doc_id, None)
                    off += 9
                else:
                    return  # corrupt record type: stop replay
            except struct.error:
                return

    @staticmethod
    def _replay_v2(data: bytes, stats: Optional[dict], batched: bool):
        """Shared v2 walk. Valid add-runs still parse as one numpy view (the
        checksum column verifies vectorized, two row-sums per run); any
        record that fails validation starts a skip-ahead scan, and the
        skipped span is accumulated into `stats` so callers can REPORT the
        loss instead of silently shrinking the store."""
        buf = np.frombuffer(data, np.uint8)
        off = 6
        n = len(data)

        def _skip(start: int):
            nxt = VectorLog._resync_v2(data, buf, start + 1, n)
            end = n if nxt is None else nxt
            if stats is not None:
                stats["skipped_bytes"] = stats.get("skipped_bytes", 0) + (end - start)
                stats["skipped_regions"] = stats.get("skipped_regions", 0) + 1
            return nxt

        while off < n:
            op = data[off]
            if op == _LOG_ADD and off + 17 <= n:
                dim, ck0 = struct.unpack_from("<II", data, off + 9)
                rec = 17 + 4 * dim
                max_run = (n - off) // rec if 0 < dim <= 65536 else 0
                if max_run == 0:
                    off = _skip(off)
                    if off is None:
                        return
                    continue
                view = buf[off : off + max_run * rec].reshape(max_run, rec)
                ok = view[:, 0] == _LOG_ADD
                dim_b = np.frombuffer(struct.pack("<I", dim), np.uint8)
                ok &= (view[:, 9:13] == dim_b).all(axis=1)
                sums = view[:, :13].sum(axis=1, dtype=np.uint64) + view[:, 17:].sum(
                    axis=1, dtype=np.uint64
                )
                stored = np.ascontiguousarray(view[:, 13:17]).view("<u4").ravel()
                ok &= (sums & 0xFFFFFFFF) == stored
                run = max_run if bool(ok.all()) else int(np.argmin(ok))
                if run == 0:  # first record is corrupt — resync
                    off = _skip(off)
                    if off is None:
                        return
                    continue
                sel = view[:run]
                ids = np.ascontiguousarray(sel[:, 1:9]).view("<u8").ravel()
                vecs = np.ascontiguousarray(sel[:, 17:]).view("<f4").reshape(run, dim)
                if batched:
                    yield ("add", ids, vecs)
                else:
                    for i in range(run):
                        yield ("add", int(ids[i]), vecs[i].copy())
                off += run * rec
            elif op == _LOG_DELETE and off + 13 <= n:
                if VectorLog._validate_v2(data, off, n) is None:
                    off = _skip(off)
                    if off is None:
                        return
                    continue
                (doc_id,) = struct.unpack_from("<Q", data, off + 1)
                yield ("delete", doc_id, None)
                off += 13
            else:
                off = _skip(off)
                if off is None:
                    return

    def rewrite(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        """Condense: atomically rewrite the log with only the live entries
        ([n] doc ids, [n, D] f32 rows), encoded in runs of 65536 records."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_LOG_MAGIC + struct.pack("<H", _LOG_VERSION))
            for s in range(0, len(doc_ids), 65536):
                f.write(self._enc_add_batch(doc_ids[s: s + 65536], vectors[s: s + 65536]))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")


class IndexSnapshot:
    """One immutable published generation of the device state a search
    dispatch reads. Writers stage under the index lock and publish a new
    snapshot with one reference swap (`GpuVectorIndex._publish_snapshot`);
    readers grab the current reference lock-free and dispatch on it. See
    the module docstring for why the in-place row writes never reach what
    a snapshot reads. A compressed snapshot carries the codes, the
    quantizers and the bf16 copy in place of the f32 store."""

    __slots__ = ("gen", "dim", "capacity", "n", "live", "store", "sq_norms",
                 "tombs", "slot_to_doc", "slot_to_doc_dev", "host_tombs",
                 "allow_token", "store_gen", "compressed", "pq", "codes",
                 "recon_norms", "rescore_dev", "rescore_sq_norms", "host_vecs",
                 "pq4", "codes4", "recon_norms4", "ivf_centroids", "ivf_buckets",
                 "ivf_pca_proj", "ivf_pca_rows", "ivf_meta")

    def __init__(self, gen: int, idx: "GpuVectorIndex"):
        self.gen = gen
        self.dim = idx.dim
        self.capacity = idx.capacity
        self.n = idx.n
        self.live = idx.live
        self.store = idx._store
        self.sq_norms = idx._sq_norms
        self.tombs = idx._tombs
        self.slot_to_doc = idx._slot_to_doc
        self.slot_to_doc_dev = idx._s2d_dev
        self.host_tombs = idx._host_tombs
        self.allow_token = idx._allow_token
        self.store_gen = idx._store_gen
        self.compressed = idx.compressed
        self.pq = idx._pq
        self.codes = idx._codes
        self.recon_norms = idx._recon_norms
        self.rescore_dev = idx._rescore_dev
        self.rescore_sq_norms = idx._rescore_sq_norms
        self.host_vecs = idx._host_vecs
        self.pq4 = idx._pq4
        self.codes4 = idx._codes4
        self.recon_norms4 = idx._recon_norms4
        # the IVF slabs: a recluster or a bucket fold replaces them whole,
        # so a dispatch on this snapshot answers from ITS layout (the PCA
        # rows change in place only at slots >= n, as the store does)
        self.ivf_centroids = idx._ivf_centroids
        self.ivf_buckets = idx._ivf_buckets
        self.ivf_pca_proj = idx._ivf_pca_proj
        self.ivf_pca_rows = idx._ivf_pca_rows
        self.ivf_meta = idx._ivf_meta  # (nlist, cap_p, recluster gen), host ints


class GpuVectorIndex(VectorIndex):
    # the async dispatch path handles filtered searches, every compressed
    # tier and the gather tier (everything rides the snapshot two-phase
    # enqueue/finalize pipeline): the shard keys off this
    async_supports_filters = True
    # staging buffers parked per (padded batch, dim)
    _STAGE_POOL_CAP = 4
    # a graph key is captured once it has served this many eager dispatches
    # of its bucket unchanged: the bucket's entries then capture at most
    # once each for every eight dispatches the key has already lived, and a
    # key that writes replace sooner (searches beside an import) stays eager
    _GRAPH_AFTER = 8 * _STAGE_POOL_CAP
    # rows per host-scan chunk: bounds the work between deadline checks
    # (and the [B, chunk, D] broadcast of the non-matmul metrics)
    _HOST_SCAN_CHUNK = 65536

    def __init__(
        self,
        config: vi.HnswUserConfig,
        shard_path: str,
        shard_name: str = "",
        device=None,
        persist: bool = True,
        metrics=None,
        class_name: str = "",
    ):
        self.config = config
        self.metric = config.distance
        self.shard_path = shard_path
        self.shard_name = shard_name
        # set before _restore: replay-time metrics must carry the right label
        self.class_name = class_name
        self.metrics = metrics
        self.device = resolve_device(device)
        # the store's element type (`storeDtype`): every write, growth,
        # carried state and rebuild keeps it; row norms stay those of the
        # f32 rows
        self.dtype = torch.bfloat16 if config.store_dtype == "bfloat16" else torch.float32
        # the lock hierarchy (tools/graftsan/lock_hierarchy.json) names the
        # single-device index's locks index.tpu*: the port's index takes
        # the same places in it, so the sanitizers hold it to the same order
        self._lock = sanitizers.register_lock(threading.RLock(), "index.tpu")

        self.dim: Optional[int] = None
        self.capacity = 0
        self.n = 0  # high-water slot count (includes tombstoned slots)
        self.live = 0
        self._store: Optional[torch.Tensor] = None     # [capacity, D] self.dtype
        self._sq_norms: Optional[torch.Tensor] = None  # [capacity] f32 (l2)
        self._tombs: Optional[torch.Tensor] = None     # [capacity] bool
        self._s2d_dev: Optional[torch.Tensor] = None   # [capacity] int64, -1 unwritten
        self._store_gen = 0  # bumped by every in-place row write
        self._slot_to_doc = np.zeros(0, dtype=np.int64)
        self._host_tombs = np.zeros(0, dtype=bool)
        self._doc_to_slot: dict[int, int] = {}
        self._snap: Optional[IndexSnapshot] = None
        self._snap_gen = 0
        self._staged_gen = 0
        self._published_gen = -1
        # monotonic stamp of the OLDEST staged-but-unpublished mutation
        # (ledger staged-publish lag; None = nothing staged / ledger off)
        self._staged_t0: Optional[float] = None
        # per-thread facts of the last dispatch: the snapshot read's lock
        # wait, the perf shape, the auditor's snapshot pin
        self._read_local = threading.local()
        self._inflight = 0  # dispatches between enqueue and finalize
        self._inflight_lock = sanitizers.register_lock(threading.Lock(), "index.tpu.inflight")
        self._inflight_gauge = None  # resolved lazily
        # query staging buffers, a small free-list per (padded batch, dim):
        # pinned host tensors (_PinnedStage) on the card, numpy arrays on
        # the CPU
        self._stage_free: dict[tuple[int, int], list] = {}
        self._stage_lock = sanitizers.register_lock(threading.Lock(), "index.tpu.stage_pool")
        # CUDA graphs of the gmin dispatch (_DispatchGraph, one per staging
        # entry): what each (padded batch, dim) bucket has seen
        self._graph_seen: dict[tuple[int, int], _GraphBucket] = {}
        # (before the upload, after the last kernel) timing event pairs of
        # traced dispatches on the card; list pop/append need no lock
        self._event_pool: list = []
        # host f32 copy of the store (+ its row sq-norms) for the breaker's
        # fallback plane (search_by_vectors_host), built once per snapshot
        # generation — (gen, rows, sq_norms)
        self._host_rows_cache: Optional[tuple[int, np.ndarray, np.ndarray]] = None
        # per-stage funnel survivor accounting for health()["pq"]
        self._pq4_lock = sanitizers.register_lock(threading.Lock(), "index.tpu.pq4")
        self._pq4_stats = {"dispatches": 0, "stage1_rows": 0,
                           "stage2_survivors": 0, "stage3_survivors": 0}
        # staging buffer keyed by doc_id: a re-add of a staged doc replaces it
        self._pending: dict[int, np.ndarray] = {}
        self._pending_tombs: list[int] = []
        # identity token for the per-allowList filter caches
        self._allow_token = object()
        # block layouts of the rescore gathers, by source name: (source
        # tensor, write generation, layout)
        self._blk_cache: dict[str, tuple] = {}
        # PQ state: when compressed the card holds codes (and, with
        # pq.rescore, a bf16 copy of the rows) instead of the f32 store;
        # the f32 rows move to host memory
        self.compressed = False
        self._pq: Optional[ProductQuantizer] = None
        self._codes: Optional[torch.Tensor] = None             # [capacity, M]
        self._recon_norms: Optional[torch.Tensor] = None       # [capacity] f32 ||recon||^2
        self._rescore_dev: Optional[torch.Tensor] = None       # [capacity, D] bf16
        self._rescore_sq_norms: Optional[torch.Tensor] = None  # [capacity] f32 (l2)
        self._host_vecs: Optional[np.ndarray] = None           # [capacity, D] f32
        # 4-bit funnel ladder (pq.bits=4): a 16-centroid quantizer sharing
        # the 8-bit one's rotation, its nibble-packed codes and norms
        self._pq4: Optional[ProductQuantizer] = None
        self._codes4: Optional[torch.Tensor] = None            # [capacity, M/2] uint8
        self._recon_norms4: Optional[torch.Tensor] = None      # [capacity] f32
        self._pq_path = os.path.join(shard_path, "pq.npz")
        self._pq4_path = os.path.join(shard_path, "pq4.npz")
        self._restoring = False
        # -- IVF scan plane (ops/ivf.py): device slabs, None until the write
        # path trains a layout: centroids [nlist, D] f32, padded buckets
        # [nlist, cap_p] int32 (-1 padding), optional PCA projection [D, dp]
        # and per-slot low-dim rows [capacity, dp]
        self._ivf_centroids: Optional[torch.Tensor] = None
        self._ivf_buckets: Optional[torch.Tensor] = None
        self._ivf_pca_proj: Optional[torch.Tensor] = None
        self._ivf_pca_rows: Optional[torch.Tensor] = None
        # host twins for write-path assignment, the per-slot partition (-1
        # unassigned), per-partition fills and the layout metadata
        self._ivf_centroids_host: Optional[np.ndarray] = None
        self._ivf_pca_host: Optional[np.ndarray] = None
        self._ivf_assign = np.zeros(0, dtype=np.int32)
        self._ivf_fills: Optional[np.ndarray] = None
        self._ivf_meta: Optional[tuple[int, int, int]] = None
        self._ivf_cap_p: Optional[int] = None
        # written (slots, partitions) runs awaiting the incremental bucket
        # fold at the next publish
        self._ivf_pending_slots: list[tuple[np.ndarray, np.ndarray]] = []
        self._ivf_trained_n = 0
        self._ivf_gen = 0            # recluster generation
        self._ivf_dirty = False      # buckets stale vs assignments
        # probe accounting (health, probed_fraction), under a leaf lock
        self._ivf_lock = sanitizers.register_lock(threading.Lock(), "index.tpu.ivf")
        self._ivf_stats = {"dispatches": 0, "probed_rows": 0, "base_rows": 0}
        # host-memory provider (monitoring/memory.py): the slot/tombstone
        # mirrors, PQ host rows, staged rows, the breaker's fallback cache
        # and the staging pool become /debug/memory host components
        memory.register_host_provider(self, memory.index_host_components)
        self._log = VectorLog(os.path.join(shard_path, "vector.log")) if persist else None
        if self._log is not None:
            self._restore()

    # -- lifecycle -----------------------------------------------------------

    def _restore(self) -> None:
        """Replay the vector log (startup.go:56 restoreFromDisk analog); if a
        persisted PQ codebook exists, re-enter compressed mode by encoding
        the replayed rows against it (the analog of the commit log's AddPQ
        replay). A codebook this index cannot use (a rejected config, a
        corrupt file, a dim mismatch) leaves the shard serving
        uncompressed, with a warning."""
        self._restoring = True
        try:
            replay_stats: dict = {}
            for op, ids, vecs in VectorLog.replay_batches(self._log.path, stats=replay_stats):
                if op == "add":
                    self._bulk_stage_add(ids, vecs)
                else:
                    self._stage_delete(int(ids), log=False)
            VectorLog.report_replay_stats(self._log.path, replay_stats)
            if os.path.exists(self._pq_path):
                self._flush_pending()
                if self.n > 0:
                    try:
                        pq = ProductQuantizer.load(self._pq_path, device=self.device)
                        self._enable_pq(pq, self._store[: self.n], save=False)
                    except Exception as e:  # noqa: BLE001 — an unusable file, see above
                        self.config.pq.enabled = False
                        _log.warning("persisted pq codebook rejected (%s: %s); "
                                     "serving uncompressed", type(e).__name__, e)
        finally:
            self._restoring = False

    def post_startup(self) -> None:
        with self._lock:
            self._flush_pending()

    # -- device plumbing -----------------------------------------------------

    def _init_device(self, dim: int) -> None:
        self.dim = dim
        self.capacity = _MIN_CAPACITY
        dev = self.device
        self._store = torch.zeros((self.capacity, dim), dtype=self.dtype, device=dev)
        self._sq_norms = torch.zeros(self.capacity, dtype=torch.float32, device=dev)
        self._tombs = torch.zeros(self.capacity, dtype=torch.bool, device=dev)
        self._s2d_dev = torch.full((self.capacity,), -1, dtype=torch.int64, device=dev)
        self._slot_to_doc = np.full(self.capacity, -1, dtype=np.int64)
        self._host_tombs = np.zeros(self.capacity, dtype=bool)
        self._stamp_memory()

    def _ensure_capacity(self, needed: int) -> None:
        if self._store is None and self._codes is None:
            raise RuntimeError("store not initialised")
        cap = self.capacity
        while cap < needed:
            cap *= 2  # geometric growth (maintainance.go:31)
        if cap == self.capacity:
            return
        faults.fire("index.gpu.alloc")
        if self.compressed:
            self._codes = _grow(self._codes, cap, 0)
            self._recon_norms = _grow(self._recon_norms, cap, 0.0)
            self._rescore_dev = _grow(self._rescore_dev, cap, 0.0)
            self._rescore_sq_norms = _grow(self._rescore_sq_norms, cap, 0.0)
            self._codes4 = _grow(self._codes4, cap, 0)
            self._recon_norms4 = _grow(self._recon_norms4, cap, 0.0)
            hv = np.zeros((cap, self.dim), np.float32)
            hv[: self.capacity] = self._host_vecs
            self._host_vecs = hv
        else:
            self._store = _grow(self._store, cap, 0.0)
            self._sq_norms = _grow(self._sq_norms, cap, 0.0)
        self._tombs = _grow(self._tombs, cap, False)
        self._s2d_dev = _grow(self._s2d_dev, cap, -1)
        self._ivf_pca_rows = _grow(self._ivf_pca_rows, cap, 0.0)
        if self._ivf_assign.size:
            ia = np.full(cap, -1, np.int32)
            ia[: self.capacity] = self._ivf_assign[: self.capacity]
            self._ivf_assign = ia
        self._store_gen += 1
        s2d = np.full(cap, -1, dtype=np.int64)
        s2d[: self.capacity] = self._slot_to_doc
        self._slot_to_doc = s2d
        ht = np.zeros(cap, dtype=bool)
        ht[: self.capacity] = self._host_tombs
        self._host_tombs = ht
        self.capacity = cap
        led = memory.get_ledger()
        if led is not None:
            led.note_write_shape(("grow", cap, self.dim or 0, self.compressed))
        self._stamp_memory()

    def _write_block(self, rows: np.ndarray, start: int) -> None:
        """Land [count, D] f32 rows at slots [start, start+count), in
        _CHUNK-row steps that grow the store as the JAX package's padded
        chunk writes do (so both packages reach the same capacity). The
        copy is in place: every slot written is >= self.n (module
        docstring). Row norms are summed in f64 and rounded to f32, as the
        JAX package does on the host: a bf16 store keeps the norms of the
        f32 rows, as the JAX package's does. Compressed, each chunk is
        encoded on the device and lands as codes (and as bf16 rows with
        pq.rescore); the f32 rows go to the host copy."""
        count = rows.shape[0]
        off = 0
        while off < count:
            take = min(_CHUNK, count - off)
            self._ensure_capacity(start + off + _CHUNK)
            chunk = torch.from_numpy(np.ascontiguousarray(rows[off: off + take])).to(self.device)
            lo, hi = start + off, start + off + take
            if self.compressed:
                codes = self._pq.encode(chunk)
                self._codes[lo:hi] = codes
                self._recon_norms[lo:hi] = self._pq.recon_sq_norms(codes)
                if self._pq4 is not None:
                    codes4 = self._pq4.encode(chunk)
                    self._codes4[lo:hi] = pack_codes4(codes4)
                    self._recon_norms4[lo:hi] = self._pq4.recon_sq_norms(codes4)
                if self._rescore_dev is not None:
                    self._rescore_dev[lo:hi] = chunk.to(torch.bfloat16)
                    if self._rescore_sq_norms is not None:
                        self._rescore_sq_norms[lo:hi] = (chunk.double() ** 2).sum(1).float()
            else:
                self._store[lo:hi] = chunk.to(self.dtype)
                if self.metric == vi.DISTANCE_L2:
                    self._sq_norms[lo:hi] = (chunk.double() ** 2).sum(1).float()
            off += take
        if self.compressed:
            self._host_vecs[start: start + count] = rows
        self._store_gen += 1
        self._ivf_on_rows_written(rows, start)
        self._stamp_memory()

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
        self._staged_gen += 1
        self._mark_staged()
        old = self._doc_to_slot.pop(doc_id, None)
        if old is not None:
            self._pending_tombs.append(old)
            self.live -= 1
        if doc_id in self._pending:
            self.live -= 1
        self._pending[doc_id] = vector
        self.live += 1
        if log and self._log is not None:
            self._log.append_add(doc_id, vector)
        if len(self._pending) >= _CHUNK:
            self._flush_pending()

    def _bulk_stage_add(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Restore-path bulk staging with _stage_add's semantics (keep-last
        for duplicate docs in the run, the per-record path for docs the
        index already knows). Tiny runs stay per-record; mid-size runs feed
        the staging buffer; runs of at least a full chunk write directly."""
        if len(ids) < 256:
            for d, v in zip(ids.tolist(), vecs):
                self._stage_add(int(d), v, log=False)
            return
        if self.dim is None:
            self._init_device(int(np.asarray(vecs).shape[1]))
        elif np.asarray(vecs).shape[1] != self.dim:
            raise ValueError(
                f"dim mismatch: index has {self.dim}, got {np.asarray(vecs).shape[1]}")
        d2s = self._doc_to_slot
        ids64, vecs, known = _prep_bulk_run(
            ids, vecs, self.metric, lambda d: d in d2s or d in self._pending)
        if known:
            for i in known:
                self._stage_add(int(ids64[i]), vecs[i], log=False)
            keep = np.ones(len(ids64), bool)
            keep[known] = False
            ids64, vecs = ids64[keep], vecs[keep]
            if len(ids64) == 0:
                return
        if len(ids64) < _CHUNK:
            self._pending.update(zip(ids64.tolist(), vecs))
            self.live += len(ids64)
            if len(self._pending) >= _CHUNK:
                self._flush_pending()
            return
        self._flush_pending()  # earlier staged singles keep their slots
        count = len(ids64)
        self._staged_gen += 1
        self._mark_staged()
        self._ensure_capacity(self.n + count)
        self._cow_host_state()
        self._write_block(np.ascontiguousarray(vecs), self.n)
        self._assign_slots(ids64, self.n)
        self.n += count
        self.live += count

    def _stage_delete(self, doc_id: int, log: bool = True) -> None:
        slot = self._doc_to_slot.pop(doc_id, None)
        if slot is None:
            # may still be in the staging buffer; an unknown doc changes
            # nothing and must not dirty the published snapshot
            if doc_id in self._pending:
                del self._pending[doc_id]
                self.live -= 1
                self._staged_gen += 1
                self._mark_staged()
                if log and self._log is not None:
                    self._log.append_delete(doc_id)
            return
        self._pending_tombs.append(slot)
        self.live -= 1
        self._staged_gen += 1
        self._mark_staged()
        if log and self._log is not None:
            self._log.append_delete(doc_id)

    def _assign_slots(self, docs: np.ndarray, start: int) -> None:
        """Record docs at slots [start, start+len): the host slot->doc
        mirror, the device column (in place, slots >= self.n) and the
        doc->slot map."""
        count = len(docs)
        self._slot_to_doc[start: start + count] = docs
        self._s2d_dev[start: start + count] = torch.from_numpy(
            np.ascontiguousarray(docs, dtype=np.int64)).to(self.device)
        self._doc_to_slot.update(zip(docs.tolist(), range(start, start + count)))

    def _cow_host_state(self) -> None:
        """Copy-on-write the host tombstone mirror when a published
        snapshot still holds it (deletes flip bits at live slots). The
        slot->doc mirror needs no copy: writers assign only at slots >=
        every published snapshot's n."""
        snap = self._snap
        if snap is not None and snap.host_tombs is self._host_tombs:
            self._host_tombs = self._host_tombs.copy()

    def _flush_pending(self) -> None:
        flushed = bool(self._pending or self._pending_tombs)
        led = memory.get_ledger()
        if flushed:
            self._cow_host_state()
        if self._pending:
            t0 = time.perf_counter()
            rows = np.stack(list(self._pending.values()))
            docs = np.array(list(self._pending.keys()), dtype=np.int64)
            count = rows.shape[0]
            self._ensure_capacity(self.n + count)
            self._write_block(rows, self.n)
            self._assign_slots(docs, self.n)
            self.n += count
            self._pending.clear()
            self._obs_index("add", "flush", t0, ops=count)
            if led is not None:
                led.note_write("add", "flush", (time.perf_counter() - t0) * 1000.0,
                               rows=count, bytes_moved=count * (self.dim or 0) * 4)
        if self._pending_tombs:
            t0 = time.perf_counter()
            count = len(self._pending_tombs)
            self._apply_pending_tombs()
            self._obs_index("delete", "apply_tombstones", t0, ops=count)
            if led is not None:
                led.note_write("delete", "apply_tombstones",
                               (time.perf_counter() - t0) * 1000.0, rows=count)
        if flushed:
            # gauges refresh only when state changed: _flush_pending runs at
            # the top of every search and must stay free on the hot path
            self._update_index_gauges()
        self._maybe_declared_compress()
        self._maybe_ivf_train()
        if flushed or self._published_gen != self._staged_gen:
            # publication is the LAST step: readers grabbing the new
            # reference must see every staged mutation already applied
            self._publish_snapshot()

    def _apply_pending_tombs(self) -> None:
        """Set the staged tombstones, out of place: published snapshots
        keep their pre-delete mask. Callers have copied the host mirror
        (_cow_host_state) if a snapshot holds it."""
        if not self._pending_tombs:
            return
        idx = np.array(self._pending_tombs, dtype=np.int64)
        tombs = self._tombs.clone()
        tombs[torch.from_numpy(idx).to(self.device)] = True
        self._tombs = tombs
        self._host_tombs[idx] = True
        self._pending_tombs.clear()

    def _maybe_declared_compress(self) -> None:
        """pq.enabled set at creation: compress once enough rows exist to
        fit the codebook (the reference needs an explicit config update;
        the JAX package also honours the declarative form). Runs on every
        flush and every batch write, never during a restore. A pq config
        that turns out invalid only once the dims are known disables
        compression with a warning instead of failing every later write."""
        if (self.config.pq.enabled and not self.compressed and not self._restoring
                and self.n >= max(256, self.config.pq.centroids)):
            try:
                self._compress_locked()
            except vi.ConfigValidationError as e:
                self.config.pq.enabled = False
                _log.warning("declared pq config is invalid (%s); auto-disabling "
                             "compression for this index", e)

    # -- IVF scan plane: write half (ops/ivf.py host half) -------------------
    # Training is declarative, like the declared compress: once IVF is on
    # and min_n rows exist, the write path fits k-means centroids and
    # buckets every row; later row runs are assigned to their nearest
    # centroid as they land, and the buckets fold them in before the next
    # publish. All of it is one comparison while IVF is off.

    def _ivf_on_rows_written(self, rows: np.ndarray, start: int) -> None:
        """Assign a written row run to the trained layout and write its PCA
        rows (in place: slots >= n, as the store's rows)."""
        cent = self._ivf_centroids_host
        if cent is None:
            return
        count = rows.shape[0]
        assign = ivf_ops.assign_partitions(rows, cent)
        if self._ivf_assign.shape[0] < self.capacity:
            ia = np.full(self.capacity, -1, np.int32)
            ia[: self._ivf_assign.shape[0]] = self._ivf_assign
            self._ivf_assign = ia
        self._ivf_assign[start: start + count] = assign
        if self._ivf_pca_host is not None:
            self._write_ivf_pca(rows @ self._ivf_pca_host, start)
        self._ivf_pending_slots.append(
            (np.arange(start, start + count, dtype=np.int32), assign))
        self._ivf_dirty = True

    def _write_ivf_pca(self, block: np.ndarray, start: int) -> None:
        """Land a [count, dp] PCA row run at slots [start, start+count)."""
        if self._ivf_pca_rows is None:
            return
        self._ivf_pca_rows[start: start + block.shape[0]] = torch.from_numpy(
            np.ascontiguousarray(block, dtype=np.float32)).to(self.device)

    def _ivf_nlist(self, s: IvfConfig, n: int) -> int:
        """Partition count for an n-row layout: the configured value
        (at most n/8), or auto: ~256 rows per partition snapped up to a
        power of two, in [16, 4096] and at most n/32."""
        if s.nlist > 0:
            return max(1, min(s.nlist, max(n // 8, 1)))
        target = 2 ** int(math.ceil(math.log2(max(n / 256.0, 16.0))))
        return int(max(16, min(target, 4096, max(n // 32, 16))))

    def _ivf_rows_for_training(self) -> np.ndarray:
        """The occupied rows as host f32 for the k-means and PCA fits: the
        host copy under PQ, else one bulk copy of the store (a bf16 store
        widened to f32)."""
        if self.compressed and self._host_vecs is not None:
            return self._host_vecs[: self.n]
        return self._store[: self.n].cpu().float().numpy()

    def _maybe_ivf_train(self) -> None:
        """Train once min_n rows exist (at least 256), retrain once n
        outgrows the trained layout by retrain_growth; never during a
        restore, never for the non-matmul metrics."""
        s = ivf_settings()
        if s is None or self._restoring or self.dim is None:
            return
        if self.metric not in ivf_ops.MATMUL_METRICS:
            return
        if self.n < max(s.min_n, 256):
            return
        if self._ivf_centroids is not None and \
                self.n < self._ivf_trained_n * (1.0 + s.retrain_growth):
            return
        self._ivf_train_locked(s)

    def _ivf_train_locked(self, s: IvfConfig) -> None:
        """Train (or retrain) the layout under the write lock: k-means on the
        host, balanced assignment of every row (the padded width pinned by
        the mean fill with 25% slack), the optional PCA basis and low-dim
        rows, the buckets; every IVF tensor is new, so published snapshots
        keep their layout."""
        t0 = time.perf_counter()
        n = self.n
        rows = self._ivf_rows_for_training()
        nlist = self._ivf_nlist(s, n)
        cent = ivf_ops.kmeans_fit(
            rows, nlist, iters=s.train_iters, seed=self._ivf_gen,
            sample=min(len(rows), max(s.train_sample, nlist * 16)))
        if self.metric == vi.DISTANCE_COSINE:
            nrm = np.linalg.norm(cent, axis=1, keepdims=True)
            nrm[nrm == 0] = 1.0
            cent = cent / nrm
        cap_t = ivf_ops.bucket_capacity(np.array([int(1.25 * n / nlist) + 1]))
        assign = np.full(self.capacity, -1, np.int32)
        assign[:n] = ivf_ops.balanced_assign(rows, cent, cap_t)
        self._ivf_cap_p = cap_t
        self._ivf_centroids_host = cent
        self._ivf_assign = assign
        self._ivf_centroids = torch.from_numpy(np.ascontiguousarray(cent)).to(self.device)
        dp = int(s.pca_dim)
        if 0 < dp < self.dim:
            psamp = min(len(rows), max(s.train_sample, 4096))
            if psamp < len(rows):
                pick = np.random.default_rng(self._ivf_gen).choice(
                    len(rows), size=psamp, replace=False)
                proj = ivf_ops.pca_fit(rows[pick], dp)
            else:
                proj = ivf_ops.pca_fit(rows, dp)
            self._ivf_pca_host = proj
            self._ivf_pca_proj = torch.from_numpy(proj).to(self.device)
            pr = torch.zeros((self.capacity, dp), dtype=torch.float32, device=self.device)
            pr[:n] = torch.from_numpy(np.ascontiguousarray(rows @ proj)).to(self.device)
            self._ivf_pca_rows = pr
        else:
            self._ivf_pca_host = self._ivf_pca_proj = self._ivf_pca_rows = None
        self._ivf_trained_n = n
        self._ivf_gen += 1
        self._ivf_rebuild_buckets()
        self._staged_gen += 1
        self._mark_staged()
        self._stamp_memory()
        ms = (time.perf_counter() - t0) * 1000.0
        led = memory.get_ledger()
        if led is not None:
            led.note_write("ivf", "recluster", ms, rows=n)
        incidents.emit("write_phase", scope="ivf_recluster", rows=n, nlist=nlist,
                       ms=round(ms, 1))

    def _ivf_apply_pending(self) -> None:
        """Fold written slots into the buckets' free columns (a scatter into
        a copy: a published snapshot may hold the old table); a bucket that
        would overflow its padding, or no bucket table yet, rebuilds it."""
        pend, self._ivf_pending_slots = self._ivf_pending_slots, []
        if self._ivf_buckets is None or self._ivf_fills is None or not pend:
            self._ivf_rebuild_buckets()
            return
        slots = np.concatenate([sl for sl, _ in pend])
        parts = np.concatenate([pt for _, pt in pend])
        nlist = self._ivf_fills.shape[0]
        counts = np.bincount(parts, minlength=nlist)
        if bool((self._ivf_fills + counts > self._ivf_cap_p).any()):
            self._ivf_rebuild_buckets()
            return
        order = np.argsort(parts, kind="stable")
        sp, ss = parts[order], slots[order]
        starts = np.zeros(nlist + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        cols = np.arange(sp.size, dtype=np.int64) - starts[sp] + self._ivf_fills[sp]
        buckets = self._ivf_buckets.clone()
        dev = self.device
        buckets[torch.from_numpy(sp.astype(np.int64)).to(dev),
                torch.from_numpy(cols).to(dev)] = torch.from_numpy(ss).to(dev)
        self._ivf_buckets = buckets
        self._ivf_fills = self._ivf_fills + counts
        self._ivf_dirty = False
        self._stamp_memory()

    def _ivf_rebuild_buckets(self) -> None:
        """Rebuild the padded buckets from the host assignment (one bucket
        sort, one upload), keeping the padded width while every bucket
        fits."""
        cent = self._ivf_centroids_host
        if cent is None:
            return
        nlist = cent.shape[0]
        buckets, fills = ivf_ops.build_buckets(self._ivf_assign, nlist, self._ivf_cap_p)
        self._ivf_cap_p = int(buckets.shape[1])
        self._ivf_fills = fills
        self._ivf_buckets = torch.from_numpy(buckets).to(self.device)
        self._ivf_meta = (nlist, self._ivf_cap_p, self._ivf_gen)
        self._ivf_pending_slots = []
        self._ivf_dirty = False
        self._stamp_memory()

    def _ivf_reset(self) -> None:
        """Drop the whole IVF layout (compact's rebuild and drop())."""
        self._ivf_centroids = self._ivf_buckets = None
        self._ivf_pca_proj = self._ivf_pca_rows = None
        self._ivf_centroids_host = self._ivf_pca_host = None
        self._ivf_assign = np.zeros(0, dtype=np.int32)
        self._ivf_fills = None
        self._ivf_meta = None
        self._ivf_cap_p = None
        self._ivf_pending_slots = []
        self._ivf_trained_n = 0
        self._ivf_dirty = False

    def ivf_stats(self) -> dict:
        """Cumulative probe accounting: dispatches the IVF plane served, the
        rows the probes read (top_p x cap_p, padding included) and the rows
        a flat scan would have read, with their ratio."""
        with self._ivf_lock:
            st = dict(self._ivf_stats)
        st["probed_fraction"] = (round(st["probed_rows"] / st["base_rows"], 4)
                                 if st["base_rows"] else None)
        return st

    # -- snapshot publication / lock-free reads ------------------------------

    def _publish_snapshot(self) -> None:
        """Publish the current device state as a new immutable snapshot
        (one reference swap; callers hold self._lock). Pending partition
        assignments fold into the buckets first, so the buckets a snapshot
        carries describe exactly its slot space."""
        if self._ivf_dirty:
            self._ivf_apply_pending()
        self._snap_gen += 1
        self._snap = IndexSnapshot(self._snap_gen, self)
        self._published_gen = self._staged_gen
        if self.device.type == "cuda":
            self._drop_stale_graphs()
        m = self.metrics
        if m is not None:
            cls, shard = self._metric_labels()
            m.index_snapshot_gen.labels(cls, shard).set(self._snap_gen)
        self._stamp_memory()
        led = memory.get_ledger()
        if led is not None and self._staged_t0 is not None:
            led.note_publish((time.perf_counter() - self._staged_t0) * 1000.0)
        self._staged_t0 = None

    def _drop_stale_graphs(self) -> None:
        """Drop the CUDA graphs of the parked staging entries: a publish
        follows a write, which changes what they captured (n, the
        tombstones, the store or its block layout). A parked entry's fetch
        is done, so none of them is in flight; a checked-out entry's graph
        goes when the entry is released (`_release_stage`)."""
        with self._stage_lock:
            for lst in self._stage_free.values():
                for entry in lst:
                    entry.graph = None

    def _read_snapshot(self) -> IndexSnapshot:
        """The snapshot a search dispatches on: lock-free when nothing is
        staged; otherwise take the write lock once, flush and publish (the
        read-your-writes check, paid by the first read after a write) and
        record the wait for `pop_read_lock_wait`. With the tracer up the
        read is the dispatch's `index.snapshot` step."""
        since = _clock() if tracing.get_tracer() is not None else None
        snap = self._snap
        if snap is not None and self._published_gen == self._staged_gen:
            self._read_local.lock_wait_ms = 0.0
        else:
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
                cls, shard = self._metric_labels()
                m.index_lock_wait.labels(cls, shard).observe(wait_ms)
        if since is not None:
            self._read_local.snap_step = _step("index.snapshot", since)
        return snap

    def pop_read_lock_wait(self) -> float:
        """ms the CALLING thread's last snapshot read waited on the write
        lock (0.0 on the lock-free fast path); reading clears it. The shard
        attaches it as a dispatch trace fact."""
        w = getattr(self._read_local, "lock_wait_ms", 0.0)
        self._read_local.lock_wait_ms = 0.0
        return w

    @property
    def snapshot_gen(self) -> int:
        """Published snapshot generation (0 = never published)."""
        snap = self._snap
        return snap.gen if snap is not None else 0

    def _track_inflight(self, delta: int) -> None:
        """Enqueued-but-not-finalized dispatch count (the read pipeline's
        depth), published to the inflight gauge when metrics are on."""
        with self._inflight_lock:
            self._inflight += delta
            val = self._inflight
        g = self._inflight_gauge
        if g is None:
            if self.metrics is None:
                return
            cls, shard = self._metric_labels()
            g = self.metrics.index_inflight_dispatches.labels(cls, shard)
            self._inflight_gauge = g
        g.set(val)

    # -- memory ledger and gauges (monitoring/memory.py, metrics.py) ---------

    def _memory_components(self) -> dict:
        """Byte sizes of every device tensor this index holds, from shapes
        and dtypes only (no sync); the names are the ledger's
        memory.DEVICE_COMPONENTS taxonomy."""
        comps: dict = {}
        for name, arr in (("store", self._store),
                          ("sq_norms", self._sq_norms),
                          ("tombs", self._tombs),
                          ("slot_to_doc", self._s2d_dev),
                          ("pq_codes", self._codes),
                          ("recon_norms", self._recon_norms),
                          ("pq4_codes", self._codes4),
                          ("pq4_norms", self._recon_norms4),
                          ("rescore_store", self._rescore_dev),
                          ("rescore_sq_norms", self._rescore_sq_norms),
                          ("ivf_centroids", self._ivf_centroids),
                          ("ivf_buckets", self._ivf_buckets),
                          ("ivf_pca_proj", self._ivf_pca_proj),
                          ("ivf_pca_rows", self._ivf_pca_rows)):
            b = memory.array_bytes(arr)
            if b:
                comps[name] = b
        return comps

    def _stamp_memory(self) -> None:
        """Stamp the ledger with this index's device components (one
        comparison when no ledger is configured)."""
        led = memory.get_ledger()
        if led is not None:
            led.stamp_device(self, self._memory_components())

    def _mark_staged(self) -> None:
        """Record the first staged-but-unpublished mutation's time so
        publication can report the staged-generation lag."""
        if self._staged_t0 is None and memory.get_ledger() is not None:
            self._staged_t0 = time.perf_counter()

    def _update_index_gauges(self) -> None:
        m = self.metrics
        if m is None:
            return
        cls, shard = self._metric_labels()
        m.vector_index_tombstones.labels(cls, shard).set(self.n - self.live)
        m.vector_index_size.labels(cls, shard).set(self.capacity)
        m.vector_index_live.labels(cls, shard).set(self.live)
        m.index_tombstone_fraction.labels(cls, shard).set(
            (self.n - self.live) / self.n if self.n > 0 else 0.0)
        if self.dim:
            m.vector_dimensions.labels(cls, shard).set(self.live * self.dim)
            if self.compressed and self._pq is not None:
                m.vector_segments.labels(cls, shard).set(self.live * self._pq.segments)

    def load_state(self, state) -> None:
        """Install device state carried over from another index (see
        weaviate_tpu_torch.state.state_from_arrays) into this empty index
        and publish it. An uncompressed store installs in this index's
        store dtype (`storeDtype`). A compressed state installs its quantizers, codes,
        bf16 copy and host rows. An IVF layout (centroids, buckets, PCA
        slabs and meta) installs as trained, its host twins rebuilt from
        the buckets, so the index probes the carried partitions. A
        persistent index rewrites its vector log with the live rows (and
        saves the codebooks); a restart retrains its IVF layout from them."""
        with self._lock:
            if self.n or self._pending or self._pending_tombs:
                raise ValueError("load_state needs an empty index")
            cap, n, dim = int(state.capacity), int(state.n), int(state.dim)
            if cap < _MIN_CAPACITY or cap & (cap - 1) or not 0 <= n <= cap:
                raise ValueError(f"bad carried state: capacity {cap}, n {n}")
            dev = self.device
            if state.pq is None:
                if tuple(state.store.shape) != (cap, dim):
                    raise ValueError(f"store shape {tuple(state.store.shape)} != {(cap, dim)}")
                self._store = state.store.to(dev, self.dtype).contiguous()
                self._sq_norms = state.sq_norms.to(dev, torch.float32).contiguous()
            else:
                if state.host_vecs.shape != (cap, dim):
                    raise ValueError(f"host rows {state.host_vecs.shape} != {(cap, dim)}")
                self._store = self._sq_norms = None
                self._pq, self._pq4 = state.pq, state.pq4
                self._codes = state.codes.to(dev).contiguous()
                self._recon_norms = state.recon_norms.to(dev, torch.float32).contiguous()
                self._host_vecs = np.array(state.host_vecs, dtype=np.float32)
                self._rescore_dev = self._rescore_sq_norms = None
                if state.rescore is not None:
                    self._rescore_dev = state.rescore.to(dev, torch.bfloat16).contiguous()
                    if state.rescore_sq_norms is not None:
                        self._rescore_sq_norms = state.rescore_sq_norms.to(
                            dev, torch.float32).contiguous()
                self._codes4 = self._recon_norms4 = None
                if state.pq4 is not None:
                    self._codes4 = state.codes4.to(dev).contiguous()
                    self._recon_norms4 = state.recon_norms4.to(dev, torch.float32).contiguous()
                self.compressed = True
                self.config.pq.enabled = True
            self.dim, self.capacity, self.n = dim, cap, n
            self._tombs = state.tombs.to(dev, torch.bool).contiguous()
            self._slot_to_doc = np.array(state.slot_to_doc, dtype=np.int64)
            self._s2d_dev = torch.from_numpy(self._slot_to_doc.copy()).to(dev)
            self._host_tombs = self._tombs.cpu().numpy().copy()
            live = np.flatnonzero(~self._host_tombs[:n] & (self._slot_to_doc[:n] >= 0))
            self._doc_to_slot = dict(zip(self._slot_to_doc[live].tolist(), live.tolist()))
            self.live = len(self._doc_to_slot)
            self._store_gen += 1
            self._allow_token = object()
            self._ivf_reset()
            if state.ivf_centroids is not None:
                self._install_ivf(state)
            if self._log is not None:
                if self.compressed:
                    rows = self._host_vecs[live]
                    self._save_codebooks()
                else:
                    rows = self._store[torch.from_numpy(live).to(dev)].float().cpu().numpy()
                self._log.rewrite(self._slot_to_doc[live], rows)
            self._staged_gen += 1
            self._publish_snapshot()

    def _install_ivf(self, state) -> None:
        """load_state's IVF half: the carried slabs on this device, and the
        host twins (centroids, per-slot assignment, fills) the write path
        needs, rebuilt from the buckets."""
        dev = self.device
        nlist, cap_p, gen = (int(v) for v in state.ivf_meta)
        buckets = state.ivf_buckets.to(dev, torch.int32).contiguous()
        if tuple(buckets.shape) != (nlist, cap_p):
            raise ValueError(f"ivf buckets {tuple(buckets.shape)} != {(nlist, cap_p)}")
        self._ivf_centroids = state.ivf_centroids.to(dev, torch.float32).contiguous()
        self._ivf_centroids_host = self._ivf_centroids.cpu().numpy().copy()
        self._ivf_buckets = buckets
        host_b = buckets.cpu().numpy()
        assign = np.full(self.capacity, -1, np.int32)
        part, _col = np.nonzero(host_b >= 0)
        assign[host_b[host_b >= 0]] = part
        self._ivf_assign = assign
        self._ivf_fills = (host_b >= 0).sum(1).astype(np.int64)
        if state.ivf_pca_proj is not None:
            self._ivf_pca_proj = state.ivf_pca_proj.to(dev, torch.float32).contiguous()
            self._ivf_pca_host = self._ivf_pca_proj.cpu().numpy().copy()
            self._ivf_pca_rows = state.ivf_pca_rows.to(dev, torch.float32).contiguous()
        self._ivf_cap_p = cap_p
        self._ivf_gen = gen
        self._ivf_meta = (nlist, cap_p, gen)
        self._ivf_trained_n = self.n

    # -- product quantization (compress.go analog) ---------------------------

    def compress(self) -> None:
        """Fit PQ on the stored rows, encode them all and swap the device
        f32 store for codes (compress.go:39: fit on the cached vectors,
        encode, persist the codebook, drop the float cache)."""
        with self._lock:
            if self._pending or self._pending_tombs:
                self._flush_pending()
            self._compress_locked()

    def _compress_locked(self) -> None:
        if self.compressed:
            return
        if self.n == 0:
            raise RuntimeError("compress requires imported vectors to fit on")
        pqc = self.config.pq
        pq = ProductQuantizer(dim=self.dim, segments=pqc.segments, centroids=pqc.centroids,
                              metric=self.metric, encoder=pqc.encoder.type,
                              distribution=pqc.encoder.distribution, rotation=pqc.rotation,
                              device=self.device)
        vecs = self._store[: self.n].float()
        pq.fit(vecs)
        self._enable_pq(pq, vecs, save=True)

    def _fit_pq4(self, pq: ProductQuantizer, vecs_n: torch.Tensor) -> ProductQuantizer:
        """The funnel's 4-bit quantizer: pq's segments, 16 centroids, fit in
        pq's rotated space (its rotation pinned, not re-learned)."""
        pq4q = ProductQuantizer(dim=self.dim, segments=pq.segments, centroids=pq4.C4,
                                metric=self.metric, encoder=vi.PQ_ENCODER_KMEANS,
                                distribution=self.config.pq.encoder.distribution,
                                rotation=vi.PQ_ROTATION_NONE, device=self.device)
        pq4q.fit(vecs_n, rotation_matrix=pq.rotation_matrix)
        return pq4q

    def _obtain_pq4(self, pq: ProductQuantizer, vecs_n: torch.Tensor) -> ProductQuantizer:
        """A restore takes the persisted pq4.npz (the same codebook across
        restarts); anything else, or a file that does not fit, refits."""
        if self._restoring and os.path.exists(self._pq4_path):
            try:
                pq4q = ProductQuantizer.load(self._pq4_path, device=self.device)
                if pq4q.segments == pq.segments and pq4q.centroids == pq4.C4:
                    return pq4q
            except Exception as e:  # noqa: BLE001 — a refit is always safe
                _log.warning("persisted pq4 codebook rejected (%s: %s); refitting",
                             type(e).__name__, e)
        return self._fit_pq4(pq, vecs_n)

    def _enable_pq(self, pq: ProductQuantizer, vecs_n: torch.Tensor, save: bool,
                   pq4q: Optional[ProductQuantizer] = None) -> None:
        """Encode the n stored rows [n, D] (f32, on the device) with pq and
        switch the index to compressed mode; every new tensor is built
        before any attribute changes, so a failure leaves the index as it
        was. `pq4q` re-encodes against a given 4-bit quantizer (compact)
        instead of obtaining one."""
        n, cap, dev = self.n, self.capacity, self.device
        vecs_n = vecs_n.to(dev, torch.float32)
        codes = pq.encode(vecs_n)
        full = torch.zeros((cap, pq.segments), dtype=pq.code_dtype, device=dev)
        full[:n] = codes
        norms = torch.zeros(cap, dtype=torch.float32, device=dev)
        norms[:n] = pq.recon_sq_norms(codes)
        hv = np.zeros((cap, self.dim), np.float32)
        hv[:n] = vecs_n.cpu().numpy()
        rescore = rescore_sq = None
        if self.config.pq.rescore:
            rescore = torch.zeros((cap, self.dim), dtype=torch.bfloat16, device=dev)
            rescore[:n] = vecs_n.to(torch.bfloat16)
            if self.metric == vi.DISTANCE_L2:
                rescore_sq = torch.zeros(cap, dtype=torch.float32, device=dev)
                rescore_sq[:n] = (vecs_n.double() ** 2).sum(1).float()
        codes4 = norms4 = None
        if self.config.pq.bits == 4:
            pq4q = pq4q if pq4q is not None else self._obtain_pq4(pq, vecs_n)
            c4 = pq4q.encode(vecs_n)
            codes4 = torch.zeros((cap, pq4q.segments // 2), dtype=torch.uint8, device=dev)
            codes4[:n] = pack_codes4(c4)
            norms4 = torch.zeros(cap, dtype=torch.float32, device=dev)
            norms4[:n] = pq4q.recon_sq_norms(c4)
        else:
            pq4q = None
        self._codes, self._recon_norms, self._host_vecs = full, norms, hv
        self._rescore_dev, self._rescore_sq_norms = rescore, rescore_sq
        self._pq4, self._codes4, self._recon_norms4 = pq4q, codes4, norms4
        self._store = self._sq_norms = None
        self._blk_cache.pop("store", None)
        self._pq = pq
        self.compressed = True
        self.config.pq.enabled = True
        if save:
            self._save_codebooks()
        self._store_gen += 1
        self._staged_gen += 1
        self._publish_snapshot()

    def _save_codebooks(self) -> None:
        if self._log is None:
            return
        self._pq.save(self._pq_path)
        if self._pq4 is not None:
            self._pq4.save(self._pq4_path)

    # -- VectorIndex ---------------------------------------------------------

    def add(self, doc_id: int, vector: np.ndarray) -> None:
        with self._lock:
            self._stage_add(int(doc_id), vector)

    def add_batch(self, doc_ids: Sequence[int], vectors: np.ndarray) -> None:
        """Bulk import. Fresh doc_ids take the vectorized path; doc_ids that
        collide with existing/staged entries go through per-row staging."""
        doc_arr = np.asarray(doc_ids, dtype=np.int64)
        vectors = np.asarray(vectors, dtype=np.float32)
        with self._lock:
            if self._doc_to_slot:
                existing = np.fromiter(self._doc_to_slot.keys(), dtype=np.int64)
                collides = bool(np.isin(doc_arr, existing).any())
            else:
                collides = False
            fresh = (not self._pending and not collides
                     and np.unique(doc_arr).size == doc_arr.size)
            if not fresh or vectors.ndim != 2:
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
            if self._log is not None:
                with tracing.span("index.vector_log"):
                    self._log.append_add_batch(doc_arr, vectors)
            t0 = time.perf_counter()
            count = vectors.shape[0]
            with tracing.span("index.device_write"):
                self._staged_gen += 1
                self._mark_staged()
                self._ensure_capacity(self.n + count + _CHUNK)
                self._cow_host_state()
                self._write_block(vectors, self.n)
                self._assign_slots(doc_arr, self.n)
                self.n += count
                self.live += count
                # deletes staged before this batch land in the same snapshot
                # (the JAX package's add_batch publishes without them)
                self._apply_pending_tombs()
                self._maybe_declared_compress()
                self._maybe_ivf_train()
                self._publish_snapshot()
            self._obs_index("add", "batch", t0, ops=count)
            led = memory.get_ledger()
            if led is not None:
                led.note_write("add", "batch", (time.perf_counter() - t0) * 1000.0,
                               rows=count, bytes_moved=count * self.dim * 4)
            self._update_index_gauges()

    def delete(self, *doc_ids: int) -> None:
        with self._lock:
            for d in doc_ids:
                self._stage_delete(int(d))

    def contains(self, doc_id: int) -> bool:
        with self._lock:
            return doc_id in self._doc_to_slot or doc_id in self._pending

    def __len__(self) -> int:
        return self.live

    def distancer_name(self) -> str:
        return self.metric

    # -- read path -----------------------------------------------------------

    def _gmin_rg(self, k: int, capacity: int) -> int:
        """Groups kept by the fast scan: >= k guarantees exact selection
        under exact arithmetic (at most k groups hold the true top-k);
        2k..128 adds slack for the bf16 ranking error. 0 = unsupported."""
        ncols = capacity // gmin_scan.G
        rg = min(max(32, 2 * k), 128, ncols)
        return rg if rg >= k else 0

    def _use_gmin(self, snap: IndexSnapshot, b: int, k: int) -> bool:
        """The routing rules of the JAX package: the exactTopK opt-out, the
        non-matmul metrics, capacities under 16384 and batches under 8
        rows take the chunked exact scan. So does a depth whose resident
        store tile has no plan (`gmin_scan.resident_plan`: D > 6208), the
        port's counterpart of the reference's VMEM plan (`fits_vmem`),
        which already refuses an f32 store from about D 722."""
        if self.config.exact_topk:
            return False
        if self.metric not in vi.MATMUL_DISTANCES:
            return False
        if snap.capacity < _MIN_CAPACITY or b < 8:
            return False
        if gmin_scan.resident_plan(snap.dim) is None:
            return False
        return self._gmin_rg(k, snap.capacity) > 0

    def _rescore_r(self, k: int, n: int) -> int:
        """Chunked-scan candidate depth for the exact rescore: 4k clamped
        to RESCORE_R_BUCKETS[0] below and the control plane's
        `rescore_r_cap` (the top bucket without a plane) above; 0 (no
        rescore) for exactTopK, the non-matmul metrics, or when the depth
        would leave no slack over k."""
        if self.config.exact_topk or self.metric not in vi.MATMUL_DISTANCES:
            return 0
        r_top = RESCORE_R_BUCKETS[-1]
        r_max = controller.rescore_r_cap(r_top)
        if r_max < 2 * k:
            # a cap below this query's slack threshold would zero r and
            # force the exact scan, more work than the static path: the
            # budget may only cut, so such queries keep the top bucket
            r_max = r_top
        r = int(min(max(4 * k, RESCORE_R_BUCKETS[0]), r_max, max(n, 1)))
        return r if r >= 2 * k else 0

    def _gen_blocks(self, name: str, src: torch.Tensor, gen: int, build) -> torch.Tensor:
        """The block layout build(src) of a snapshot's tensor, cached per
        source name and rebuilt when the tensor or its write generation
        changes (the old layout is freed before the new one is built).
        Concurrent readers may race here; a lost race only recomputes the
        layout."""
        hit = self._blk_cache.get(name)
        if hit is not None and hit[0] is src and hit[1] == gen:
            return hit[2]
        self._blk_cache.pop(name, None)
        blk = build(src)
        self._blk_cache[name] = (src, gen, blk)
        return blk

    def _prep_queries_staged(self, vectors: np.ndarray, shape=None, gkey=None):
        """Query prep (f32 cast, cosine normalization, bucket padding) into
        a reusable staging buffer from the per-(padded batch, dim) pool,
        then the upload. On the card the buffer is pinned host memory and
        the upload is non-blocking on the current stream. On the CPU the
        buffer is a numpy array the query tensor aliases.
        -> (device query [bb, D] f32, actual rows, the staging entry, the
        graph mode). With a graph key (`_graph_key`, on the card) the
        entry's graph and the key's count decide the mode (`_graph_mode`);
        a graph replay or capture uploads into the graph's static input,
        so the query is None then. The entry must go back through _release_stage only
        AFTER the dispatch's blocking fetch (the finalize wrapper does): by
        then the copy has read the buffer (on the CPU: the scan has), so
        the next checkout may overwrite it. With a perf shape (tracer up) this is
        the `index.stage` step, a new buffer its `index.stage_alloc` step
        and a count in `shape.stage_alloc`; on the card the dispatch's
        first CUDA event is recorded before the upload."""
        since = _clock() if shape is not None else None
        q = np.ascontiguousarray(vectors, dtype=np.float32)  # the row norms' summation order
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        bb = _bucket_b(b)
        key = (bb, q.shape[1])
        with self._stage_lock:
            lst = self._stage_free.get(key)
            entry = lst.pop() if lst else None
        pinned = self.device.type == "cuda"
        alloc = ()
        if entry is None:
            t_alloc = _clock() if shape is not None else None
            entry = (_PinnedStage(torch.empty(key, dtype=torch.float32, pin_memory=True))
                     if pinned else np.empty(key, np.float32))
            if shape is not None:
                shape.stage_alloc += 1
                alloc = (_step("index.stage_alloc", t_alloc),)
        buf = entry.buf.numpy() if pinned else entry
        if self.metric == vi.DISTANCE_COSINE:
            # divided straight into the buffer: one pass less, each a
            # point where the thread lets go of the interpreter lock
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            np.divide(q, norms, out=buf[:b])
        else:
            np.copyto(buf[:b], q)
        if bb != b:
            buf[b:] = 0.0
        if not pinned:
            if shape is not None:
                shape.spans.append(_step("index.stage", since, alloc))
            return torch.from_numpy(buf), b, entry, GRAPH_EAGER
        mode = self._graph_mode(entry, key, gkey) if gkey is not None else GRAPH_EAGER
        # no timing events while a profiler session is up: the capture
        # times the device itself, and under its start and stop one such
        # record aborted the process
        if shape is not None and profiling.hold_off():
            try:
                try:
                    pair = self._event_pool.pop()
                except IndexError:
                    pair = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                shape.events = (*pair, self._event_pool)
                pair[0].record(torch.cuda.current_stream(self.device))
            finally:
                profiling.let_go()
        q_dev = entry.buf.to(self.device, non_blocking=True) if mode == GRAPH_EAGER else None
        if shape is not None:
            shape.spans.append(_step("index.stage", since, alloc))
        return q_dev, b, entry, mode

    def _graph_mode(self, entry: _PinnedStage, bucket: tuple[int, int], gkey: tuple) -> str:
        """Replay the entry's graph when its key is this dispatch's; else
        drop it (stale: its own fetch is done, so it is not in flight) and
        capture a key that has served `_GRAPH_AFTER` eager dispatches of
        the bucket unchanged, where the entry has a pool or the bucket may
        make one, and the pool fits the device's budget at the bucket's
        last pool size; else run eagerly and count the dispatch. A key that
        writes replace sooner never reaches the count."""
        if entry.graph is not None:
            if entry.graph.key == gkey:
                return GRAPH_REPLAY
            entry.graph = None
        seen = self._graph_seen.get(bucket)
        if seen is None:
            seen = self._graph_seen[bucket] = _GraphBucket()
        if seen.key != gkey:
            seen.key, seen.served = gkey, 0
        elif seen.served >= self._GRAPH_AFTER:
            pool = entry.pool or (seen.spare[-1] if seen.spare else None)
            held = pool.booked[0] if pool is not None else 0
            if ((pool is not None or seen.made < self._STAGE_POOL_CAP)
                    and _graph_fits(self.device, max(0, seen.nbytes - held))):
                return GRAPH_CAPTURE
        seen.served += 1
        return GRAPH_EAGER

    def _graph_key(self, snap: IndexSnapshot, tier: str, allow_list, ivf_plan, bb: int,
                   k_eff: int, s2d) -> Optional[tuple]:
        """(the key of the CUDA graph that may serve this dispatch, its gmin
        launch `_gmin_plan`), or None where the dispatch stays eager: a
        filter, the IVF plane, the tiers that run no full scan, and shapes
        `_use_gmin` sends to the chunked scan (batches under 8 rows among
        them). The key is what the launch reads: the plan's tensors by
        identity (a graph holds them, so no live graph's id is reused) and
        its scalars, the tombstones, the fused layout's doc-id column, n,
        the write generation and the bucketed batch."""
        if allow_list is not None or ivf_plan is not None or tier not in _FULL_SCAN_TIERS:
            return None
        plan = self._gmin_plan(snap, bb, k_eff)
        if plan is None:
            return None
        parts = (*plan, snap.tombs, s2d, snap.n, snap.store_gen, bb)
        return tuple(id(x) if isinstance(x, torch.Tensor) else x for x in parts), plan

    def _capture_graph(self, snap: IndexSnapshot, gkey: tuple, plan: tuple,
                       entry: _PinnedStage, s2d, shape=None) -> bool:
        """Capture the entry's gmin dispatch as one CUDA graph (the
        `index.capture` step) into the entry's pool (a spare one of the
        bucket, or a new one): from a static query input, the eager path's
        own launches of `plan`, K1 through `gmin_scan_launch`, recorded on
        a side stream in thread_local mode, so the other serving threads
        keep launching meanwhile. Nothing runs until the replay. -> False,
        and nothing captured, while a profiler session is up (no capture
        under its start and stop, as no timing event), and where the
        bucket's pool, at the size its last capture measured, no longer
        fits the device's budget (checked again once the captures before
        this one are done). A failed capture raises, as a failed launch
        does. A graph whose pool passes the budget serves this dispatch
        only."""
        if not profiling.hold_off():
            return False
        try:
            since = _clock() if shape is not None else None
            seen = self._graph_seen.setdefault(entry.shape, _GraphBucket())
            if entry.pool is None:
                with self._stage_lock:
                    entry.pool = seen.spare.pop() if seen.spare else None
                    if entry.pool is None:
                        seen.made += 1
                if entry.pool is None:
                    entry.pool = _GraphPool(self.device)
            graph = torch.cuda.CUDAGraph()
            with _capture_lock, _no_collection():
                if not _graph_fits(self.device, max(0, seen.nbytes - entry.pool.booked[0])):
                    return False
                stream = _capture_streams.get(self.device)
                if stream is None:
                    stream = _capture_streams[self.device] = torch.cuda.Stream(self.device)
                share = entry.pool.graph.pool() if entry.pool.graph is not None else None
                with torch.cuda.stream(stream):
                    graph.capture_begin(pool=share, capture_error_mode="thread_local")
                    try:
                        q = torch.empty(entry.shape, dtype=torch.float32, device=self.device)
                        out = self._scan_packed(snap, q, 0, None, s2d, plan)
                    except BaseException:
                        # end the capture the error invalidated; the first
                        # error is the one raised
                        with contextlib.suppress(RuntimeError):
                            graph.capture_end()
                        raise
                    graph.capture_end()
                seen.nbytes, kept = entry.pool.book(graph, self.device)
        finally:
            profiling.let_go()
        entry.graph = _DispatchGraph(gkey, snap.gen, graph, q, out, (*plan, snap.tombs, s2d),
                                     kept)
        if shape is not None:
            shape.spans.append(_step("index.capture", since))
        return True

    def _replay_graph(self, snap: IndexSnapshot, entry: _PinnedStage, b: int, s2d,
                      mode: str, shape=None):
        """Upload the queries into the entry's graph's static input and
        replay the graph, both on the dispatch's stream; finalize() fetches
        its static packed output. K1 counts once a dispatch: the capture
        counted the launch it recorded."""
        g = entry.graph
        g.q.copy_(entry.buf, non_blocking=True)
        g.graph.replay()
        if mode == GRAPH_REPLAY:
            gmin_scan.launches += 1
        return self._finalize(g.out, snap, s2d, b, shape=shape)

    def _release_stage(self, entry) -> None:
        """Park a staging entry for the next dispatch of its shape. Its
        graph goes first when a publish since its capture made it stale,
        and with its pool when its device's budget refused the pool. An
        entry the full pool turns away leaves its graph pool to the
        bucket's spares."""
        if entry is None:
            return
        key = (entry.shape[0], entry.shape[1])
        g = entry.graph if isinstance(entry, _PinnedStage) else None
        if g is not None and (not g.kept or g.gen != self._snap.gen):
            entry.graph = None
        with self._stage_lock:
            # dim is None once drop() ran: an in-flight dispatch finalizing
            # after drop must NOT re-park its buffer into the cleared pool
            # (checked under the lock: drop() sets dim before its locked
            # clear, so a racing finalize either sees dim None here or
            # appends before the clear wipes it)
            if self.dim is None:
                return
            seen = self._graph_seen.get(key)
            if g is not None and not g.kept:
                entry.pool = None
                if seen is not None:
                    seen.made -= 1
            lst = self._stage_free.setdefault(key, [])
            if len(lst) < self._STAGE_POOL_CAP:
                lst.append(entry)
            elif isinstance(entry, _PinnedStage) and entry.pool is not None and seen is not None:
                seen.spare.append(entry.pool)
                entry.graph = entry.pool = None

    def _allow_words(self, snap: IndexSnapshot, allow_list: AllowList) -> torch.Tensor:
        """Packed device filter words (int32 bits) for a snapshot's slot
        layout, cached on the (immutable) allowList per (allow token, n,
        capacity): slot assignment is append-only, so the triple names the
        layout."""
        key = (snap.allow_token, snap.n, snap.capacity)
        cached = getattr(allow_list, "_words_cache", None)
        if cached is not None and cached[0] == key and cached[1].device == self.device:
            return cached[1]
        words = torch.from_numpy(
            pack_allow_words(self._allowed(snap, allow_list), snap.capacity)
            .view(np.int32)).to(self.device)
        try:
            allow_list._words_cache = (key, words)
        except AttributeError:
            pass  # AllowList implementations without the cache slot
        return words

    @staticmethod
    def _allowed(snap: IndexSnapshot, allow_list: AllowList) -> np.ndarray:
        live_docs = snap.slot_to_doc[: snap.n]
        if isinstance(allow_list, Bitmap):
            return allowed_mask(allow_list, live_docs)
        return allow_list.contains_array(live_docs.astype(np.uint64))

    def _allow_slots(self, snap: IndexSnapshot, allow_list: AllowList) -> np.ndarray:
        """Store slots of the allowList's docs in this snapshot (the gather
        tier's input), cached on the allowList like `_allow_words`. The
        list ignores tombstones: the key does not change on deletes, so
        the dispatching snapshot's own device mask drops dead slots."""
        key = (snap.allow_token, snap.n, snap.capacity)
        cached = getattr(allow_list, "_slots_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        slots = np.flatnonzero(self._allowed(snap, allow_list)).astype(np.int64)
        try:
            allow_list._slots_cache = (key, slots)
        except AttributeError:
            pass
        return slots

    def padded_width(self, b: int) -> int:
        """Query rows after bucket padding."""
        return _bucket_b(max(int(b), 1))

    def search_by_vectors(
        self, vectors: np.ndarray, k: int, allow_list: Optional[AllowList] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN on the current published snapshot."""
        snap = self._read_snapshot()
        return self._dispatch_search(snap, vectors, k, allow_list)()

    def search_by_vectors_async(self, vectors: np.ndarray, k: int,
                                allow_list: Optional[AllowList] = None):
        """Enqueue a batched kNN and return finalize() -> (ids, dists)
        without waiting for the device: the caller may enqueue the next
        batch before finalizing this one. The same dispatch as the sync
        call, so the two return the same answers."""
        snap = self._read_snapshot()
        return self._dispatch_search(snap, vectors, k, allow_list)

    def _dispatch_search(self, snap: IndexSnapshot, vectors: np.ndarray,
                         k: int, allow_list: Optional[AllowList] = None):
        """Two-phase search on `snap`: enqueue the device work now (query
        upload and kernels; nothing waits on the device) and return
        finalize(), whose one device->host transfer runs outside any
        lock. Every tier dispatches through here, so sync and async
        searches run the same kernels on the same arguments."""
        if snap.n == 0 or snap.live == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            empty = (np.zeros((b, 0), dtype=np.uint64), np.zeros((b, 0), dtype=np.float32))
            return lambda: empty
        if np.shape(vectors)[-1] != snap.dim:
            raise ValueError(f"dim mismatch: index has {snap.dim}, got {np.shape(vectors)[-1]}")
        faults.fire("index.gpu.dispatch")
        k_eff = min(k, snap.live)
        # the fused dispatch translates on the card from the snapshot's
        # doc-id column; the staged one (s2d None) on the host
        s2d = snap.slot_to_doc_dev if fused_dispatch_enabled() else None
        tier = self.dispatch_tier(snap, allow_list)
        # the partition-pruned plane: after the gather tier, before the
        # flat tiers (large allowLists compose through the packed words)
        ivf_plan = self._ivf_plan(snap, k_eff) if tier != costmodel.TIER_GATHER else None
        # perf-attribution shape (monitoring/costmodel.py): built ONLY
        # while the tracer is up, stamped as the dispatch executes and
        # popped by the shard on the dispatching thread
        shape = None
        rows = 1 if np.ndim(vectors) == 1 else len(vectors)
        if tracing.get_tracer() is not None:
            t_enq0 = time.perf_counter()
            shape = (self._ivf_shape(snap, ivf_plan, rows, _bucket_b(rows), k_eff)
                     if ivf_plan is not None
                     else self._dispatch_shape(snap, tier, allow_list, rows, _bucket_b(rows),
                                               k_eff))
            shape.backend = costmodel.detect_backend(self.device)
            shape.t_start = t_enq0
            snap_step = getattr(self._read_local, "snap_step", None)
            if snap_step is not None:
                self._read_local.snap_step = None
                shape.spans.append(snap_step)
        # the gmin tiers replay one CUDA graph per staging entry on the card
        gkey, plan = ((self._graph_key(snap, tier, allow_list, ivf_plan, _bucket_b(rows), k_eff,
                                       s2d) if self.device.type == "cuda" else None)
                      or (None, None))
        # no device work while a profiler session starts or stops
        with profiling.launching():
            q, b, stage, mode = self._prep_queries_staged(vectors, shape, gkey)
            if (mode == GRAPH_CAPTURE
                    and not self._capture_graph(snap, gkey, plan, stage, s2d, shape)):
                q, mode = stage.buf.to(self.device, non_blocking=True), GRAPH_EAGER
            since = _clock() if shape is not None else None
            if mode != GRAPH_EAGER:
                fin = self._replay_graph(snap, stage, b, s2d, mode, shape)
            elif tier == costmodel.TIER_GATHER:
                fin = self._dispatch_small_allow(snap, q, b, k_eff, allow_list, s2d, shape)
            elif ivf_plan is not None:
                fin = self._dispatch_ivf(snap, q, b, k_eff, allow_list, ivf_plan, s2d, shape)
            elif snap.compressed:
                fin = self._dispatch_full_pq(snap, q, b, k_eff, allow_list, s2d, shape)
            else:
                allow_words = (self._allow_words(snap, allow_list)
                               if allow_list is not None else None)
                fin = self._dispatch_scan(snap, q, b, k_eff, allow_words, s2d, shape=shape)
        if shape is not None:
            shape.spans.append(_step("index.enqueue", since))
            shape.graph = mode
            shape.enqueue_ms = (time.perf_counter() - shape.t_start) * 1000.0
            if s2d is not None:
                # the fused-dispatch ledger invariant: one blocking fetch,
                # no host translation
                shape.fused = True
                shape.translate_ms = 0.0
            self._read_local.dispatch_shape = shape
        # shadow-audit snapshot pin (monitoring/quality.py): the snapshot
        # THIS dispatch read, so a sampled audit re-executes against the
        # same index state; gated so the disabled path stores nothing
        if quality.get_auditor() is not None:
            self._read_local.audit_snap = snap
        self._track_inflight(1)
        done = [False]

        def finalize():
            fetched = False
            try:
                faults.fire("index.gpu.finalize")
                if shape is not None and shape.fetches:
                    shape.fetches = 0  # a retried finalize re-runs the fetch
                t0 = time.perf_counter()
                with profiling.launching():
                    out = fin()
                fetched = True
                if shape is not None:
                    t1 = time.perf_counter()
                    shape.finalize_ms = (t1 - t0) * 1000.0
                    shape.t_end = t1
                return out
            finally:
                if not done[0]:  # idempotent: finalize may be retried
                    done[0] = True
                    self._track_inflight(-1)
                    if fetched:
                        # back to the pool ONLY after a completed fetch: a
                        # buffer recycled under a still-enqueued upload
                        # could be overwritten and corrupt a retry
                        self._release_stage(stage)

        return finalize

    def dispatch_tier(self, snap: IndexSnapshot, allow_list=None) -> str:
        """The costmodel TIER_* a dispatch on `snap` with `allow_list`
        takes: the branching of _dispatch_search, also read by the quality
        auditor."""
        if allow_list is not None and len(allow_list) < self.config.flat_search_cutoff:
            return costmodel.TIER_GATHER
        if snap.compressed:
            if snap.codes4 is not None and self.metric in vi.MATMUL_DISTANCES:
                return costmodel.TIER_PQ_ADC4
            if self.config.pq.rescore and snap.rescore_dev is not None:
                return costmodel.TIER_PQ_RESCORE
            return costmodel.TIER_PQ_CODES
        return costmodel.TIER_EXACT

    def _dispatch_shape(self, snap: IndexSnapshot, tier: str, allow_list, b: int,
                        bb: int, k: int):
        """The costmodel.DispatchShape of one dispatch (the JAX package's
        per-tier attribution: rows scanned and the bytes each row costs)."""
        if tier == costmodel.TIER_GATHER:
            return costmodel.DispatchShape(
                tier, n=min(len(allow_list), snap.live), dim=snap.dim, batch=b,
                batch_padded=bb, bytes_per_row=snap.dim * 4, k=k)
        if tier == costmodel.TIER_PQ_ADC4:
            rescore = self.config.pq.rescore and snap.rescore_dev is not None
            rg4, rc = self._funnel_budgets(k, snap.capacity)
            return costmodel.DispatchShape(
                tier, n=snap.n, dim=snap.dim, batch=b, batch_padded=bb,
                bytes_per_row=snap.pq4.segments // 2, k=k,
                extra={"funnel_c": rg4 * 16, "funnel_rescore": rc,
                       "funnel_stage2_bytes_per_row": snap.pq.segments,
                       "funnel_stage3_bytes_per_row": 2 * snap.dim if rescore else 0})
        if tier == costmodel.TIER_PQ_RESCORE:
            return costmodel.DispatchShape(tier, n=snap.n, dim=snap.dim, batch=b,
                                           batch_padded=bb, bytes_per_row=2 * snap.dim, k=k)
        if tier == costmodel.TIER_PQ_CODES:
            return costmodel.DispatchShape(tier, n=snap.n, dim=snap.dim, batch=b,
                                           batch_padded=bb, bytes_per_row=snap.pq.segments,
                                           k=k)
        return costmodel.DispatchShape(
            tier, n=snap.n, dim=snap.dim, batch=b, batch_padded=bb,
            bytes_per_row=snap.dim * snap.store.element_size(), k=k)

    def pop_dispatch_shape(self):
        """The costmodel.DispatchShape of the CALLING thread's last
        dispatch (None while the tracer is down); reading clears it. The
        shape object is shared with the finalize closure, so a pop at
        enqueue time still sees the timings finalize stamps."""
        s = getattr(self._read_local, "dispatch_shape", None)
        if s is not None:
            self._read_local.dispatch_shape = None
        return s

    def pop_audit_snapshot(self) -> Optional[IndexSnapshot]:
        """The IndexSnapshot the CALLING thread's last dispatch read (None
        unless an auditor was configured at dispatch time); reading clears
        it, so the shadow re-execution is generation-pinned."""
        s = getattr(self._read_local, "audit_snap", None)
        if s is not None:
            self._read_local.audit_snap = None
        return s

    def _dispatch_scan(self, snap: IndexSnapshot, q: torch.Tensor, b: int,
                       k_eff: int, allow_words, s2d, shape=None):
        """Full scan (`_scan_store`): the store uncompressed (f32, or
        bf16 with `storeDtype: bfloat16`: K1 then runs its bf16 filler on
        the store itself), the bf16 rescore copy under PQ with rescore. The group-min fast scan
        when `_use_gmin` allows it, the chunked exact scan otherwise; the
        slot->doc translation runs on the device in both when s2d is the
        snapshot's doc-id column, on the host when it is None."""
        packed = self._scan_packed(snap, q, k_eff, allow_words, s2d)
        return self._finalize(packed, snap, s2d, b, shape=shape)

    @staticmethod
    def _scan_store(snap: IndexSnapshot) -> tuple:
        """(store, row norms, block-cache name) of a full scan on `snap`:
        the store, or under PQ the bf16 rescore copy."""
        if snap.compressed:
            return snap.rescore_dev, snap.rescore_sq_norms, "rescore"
        return snap.store, snap.sq_norms, "store"

    def _gmin_plan(self, snap: IndexSnapshot, b: int, k_eff: int) -> Optional[tuple]:
        """The gmin launch of a full scan of b query rows on `snap`:
        (store, row norms, rescore block layout, kk, rg, live store
        slices), or None where `_use_gmin` sends the scan to the chunked
        path."""
        kk = min(max(k_eff, 1), snap.n)
        if not self._use_gmin(snap, b, kk):
            return None
        store, sq_norms, name = self._scan_store(snap)
        blocks = self._gen_blocks(name, store, snap.store_gen, gmin_scan.build_rescore_blocks)
        return (store, sq_norms, blocks, kk, self._gmin_rg(kk, snap.capacity),
                -(-snap.n // (snap.capacity // gmin_scan.G)))

    def _scan_packed(self, snap: IndexSnapshot, q: torch.Tensor, k_eff: int, allow_words, s2d,
                     plan=None) -> torch.Tensor:
        """The launches of `_dispatch_scan` -> its packed result; `plan` is
        the gmin launch when the caller has it (a graph capture: its block
        layout is built outside the capture, which would otherwise record
        the build into the graph)."""
        use_allow = allow_words is not None
        if plan is None:
            plan = self._gmin_plan(snap, q.shape[0], k_eff)
        if plan is not None:
            store, sq_norms, blocks, kk, rg, active_g = plan
            args = (store, sq_norms, snap.tombs, snap.n, q, allow_words)
            statics = (use_allow, kk, self.metric, rg, active_g, blocks)
            if s2d is not None:
                return gmin_scan.search_gmin_fused(*args, s2d, *statics)
            return gmin_scan.search_gmin(*args, *statics)
        store, sq_norms, _ = self._scan_store(snap)
        kk = min(max(k_eff, 1), snap.n)
        top, idx = _search_full(
            store, sq_norms if self.metric == vi.DISTANCE_L2 else None,
            snap.tombs, snap.n, q, allow_words, kk, self.metric, use_allow,
            -(-snap.n // _SCAN_CHUNK),
            self._rescore_r(kk, snap.n))
        return _pack(top, idx, s2d)

    def _funnel_budgets(self, k: int, n: int) -> tuple[int, int]:
        """(rg4 stage-1 groups, rc stage-2 survivors) of a funnel whose scan
        plane holds n rows (the slab capacity). The two caps are the control
        plane's recall-guarded budgets (`funnel_c_cap`,
        `funnel_rescore_cap`; the ladders' top buckets without a plane); a
        cap too shallow for this query's k lapses to the top bucket (the
        plane may only cut work, never break coverage)."""
        c_top = PQ4_FUNNEL_C_BUCKETS[-1]
        rc_top = PQ4_FUNNEL_RESCORE_BUCKETS[-1]
        c_cap = controller.funnel_c_cap(c_top)
        rc_cap = controller.funnel_rescore_cap(rc_top)
        if c_cap < 4 * k:
            c_cap = c_top
        if rc_cap < 2 * k:
            rc_cap = rc_top
        return pq4.plan_funnel(k, n, c_cap, rc_cap)

    def _pq4_funnel_or_none(self, snap: IndexSnapshot, q: torch.Tensor, k: int,
                            allow_words, use_allow: bool, s2d):
        """The three-stage 4-bit funnel (ops/pq4.py) -> packed result (fused
        with s2d, staged without), or None when this index or k does not
        take it (the 8-bit tiers serve then)."""
        if snap.codes4 is None or snap.pq4 is None or self.metric not in vi.MATMUL_DISTANCES:
            return None
        kk = min(max(k, 1), snap.live)
        ncols = snap.capacity // gmin_scan.G
        rg4, rc = self._funnel_budgets(kk, snap.capacity)
        if rc < kk:
            return None  # candidate set too small to cover k
        pq8 = snap.pq
        args = (snap.codes4, snap.codes, snap.recon_norms4, snap.recon_norms, snap.tombs, snap.n,
                q, snap.pq4.codebook_bf16(), snap.pq4.codebook_dev(),
                pq8.codebook_dev().reshape(-1, pq8.ds), snap.rescore_dev, allow_words)
        statics = (use_allow, kk, self.metric, rg4, rc, max(1, -(-snap.n // ncols)),
                   pq4.use_kernel(self.metric, q.shape[0], ncols, q.shape[1]),
                   snap.pq4.rotation_dev(),
                   self._gen_blocks("codes", snap.codes, snap.store_gen,
                                    pq_gmin.build_codes_blocks))
        if s2d is not None:
            packed = pq4.search_pq4_funnel_fused(*args, s2d, *statics)
        else:
            packed = pq4.search_pq4_funnel(*args, *statics)
        # per-stage survivor accounting (health()["pq"]["funnel"]): live
        # rows, so the funnel reads monotone on a sparse slab too
        with self._pq4_lock:
            st = self._pq4_stats
            st["dispatches"] += 1
            st["stage1_rows"] += int(snap.n)
            st["stage2_survivors"] += min(rg4 * gmin_scan.G, int(snap.n))
            st["stage3_survivors"] += min(rc, int(snap.n))
        return packed

    def _pq_gmin_or_none(self, snap: IndexSnapshot, q: torch.Tensor, k: int,
                         allow_words, use_allow: bool, s2d):
        """The codes kernel's search (ops/pq_gmin.py) -> packed result
        (fused with s2d, staged without), or None when `eligible_rg` routes
        this shape to the reconstruction scan."""
        ncols = snap.capacity // gmin_scan.G
        kk = min(k, snap.live)
        rg = pq_gmin.eligible_rg(self.config.exact_topk, self.metric, snap.pq, q.shape[0],
                                 ncols, kk, q.shape[1])
        if rg is None:
            return None
        pq8 = snap.pq
        args = (snap.codes, snap.recon_norms, snap.tombs, snap.n, q, pq8.codebook_bf16(),
                pq8.codebook_dev().reshape(-1, pq8.ds), allow_words)
        statics = (use_allow, kk, self.metric, rg, max(1, -(-snap.n // ncols)),
                   pq8.rotation_dev(),
                   self._gen_blocks("codes", snap.codes, snap.store_gen,
                                    pq_gmin.build_codes_blocks))
        if s2d is not None:
            return pq_gmin.search_pq_gmin_fused(*args, s2d, *statics)
        return pq_gmin.search_pq_gmin(*args, *statics)

    def _dispatch_full_pq(self, snap: IndexSnapshot, q: torch.Tensor, b: int, k: int,
                          allow_list: Optional[AllowList], s2d, shape=None):
        """Compressed full-store search, in the reference's order: the
        4-bit funnel; the rescored tier (the fast scan reads the bf16 copy
        directly: less traffic and more accurate than scanning the codes
        first); the codes kernel; the reconstruction scan for the shapes
        it does not take; the LUT scan for manhattan (hamming never
        compresses)."""
        pqc = self.config.pq
        use_allow = allow_list is not None
        allow_words = self._allow_words(snap, allow_list) if use_allow else None
        packed = self._pq4_funnel_or_none(snap, q, k, allow_words, use_allow, s2d)
        if packed is not None:
            return self._finalize(packed, snap, s2d, b, k, shape)
        rescore = pqc.rescore and snap.rescore_dev is not None
        if shape is not None and shape.tier == costmodel.TIER_PQ_ADC4:
            # the funnel refused this k: label what serves instead
            shape.tier = costmodel.TIER_PQ_RESCORE if rescore else costmodel.TIER_PQ_CODES
            shape.bytes_per_row = 2 * snap.dim if rescore else snap.pq.segments
            shape.extra = None
        if rescore:
            return self._dispatch_scan(snap, q, b, k, allow_words, s2d, shape=shape)
        packed = self._pq_gmin_or_none(snap, q, k, allow_words, use_allow, s2d)
        if packed is not None:
            return self._finalize(packed, snap, s2d, b, k, shape)
        if self.metric in vi.MATMUL_DISTANCES:
            # per-chunk candidate depth: the pool of every chunk's winners
            # stays >= 512 (pq.rescoreLimit) whatever the chunk count
            nchunks = max(1, -(-snap.n // _SCAN_CHUNK))
            pool_target = pqc.rescore_limit or 1024
            r_top = RESCORE_R_BUCKETS[-1]
            r_cap = controller.rescore_r_cap(r_top)
            if r_cap < r_top:
                # the plane's cap scales the pool too; the floor keeps the
                # pool's own recall guarantee without ever raising a
                # configured rescore_limit below 512 (the plane only cuts)
                pool_target = max(int(pool_target * r_cap / r_top),
                                  min(512, pool_target))
            r_chunk = min(max(2 * k, -(-pool_target // nchunks), 64), 256, snap.n)
            r_chunk = max(r_chunk, min(-(-k // nchunks), snap.n))  # the pool covers k
            top, idx = _search_pq_recon(
                snap.codes, snap.recon_norms, snap.tombs, snap.n, snap.pq, q, allow_words,
                min(k, snap.live), r_chunk, self.metric, use_allow,
                -(-snap.n // _SCAN_CHUNK))
        else:
            lut = build_lut(q, snap.pq.codebook_dev(), self.metric)
            top, idx = _search_pq(snap.codes, snap.tombs, snap.n, lut, allow_words,
                                  min(k, snap.n, _PQ_SCAN_CHUNK), use_allow,
                                  -(-snap.n // _PQ_SCAN_CHUNK))
        return self._finalize(_pack(top, idx, s2d), snap, s2d, b, k, shape)

    @staticmethod
    def _finalize(packed: torch.Tensor, snap: IndexSnapshot, s2d, b: int,
                  k: Optional[int] = None, shape=None):
        """finalize() of a dispatch: the ONE blocking device->host transfer
        (`_fetch_packed`). Fused (s2d given), it already carries final doc
        ids and the host half is dtype views. Staged (s2d None), it carries
        slot indices, translated through the dispatching snapshot's own
        slot->doc mirror (a later write cannot change an in-flight
        answer)."""
        if s2d is not None:
            def finalize():
                ids, dists = unpack_fused(_fetch_packed(packed, shape))
                if k is not None:
                    ids, dists = ids[:, :k], dists[:, :k]
                return ids[:b], dists[:b]

            return finalize
        slot_to_doc = snap.slot_to_doc

        def finalize_staged():
            top, idx = unpack_topk(_fetch_packed(packed, shape))
            t0 = time.perf_counter()
            if k is not None:
                top, idx = top[:, :k], idx[:, :k]
            top, idx = top[:b], idx[:b]
            ids = np.where(idx >= 0, slot_to_doc[np.clip(idx, 0, None)], -1)
            if shape is not None:
                shape.translate_ms = (time.perf_counter() - t0) * 1000.0
            return ids.astype(np.uint64), top.astype(np.float32)

        return finalize_staged

    def _dispatch_small_allow(self, snap: IndexSnapshot, q: torch.Tensor,
                              b: int, k: int, allow_list: AllowList, s2d, shape=None):
        """Gather tier (flatSearch over the allowList, flat_search.go:19).
        Compressed, the allowed rows are uploaded from the host copy."""
        empty = (np.zeros((b, 0), np.uint64), np.zeros((b, 0), np.float32))
        slots = self._allow_slots(snap, allow_list)
        # nothing can match in THIS snapshot: no device work at all
        if slots.size == 0 or not np.any(~snap.host_tombs[slots]):
            if shape is not None:
                shape.n = 0  # no device work ran: zero the analytic cost
            return lambda: empty
        if shape is not None:
            # the gather scores only the rows present in this shard
            shape.n = int(slots.size)
        rows = torch.from_numpy(slots).to(self.device)
        if snap.compressed:
            sub = torch.from_numpy(snap.host_vecs[slots]).to(self.device)
        else:
            sub = snap.store[rows]
        top, pos = _score_rows(sub, q, rows, snap.tombs, min(k, slots.size), self.metric)
        slot_idx = torch.where(pos >= 0, rows[torch.clamp(pos, min=0)], -1)
        return self._finalize(_pack(top, slot_idx, s2d), snap, s2d, b, shape=shape)

    # -- IVF scan plane: dispatch half ---------------------------------------

    def _ivf_plan(self, snap: IndexSnapshot, k: int) -> Optional[tuple[int, int]]:
        """(top_p, prefilter_c) of an IVF dispatch on `snap`, or None for the
        flat tiers: the plane off, no trained layout on the snapshot, or a
        metric without the matmul forms. The probe count is the configured
        one (auto: nlist/16) cut by the control plane's `ivf_top_p_cap`,
        snapped to IVF_TOP_P_BUCKETS (or nlist itself), then widened until
        the probed candidates cover 4k; pre_c (the PCA prefilter's
        survivors, auto max(8k, min(2048, r/8))) snaps to a power of two
        and is 0 unless it cuts."""
        if snap.ivf_buckets is None:
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
        pre_c = 0
        if snap.ivf_pca_proj is not None:
            r = eff * cap_p
            pc = s.prefilter_c if s.prefilter_c > 0 else max(8 * k, min(2048, r // 8))
            pc = _bucket_rows(min(pc, r))
            if pc < r:
                pre_c = pc
        return eff, pre_c

    def _ivf_shape(self, snap: IndexSnapshot, plan: tuple[int, int], b: int, padded: int,
                   k_eff: int):
        """The probed-aware costmodel shape of an IVF dispatch: `n` is the
        rows the device reads (top_p x cap_p candidates, padding included,
        plus the nlist centroids), never the rows the probe skipped."""
        top_p, _pre_c = plan
        nlist, cap_p, _gen = snap.ivf_meta
        probed = top_p * cap_p + nlist
        rescore = snap.compressed and self.config.pq.rescore and snap.rescore_dev is not None
        if not snap.compressed:
            tier, bpr = costmodel.TIER_EXACT, snap.dim * snap.store.element_size()
        elif snap.codes4 is not None and self.metric in vi.MATMUL_DISTANCES:
            tier, bpr = costmodel.TIER_PQ_ADC4, snap.pq4.segments // 2
        elif rescore:
            tier, bpr = costmodel.TIER_PQ_RESCORE, 2 * snap.dim
        else:
            tier, bpr = costmodel.TIER_PQ_CODES, snap.pq.segments
        return costmodel.DispatchShape(
            tier, n=probed, dim=snap.dim, batch=b, batch_padded=padded, bytes_per_row=bpr,
            k=int(k_eff),
            extra={"ivf": True, "ivf_top_p": top_p, "ivf_nlist": nlist,
                   "probed_fraction": round(min(probed / max(snap.n, 1), 1.0), 4)})

    def _dispatch_ivf(self, snap: IndexSnapshot, q: torch.Tensor, b: int, k: int, allow_list,
                      plan: tuple[int, int], s2d, shape=None):
        """Partition-pruned search (ops/ivf.py, ops/pq4.search_ivf_pq4):
        probe the centroids, score only the probed buckets, finish through
        the same packed or fused epilogue as the flat tiers. Serves the
        exact (f32 or bf16 store), PQ-rescore, PQ-codes and 4-bit funnel
        tiers; tombstones and allowLists mask as in the flat scans. Query
        blocks and probes per step come from ops/ivf.plan_steps."""
        top_p, pre_c = plan
        nlist, cap_p, _gen = snap.ivf_meta
        use_allow = allow_list is not None
        allow_words = self._allow_words(snap, allow_list) if use_allow else None
        kk = min(max(k, 1), top_p * cap_p)
        bq, dim, metric = q.shape[0], snap.dim, self.metric
        rescore = snap.compressed and self.config.pq.rescore and snap.rescore_dev is not None
        packed = None
        if snap.codes4 is not None and snap.pq4 is not None and metric in vi.MATMUL_DISTANCES:
            r_cand = top_p * cap_p
            rg4, rc = self._funnel_budgets(kk, r_cand)
            c1 = min(rg4 * gmin_scan.G, r_cand)
            if rc >= kk and c1 >= rc:
                qb, gp, steps2 = ivf_ops.plan_steps(bq, cap_p, dim, top_p, second=c1)
                args = (snap.codes4, snap.codes, snap.recon_norms4, snap.recon_norms,
                        snap.tombs, snap.n, q, allow_words, snap.pq4.codebook_dev(),
                        snap.pq.codebook_dev(), snap.ivf_centroids, snap.ivf_buckets,
                        snap.pq4.rotation_dev(), snap.rescore_dev)
                statics = (kk, metric, use_allow, top_p, c1, rc, gp, steps2)
                if s2d is not None:
                    packed = pq4.search_ivf_pq4_fused(*args, s2d, *statics, qb=qb)
                else:
                    packed = pq4.search_ivf_pq4(*args, *statics, qb=qb)
                with self._pq4_lock:
                    st = self._pq4_stats
                    st["dispatches"] += 1
                    st["stage1_rows"] += r_cand
                    st["stage2_survivors"] += c1
                    st["stage3_survivors"] += rc
            elif shape is not None and shape.tier == costmodel.TIER_PQ_ADC4:
                # the budgets cannot cover this k over the probed set: the
                # 8-bit IVF tier serves, labelled as such
                shape.tier = costmodel.TIER_PQ_RESCORE if rescore else costmodel.TIER_PQ_CODES
                shape.bytes_per_row = 2 * dim if rescore else snap.pq.segments
        if packed is None:
            qb, gp, steps2 = ivf_ops.plan_steps(bq, cap_p, dim, top_p, second=pre_c)
            statics = (kk, metric, use_allow, top_p, pre_c, gp, steps2)
            if not snap.compressed or rescore:
                store = snap.rescore_dev if snap.compressed else snap.store
                args = (store, snap.tombs, snap.n, q, allow_words, snap.ivf_centroids,
                        snap.ivf_buckets, snap.ivf_pca_proj, snap.ivf_pca_rows)
                if s2d is not None:
                    packed = ivf_ops.search_ivf_dense_fused(*args, s2d, *statics, qb=qb)
                else:
                    packed = ivf_ops.search_ivf_dense(*args, *statics, qb=qb)
            else:
                args = (snap.codes, snap.recon_norms, snap.tombs, snap.n, q, allow_words,
                        snap.pq.codebook_dev(), snap.ivf_centroids, snap.ivf_buckets,
                        snap.ivf_pca_proj, snap.ivf_pca_rows, snap.pq.rotation_dev())
                if s2d is not None:
                    packed = ivf_ops.search_ivf_codes_fused(*args, s2d, *statics, qb=qb)
                else:
                    packed = ivf_ops.search_ivf_codes(*args, *statics, qb=qb)
        with self._ivf_lock:
            st = self._ivf_stats
            st["dispatches"] += 1
            st["probed_rows"] += top_p * cap_p
            st["base_rows"] += int(snap.n)
        return self._finalize(packed, snap, s2d, b, shape=shape)

    # -- host fallback plane (serving/robustness.py circuit breaker) ---------

    def host_rows(self, snap: IndexSnapshot) -> tuple[np.ndarray, np.ndarray]:
        """Host f32 ([n, D] rows, [n] row sq-norms) of `snap`'s occupied
        region: one bulk device->host copy and one norms pass, no caching
        (the breaker caches per generation in _host_fallback_rows, the
        quality auditor keeps its own). Under PQ the f32 rows already live
        on the host (host_vecs); a bf16 store's rows come back upcast."""
        if snap.compressed and snap.host_vecs is not None:
            rows = snap.host_vecs[: snap.n]  # a view: no extra memory
        else:
            rows = snap.store[: snap.n].float().cpu().numpy()
        # einsum: the norms pass must not transiently duplicate the rows
        sq = np.einsum("ij,ij->i", rows, rows, dtype=np.float32)
        return rows, sq

    def _host_fallback_rows(self, snap: IndexSnapshot) -> tuple[np.ndarray, np.ndarray]:
        """host_rows built ONCE per snapshot generation and cached: the
        breaker's fallback pays one bulk copy when it first opens, not per
        degraded query. (A card too far gone even to copy its memory makes
        the copy raise; the shard then surfaces the original error.)"""
        cached = self._host_rows_cache
        if cached is not None and cached[0] == snap.gen:
            return cached[1], cached[2]
        rows, sq = self.host_rows(snap)
        self._host_rows_cache = (snap.gen, rows, sq)
        return rows, sq

    def release_host_fallback_cache(self) -> None:
        """Drop the host fallback copy (a full f32 store at serving scale)
        once the breaker has recovered and the card serves this index
        again; it rebuilds on the next breaker-open episode."""
        self._host_rows_cache = None

    def search_by_vectors_host(self, vectors: np.ndarray, k: int,
                               allow_list: Optional[AllowList] = None
                               ) -> tuple[np.ndarray, np.ndarray]:
        """Batched kNN entirely on the HOST (numpy brute force) over the
        published snapshot: the read path the shard routes to while the
        device circuit breaker is open. The contract of search_by_vectors
        ([B, k] ids and dists, inf-padded absent slots); selection is
        exact."""
        snap = self._read_snapshot()
        if snap.n == 0 or snap.live == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            return np.zeros((b, 0), np.uint64), np.zeros((b, 0), np.float32)
        rows, row_sq = self._host_fallback_rows(snap)
        return self._host_search_snap(snap, vectors, k, allow_list, rows, row_sq)

    def search_by_vectors_host_pinned(self, snap: IndexSnapshot, vectors: np.ndarray, k: int,
                                      allow_list: Optional[AllowList] = None,
                                      rows: Optional[np.ndarray] = None,
                                      sq_norms: Optional[np.ndarray] = None,
                                      deadline: Optional[float] = None
                                      ) -> tuple[np.ndarray, np.ndarray]:
        """The quality auditor's host-plane entry: exact brute-force kNN
        over a CALLER-PINNED snapshot (no flush, no lock, no fallback
        cache; callers pass their own `rows`). `deadline`
        (time.monotonic seconds) bounds the scan: quality.AuditDeadlineExceeded
        aborts an over-budget audit."""
        if snap.n == 0 or snap.live == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            return np.zeros((b, 0), np.uint64), np.zeros((b, 0), np.float32)
        if rows is None:
            rows, sq_norms = self.host_rows(snap)
        return self._host_search_snap(snap, vectors, k, allow_list, rows, sq_norms, deadline)

    def _host_search_snap(self, snap: IndexSnapshot, vectors: np.ndarray, k: int,
                          allow_list: Optional[AllowList], rows: np.ndarray,
                          row_sq: np.ndarray, deadline: Optional[float] = None
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Shared exact host scan over a snapshot's rows, in row chunks
        (output-column splits, the same sums as one product) with a
        deadline check per chunk."""
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        empty = (np.zeros((b, 0), np.uint64), np.zeros((b, 0), np.float32))
        if snap.n == 0 or snap.live == 0:
            return empty
        if self.metric == vi.DISTANCE_COSINE:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            q = q / norms
        live = ~snap.host_tombs[: snap.n]
        if allow_list is not None:
            live = live & self._allowed(snap, allow_list)
        n_live = int(live.sum())
        if n_live == 0:
            return empty
        q_sq = (q ** 2).sum(1)[:, None] if self.metric == vi.DISTANCE_L2 else None
        d = np.empty((b, snap.n), np.float32)
        chunk = (4096 if self.metric in (vi.DISTANCE_MANHATTAN, vi.DISTANCE_HAMMING)
                 else self._HOST_SCAN_CHUNK)
        for s in range(0, snap.n, chunk):
            if deadline is not None and time.monotonic() > deadline:
                raise quality.AuditDeadlineExceeded(
                    f"host scan over audit budget at row {s}/{snap.n}")
            blk = rows[s: s + chunk]
            e = s + blk.shape[0]
            if self.metric == vi.DISTANCE_L2:
                d[:, s:e] = np.maximum(q_sq - 2.0 * (q @ blk.T) + row_sq[s:e][None, :], 0.0)
            elif self.metric == vi.DISTANCE_DOT:
                d[:, s:e] = -(q @ blk.T)
            elif self.metric == vi.DISTANCE_COSINE:
                d[:, s:e] = 1.0 - q @ blk.T  # rows are insert-normalized
            elif self.metric == vi.DISTANCE_MANHATTAN:
                d[:, s:e] = np.abs(q[:, None, :] - blk[None, :, :]).sum(-1)
            else:  # hamming
                d[:, s:e] = (q[:, None, :] != blk[None, :, :]).sum(-1)
        d[:, ~live] = np.inf
        kk = min(max(int(k), 1), n_live)
        part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
        pd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(pd, axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1)
        top = np.take_along_axis(pd, order, axis=1)
        ids = np.where(np.isinf(top), -1, snap.slot_to_doc[idx])
        return ids.astype(np.uint64), top.astype(np.float32)

    def _ivf_health(self) -> dict:
        """health()["ivf"]: partition count, bucket fill and padding waste,
        imbalance, the last recluster generation and the probe accounting
        (lock-free racy reads, like the rest of health())."""
        s = ivf_settings()
        cent = self._ivf_centroids_host
        out = {"enabled": s is not None, "trained": cent is not None}
        if cent is None:
            return out
        nlist, cap_p, gen = self._ivf_meta or (cent.shape[0], self._ivf_cap_p or 0,
                                               self._ivf_gen)
        out.update({
            "nlist": int(nlist),
            "bucket_capacity": int(cap_p),
            "trained_n": int(self._ivf_trained_n),
            "last_recluster_gen": int(gen),
            "pca_dim": int(self._ivf_pca_host.shape[1]) if self._ivf_pca_host is not None else 0,
        })
        fills = self._ivf_fills
        if fills is not None and fills.size and cap_p:
            total = int(fills.sum())
            mean = total / max(int(nlist), 1)
            out["buckets"] = {
                "fill_min": int(fills.min()),
                "fill_mean": round(mean, 1),
                "fill_max": int(fills.max()),
                "empty": int((fills == 0).sum()),
                # the padded table's share of -1 rows the probes still read
                "padding_waste": round(1.0 - total / (nlist * cap_p), 4),
                "imbalance": round(float(fills.max()) / mean, 2) if mean > 0 else None,
                "fill_histogram": np.histogram(fills, bins=8, range=(0, cap_p))[0].tolist(),
            }
        out["probes"] = self.ivf_stats()
        return out

    def health(self) -> dict:
        """Per-index introspection for ``GET /debug/index``: live and
        tombstone accounting, snapshot and staged generation lag, PQ state,
        the host fallback cache. Lock-free racy reads (introspection, not
        an invariant); nothing here touches the device."""
        snap = self._snap
        n, live = self.n, self.live
        tombs = max(n - live, 0)
        cache = self._host_rows_cache
        out = {
            "type": "hnsw_tpu",
            "metric": self.metric,
            "dim": self.dim,
            "capacity": self.capacity,
            "slots": n,
            "live": live,
            "tombstones": tombs,
            "tombstone_fraction": round(tombs / n, 4) if n > 0 else 0.0,
            "pending_adds": len(self._pending),
            "pending_tombstones": len(self._pending_tombs),
            "snapshot_gen": snap.gen if snap is not None else 0,
            "staged_gen": self._staged_gen,
            "published_gen": self._published_gen,
            "staged_lag": max(self._staged_gen - self._published_gen, 0),
            "compressed": self.compressed,
            "pq": None,
            "ivf": self._ivf_health(),
            "host_fallback_cache": {
                "resident": cache is not None,
                "gen": cache[0] if cache is not None else None,
                "bytes": memory.host_rows_cache_bytes(self),
            },
            "memory": {
                "device_components": self._memory_components(),
                "host_components": memory.index_host_components(self),
            },
        }
        pq = self._pq
        if self.compressed and pq is not None:
            out["pq"] = {
                "segments": pq.segments,
                "centroids": pq.centroids,
                "rotation": bool(pq.rotation),  # the configured name, as the reference reads it
                "rescore": bool(self.config.pq.rescore and self._rescore_dev is not None),
                # the reference's host code type, named as it names it
                "code_dtype": str(np.uint8 if pq.centroids <= 256 else np.uint16),
                "bits": 4 if self._codes4 is not None else 8,
                # the funnel's rotated 4-bit ladder (the reference's device rotation)
                "opq": self._pq4 is not None and self._pq4.rotation_matrix is not None,
            }
            if self._codes4 is not None and self._pq4 is not None:
                rg4, rc = self._funnel_budgets(10, max(self.capacity, 1))  # k 10: the readout
                with self._pq4_lock:
                    st = dict(self._pq4_stats)
                d = max(st["dispatches"], 1)
                out["pq"]["funnel"] = {
                    "stage1_c": rg4 * 16,
                    "stage2_rescore": rc,
                    "c_cap": controller.funnel_c_cap(PQ4_FUNNEL_C_BUCKETS[-1]),
                    "rescore_cap": controller.funnel_rescore_cap(
                        PQ4_FUNNEL_RESCORE_BUCKETS[-1]),
                    "dispatches": st["dispatches"],
                    "mean_stage1_rows": round(st["stage1_rows"] / d, 1),
                    "mean_stage2_survivors": round(st["stage2_survivors"] / d, 1),
                    "mean_stage3_survivors": round(st["stage3_survivors"] / d, 1),
                }
        return out

    def search_by_vector(
        self, vector: np.ndarray, k: int, allow_list: Optional[AllowList] = None
    ) -> tuple[np.ndarray, np.ndarray]:
        ids, dists = self.search_by_vectors(np.asarray(vector)[None, :], k, allow_list)
        keep = dists[0] != np.inf
        return ids[0][keep], dists[0][keep]

    def search_by_vector_distance(
        self,
        vector: np.ndarray,
        target_distance: float,
        max_limit: int,
        allow_list: Optional[AllowList] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Iteratively double the limit until past the target distance
        (search.go:90-157), each round one batched device call."""
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

    def update_user_config(self, updated: vi.HnswUserConfig) -> None:
        """Hot config update; pq.enabled turned on compresses now
        (compress.go: "triggered by config update pq.enabled"). A failed
        compression leaves the old config in place."""
        with self._lock:
            vi.validate_config_update(self.config, updated)
            was_enabled = self.config.pq.enabled
            if (updated.pq.enabled and not was_enabled and self.dim is not None
                    and updated.pq.segments > 0 and self.dim % updated.pq.segments != 0):
                raise vi.ConfigValidationError(
                    f"pq.segments ({updated.pq.segments}) must divide vector "
                    f"dims ({self.dim})")
            prev = self.config
            self.config = updated
            if updated.pq.enabled and not was_enabled and not self.compressed:
                try:
                    self._flush_pending()
                    if self.n > 0:
                        self._compress_locked()
                except Exception:
                    self.config = prev
                    raise

    def flush(self) -> None:
        with self._lock:
            self._flush_pending()
            if self._log is not None:
                self._log.flush()

    def compact(self) -> None:
        """Condense: drop tombstoned slots and rewrite the log (condensor.go
        analog). Under PQ the rebuild re-encodes against the existing
        codebooks, 8-bit and 4-bit."""
        with self._lock:
            self._flush_pending()
            if self.n == 0:
                return
            live_slots = np.array(sorted(self._doc_to_slot.values()), dtype=np.int64)
            if live_slots.size == self.n:
                return
            t_compact0 = time.perf_counter()
            docs = self._slot_to_doc[live_slots]
            if self.compressed:
                vecs = self._host_vecs[live_slots]
            else:  # a bf16 store's rows come back upcast, as the reference's do
                rows = self._store[torch.from_numpy(live_slots).to(self.device)]
                vecs = rows.float().cpu().numpy()
            if self._log is not None:
                self._log.rewrite(docs, vecs)
            # the slot->doc mapping is rebuilt wholesale: filter caches keyed
            # on the old layout must never be served again
            self._allow_token = object()
            pq, pq4q, was_compressed = self._pq, self._pq4, self.compressed
            self.compressed = False
            self._pq = self._pq4 = None
            self._codes = self._recon_norms = None
            self._rescore_dev = self._rescore_sq_norms = None
            self._codes4 = self._recon_norms4 = None
            self._host_vecs = None
            self._blk_cache.clear()
            self.dim = None
            self.capacity = 0
            self.n = 0
            self.live = 0
            self._doc_to_slot.clear()
            self._store = self._sq_norms = self._tombs = self._s2d_dev = None
            # the partition layout indexes the old slot space: drop it; the
            # retrain after the rebuild reclusters the dense slot space
            self._ivf_reset()
            self._slot_to_doc = np.zeros(0, dtype=np.int64)
            self._host_tombs = np.zeros(0, dtype=bool)
            # suppress the declarative compress trigger for the rebuild:
            # config.pq.enabled is true for ANY compressed index, so a flush
            # would otherwise re-FIT a codebook in the middle of the rebuild
            # and change the codes the re-encode below must preserve
            prev_restoring = self._restoring
            self._restoring = True
            try:
                self._bulk_stage_add(docs, vecs)
                self._flush_pending()
            finally:
                self._restoring = prev_restoring
            if was_compressed and self.n > 0:
                self._enable_pq(pq, self._store[: self.n].float(), save=False, pq4q=pq4q)
            self._maybe_ivf_train()
            if self._published_gen != self._staged_gen:
                self._publish_snapshot()
            ms = (time.perf_counter() - t_compact0) * 1000.0
            led = memory.get_ledger()
            if led is not None:
                led.note_write("compact", "compact", ms, rows=self.live)
            incidents.emit("write_phase", scope="compact", rows=self.live, ms=round(ms, 1))

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
            self._ivf_reset()
            self._blk_cache.clear()
            self.dim = None
            self.capacity = 0
            self.n = 0
            self.live = 0
            self._slot_to_doc = np.zeros(0, dtype=np.int64)
            self._host_tombs = np.zeros(0, dtype=bool)
            with self._stage_lock:
                # parked staging buffers die with the data (a re-created
                # class may use another dim), their graphs with them
                self._stage_free.clear()
            self._graph_seen.clear()
            self._host_rows_cache = None
            self._doc_to_slot.clear()
            self._pending.clear()
            self._pending_tombs.clear()
            self.compressed = False
            self._pq = self._pq4 = None
            self._codes = self._recon_norms = None
            self._rescore_dev = self._rescore_sq_norms = None
            self._codes4 = self._recon_norms4 = None
            self._host_vecs = None
            # slots are reassigned from 0 after a drop: filter caches keyed
            # on the old layout must not match the new one
            self._allow_token = object()
            self._staged_gen += 1
            self._publish_snapshot()
            for path in (self._pq_path, self._pq4_path):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass

    def shutdown(self) -> None:
        with self._lock:
            self._flush_pending()
            if self._log is not None:
                self._log.flush()
                self._log.close()

    def list_files(self) -> list[str]:
        files = [self._log.path] if self._log is not None else []
        return files + [p for p in (self._pq_path, self._pq4_path) if os.path.exists(p)]
