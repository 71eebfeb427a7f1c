"""The GPU vector index ("hnsw_tpu" / "flat"): the port of
`weaviate_tpu/index/tpu.py`, single device, uncompressed.

The interface contract is the reference's (vector_index.go:23-40:
(vector, k, allowList) -> (ids, dists)); the device does the work in
batches:

- the shard's vectors live on the card as one padded [capacity, D] f32
  tensor, with an [capacity] f32 row-norm vector (l2), a [capacity] bool
  tombstone mask and a [capacity] int64 slot->doc column;
- a query batch of 8 rows or more runs the group-min fast scan
  (ops/gmin_scan.py, the hand-written Hopper kernel) and an exact f32
  rescore; smaller batches, `exactTopK`, and the manhattan and hamming
  metrics run the chunked exact scan (`_search_full`);
- allowLists below `flatSearchCutoff` take the gather tier: only the
  allowed rows are scored (flat_search.go:19 semantics);
- each dispatch ends in ONE device->host transfer that already carries
  final doc ids (ops/topk.translate_pack);
- reads are snapshot-isolated: writers publish an immutable IndexSnapshot
  with one reference swap, readers grab it lock-free and run the whole
  two-phase dispatch (enqueue, then finalize) on it.

Writes and snapshots. The JAX package replaces every device array on
every write. Here two kinds of write stay in place, because no published
snapshot can see what they change:
  - new rows (store, row norms, slot->doc) land only at slots >= self.n,
    and every published snapshot has n <= self.n. A snapshot masks every
    slot at or past its own n (the scan's bias and valid mask, the gather
    tier's slot list, the translation's slot indices all stay below it),
    so a row written there cannot change its answers. On the card the
    write is also ordered on the stream after every dispatch already
    enqueued.
  - the rescore-block cache is rebuilt when the store's write generation
    moves (a snapshot carries the generation it was published at).
Everything a snapshot does read changes out of place: tombstones are
cloned before a delete sets them, and growth allocates new tensors.

Durability: an append-only binary vector log per shard (add/delete
records), replayed at startup, in the JAX package's on-disk format
(magic WTVL, v2, per-record checksums), so a shard written by either
package restores in the other.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.index.interface import AllowList, VectorIndex
from weaviate_tpu_torch.ops import gmin_scan
from weaviate_tpu_torch.ops.distances import DISTANCE_FNS
from weaviate_tpu_torch.ops.topk import (bitmap_to_mask, merge_top_k,
                                         rescore_distances, smallest_k,
                                         translate_pack, unpack_fused)
from weaviate_tpu_torch.storage.bitmap import (Bitmap, allowed_mask,
                                               pack_allow_words)

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

# fast-scan candidate depth bounds of the chunked scan (the JAX package's
# RESCORE_R_BUCKETS ends)
_RESCORE_R_MIN = 32
_RESCORE_R_MAX = 128

_NO_PQ = ("the compressed (PQ) tiers are not ported yet: ROADMAP queue 1 "
          "item 7 (8-bit PQ) and item 8 (4-bit funnel)")
_NO_IVF = "the IVF scan plane is not ported yet: ROADMAP queue 1 item 9"


def _ivf_requested(n: int) -> bool:
    """True when IVF_ENABLED asks for the IVF plane and the shard is large
    enough that the JAX package would route this dispatch to it."""
    on = os.environ.get("IVF_ENABLED", "").strip().lower() in ("true", "enabled", "on", "1")
    return on and n >= int(os.environ.get("IVF_MIN_N", "") or 20000)


def _bucket_b(b: int) -> int:
    for s in _B_BUCKETS:
        if b <= s:
            return s
    return ((b + 1023) // 1024) * 1024


def _grow(t: torch.Tensor, new_cap: int, fill) -> torch.Tensor:
    """A new [new_cap, ...] tensor holding t's rows then `fill`: growth
    never touches the tensor a published snapshot holds."""
    out = torch.full((new_cap, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    out[: t.shape[0]] = t
    return out


def _search_full(store, sq_norms, tombs, n, q, allow_words, k, metric, use_allow,
                 active_chunks=None, rescore_r=0):
    """Full-store masked kNN: a loop over store chunks, each one [B, chunk]
    distance block and a per-chunk top-k, merged exactly.

    rescore_r > 0 keeps the top max(k, rescore_r) candidates of the scan
    and rescores them exactly in f32 before the final top-k (the JAX
    package's fast-scan-then-rescore shape; here the scan itself is
    already full f32). Candidates whose scan distance was +inf (dead
    slots) stay +inf through the rescore. -> ([B, k] dists, [B, k] slot
    idx int32, -1 for missing)."""
    cap, _ = store.shape
    chunk = min(cap, _SCAN_CHUNK)
    nchunks = cap // chunk
    if active_chunks is not None:
        nchunks = max(1, min(nchunks, active_chunks))
    b = q.shape[0]
    dev = store.device
    kk = max(k, rescore_r) if rescore_r else k
    top = torch.full((b, kk), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, kk), -1, dtype=torch.int64, device=dev)
    lane = torch.arange(chunk, device=dev)
    for ci in range(nchunks):
        base = ci * chunk
        valid = (lane + base < n) & ~tombs[base: base + chunk]
        if use_allow:
            valid = valid & bitmap_to_mask(allow_words[base // 32: (base + chunk) // 32], chunk)
        norms = sq_norms[base: base + chunk] if sq_norms is not None else None
        d = DISTANCE_FNS[metric](q, store[base: base + chunk], norms)
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


def _search_gathered(store, q, rows, tombs, k, metric):
    """Gather tier (flat_search.go:19 analog): score only the allowList's
    rows. rows [R] int64 store slots; the dispatching snapshot's tombs
    mask them on the device. -> ([B, k] dists, [B, k] positions into
    rows, -1 for missing)."""
    sub = store[rows]
    dists = DISTANCE_FNS[metric](q, sub, None)
    live = ~tombs[rows]
    masked = torch.where(live[None, :], dists, float("inf"))
    top, idx = smallest_k(masked, k)
    return top, torch.where(torch.isinf(top), -1, idx)


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

    def append_add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        """Vectorized bulk append: one write() for the whole batch, with the
        per-record checksums computed as two numpy row-sums."""
        n, dim = vectors.shape
        rec_len = 17 + 4 * dim
        buf = np.zeros((n, rec_len), np.uint8)
        buf[:, 0] = _LOG_ADD
        buf[:, 1:9] = doc_ids.astype("<u8").view(np.uint8).reshape(n, 8)
        buf[:, 9:13] = np.frombuffer(struct.pack("<I", dim), np.uint8)
        buf[:, 17:] = np.ascontiguousarray(vectors, dtype="<f4").view(np.uint8).reshape(n, 4 * dim)
        sums = buf[:, :13].sum(axis=1, dtype=np.uint64) + buf[:, 17:].sum(axis=1, dtype=np.uint64)
        buf[:, 13:17] = (sums & 0xFFFFFFFF).astype("<u4").view(np.uint8).reshape(n, 4)
        self._f.write(buf.tobytes())

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

    def rewrite(self, entries) -> None:
        """Condense: atomically rewrite the log with only live entries."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_LOG_MAGIC + struct.pack("<H", _LOG_VERSION))
            for doc_id, vec in entries:
                v = np.ascontiguousarray(vec, dtype=np.float32)
                f.write(self._enc_add(doc_id, v))
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
    a snapshot reads."""

    __slots__ = ("gen", "dim", "capacity", "n", "live", "store", "sq_norms",
                 "tombs", "slot_to_doc", "slot_to_doc_dev", "host_tombs",
                 "allow_token", "store_gen")

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


class GpuVectorIndex(VectorIndex):
    def __init__(
        self,
        config: vi.HnswUserConfig,
        shard_path: str,
        shard_name: str = "",
        device=None,
        persist: bool = True,
    ):
        if config.pq.enabled:
            raise NotImplementedError(_NO_PQ)
        self.config = config
        self.metric = config.distance
        self.shard_path = shard_path
        self.shard_name = shard_name
        self.device = resolve_device(device)
        self._lock = threading.RLock()

        self.dim: Optional[int] = None
        self.capacity = 0
        self.n = 0  # high-water slot count (includes tombstoned slots)
        self.live = 0
        self._store: Optional[torch.Tensor] = None     # [capacity, D] f32
        self._sq_norms: Optional[torch.Tensor] = None  # [capacity] f32 (l2)
        self._tombs: Optional[torch.Tensor] = None     # [capacity] bool
        self._s2d_dev: Optional[torch.Tensor] = None   # [capacity] int64, -1 unwritten
        self._store_gen = 0  # bumped by every in-place store write
        self._slot_to_doc = np.zeros(0, dtype=np.int64)
        self._host_tombs = np.zeros(0, dtype=bool)
        self._doc_to_slot: dict[int, int] = {}
        self._snap: Optional[IndexSnapshot] = None
        self._snap_gen = 0
        self._staged_gen = 0
        self._published_gen = -1
        # staging buffer keyed by doc_id: a re-add of a staged doc replaces it
        self._pending: dict[int, np.ndarray] = {}
        self._pending_tombs: list[int] = []
        # identity token for the per-allowList filter caches
        self._allow_token = object()
        # (store tensor, store generation, [ncols, G*D] rescore blocks)
        self._blk_cache: Optional[tuple] = None
        self._log = VectorLog(os.path.join(shard_path, "vector.log")) if persist else None
        if self._log is not None:
            self._restore()

    # -- lifecycle -----------------------------------------------------------

    def _restore(self) -> None:
        """Replay the vector log (startup.go:56 restoreFromDisk analog)."""
        replay_stats: dict = {}
        for op, ids, vecs in VectorLog.replay_batches(self._log.path, stats=replay_stats):
            if op == "add":
                self._bulk_stage_add(ids, vecs)
            else:
                self._stage_delete(int(ids), log=False)
        VectorLog.report_replay_stats(self._log.path, replay_stats)

    def post_startup(self) -> None:
        with self._lock:
            self._flush_pending()

    # -- device plumbing -----------------------------------------------------

    def _init_device(self, dim: int) -> None:
        self.dim = dim
        self.capacity = _MIN_CAPACITY
        dev = self.device
        self._store = torch.zeros((self.capacity, dim), dtype=torch.float32, device=dev)
        self._sq_norms = torch.zeros(self.capacity, dtype=torch.float32, device=dev)
        self._tombs = torch.zeros(self.capacity, dtype=torch.bool, device=dev)
        self._s2d_dev = torch.full((self.capacity,), -1, dtype=torch.int64, device=dev)
        self._slot_to_doc = np.full(self.capacity, -1, dtype=np.int64)
        self._host_tombs = np.zeros(self.capacity, dtype=bool)

    def _ensure_capacity(self, needed: int) -> None:
        if self._store is None:
            raise RuntimeError("store not initialised")
        cap = self.capacity
        while cap < needed:
            cap *= 2  # geometric growth (maintainance.go:31)
        if cap == self.capacity:
            return
        self._store = _grow(self._store, cap, 0.0)
        self._sq_norms = _grow(self._sq_norms, cap, 0.0)
        self._tombs = _grow(self._tombs, cap, False)
        self._s2d_dev = _grow(self._s2d_dev, cap, -1)
        self._store_gen += 1
        s2d = np.full(cap, -1, dtype=np.int64)
        s2d[: self.capacity] = self._slot_to_doc
        self._slot_to_doc = s2d
        ht = np.zeros(cap, dtype=bool)
        ht[: self.capacity] = self._host_tombs
        self._host_tombs = ht
        self.capacity = cap

    def _write_block(self, rows: np.ndarray, start: int) -> None:
        """Land [count, D] f32 rows at slots [start, start+count), in
        _CHUNK-row steps that grow the store as the JAX package's padded
        chunk writes do (so both packages reach the same capacity). The
        copy is in place: every slot written is >= self.n (module
        docstring). Row norms are summed in f64 and rounded to f32, as the
        JAX package does on the host."""
        count = rows.shape[0]
        off = 0
        while off < count:
            take = min(_CHUNK, count - off)
            self._ensure_capacity(start + off + _CHUNK)
            chunk = torch.from_numpy(np.ascontiguousarray(rows[off: off + take])).to(self.device)
            lo, hi = start + off, start + off + take
            self._store[lo:hi] = chunk
            if self.metric == vi.DISTANCE_L2:
                self._sq_norms[lo:hi] = (chunk.double() ** 2).sum(1).float()
            off += take
        self._store_gen += 1

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
                if log and self._log is not None:
                    self._log.append_delete(doc_id)
            return
        self._pending_tombs.append(slot)
        self.live -= 1
        self._staged_gen += 1
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
        if flushed:
            self._cow_host_state()
        if self._pending:
            rows = np.stack(list(self._pending.values()))
            docs = np.array(list(self._pending.keys()), dtype=np.int64)
            count = rows.shape[0]
            self._ensure_capacity(self.n + count)
            self._write_block(rows, self.n)
            self._assign_slots(docs, self.n)
            self.n += count
            self._pending.clear()
        self._apply_pending_tombs()
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

    # -- snapshot publication / lock-free reads ------------------------------

    def _publish_snapshot(self) -> None:
        """Publish the current device state as a new immutable snapshot
        (one reference swap; callers hold self._lock)."""
        self._snap_gen += 1
        self._snap = IndexSnapshot(self._snap_gen, self)
        self._published_gen = self._staged_gen

    def _read_snapshot(self) -> IndexSnapshot:
        """The snapshot a search dispatches on: lock-free when nothing is
        staged; otherwise take the write lock once, flush and publish (the
        read-your-writes check, paid by the first read after a write)."""
        snap = self._snap
        if snap is not None and self._published_gen == self._staged_gen:
            return snap
        with self._lock:
            self._flush_pending()
            if self._snap is None or self._published_gen != self._staged_gen:
                self._publish_snapshot()
            return self._snap

    def load_state(self, state) -> None:
        """Install device state carried over from another index (see
        weaviate_tpu_torch.state.state_from_arrays) into this empty index
        and publish it. A persistent index rewrites its vector log with the
        live rows, so a restart restores the same answers."""
        with self._lock:
            if self.n or self._pending or self._pending_tombs:
                raise ValueError("load_state needs an empty index")
            cap, n, dim = int(state.capacity), int(state.n), int(state.dim)
            if cap < _MIN_CAPACITY or cap & (cap - 1) or not 0 <= n <= cap:
                raise ValueError(f"bad carried state: capacity {cap}, n {n}")
            if tuple(state.store.shape) != (cap, dim):
                raise ValueError(f"store shape {tuple(state.store.shape)} != {(cap, dim)}")
            dev = self.device
            self.dim, self.capacity, self.n = dim, cap, n
            self._store = state.store.to(dev, torch.float32).contiguous()
            self._sq_norms = state.sq_norms.to(dev, torch.float32).contiguous()
            self._tombs = state.tombs.to(dev, torch.bool).contiguous()
            self._slot_to_doc = np.array(state.slot_to_doc, dtype=np.int64)
            self._s2d_dev = torch.from_numpy(self._slot_to_doc.copy()).to(dev)
            self._host_tombs = self._tombs.cpu().numpy().copy()
            live = np.flatnonzero(~self._host_tombs[:n] & (self._slot_to_doc[:n] >= 0))
            self._doc_to_slot = dict(zip(self._slot_to_doc[live].tolist(), live.tolist()))
            self.live = len(self._doc_to_slot)
            self._store_gen += 1
            self._allow_token = object()
            if self._log is not None:
                rows = self._store[torch.from_numpy(live).to(dev)].cpu().numpy()
                self._log.rewrite(zip(self._slot_to_doc[live].tolist(), rows))
            self._staged_gen += 1
            self._publish_snapshot()

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
                self._log.append_add_batch(doc_arr, vectors)
            count = vectors.shape[0]
            self._staged_gen += 1
            self._ensure_capacity(self.n + count + _CHUNK)
            self._cow_host_state()
            self._write_block(vectors, self.n)
            self._assign_slots(doc_arr, self.n)
            self.n += count
            self.live += count
            # deletes staged before this batch land in the same snapshot
            # (the JAX package's add_batch publishes without them)
            self._apply_pending_tombs()
            self._publish_snapshot()

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
        rows take the chunked exact scan."""
        if self.config.exact_topk:
            return False
        if self.metric not in vi.MATMUL_DISTANCES:
            return False
        if snap.capacity < _MIN_CAPACITY or b < 8:
            return False
        return self._gmin_rg(k, snap.capacity) > 0

    def _rescore_r(self, k: int, n: int) -> int:
        """Chunked-scan candidate depth for the exact rescore: 4k clamped
        to [32, 128]; 0 (no rescore) for exactTopK, the non-matmul metrics,
        or when the depth would leave no slack over k."""
        if self.config.exact_topk or self.metric not in vi.MATMUL_DISTANCES:
            return 0
        r = int(min(max(4 * k, _RESCORE_R_MIN), _RESCORE_R_MAX, max(n, 1)))
        return r if r >= 2 * k else 0

    def _gen_blocks(self, snap: IndexSnapshot) -> torch.Tensor:
        """The [ncols, G*D] rescore-block layout of snap's store, rebuilt
        when the store tensor or its write generation changes. Concurrent
        readers may race here; a lost race only recomputes the layout."""
        hit = self._blk_cache
        if hit is not None and hit[0] is snap.store and hit[1] == snap.store_gen:
            return hit[2]
        self._blk_cache = None  # free the old layout before building the new
        blk = gmin_scan.build_rescore_blocks(snap.store)
        self._blk_cache = (snap.store, snap.store_gen, blk)
        return blk

    def _prep_queries(self, vectors: np.ndarray) -> tuple[np.ndarray, int]:
        """Query prep: f32 cast, cosine normalization and bucket padding
        (the JAX package's _prep_queries_staged, without its buffer pool).
        -> (padded [bb, D] f32, actual rows)."""
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        buf = np.zeros((_bucket_b(b), q.shape[1]), np.float32)
        buf[:b] = q
        if self.metric == vi.DISTANCE_COSINE:
            norms = np.linalg.norm(buf[:b], axis=1, keepdims=True)
            norms[norms == 0] = 1.0
            buf[:b] /= norms
        return buf, b

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
        lock."""
        if snap.n == 0 or snap.live == 0:
            b = 1 if np.asarray(vectors).ndim == 1 else len(vectors)
            empty = (np.zeros((b, 0), dtype=np.uint64), np.zeros((b, 0), dtype=np.float32))
            return lambda: empty
        if self.config.pq.enabled:
            raise NotImplementedError(_NO_PQ)
        if _ivf_requested(snap.n):
            raise NotImplementedError(_NO_IVF)
        q_host, b = self._prep_queries(vectors)
        if q_host.shape[1] != snap.dim:
            raise ValueError(f"dim mismatch: index has {snap.dim}, got {q_host.shape[1]}")
        q = torch.from_numpy(q_host).to(self.device)
        k_eff = min(k, snap.live)
        if allow_list is not None and len(allow_list) < self.config.flat_search_cutoff:
            return self._dispatch_small_allow(snap, q, b, k_eff, allow_list)
        allow_words = (self._allow_words(snap, allow_list)
                       if allow_list is not None else None)
        return self._dispatch_scan(snap, q, b, k_eff, allow_words)

    def _dispatch_scan(self, snap: IndexSnapshot, q: torch.Tensor, b: int,
                       k_eff: int, allow_words):
        """Full-store scan: the group-min fast scan when `_use_gmin` allows
        it, the chunked exact scan otherwise; the slot->doc translation
        runs on the device in both."""
        kk = min(max(k_eff, 1), snap.n)
        use_allow = allow_words is not None
        if self._use_gmin(snap, q.shape[0], kk):
            ncols = snap.capacity // gmin_scan.G
            packed = gmin_scan.search_gmin_fused(
                snap.store, snap.sq_norms, snap.tombs, snap.n, q, allow_words,
                snap.slot_to_doc_dev, use_allow, kk, self.metric,
                self._gmin_rg(kk, snap.capacity),
                active_g=-(-snap.n // ncols),  # live store slices only
                rescore_blk=self._gen_blocks(snap))
        else:
            top, idx = _search_full(
                snap.store, snap.sq_norms if self.metric == vi.DISTANCE_L2 else None,
                snap.tombs, snap.n, q, allow_words, kk, self.metric, use_allow,
                -(-snap.n // _SCAN_CHUNK),
                self._rescore_r(kk, snap.n))
            packed = translate_pack(top, idx, snap.slot_to_doc_dev)
        return self._finalize_fused(packed, b)

    @staticmethod
    def _finalize_fused(packed: torch.Tensor, b: int):
        """finalize() of a dispatch: the ONE blocking device->host transfer
        already carries final doc ids; the host half is dtype views."""
        def finalize():
            ids, dists = unpack_fused(packed.cpu().numpy())
            return ids[:b], dists[:b]

        return finalize

    def _dispatch_small_allow(self, snap: IndexSnapshot, q: torch.Tensor,
                              b: int, k: int, allow_list: AllowList):
        """Gather tier (flatSearch over the allowList, flat_search.go:19)."""
        empty = (np.zeros((b, 0), np.uint64), np.zeros((b, 0), np.float32))
        slots = self._allow_slots(snap, allow_list)
        # nothing can match in THIS snapshot: no device work at all
        if slots.size == 0 or not np.any(~snap.host_tombs[slots]):
            return lambda: empty
        rows = torch.from_numpy(slots).to(self.device)
        top, pos = _search_gathered(snap.store, q, rows, snap.tombs,
                                    min(k, slots.size), self.metric)
        slot_idx = torch.where(pos >= 0, rows[torch.clamp(pos, min=0)], -1)
        return self._finalize_fused(translate_pack(top, slot_idx, snap.slot_to_doc_dev), b)

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
        with self._lock:
            vi.validate_config_update(self.config, updated)
            if updated.pq.enabled:
                raise NotImplementedError(_NO_PQ)
            self.config = updated

    def flush(self) -> None:
        with self._lock:
            self._flush_pending()
            if self._log is not None:
                self._log.flush()

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
            self._blk_cache = None
            self.dim = None
            self.capacity = 0
            self.n = 0
            self.live = 0
            self._slot_to_doc = np.zeros(0, dtype=np.int64)
            self._host_tombs = np.zeros(0, dtype=bool)
            self._doc_to_slot.clear()
            self._pending.clear()
            self._pending_tombs.clear()
            # slots are reassigned from 0 after a drop: filter caches keyed
            # on the old layout must not match the new one
            self._allow_token = object()
            self._staged_gen += 1
            self._publish_snapshot()

    def shutdown(self) -> None:
        with self._lock:
            self._flush_pending()
            if self._log is not None:
                self._log.flush()
                self._log.close()

    def list_files(self) -> list[str]:
        return [self._log.path] if self._log is not None else []
