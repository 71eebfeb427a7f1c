"""Device BM25 engine: dense impact rows + one top-k per query (twin of
`weaviate_tpu/inverted/bm25_device.py`).

The keyword half of hybrid search, on the same device as the vector half
(the shard's). It produces the host MaxScore engine's ranking
(inverted/bm25.py) and hands a query to the host engine only where the
host path is the right one, as the reference does:

- additional_explanations (the per-term breakdown needs the postings),
- empty or unknown terms, non-positive property boosts, or fewer postings
  than DEVICE_MIN_POSTINGS.

The reference also falls back when no jax backend comes up; the port has
no such probe: the engine runs on the device it was given, and a card
fault raises.

Dense rows are cached per (property, term, weight) under the shard write
generation, with the reference's mid-write guard (a row built while the
generation moved is not cached); allowLists ride along as a dense bool
mask cached per (filter identity, generation).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.index.interface import AllowList
from weaviate_tpu_torch.inverted.bm25 import BM25Searcher
from weaviate_tpu_torch.monitoring import costmodel
from weaviate_tpu_torch.ops import bm25_scan
from weaviate_tpu_torch.ops import topk as topk_ops

# below this many total postings the host engine serves the query
DEVICE_MIN_POSTINGS = 0  # 0 = always the device when eligible

# device bytes pinned for dense rows (a row is n_pad * 4 bytes: ~4 MB per
# cached term at 1M docs). A batch sweep whose distinct-term working set
# passes this rebuilds its rows on every sweep; heavy keyword fleets raise
# it with WEAVIATE_TPU_BM25_ROW_CACHE_MB.
try:
    _ROW_CACHE_MAX_BYTES = int(
        os.environ.get("WEAVIATE_TPU_BM25_ROW_CACHE_MB") or 512
    ) * 1024 * 1024
except ValueError:  # a malformed value must not take the server down
    _ROW_CACHE_MAX_BYTES = 512 * 1024 * 1024

# transient device bytes one batched product may stack ([U_pad, n_pad]
# f32); a batch whose distinct units would pass it runs in slices
_BATCH_STACK_MAX_BYTES = 256 * 1024 * 1024


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceBM25:
    """Wraps a host BM25Searcher; owns the device row and mask caches."""

    def __init__(self, searcher: BM25Searcher, gen_fn=None, device=None):
        self.searcher = searcher
        self.device = resolve_device(device)
        self._gen_fn = gen_fn if gen_fn is not None else searcher._gen_fn
        # (prop, term, weight) -> (gen, n_pad, device row [n_pad] f32)
        self._rows: OrderedDict[tuple, tuple] = OrderedDict()
        self._row_bytes = 0
        # id(bitmap) -> (gen, n_pad, device mask, pinned bitmap)
        self._masks: dict[int, tuple] = {}
        self._npad_hwm: Optional[tuple] = None  # (gen, n_pad floor)
        # readers share one engine per shard: evictions and the byte
        # accounting run under this lock
        self._cache_lock = threading.RLock()
        # the last search_batch dispatch's cost-model shape
        self.last_batch_shape: Optional[costmodel.DispatchShape] = None

    # -- plumbing ------------------------------------------------------------

    def _gen(self):
        return self._gen_fn() if self._gen_fn is not None else None

    def _npad(self, max_id: int, gen) -> int:
        """Dense-row length for this request: the bucket of max_id, never
        below the generation's high-water mark (queries alternating
        between low-id and high-id terms would otherwise rebuild each
        other's rows)."""
        want = bm25_scan.n_bucket(max_id)
        with self._cache_lock:
            cur = self._npad_hwm
            if cur is not None and cur[0] == gen:
                want = max(want, cur[1])
                self._npad_hwm = (gen, want)
            elif cur is None or self._gen() == gen:
                # only the live generation may reset the floor
                self._npad_hwm = (gen, want)
        return want

    def _evict_dead(self) -> None:
        """Drop rows and masks of generations no longer live (compared
        against the generation read now, never a caller's older one)."""
        live = self._gen()
        with self._cache_lock:
            dead = [k for k, v in self._rows.items() if v[0] != live]
            for k in dead:
                entry = self._rows.pop(k, None)
                if entry is not None:
                    self._row_bytes -= _nbytes(entry[2])
            self._masks = {k: v for k, v in self._masks.items() if v[0] == live}

    # -- dense row cache -----------------------------------------------------

    def _dense_row(self, unit, n_pad: int, gen) -> torch.Tensor:
        """Scaled dense impact row of one scoring unit, built on the device
        and cached under the write generation."""
        key = (unit.prop, unit.term, unit.weight)
        with self._cache_lock:
            hit = self._rows.get(key)
            if hit is not None and hit[0] == gen and hit[1] == n_pad:
                self._rows.move_to_end(key)
                return hit[2]
        # per-posting scores on the host (f64, one pass); built outside the
        # lock: two threads may build one row twice, the last write wins
        scores = unit._score(unit.ids, unit.tf).astype(np.float32)
        ids = unit.ids.astype(np.int64)
        ids = np.where(ids < n_pad, ids, n_pad)
        ids, scores = bm25_scan.pad_postings(ids, scores, n_pad)
        row = bm25_scan.build_dense_row(torch.from_numpy(ids).to(self.device),
                                        torch.from_numpy(scores).to(self.device), n_pad)
        if gen is not None and self._gen() == gen:
            with self._cache_lock:
                old = self._rows.pop(key, None)
                if old is not None:
                    self._row_bytes -= _nbytes(old[2])
                self._rows[key] = (gen, n_pad, row)
                self._row_bytes += _nbytes(row)
                while self._row_bytes > _ROW_CACHE_MAX_BYTES and len(self._rows) > 1:
                    _, (_, _, e) = self._rows.popitem(last=False)
                    self._row_bytes -= _nbytes(e)
        return row

    def _allow_mask(self, allow_list: AllowList, n_pad: int, gen) -> torch.Tensor:
        # keyed by the Bitmap's identity with the Bitmap pinned in the
        # entry, so a recycled id can never alias another filter's mask
        key = id(allow_list)
        with self._cache_lock:
            hit = self._masks.get(key)
            if hit is not None and hit[0] == gen and hit[1] == n_pad and hit[3] is allow_list:
                return hit[2]
        host = np.zeros((n_pad,), dtype=bool)
        ids = allow_list.to_array().astype(np.int64)
        host[ids[ids < n_pad]] = True
        mask = torch.from_numpy(host).to(self.device)
        if gen is not None and self._gen() == gen:
            with self._cache_lock:
                if len(self._masks) >= 16:
                    self._masks.pop(next(iter(self._masks)), None)
                self._masks[key] = (gen, n_pad, mask, allow_list)
        return mask

    # -- search --------------------------------------------------------------

    def search(
        self,
        query: str,
        limit: int,
        properties: Optional[Sequence[str]] = None,
        allow_list: Optional[AllowList] = None,
        additional_explanations: bool = False,
    ) -> list[tuple[int, float, Optional[dict]]]:
        """BM25Searcher.search's contract. Explanations, non-positive
        boosts and small postings go to the host engine."""
        if additional_explanations or limit <= 0:
            return self.searcher.search(
                query, limit, properties=properties, allow_list=allow_list,
                additional_explanations=additional_explanations)
        s = self.searcher
        props = s._searchable_props(properties)
        if any(w <= 0 for _, w in props):
            # non-positive boosts break the score-0-means-empty floor
            return s.search(query, limit, properties=properties, allow_list=allow_list)
        # the generation before the count and the units: the row cache's
        # guard re-reads it after the build, so the window spans all idf
        # depends on
        gen = self._gen()
        n_docs = max(s._doc_count(), 1)
        units = s._build_units(query, props, n_docs)
        if not units:
            return []
        if sum(u.ids.size for u in units) < DEVICE_MIN_POSTINGS:
            return s.search(query, limit, properties=properties, allow_list=allow_list)
        max_id = max(int(u.ids[-1]) for u in units)  # ids are doc-sorted
        n_pad = self._npad(max_id, gen)
        self._evict_dead()
        total = self._dense_row(units[0], n_pad, gen)
        for u in units[1:]:
            total = bm25_scan.add_rows(total, self._dense_row(u, n_pad, gen))
        mask = self._allow_mask(allow_list, n_pad, gen) if allow_list is not None else None
        k = min(bm25_scan.k_bucket(limit), n_pad)
        packed = bm25_scan.dense_topk(total, k, mask)
        scores, ids = bm25_scan.unpack_topk(packed.cpu().numpy(), k)  # the one fetch
        scores, ids = scores[:limit], ids[:limit]
        keep = ids >= 0
        return [(int(d), float(v), None) for d, v in zip(ids[keep], scores[keep])]

    def search_batch(
        self,
        queries: Sequence[str],
        limit: int,
        properties: Optional[Sequence[str]] = None,
    ) -> Optional[list[list[tuple[int, float, None]]]]:
        """Q plain keyword queries in one product and one fetch per slice:
        the distinct units' rows stacked [U, n], a host [Q, U] selection
        matrix, and batch_topk. None sends the batch to per-query scoring
        (non-positive boosts). No allowList or explanations: those keep a
        query out of the batch lane (usecases/traverser.py)."""
        self.last_batch_shape = None
        if limit <= 0:
            return [[] for _ in queries]
        s = self.searcher
        props = s._searchable_props(properties)
        if any(w <= 0 for _, w in props):
            return None
        gen = self._gen()  # before _doc_count, as in search()
        n_docs = max(s._doc_count(), 1)
        per_query_units = [s._build_units(q, props, n_docs) for q in queries]
        all_units = [u for units in per_query_units for u in units]
        if not all_units:
            return [[] for _ in queries]
        max_id = max(int(u.ids[-1]) for u in all_units)
        n_pad = self._npad(max_id, gen)
        self._evict_dead()
        # greedy slices whose distinct units fit _BATCH_STACK_MAX_BYTES
        max_units = max(int(_BATCH_STACK_MAX_BYTES // (n_pad * 4)),
                        max(len(u) for u in per_query_units), 1)
        out: list[list[tuple[int, float, None]]] = []
        stats = {"q": len(queries), "u": 0, "n_pad": n_pad, "slices": 0, "qu": 0}
        qi = 0
        while qi < len(queries):
            ukeys: dict[tuple, object] = {}
            slice_units: list = []
            j = qi
            while j < len(queries):
                units = per_query_units[j]
                new = {(u.prop, u.term, u.weight): u for u in units
                       if (u.prop, u.term, u.weight) not in ukeys}
                if ukeys and len(ukeys) + len(new) > max_units:
                    break
                ukeys.update(new)
                slice_units.append(units)
                j += 1
            out.extend(self._matmul_slice(slice_units, ukeys, n_pad, gen, limit))
            stats["u"] += len(ukeys)
            stats["qu"] += len(slice_units) * len(ukeys)
            stats["slices"] += 1
            qi = j
        # flops = 2 * n_pad * sum(q_slice * u_slice)
        self.last_batch_shape = costmodel.DispatchShape(
            costmodel.TIER_BM25_MATMUL, n=stats["n_pad"],
            dim=stats["qu"] / max(stats["q"], 1), batch=stats["q"],
            bytes_per_row=stats["u"] * 4, k=int(limit), extra=stats)
        return out

    @property
    def last_batch_stats(self) -> Optional[dict]:
        """Flat dict view of the last batch dispatch's shape."""
        s = self.last_batch_shape
        return None if s is None else s.describe()

    def _matmul_slice(self, per_query_units, ukeys, n_pad, gen, limit):
        """One batch_topk product and one fetch for a slice of queries."""
        if not ukeys:
            return [[] for _ in per_query_units]
        rows = [self._dense_row(u, n_pad, gen) for u in ukeys.values()]
        u_pad = bm25_scan.k_bucket(len(rows))
        if u_pad > len(rows):
            zero = torch.zeros((n_pad,), dtype=torch.float32, device=self.device)
            rows.extend([zero] * (u_pad - len(rows)))
        upos = {key: i for i, key in enumerate(ukeys)}
        sel = np.zeros((len(per_query_units), u_pad), dtype=np.float32)
        for qi, units in enumerate(per_query_units):
            for u in units:
                # += : a repeated property yields duplicate units, scored twice
                sel[qi, upos[(u.prop, u.term, u.weight)]] += 1.0
        k = min(bm25_scan.k_bucket(limit), n_pad)
        packed = bm25_scan.batch_topk(torch.stack(rows), torch.from_numpy(sel).to(self.device),
                                      k)
        scores_all, ids_all = topk_ops.unpack_topk(packed.cpu().numpy())  # the slice's one fetch
        out: list[list[tuple[int, float, None]]] = []
        for qi in range(len(per_query_units)):
            scores, ids = scores_all[qi][:limit], ids_all[qi][:limit]
            keep = ids >= 0
            out.append([(int(d), float(v), None) for d, v in zip(ids[keep], scores[keep])])
        return out
