"""Partition-pruned (IVF) scan plane: clustered layout and probed search
(twin of `weaviate_tpu/ops/ivf.py`).

HOST half (write path, under the index write lock), numpy, copied from
the reference so both packages build bit-identical layouts from the same
rows:
  - `kmeans_fit`: Lloyd's k-means over a bounded training sample ->
    [nlist, D] f32 centroids (k-means++ seeded up to 1024 centroids);
  - `assign_partitions` / `balanced_assign`: nearest-centroid partition
    of every row, the balanced form capping every partition at `cap`;
  - `pca_fit`: the low-dimensional prefilter projection;
  - `build_buckets`: assignments -> padded partition buckets [nlist,
    cap_p] int32 (-1 padding).

DEVICE half (read path), plain torch ops on the index's device: a probe
(one [B, nlist] f32 product and an exact top_p), gathers of the probed
buckets' slots and rows, the flat tiers' masking (capacity, the
snapshot's own tombstones, the packed allowList words), an optional PCA
prefilter, and full-fidelity scoring of the survivors through the shared
rescore core (ops/topk.rescore_distances), merged exactly across steps
with ops/topk.merge_top_k. No hand-written kernel runs here: the
reference's programs are XLA, not Pallas.

Port notes:
  - selection is an exact `torch.topk` everywhere (the reference uses
    `approx_min_k` outside exactTopK, which JAX's CPU backend computes
    exactly), so the query blocking and the probes per step (`gp`) only
    bound memory and never change an answer;
  - the reference scores the whole batch per step; the port also blocks
    the queries (`qb` rows), so one step's [qb, gp * cap_p, D] gather
    stays under a byte budget (`plan_steps`);
  - the reference's out-of-range "fill" gather becomes one all -1
    bucket row appended per dispatch.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops.distances import require_full_f32
from weaviate_tpu_torch.ops.pq_gmin import reconstruct
from weaviate_tpu_torch.ops.topk import (bitmap_to_mask, merge_top_k, pack_topk,
                                         rescore_distances, retranslate_packed, smallest_k)

INF = float("inf")

# metrics the IVF plane serves (matmul probe + rescore forms); manhattan
# and hamming keep the flat streamed scan
MATMUL_METRICS = (vi.DISTANCE_L2, vi.DISTANCE_DOT, vi.DISTANCE_COSINE)

# rows per assignment chunk: bounds the [chunk, nlist] host distance block
_ASSIGN_CHUNK = 65536

# bytes of one step's candidate gather ([qb, gp * cap_p, D] f32): the
# port's bound on the largest intermediate of a step (its elementwise
# rescore holds about three such blocks at once)
STEP_BYTES = 512 << 20


# -- host half: training / assignment / layout --------------------------------


def _kpp_init(rows: np.ndarray, nlist: int, rng) -> np.ndarray:
    """k-means++ seeding (D^2 sampling): spreads the initial centroids
    over the data's density, which keeps partition fills even."""
    n = rows.shape[0]
    cent = np.empty((nlist, rows.shape[1]), np.float32)
    cent[0] = rows[int(rng.integers(n))]
    d2 = ((rows - cent[0]) ** 2).sum(1)
    for i in range(1, nlist):
        total = float(d2.sum())
        if total <= 0:
            cent[i:] = rows[rng.choice(n, size=nlist - i)]
            break
        cent[i] = rows[int(rng.choice(n, p=d2 / total))]
        d2 = np.minimum(d2, ((rows - cent[i]) ** 2).sum(1))
    return cent


def kmeans_fit(rows: np.ndarray, nlist: int, iters: int = 6,
               seed: int = 0, sample: int = 0) -> np.ndarray:
    """Lloyd's k-means on (a sample of) ``rows`` -> [nlist, D] f32
    centroids. Deterministic for a given seed; empty clusters are
    re-seeded from the rows farthest from their centroid. Seeding is
    k-means++ up to 1024 centroids, distinct random rows past that."""
    rows = np.asarray(rows, np.float32)
    n = rows.shape[0]
    nlist = max(1, min(int(nlist), n))
    rng = np.random.default_rng(seed)
    if sample and n > sample:
        rows = rows[rng.choice(n, size=sample, replace=False)]
        n = rows.shape[0]
    if nlist <= 1024:
        cent = _kpp_init(rows, nlist, rng)
    else:
        cent = rows[rng.choice(n, size=nlist, replace=False)].copy()
    for _ in range(max(1, int(iters))):
        assign = assign_partitions(rows, cent)
        counts = np.bincount(assign, minlength=nlist)
        sums = np.zeros_like(cent, dtype=np.float64)  # f64 partial sums, host only
        np.add.at(sums, assign, rows)
        nonzero = counts > 0
        cent[nonzero] = (sums[nonzero]
                         / counts[nonzero, None]).astype(np.float32)
        empty = np.flatnonzero(~nonzero)
        if empty.size:
            d = rows - cent[assign]
            far = np.argsort(-np.einsum("ij,ij->i", d, d))[: empty.size]
            cent[empty] = rows[far]
    return cent


def assign_partitions(rows: np.ndarray, centroids: np.ndarray,
                      chunk: int = 0) -> np.ndarray:
    """Nearest-centroid (L2) partition of every row -> int32 [n], in row
    chunks whose [chunk, nlist] distance block stays near 64 MB."""
    rows = np.asarray(rows, np.float32)
    if chunk <= 0:
        chunk = min(_ASSIGN_CHUNK,
                    max(1024, (1 << 24) // max(centroids.shape[0], 1)))
    cn = np.einsum("ij,ij->i", centroids, centroids, dtype=np.float64
                   ).astype(np.float32)
    out = np.empty(rows.shape[0], np.int32)
    for s in range(0, rows.shape[0], chunk):
        blk = rows[s: s + chunk]
        d = cn[None, :] - 2.0 * (blk @ centroids.T)
        out[s: s + blk.shape[0]] = np.argmin(d, axis=1)
    return out


def balanced_assign(rows: np.ndarray, centroids: np.ndarray,
                    cap: int) -> np.ndarray:
    """Capacity-bounded partition assignment: nearest-centroid first, then
    every partition over ``cap`` keeps its ``cap`` closest rows and spills
    the rest to the nearest centroid with space (each spilled row walks
    its own 32 nearest partitions, then the emptiest one). Requires
    nlist * cap > n; otherwise the unbalanced assignment serves."""
    rows = np.asarray(rows, np.float32)
    assign = assign_partitions(rows, centroids)
    nlist = centroids.shape[0]
    if nlist * cap <= rows.shape[0]:
        return assign
    fills = np.bincount(assign, minlength=nlist)
    over = np.flatnonzero(fills > cap)
    if not over.size:
        return assign
    spilled = []
    for p in over:
        members = np.flatnonzero(assign == p)
        d = ((rows[members] - centroids[p]) ** 2).sum(1)
        spill = members[np.argsort(d, kind="stable")[cap:]]
        spilled.append(spill)
        assign[spill] = -1
        fills[p] = cap
    spilled = np.concatenate(spilled)
    cn = np.einsum("ij,ij->i", centroids, centroids).astype(np.float32)
    walk = min(32, nlist)
    for s in range(0, spilled.size, _ASSIGN_CHUNK // 8):
        blk = spilled[s: s + _ASSIGN_CHUNK // 8]
        d = cn[None, :] - 2.0 * (rows[blk] @ centroids.T)
        order = np.argpartition(d, walk - 1, axis=1)[:, :walk]
        order = np.take_along_axis(
            order, np.argsort(np.take_along_axis(d, order, axis=1),
                              axis=1, kind="stable"), axis=1)
        for i, r in enumerate(blk):
            for p in order[i]:
                if fills[p] < cap:
                    assign[r] = p
                    fills[p] += 1
                    break
            else:
                p = int(np.argmin(fills))
                assign[r] = p
                fills[p] += 1
    return assign


def pca_fit(rows: np.ndarray, dp: int) -> np.ndarray:
    """Top-``dp`` principal directions of ``rows`` -> [D, dp] f32
    projection (eigh of the [D, D] covariance in f64)."""
    rows = np.asarray(rows, np.float32)
    mean = rows.mean(axis=0)
    x = rows - mean
    cov = (x.T @ x) / max(x.shape[0] - 1, 1)
    _, vecs = np.linalg.eigh(cov.astype(np.float64))
    dp = max(1, min(int(dp), rows.shape[1]))
    return np.ascontiguousarray(vecs[:, ::-1][:, :dp]).astype(np.float32)


def bucket_capacity(fills: np.ndarray) -> int:
    """Padded bucket width for the given per-partition fills: the largest
    fill snapped up to a 128-row multiple, min 128."""
    top = int(fills.max()) if fills.size else 0
    return max(128, -(-top // 128) * 128)


def build_buckets(assign: np.ndarray, nlist: int,
                  cap_p: Optional[int] = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Partition assignment [n] int32 (-1 = unassigned/dead) -> (padded
    buckets [nlist, cap_p] int32 with -1 padding, fills [nlist] int64).
    ``cap_p`` pins the padding width while every bucket still fits; None
    re-derives it from the fills."""
    assign = np.asarray(assign, np.int32)
    valid = assign >= 0
    slots = np.flatnonzero(valid).astype(np.int32)
    parts = assign[slots]
    fills = np.bincount(parts, minlength=nlist).astype(np.int64)
    if cap_p is None or (fills.size and int(fills.max()) > cap_p):
        cap_p = bucket_capacity(fills)
    order = np.argsort(parts, kind="stable")
    slots = slots[order]
    parts = parts[order]
    buckets = np.full((nlist, cap_p), -1, np.int32)
    starts = np.zeros(nlist + 1, np.int64)
    np.cumsum(fills, out=starts[1:])
    col = np.arange(slots.size, dtype=np.int64) - starts[parts]
    buckets[parts, col] = slots
    return buckets, fills


def group_steps(b: int, cap_p: int, dim: int, top_p: int,
                budget_elems: int = 1 << 21) -> int:
    """Probes per scan step so one step's [B, gp*cap_p, D] gather stays
    under ``budget_elems`` elements (the reference's rule)."""
    per_probe = max(b * cap_p * dim, 1)
    return max(1, min(top_p, budget_elems // per_probe))


def plan_steps(b: int, cap_p: int, dim: int, top_p: int, second: int = 0,
               budget: int = STEP_BYTES) -> tuple[int, int, int]:
    """-> (qb query rows per block, gp probes per step, steps2 chunks of a
    second stage over `second` survivors) so that one step's [qb, gp *
    cap_p, dim] f32 gather, and one second-stage chunk's [qb, second /
    steps2, dim] one, stay under `budget` bytes. Query rows first take
    one probe each; spare room widens the step."""
    qb = max(1, min(b, budget // max(cap_p * dim * 4, 1)))
    gp = group_steps(qb, cap_p, dim, top_p, budget_elems=budget // 4)
    steps2 = 1
    if second:
        while steps2 < second and qb * -(-second // steps2) * dim * 4 > budget:
            steps2 *= 2
    return qb, gp, steps2


# -- device half: probe + candidate scoring ------------------------------------


def _probe(q: torch.Tensor, centroids: torch.Tensor, top_p: int, metric: str) -> torch.Tensor:
    """[B, D] f32 queries x [L, D] centroids -> the top_p probed partition
    ids per query [B, top_p] int64 (exact selection, f32 product)."""
    qx = q @ centroids.T
    if metric == vi.DISTANCE_L2:
        q_sq = torch.sum(q ** 2, dim=-1, keepdim=True)
        cnorms = torch.sum(centroids ** 2, dim=-1)
        d = torch.clamp(q_sq - 2.0 * qx + cnorms[None, :], min=0.0)
    elif metric == vi.DISTANCE_DOT:
        d = -qx
    else:  # cosine: centroids are train-time normalized
        d = 1.0 - qx
    return smallest_k(d, top_p)[1]


def _fill_row(buckets: torch.Tensor) -> torch.Tensor:
    """The buckets with one all -1 row appended at index nlist: the
    partition id the padded probes gather (the reference's mode="fill")."""
    pad = torch.full((1, buckets.shape[1]), -1, dtype=buckets.dtype, device=buckets.device)
    return torch.cat([buckets, pad])


def _candidate_slots(parts: torch.Tensor, buckets_ext: torch.Tensor,
                     gp: int) -> Iterator[torch.Tensor]:
    """Probed partitions [B, top_p] -> one [B, gp*cap_p] int64 slot group
    per step of ``gp`` probes (-1 = padding); the last step pads with the
    fill row's id (see _fill_row)."""
    b, top_p = parts.shape
    nlist, cap_p = buckets_ext.shape[0] - 1, buckets_ext.shape[1]
    for s in range(0, top_p, gp):
        p = parts[:, s: s + gp]
        if p.shape[1] < gp:
            p = torch.cat([p, torch.full((b, gp - p.shape[1]), nlist, dtype=p.dtype,
                                         device=p.device)], dim=1)
        yield buckets_ext[p].reshape(b, gp * cap_p).long()


def _slot_valid(slots: torch.Tensor, n, tombs: torch.Tensor,
                allow_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The flat kernels' masking, per candidate slot: capacity padding
    (slots >= n), the dispatching snapshot's own tombstones, and the
    allowList (the packed words expanded once per dispatch by
    ops/topk.bitmap_to_mask)."""
    safe = torch.clamp(slots, 0, tombs.shape[0] - 1)
    ok = (slots >= 0) & (slots < n) & ~tombs[safe]
    if allow_mask is not None:
        ok = ok & allow_mask[safe]
    return ok


def _grouped_topk(groups, score_fn, keep: int, total: int, slack: bool = True):
    """Score each (slots [B, g], valid [B, g]) group through
    ``score_fn(slots) -> [B, g] f32`` and merge the running best exactly
    across groups. The merge keeps w >= keep columns (4x keep slack, as
    the reference); with exact selection the first `keep` columns are the
    exact top-keep of every valid candidate, whatever the grouping.
    -> ([B, keep] dists, [B, keep] slots int64, -1 for missing)."""
    w = min(max(4 * keep, 32), max(total, keep)) if slack else keep
    w = max(w, keep)
    top = idx = None
    for sl, va in groups:
        d = torch.where(va, score_fn(sl), INF)
        td, pos = smallest_k(d, min(w, sl.shape[1]))
        ts = torch.where(torch.isinf(td), -1, torch.gather(sl, 1, pos))
        if top is None:
            b = sl.shape[0]
            top = torch.full((b, w), INF, dtype=torch.float32, device=sl.device)
            idx = torch.full((b, w), -1, dtype=torch.int64, device=sl.device)
        top, idx = merge_top_k(top, idx, td, ts, w)
    return top[:, :keep], idx[:, :keep]


def _regroup(slots: torch.Tensor, valid: torch.Tensor, steps: int):
    """[B, C] survivors -> `steps` column chunks of (slots, valid) for the
    second scoring stage."""
    return list(zip(torch.chunk(slots, steps, dim=1), torch.chunk(valid, steps, dim=1)))


def _prep(q, tombs, n, allow_words, use_allow, centroids, buckets, top_p, metric):
    """Per-dispatch inputs shared by every IVF tier: the f32 queries (TF32
    refused), the probed partitions, the fill-extended buckets and the
    allowList mask."""
    require_full_f32(q.device)
    qf = q.float()
    parts = _probe(qf, centroids, top_p, metric)
    allow = bitmap_to_mask(allow_words, tombs.shape[0]) if use_allow else None
    return qf, parts, _fill_row(buckets), allow


def _probed_groups(parts, buckets_ext, gp, n, tombs, allow):
    for sl in _candidate_slots(parts, buckets_ext, gp):
        yield sl, _slot_valid(sl, n, tombs, allow)


def _pca_stage(qf, parts, buckets_ext, gp, n, tombs, allow, pca_proj, pca_rows, pre_c,
               steps2, total):
    """The low-dim prefilter: rank the probed candidates by L2 in the PCA
    subspace, keep pre_c, and return them as `steps2` (slots, valid)
    groups for the full-dim pass."""
    cap = pca_rows.shape[0]
    qp = qf @ pca_proj

    def score_pca(sl):
        rows = pca_rows[torch.clamp(sl, 0, cap - 1)]
        return torch.sum((rows - qp[:, None, :]) ** 2, dim=-1)

    _, pslots = _grouped_topk(_probed_groups(parts, buckets_ext, gp, n, tombs, allow),
                              score_pca, pre_c, total, slack=False)
    return _regroup(pslots, pslots >= 0, steps2)


def _blocks(b: int, qb: Optional[int]):
    step = b if not qb else max(1, int(qb))
    return [(s, min(s + step, b)) for s in range(0, b, step)]


def _finish(tops, idxs):
    top = torch.cat(tops)
    return top, torch.where(torch.isinf(top), -1, torch.cat(idxs)).to(torch.int32)


def ivf_dense_topk(store, tombs, n, q, allow_words, centroids, buckets, pca_proj, pca_rows,
                   k, metric, use_allow, top_p, pre_c, gp, steps2, qb=None):
    """IVF search over a dense row store (the exact tier's f32/bf16 store,
    or the PQ-rescore tier's bf16 copy): probe -> gather the probed
    buckets -> optional PCA prefilter (pre_c > 0) -> exact f32 scoring of
    the survivors -> ([B, k] dists, [B, k] slot idx int32, -1 missing).
    Queries run in blocks of `qb` rows (None: one block)."""
    qf_all, parts_all, buckets_ext, allow = _prep(q, tombs, n, allow_words, use_allow,
                                                  centroids, buckets, top_p, metric)
    cap = store.shape[0]
    total = top_p * buckets.shape[1]
    tops, idxs = [], []
    for s, e in _blocks(qf_all.shape[0], qb):
        qf, parts = qf_all[s:e], parts_all[s:e]

        def score_full(sl):
            return rescore_distances(store[torch.clamp(sl, 0, cap - 1)], qf, metric)

        if pre_c:
            groups = _pca_stage(qf, parts, buckets_ext, gp, n, tombs, allow, pca_proj,
                                pca_rows, pre_c, steps2, total)
            top, idx = _grouped_topk(groups, score_full, k, pre_c)
        else:
            top, idx = _grouped_topk(_probed_groups(parts, buckets_ext, gp, n, tombs, allow),
                                     score_full, k, total)
        tops.append(top)
        idxs.append(idx)
    return _finish(tops, idxs)


def search_ivf_dense(store, tombs, n, q, allow_words, centroids, buckets, pca_proj, pca_rows,
                     k, metric, use_allow, top_p, pre_c, gp, steps2, qb=None):
    """ivf_dense_topk packed into the staged [B, 2k] int32 layout."""
    return pack_topk(*ivf_dense_topk(store, tombs, n, q, allow_words, centroids, buckets,
                                     pca_proj, pca_rows, k, metric, use_allow, top_p, pre_c,
                                     gp, steps2, qb))


def search_ivf_dense_fused(store, tombs, n, q, allow_words, centroids, buckets, pca_proj,
                           pca_rows, s2d, k, metric, use_allow, top_p, pre_c, gp, steps2,
                           qb=None):
    """search_ivf_dense with the slot->doc translation on the device -> the
    fused [B, 3k] layout (ops/topk.retranslate_packed)."""
    packed = search_ivf_dense(store, tombs, n, q, allow_words, centroids, buckets, pca_proj,
                              pca_rows, k, metric, use_allow, top_p, pre_c, gp, steps2, qb)
    return retranslate_packed(packed, s2d)


def adc_scorer(codes, norms, codebook, qr, metric):
    """score_fn(slots [B, g]) -> [B, g] asymmetric-ADC distances of the
    slots' codes: rebuild each candidate from the bf16-rounded codebook
    and take one f32 product with the bf16-rounded (rotated) query
    (products of two bf16 values are exact in f32), plus the precomputed
    ||recon||^2 for L2. qr [B, D] f32 is the rotated query."""
    cap = codes.shape[0]
    cbf = codebook.to(torch.bfloat16).float()
    qd = qr.to(torch.bfloat16).float()
    q_sq = torch.sum(qr ** 2, dim=-1, keepdim=True)

    def score(sl):
        safe = torch.clamp(sl, 0, cap - 1)
        recon = reconstruct(codes[safe], cbf)                    # [B, g, D]
        qx = torch.bmm(recon, qd[:, :, None])[..., 0]
        if metric == vi.DISTANCE_L2:
            return torch.clamp(q_sq - 2.0 * qx + norms[safe], min=0.0)
        if metric == vi.DISTANCE_DOT:
            return -qx
        return 1.0 - qx

    return score


def ivf_codes_topk(codes, recon_norms, tombs, n, q, allow_words, codebook, centroids, buckets,
                   pca_proj, pca_rows, rot, k, metric, use_allow, top_p, pre_c, gp, steps2,
                   qb=None):
    """IVF search over the codes-only PQ tier: probed candidates scored by
    the flat reconstruction scan's ADC math (adc_scorer), no rescore pass.
    codebook [M, C, ds] f32. -> ([B, k] ADC dists, [B, k] slot idx int32,
    -1 missing)."""
    qf_all, parts_all, buckets_ext, allow = _prep(q, tombs, n, allow_words, use_allow,
                                                  centroids, buckets, top_p, metric)
    qr_all = qf_all if rot is None else qf_all @ rot
    total = top_p * buckets.shape[1]
    tops, idxs = [], []
    for s, e in _blocks(qf_all.shape[0], qb):
        qf, parts = qf_all[s:e], parts_all[s:e]
        score_adc = adc_scorer(codes, recon_norms, codebook, qr_all[s:e], metric)
        if pre_c:
            groups = _pca_stage(qf, parts, buckets_ext, gp, n, tombs, allow, pca_proj,
                                pca_rows, pre_c, steps2, total)
            top, idx = _grouped_topk(groups, score_adc, k, pre_c)
        else:
            top, idx = _grouped_topk(_probed_groups(parts, buckets_ext, gp, n, tombs, allow),
                                     score_adc, k, total)
        tops.append(top)
        idxs.append(idx)
    return _finish(tops, idxs)


def search_ivf_codes(codes, recon_norms, tombs, n, q, allow_words, codebook, centroids,
                     buckets, pca_proj, pca_rows, rot, k, metric, use_allow, top_p, pre_c, gp,
                     steps2, qb=None):
    """ivf_codes_topk packed into the staged [B, 2k] int32 layout."""
    return pack_topk(*ivf_codes_topk(codes, recon_norms, tombs, n, q, allow_words, codebook,
                                     centroids, buckets, pca_proj, pca_rows, rot, k, metric,
                                     use_allow, top_p, pre_c, gp, steps2, qb))


def search_ivf_codes_fused(codes, recon_norms, tombs, n, q, allow_words, codebook, centroids,
                           buckets, pca_proj, pca_rows, rot, s2d, k, metric, use_allow, top_p,
                           pre_c, gp, steps2, qb=None):
    """search_ivf_codes with the slot->doc translation on the device."""
    packed = search_ivf_codes(codes, recon_norms, tombs, n, q, allow_words, codebook,
                              centroids, buckets, pca_proj, pca_rows, rot, k, metric,
                              use_allow, top_p, pre_c, gp, steps2, qb)
    return retranslate_packed(packed, s2d)
