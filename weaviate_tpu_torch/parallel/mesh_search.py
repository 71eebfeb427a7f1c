"""Sharded search over a list of devices (twin of
`weaviate_tpu/parallel/mesh_search.py`).

The JAX package runs each step as one SPMD program over a
jax.sharding.Mesh: every chip scores its own [n_loc, D] slab, takes a
local top-k, and an all_gather over ICI plus a reselect merges the
candidates inside the same jit. Here one process drives an ordered list
of torch devices (`make_mesh`), one slab each. The state is a list of
tensors per buffer, slab s on `mesh[s]`; replicated operands (queries,
codebooks, the OPQ rotation, IVF centroids) come as per-slab lists too,
with one copy per distinct device (`replicate`). A list may name one card
more than once (the card's counterpart of XLA's virtual host devices):
its slabs then share that card.

A search step loops over the slabs and enqueues each slab's work on its
own device, with no host synchronisation inside the loop (no `.item()`,
no boolean-mask indexing; the live counts are host ints). Each slab ends
in the shared epilogue `_epilogue`:
- fused: its local winners translated through its own slot->doc column
  (ops/topk.translate_pack) into a [B, 3k] block of (distance | id low
  words | id high words), so the merged result already carries doc ids;
- staged: its winners rebased to global rows (slab row + s * n_loc) and
  packed [B, 2k] (ops/topk.pack_topk), for the host translation.
The blocks go to the lead device (slab 0's) with `.to(lead,
non_blocking=True)` (a no-op when the slab lives there), are concatenated
in slab order and reselected with `torch.topk` (`_merge`), so a dispatch
still ends in one device->host fetch. `torch.topk` keeps no tie order, so
the parity data is tie-free, as everywhere in the port.

The search steps, each the reference's per-chip body:
- mesh_search_step: the chunked masked exact scan per slab;
- mesh_search_gmin_step: K1 (or K1 over a bf16 store) per slab, through
  ops/gmin_scan.gmin_topk with the slab's rescore block layout, built per
  dispatch as the reference builds it in-graph;
- mesh_search_pq_gmin_step: K2 per slab (ops/pq_gmin.pq_gmin_topk);
- mesh_search_pq_step: the reconstruction scan per slab, with an exact
  rescore against the slab's own (bf16) store rows when asked;
- mesh_search_ivf_step: the probed dense scan per slab over the slab's own
  bucket table (ops/ivf.ivf_dense_topk; no PCA prefilter, as in the
  reference);
- mesh_search_pq4_step: the 4-bit funnel per slab, its stage 1 the
  byte-LUT scan (not K3), as the reference fixes it.
Selection is exact everywhere (`torch.topk`): the reference's
approx_min_k is exact on its CPU backend, which is what the parity tests
compare against.

The write steps land rows, tombstones and slot->doc ids in the slabs a
caller owns, in place; the index (index/mesh.py) first copies any slab
that a published snapshot holds, which keeps the reference's
non-donating contract. `mesh_grow` pads every slab into new tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops import gmin_scan, ivf, pq4, pq_gmin
from weaviate_tpu_torch.ops.distances import DISTANCE_FNS
from weaviate_tpu_torch.ops.topk import (bitmap_to_mask, merge_top_k, pack_topk, query_block,
                                         rescore_distances, smallest_k, translate_pack)

# rows of a slab scored per scan step (bounds the [B, chunk] block, the
# reference's _MESH_SCAN_CHUNK)
_MESH_SCAN_CHUNK = 131072

# slabs per mesh on the CPU when none are named: the count the JAX package
# sees in the tests (8 virtual host devices), so CPU parity runs compare
# equal slab counts
_CPU_SLABS = 8


def make_mesh(n_devices: Optional[int] = None, devices=None, device=None) -> list:
    """-> the ordered list of torch devices, one per slab (the reference's
    `make_mesh`, `jax.devices()[:n]`). `devices` names them outright and
    may name one card more than once; otherwise `device` picks the kind:
    the card (the default) gives the first n of `torch.cuda.device_count()`
    cards, all of them when n is 0 or None; "cpu" gives n slabs on the
    CPU, 8 when n is 0 or None."""
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("a mesh needs at least one device")
        return out
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (n_devices or _CPU_SLABS)
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(count)][: n_devices or count]


def replicate(t: Optional[torch.Tensor], mesh: Sequence[torch.device]) -> list:
    """One copy of t on each distinct device of the mesh, as a per-slab
    list (slabs on one device share the copy; None stays None)."""
    if t is None:
        return [None] * len(mesh)
    copies: dict = {}
    for d in mesh:
        if d not in copies:
            # pageable host memory is staged at the call: the source may be
            # reused at once, and the upload waits for no earlier work
            copies[d] = t.to(d, non_blocking=True)
    return [copies[d] for d in mesh]


def _epilogue(d_top, i_loc, s2d_l, base: int, fused: bool) -> torch.Tensor:
    """A slab's local winners (i_loc [B, k] slab rows, -1 for missing) ->
    its block for the merge: fused, translated through the slab's own
    slot->doc column into the [B, 3k] layout; staged, rebased to global
    rows (base = s * n_loc) in the [B, 2k] layout. A candidate at +inf
    carries no row, whatever the selection's tie order left there."""
    i_loc = torch.where(torch.isinf(d_top), -1, i_loc.long())
    if fused:
        return translate_pack(d_top, i_loc, s2d_l)
    return pack_topk(d_top, torch.where(i_loc >= 0, i_loc + base, -1))


def _merge(blocks: list, k: int, fused: bool) -> torch.Tensor:
    """The cross-slab merge on the lead device (the reference's
    all_gather + reselect): concatenate the slabs' blocks in slab order
    and keep the k best by distance, their id words (fused) or global
    rows (staged) riding the selection."""
    all_p = torch.cat(blocks, dim=1) if len(blocks) > 1 else blocks[0]
    b = all_p.shape[0]
    w = all_p.view(b, -1, 3 if fused else 2, k)
    d_all = w[:, :, 0, :].reshape(b, -1).view(torch.float32)
    top, pos = smallest_k(d_all, k)
    if fused:
        lo = torch.gather(w[:, :, 1, :].reshape(b, -1), 1, pos)
        hi = torch.gather(w[:, :, 2, :].reshape(b, -1), 1, pos)
        return torch.cat([top.view(torch.int32), lo, hi], dim=1)
    rows = torch.gather(w[:, :, 1, :].reshape(b, -1), 1, pos)
    return pack_topk(top, torch.where(torch.isinf(top), -1, rows))


def _over_slabs(mesh, k: int, n_loc: int, s2d, fused: bool, slab_fn) -> torch.Tensor:
    """Run slab_fn(s) -> ([B, k] dists, [B, k] slab rows) for every slab,
    each on its own device, then merge on the lead device."""
    lead = mesh[0]
    blocks = []
    for s in range(len(mesh)):
        d_top, i_loc = slab_fn(s)
        blk = _epilogue(d_top, i_loc, s2d[s] if fused else None, s * n_loc, fused)
        blocks.append(blk.to(lead, non_blocking=True))
    return _merge(blocks, k, fused)


def _valid(tombs_l, n_mine: int, base: int, chunk: int, allow_l, use_allow: bool):
    """[chunk] bool: slab rows base.. below the slab's live count, not
    tombstoned and allowed."""
    lane = torch.arange(chunk, device=tombs_l.device)
    valid = (lane + base < n_mine) & ~tombs_l[base: base + chunk]
    if use_allow:
        valid = valid & bitmap_to_mask(allow_l[base // 32: (base + chunk) // 32], chunk)
    return valid


def _scan_slab(store_l, norms_l, tombs_l, n_mine, q, allow_l, k, metric, use_allow):
    """The chunked masked scan over one slab -> ([B, k] dists, [B, k] slab
    rows): each chunk's [B, chunk] distances (the query rounded to the
    store's type, as the reference casts it), a per-chunk top-k, an exact
    merge."""
    n_loc = store_l.shape[0]
    chunk = min(n_loc, _MESH_SCAN_CHUNK)
    b = q.shape[0]
    dev = store_l.device
    qd = q.to(store_l.dtype)
    top = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for base in range(0, n_loc, chunk):
        valid = _valid(tombs_l, n_mine, base, chunk, allow_l, use_allow)
        norms = norms_l[base: base + chunk] if norms_l is not None else None
        d = DISTANCE_FNS[metric](qd, store_l[base: base + chunk], norms)
        d = torch.where(valid[None, :], d, float("inf"))
        td, li = smallest_k(d, k)
        top, idx = merge_top_k(top, idx, td, li + base, k)
    return top, idx


def mesh_search_step(store, sq_norms, tombs, counts, allow_words, queries, s2d, k: int,
                     metric: str, use_allow: bool, use_norms: bool, fused: bool, mesh):
    """Masked exact kNN over every slab (the chunked scan, tombstones and
    the allowList's packed words) -> the merged packed result on the lead
    device: fused [B, 3k] with doc ids, staged [B, 2k] with global rows.

    store [n_loc, D], sq_norms [n_loc] f32 (read only when use_norms),
    tombs [n_loc] bool, allow_words [n_loc / 32] int32 (None without a
    filter), s2d [n_loc] int64: per-slab lists; counts: the slabs' live
    high-water marks (host ints); queries: per-slab replicas of [B, D]
    f32."""
    n_loc = store[0].shape[0]
    return _over_slabs(mesh, k, n_loc, s2d, fused, lambda s: _scan_slab(
        store[s], sq_norms[s] if use_norms else None, tombs[s], int(counts[s]), queries[s],
        allow_words[s] if use_allow else None, k, metric, use_allow))


def mesh_search_gmin_step(store, sq_norms, tombs, counts, allow_words, queries, s2d, k: int,
                          metric: str, use_allow: bool, rg: int, active_g: int, fused: bool,
                          mesh):
    """The group-min fast scan per slab: K1 over the slab's f32 (or bf16)
    store, the top rg groups, the exact f32 rescore of their members from
    the slab's block layout (built here, per dispatch, as the reference
    builds it in-graph), then the merge. Same operands as
    mesh_search_step plus rg kept groups and active_g live slices per
    slab."""
    n_loc = store[0].shape[0]

    def slab(s):
        return gmin_scan.gmin_topk(
            store[s], sq_norms[s], tombs[s], int(counts[s]), queries[s],
            allow_words[s] if use_allow else None, use_allow, k, metric, rg, active_g,
            gmin_scan.build_rescore_blocks(store[s]))

    return _over_slabs(mesh, k, n_loc, s2d, fused, slab)


def mesh_search_pq_gmin_step(codes, recon_norms, tombs, counts, allow_words, cb_bf16, flat_cb,
                             queries, rot, s2d, k: int, metric: str, use_allow: bool, rg: int,
                             active_g: int, fused: bool, mesh):
    """The codes-only ADC scan per slab: K2 over the slab's uint8 codes,
    the top rg groups, their exact-ADC rescore from the slab's code block
    layout, then the merge. ADC distances are deterministic per slab, so
    the merge is exact with respect to the quantizer. cb_bf16 [M, C, ds]
    bf16, flat_cb [M*C, ds] f32 and rot [D, D] (or None) are per-slab
    replicas."""
    n_loc = codes[0].shape[0]

    def slab(s):
        return pq_gmin.pq_gmin_topk(
            codes[s], recon_norms[s], tombs[s], int(counts[s]), queries[s], cb_bf16[s],
            flat_cb[s], allow_words[s] if use_allow else None, use_allow, k, metric, rg,
            active_g, rot[s], pq_gmin.build_codes_blocks(codes[s]))

    return _over_slabs(mesh, k, n_loc, s2d, fused, slab)


def _recon_slab(codes_l, norms_l, tombs_l, n_mine, q, allow_l, cb_bf16, rs_l, r, k, r_chunk,
                metric, use_allow, do_rescore):
    """The reconstruction scan over one slab: each chunk's codes rebuild
    [chunk, D] bf16 rows from the bf16 codebook, scored by one product with
    the bf16-rounded (rotated) query in f32; each chunk keeps its top
    r_chunk; with do_rescore the pool is rescored exactly against the
    slab's store rows with the raw query, in query blocks. -> ([B, k]
    dists, [B, k] slab rows)."""
    n_loc = codes_l.shape[0]
    chunk = min(n_loc, _MESH_SCAN_CHUNK)
    qr = q.float() if r is None else q.float() @ r
    qd = qr.to(torch.bfloat16).float()
    q_sq = torch.sum(qr ** 2, dim=-1, keepdim=True)
    tds, lis = [], []
    for base in range(0, n_loc, chunk):
        recon = pq_gmin.reconstruct(codes_l[base: base + chunk], cb_bf16).float()
        qx = qd @ recon.T
        if metric == vi.DISTANCE_L2:
            d = torch.clamp(q_sq - 2.0 * qx + norms_l[base: base + chunk][None, :], min=0.0)
        elif metric == vi.DISTANCE_DOT:
            d = -qx
        else:  # cosine: rows and queries normalized
            d = 1.0 - qx
        valid = _valid(tombs_l, n_mine, base, chunk, allow_l, use_allow)
        d = torch.where(valid[None, :], d, float("inf"))
        td, li = smallest_k(d, r_chunk)
        tds.append(td)
        lis.append(li + base)
    cand_d, cand_i = torch.cat(tds, dim=1), torch.cat(lis, dim=1)
    if do_rescore:
        parts = []
        step = query_block(cand_i.shape[1], q.shape[1])
        for s in range(0, q.shape[0], step):
            ci = cand_i[s: s + step]
            rows = rs_l[torch.clamp(ci, 0, n_loc - 1)]
            parts.append(rescore_distances(rows, q[s: s + step], metric))
        cand_d = torch.where(torch.isinf(cand_d), float("inf"), torch.cat(parts))
    top, pos = smallest_k(cand_d, k)
    return top, torch.gather(cand_i, 1, pos)


def mesh_search_pq_step(codes, recon_norms, tombs, counts, allow_words, cb_bf16,
                        rescore_store, queries, rot, s2d, k: int, r_chunk: int, metric: str,
                        use_allow: bool, do_rescore: bool, fused: bool, mesh):
    """The PQ reconstruction scan per slab (the single-device
    `_search_pq_recon`), with the exact rescore of each slab's candidate
    pool against its own store rows when do_rescore (rescored distances
    are exact f32, so the merge is exact), then the merge. codes [n_loc,
    M], rescore_store [n_loc, D]: per-slab lists."""
    n_loc = codes[0].shape[0]
    return _over_slabs(mesh, k, n_loc, s2d, fused, lambda s: _recon_slab(
        codes[s], recon_norms[s], tombs[s], int(counts[s]), queries[s],
        allow_words[s] if use_allow else None, cb_bf16[s], rescore_store[s], rot[s], k,
        r_chunk, metric, use_allow, do_rescore))


def mesh_search_ivf_step(store, tombs, counts, allow_words, centroids, buckets, queries, s2d,
                         k: int, metric: str, use_allow: bool, top_p: int, fused: bool, mesh):
    """Partition-pruned kNN per slab: every slab probes the same replicated
    centroids and scores only the probed candidates of its own bucket
    table (buckets [nlist, cap_p] int32 of slab rows, -1 padding, one per
    slab), exactly like the single-device dense IVF scan, then the merge.
    No PCA prefilter: the probed per-slab pool is already 1/n_dev of the
    single-device one (the reference's rule). Query blocks and probes per
    step come from ops/ivf.plan_steps."""
    n_loc = store[0].shape[0]
    b, dim = queries[0].shape
    cap_p = buckets[0].shape[1]
    qb, gp, _ = ivf.plan_steps(b, cap_p, dim, top_p)
    return _over_slabs(mesh, k, n_loc, s2d, fused, lambda s: ivf.ivf_dense_topk(
        store[s], tombs[s], int(counts[s]), queries[s], allow_words[s] if use_allow else None,
        centroids[s], buckets[s], None, None, k, metric, use_allow, top_p, 0, gp, 1, qb=qb))


def mesh_search_pq4_step(codes4, codes8, norms4, norms8, tombs, counts, allow_words, cb4,
                         flat_cb8, rescore_store, queries, rot, s2d, k: int, metric: str,
                         use_allow: bool, rg4: int, rc: int, fused: bool, mesh):
    """The 4-bit funnel per slab (ops/pq4.pq4_funnel_topk: byte-LUT nibble
    scan -> exact 8-bit ADC of the top rg4 * 16 -> exact rescore of the top
    rc against the slab's own store rows), then the merge. Stage 1 is the
    byte-LUT scan on every slab, not K3: the reference's rule
    (`use_pallas=False`). rg4 and rc are per-slab budgets. codes4 [n_loc,
    M/2] packed, codes8 [n_loc, M], per-slab lists; cb4 [M, 16, ds] f32,
    flat_cb8 [M*C, ds] f32 and rot per-slab replicas."""
    n_loc = codes4[0].shape[0]
    return _over_slabs(mesh, k, n_loc, s2d, fused, lambda s: pq4.pq4_funnel_topk(
        codes4[s], codes8[s], norms4[s], norms8[s], tombs[s], int(counts[s]), queries[s],
        None, cb4[s], flat_cb8[s], rescore_store[s], allow_words[s] if use_allow else None,
        use_allow, k, metric, rg4, rc, kernel=False, rot=rot[s]))


# -- write and grow steps ------------------------------------------------------
# Each lands one run of rows per slab at the slab's own offset, in place, in
# slabs the caller owns (index/mesh.py copies a snapshot's slab first). A
# slab without rows is left as it is.

def mesh_insert_step(store, sq_norms, chunks, offsets, use_norms: bool) -> None:
    """Land chunks[s] ([take, D] f32 host rows, or None) in store[s] at
    offsets[s], and their squared norms (summed in f64, rounded to f32)
    in sq_norms[s] when use_norms."""
    for s, ch in enumerate(chunks):
        if ch is None or len(ch) == 0:
            continue
        off = int(offsets[s])
        x = torch.from_numpy(np.ascontiguousarray(ch, dtype=np.float32)).to(store[s].device)
        store[s][off: off + len(ch)] = x.to(store[s].dtype)
        if use_norms:
            sq_norms[s][off: off + len(ch)] = (x.double() ** 2).sum(1).float()


def mesh_write_rows_step(arr2d, arr1d, chunks2d, vals1d, offsets) -> None:
    """The generic twin of mesh_insert_step for a code matrix and a per-row
    f32 vector (codes and ||recon||^2): chunks2d[s] [take, W] and vals1d[s]
    [take] (device tensors, or None) land at offsets[s]."""
    for s, ch in enumerate(chunks2d):
        if ch is None or ch.shape[0] == 0:
            continue
        off = int(offsets[s])
        arr2d[s][off: off + ch.shape[0]] = ch.to(arr2d[s].device, arr2d[s].dtype)
        arr1d[s][off: off + ch.shape[0]] = vals1d[s].to(arr1d[s].device, torch.float32)


def mesh_write_pairs_step(s2d, docs, offsets) -> None:
    """Land docs[s] (int64 doc ids, host, or None) in the slab's slot->doc
    column at offsets[s]."""
    for s, d in enumerate(docs):
        if d is None or len(d) == 0:
            continue
        off = int(offsets[s])
        s2d[s][off: off + len(d)] = torch.from_numpy(
            np.ascontiguousarray(d, dtype=np.int64)).to(s2d[s].device)


def mesh_delete_step(tombs, rows: np.ndarray, n_loc: int) -> list:
    """Tombstone global rows: each slab takes the rows inside it. ->
    the slabs written."""
    rows = np.asarray(rows, dtype=np.int64)
    touched = []
    for s in range(len(tombs)):
        mine = rows[(rows >= s * n_loc) & (rows < (s + 1) * n_loc)] - s * n_loc
        if mine.size:
            tombs[s][torch.from_numpy(mine).to(tombs[s].device)] = True
            touched.append(s)
    return touched


def mesh_grow(arrs, new_loc: int, fill) -> list:
    """Pad every slab to new_loc rows into a new tensor, its rows kept at
    their slab offsets and `fill` past them: the reference's
    mesh_grow_2d and mesh_grow_1d (fill 0) and mesh_grow_pairs (fill the
    unwritten-slot id -1). Published snapshots keep the old tensors."""
    out = []
    for t in arrs:
        g = torch.full((new_loc, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
        g[: t.shape[0]] = t
        out.append(g)
    return out


class MeshSearchPlan:
    """Thin facade over the mesh index (index/mesh.py) for standalone use:
    balanced placement, no durability."""

    def __init__(self, mesh, dim: int, capacity_per_shard: int = 16384,
                 metric: str = vi.DISTANCE_L2, dtype=torch.float32):
        from weaviate_tpu_torch.index.mesh import MeshVectorIndex

        cfg = vi.HnswUserConfig(index_type="hnsw_tpu_mesh", distance=metric)
        if dtype == torch.bfloat16:
            cfg.store_dtype = "bfloat16"
        self.index = MeshVectorIndex(cfg, shard_path="", persist=False, mesh=mesh,
                                     initial_capacity_per_shard=capacity_per_shard,
                                     dim_hint=dim)
        self.mesh = mesh
        self.dim = dim

    def add_batch(self, doc_ids: np.ndarray, vectors: np.ndarray) -> None:
        self.index.add_batch(np.asarray(doc_ids), np.asarray(vectors, np.float32))

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        ids, d = self.index.search_by_vectors(np.asarray(queries, np.float32), k)
        # uint64 sentinel (max) -> -1 for the standalone API
        return ids.view(np.int64), d
