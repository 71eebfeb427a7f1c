"""4-bit PQ scan plane and the three-stage re-ranking funnel (twin of
`weaviate_tpu/ops/pq4.py`).

pq.bits=4 fits a second, 16-centroid quantizer over the same M segments
(in the 8-bit quantizer's rotated space) and packs two codes per byte:
byte j holds segment j in its low nibble and segment M/2 + j in its high
nibble. Search runs three stages:
  1. a 4-bit ADC group-min scan over the whole slab -> the top C/16
     groups (C = rg4 * 16 rows). The hand-written kernel K3
     (`csrc/pq_gmin.cu`, `pq4_group_min_scores`) serves batches of 8 rows
     or more at depths whose resident store tile fits in shared memory
     (`use_kernel`); other shapes take the byte-LUT scan
     (`pq4_scores_traceable`: the two 4-bit LUTs of a packed byte folded
     into one 256-entry LUT per byte). That is a routing rule, as the
     reference's (`pallas_eligible`), not a fallback;
  2. exact 8-bit ADC of the C survivors -> the top c = rc;
  3. the exact distance of the c survivors against the bf16 rescore copy
     with the unrotated query -> the top k (without a rescore copy, the
     8-bit ADC distances are reported).

Port notes: the group selection is an exact `torch.topk`, and stages 2
and 3 run in query blocks that keep each [rows, C, D] f32 gather near
2 GB (`topk.query_block`): the port's choice, the JAX program gathers the
whole batch at once (206 GB at B=16384, C=4096, D=768).

The IVF composition (`search_ivf_pq4`) runs the same three stages over
the probed buckets only, with ops/ivf.py's probe, masking and exact
collect-then-merge: stage 1 is the byte-LUT scan per probed candidate
(no kernel: the reference's IVF funnel is an XLA program too).
"""

from __future__ import annotations

import torch

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops import ivf, pq_gmin
from weaviate_tpu_torch.ops.gmin_scan import G, scan_bias
from weaviate_tpu_torch.ops.topk import (pack_topk, query_block, rescore_distances,
                                         retranslate_packed, smallest_k, translate_pack)

C4 = 16  # centroids per 4-bit sub-quantizer (one nibble)

# launches of the K3 kernel by pq4_group_min_scores (never the CPU path)
launches = 0


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """[..., M/2] packed -> [..., M] codes (compress/pq.unpack_codes4)."""
    return torch.cat([packed & 15, packed >> 4], dim=-1)


def pq4_group_min_scores_reference(q, codes3p, bias2, codebook4, alpha: float,
                                   active_g: int = G) -> torch.Tensor:
    """Plain torch version of K3: K2's over the unpacked nibbles."""
    return pq_gmin.codes_scores_reference(q, codes3p, bias2, codebook4, alpha, active_g,
                                          unpack=_unpack)


def pq4_group_min_scores(q: torch.Tensor, codes3p: torch.Tensor, bias2: torch.Tensor,
                         codebook4: torch.Tensor, alpha: float, *,
                         active_g: int = G) -> torch.Tensor:
    """[B, D] f32 rotated queries x [G, ncols, M/2] packed codes view x
    [M, 16, D/M] bf16 codebook -> [B, ncols] group-min 4-bit ADC scores.

    On a CUDA tensor this launches K3 and raises if the launch fails; on a
    CPU tensor it runs pq4_group_min_scores_reference."""
    global launches
    if q.device.type == "cpu":
        return pq4_group_min_scores_reference(q, codes3p, bias2, codebook4, alpha, active_g)
    if q.device.type != "cuda":
        raise ValueError(f"pq4_group_min_scores runs on cuda or cpu tensors, got {q.device}")
    dims = pq_gmin.check_codes_args(q, codes3p, bias2, codebook4, 0.5, C4)
    out = pq_gmin.launch_codes("pq4_gmin_launch", q, codes3p, bias2, codebook4, alpha,
                               active_g, *dims)
    launches += 1
    return out


def use_kernel(metric: str, b: int, ncols: int, dim: int) -> bool:
    """Stage 1's routing rule: K3 for the matmul metrics at 8 query rows
    or more, at least 64 group columns and a depth whose store tile has a
    plan (`pq_gmin.codes_plan`, the counterpart of the reference's
    `fits_vmem_pq4`); the byte-LUT scan otherwise."""
    return (metric in vi.MATMUL_DISTANCES and b >= 8 and ncols >= 64
            and pq_gmin.codes_plan(dim) is not None)


def plan_funnel(k: int, n: int, c_cap: int, rc_cap: int) -> tuple[int, int]:
    """-> (rg4 kept stage-1 groups, rc stage-2 survivors) with k <= rc <=
    rg4*G where possible. n is the scan plane's row count (the slab
    capacity on the full-store tier)."""
    ncols = max(1, n // G)
    rg4 = max(1, min(c_cap // G, ncols))
    rc = max(k, min(rc_cap, rg4 * G))
    if rg4 * G < k:
        rc = rg4 * G
    return rg4, rc


def byte_lut(qr: torch.Tensor, codebook4: torch.Tensor) -> torch.Tensor:
    """[B, D] rotated queries x [M, 16, ds] codebook -> [B, M/2*256] f32:
    entry j*256 + byte holds q.recon of BOTH nibbles of packed byte j."""
    b, _ = qr.shape
    m, _, ds = codebook4.shape
    mb = m // 2
    qs = qr.reshape(b, m, ds).float()
    lut4 = torch.einsum("bmd,mcd->bmc", qs, codebook4.float())
    # byte v = lo | hi << 4 -> index [hi, lo]
    lut2 = lut4[:, mb:, :, None] + lut4[:, :mb, None, :]  # [B, mb, 16, 16]
    return lut2.reshape(b, mb * 256)


_LUT_ELEMS = 1 << 28  # largest [B, columns, M/2] gather of the byte-LUT scan


def pq4_scores_traceable(qr, codes3p, bias2, codebook4, alpha: float) -> torch.Tensor:
    """[B, ncols] group-min 4-bit ADC scores through the byte LUT (M/2
    lookups per row, no reconstruction), over column chunks that bound
    the [B, chunk, M/2] gather."""
    b = qr.shape[0]
    g, ncols, mb = codes3p.shape
    lut2 = byte_lut(qr, codebook4)
    joff = torch.arange(mb, device=qr.device) * 256
    out = torch.full((b, ncols), float("inf"), dtype=torch.float32, device=qr.device)
    step = max(1, _LUT_ELEMS // max(b * mb, 1))
    for gi in range(g):
        for c0 in range(0, ncols, step):
            idx = codes3p[gi, c0: c0 + step].long() + joff   # [chunk, mb]
            s = lut2[:, idx].sum(-1)                          # [B, chunk]
            out[:, c0: c0 + step] = torch.minimum(
                out[:, c0: c0 + step], bias2[gi, c0: c0 + step][None, :] + alpha * s)
    return out


def pq4_funnel_topk(codes4p, codes8, norms4, norms8, tombs, n, q, codebook4_bf16, codebook4,
                    flat_cb8, rescore_rows, allow_words, use_allow, k, metric, rg4, rc,
                    active_g=G, kernel=False, rot=None, codes8_blk=None):
    """The three-stage funnel -> ([B, k] dists, [B, k] slot idx int32, -1
    missing). codebook4_bf16 feeds K3, codebook4 (f32) the byte-LUT scan;
    flat_cb8 is the 8-bit [M*C, ds] f32 codebook; rescore_rows the bf16
    [cap, D] copy or None (two stages, 8-bit ADC distances reported)."""
    qf = q.float()
    qr = qf if rot is None else qf @ rot
    cap, mb = codes4p.shape
    ncols = cap // G
    b, d = q.shape
    dev = codes4p.device

    bias2, alpha = scan_bias(tombs, n, norms4, allow_words, use_allow, metric)

    # stage 1: 4-bit group-min scan -> top rg4 groups (C = rg4*G rows)
    codes3p = codes4p.view(G, ncols, mb)
    if kernel:
        gmin = pq4_group_min_scores(qr, codes3p, bias2, codebook4_bf16, alpha,
                                    active_g=active_g)
    else:
        gmin = pq4_scores_traceable(qr, codes3p, bias2, codebook4, alpha)
    _, gidx = smallest_k(gmin, rg4)
    del gmin

    offs = torch.arange(G, device=dev) * ncols
    bias_blk = bias2.T.contiguous()  # [ncols, G]
    tops, idxs = [], []
    step = query_block(rg4 * G, d)
    for s in range(0, b, step):
        gidx_ = gidx[s: s + step]
        nb = gidx_.shape[0]
        # stage 2: exact 8-bit ADC of the C survivors -> top rc
        slots = (gidx_[:, :, None] + offs).reshape(nb, rg4 * G)
        ed8 = pq_gmin.adc_rescore(qr[s: s + step], gidx_, slots, codes8, codes8_blk,
                                  flat_cb8, bias_blk, norms8, metric)
        d2, pos = smallest_k(ed8, rc)
        slots2 = torch.gather(slots, 1, pos)
        del ed8
        # stage 3: exact distances of the rc survivors against the rescore
        # copy, with the raw query (the copy holds unrotated rows)
        if rescore_rows is not None:
            rows = rescore_rows[torch.clamp(slots2, 0, cap - 1)]
            ed3 = rescore_distances(rows, qf[s: s + step], metric)
            ed3 = torch.where(torch.isinf(d2), float("inf"), ed3)
            top, pos3 = smallest_k(ed3, k)
            idx = torch.gather(slots2, 1, pos3)
        else:
            top, idx = d2[:, :k], slots2[:, :k]
        tops.append(top)
        idxs.append(idx)
    top = torch.cat(tops)
    idx = torch.where(torch.isinf(top), -1, torch.cat(idxs)).to(torch.int32)
    return top, idx


def search_pq4_funnel(codes4p, codes8, norms4, norms8, tombs, n, q, codebook4_bf16, codebook4,
                      flat_cb8, rescore_rows, allow_words, use_allow, k, metric, rg4, rc,
                      active_g=G, kernel=False, rot=None, codes8_blk=None):
    """pq4_funnel_topk packed into the staged [B, 2k] int32 layout
    (ops/topk.pack_topk)."""
    top, idx = pq4_funnel_topk(codes4p, codes8, norms4, norms8, tombs, n, q, codebook4_bf16,
                               codebook4, flat_cb8, rescore_rows, allow_words, use_allow, k,
                               metric, rg4, rc, active_g, kernel, rot, codes8_blk)
    return pack_topk(top, idx)


def search_pq4_funnel_fused(codes4p, codes8, norms4, norms8, tombs, n, q, codebook4_bf16,
                            codebook4, flat_cb8, rescore_rows, allow_words, s2d, use_allow, k,
                            metric, rg4, rc, active_g=G, kernel=False, rot=None,
                            codes8_blk=None):
    """pq4_funnel_topk with the slot->doc translation on the device -> the
    fused [B, 3k] int32 layout (ops/topk.translate_pack)."""
    top, idx = pq4_funnel_topk(codes4p, codes8, norms4, norms8, tombs, n, q, codebook4_bf16,
                               codebook4, flat_cb8, rescore_rows, allow_words, use_allow, k,
                               metric, rg4, rc, active_g, kernel, rot, codes8_blk)
    return translate_pack(top, idx, s2d)


# -- IVF composition ----------------------------------------------------------


def ivf_pq4_topk(codes4p, codes8, norms4, norms8, tombs, n, q, allow_words, codebook4,
                 codebook8, centroids, buckets, rot, rescore_rows, k, metric, use_allow, top_p,
                 c1, rc, gp, steps2, qb=None):
    """The IVF-probed three-stage funnel: probe -> 4-bit byte-LUT ADC over
    the probed buckets (keep c1) -> exact 8-bit ADC of the survivors (keep
    rc) -> exact distances against the bf16 rescore copy with the raw
    query (without a copy, the 8-bit ADC distances are reported).
    codebook4 [M, 16, ds] and codebook8 [M, C, ds] are f32. -> ([B, k]
    dists, [B, k] slot idx int32, -1 missing)."""
    qf_all, parts_all, buckets_ext, allow = ivf._prep(q, tombs, n, allow_words, use_allow,
                                                      centroids, buckets, top_p, metric)
    qr_all = qf_all if rot is None else qf_all @ rot
    cap, mb = codes4p.shape
    joff = torch.arange(mb, device=q.device) * 256
    total = top_p * buckets.shape[1]
    tops, idxs = [], []
    for s, e in ivf._blocks(qf_all.shape[0], qb):
        qf, qr, parts = qf_all[s:e], qr_all[s:e], parts_all[s:e]
        q_sq = torch.sum(qr ** 2, dim=-1, keepdim=True)
        lut2 = byte_lut(qr, codebook4)                      # [b, mb*256]

        def score_adc4(sl):
            bq, g = sl.shape
            safe = torch.clamp(sl, 0, cap - 1)
            idx = (codes4p[safe].long() + joff).reshape(bq, g * mb)
            acc = torch.gather(lut2, 1, idx).reshape(bq, g, mb).sum(-1)
            if metric == vi.DISTANCE_L2:
                return torch.clamp(q_sq - 2.0 * acc + norms4[safe], min=0.0)
            if metric == vi.DISTANCE_DOT:
                return -acc
            return 1.0 - acc

        # c1 is already a wide cut over rc: no slack on stage 1
        groups = ivf._probed_groups(parts, buckets_ext, gp, n, tombs, allow)
        _, pslots = ivf._grouped_topk(groups, score_adc4, c1, total, slack=False)
        score_adc8 = ivf.adc_scorer(codes8, norms8, codebook8, qr, metric)
        top2, idx2 = ivf._grouped_topk(ivf._regroup(pslots, pslots >= 0, steps2),
                                       score_adc8, rc, c1)
        if rescore_rows is not None:
            rows = rescore_rows[torch.clamp(idx2, 0, cap - 1)]
            ed3 = rescore_distances(rows, qf, metric)
            ed3 = torch.where(torch.isinf(top2), float("inf"), ed3)
            top, pos = smallest_k(ed3, k)
            idx = torch.gather(idx2, 1, pos)
        else:
            top, idx = top2[:, :k], idx2[:, :k]
        tops.append(top)
        idxs.append(idx)
    return ivf._finish(tops, idxs)


def search_ivf_pq4(codes4p, codes8, norms4, norms8, tombs, n, q, allow_words, codebook4,
                   codebook8, centroids, buckets, rot, rescore_rows, k, metric, use_allow,
                   top_p, c1, rc, gp, steps2, qb=None):
    """ivf_pq4_topk packed into the staged [B, 2k] int32 layout."""
    return pack_topk(*ivf_pq4_topk(codes4p, codes8, norms4, norms8, tombs, n, q, allow_words,
                                   codebook4, codebook8, centroids, buckets, rot, rescore_rows,
                                   k, metric, use_allow, top_p, c1, rc, gp, steps2, qb))


def search_ivf_pq4_fused(codes4p, codes8, norms4, norms8, tombs, n, q, allow_words, codebook4,
                         codebook8, centroids, buckets, rot, rescore_rows, s2d, k, metric,
                         use_allow, top_p, c1, rc, gp, steps2, qb=None):
    """search_ivf_pq4 with the slot->doc translation on the device."""
    packed = search_ivf_pq4(codes4p, codes8, norms4, norms8, tombs, n, q, allow_words,
                            codebook4, codebook8, centroids, buckets, rot, rescore_rows, k,
                            metric, use_allow, top_p, c1, rc, gp, steps2, qb)
    return retranslate_packed(packed, s2d)
