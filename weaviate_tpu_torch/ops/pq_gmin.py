"""Group-min fast scan over 8-bit PQ codes: the codes-only serving tier
(twin of `weaviate_tpu/ops/pq_gmin.py`).

The memory-tightest tier (pq.rescore=false) keeps only [cap, M] uint8
codes on the device. The scan scores every slot against its
reconstruction, recon[slot] = concat over segments m of
bf16(codebook)[m, codes[slot, m]], in K1's unified form

    score = bias[slot] + alpha * (bf16(q) . recon[slot])
      l2:         bias = ||recon||^2 from the f32 codebook, alpha = -2
      dot/cosine: bias = 0, alpha = -1
    dead slots (tombstoned / past n / filtered out): bias = +inf

and keeps only the [B, ncols] group minima over the G=16 store slices,
as K1 does. The top RG groups' members are then rescored by exact ADC in
f32 (their reconstruction from the f32 codebook), so the distances
returned are ADC distances, the same values the reference's codes tier
reports. OPQ rotates the queries first; distances are rotation-invariant
for the matmul metrics.

`pq_group_min_scores` launches the hand-written Hopper kernel K2
(`csrc/pq_gmin.cu`) for tensors on the card and runs its plain torch
version, `pq_group_min_scores_reference`, for tensors on the CPU. The
kernel keeps a decoded store tile of S live slices x SCG group columns
resident in shared memory for its whole life (K1's resident-tile scan,
`csrc/gmin_resident.cuh`). `codes_plan` sizes that tile, as
`gmin_scan.resident_plan` does for K1, and shapes whose tile does not fit
even at one column (D > 6208) take the reconstruction scan through
`eligible_rg`, as the reference refuses its Pallas kernel past VMEM
(`fits_vmem_pq`). Around
it, plain torch ops: an exact `torch.topk` group selection (the TPU used
approx_min_k) and the block-gathered exact-ADC rescore. The rescore runs
in query blocks that keep each [rows, RG*16, D] f32 gather near 2 GB
(`topk.query_block`): the port's choice, the JAX program gathers the
whole batch at once (25.8 GB at B=16384, RG*16=512, D=768).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops import _kernels
from weaviate_tpu_torch.ops.gmin_scan import (G, ResidentPlan, _live_slices, no_plan_error,
                                              query_scratch, resident_plan, scan_bias)
from weaviate_tpu_torch.ops.topk import (pack_topk, query_block, rescore_distances,
                                         smallest_k, translate_pack)

# launches of the K2 kernel by pq_group_min_scores (never the CPU path)
launches = 0

_lib = None


def codes_plan(d: int, active_g: int = G) -> Optional[ResidentPlan]:
    """The resident-tile plan of K2/K3 for depth d: K1's
    (`gmin_scan.resident_plan`), None when no tile fits."""
    return resident_plan(d, active_g)


def codes_lib():
    """The loaded `csrc/pq_gmin.cu` library (K2 and K3), built on first use."""
    global _lib
    if _lib is None:
        lib = _kernels.load("pq_gmin")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.pq8_gmin_launch, lib.pq4_gmin_launch):
            fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, ci, ci, ci, ctypes.c_float,
                           ci, ci, ci, vp]
            fn.restype = ctypes.c_int
        lib.pq_gmin_error_string.argtypes = [ci]
        lib.pq_gmin_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def reconstruct(codes: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """[..., M] codes x [M, C, ds] codebook -> [..., M*ds] rows in the
    codebook's dtype."""
    m, _, ds = codebook.shape
    seg = torch.arange(m, device=codes.device)
    return codebook[seg, codes.long()].reshape(*codes.shape[:-1], m * ds)


def codes_scores_reference(q, codes3, bias2, codebook, alpha, active_g, unpack=None):
    """The plain version shared by K2 and K3: per live slice, the product of
    bf16(q) and the reconstruction from bf16(codebook), in f32, then bias
    + alpha * qx and a running min. Products of two bf16 values are exact
    in f32, so only the order of summation differs from the kernels."""
    b = q.shape[0]
    g, ncols, _ = codes3.shape
    qb = q.to(torch.bfloat16).float()
    cbf = codebook.to(torch.bfloat16).float()
    out = torch.full((b, ncols), float("inf"), dtype=torch.float32, device=q.device)
    for gi in range(_live_slices(active_g, g)):
        codes = codes3[gi] if unpack is None else unpack(codes3[gi])
        qx = qb @ reconstruct(codes, cbf).T
        out = torch.minimum(out, bias2[gi][None, :] + alpha * qx)
    return out


def pq_group_min_scores_reference(q, codes3, bias2, codebook, alpha: float,
                                  active_g: int = G) -> torch.Tensor:
    """Plain torch version of K2 (see codes_scores_reference)."""
    return codes_scores_reference(q, codes3, bias2, codebook, alpha, active_g)


def check_codes_args(q, codes3, bias2, codebook, row_bytes_per_segment: float, max_c: int):
    """Shape, type and placement checks of the K2/K3 wrappers -> (b, d,
    g, ncols, m, c)."""
    b, d = q.shape
    g, ncols, nb = codes3.shape
    m, c, ds = codebook.shape
    if m * ds != d or nb != int(m * row_bytes_per_segment) or tuple(bias2.shape) != (g, ncols):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, codes3 {tuple(codes3.shape)}, "
                         f"bias2 {tuple(bias2.shape)}, codebook {tuple(codebook.shape)}")
    for name, t, dt in (("q", q, torch.float32), ("codes3", codes3, torch.uint8),
                        ("bias2", bias2, torch.float32), ("codebook", codebook, torch.bfloat16)):
        if t.dtype != dt or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {q.device}")
    if g > G or c > max_c:
        raise ValueError(f"the kernel takes at most {G} slices and {max_c} centroids, "
                         f"got {g} and {c}")
    return b, d, g, ncols, m, c


def launch_codes(fn_name: str, q, codes3, bias2, codebook, alpha, active_g, b, d, g, ncols,
                 m, c) -> torch.Tensor:
    """Launch K2 or K3 on q's stream -> [B, ncols] f32; raises if the
    shape has no plan (the routers send such shapes elsewhere) or the
    launch fails. The kernel first rounds q into a zero-padded bf16
    scratch, allocated here."""
    ag = _live_slices(active_g, g)
    plan = codes_plan(d, ag)
    if plan is None:
        raise no_plan_error(d)
    out = torch.empty((b, ncols), dtype=torch.float32, device=q.device)
    if b == 0 or ncols == 0:
        return out
    q_bf16 = query_scratch(q, plan)
    lib = codes_lib()
    rc = getattr(lib, fn_name)(
        q.data_ptr(), codes3.data_ptr(), bias2.data_ptr(), codebook.data_ptr(),
        q_bf16.data_ptr(), out.data_ptr(), b, ncols, d, m, c, ag,
        float(alpha), plan.scg, int(d % 4 == 0 and q.data_ptr() % 16 == 0),
        int(codebook.data_ptr() % 16 == 0), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise _kernels.launch_error(f"{fn_name} failed", rc,
                                    lib.pq_gmin_error_string(rc).decode())
    return out


def pq_group_min_scores(q: torch.Tensor, codes3: torch.Tensor, bias2: torch.Tensor,
                        codebook: torch.Tensor, alpha: float, *,
                        active_g: int = G) -> torch.Tensor:
    """[B, D] f32 queries x [G, ncols, M] uint8 codes view x [M, C<=256,
    D/M] bf16 codebook -> [B, ncols] group-min ADC scores over the first
    active_g slices.

    On a CUDA tensor this launches K2 and raises if the launch fails; on a
    CPU tensor it runs pq_group_min_scores_reference."""
    global launches
    if q.device.type == "cpu":
        return pq_group_min_scores_reference(q, codes3, bias2, codebook, alpha, active_g)
    if q.device.type != "cuda":
        raise ValueError(f"pq_group_min_scores runs on cuda or cpu tensors, got {q.device}")
    dims = check_codes_args(q, codes3, bias2, codebook, 1, 256)
    out = launch_codes("pq8_gmin_launch", q, codes3, bias2, codebook, alpha, active_g, *dims)
    launches += 1
    return out


def eligible_rg(exact_topk: bool, metric: str, pq, b: int, ncols: int, kk: int,
                dim: int) -> Optional[int]:
    """The codes kernel's routing rule -> RG (groups kept) when this shape
    takes it, else None (the reconstruction scan serves): exactTopK, the
    non-matmul metrics, more than 256 centroids, batches under 8 rows,
    fewer than 64 group columns and depths whose store tile has no plan
    (`codes_plan`) do not."""
    if exact_topk or metric not in vi.MATMUL_DISTANCES:
        return None
    if pq is None or pq.centroids > 256 or b < 8 or ncols < 64:
        return None
    rg = min(max(32, 2 * kk), 128, ncols)
    if rg < kk or codes_plan(dim) is None:
        return None
    return rg


def build_codes_blocks(codes: torch.Tensor) -> torch.Tensor:
    """[cap, M] codes -> [ncols, G*M] group-block layout (the codes twin of
    gmin_scan.build_rescore_blocks): the rescore gathers rg contiguous
    G*M-byte rows per query. The index caches it per write generation."""
    cap, m = codes.shape
    ncols = cap // G
    return codes.reshape(G, ncols, m).transpose(0, 1).reshape(ncols, G * m)


def adc_rescore(q, gidx, slots, codes, codes_blk, flat_cb, bias_blk, norms, metric):
    """Exact ADC distances of the kept groups' members -> [nb, rg*G] f32
    (+inf for dead members). q [nb, D] (rotated), gidx [nb, rg] kept
    groups, slots [nb, rg*G] their member slots, flat_cb [M*C, ds] f32,
    bias_blk [ncols, G], norms [cap] f32 (l2's ||recon||^2)."""
    nb, d = q.shape
    m = codes.shape[1]
    c = flat_cb.shape[0] // m
    ncols = bias_blk.shape[0]
    r = slots.shape[1]
    if codes_blk is not None:
        cand_codes = codes_blk[gidx].reshape(nb, r, m).long()
    else:
        cand_codes = codes[slots].long()
    seg_off = torch.arange(m, device=q.device) * c
    cand = flat_cb[cand_codes + seg_off].reshape(nb, r, d)
    cand_bias = bias_blk[gidx].reshape(nb, r)
    if metric == vi.DISTANCE_L2:
        q_sq = torch.sum(q ** 2, dim=-1, keepdim=True)
        qx = torch.bmm(cand, q[:, :, None])[:, :, 0]
        nrm = norms.view(G, ncols).T[gidx].reshape(nb, r)
        ed = torch.clamp(q_sq - 2.0 * qx + nrm, min=0.0)
    else:
        ed = rescore_distances(cand, q, metric)
    return torch.where(torch.isinf(cand_bias), float("inf"), ed)


def pq_gmin_topk(codes, recon_norms, tombs, n, q, codebook_bf16, flat_cb, allow_words,
                 use_allow, k, metric, rg, active_g=G, rot=None, codes_blk=None):
    """Codes-only fused search -> ([B, k] ADC dists, [B, k] slot idx
    int32, -1 missing): K2 scan -> top-RG groups -> exact-ADC rescore of
    their RG*G members -> top-k. flat_cb is the [M*C, ds] f32 codebook; rot
    ([D, D], or None) maps queries into the quantizer's rotated space;
    codes_blk is build_codes_blocks(codes) or None."""
    q = q.float()
    if rot is not None:
        q = q @ rot
    cap, m = codes.shape
    ncols = cap // G
    b, d = q.shape
    dev = codes.device

    bias2, alpha = scan_bias(tombs, n, recon_norms, allow_words, use_allow, metric)
    gmin = pq_group_min_scores(q, codes.view(G, ncols, m), bias2, codebook_bf16, alpha,
                               active_g=active_g)
    _, gidx = smallest_k(gmin, rg)
    del gmin

    offs = torch.arange(G, device=dev) * ncols
    bias_blk = bias2.T.contiguous()  # [ncols, G]
    tops, idxs = [], []
    step = query_block(rg * G, d)
    for s in range(0, b, step):
        gidx_ = gidx[s: s + step]
        slots = (gidx_[:, :, None] + offs).reshape(gidx_.shape[0], rg * G)
        ed = adc_rescore(q[s: s + step], gidx_, slots, codes, codes_blk, flat_cb, bias_blk,
                         recon_norms, metric)
        top, pos = smallest_k(ed, k)
        tops.append(top)
        idxs.append(torch.gather(slots, 1, pos))
    top = torch.cat(tops)
    idx = torch.where(torch.isinf(top), -1, torch.cat(idxs)).to(torch.int32)
    return top, idx


def search_pq_gmin(codes, recon_norms, tombs, n, q, codebook_bf16, flat_cb, allow_words,
                   use_allow, k, metric, rg, active_g=G, rot=None, codes_blk=None):
    """pq_gmin_topk packed into the staged [B, 2k] int32 layout
    (ops/topk.pack_topk)."""
    top, idx = pq_gmin_topk(codes, recon_norms, tombs, n, q, codebook_bf16, flat_cb,
                            allow_words, use_allow, k, metric, rg, active_g, rot, codes_blk)
    return pack_topk(top, idx)


def search_pq_gmin_fused(codes, recon_norms, tombs, n, q, codebook_bf16, flat_cb,
                         allow_words, s2d, use_allow, k, metric, rg, active_g=G, rot=None,
                         codes_blk=None):
    """pq_gmin_topk with the slot->doc translation on the device -> the
    fused [B, 3k] int32 layout (ops/topk.translate_pack)."""
    top, idx = pq_gmin_topk(codes, recon_norms, tombs, n, q, codebook_bf16, flat_cb,
                            allow_words, use_allow, k, metric, rg, active_g, rot, codes_blk)
    return translate_pack(top, idx, s2d)
