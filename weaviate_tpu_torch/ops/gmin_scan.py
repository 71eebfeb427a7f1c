"""Group-min fast scan: the fast half of the flagship kNN path (twin of
`weaviate_tpu/ops/gmin_scan.py`).

The store [cap, D] is viewed as [G=16, cap/G, D] with no copy, so group
c's members are the slots {c + g*(cap/G)}. The scan computes, per query,
the min over each group's members of a bf16 score and never writes the
[B, cap] score matrix: only the [B, cap/G] group minima. Keeping the top
RG >= k groups and rescoring their RG*G members exactly in f32 gives the
top-k up to the bf16 ranking error, which the 2k..128 RG slack absorbs.

Scoring is unified as  score = bias[slot] + alpha * (q . x[slot]):
  l2:     bias = ||x||^2 (+inf dead), alpha = -2   (rank-equal to l2)
  dot:    bias = 0 (+inf dead),       alpha = -1   (rank-equal to -dot)
  cosine: bias = 0 (+inf dead),       alpha = -1   (rows pre-normalized)
Dead slots (tombstoned / beyond n / filtered out) carry bias=+inf.

`group_min_scores` launches the hand-written Hopper kernel
(`csrc/gmin_scan.cu`) for tensors on the card and runs its plain torch
version, `group_min_scores_reference`, for tensors on the CPU. Around
it, plain torch ops do what the JAX package left to XLA: the group
selection is an exact `torch.topk` (the TPU used approx_min_k at recall
target 0.99), then a block gather and the exact f32 rescore.
"""

from __future__ import annotations

import ctypes

import torch

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops import _kernels
from weaviate_tpu_torch.ops.topk import (bitmap_to_mask, rescore_distances,
                                         smallest_k, translate_pack)

G = 16                 # group size (store slices)
_RESCORE_BLOCK = 2048  # query rows per rescore step (bounds the gather)

# launches of the CUDA kernel by group_min_scores (never the CPU path):
# a run reads it to show that its searches went through the kernel
launches = 0

_lib = None


def _gmin_lib():
    global _lib
    if _lib is None:
        lib = _kernels.load("gmin_scan")
        vp, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.gmin_scan_launch.argtypes = [vp, vp, vp, vp, ll, ll, ll, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int, vp]
        lib.gmin_scan_launch.restype = ctypes.c_int
        lib.gmin_scan_error_string.argtypes = [ctypes.c_int]
        lib.gmin_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _live_slices(active_g: int, g: int) -> int:
    return max(1, min(int(active_g), g))


def group_min_scores_reference(q: torch.Tensor, store3: torch.Tensor,
                               bias2: torch.Tensor, alpha: float,
                               active_g: int = G) -> torch.Tensor:
    """Plain torch version of the kernel: per live slice, the product of
    the bf16-rounded operands in f32, then bias + alpha * qx and a running
    min. Products of two bf16 values are exact in f32, so only the order
    of summation differs from the kernel. The TF32 flag does not change
    the result: a bf16 value is exact in TF32, which accumulates in f32."""
    b = q.shape[0]
    g, ncols, _ = store3.shape
    qb = q.to(torch.bfloat16).float()
    out = torch.full((b, ncols), float("inf"), dtype=torch.float32, device=q.device)
    for gi in range(_live_slices(active_g, g)):
        qx = qb @ store3[gi].to(torch.bfloat16).float().T
        out = torch.minimum(out, bias2[gi][None, :] + alpha * qx)
    return out


def group_min_scores(q: torch.Tensor, store3: torch.Tensor, bias2: torch.Tensor,
                     alpha: float, *, active_g: int = G) -> torch.Tensor:
    """[B, D] queries x [G, ncols, D] store view -> [B, ncols] group-min
    scores over the first active_g slices (slots fill in order, so slices
    past ceil(n/ncols) hold no live slot and are never read).

    On a CUDA tensor this launches the Hopper kernel and raises if the
    launch fails; on a CPU tensor it runs group_min_scores_reference."""
    global launches
    if q.device.type == "cpu":
        return group_min_scores_reference(q, store3, bias2, alpha, active_g)
    if q.device.type != "cuda":
        raise ValueError(f"group_min_scores runs on cuda or cpu tensors, got {q.device}")
    b, d = q.shape
    g, ncols, d2 = store3.shape
    if d2 != d or tuple(bias2.shape) != (g, ncols):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, store3 "
                         f"{tuple(store3.shape)}, bias2 {tuple(bias2.shape)}")
    for name, t in (("q", q), ("store3", store3), ("bias2", bias2)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 tensor on {q.device}")
    if g > G:
        raise ValueError(f"the kernel takes at most {G} store slices, got {g}")
    out = torch.empty((b, ncols), dtype=torch.float32, device=q.device)
    if b == 0 or ncols == 0:
        return out
    vec4 = d % 4 == 0 and q.data_ptr() % 16 == 0 and store3.data_ptr() % 16 == 0
    lib = _gmin_lib()
    rc = lib.gmin_scan_launch(q.data_ptr(), store3.data_ptr(), bias2.data_ptr(),
                              out.data_ptr(), b, ncols, d, _live_slices(active_g, g),
                              float(alpha), int(vec4),
                              torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("gmin_scan kernel launch failed: "
                           + lib.gmin_scan_error_string(rc).decode())
    launches += 1
    return out


def build_rescore_blocks(store: torch.Tensor) -> torch.Tensor:
    """[cap, D] store -> [ncols, G*D] group-block layout: row `col` holds
    the G strided members of group `col` (slots col, ncols+col, ...)
    contiguously, member-major, so the rescore gathers rg contiguous
    G*D-wide rows per query instead of rg*G scattered ones. The index
    caches it per store generation."""
    cap, d = store.shape
    ncols = cap // G
    return store.reshape(G, ncols, d).transpose(0, 1).reshape(ncols, G * d)


def gmin_topk(store, sq_norms, tombs, n, q, allow_words, use_allow, k, metric,
              rg, active_g=G, rescore_blk=None):
    """Group-min scan -> top-RG groups -> exact rescore of their RG*G
    members -> ([B, k] dists, [B, k] slot idx int32, -1 for missing)."""
    cap, dim = store.shape
    ncols = cap // G
    b = q.shape[0]
    dev = store.device

    # dead-slot bias: +inf survives the group min and never wins selection
    slot = torch.arange(cap, device=dev)
    dead = tombs | (slot >= n)
    if use_allow:
        dead = dead | ~bitmap_to_mask(allow_words, cap)
    if metric == vi.DISTANCE_L2:
        base, alpha = sq_norms, -2.0
    else:  # dot / cosine (rows pre-normalized at insert for cosine)
        base, alpha = torch.zeros(cap, dtype=torch.float32, device=dev), -1.0
    bias = torch.where(dead, float("inf"), base)

    bias2 = bias.view(G, ncols)
    gmin = group_min_scores(q, store.view(G, ncols, dim), bias2, alpha,
                            active_g=active_g)
    _, gidx = smallest_k(gmin, rg)

    # expand each kept group to its member slots and rescore exactly, in
    # query blocks that bound the [block, rg*G, D] gather; the members'
    # bias rides the same block gather
    offs = torch.arange(G, device=dev) * ncols
    bias_blk = bias2.T.contiguous()  # [ncols, G]
    tops, idxs = [], []
    for s in range(0, b, _RESCORE_BLOCK):
        q_ = q[s: s + _RESCORE_BLOCK]
        gidx_ = gidx[s: s + _RESCORE_BLOCK]
        nb = q_.shape[0]
        slots = (gidx_[:, :, None] + offs).reshape(nb, rg * G)
        if rescore_blk is not None:
            cand = rescore_blk[gidx_].reshape(nb, rg * G, dim)
        else:
            cand = store[slots]
        ed = rescore_distances(cand, q_, metric)
        cand_bias = bias_blk[gidx_].reshape(nb, rg * G)
        ed = torch.where(torch.isinf(cand_bias), float("inf"), ed)
        top, pos = smallest_k(ed, k)
        tops.append(top)
        idxs.append(torch.gather(slots, 1, pos))
    top = torch.cat(tops)
    idx = torch.where(torch.isinf(top), -1, torch.cat(idxs)).to(torch.int32)
    return top, idx


def search_gmin_fused(store, sq_norms, tombs, n, q, allow_words, s2d, use_allow,
                      k, metric, rg, active_g=G, rescore_blk=None):
    """gmin_topk with the slot->doc translation on the device: s2d is the
    [capacity] int64 doc-id column, and the result is the fused [B, 3k]
    int32 layout (ops/topk.translate_pack) that leaves the card in one
    transfer."""
    top, idx = gmin_topk(store, sq_norms, tombs, n, q, allow_words, use_allow,
                         k, metric, rg, active_g, rescore_blk)
    return translate_pack(top, idx, s2d)
