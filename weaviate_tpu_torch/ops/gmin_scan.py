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
version, `group_min_scores_reference`, for tensors on the CPU. The store
is f32 (the uncompressed index) or bf16 (the rescore copy of the
PQ-compressed index); the kernel has one tile filler for each. It keeps a
store tile of S slices x SCG group columns resident in shared memory for
its whole life (`csrc/gmin_resident.cuh`, shared with K2 and K3), and
`resident_plan` sizes that tile for all four kernels: depths past it (D >
6208) have no plan, and the index routes them to its chunked scan (the
reference's counterpart is its VMEM plan, `fits_vmem`, which refuses an
f32 store from about D 722 at 16 live slices). Around the kernel, plain
torch ops do what the JAX package left to XLA: the group selection is an
exact `torch.topk` (the TPU used approx_min_k at recall target 0.99), then
a block gather and the exact f32 rescore, in query blocks that bound the
gather (`topk.query_block`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops import _kernels
from weaviate_tpu_torch.ops.topk import (bitmap_to_mask, pack_topk, query_block,
                                         rescore_distances, smallest_k,
                                         translate_pack)

G = 16  # group size (store slices)

# launches of the CUDA kernel by group_min_scores (never the CPU path):
# a run reads it to show that its searches went through the kernel
launches = 0

# The resident-tile plan of K1, K1-bf16, K2 and K3; csrc/gmin_resident.cuh
# checks the same numbers.
SMEM_LIMIT = 232_448   # bytes of shared memory one block may use on sm_90
RING_BYTES = 32_768    # the ring of bf16 query tiles streamed past the store tile
RING_STAGES = 4        # ... in this many stages, two per consumer warpgroup
SMEM_RESERVE = 1_024   # mbarriers and the 1024-byte alignment of the tiles
SMEM_BIAS_WIDTH = 256  # tiles this wide keep their bias in shared memory (4 bytes a row)
DEPTH_STEP = 64        # the tiles' depth is padded to a multiple of 64 (128 bytes)
QUERY_ROWS = 128       # the bf16 query scratch is padded to a multiple of 128 rows
WIDTHS = (256, 128, 64, 32, 16)  # tile rows N = S * SCG: the wgmma widths


class ResidentPlan(NamedTuple):
    """One resident store tile: `slices` (S, the least power of two >= the
    live slices) x `scg` group columns of bf16 rows padded to depth `dp`,
    `smem` bytes of shared memory with the query ring."""
    slices: int
    scg: int
    dp: int
    smem: int

    @property
    def width(self) -> int:
        return self.slices * self.scg


_lib = None


def _gmin_lib():
    global _lib
    if _lib is None:
        lib = _kernels.load("gmin_scan")
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.gmin_scan_launch, lib.gmin_scan_bf16_launch):
            fn.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ci, ctypes.c_float, ci, ci, ci, vp]
            fn.restype = ctypes.c_int
        lib.gmin_scan_error_string.argtypes = [ctypes.c_int]
        lib.gmin_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _live_slices(active_g: int, g: int) -> int:
    return max(1, min(int(active_g), g))


def tile_slices(active_g: int) -> int:
    """S: the least power of two >= active_g live slices (1 .. 16)."""
    s = 1
    while s < min(max(int(active_g), 1), G):
        s *= 2
    return s


def resident_plan(d: int, active_g: int = G) -> Optional[ResidentPlan]:
    """The resident-tile plan for depth d and active_g live slices, or None
    when no tile fits (d > 6208). The tile holds S = the least power of two
    >= active_g slices, at most 16, and N = S * SCG rows of bf16 padded to
    dp = roundup(d, 64): N is the widest of WIDTHS whose tile fits in
    shared memory beside the query ring."""
    dp = -(-d // DEPTH_STEP) * DEPTH_STEP
    s = tile_slices(active_g)
    for n in WIDTHS:
        smem = (n * dp * 2 + RING_BYTES + (4 * n if n >= SMEM_BIAS_WIDTH else 0)
                + SMEM_RESERVE)
        if smem <= SMEM_LIMIT:
            return ResidentPlan(s, n // s, dp, smem)
    return None


def query_scratch(q: torch.Tensor, plan: ResidentPlan) -> torch.Tensor:
    """The [roundup(B, 128), dp] bf16 scratch a resident-tile kernel rounds
    the queries into (zeros past B and D), so every TMA row is aligned."""
    return torch.empty((-(-q.shape[0] // QUERY_ROWS) * QUERY_ROWS, plan.dp),
                       dtype=torch.bfloat16, device=q.device)


def no_plan_error(d: int) -> ValueError:
    return ValueError(f"D={d}: the resident store tile does not fit in shared memory even "
                      "at one group column per block (the routers send this depth to "
                      "another scan)")


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
    """[B, D] f32 queries x [G, ncols, D] f32 or bf16 store view ->
    [B, ncols] group-min scores over the first active_g slices (slots fill
    in order, so slices past ceil(n/ncols) hold no live slot and are never
    read).

    On a CUDA tensor this launches the Hopper kernel with
    resident_plan(D, active_g) and raises if D has no plan or the launch
    fails; on a CPU tensor it runs group_min_scores_reference."""
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
    for name, t, dtypes in (("q", q, (torch.float32,)),
                            ("store3", store3, (torch.float32, torch.bfloat16)),
                            ("bias2", bias2, (torch.float32,))):
        if t.dtype not in dtypes or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {' or '.join(map(str, dtypes))} "
                             f"tensor on {q.device}")
    if g > G:
        raise ValueError(f"the kernel takes at most {G} store slices, got {g}")
    ag = _live_slices(active_g, g)
    plan = resident_plan(d, ag)
    if plan is None:
        raise no_plan_error(d)
    out = torch.empty((b, ncols), dtype=torch.float32, device=q.device)
    if b == 0 or ncols == 0:
        return out
    q_bf16 = query_scratch(q, plan)
    qvec4 = d % 4 == 0 and q.data_ptr() % 16 == 0
    lib = _gmin_lib()
    if store3.dtype == torch.bfloat16:
        launch, svec = lib.gmin_scan_bf16_launch, d % 8 == 0 and store3.data_ptr() % 16 == 0
    else:
        launch, svec = lib.gmin_scan_launch, d % 4 == 0 and store3.data_ptr() % 16 == 0
    rc = launch(q.data_ptr(), store3.data_ptr(), bias2.data_ptr(), q_bf16.data_ptr(),
                out.data_ptr(), b, ncols, d, ag, float(alpha), plan.scg, int(qvec4), int(svec),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise _kernels.launch_error("gmin_scan kernel launch failed", rc,
                                    lib.gmin_scan_error_string(rc).decode())
    launches += 1
    return out


def scan_bias(tombs, n, norms, allow_words, use_allow, metric) -> tuple[torch.Tensor, float]:
    """-> ([G, ncols] bias, alpha) of the unified score over a [cap] slot
    space: +inf for dead slots (tombstoned, at or past n, filtered out);
    l2: the rows' squared norms, alpha -2; dot/cosine: 0, alpha -1 (rows
    pre-normalized at insert for cosine)."""
    cap = tombs.shape[0]
    dead = tombs | (torch.arange(cap, device=tombs.device) >= n)
    if use_allow:
        dead = dead | ~bitmap_to_mask(allow_words, cap)
    if metric == vi.DISTANCE_L2:
        base, alpha = norms, -2.0
    else:
        base, alpha = torch.zeros(cap, dtype=torch.float32, device=tombs.device), -1.0
    return torch.where(dead, float("inf"), base).view(G, cap // G), alpha


def build_rescore_blocks(store: torch.Tensor) -> torch.Tensor:
    """[cap, D] store (f32 or bf16) -> [ncols, G*D] group-block layout: row `col` holds
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
    bias2, alpha = scan_bias(tombs, n, sq_norms, allow_words, use_allow, metric)
    gmin = group_min_scores(q, store.view(G, ncols, dim), bias2, alpha,
                            active_g=active_g)
    _, gidx = smallest_k(gmin, rg)

    # expand each kept group to its member slots and rescore exactly, in
    # query blocks that bound the [block, rg*G, D] gather; the members'
    # bias rides the same block gather
    offs = torch.arange(G, device=dev) * ncols
    bias_blk = bias2.T.contiguous()  # [ncols, G]
    tops, idxs = [], []
    step = query_block(rg * G, dim)
    for s in range(0, b, step):
        q_ = q[s: s + step]
        gidx_ = gidx[s: s + step]
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


def search_gmin(store, sq_norms, tombs, n, q, allow_words, use_allow, k, metric, rg,
                active_g=G, rescore_blk=None):
    """gmin_topk packed into the staged [B, 2k] int32 layout
    (ops/topk.pack_topk): slot indices, translated to doc ids on the
    host."""
    top, idx = gmin_topk(store, sq_norms, tombs, n, q, allow_words, use_allow,
                         k, metric, rg, active_g, rescore_blk)
    return pack_topk(top, idx)


def search_gmin_fused(store, sq_norms, tombs, n, q, allow_words, s2d, use_allow,
                      k, metric, rg, active_g=G, rescore_blk=None):
    """gmin_topk with the slot->doc translation on the device: s2d is the
    [capacity] int64 doc-id column, and the result is the fused [B, 3k]
    int32 layout (ops/topk.translate_pack) that leaves the card in one
    transfer."""
    top, idx = gmin_topk(store, sq_norms, tombs, n, q, allow_words, use_allow,
                         k, metric, rg, active_g, rescore_blk)
    return translate_pack(top, idx, s2d)
