"""Masked top-k, candidate merging, result packing (the staged [B, 2k]
layout and the fused [B, 3k] one) and the device slot->doc translation
(twin of `weaviate_tpu/ops/topk.py`).

Smallest-k selection is `torch.topk(..., largest=False)`, which returns
its k values in ascending order. Ties between equal finite distances may
come out in another order than `lax.top_k`'s lower-index-first; the
parity tests use tie-free data. Masked-out slots surface as +inf with
index -1 in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.entities import vectorindex as vi

INF = float("inf")

# a missing result slot: doc id -1 as int64, 2**64-1 once viewed as uint64
# on the host (the JAX package's all-ones sentinel words)
MISSING_DOC = -1

# the candidate rescores run in query blocks of at most this many rows,
# fewer where a block's [rows, candidates, D] f32 gather would pass
# _BLOCK_BYTES (the port's bound on one intermediate; the JAX programs
# build the whole batch's gather at once)
RESCORE_BLOCK = 2048
_BLOCK_BYTES = 2 << 30


def query_block(cands: int, dim: int) -> int:
    """Query rows per rescore block for `cands` candidates of `dim` f32
    values each."""
    return max(1, min(RESCORE_BLOCK, _BLOCK_BYTES // max(cands * dim * 4, 1)))


def smallest_k(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (values [B, k] ascending, positions [B, k] int64) of the k
    smallest entries of each row."""
    return torch.topk(d, k, dim=1, largest=False, sorted=True)


def masked_top_k(dists: torch.Tensor, valid_mask: torch.Tensor, k: int,
                 allow_mask: Optional[torch.Tensor] = None):
    """dists [B, N] + valid_mask [N] bool (+ optional allow_mask [N] or
    [B, N]) -> (top_dists [B, k], top_idx [B, k] int32). Masked-out slots
    surface as +inf distance with index -1."""
    mask = valid_mask[None, :]
    if allow_mask is not None:
        allow = allow_mask if allow_mask.dim() == 2 else allow_mask[None, :]
        mask = mask & allow
    masked = torch.where(mask, dists, INF)
    top, idx = smallest_k(masked, k)
    idx = torch.where(torch.isinf(top), -1, idx)
    return top, idx.to(torch.int32)


def merge_top_k(dists_a, idx_a, dists_b, idx_b, k: int):
    """Merge two [B, k'] top-k candidate sets into one [B, k] (reference
    index.go:1040-1046, vectorized)."""
    d = torch.cat([dists_a, dists_b], dim=1)
    i = torch.cat([idx_a, idx_b], dim=1)
    top, pos = smallest_k(d, k)
    return top, torch.gather(i, 1, pos)


def pack_topk(top: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pack (dists f32, slot idx) [B, k] each into one [B, 2k] int32
    tensor, the distances as their bit pattern, so the host needs a single
    device->host fetch (the staged dispatch's layout)."""
    return torch.cat([top.contiguous().view(torch.int32), idx.to(torch.int32)], dim=1)


def unpack_topk(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of pack_topk: np [B, 2k] i32 -> (dists f32 [B, k],
    slot idx i32 [B, k]), both views into the fetched buffer."""
    k = packed.shape[1] // 2
    return packed[:, :k].view("<f4"), packed[:, k:]


def translate_pack(top: torch.Tensor, idx: torch.Tensor, s2d: torch.Tensor) -> torch.Tensor:
    """The final top-k's slot->doc translation, on the device, packed with
    the distances into one fetchable buffer.

    top [B, k] f32, idx [B, k] slot indices (-1 = missing), s2d
    [capacity] int64 doc id per slot (-1 = unwritten). The doc ids live in
    one int64 column: the JAX package's [capacity, 2] uint32 word table
    exists only because jax may run without 64-bit integers. The returned
    layout is the JAX package's FUSED one,

        [B, 3k] int32 = [ dists (f32 bits) | id low words | id high words ]

    so `unpack_fused` reads both packages' buffers the same way."""
    b, k = idx.shape
    safe = torch.clamp(idx.long(), 0, s2d.shape[0] - 1)
    ids = torch.where(idx < 0, MISSING_DOC, s2d[safe])
    words = ids.contiguous().view(torch.int32).reshape(b, k, 2)
    return torch.cat([top.contiguous().view(torch.int32),
                      words[..., 0], words[..., 1]], dim=1)


def retranslate_packed(packed: torch.Tensor, s2d: torch.Tensor) -> torch.Tensor:
    """pack_topk layout -> the fused layout of translate_pack, on the
    device: a packed result gains the slot->doc translation."""
    kc = packed.shape[1] // 2
    top = packed[:, :kc].contiguous().view(torch.float32)
    return translate_pack(top, packed[:, kc:], s2d)


def unpack_fused(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of translate_pack: np [B, 3k] i32 -> (ids u64
    [B, k], dists f32 [B, k])."""
    k = packed.shape[1] // 3
    dists = packed[:, :k].view("<f4")
    ids = np.empty((packed.shape[0], k), "<u8")
    w = ids.view("<u4").reshape(packed.shape[0], k, 2)
    w[..., 0] = packed[:, k: 2 * k].view("<u4")
    w[..., 1] = packed[:, 2 * k:].view("<u4")
    return ids, dists


def rescore_distances(cand: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """Exact f32 distances of gathered candidates: cand [B, R, D] vs
    q [B, D] -> [B, R] (the shared rescore core of the scan paths)."""
    qf = q.float()[:, None, :]
    c = cand.float()
    if metric == vi.DISTANCE_L2:
        return torch.sum((c - qf) ** 2, dim=-1)
    if metric == vi.DISTANCE_DOT:
        return -torch.sum(c * qf, dim=-1)
    return 1.0 - torch.sum(c * qf, dim=-1)  # cosine: rows pre-normalized


def bitmap_to_mask(bitmap_words: torch.Tensor, n: int) -> torch.Tensor:
    """Expand packed 32-bit filter words [ceil(N/32)] into a bool mask [N]
    (bit i of word w = slot 32w+i). The words ride as int32: an arithmetic
    shift of bit 31 still leaves it in the low bit."""
    w = bitmap_words.to(torch.int32)
    bits = torch.arange(32, dtype=torch.int32, device=w.device)
    expanded = (w[:, None] >> bits[None, :]) & 1
    return expanded.reshape(-1)[:n].to(torch.bool)
