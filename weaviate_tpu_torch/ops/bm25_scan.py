"""Device-side BM25 scoring over dense per-term impact rows (twin of
`weaviate_tpu/ops/bm25_scan.py`).

Each scoring unit (one property x term) becomes a dense f32 impact row
over the padded doc-id space: row[d] is the unit's whole BM25
contribution for doc d (idf, weight, tf saturation and length norm
folded in), zero where the doc has no posting. A query sums its rows,
masks them and takes one top-k; a batch of queries is one [Q, U] x [U, n]
product. Plain torch ops on the engine's device: the reference's
programs are XLA, not Pallas, so no hand-written kernel runs here.

Scores are f32 on the device (the host engine's are f64); the row build
is an `index_add_` (atomic adds on the card), so sums of duplicate ids
may differ from the reference in the last bits. Selection breaks ties
toward the lower doc id, as the reference's `lax.top_k` does.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.ops import topk as topk_ops
from weaviate_tpu_torch.ops.distances import require_full_f32

# doc-capacity bucket: dense rows are padded to a multiple of this, so a
# row built for one query serves the next while the corpus grows
_N_BUCKET = 16384

# query rows per batched product step: bounds the [Q, n] totals block
_QCHUNK = 32


def n_bucket(max_doc_id: int) -> int:
    """Padded dense-row length for a corpus whose largest doc id is
    max_doc_id (-1 for empty)."""
    need = max(int(max_doc_id) + 1, 1)
    return ((need + _N_BUCKET - 1) // _N_BUCKET) * _N_BUCKET


def k_bucket(k: int) -> int:
    """k rounded up to a power of two (limit/offset changes share a k)."""
    b = 1
    while b < k:
        b <<= 1
    return b


def pad_postings(ids, scores, n_pad: int):
    """Pad (ids, scores) to the next power-of-two length with drop-slot
    sentinels (id n_pad, score 0), as the reference does."""
    want = k_bucket(max(int(ids.size), 1))
    if want == ids.size:
        return ids, scores
    pad = want - ids.size
    ids = np.concatenate([ids, np.full(pad, n_pad, dtype=ids.dtype)])
    scores = np.concatenate([scores, np.zeros(pad, dtype=scores.dtype)])
    return ids, scores


def build_dense_row(ids: torch.Tensor, scores: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Scatter one unit's scaled posting scores into a dense row: ids [L]
    int64 (pad slots point at n_pad, one past the row), scores [L] f32 ->
    [n_pad] f32. Duplicate ids accumulate; the extra last slot takes the
    pads and is sliced off."""
    row = torch.zeros(n_pad + 1, dtype=torch.float32, device=scores.device)
    row.index_add_(0, ids, scores)
    return row[:-1]


def add_rows(acc: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Pairwise row accumulation (a query's units summed in order)."""
    return acc + row


def _topk_packed(totals: torch.Tensor, k: int) -> torch.Tensor:
    """[R, n] summed scores -> packed [R, 2k] int32 (score bits, then doc
    ids), score-descending with ties to the lower doc id (the order of
    `lax.top_k`, which `torch.topk` does not promise; BM25 ties by
    nature); empty slots are score 0 / id -1 (BM25 scores are positive,
    so 0 is a safe floor).

    The selection key is the score in f64 scaled by (1 - id * 2^-50): for
    rows under 2^26 docs the relative step stays under 2^-24, so it never
    reorders two f32 scores, and between equal ones (each id 4 f64 ulps
    apart) it puts the lower id first."""
    if totals.shape[1] >= 1 << 26:
        raise ValueError(f"dense rows of {totals.shape[1]} docs: the tie-break key holds 2^26")
    ids = torch.arange(totals.shape[1], dtype=torch.float64, device=totals.device)
    key = totals.double() * (1.0 - ids * 2.0 ** -50)
    ids = torch.topk(key, k, dim=1, largest=True, sorted=True).indices
    scores = torch.gather(totals, 1, ids)
    ids = torch.where(scores > 0.0, ids, -1).to(torch.int32)
    return topk_ops.pack_topk(scores, ids)


def dense_topk(total: torch.Tensor, k: int, allow_mask=None) -> torch.Tensor:
    """total [n] f32 (+ optional allow_mask [n] bool) -> packed [2k] int32,
    the layout of ops/topk.pack_topk: one device->host fetch."""
    if allow_mask is not None:
        total = torch.where(allow_mask, total, 0.0)
    return _topk_packed(total[None, :], k)[0]


def unpack_topk(packed, k: int):
    """Host-side inverse of dense_topk -> (scores f32 [k], ids int32 [k])."""
    scores, ids = topk_ops.unpack_topk(np.asarray(packed)[None, :])
    return scores[0], ids[0]


def batch_topk(rows: torch.Tensor, sel: torch.Tensor, k: int) -> torch.Tensor:
    """Batched keyword scoring as one f32 product per _QCHUNK queries:
    rows [U, n] stacked impact rows, sel [Q, U] f32 (1.0 where unit u
    scores query q, repeated units added) -> packed [Q, 2k] int32 (the
    dense_topk packing per row). TF32 is refused: scores keep f32."""
    require_full_f32(rows.device)
    return torch.cat([_topk_packed(sel[s: s + _QCHUNK] @ rows, k)
                      for s in range(0, sel.shape[0], _QCHUNK)])
