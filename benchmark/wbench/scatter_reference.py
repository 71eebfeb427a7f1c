"""The plain reference of a class searched over several shards: each
shard's exact top k, merged by distance, as a scatter-gather serves it.

Plain PyTorch in float64. It imports nothing of the program. The rows are
split by `part` (row i lives in shard part[i]; shard order is the order of
the shard numbers); every distance is exact in float64, computed in blocks
of rows so the whole of SIFT1M fits the card. Ties are ordered by distance,
then shard order, then row order in the shard, the order a stable merge of
the shards' sorted answers gives. Whatever the partition, the answers are
the exact top k of all the rows.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_BLOCK = 16384


def _prepared(t: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "cosine":
        return t / t.norm(dim=1, keepdim=True)
    return t


def distances(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """[m, n] exact distances of float64 queries q to float64 rows x (both
    prepared: unit rows for cosine)."""
    dot = q @ x.T
    if metric == "cosine":
        return 1.0 - dot
    if metric == "dot":
        return -dot
    if metric == "l2-squared":
        return (q * q).sum(1, keepdim=True) - 2.0 * dot + (x * x).sum(1)[None, :]
    raise ValueError(f"the reference has no distance {metric!r}")


def _sorted_merge(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row of d, ties in column order -> (d, ids)."""
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(ids, 1, order[:, :k])


def shard_topk(q: torch.Tensor, x: torch.Tensor, rows: torch.Tensor, k: int, metric: str,
               block: int = ROW_BLOCK):
    """One shard's exact top k: -> (distances [m, k'], row ids [m, k']),
    k' = min(k, len(rows)); ties in row order."""
    m = q.shape[0]
    best_d = torch.empty((m, 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((m, 0), dtype=torch.int64, device=q.device)
    for s in range(0, len(rows), block):
        r = rows[s:s + block]
        d = distances(q, x[r], metric)
        # the best so far hold only earlier rows: ties stay in row order
        best_d, best_i = _sorted_merge(torch.cat([best_d, d], 1),
                                       torch.cat([best_i, r[None, :].expand(m, -1)], 1), k)
    return best_d, best_i


def scatter_gather(q: np.ndarray, x: np.ndarray, part: np.ndarray, k: int, metric: str,
                   device="cpu", block: int = ROW_BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """Each shard's exact top k of the queries q ([m, D]) over its rows of
    x ([n, D]), merged to each query's k nearest -> (row ids [m, k'] int64,
    float64 distances [m, k']), k' = min(k, n)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        qd = _prepared(torch.as_tensor(np.asarray(q), dtype=torch.float64, device=device), metric)
        xd = _prepared(torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device), metric)
        pd = torch.as_tensor(np.asarray(part), device=device)
        ds, ids = [], []
        for shard in torch.unique(pd, sorted=True):
            rows = torch.nonzero(pd == shard).flatten()
            d, i = shard_topk(qd, xd, rows, k, metric, block)
            ds.append(d)
            ids.append(i)
        d, i = _sorted_merge(torch.cat(ds, 1), torch.cat(ids, 1), k)
        return i.cpu().numpy(), d.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
