"""The plain reference: exact k-nearest neighbours by brute force, and the
comparison that judges what the clients received.

Plain PyTorch and NumPy. It imports nothing of the program and takes
nothing the program made: the rows and queries come from `gen.py`, the
program's answers (ids and distances as the clients got them) are only
judged. Top-k runs in float32 with TF32 off, in blocks of queries; the
distances it judges by are recomputed in float64.
"""

from __future__ import annotations

import numpy as np
import torch

QUERY_BLOCK = 1024


def _prepared(x: np.ndarray, metric: str) -> np.ndarray:
    if metric == "cosine":
        x = x.astype(np.float64)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float64)


def distances64(q: np.ndarray, x: np.ndarray, ids: np.ndarray, metric: str) -> np.ndarray:
    """[m, j] float64 distances of query i to row ids[i, j] (ids >= 0)."""
    q64 = _prepared(q, metric)
    rows = _prepared(x[ids.reshape(-1)], metric).reshape(ids.shape + (x.shape[1],))
    dot = np.einsum("md,mjd->mj", q64, rows)
    if metric == "cosine":
        return 1.0 - dot
    if metric == "dot":
        return -dot
    if metric == "l2-squared":
        return ((rows - q64[:, None, :]) ** 2).sum(-1)
    raise ValueError(f"the reference has no distance {metric!r}")


def topk(q: np.ndarray, x: np.ndarray, k: int, metric: str, device="cpu",
         round_rows=None) -> tuple[np.ndarray, np.ndarray]:
    """Brute-force top-k in float32 -> (ids [m, k] int64, distances [m, k]
    as computed). `round_rows`, applied to the rows and the queries before
    the product, gives the lower-precision controls."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xd = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        qd_all = torch.from_numpy(np.ascontiguousarray(q)).to(device)
        if metric == "cosine":
            xd = xd / xd.norm(dim=1, keepdim=True)
            qd_all = qd_all / qd_all.norm(dim=1, keepdim=True)
        if round_rows is not None:
            xd, qd_all = round_rows(xd), round_rows(qd_all)
        sq = (xd ** 2).sum(1) if metric == "l2-squared" else None
        ids, dists = [], []
        for s in range(0, len(q), QUERY_BLOCK):
            qd = qd_all[s:s + QUERY_BLOCK]
            dot = qd @ xd.T
            if metric == "cosine":
                d = 1.0 - dot
            elif metric == "dot":
                d = -dot
            else:
                d = (qd ** 2).sum(1, keepdim=True) - 2.0 * dot + sq[None, :]
            top = torch.topk(d, k, dim=1, largest=False)
            ids.append(top.indices.cpu().numpy())
            dists.append(top.values.cpu().numpy())
        return np.concatenate(ids), np.concatenate(dists)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def truth(q: np.ndarray, x: np.ndarray, k: int, metric: str, device="cpu",
          depth: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """The exact top-k: f32 candidates k + depth deep, ordered again in
    float64 -> (ids [m, k], float64 distances [m, k])."""
    cand, _ = topk(q, x, min(k + depth, len(x)), metric, device)
    d64 = distances64(q, x, cand, metric)
    order = np.argsort(d64, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(cand, order, 1), np.take_along_axis(d64, order, 1))


def scale(q: np.ndarray, x: np.ndarray, metric: str) -> np.ndarray:
    """[m] the size a distance of query i is measured against: 1 for
    cosine (unit rows), |q| times the median row norm for dot, and the
    median squared row norm for l2."""
    if metric == "cosine":
        return np.ones(len(q))
    med = float(np.median(np.linalg.norm(x[:: max(1, len(x) // 65536)], axis=1)))
    if metric == "dot":
        return np.linalg.norm(q.astype(np.float64), axis=1) * med
    return np.full(len(q), med * med)


def judge(q: np.ndarray, x: np.ndarray, k: int, metric: str, got_ids: np.ndarray,
          got_dists: np.ndarray, true_ids: np.ndarray, true_d: np.ndarray,
          order_tol: float = 0.0) -> dict:
    """Readings of the answers to q ([m, k] ids, -1 where a result is
    missing or names no stored row; the distances as received):
      bad: answers that are short, name a row that does not exist, name a
        row twice, or whose received distances fall from one result to the
        next by more than `order_tol` of the query's scale;
      order_gap: the widest such fall, over the scale;
      dist_gap: the widest gap between a received distance and the
        reference's distance of the row it names, over the query's scale;
      kth_gap: the widest amount by which an answer's farthest row (by the
        reference) lies past the true k-th distance, over the same scale;
      recall: the mean share of the true top-k among the answers."""
    ok = got_ids >= 0
    srt = np.sort(got_ids, axis=1)
    repeated = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(axis=1)
    safe = np.where(ok, got_ids, 0)
    ref_d = distances64(q, x, safe, metric)
    s = scale(q, x, metric)[:, None]
    got64 = got_dists.astype(np.float64)
    fall = np.where(ok[:, 1:] & ok[:, :-1], got64[:, :-1] - got64[:, 1:], 0.0) / s
    fall = fall.max(axis=1) if fall.shape[1] else np.zeros(len(q))
    bad = int((~ok.all(axis=1) | repeated | (fall > order_tol)).sum())
    gap = np.where(ok, np.abs(got64 - ref_d) / s, 0.0)
    worst = np.where(ok, ref_d, -np.inf).max(axis=1)
    kth = np.maximum(worst - true_d[:, k - 1], 0.0) / s[:, 0]
    hits = [len(set(g[o].tolist()) & set(t.tolist()))
            for g, o, t in zip(got_ids, ok, true_ids)]
    return {"bad": bad, "dist_gap": float(gap.max()) if gap.size else 0.0,
            "kth_gap": float(kth.max()) if kth.size else 0.0,
            "order_gap": float(max(fall.max(), 0.0)) if fall.size else 0.0,
            "recall": float(np.mean(hits) / k) if hits else 0.0}


def bf16_rows(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def fp8_rows(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 per row: each row scaled so its largest |value| is 448."""
    sc = t.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 448.0
    return (t / sc).to(torch.float8_e4m3fn).float() * sc


CONTROLS = {"bfloat16": bf16_rows, "fp8_e4m3": fp8_rows}
