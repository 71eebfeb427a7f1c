"""Batched distance functions in torch (twin of `weaviate_tpu/ops/distances.py`).

Reference semantics (adapters/repos/db/vector/hnsw/distancer/):
- l2-squared: sum((a-b)^2)
- dot: -dot(a,b)  (negative so that smaller = closer)
- cosine: 1 - dot(a_norm, b_norm); vectors are normalized once at insert and
  at query time, then treated as dot
- manhattan: sum(|a-b|)
- hamming: count(a[i] != b[i])

dot/cosine/l2 expand to one Q @ X^T product in full float32. On the card
that needs TF32 off for matmul, which is torch's default; the port never
changes the process-wide flag, and `require_full_f32` raises if a caller
turned it on. Manhattan/hamming have no matmul form; they stream X in
chunks so the broadcast buffer stays bounded.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from weaviate_tpu_torch.entities import vectorindex as vi

# chunk of stored vectors processed per step for non-matmul metrics
_STREAM_CHUNK = 4096


def require_full_f32(device: torch.device) -> None:
    """Raise if float32 matmuls on `device` would run as TF32, which keeps
    about three decimal digits: too few for ranking distances."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 distances need TF32 off for matmul (torch's default); "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")


def normalize_rows(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """L2-normalize rows (cosine is normalize-then-dot)."""
    norm = torch.sqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps)).to(x.dtype)


def _matmul(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    require_full_f32(q.device)
    return torch.matmul(q.float(), x.float().T)


def _dot_dists(q, x, x_sq_norms):
    return -_matmul(q, x)


def _cosine_dists(q, x, x_sq_norms):
    # caller guarantees both sides are normalized; 1 - dot
    return 1.0 - _matmul(q, x)


def _l2_dists(q, x, x_sq_norms):
    # ||q-x||^2 = ||q||^2 - 2 q.x + ||x||^2
    qx = _matmul(q, x)
    q_sq = torch.sum(q.float() ** 2, dim=-1, keepdim=True)
    if x_sq_norms is None:
        x_sq_norms = torch.sum(x.float() ** 2, dim=-1)
    d = q_sq - 2.0 * qx + x_sq_norms[None, :]
    return torch.clamp(d, min=0.0)


def _streamed(elem_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """[B, N] distance fn over N-chunks of x; elem_fn(q[B,1,D],
    xc[1,C,D]) -> [B, C]."""

    def fn(q, x, x_sq_norms):
        qf = q.float()[:, None, :]
        parts = [elem_fn(qf, x[s: s + _STREAM_CHUNK].float()[None, :, :])
                 for s in range(0, x.shape[0], _STREAM_CHUNK)]
        if not parts:
            return torch.zeros((q.shape[0], 0), dtype=torch.float32, device=q.device)
        return torch.cat(parts, dim=1)

    return fn


_manhattan_dists = _streamed(lambda q, xc: torch.sum(torch.abs(q - xc), dim=-1))
_hamming_dists = _streamed(lambda q, xc: torch.sum((q != xc).float(), dim=-1))


DISTANCE_FNS: dict[str, Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]] = {
    vi.DISTANCE_DOT: _dot_dists,
    vi.DISTANCE_COSINE: _cosine_dists,
    vi.DISTANCE_L2: _l2_dists,
    vi.DISTANCE_MANHATTAN: _manhattan_dists,
    vi.DISTANCE_HAMMING: _hamming_dists,
}


def pairwise_distances(q: torch.Tensor, x: torch.Tensor, metric: str = vi.DISTANCE_L2,
                       x_sq_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, D] queries x [N, D] store -> [B, N] float32 distances. For
    cosine, q and x must already be row-normalized."""
    return DISTANCE_FNS[metric](q, x, x_sq_norms)


def single_distance(a, b, metric: str = vi.DISTANCE_L2) -> float:
    """Scalar host-side distance (distancer/provider.go:14 SingleDist)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    if metric == vi.DISTANCE_L2:
        d = a - b
        return float(np.dot(d, d))
    if metric == vi.DISTANCE_DOT:
        return float(-np.dot(a, b))
    if metric == vi.DISTANCE_COSINE:
        na = np.linalg.norm(a) or 1.0
        nb = np.linalg.norm(b) or 1.0
        return float(1.0 - np.dot(a, b) / (na * nb))
    if metric == vi.DISTANCE_MANHATTAN:
        return float(np.sum(np.abs(a - b)))
    if metric == vi.DISTANCE_HAMMING:
        return float(np.sum(a != b))
    raise ValueError(f"unknown metric {metric!r}")
