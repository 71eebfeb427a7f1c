"""t-SNE feature projection on the module's device (twin of
`weaviate_tpu/ops/tsne.py`).

The reference's `featureProjection` additional prop runs go-tsne over the
result set's vectors (modules/text2vec-contextionary/additional/projector/
projector.go). Result sets are small (tens to a few hundred rows), so this
is a latency problem, not a throughput one: the O(n^2 d) affinity/gradient
math stays as dense [n, n] tensor ops on the device, P and the initial
layout go up once, the whole gradient descent runs with no host sync
inside it (the iteration-dependent knobs are Python values, the
trust-region cap a tensor expression), and one device-to-host copy brings
the layout back.

The step is the JAX program's, op for op: `diff` keeps the [n, n, dims]
broadcast (dims <= 3) rather than a cdist or a matmul expansion, which
would change the arithmetic (and on the card, through TF32, change it
again); no op of the loop uses atomics, so two runs on one device give the
same bits. The f32 summation order is the backend's own, and momentum
amplifies its last-bit differences: the port tracks the JAX program
closely for tens of iterations and drifts from it after hundreds, while
both keep the layout's structure.

Determinism: Y is initialized from the top principal components of X (no
RNG), so the same result set always projects to the same layout — the
property the reference gets by seeding go-tsne.
"""

from __future__ import annotations

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve_device


def _affinities(x: np.ndarray, perplexity: float) -> np.ndarray:
    """Symmetrized t-SNE input affinities P (numpy: n is tiny and the
    per-point sigma binary search is branchy host logic)."""
    n = x.shape[0]
    d2 = np.square(x[:, None, :] - x[None, :, :]).sum(-1)
    target = np.log(max(perplexity, 1.0001))
    p = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        lo, hi = 1e-20, 1e20
        beta = 1.0
        di = np.delete(d2[i], i)
        for _ in range(50):
            w = np.exp(-di * beta)
            s = w.sum()
            if s <= 0:
                h = 0.0
            else:
                pi = w / s
                h = -(pi * np.log(np.maximum(pi, 1e-30))).sum()
            if abs(h - target) < 1e-5:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi >= 1e20 else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo <= 1e-20 else (beta + lo) / 2
        w = np.exp(-d2[i] * beta)
        w[i] = 0.0
        s = w.sum()
        p[i] = w / s if s > 0 else 0.0
    p = (p + p.T) / (2.0 * n)
    return np.maximum(p, 1e-12).astype(np.float32)


def _pca_init(x: np.ndarray, dims: int) -> np.ndarray:
    """Deterministic PCA init scaled small (the usual 1e-4 t-SNE
    convention)."""
    xc = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    comps = vt[:dims] if vt.shape[0] >= dims else np.pad(vt, ((0, dims - vt.shape[0]), (0, 0)))
    y0 = (xc @ comps.T).astype(np.float32)
    scale = np.abs(y0).max()
    return y0 / (scale * 1e4) if scale > 0 else y0


def _descend(p: torch.Tensor, y0: torch.Tensor, iterations: int,
             learning_rate: float) -> torch.Tensor:
    """The gradient descent on p's device: early exaggeration (x12, momentum
    0.5) for the first quarter, then momentum 0.8; each point's step capped
    at a quarter of the embedding's spread."""
    n = p.shape[0]
    exaggeration_until = max(1, iterations // 4)
    off_diag = 1.0 - torch.eye(n, dtype=p.dtype, device=p.device)
    y, vel = y0, torch.zeros_like(y0)
    for i in range(iterations):
        early = i < exaggeration_until
        pe = p * 12.0 if early else p
        diff = y[:, None, :] - y[None, :, :]          # [n, n, dims]
        q_num = 1.0 / (1.0 + torch.sum(diff ** 2, dim=-1))
        q_num = q_num * off_diag
        q = torch.clamp_min(q_num / torch.sum(q_num), 1e-12)
        g = 4.0 * torch.sum(((pe - q) * q_num)[:, :, None] * diff, dim=1)
        vel = (0.5 if early else 0.8) * vel - learning_rate * g
        # trust region: cap each point's step at a fraction of the current
        # embedding spread. Small result sets have P entries of O(1) (vs
        # O(1/n) at scale), so the exaggerated attraction is an unstable
        # oscillator at any fixed learning rate — uncapped, one overshoot
        # flings cluster mates to opposite ends and the post-exaggeration
        # forces are too weak to recover.
        spread = torch.sqrt(torch.max(torch.sum(y ** 2, dim=-1))) + 1e-8
        vnorm = torch.sqrt(torch.sum(vel ** 2, dim=-1, keepdim=True))
        vel = vel * torch.clamp_max(0.25 * spread / torch.clamp_min(vnorm, 1e-30), 1.0)
        y = y + vel
        y = y - torch.mean(y, dim=0, keepdim=True)
    return y


def tsne_project(
    vectors: np.ndarray,
    dims: int = 2,
    perplexity: float = 0.0,
    iterations: int = 100,
    learning_rate: float = 25.0,
    device=None,
) -> np.ndarray:
    """Project [n, d] float vectors to [n, dims] with exact t-SNE on
    `device` (None: the card, which must exist; "cpu" on request).

    perplexity <= 0 selects the auto rule: min(5, (n-1)/3) with a floor of
    1 (projector.go defaultPerplexity-style guard, tightened to honor the
    n > 3*perplexity rule of thumb — at perplexity ~ n-1 the affinities go
    uniform and tiny result sets project to noise).
    n < 2 short-circuits (a single point projects to the origin).
    """
    dev = resolve_device(device)
    x = np.asarray(vectors, dtype=np.float32)
    n = x.shape[0]
    if n < 2:
        return np.zeros((n, dims), dtype=np.float32)
    if perplexity <= 0:
        perplexity = float(min(5.0, max(1.0, (n - 1) / 3.0)))
    perplexity = float(min(perplexity, n - 1))

    p = _affinities(x, perplexity)
    y0 = _pca_init(x, dims)
    with torch.inference_mode():
        y = _descend(torch.from_numpy(p).to(dev), torch.from_numpy(y0).to(dev),
                     int(iterations), float(learning_rate))
        return y.cpu().numpy()
