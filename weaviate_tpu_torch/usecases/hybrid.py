# The port's copy of weaviate_tpu/usecases/hybrid.py, its imports pointed at the port.
"""Hybrid search fusion.

Reference: usecases/traverser/hybrid/rank_fusion.go — FusionScoreCombSUM
(min-max-normalized weighted score sum) and FusionReciprocal (reciprocal-rank
fusion, k=60), alpha weighting dense vs sparse, explainScore breadcrumbs.
"""

from __future__ import annotations

from typing import Optional

FUSION_RANKED = "rankedFusion"        # RRF (the 1.19 default)
FUSION_RELATIVE_SCORE = "relativeScoreFusion"  # CombSUM on normalized scores

RRF_K = 60.0


def _key(r) -> str:
    return r.obj.uuid


def fusion_reciprocal(sparse: list, dense: list, alpha: float) -> list:
    """RRF: score = sum over result sets of weight / (k + rank)
    (rank_fusion.go FusionReciprocal)."""
    scores: dict[str, float] = {}
    explain: dict[str, list[str]] = {}
    by_id: dict[str, object] = {}
    for weight, results, label in ((1 - alpha, sparse, "keyword"), (alpha, dense, "vector")):
        if weight == 0:
            continue
        for rank, r in enumerate(results):
            u = _key(r)
            add = weight / (RRF_K + rank + 1)
            scores[u] = scores.get(u, 0.0) + add
            explain.setdefault(u, []).append(
                f"{label}: original rank {rank + 1}, contributes {add:.6f}"
            )
            prev = by_id.get(u)
            if prev is None:
                by_id[u] = r
            else:
                _merge_result(prev, r)
    return _finalize(scores, explain, by_id)


def fusion_score_combsum(sparse: list, dense: list, alpha: float) -> list:
    """Relative-score fusion: min-max normalize each result set's scores,
    then weighted sum (rank_fusion.go FusionScoreCombSUM)."""
    scores: dict[str, float] = {}
    explain: dict[str, list[str]] = {}
    by_id: dict[str, object] = {}
    for weight, results, label in ((1 - alpha, sparse, "keyword"), (alpha, dense, "vector")):
        if weight == 0 or not results:
            continue
        raw = [
            (r.score if label == "keyword" else _dense_score(r)) or 0.0 for r in results
        ]
        lo, hi = min(raw), max(raw)
        for r, s in zip(results, raw):
            u = _key(r)
            # all-equal (incl. single-result) leg: everyone is a full match,
            # not a zero match
            norm = (s - lo) / (hi - lo) if hi > lo else 1.0
            add = weight * norm
            scores[u] = scores.get(u, 0.0) + add
            explain.setdefault(u, []).append(
                f"{label}: normalized score {norm:.4f}, contributes {add:.6f}"
            )
            prev = by_id.get(u)
            if prev is None:
                by_id[u] = r
            else:
                _merge_result(prev, r)
    return _finalize(scores, explain, by_id)


def _dense_score(r) -> float:
    # convert distance to a bigger-is-better score
    if r.distance is None:
        return 0.0
    return 1.0 / (1.0 + max(r.distance, 0.0))


def _merge_result(dst, src) -> None:
    if dst.distance is None and src.distance is not None:
        dst.distance = src.distance
    if dst.score is None and src.score is not None:
        dst.score = src.score


def _finalize(scores, explain, by_id) -> list:
    out = []
    for u, s in sorted(scores.items(), key=lambda kv: -kv[1]):
        r = by_id[u]
        r.score = s
        r.explain_score = "; ".join(explain[u])
        out.append(r)
    return out


def fuse(sparse: list, dense: list, alpha: float, fusion_type: Optional[str]) -> list:
    if fusion_type == FUSION_RELATIVE_SCORE:
        return fusion_score_combsum(sparse, dense, alpha)
    return fusion_reciprocal(sparse, dense, alpha)
