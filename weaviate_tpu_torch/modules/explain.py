# The port's copy of weaviate_tpu/modules/explain.py, its imports pointed at the port; featureProjection's
# t-SNE runs on the module's `device`.
"""Explanation additional props: nearestNeighbors, semanticPath,
interpretation, featureProjection.

Reference: the contextionary module family resolves these against its
300k-word concept space (modules/text2vec-contextionary/additional/
{nearestneighbors/extender.go, sempath/builder.go, interpretation/
interpretation.go, projector/projector.go}; payload shapes in
additional/models/models.go).

Redesign: the reference needs a contextionary *service* because its concept
space lives in the sidecar. Here the explainer is a capability mixin over
the Vectorizer interface itself — the concept vocabulary is built from the
words of the result set (plus query concepts) and embedded through the same
`vectorize_text` path the module already has, so ANY vectorizer module
(local hash embedder, contextionary sidecar, HTTP sidecars) gains all four
props with zero extra service surface. featureProjection runs the device
t-SNE in ops/tsne.py on the module's device.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.interface import AdditionalProperties
from weaviate_tpu_torch.modules.provider import ModuleError

_TOKEN_RE = re.compile(r"[a-zA-Z][a-zA-Z0-9]+")
_MAX_VOCAB = 1024
_PATH_STEPS = 5

EXPLAIN_PROPS = (
    "nearestNeighbors",
    "semanticPath",
    "interpretation",
    "featureProjection",
)


def _result_text(r) -> str:
    props = getattr(r.obj, "properties", None) or {}
    return " ".join(str(v) for v in props.values() if isinstance(v, str))


def _result_vector(r) -> Optional[np.ndarray]:
    v = getattr(r.obj, "vector", None)
    if v is None:
        return None
    return np.asarray(v, dtype=np.float32)


def _unit(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-30)


class SemanticExplainer(AdditionalProperties):
    """Mixin for Vectorizer modules: the four contextionary-style
    explanation props, resolved per query over a result-derived vocab.

    `device` is where featureProjection's t-SNE runs: the Provider hands
    its own to every explainer it registers; None means the card."""

    device = None

    def additional_properties(self) -> list[str]:
        return list(EXPLAIN_PROPS)

    # -- vocab ---------------------------------------------------------------

    def _explain_vocab(self, results, extra_texts: Sequence[str] = ()):
        """(words, unit vectors [V, D]) — the most frequent words of the
        result corpora (capped at _MAX_VOCAB) plus any query concepts,
        embedded in one vectorize_text batch.

        The result-only vocab is memoized on the result uuids: a query
        selecting several explain props resolves each prop separately, and
        without the memo a sidecar-backed vectorizer would pay one full
        vocab embedding round-trip per prop. Query concepts (extra_texts,
        a handful of words) are embedded per call and appended."""
        # update-time in the key: a PATCHed object must not serve the vocab
        # of its pre-edit text from the memo
        key = tuple(
            (getattr(r.obj, "uuid", id(r)),
             getattr(r.obj, "last_update_time_unix", 0))
            for r in results
        )
        memo = getattr(self, "_vocab_memo", None)
        if memo is not None and memo[0] == key:
            words, vecs = memo[1]
        else:
            counts: dict[str, int] = {}
            for r in results:
                for tok in _TOKEN_RE.findall(_result_text(r).lower()):
                    counts[tok] = counts.get(tok, 0) + 1
            words = sorted(counts, key=lambda w: (-counts[w], w))[:_MAX_VOCAB]
            if words:
                vecs = _unit(np.asarray(self.vectorize_text(words), dtype=np.float32))
            else:
                vecs = np.zeros((0, 1), np.float32)
            self._vocab_memo = (key, (words, vecs))

        extra = []
        seen = set(words)
        for t in extra_texts:
            for tok in _TOKEN_RE.findall(str(t).lower()):
                if tok not in seen:
                    seen.add(tok)
                    extra.append(tok)
        if extra:
            ev = _unit(np.asarray(self.vectorize_text(extra), dtype=np.float32))
            if vecs.size:
                words, vecs = words + extra, np.concatenate([vecs, ev])
            else:
                words, vecs = list(extra), ev
        if not words:
            return [], np.zeros((0, 1), np.float32)
        return words, vecs

    # -- resolvers -----------------------------------------------------------

    def _nearest_neighbors(self, results, params: dict):
        limit = int((params or {}).get("limit", 10) or 10)
        words, vocab = self._explain_vocab(results)
        out = []
        for r in results:
            v = _result_vector(r)
            if v is None or not words:
                out.append(None)
                continue
            sims = vocab @ _unit(v)
            top = np.argsort(-sims)[:limit]
            out.append({
                "neighbors": [
                    {
                        "concept": words[i],
                        "distance": float(1.0 - sims[i]),
                        "vector": [float(x) for x in vocab[i]],
                    }
                    for i in top
                ]
            })
        return out

    def _interpretation(self, results, params: dict):
        out = []
        for r in results:
            v = _result_vector(r)
            text = _result_text(r)
            if v is None or not text.strip():
                out.append(None)
                continue
            counts: dict[str, int] = {}
            for tok in _TOKEN_RE.findall(text.lower()):
                counts[tok] = counts.get(tok, 0) + 1
            words = sorted(counts, key=lambda w: (-counts[w], w))[:64]
            if not words:
                out.append(None)
                continue
            wv = _unit(np.asarray(self.vectorize_text(words), dtype=np.float32))
            sims = wv @ _unit(v)
            order = np.argsort(-sims)
            out.append({
                "source": [
                    {
                        "concept": words[i],
                        "occurrence": counts[words[i]],
                        "weight": float(max(0.0, min(1.0, (sims[i] + 1.0) / 2.0))),
                    }
                    for i in order
                ]
            })
        return out

    def _semantic_path(self, results, params: dict):
        near_text = (params or {}).get("near_text") or {}
        concepts = near_text.get("concepts") if isinstance(near_text, dict) else near_text
        if isinstance(concepts, str):
            concepts = [concepts]
        if not concepts:
            raise ModuleError(
                "_additional.semanticPath requires a nearText search "
                "(sempath/builder.go: path is built from the query concepts)"
            )
        qv = _unit(np.asarray(
            self.vectorize_text([" ".join(str(c) for c in concepts)]),
            dtype=np.float32,
        )[0])
        words, vocab = self._explain_vocab(results, extra_texts=concepts)
        out = []
        for r in results:
            v = _result_vector(r)
            if v is None or not words:
                out.append(None)
                continue
            rv = _unit(v)
            # walk query -> result through concept space: at each
            # interpolation step pick the nearest vocab concept, dedup runs
            picked: list[int] = []
            for s in range(_PATH_STEPS + 1):
                t = s / _PATH_STEPS
                point = _unit((1.0 - t) * qv + t * rv)
                ci = int(np.argmax(vocab @ point))
                if not picked or picked[-1] != ci:
                    picked.append(ci)
            elems = []
            for j, ci in enumerate(picked):
                cv = vocab[ci]
                elem = {
                    "concept": words[ci],
                    "distanceToQuery": float(1.0 - cv @ qv),
                    "distanceToResult": float(1.0 - cv @ rv),
                }
                if j > 0:
                    elem["distanceToPrevious"] = float(1.0 - cv @ vocab[picked[j - 1]])
                if j < len(picked) - 1:
                    elem["distanceToNext"] = float(1.0 - cv @ vocab[picked[j + 1]])
                elems.append(elem)
            out.append({"path": elems})
        return out

    def _feature_projection(self, results, params: dict):
        from weaviate_tpu_torch.ops.tsne import tsne_project

        p = params or {}
        algo = str(p.get("algorithm", "tsne") or "tsne")
        if algo != "tsne":
            raise ModuleError(f"featureProjection algorithm {algo!r} not supported (tsne only)")
        vecs, rows = [], []
        for i, r in enumerate(results):
            v = _result_vector(r)
            if v is not None:
                rows.append(i)
                vecs.append(v)
        out = [None] * len(results)
        if not vecs:
            return out
        # clamp user-controlled knobs: iterations/dims come straight off the
        # GraphQL wire and drive an O(n^2 * iterations) device loop
        proj = tsne_project(
            np.stack(vecs),
            dims=max(1, min(int(p.get("dimensions", 2) or 2), 3)),
            perplexity=min(max(float(p.get("perplexity", 0) or 0), 0.0), 100.0),
            iterations=max(1, min(int(p.get("iterations", 100) or 100), 2000)),
            learning_rate=min(max(float(p.get("learningRate", 25) or 25), 1e-3), 1e4),
            device=self.device,
        )
        for j, i in enumerate(rows):
            out[i] = {"vector": [float(x) for x in proj[j]]}
        return out

    def resolve_additional(self, prop: str, results, params: dict):
        if prop == "nearestNeighbors":
            return self._nearest_neighbors(results, params)
        if prop == "interpretation":
            return self._interpretation(results, params)
        if prop == "semanticPath":
            return self._semantic_path(results, params)
        if prop == "featureProjection":
            return self._feature_projection(results, params)
        return [None] * len(results)
