# The port's copy of weaviate_tpu/modules/text2vec_local.py, its imports pointed at the port; the class takes
# the `device` its explainer half runs on.
"""Local hash-embedding text vectorizer ("text2vec-local").

The in-process counterpart of the reference's vectorizer sidecars: where
text2vec-contextionary dials a gRPC service
(modules/text2vec-contextionary/client/contextionary.go:41), this module
embeds entirely locally so vectorize-at-import and nearText work with zero
external services (tests, air-gapped deployments, CI).

Embedding model: deterministic token hashing — each token maps to a fixed
pseudo-random gaussian direction (seeded by the token's digest), a text is
the L2-normalized sum of its token directions weighted by log(1+tf). Texts
sharing tokens land close in cosine space, which is exactly the contract
nearText needs (query concepts match objects containing those words);
unrelated texts are near-orthogonal in high dimensions. No external model,
fully reproducible across processes and platforms.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.explain import SemanticExplainer
from weaviate_tpu_torch.modules.interface import (
    GraphQLArguments,
    Module,
    ModuleRest,
    Vectorizer,
)
from weaviate_tpu_torch.modules.provider import corpus_from_object

_TOKEN_RE = re.compile(r"[a-z0-9]+")
_CONCEPT_RE = re.compile(r"^[a-z0-9]+( [a-z0-9]+)*$")


class LocalTextVectorizer(Module, Vectorizer, GraphQLArguments, SemanticExplainer,
                          ModuleRest):
    def __init__(self, name: str = "text2vec-local", dim: int = 256,
                 persist_path: Optional[str] = None, device=None):
        self._name = name
        self.device = device  # featureProjection's t-SNE (None: the card)
        self.dim = dim
        self._cache: dict[str, np.ndarray] = {}
        # custom concepts (C11yExtension): concept -> (blended vector, ext);
        # definitions persist (extensions-storage role) so restarts keep
        # embedding the concept the way already-imported vectors saw it
        self._extensions: dict[str, tuple[np.ndarray, dict]] = {}
        self._ext_lock = threading.Lock()
        self._persist_path = persist_path
        if persist_path and os.path.exists(persist_path):
            try:
                with open(persist_path) as f:
                    records = json.load(f)
                loaded = {}
                for rec in records:  # any malformed shape lands in except
                    vec = np.asarray(rec.pop("vector"), np.float32)
                    loaded[rec["concept"]] = (vec, rec)
                self._extensions = loaded  # all-or-nothing, never partial
            except Exception:  # noqa: BLE001 — corrupt file must not stop
                self._extensions = {}      # the server; serve without ext.

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_type(self) -> str:
        return "text2vec"

    def meta(self) -> dict:
        return {"type": "text2vec", "model": "hash-embedding", "dimensions": self.dim}

    def arguments(self) -> list[str]:
        return ["nearText"]

    # -- embedding -----------------------------------------------------------

    def _token_vec(self, token: str) -> np.ndarray:
        ext = self._extensions.get(token)
        if ext is not None:
            return ext[0]  # custom concept overrides the hash direction
        v = self._cache.get(token)
        if v is None:
            seed = int.from_bytes(
                hashlib.blake2b(token.encode("utf-8"), digest_size=8).digest(), "little"
            )
            v = np.random.default_rng(seed).standard_normal(self.dim).astype(np.float32)
            if len(self._cache) < 200_000:  # bound the token cache
                self._cache[token] = v
        return v

    def _embed(self, text: str) -> np.ndarray:
        ext = self._extensions.get(text.strip().lower())
        if ext is not None:
            return ext[0]  # compound custom concepts match whole queries
        tokens = _TOKEN_RE.findall(text.lower())
        if not tokens:
            return np.zeros(self.dim, dtype=np.float32)
        counts: dict[str, int] = {}
        for t in tokens:
            counts[t] = counts.get(t, 0) + 1
        acc = np.zeros(self.dim, dtype=np.float32)
        for t, c in counts.items():
            acc += np.log1p(c) * self._token_vec(t)
        n = np.linalg.norm(acc)
        return acc / n if n > 0 else acc

    # -- Vectorizer ----------------------------------------------------------

    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        corpus = corpus_from_object(class_def, obj, module_cfg, self._name)
        if not corpus.strip():
            return None
        return self._embed(corpus)

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self._embed(t) for t in texts])

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        return corpus_from_object(class_def, obj, module_cfg, self._name)

    def _blend(self, concept: str, def_vec: np.ndarray,
               weight: float) -> np.ndarray:
        """weight=1 overrides entirely; otherwise blend with the concept's
        PREVIOUS vector (only reachable for already-extended concepts — new
        ones require weight=1)."""
        if weight >= 1.0 or concept not in self._extensions:
            return def_vec.astype(np.float32)
        prev = self._extensions[concept][0]
        vec = weight * def_vec + (1.0 - weight) * prev
        n = np.linalg.norm(vec)
        return (vec / n if n > 0 else vec).astype(np.float32)

    def _save_extensions(self) -> None:
        if not self._persist_path:
            return
        try:
            os.makedirs(os.path.dirname(self._persist_path), exist_ok=True)
            tmp = self._persist_path + ".tmp"
            with open(tmp, "w") as f:
                # the FINAL vector persists too: a weight<1 blend chain is
                # not reconstructible from the latest definition alone
                json.dump([{**e, "vector": v.tolist()}
                           for v, e in self._extensions.values()], f)
            os.replace(tmp, self._persist_path)
        except OSError:
            pass  # persistence is best-effort; the live table still serves

    # -- /v1/modules/<name>/... (ModuleRest) ----------------------------------

    def handle_rest(self, method: str, path: str, body):
        """User-facing extension surface (the reference's
        modules/text2vec-contextionary/extensions/rest_user_facing.go and
        concepts/rest.go, served locally):

        POST /extensions          {concept, definition, weight} -> stored;
                                  the concept now embeds as the definition
                                  (weight=1) or as `weight * new_def +
                                  (1-weight) * previous_extension_vector`
                                  on re-definition; nearText and
                                  vectorize-at-import pick it up immediately
        GET  /extensions          all stored extensions
        GET  /concepts/<concept>  word-presence info (C11yWordsResponse shape)
        """
        path = path.rstrip("/")
        if path == "/extensions" and method == "POST":
            if not isinstance(body, dict):
                return 422, {"error": [{"message": "body must be a JSON object"}]}
            concept = str(body.get("concept", "")).strip()
            definition = str(body.get("definition", "")).strip()
            try:
                weight = float(body.get("weight", 1.0))
            except (TypeError, ValueError):
                return 422, {"error": [{"message": "weight must be a number"}]}
            # validated as GIVEN: uppercase is rejected, not normalized
            # (rest_user_facing.go: "must be an all-lowercase single word")
            if not _CONCEPT_RE.match(concept):
                return 422, {"error": [{"message":
                    "concept must be an all-lowercase single word or "
                    "space-delimited compound word"}]}
            if not definition:
                return 422, {"error": [{"message": "definition is required"}]}
            if not 0.0 <= weight <= 1.0:
                return 422, {"error": [{"message": "weight must be in [0, 1]"}]}
            with self._ext_lock:
                if concept not in self._extensions and weight < 1.0:
                    # rest_user_facing.go semantics: a concept the module
                    # does not know yet cannot blend with an existing one
                    return 400, {"error": [{"message":
                        "custom concepts require weight=1 on first definition"}]}
                def_vec = self._embed(definition)
                vec = self._blend(concept, def_vec, weight)
                ext = {"concept": concept, "definition": definition,
                       "weight": weight}
                self._extensions[concept] = (vec, ext)
                self._save_extensions()
            return 200, ext
        if path == "/extensions" and method == "GET":
            with self._ext_lock:
                return 200, {"extensions":
                             [e for _, e in self._extensions.values()]}
        if path.startswith("/concepts/") and method == "GET":
            from urllib.parse import unquote

            concept = unquote(path[len("/concepts/"):]).strip().lower()
            with self._ext_lock:
                whole = concept in self._extensions  # compound custom concept
                words = _TOKEN_RE.findall(concept) or [concept]
                return 200, {
                    "concept": concept,
                    "custom": whole,
                    "individualWords": [{
                        "word": w,
                        "present": True,  # hash embedding: every token embeds
                        "info": {
                            # per-WORD customness only; the top-level
                            # "custom" field reports the compound concept
                            "custom": w in self._extensions,
                            "nearestNeighbors": [],
                        },
                    } for w in words],
                }
        return 404, {"error": [{"message": f"no module route {method} {path}"}]}
