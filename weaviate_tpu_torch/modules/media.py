# The port's copy of weaviate_tpu/modules/media.py, its imports pointed at the port.
"""Media vectorizers: img2vec-neural and multi2vec-clip.

Reference clients:
- modules/img2vec-neural/clients/ — POST {url}/vectors/ with {"image":
  b64} against an inference container (IMAGE_INFERENCE_API).
- modules/multi2vec-clip/clients/ — POST {url}/vectorize with {"texts":
  [..], "images": [b64..]} (CLIP_INFERENCE_API); objects may carry text
  AND blob (image) properties, vectors are the weighted mean of both
  modalities.

The image payload is the object's `blob` property (base64, the data type
the schema uses for images).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.interface import GraphQLArguments, Module, Vectorizer
from weaviate_tpu_torch.modules.provider import ModuleError, corpus_from_object
from weaviate_tpu_torch.modules.sidecar import http_json


def _blob_props(class_def, obj, module_cfg: dict) -> list[str]:
    cfg_fields = module_cfg.get("imageFields")
    if cfg_fields:
        return [f for f in cfg_fields if isinstance(obj.properties.get(f), str)]
    out = []
    for p in class_def.properties:
        if p.data_type and p.data_type[0] == "blob":
            if isinstance(obj.properties.get(p.name), str):
                out.append(p.name)
    return out


class Img2VecNeural(Module, Vectorizer, GraphQLArguments):
    def __init__(self, url: str, timeout: float = 60.0):
        if not url:
            raise ModuleError("img2vec-neural requires IMAGE_INFERENCE_API")
        self.url = url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "img2vec-neural"

    @property
    def module_type(self) -> str:
        return "img2vec"

    def meta(self) -> dict:
        return {"type": "img2vec", "url": self.url}

    def arguments(self) -> list[str]:
        return ["nearImage"]

    def vectorize_image(self, image_b64: str) -> np.ndarray:
        reply = http_json(f"{self.url}/vectors", {"image": image_b64},
                          timeout=self.timeout)
        vec = reply.get("vector")
        if vec is None:
            raise ModuleError(f"img2vec sidecar returned no vector: {reply}")
        return np.asarray(vec, dtype=np.float32)

    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        blobs = _blob_props(class_def, obj, module_cfg)
        if not blobs:
            return None
        vecs = [self.vectorize_image(obj.properties[b]) for b in blobs]
        return np.mean(np.stack(vecs), axis=0)

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        blobs = _blob_props(class_def, obj, module_cfg)
        return tuple(obj.properties.get(b, "") for b in sorted(blobs))

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        raise ModuleError("img2vec-neural cannot embed text (use nearImage)")


class Multi2VecClip(Module, Vectorizer, GraphQLArguments):
    def __init__(self, url: str, timeout: float = 60.0):
        if not url:
            raise ModuleError("multi2vec-clip requires CLIP_INFERENCE_API")
        self.url = url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "multi2vec-clip"

    @property
    def module_type(self) -> str:
        return "multi2vec"

    def meta(self) -> dict:
        return {"type": "multi2vec", "url": self.url}

    def arguments(self) -> list[str]:
        return ["nearText", "nearImage"]

    def _vectorize(self, texts: list[str], images: list[str]) -> dict:
        return http_json(
            f"{self.url}/vectorize",
            {"texts": texts, "images": images},
            timeout=self.timeout,
        )

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        reply = self._vectorize(list(texts), [])
        vecs = reply.get("textVectors")
        if not vecs:
            raise ModuleError(f"clip sidecar returned no textVectors: {reply}")
        return np.asarray(vecs, dtype=np.float32)

    def vectorize_image(self, image_b64: str) -> np.ndarray:
        reply = self._vectorize([], [image_b64])
        vecs = reply.get("imageVectors")
        if not vecs:
            raise ModuleError(f"clip sidecar returned no imageVectors: {reply}")
        return np.asarray(vecs[0], dtype=np.float32)

    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        corpus = corpus_from_object(class_def, obj, module_cfg, self.name)
        blobs = _blob_props(class_def, obj, module_cfg)
        texts = [corpus] if corpus.strip() else []
        images = [obj.properties[b] for b in blobs]
        if not texts and not images:
            return None
        reply = self._vectorize(texts, images)
        vecs = [np.asarray(v, np.float32)
                for v in (reply.get("textVectors") or [])]
        vecs += [np.asarray(v, np.float32)
                 for v in (reply.get("imageVectors") or [])]
        if not vecs:
            raise ModuleError(f"clip sidecar returned no vectors: {reply}")
        mean = np.mean(np.stack(vecs), axis=0)
        n = np.linalg.norm(mean)
        return mean / n if n > 0 else mean

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        corpus = corpus_from_object(class_def, obj, module_cfg, self.name)
        blobs = _blob_props(class_def, obj, module_cfg)
        return (corpus, tuple(obj.properties.get(b, "") for b in sorted(blobs)))
