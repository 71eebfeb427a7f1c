# The port's copy of weaviate_tpu/modules/text2vec_http.py, its imports pointed at the port.
"""Text vectorizers over HTTP: the transformers sidecar and the SaaS APIs.

Reference clients:
- modules/text2vec-transformers/clients/ — POST {url}/vectors/ with
  {"text": ...} against a locally-deployed inference container
  (TRANSFORMERS_INFERENCE_API env).
- modules/text2vec-openai/clients/ — POST api.openai.com/v1/embeddings
  (OPENAI_APIKEY; model from class moduleConfig).
- modules/text2vec-cohere/clients/ — POST api.cohere.ai/v1/embed
  (COHERE_APIKEY).
- modules/text2vec-huggingface/clients/ — POST the HF inference API
  (HUGGINGFACE_APIKEY; endpoint from moduleConfig).

All four share Vectorizer semantics (corpus built exactly like the local
module); they differ only in wire format, so each subclass is the payload
codec and nothing else.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.interface import GraphQLArguments, Module, Vectorizer
from weaviate_tpu_torch.modules.provider import ModuleError, corpus_from_object
from weaviate_tpu_torch.modules.sidecar import http_json


class _HttpTextVectorizer(Module, Vectorizer, GraphQLArguments):
    """Common skeleton: corpus building + batch loop + near-args."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def arguments(self) -> list[str]:
        return ["nearText"]

    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        corpus = corpus_from_object(class_def, obj, module_cfg, self.name)
        if not corpus.strip():
            return None
        return self.vectorize_text([corpus])[0]

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        return corpus_from_object(class_def, obj, module_cfg, self.name)


class TransformersVectorizer(_HttpTextVectorizer):
    """text2vec-transformers: local inference-container sidecar."""

    def __init__(self, url: str, timeout: float = 30.0):
        super().__init__(timeout)
        if not url:
            raise ModuleError(
                "text2vec-transformers requires TRANSFORMERS_INFERENCE_API"
            )
        self.url = url.rstrip("/")

    @property
    def name(self) -> str:
        return "text2vec-transformers"

    def meta(self) -> dict:
        try:
            return {"type": "text2vec", **http_json(f"{self.url}/meta", method="GET", timeout=2.0)}
        except Exception:  # noqa: BLE001
            return {"type": "text2vec", "url": self.url, "reachable": False}

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        out = []
        for t in texts:
            reply = http_json(f"{self.url}/vectors", {"text": t}, timeout=self.timeout)
            vec = reply.get("vector")
            if vec is None:
                raise ModuleError(f"transformers sidecar returned no vector: {reply}")
            out.append(np.asarray(vec, dtype=np.float32))
        return np.stack(out)


class OpenAIVectorizer(_HttpTextVectorizer):
    """text2vec-openai: api.openai.com embeddings."""

    def __init__(self, api_key: str, model: str = "text-embedding-3-small",
                 base_url: str = "https://api.openai.com/v1", timeout: float = 60.0):
        super().__init__(timeout)
        if not api_key:
            raise ModuleError("text2vec-openai requires OPENAI_APIKEY")
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")

    @property
    def name(self) -> str:
        return "text2vec-openai"

    def meta(self) -> dict:
        return {"type": "text2vec", "provider": "openai", "model": self.model}

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        reply = http_json(
            f"{self.base_url}/embeddings",
            {"input": list(texts), "model": self.model},
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        data = sorted(reply.get("data", []), key=lambda d: d.get("index", 0))
        if len(data) != len(texts):
            raise ModuleError(f"openai returned {len(data)} embeddings for {len(texts)} inputs")
        return np.asarray([d["embedding"] for d in data], dtype=np.float32)


class CohereVectorizer(_HttpTextVectorizer):
    """text2vec-cohere: api.cohere.ai embed."""

    def __init__(self, api_key: str, model: str = "embed-multilingual-v3.0",
                 base_url: str = "https://api.cohere.ai/v1", timeout: float = 60.0):
        super().__init__(timeout)
        if not api_key:
            raise ModuleError("text2vec-cohere requires COHERE_APIKEY")
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")

    @property
    def name(self) -> str:
        return "text2vec-cohere"

    def meta(self) -> dict:
        return {"type": "text2vec", "provider": "cohere", "model": self.model}

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        reply = http_json(
            f"{self.base_url}/embed",
            {"texts": list(texts), "model": self.model, "input_type": "search_document"},
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        embs = reply.get("embeddings")
        if not embs or len(embs) != len(texts):
            raise ModuleError("cohere returned a mismatched embeddings payload")
        return np.asarray(embs, dtype=np.float32)


class HuggingFaceVectorizer(_HttpTextVectorizer):
    """text2vec-huggingface: HF inference API feature extraction."""

    def __init__(self, api_key: str,
                 model: str = "sentence-transformers/all-MiniLM-L6-v2",
                 base_url: str = "https://api-inference.huggingface.co",
                 timeout: float = 60.0):
        super().__init__(timeout)
        if not api_key:
            raise ModuleError("text2vec-huggingface requires HUGGINGFACE_APIKEY")
        self.api_key = api_key
        self.model = model
        self.base_url = base_url.rstrip("/")

    @property
    def name(self) -> str:
        return "text2vec-huggingface"

    def meta(self) -> dict:
        return {"type": "text2vec", "provider": "huggingface", "model": self.model}

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        reply = http_json(
            f"{self.base_url}/pipeline/feature-extraction/{self.model}",
            {"inputs": list(texts), "options": {"wait_for_model": True}},
            headers={"Authorization": f"Bearer {self.api_key}"},
            timeout=self.timeout,
        )
        if not isinstance(reply, list) and isinstance(reply, dict):
            raise ModuleError(f"huggingface error: {reply.get('error', reply)}")
        return np.asarray(reply, dtype=np.float32)
