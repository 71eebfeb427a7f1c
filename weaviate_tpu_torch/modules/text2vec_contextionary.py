# The port's copy of weaviate_tpu/modules/text2vec_contextionary.py, its imports pointed at the port.
"""gRPC vectorizer-sidecar client ("text2vec-contextionary").

Reference: modules/text2vec-contextionary/client/contextionary.go:41-48 —
grpc.Dial to an external embedding service, the pattern every heavyweight
vectorizer follows (and the link BASELINE.json names for host↔accelerator
sidecars). The channel is lazy: constructing the module never touches the
network, so a node configured with CONTEXTIONARY_URL starts even while the
sidecar is still coming up; raw method paths via channel.unary_unary avoid
a build-time codegen dependency for the service stubs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.modules.explain import SemanticExplainer
from weaviate_tpu_torch.modules.interface import GraphQLArguments, Module, Vectorizer
from weaviate_tpu_torch.modules.provider import ModuleError, corpus_from_object

_SERVICE = "/weaviatetpu.modules.v1.Vectorizer"


class ContextionaryVectorizer(Module, Vectorizer, GraphQLArguments, SemanticExplainer):
    def __init__(self, url: str, timeout: float = 30.0):
        if not url:
            raise ModuleError(
                "text2vec-contextionary requires CONTEXTIONARY_URL (host:port)"
            )
        import threading

        self.url = url
        self.timeout = timeout
        self._channel = None
        self._vectorize = None
        self._meta = None
        self._connect_lock = threading.Lock()

    @property
    def name(self) -> str:
        return "text2vec-contextionary"

    def arguments(self) -> list[str]:
        return ["nearText"]

    def _connect(self):
        if self._channel is not None:
            return
        with self._connect_lock:
            if self._channel is not None:
                return
            import grpc

            from weaviate_tpu_torch.modules import contextionary_pb2 as pb

            channel = grpc.insecure_channel(self.url)
            self._vectorize = channel.unary_unary(
                f"{_SERVICE}/Vectorize",
                request_serializer=pb.VectorizeRequest.SerializeToString,
                response_deserializer=pb.VectorizeReply.FromString,
            )
            self._meta = channel.unary_unary(
                f"{_SERVICE}/Meta",
                request_serializer=pb.MetaRequest.SerializeToString,
                response_deserializer=pb.MetaReply.FromString,
            )
            self._channel = channel  # assign last: publishes the stubs

    def meta(self) -> dict:
        try:
            self._connect()
            from weaviate_tpu_torch.modules import contextionary_pb2 as pb

            reply = self._meta(pb.MetaRequest(), timeout=2.0)
            return {
                "type": "text2vec",
                "version": reply.version,
                "wordCount": reply.word_count,
                "dimensions": reply.dimensions,
            }
        except Exception:  # noqa: BLE001 — sidecar down: report reachability only
            return {"type": "text2vec", "url": self.url, "reachable": False}

    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        self._connect()
        from weaviate_tpu_torch.modules import contextionary_pb2 as pb

        reply = self._vectorize(
            pb.VectorizeRequest(texts=list(texts)), timeout=self.timeout
        )
        if reply.error:
            raise ModuleError(f"vectorizer sidecar error: {reply.error}")
        return np.asarray(
            [list(v.values) for v in reply.vectors], dtype=np.float32
        )

    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        corpus = corpus_from_object(class_def, obj, module_cfg, self.name)
        if not corpus.strip():
            return None
        return self.vectorize_text([corpus])[0]

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        return corpus_from_object(class_def, obj, module_cfg, self.name)

    def shutdown(self) -> None:
        if self._channel is not None:
            self._channel.close()
            self._channel = None
