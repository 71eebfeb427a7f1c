# The port's copy of weaviate_tpu/modules/interface.py, its imports pointed at the port.
"""Module capability interfaces.

Reference: entities/modulecapabilities/module.go:34 (Module),
vectorizer.go (Vectorizer), graphql.go (GraphQLArguments), additional.go
(AdditionalProperties), backup.go (BackupBackend). A module declares a name
+ type and implements any subset of the capability mixins; the Provider
(provider.py) dispatches on isinstance checks, the Python idiom for the
reference's interface assertions.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import numpy as np


class Module(abc.ABC):
    """modulecapabilities.Module: identity + lifecycle."""

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    def module_type(self) -> str:
        return "text2vec"

    def init(self, config) -> None:
        """Called once at registration (InitParams analog)."""

    def meta(self) -> dict:
        return {}

    def shutdown(self) -> None:
        pass


class Vectorizer(abc.ABC):
    """Vectorize-at-import + query-time near-args resolution
    (modulecapabilities/vectorizer.go)."""

    @abc.abstractmethod
    def vectorize_object(self, class_def, obj, module_cfg: dict) -> Optional[np.ndarray]:
        """Embed one object's text corpus; None = nothing to vectorize."""

    @abc.abstractmethod
    def vectorize_text(self, texts: Sequence[str]) -> np.ndarray:
        """Embed raw query texts -> [len(texts), D] float32."""

    def vectorize_input(self, class_def, obj, module_cfg: dict):
        """The canonical embedding input for `obj` (corpus string, beacon
        list, ...), or None if undeterminable. Lets callers skip embedding
        when an edit didn't change what would be embedded."""
        return None


class GraphQLArguments(abc.ABC):
    """near-args the module contributes to Get/Explore
    (modulecapabilities/graphql.go)."""

    def arguments(self) -> list[str]:
        return []


class ModuleRest(abc.ABC):
    """User-facing module REST extension surface served under
    /v1/modules/<module-name>/... (the reference mounts each module's
    RootHandler there, middlewares.go:66; e.g. text2vec-contextionary's
    /extensions and /concepts/{concept} handlers)."""

    @abc.abstractmethod
    def handle_rest(self, method: str, path: str, body):
        """method + subpath (no module prefix) + decoded JSON body (or
        None) -> (status_code, payload dict)."""


class TextTransformer(abc.ABC):
    """Query-text transformation — the autocorrect hook
    (modulecapabilities/texttransformer.go TextTransform)."""

    @abc.abstractmethod
    def transform(self, texts: Sequence[str]) -> list[str]:
        """-> the transformed texts, same length/order."""


class AdditionalProperties(abc.ABC):
    """_additional props the module can resolve
    (modulecapabilities/additional.go)."""

    def additional_properties(self) -> list[str]:
        return []

    def resolve_additional(self, prop: str, results, params: dict):
        return None


class BackupBackend(abc.ABC):
    """Backup storage backend (modulecapabilities/backup.go):
    write/read backup artifacts under (backup_id, node, path) keys."""

    @abc.abstractmethod
    def put_object(self, backup_id: str, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get_object(self, backup_id: str, key: str) -> bytes: ...

    @abc.abstractmethod
    def write_meta(self, backup_id: str, meta: dict) -> None: ...

    @abc.abstractmethod
    def read_meta(self, backup_id: str) -> Optional[dict]: ...

    def put_file(self, backup_id: str, key: str, src_path: str) -> None:
        """Streamed upload; default reads fully (override for real streaming)."""
        with open(src_path, "rb") as f:
            self.put_object(backup_id, key, f.read())

    def fetch_to_file(self, backup_id: str, key: str, dst_path: str) -> None:
        """Streamed download; default materializes (override to stream)."""
        import os as _os

        _os.makedirs(_os.path.dirname(dst_path), exist_ok=True)
        with open(dst_path, "wb") as f:
            f.write(self.get_object(backup_id, key))

    def home_id(self, backup_id: str) -> str:
        return backup_id
