# The port's copy of weaviate_tpu/modules/__init__.py, its imports pointed at the port.
"""Module system: capability interfaces + provider + concrete modules.

Reference: usecases/modules/ (provider) + entities/modulecapabilities/
(interfaces) + modules/ (18 concrete modules). Concrete modules here:

- text2vec-local          in-process hash-embedding vectorizer (no sidecar)
- text2vec-contextionary  gRPC embedding-sidecar client (the contextionary
                          dial pattern, client/contextionary.go:41)
- ref2vec-centroid        vector = centroid of referenced objects' vectors
- backup-filesystem       backup storage backend (modules/backup-filesystem)
"""

from weaviate_tpu_torch.modules.interface import (
    AdditionalProperties,
    BackupBackend,
    GraphQLArguments,
    Module,
    Vectorizer,
)
from weaviate_tpu_torch.modules.provider import ModuleError, Provider, build_provider

__all__ = [
    "AdditionalProperties",
    "BackupBackend",
    "GraphQLArguments",
    "Module",
    "ModuleError",
    "Provider",
    "Vectorizer",
    "build_provider",
]
