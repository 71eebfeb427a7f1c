"""Vector indexes behind the VectorIndex seam (reference
adapters/repos/db/vector_index.go:23-40). Implementations in this port:

- gpu.GpuVectorIndex  ("hnsw_tpu"/"flat"): device-resident batched kNN
- noop.NoopIndex      ("noop"/skip=true)
"""

from weaviate_tpu_torch.index.interface import VectorIndex

__all__ = ["VectorIndex", "new_vector_index"]

# index types of the JAX package that this port does not serve yet, and
# the ROADMAP item that brings each
_LATER = {
    "hnsw_tpu_mesh": "the multi-device mesh index (ROADMAP queue 1, item 10)",
    "hnsw": "the native CPU graph engine (ROADMAP queue 1, item 16)",
}


def new_vector_index(config, shard_path: str, shard_name: str = "", device=None,
                     persist: bool = True, metrics=None, class_name: str = ""):
    """Factory keyed on UserConfig.IndexType() (config.go:69-71). `device`
    defaults to the CUDA card; without one this raises unless the caller
    passes device="cpu". `metrics` and `class_name` label the index's
    gauges (the shard passes its own)."""
    t = config.IndexType()
    if config.skip or t == "noop":
        from weaviate_tpu_torch.index.noop import NoopIndex

        return NoopIndex(config)
    if t in ("hnsw_tpu", "flat"):
        from weaviate_tpu_torch.index.gpu import GpuVectorIndex

        return GpuVectorIndex(config, shard_path, shard_name, device=device,
                              persist=persist, metrics=metrics, class_name=class_name)
    if t in _LATER:
        raise ValueError(f"vectorIndexType {t!r} is not ported yet: {_LATER[t]}")
    raise ValueError(f"unknown vector index type {t!r}")
