"""Vector indexes behind the VectorIndex seam (reference
adapters/repos/db/vector_index.go:23-40). Implementations in this port:

- hnsw.HnswIndex       ("hnsw"): the native C++ graph engine on the host
  (native/hnsw.cpp), picked by its type beside the card's indexes
- gpu.GpuVectorIndex   ("hnsw_tpu"/"flat"): device-resident batched kNN
- mesh.MeshVectorIndex ("hnsw_tpu_mesh"): the same, sharded row-wise over
  a list of devices, one slab each
- noop.NoopIndex       ("noop"/skip=true)
"""

from weaviate_tpu_torch.index.interface import VectorIndex

__all__ = ["VectorIndex", "new_vector_index"]

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
    if t == "hnsw":
        # a host engine: it takes no device
        from weaviate_tpu_torch.index.hnsw import HnswIndex

        return HnswIndex(config, shard_path, shard_name, metrics=metrics,
                         persist=persist, class_name=class_name)
    if t in ("hnsw_tpu", "flat"):
        from weaviate_tpu_torch.index.gpu import GpuVectorIndex

        return GpuVectorIndex(config, shard_path, shard_name, device=device,
                              persist=persist, metrics=metrics, class_name=class_name)
    if t == "hnsw_tpu_mesh":
        from weaviate_tpu_torch.index.mesh import MeshVectorIndex

        return MeshVectorIndex(config, shard_path, shard_name, device=device,
                               persist=persist, metrics=metrics, class_name=class_name)
    raise ValueError(f"unknown vector index type {t!r}")
