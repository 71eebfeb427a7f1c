"""Multi-device data plane (twin of `weaviate_tpu/parallel/`).

Reference parallelism (SURVEY.md §2.8): goroutine scatter-gather across
shards + HTTP between nodes (index.go:967-1046). The JAX package shards one
logical index row-wise over a jax.sharding Mesh; this port shards it over
an ordered list of torch devices driven by one process: each device holds
a [n_loc, D] slab, a query batch is copied to every device, every slab is
scored on its own device, and the per-slab top-k candidates are merged on
the lead device (slab 0's). Host-level (multi-node) scatter-gather stays
on the cluster API plane.
"""

from weaviate_tpu_torch.parallel.mesh_search import (MeshSearchPlan, make_mesh,
                                                     mesh_search_step)

__all__ = ["MeshSearchPlan", "make_mesh", "mesh_search_step"]
