"""The compressed tiers of the port's mesh index against the JAX
package's on the same inputs, on the CPU (the setup and the tolerances are
tests/test_torch_mesh.py's): K2 per slab (codes only), the reconstruction
scan with and without its rescore, and the 4-bit funnel with OPQ; each
with tombstones and an allowList, fused and staged, l2, dot and cosine.
Both packages restart from copies of one JAX-written shard directory
(vector.log, pq.npz, pq4.npz), so both encode against the same codebooks.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import (DIM, METRICS, _configs, _mutate_and_compare, _queries,
                                   _reopen, _reset_globals, _same, _vecs)
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index.mesh import MeshVectorIndex as JMesh
from weaviate_tpu_torch.ops import pq4, pq_gmin
from weaviate_tpu_torch.parallel import mesh_search

__all__ = ["_reset_globals"]  # the shared autouse fixture


def _pq_dir(tmp_path, metric, pq, n, loc, seed=4, dim=DIM):
    """A JAX mesh shard directory compressed with `pq` (vector.log, pq.npz
    and pq4.npz): both packages restart from copies of it, so they encode
    against the same codebooks."""
    conf = {"distance": metric, "pq": {"enabled": False, **pq}}
    jc, _ = _configs(conf)
    src = tmp_path / "src"
    src.mkdir()
    idx = JMesh(jc, str(src), initial_capacity_per_shard=loc)
    vecs = _vecs(n, seed=seed, dim=dim)
    idx.add_batch(np.arange(n), vecs)
    idx.update_user_config(jvi.parse_and_validate_config(
        "hnsw_tpu_mesh", {"distance": metric, "pq": {"enabled": True, **pq}}))
    assert idx.compressed
    idx.shutdown()
    return src, {"distance": metric, "pq": {"enabled": True, **pq}}, vecs


@pytest.mark.parametrize("metric", METRICS)
def test_k2_codes_step_matches(tmp_path, metric):
    """Codes only (rescore false) on slabs of 1024 rows (64 group columns):
    K2 per slab at B 16; a batch under 8 rows takes the reconstruction
    scan without a rescore."""
    src, conf, vecs = _pq_dir(tmp_path, metric,
                              {"segments": 8, "centroids": 32, "rescore": False}, 2000, 1024)
    j, t = _reopen(tmp_path, src, conf, 1024)
    assert t.compressed and t._store[0].dtype == torch.bfloat16
    q = _queries(vecs, 16)
    assert t._pq_gmin_rg(t._read_snapshot(), 16, 5) is not None
    launches = []
    real = pq_gmin.pq_gmin_topk
    try:
        mesh_search.pq_gmin.pq_gmin_topk = lambda *a, **kw: launches.append(1) or real(*a, **kw)
        _mutate_and_compare(j, t, vecs, q, 5, atol=1e-4)
    finally:
        mesh_search.pq_gmin.pq_gmin_topk = real
    assert launches
    _same(j, t, q[:4], 5, atol=1e-4)  # the reconstruction scan, no rescore


@pytest.mark.parametrize("metric", METRICS)
def test_reconstruction_rescore_step_matches(tmp_path, metric):
    """PQ with rescore: the reconstruction scan per slab, its pool rescored
    exactly against the slab's bf16 store rows."""
    src, conf, vecs = _pq_dir(tmp_path, metric, {"segments": 4, "centroids": 16}, 600, 64)
    j, t = _reopen(tmp_path, src, conf, 64)
    _mutate_and_compare(j, t, vecs, _queries(vecs, 16), 10, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_pq4_funnel_with_opq_matches(tmp_path, metric):
    """bits 4 with OPQ: the funnel per slab, its stage 1 the byte-LUT scan
    on both sides (the reference's rule), restarted from pq.npz and
    pq4.npz."""
    pq = {"segments": 8, "centroids": 32, "bits": 4, "rotation": "opq"}
    src, conf, vecs = _pq_dir(tmp_path, metric, pq, 1200, 128)
    assert (src / "pq4.npz").exists()
    j, t = _reopen(tmp_path, src, conf, 128)
    assert t._pq4 is not None and t._opq_rot_dev is not None
    np.testing.assert_array_equal(t._pq4.codebook, j._pq4.codebook)
    launches = pq4.launches
    _mutate_and_compare(j, t, vecs, _queries(vecs, 16), 10, atol=1e-4)
    assert pq4.launches == launches  # no K3 on the mesh
