"""The uncompressed kernel and IVF tiers of the port's mesh index against
the JAX package's on the same inputs, on the CPU (the setup, the JAX mesh
on 8 virtual host devices and the port's on 8 CPU slabs, and the
tolerances are tests/test_torch_mesh.py's): K1 per slab over an f32 and a
bf16 store, and IVF; each with tombstones and an allowList, fused and
staged, l2, dot and cosine. The compressed tiers are
tests/test_torch_mesh_pq.py's.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh import (METRICS, _apply, _mutate_and_compare, _pair, _queries,
                                   _reset_globals, _vecs)
from weaviate_tpu.config.config import IvfConfig as JIvfConfig
from weaviate_tpu.index import tpu
from weaviate_tpu_torch.config.config import IvfConfig
from weaviate_tpu_torch.index import gpu
from weaviate_tpu_torch.ops import gmin_scan
from weaviate_tpu_torch.parallel import mesh_search

__all__ = ["_reset_globals"]  # the shared autouse fixture


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_step_matches(tmp_path, metric, dtype):
    """Slabs of 16384 rows open K1 per slab (the reference's own test uses
    the same capacity, tests/test_mesh_index.py:411), over an f32 store or
    a bf16 one; the port's slabs run the kernel's plain version here."""
    j, t = _pair(tmp_path, {"distance": metric, "storeDtype": dtype}, loc=16384)
    vecs = _vecs(3000, seed=3)
    _apply((j, t), lambda x: x.add_batch(np.arange(3000), vecs))
    q = _queries(vecs, 16)
    snap = t._read_snapshot()
    assert t._gmin_plan(16, 5, snap) == (32, 1)
    assert snap.store[0].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    calls = []
    real = gmin_scan.gmin_topk
    try:
        mesh_search.gmin_scan.gmin_topk = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        _mutate_and_compare(j, t, vecs, q, 5, atol=1e-5 if dtype == "float32" else 1e-4)
    finally:
        mesh_search.gmin_scan.gmin_topk = real
    assert len(calls) % 8 == 0 and calls  # one scan per slab per dispatch


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_step_matches(tmp_path, metric):
    """IVF trained by flush() (off the lock, from a pinned snapshot) gives
    both packages the same codebook and per-slab buckets; probed searches
    (top_p 4 of nlist 8) answer alike."""
    kw = dict(enabled=True, nlist=8, min_n=256, top_p=4, train_sample=4096, train_iters=4)
    tpu.set_ivf_config(JIvfConfig(**kw))
    gpu.set_ivf_config(IvfConfig(**kw))
    j, t = _pair(tmp_path, {"distance": metric}, loc=64)
    vecs = _vecs(900, seed=5) * 10.0
    _apply((j, t), lambda x: x.add_batch(np.arange(900), vecs))
    _apply((j, t), lambda x: x.flush())
    np.testing.assert_array_equal(t._ivf_centroids_host, j._ivf_centroids_host)
    assert t._ivf_meta is None  # buckets build at the next publish
    t._read_snapshot(), j._read_snapshot()
    assert t._ivf_meta[:2] == j._ivf_meta[:2]
    for s in range(8):
        np.testing.assert_array_equal(t._ivf_buckets[s].numpy(), np.asarray(j._ivf_buckets[s]))
    _mutate_and_compare(j, t, vecs, _queries(vecs, 16), 10)
    assert t.ivf_stats()["dispatches"] == j.ivf_stats()["dispatches"] > 0
    assert t.health()["ivf"]["buckets"] == j.health()["ivf"]["buckets"]
