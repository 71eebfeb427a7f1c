"""The mesh snapshot plane of the port (weaviate_tpu_torch/index/mesh.py
MeshSnapshot) on 8 CPU slabs: the six contracts of tests/test_mesh_async.py
restated for the port.

1. bit-identical results: sync and async (two-phase) reads return exactly
   what a quiesced sync search returns, over the full scan, the masked
   allowList scan, a k that merges every slab's candidates, and the PQ
   rescore and codes-only tiers;
2. zero index-lock acquisitions on a warmed async read, one fetch, and no
   host translation (the fused layout);
3. a reader never blocks on a writer holding the index lock;
4. a dispatch enqueued before delete + compact finalizes with the old
   snapshot's answer;
5. read-your-writes: a search right after add or delete republishes and
   sees the write.

Small-integer vectors: every l2 distance is exact integer arithmetic in
f32 whatever the summation order, so the equality checks are exact.
"""

import threading
import time

import numpy as np

from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
from weaviate_tpu_torch.index.mesh import MeshVectorIndex
from weaviate_tpu_torch.monitoring import costmodel, tracing
from weaviate_tpu_torch.storage.bitmap import Bitmap

DIM = 16


def _mk_index(tmp_path, n=400, pq=None, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-8, 8, (n, DIM)).astype(np.float32)
    d = {"distance": "l2-squared"}
    if pq is not None:
        d["pq"] = pq
    (tmp_path / "meshix").mkdir(parents=True, exist_ok=True)
    idx = MeshVectorIndex(parse_and_validate_config("hnsw_tpu_mesh", d), str(tmp_path / "meshix"),
                          device="cpu", persist=False, initial_capacity_per_shard=64)
    idx.add_batch(np.arange(n), vecs)
    idx.flush()
    return idx, vecs, rng


def _case_queries(vecs, rng):
    return vecs[:6] + rng.integers(0, 2, (6, DIM)).astype(np.float32)


def _assert_identical(idx, q, k, allow=None):
    sync_ids, sync_d = idx.search_by_vectors(q, k, allow)
    async_ids, async_d = idx.search_by_vectors_async(q, k, allow)()
    np.testing.assert_array_equal(sync_ids, async_ids)
    np.testing.assert_array_equal(sync_d, async_d)
    again_ids, again_d = idx.search_by_vectors(q, k, allow)
    np.testing.assert_array_equal(sync_ids, again_ids)
    np.testing.assert_array_equal(sync_d, again_d)


def test_mesh_bit_identical_sync_async_uncompressed(tmp_path):
    idx, vecs, rng = _mk_index(tmp_path)
    q = _case_queries(vecs, rng)
    _assert_identical(idx, q, 5)                        # full scan
    _assert_identical(idx, q, 5, Bitmap(range(0, 300, 2)))  # masked allowList
    _assert_identical(idx, q, 5, Bitmap(range(0, 40)))  # small allowList
    # every slab's local top-k contributes to the merge (50 rows a slab)
    _assert_identical(idx, q, 48)


def test_mesh_bit_identical_sync_async_pq_tiers(tmp_path):
    for rescore in (True, False):
        sub = tmp_path / ("rs" if rescore else "codes")
        sub.mkdir()
        idx, vecs, rng = _mk_index(sub, pq={"enabled": False, "segments": 8, "centroids": 16,
                                            "rescore": rescore})
        idx.compress()
        assert idx.compressed
        q = _case_queries(vecs, rng)
        _assert_identical(idx, q, 5)
        _assert_identical(idx, q, 5, Bitmap(range(0, 300, 2)))


class SpyLock:
    def __init__(self, inner):
        self.inner, self.count = inner, 0

    def acquire(self, *a, **kw):
        self.count += 1
        return self.inner.acquire(*a, **kw)

    def release(self):
        return self.inner.release()

    def __enter__(self):
        self.count += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_mesh_async_read_takes_zero_index_locks_one_fetch(tmp_path):
    idx, vecs, rng = _mk_index(tmp_path)
    q = _case_queries(vecs, rng)
    idx.search_by_vectors(q, 5)  # publish
    prev = tracing.get_tracer()
    tracing.configure(tracing.Tracer(sample_rate=1.0))
    spy = SpyLock(idx._lock)
    idx._lock = spy
    try:
        ids, _ = idx.search_by_vectors_async(q, 5)()
    finally:
        idx._lock = spy.inner
        tracing.configure(prev)
    assert ids.shape == (6, 5)
    assert spy.count == 0, "the mesh async dispatch took the index lock"
    shape = idx.pop_dispatch_shape()
    assert shape is not None and shape.ndev == 8 and shape.fetches == 1
    assert shape.fused and shape.translate_ms == 0.0
    assert costmodel.fused_invariant_ok(shape)


def test_mesh_reader_never_blocks_on_writer_held_lock(tmp_path):
    idx, vecs, _ = _mk_index(tmp_path)
    idx.search_by_vectors(vecs[:4], 3)
    holding, release = threading.Event(), threading.Event()

    def writer():
        with idx._lock:
            holding.set()
            release.wait(3.0)

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    assert holding.wait(5.0)
    t0 = time.perf_counter()
    ids, _ = idx.search_by_vectors(vecs[:4], 3)
    elapsed = time.perf_counter() - t0
    release.set()
    w.join(timeout=10)
    assert ids.shape == (4, 3)
    assert elapsed < 1.0, f"the reader took {elapsed:.2f} s while a writer held the lock"
    assert idx.pop_read_lock_wait() == 0.0


def test_mesh_snapshot_pins_arrays_across_delete_and_compact(tmp_path):
    idx, vecs, _ = _mk_index(tmp_path)
    q = vecs[:4].copy()
    expect_ids, expect_d = idx.search_by_vectors(q, 3)
    snap = idx._read_snapshot()
    tombs0 = [t.clone() for t in snap.tombs]
    fin = idx.search_by_vectors_async(q, 3)  # enqueued on snapshot S
    for row in expect_ids:
        for doc in row:
            idx.delete(int(doc))
    idx.compact()
    got_ids, got_d = fin()  # finalizes against the pinned snapshot S
    np.testing.assert_array_equal(got_ids, expect_ids)
    np.testing.assert_array_equal(got_d, expect_d)
    # the slabs S holds were never written: the delete copied them first
    assert all(a.equal(b) for a, b in zip(tombs0, snap.tombs))
    new_ids, _ = idx.search_by_vectors(q, 3)
    assert not ({int(x) for x in new_ids.ravel()} & {int(x) for x in expect_ids.ravel()})


def test_mesh_read_your_writes_after_staged_mutations(tmp_path):
    idx, vecs, _ = _mk_index(tmp_path, n=100)
    gen0 = idx.snapshot_gen
    v = np.full(DIM, 7.0, np.float32)
    idx.add(5000, v)
    ids, dists = idx.search_by_vectors(v[None, :], 1)
    assert int(ids[0, 0]) == 5000 and float(dists[0, 0]) == 0.0
    assert idx.snapshot_gen > gen0  # the read published a new snapshot
    idx.delete(5000)
    ids, _ = idx.search_by_vectors(v[None, :], 1)
    assert int(ids[0, 0]) != 5000
