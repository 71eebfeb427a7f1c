"""The index's lifecycle pieces in the port (weaviate_tpu_torch.index.gpu)
against the JAX package's TpuVectorIndex, on the CPU: `compact()`
uncompressed and under PQ 8-bit and 4-bit, the host fallback plane,
`health()`, the query staging pool, the per-thread dispatch facts, and
the `storeDtype: bfloat16` store.

A compressed JAX index and the port answer alike only from the same slot
layout and codebook: those cases build and compress in the JAX package,
shut it down, and restart both packages from copies of the same shard
directory (as tests/test_torch_index_pq.py does).

Tolerances: doc ids equal exactly (tie-free gaussian data); distances
rtol 1e-5, atol 1e-5 (the same f32 arithmetic in another order). The host
plane is compared on integer vectors, exact in f32, as
tests/test_robustness.py does.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import new_vector_index as jax_new_index
from weaviate_tpu.storage.bitmap import Bitmap as JaxBitmap
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.index import new_vector_index as torch_new_index
from weaviate_tpu_torch.monitoring import costmodel, tracing
from weaviate_tpu_torch.state import state_from_arrays
from weaviate_tpu_torch.storage.bitmap import Bitmap as TorchBitmap

D, N, B, K = 32, 3000, 16, 10
SENTINEL = np.iinfo(np.uint64).max
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "recall_fixture.npz")
PQ = {"enabled": True, "segments": 8, "centroids": 32}


def _jax(conf, path):
    return jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(path))


def _torch(conf, path):
    return torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf), str(path),
                           device="cpu")


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _gauss(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32), rng


def _batches(rng, n=N):
    """16 rows (the kernel tiers), 1 row (the chunked tiers), a masked and
    a gather-tier allowList (flatSearchCutoff 500)."""
    q = rng.standard_normal((B, D)).astype(np.float32)
    return [(q, None), (q[:1], None), (q, np.arange(0, n, 2)),
            (q[:4], rng.choice(n, 300, replace=False))]


def _compare(tidx, jidx, rng, n=N):
    for q, allow in _batches(rng, n):
        t_allow = TorchBitmap(allow) if allow is not None else None
        j_allow = JaxBitmap(allow) if allow is not None else None
        _assert_same(tidx.search_by_vectors(q, K, t_allow), jidx.search_by_vectors(q, K, j_allow))


def _restart_pair(tmp_path, conf, vecs):
    """Build (and compress, when conf has a pq block) in the JAX package,
    then restart each package from its own copy of the shard directory."""
    w = _jax(conf, tmp_path / "w")
    w.add_batch(np.arange(len(vecs)), vecs)
    w.shutdown()
    for name in ("jax", "torch"):
        shutil.copytree(tmp_path / "w", tmp_path / name)
    return _jax(conf, tmp_path / "jax"), _torch(conf, tmp_path / "torch")


# -- compact ---------------------------------------------------------------------------

COMPACT_CASES = {
    "uncompressed": {"distance": "l2-squared", "flatSearchCutoff": 500},
    "cosine": {"distance": "cosine", "flatSearchCutoff": 500},
    "bf16_store": {"distance": "l2-squared", "flatSearchCutoff": 500, "storeDtype": "bfloat16"},
    "pq8_rescore": {"distance": "l2-squared", "flatSearchCutoff": 500, "pq": PQ},
    "pq8_codes": {"distance": "dot", "flatSearchCutoff": 500, "pq": {**PQ, "rescore": False}},
    "pq4": {"distance": "l2-squared", "flatSearchCutoff": 500, "pq": {**PQ, "bits": 4}},
}


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_matches_jax(tmp_path, case):
    """Deletes then compact in both packages from the same shard: the
    tombstoned slots go, the codebooks stay as they were, both answer
    alike before and after, and a restart of the compacted shard (the
    rewritten vector.log) answers the same again."""
    conf = COMPACT_CASES[case]
    vecs, rng = _gauss(1)
    jidx, tidx = _restart_pair(tmp_path, conf, vecs)
    assert tidx.compressed == ("pq" in conf)
    cb = (tidx._pq.codebook.copy(), tidx._pq4.codebook.copy() if tidx._pq4 is not None else None) \
        if tidx.compressed else None
    dead = list(range(0, N, 7)) + list(range(100, 160))
    for idx in (jidx, tidx):
        idx.delete(*dead)
        idx.compact()
    live = N - len(set(dead))
    assert tidx.n == tidx.live == len(tidx) == jidx.n == live
    assert tidx.health()["tombstones"] == 0
    if cb is not None:
        np.testing.assert_array_equal(tidx._pq.codebook, cb[0])
        if cb[1] is not None:
            np.testing.assert_array_equal(tidx._pq4.codebook, cb[1])
        assert tidx.compressed and tidx.health()["pq"]["bits"] == jidx.health()["pq"]["bits"]
    _compare(tidx, jidx, rng, n=N)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = tidx.search_by_vectors(q, K)
    assert not np.isin(want[0].astype(np.int64), dead).any()
    tidx.shutdown()
    again = _torch(conf, tmp_path / "torch")
    _assert_same(again.search_by_vectors(q, K), want)
    assert len(again) == live


@pytest.mark.parametrize("case", ["uncompressed", "pq8_rescore"])
def test_snapshot_pins_arrays_across_delete_and_compact(tmp_path, case):
    """A dispatch enqueued BEFORE a delete and compact finalizes AFTER it
    with the old snapshot's answer; a fresh search sees the new state."""
    conf = COMPACT_CASES[case]
    vecs, _ = _gauss(2)
    _, idx = _restart_pair(tmp_path, conf, vecs)
    q = vecs[:4].copy()
    expect_ids, expect_d = idx.search_by_vectors(q, 3)
    fin = idx.search_by_vectors_async(q, 3)
    for row in expect_ids:
        idx.delete(*(int(d) for d in row))
    idx.compact()
    got_ids, got_d = fin()
    np.testing.assert_array_equal(got_ids, expect_ids)
    np.testing.assert_array_equal(got_d, expect_d)
    new_ids, _ = idx.search_by_vectors(q, 3)
    assert not ({int(x) for x in new_ids.ravel()} & {int(x) for x in expect_ids.ravel()})


def test_compact_keeps_the_declared_compress_from_refitting(tmp_path):
    """A pq block declared at creation: compact re-encodes against the
    codebook it has (the _restoring guard), it never fits a new one."""
    vecs, _ = _gauss(3)
    idx = _torch({"distance": "l2-squared", "pq": PQ}, tmp_path)
    idx.add_batch(np.arange(N), vecs)
    assert idx.compressed
    cb, pq = idx._pq.codebook.copy(), idx._pq
    idx.delete(*range(0, 300))
    idx.compact()
    assert idx._pq is pq and not idx._restoring
    np.testing.assert_array_equal(idx._pq.codebook, cb)


# -- the host fallback plane ----------------------------------------------------------------

def _int_vecs(n=300, d=16, seed=23):
    return np.random.default_rng(seed).integers(-8, 8, (n, d)).astype(np.float32)


def _tie_free(vecs, count, k=5):
    out, i = [], 0
    while len(out) < count:
        q = vecs[i] + 0.5
        i += 1
        d = np.sort(((vecs - q) ** 2).sum(1))[: k + 8]
        if len(np.unique(d)) == len(d):
            out.append(q)
    return np.stack(out)


def test_host_plane_parity_after_pq_recompress_and_compact(tmp_path):
    """The host plane equals the device answer and the JAX package's host
    plane, through a PQ compress and a delete + compact (integer vectors
    are bf16-exact, so the rescored tier and the f32 host plane agree
    exactly), filtered too; the pinned entry agrees with the live one."""
    vecs = _int_vecs()
    k = 5
    conf = {"distance": "l2-squared"}
    jidx, tidx = _jax(conf, tmp_path / "jax"), _torch(conf, tmp_path / "torch")
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(len(vecs)), vecs)
    queries = _tie_free(vecs, 6)
    even = np.arange(0, len(vecs), 2)

    def parity(allow=None):
        host = tidx.search_by_vectors_host(queries, k, TorchBitmap(allow) if allow is not None
                                           else None)
        dev = tidx.search_by_vectors(queries, k, TorchBitmap(allow) if allow is not None
                                     else None)
        ref = jidx.search_by_vectors_host(queries, k, JaxBitmap(allow) if allow is not None
                                          else None)
        for got in (dev, ref):
            np.testing.assert_array_equal(host[0], got[0])
            np.testing.assert_array_equal(host[1], got[1])
        pinned = tidx.search_by_vectors_host_pinned(tidx._snap, queries, k,
                                                    TorchBitmap(allow) if allow is not None
                                                    else None)
        np.testing.assert_array_equal(pinned[0], host[0])
        np.testing.assert_array_equal(pinned[1], host[1])

    parity()
    for idx in (jidx, tidx):
        idx.config.pq.enabled = True
        idx.config.pq.segments = 4
        idx.config.pq.centroids = 16
        idx.compress()
    assert tidx.compressed
    parity()
    for idx in (jidx, tidx):
        idx.delete(*range(0, 29))
        idx.compact()
    assert len(tidx) == len(vecs) - 29
    parity()
    parity(even)


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot", "manhattan"])
def test_host_plane_matches_jax_and_caches_per_generation(tmp_path, metric):
    """search_by_vectors_host equals the JAX package's on gaussian data;
    its rows are copied once per snapshot generation and released on
    request; an empty index answers [B, 0]."""
    vecs, rng = _gauss(4)
    conf = {"distance": metric}
    jidx, tidx = _jax(conf, tmp_path / "jax"), _torch(conf, tmp_path / "torch")
    empty = tidx.search_by_vectors_host(np.zeros((3, D), np.float32), K)
    assert empty[0].shape == (3, 0)
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(N), vecs)
        idx.delete(*range(0, 90, 3))
    q = rng.standard_normal((B, D)).astype(np.float32)
    _assert_same(tidx.search_by_vectors_host(q, K), jidx.search_by_vectors_host(q, K))
    cache = tidx._host_rows_cache
    assert cache is not None and cache[0] == tidx.snapshot_gen
    tidx.search_by_vectors_host(q, K)
    assert tidx._host_rows_cache is cache  # the same generation reuses it
    tidx.delete(5000, 1)
    tidx.search_by_vectors_host(q, K)
    assert tidx._host_rows_cache[0] == tidx.snapshot_gen != cache[0]
    tidx.release_host_fallback_cache()
    assert tidx._host_rows_cache is None and tidx.health()["host_fallback_cache"]["bytes"] == 0


# -- health() -----------------------------------------------------------------------------

# values a device cannot change: the rest (memory components, generations)
# may follow each package's own bookkeeping
_HEALTH_SAME = ("type", "metric", "dim", "capacity", "slots", "live", "tombstones",
                "tombstone_fraction", "pending_adds", "pending_tombstones", "compressed",
                "ivf")


@pytest.mark.parametrize("case", ["uncompressed", "pq8_rescore", "pq4"])
def test_health_matches_jax(tmp_path, case):
    conf = COMPACT_CASES[case]
    vecs, rng = _gauss(5)
    jidx, tidx = _restart_pair(tmp_path, conf, vecs)
    for idx in (jidx, tidx):
        idx.delete(*range(0, 50))
        idx.search_by_vectors(rng.standard_normal((B, D)).astype(np.float32), K)
        idx.search_by_vectors_host(vecs[:4], K)
        idx.add(N + 1, vecs[0])  # one staged add
    hj, ht = jidx.health(), tidx.health()
    assert set(ht) == set(hj)
    for key in _HEALTH_SAME:
        assert ht[key] == hj[key], key
    assert set(ht["host_fallback_cache"]) == set(hj["host_fallback_cache"])
    assert ht["host_fallback_cache"]["resident"] == hj["host_fallback_cache"]["resident"]
    assert ht["host_fallback_cache"]["bytes"] == hj["host_fallback_cache"]["bytes"]
    assert set(ht["memory"]) == set(hj["memory"])
    for name in ("slot_to_doc", "host_tombs", "host_vecs", "pending_rows", "breaker_rows"):
        assert ht["memory"]["host_components"].get(name) == \
            hj["memory"]["host_components"].get(name), name
    for name in ("store", "sq_norms", "tombs", "pq_codes", "recon_norms", "rescore_store",
                 "pq4_codes", "pq4_norms"):
        assert ht["memory"]["device_components"].get(name) == \
            hj["memory"]["device_components"].get(name), name
    if hj["pq"] is None:
        assert ht["pq"] is None
    else:
        assert set(ht["pq"]) == set(hj["pq"])
        for key, val in hj["pq"].items():
            if key == "funnel":
                assert set(ht["pq"]["funnel"]) == set(val)
                for fk in ("stage1_c", "stage2_rescore", "c_cap", "rescore_cap", "dispatches",
                           "mean_stage1_rows", "mean_stage2_survivors",
                           "mean_stage3_survivors"):
                    assert ht["pq"]["funnel"][fk] == val[fk], fk
            else:
                assert ht["pq"][key] == val, key


# -- the staging pool -------------------------------------------------------------------------

def test_staging_pool_matches_jax(tmp_path):
    """The same dispatches in both packages park the same buffers: one per
    (padded batch, dim) after sync searches, reused by the next search of
    that shape, out of the pool while an async dispatch is in flight, back
    after its fetch, and never re-parked after drop."""
    vecs, rng = _gauss(6)
    conf = {"distance": "l2-squared"}
    jidx, tidx = _jax(conf, tmp_path / "jax"), _torch(conf, tmp_path / "torch")
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(N), vecs)
    q = rng.standard_normal((B, D)).astype(np.float32)

    def pool(idx):
        return {key: len(v) for key, v in idx._stage_free.items()}

    for idx in (jidx, tidx):
        idx.search_by_vectors(q, K)
        idx.search_by_vectors(q[:3], K)
    assert pool(tidx) == pool(jidx) == {(16, D): 1, (4, D): 1}
    buf = tidx._stage_free[(16, D)][0]
    tidx.search_by_vectors(q, K)
    assert tidx._stage_free[(16, D)][0] is buf  # reused, not reallocated
    fins = {}
    for name, idx in (("jax", jidx), ("torch", tidx)):
        fins[name] = [idx.search_by_vectors_async(q, K), idx.search_by_vectors_async(q, K)]
    assert pool(tidx) == pool(jidx) == {(16, D): 0, (4, D): 1}
    outs = [f() for f in fins["torch"]]
    for f in fins["jax"]:
        f()
    assert pool(tidx) == pool(jidx) == {(16, D): 2, (4, D): 1}
    _assert_same(outs[0], outs[1])
    # an in-flight dispatch that finalizes after drop() parks nothing
    late = {name: idx.search_by_vectors_async(q, K) for name, idx in (("jax", jidx),
                                                                        ("torch", tidx))}
    for idx in (jidx, tidx):
        idx.drop()
    for f in late.values():
        f()
    assert tidx._stage_free == jidx._stage_free == {}


def test_a_failed_fetch_does_not_park_its_buffer(tmp_path):
    """A finalize that fails before its fetch completes strands its buffer
    (a retry may still read it): the retry answers, and the buffer never
    goes back (the first attempt settled the dispatch)."""
    from weaviate_tpu_torch.testing import faults

    vecs, rng = _gauss(7)
    idx = _torch({"distance": "l2-squared"}, tmp_path)
    idx.add_batch(np.arange(N), vecs)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = idx.search_by_vectors(q, K)
    idx._stage_free.clear()
    inj = faults.configure(faults.FaultInjector())
    try:
        inj.plan("index.gpu.finalize", "device_error", times=1)
        fin = idx.search_by_vectors_async(q, K)
        with pytest.raises(faults.InjectedDeviceError):
            fin()
        assert idx._stage_free.get((16, D), []) == []
        _assert_same(fin(), want)  # the retry is allowed
        assert idx._stage_free.get((16, D), []) == []
    finally:
        faults.unconfigure(inj)


# -- the per-thread dispatch facts ------------------------------------------------------------

def test_dispatch_facts(tmp_path):
    """pop_read_lock_wait, snapshot_gen, pop_dispatch_shape (only while a
    tracer is up, with the tier and one fetch stamped) and
    pop_audit_snapshot (only while an auditor is configured)."""
    from weaviate_tpu_torch.monitoring import quality

    vecs, rng = _gauss(8)
    idx = _torch({"distance": "l2-squared", "flatSearchCutoff": 500}, tmp_path)
    assert idx.snapshot_gen == 0 and idx.async_supports_filters
    idx.add_batch(np.arange(N), vecs)
    q = rng.standard_normal((B, D)).astype(np.float32)
    idx.search_by_vectors(q, K)
    assert idx.snapshot_gen >= 1
    assert idx.pop_read_lock_wait() == 0.0 and idx.pop_dispatch_shape() is None
    idx.delete(3)  # the next read flushes under the lock
    idx.search_by_vectors(q, K)
    assert idx.pop_read_lock_wait() >= 0.0
    assert idx.pop_audit_snapshot() is None
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0))
    try:
        for allow, tier in ((None, costmodel.TIER_EXACT),
                            (TorchBitmap(np.arange(0, 300)), costmodel.TIER_GATHER)):
            idx.search_by_vectors(q, K, allow)
            shape = idx.pop_dispatch_shape()
            assert shape.tier == tier and shape.fetches == 1 and shape.fused
            # the blocked fetch; no CUDA events time the device on the CPU
            assert shape.fetch_ms >= 0.0 and shape.device_ms == -1.0 and shape.batch == B
            assert idx.pop_dispatch_shape() is None  # reading clears it
    finally:
        tracing.unconfigure(tracer)
    aud = quality.configure(quality.QualityAuditor(sample_rate=0.0))
    try:
        idx.search_by_vectors(q, K)
        assert idx.pop_audit_snapshot() is idx._snap
        assert idx.pop_audit_snapshot() is None
    finally:
        quality.unconfigure(aud)


# -- storeDtype: bfloat16 ---------------------------------------------------------------------

BF16 = {"distance": "l2-squared", "flatSearchCutoff": 500, "storeDtype": "bfloat16"}


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot"])
def test_bf16_store_matches_jax(tmp_path, metric):
    """The same bf16-store index in both packages answers alike on every
    tier: the fast scan (K1 on the bf16 store), the chunked scan, the
    masked scan and the gather tier."""
    vecs, rng = _gauss(9)
    conf = {**BF16, "distance": metric}
    jidx, tidx = _jax(conf, tmp_path / "jax"), _torch(conf, tmp_path / "torch")
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(N), vecs)
        idx.delete(*range(0, 60, 3))
    assert tidx._store.dtype == torch.bfloat16
    assert tidx._use_gmin(tidx._read_snapshot(), B, K)
    _compare(tidx, jidx, rng)


def test_bf16_store_writes_growth_and_replay(tmp_path):
    """Writes past the first capacity grow the store in bf16; singles,
    re-adds and deletes replay from vector.log into a bf16 store; a shard
    written by either package restores in the other."""
    vecs, rng = _gauss(10, n=20000)
    for writer in ("jax", "torch"):
        path = tmp_path / writer
        w = (_jax if writer == "jax" else _torch)(BF16, path)
        w.add_batch(np.arange(19000), vecs[:19000])  # past the 16384 of the first store
        for i in range(19000, 19100):
            w.add(i, vecs[i])
        w.add(7, vecs[8])
        w.delete(*range(200, 260))
        q = rng.standard_normal((B, D)).astype(np.float32)
        want = w.search_by_vectors(q, K)
        w.shutdown()
        for reader in (_jax, _torch):
            r = reader(BF16, path)
            assert len(r) == 19100 - 60
            _assert_same(r.search_by_vectors(q, K), want)
            if reader is _torch:
                assert r._store.dtype == torch.bfloat16 and r.capacity == 32768
            r.shutdown()


@pytest.mark.parametrize("restart", [False, True])
def test_bf16_store_recall_fixture(tmp_path, restart):
    """recall@10 >= 0.99 on the committed recall fixture with a bf16
    store, and again after a vector.log replay."""
    data = np.load(FIXTURE)
    vectors, queries = data["vectors"].astype(np.float32), data["queries"].astype(np.float32)
    idx = _torch({"distance": "l2-squared", "storeDtype": "bfloat16"}, tmp_path)
    idx.add_batch(np.arange(len(vectors)), vectors)
    if restart:
        idx.shutdown()
        idx = _torch({"distance": "l2-squared", "storeDtype": "bfloat16"}, tmp_path)
    assert idx._use_gmin(idx._read_snapshot(), len(queries), K)
    ids, _ = idx.search_by_vectors(queries, K)
    gt = data["gt"]
    hits = sum(len(set(gt[i][:K].tolist()) & {int(x) for x in ids[i] if x != SENTINEL})
               for i in range(len(queries)))
    assert hits / (len(queries) * K) >= 0.99


@pytest.mark.parametrize("form", ["bf16", "uint16", "float32"])
def test_bf16_state_carried_from_jax(tmp_path, form):
    """A JAX bf16 store carried across with state_from_arrays(...,
    store_dtype="bfloat16"): as bf16 values, their bits as uint16, or
    upcast to f32, it installs as the port's bf16 store and answers like
    the JAX index."""
    vecs, rng = _gauss(11)
    jidx = _jax(BF16, tmp_path / "jax")
    jidx.add_batch(np.arange(N), vecs)
    jidx.delete(*range(0, 100, 3))
    snap = jidx._read_snapshot()
    store = np.asarray(snap.store)
    store = {"bf16": store, "uint16": store.view(np.uint16),
             "float32": store.astype(np.float32)}[form]
    arrays = {"store": store, "sq_norms": np.asarray(snap.sq_norms),
              "tombs": np.asarray(snap.tombs), "slot_to_doc": snap.slot_to_doc,
              "n": snap.n, "capacity": snap.capacity, "dim": snap.dim}
    tidx = _torch(BF16, tmp_path / "carried")
    tidx.load_state(state_from_arrays(arrays, device="cpu", store_dtype="bfloat16"))
    assert tidx._store.dtype == torch.bfloat16
    np.testing.assert_array_equal(tidx._store.float().numpy(), np.asarray(snap.store, np.float32))
    _compare(tidx, jidx, rng)


def test_store_dtype_config_checks():
    from weaviate_tpu_torch.config.config import store_dtype_from_env

    for dt in ("float32", "bfloat16"):
        assert tvi.parse_and_validate_config("hnsw_tpu", {"storeDtype": dt}).store_dtype == dt
        assert store_dtype_from_env({"TPU_STORE_DTYPE": dt}) == dt
    assert store_dtype_from_env({}) == "float32"
    with pytest.raises(tvi.ConfigValidationError, match="storeDtype"):
        tvi.parse_and_validate_config("hnsw_tpu", {"storeDtype": "float16"})
    with pytest.raises(ValueError, match="STORE_DTYPE"):
        store_dtype_from_env({"TPU_STORE_DTYPE": "int8"})


# -- the device-sync sanitizer over the port's fetch -----------------------------------------

def test_sanitizer_catches_the_port_fetch_under_the_index_lock(tmp_path):
    """The port's sanitizer patches its own fetch points (the index's
    `_fetch_packed` and torch.cuda.synchronize): a finalize run while the
    index lock is held is one violation keyed on the caller's site, and a
    finalize outside the lock is clean."""
    from weaviate_tpu_torch.index import gpu
    from weaviate_tpu_torch.testing import sanitizers

    assert sanitizers.get_sanitizer() is None
    san = sanitizers.configure(sanitizers.GraftSan(frozenset({"lock", "sync"}), baseline=[]))
    try:
        assert gpu._fetch_packed is not sanitizers._patched["fetch"]
        vecs, rng = _gauss(12)
        idx = _torch({"distance": "l2-squared"}, tmp_path)
        idx.add_batch(np.arange(N), vecs)
        q = rng.standard_normal((B, D)).astype(np.float32)
        idx.search_by_vectors(q, K)
        assert [v for v in san.violations() if v.kind == "sync-under-lock"] == []

        def finalize_under_lock():
            fin = idx.search_by_vectors_async(q, K)
            with idx._lock:
                return fin()

        finalize_under_lock()
        vs = [v for v in san.violations() if v.kind == "sync-under-lock"]
        assert [v.key for v in vs] == [("sync-under-lock", "index.tpu", "finalize")]
        assert "index.gpu._fetch_packed" in vs[0].message
    finally:
        sanitizers.unconfigure(san)
    assert gpu._fetch_packed is not None and sanitizers._patched is None


def test_vector_log_rewrite_bytes_equal_jax(tmp_path):
    """The compaction's log rewrite (encoded in runs) writes the bytes the
    JAX package's per-record rewrite writes, so a compacted shard's log
    is the shared format."""
    from weaviate_tpu.index.tpu import VectorLog as JaxLog
    from weaviate_tpu_torch.index.gpu import VectorLog

    rng = np.random.default_rng(13)
    docs = rng.choice(1 << 40, 70000, replace=False).astype(np.int64)
    vecs = rng.standard_normal((70000, 12)).astype(np.float32)
    ours, theirs = VectorLog(str(tmp_path / "a" / "vector.log")), JaxLog(
        str(tmp_path / "b" / "vector.log"))
    ours.rewrite(docs, vecs)
    theirs.rewrite(zip(docs.tolist(), vecs))
    ours.close()
    theirs.close()
    a, b = (tmp_path / "a" / "vector.log").read_bytes(), (tmp_path / "b" / "vector.log").read_bytes()
    assert a == b and len(a) == 6 + 70000 * (17 + 48)


def test_staging_pool_under_concurrent_dispatches(tmp_path):
    """More threads than cores dispatch and finalize searches of their own
    queries through one index, with a short switch interval: every answer
    is its own query's (no buffer handed to two dispatches at once), and
    the pool ends within its cap per shape."""
    import os
    import sys
    import threading

    vecs, rng = _gauss(14)
    idx = _torch({"distance": "l2-squared"}, tmp_path)
    idx.add_batch(np.arange(N), vecs)
    workers = 2 * (os.cpu_count() or 4)
    qs = [rng.standard_normal((int(rng.choice([3, 16])), D)).astype(np.float32)
          for _ in range(workers)]
    want = [idx.search_by_vectors(q, K) for q in qs]
    bad, done = [], []

    def run(i):
        for _ in range(15):
            fins = [idx.search_by_vectors_async(qs[i], K) for _ in range(2)]
            for fin in fins:
                got = fin()
                if not (np.array_equal(got[0], want[i][0]) and np.array_equal(got[1], want[i][1])):
                    bad.append(i)
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and sorted(done) == list(range(workers))
    assert bad == []
    assert all(len(v) <= idx._STAGE_POOL_CAP for v in idx._stage_free.values())


def test_filter_resolutions_are_cached_on_the_allow_list(tmp_path):
    """The port's Bitmap holds both per-snapshot caches the index writes:
    the gather tier's slot list and the masked scan's device words."""
    vecs, rng = _gauss(15)
    idx = _torch({"distance": "l2-squared", "flatSearchCutoff": 500}, tmp_path)
    idx.add_batch(np.arange(N), vecs)
    q = rng.standard_normal((B, D)).astype(np.float32)
    small, large = TorchBitmap(np.arange(0, 300)), TorchBitmap(np.arange(0, N, 2))
    idx.search_by_vectors(q, K, small)
    idx.search_by_vectors(q, K, large)
    slots, words = small._slots_cache, large._words_cache
    idx.search_by_vectors(q, K, small)
    idx.search_by_vectors(q, K, large)
    assert small._slots_cache is slots and large._words_cache is words
