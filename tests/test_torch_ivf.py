"""The port's IVF scan plane through GpuVectorIndex, on the CPU: the
contracts of tests/test_ivf.py and the probed funnel of
tests/test_pq4_funnel.py restated for the port, and the port against the
JAX TpuVectorIndex on the same data (the same layout, the same answers),
directly, through a shared shard directory, and through state_from_arrays.

Data is gaussian (tie-free: `torch.topk` orders ties unlike `lax.top_k`).
Tolerances: ids exact; distances rtol 1e-5, atol 1e-5 (f32 rescores in
another summation order; the flat exact scan's matmul form against the
IVF rescore's difference form), ADC distances atol 1e-4.
"""

import numpy as np
import pytest

from weaviate_tpu.config.config import IvfConfig as JIvfConfig
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import tpu
from weaviate_tpu.index.tpu import TpuVectorIndex
from weaviate_tpu_torch.config.config import IvfConfig
from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
from weaviate_tpu_torch.index import gpu
from weaviate_tpu_torch.index.gpu import GpuVectorIndex
from weaviate_tpu_torch.monitoring import memory, tracing
from weaviate_tpu_torch.serving import controller
from weaviate_tpu_torch.serving.controller import KNOB_IVF_TOP_P, ControlPlane
from weaviate_tpu_torch.state import state_from_arrays
from weaviate_tpu_torch.storage.bitmap import Bitmap

DIM = 16
PQ = {"enabled": True, "segments": 8, "centroids": 16}


@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    gpu.set_ivf_config(None)
    gpu.set_fused_enabled(None)
    tpu.set_ivf_config(None)
    tpu.set_fused_enabled(None)
    tracing.configure(None)
    controller.configure(None)


def _ivf_kw(**kw):
    base = dict(enabled=True, nlist=8, min_n=256, top_p=8, train_sample=4096, train_iters=4)
    base.update(kw)
    return base


def _ivf(**kw) -> IvfConfig:
    return IvfConfig(**_ivf_kw(**kw))


def _vecs(n, seed=3):
    return (10.0 * np.random.default_rng(seed).standard_normal((n, DIM))).astype(np.float32)


def _mk_index(tmp_path, n=600, pq=None, seed=3, name="ivfx", persist=False, **cfg_extra):
    vecs = _vecs(n, seed)
    d = {"distance": "l2-squared", **cfg_extra}
    if pq is not None:
        d["pq"] = pq
    idx = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", d), str(tmp_path / name),
                         device="cpu", persist=persist)
    idx.add_batch(np.arange(n), vecs)
    idx.flush()
    return idx, vecs


def _same(got, want, atol=1e-5, msg=""):
    np.testing.assert_array_equal(got[0], want[0], err_msg=msg)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=atol, err_msg=msg)


def _recall(ids, gt):
    return np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids.tolist(), gt.tolist())])


# -- 1. top_p = all == flat, every tier, sync + async, fused + staged ---------


_TIERS = {
    "exact": dict(exactTopK=True),
    "fast_scan": {},
    "bf16_store": dict(storeDtype="bfloat16"),
    "filtered_scan": dict(exactTopK=True),
    # the fast scan over the bf16 copy and its f32 rescore (under exactTopK
    # the flat tier reports the bf16 scan's own distances)
    "pq_rescore": dict(pq=PQ),
    "pq_codes": dict(pq={**PQ, "rescore": False}, exactTopK=True),
    "pq4_funnel": dict(pq={**PQ, "bits": 4}),
}


@pytest.mark.parametrize("tier", list(_TIERS))
def test_top_p_all_matches_flat_all_tiers_sync_async(tmp_path, tier):
    gpu.set_ivf_config(_ivf())  # trains at import (min_n < n)
    idx, vecs = _mk_index(tmp_path, name=tier, **_TIERS[tier])
    assert idx._ivf_buckets is not None
    if tier.startswith("pq"):
        assert idx.compressed
    allow = (Bitmap(np.arange(0, idx.config.flat_search_cutoff + 64, dtype=np.uint64))
             if tier == "filtered_scan" else None)
    # fresh queries: no query sits on a row, where the flat exact scan's
    # matmul form loses digits to cancellation
    q = _vecs(9, seed=99)
    atol = 1e-4 if tier == "pq_codes" else 1e-5
    for fused in (True, False):
        gpu.set_fused_enabled(fused)
        gpu.set_ivf_config(_ivf())  # top_p 8 == nlist: every partition probed
        before = idx.ivf_stats()["dispatches"]
        i_sync = idx.search_by_vectors(q, 10, allow)
        i_async = idx.search_by_vectors_async(q, 10, allow)()
        assert idx.ivf_stats()["dispatches"] == before + 2
        gpu.set_ivf_config(None)  # the flat tiers on the same index
        flat = idx.search_by_vectors(q, 10, allow)
        _same(i_sync, flat, atol, f"{tier} fused={fused} sync")
        _same(i_async, flat, atol, f"{tier} fused={fused} async")
        assert i_sync[0].dtype == np.uint64 and i_sync[1].dtype == np.float32


def test_ivf_target_distance_matches_flat(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, vecs = _mk_index(tmp_path, exactTopK=True)
    q = vecs[5] + np.float32(1.0)
    ids_i, d_i = idx.search_by_vector_distance(q, 1500.0, 64)
    gpu.set_ivf_config(None)
    ids_f, d_f = idx.search_by_vector_distance(q, 1500.0, 64)
    np.testing.assert_allclose(d_i, d_f, rtol=1e-5)
    assert ids_i.tolist() == ids_f.tolist() and len(ids_i) > 0


# -- 2. disabled = a no-op ----------------------------------------------------


def test_ivf_disabled_is_true_noop(tmp_path):
    idx, _ = _mk_index(tmp_path)
    assert idx._ivf_centroids is None and idx._ivf_buckets is None
    snap = idx._read_snapshot()
    assert snap.ivf_buckets is None and idx._ivf_plan(snap, 10) is None
    assert not any(k.startswith("ivf") for k in idx._memory_components())
    assert idx.ivf_stats()["dispatches"] == 0
    assert idx.health()["ivf"] == {"enabled": False, "trained": False}


def test_ivf_enabled_below_min_n_does_not_train(tmp_path):
    gpu.set_ivf_config(_ivf(min_n=100000))
    idx, _ = _mk_index(tmp_path)
    assert idx._ivf_centroids is None
    ids, _d = idx.search_by_vectors(np.zeros(DIM, np.float32)[None], 5)
    assert ids.shape == (1, 5)


def test_ivf_skips_non_matmul_metrics(tmp_path):
    gpu.set_ivf_config(_ivf())
    vecs = np.random.default_rng(0).integers(0, 2, (600, DIM)).astype(np.float32)
    idx = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", {"distance": "manhattan"}),
                         str(tmp_path / "man"), device="cpu", persist=False)
    idx.add_batch(np.arange(600), vecs)
    idx.flush()
    assert idx._ivf_centroids is None
    assert idx.search_by_vectors(vecs[:3], 5)[0].shape[0] == 3


# -- 3. training / layout ------------------------------------------------------


def test_training_publishes_a_complete_layout(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, _ = _mk_index(tmp_path)
    snap = idx._read_snapshot()
    nlist, cap_p, gen = snap.ivf_meta
    assert nlist == 8 and gen == 1
    buckets = snap.ivf_buckets.numpy()
    assert buckets.shape == (nlist, cap_p)
    assert sorted(buckets[buckets >= 0].tolist()) == list(range(600))
    assert int(idx._ivf_fills.sum()) == 600


def test_bucket_shapes_stay_stable_across_small_inserts(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, _ = _mk_index(tmp_path)
    cap_p0, gen0 = idx._ivf_meta[1], idx._ivf_gen
    old = idx._read_snapshot()
    old_buckets = old.ivf_buckets.clone()
    extra = _vecs(16, seed=9)
    idx.add_batch(np.arange(600, 616), extra)
    idx.flush()
    assert idx._ivf_gen == gen0 and idx._ivf_meta[1] == cap_p0
    buckets = idx._read_snapshot().ivf_buckets.numpy()
    assert sorted(buckets[buckets >= 0].tolist()) == list(range(616))
    # the fold scattered into a copy: the older snapshot's table is intact
    assert old.ivf_buckets.equal(old_buckets)
    ids, _ = idx.search_by_vectors(extra[:3], 1)
    assert ids[:, 0].tolist() == [600, 601, 602]


def test_growth_triggers_recluster(tmp_path):
    gpu.set_ivf_config(_ivf(retrain_growth=0.5))
    idx, _ = _mk_index(tmp_path)
    gen0 = idx._ivf_gen
    idx.add_batch(np.arange(1000, 1400), _vecs(400, seed=11))
    idx.flush()
    assert idx._ivf_gen == gen0 + 1 and idx._ivf_trained_n == 1000


def test_ivf_respects_deletes_and_readds(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, vecs = _mk_index(tmp_path, exactTopK=True)
    q = vecs[7][None, :]
    assert int(idx.search_by_vectors(q, 3)[0][0, 0]) == 7
    idx.delete(7)
    assert 7 not in idx.search_by_vectors(q, 3)[0][0].tolist()
    idx.add(7, vecs[7])
    assert int(idx.search_by_vectors(q, 3)[0][0, 0]) == 7


def test_small_allowlist_keeps_the_gather_tier(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, vecs = _mk_index(tmp_path, exactTopK=True)
    before = idx.ivf_stats()["dispatches"]
    allow = Bitmap(np.array([3, 7, 11, 401], dtype=np.uint64))
    q = vecs[:4] + np.float32(1.0)
    got = idx.search_by_vectors(q, 4, allow)
    gpu.set_ivf_config(None)
    _same(got, idx.search_by_vectors(q, 4, allow))
    assert idx.ivf_stats()["dispatches"] == before


def test_probe_prunes_and_keeps_recall_on_clustered_data(tmp_path):
    rng = np.random.default_rng(1)
    n = 4000
    centers = rng.standard_normal((64, DIM)).astype(np.float32) * 8
    vecs = (centers[rng.integers(0, 64, n)]
            + 0.3 * rng.standard_normal((n, DIM)).astype(np.float32))
    gpu.set_ivf_config(_ivf(nlist=64, top_p=8, min_n=512))
    idx = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                         str(tmp_path / "clu"), device="cpu", persist=False)
    idx.add_batch(np.arange(n), vecs)
    q = vecs[:32] + np.float32(0.01)
    d = ((q[:, None, :] - vecs[None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :10]
    ids, _ = idx.search_by_vectors(q, 10)
    assert _recall(ids, gt) >= 0.95
    st = idx.ivf_stats()
    assert st["probed_fraction"] is not None and st["probed_fraction"] < 1.0


def test_pca_prefilter_cuts_candidates_and_keeps_recall(tmp_path):
    gpu.set_ivf_config(_ivf(pca_dim=8))
    idx, vecs = _mk_index(tmp_path, n=1200, name="pca")
    snap = idx._read_snapshot()
    assert snap.ivf_pca_proj is not None and snap.ivf_pca_rows is not None
    top_p, pre_c = idx._ivf_plan(snap, 10)
    assert 0 < pre_c < top_p * snap.ivf_meta[1]
    q = vecs[:16] + np.float32(1.0)
    ids, _ = idx.search_by_vectors(q, 10)
    gpu.set_ivf_config(None)
    assert _recall(ids, idx.search_by_vectors(q, 10)[0]) >= 0.9


@pytest.mark.parametrize("pq", [None, PQ, {**PQ, "bits": 4}], ids=["exact", "pq", "pq4"])
def test_enqueued_dispatch_survives_recluster_and_compact(tmp_path, pq):
    """Enqueue on an old snapshot, then delete the winners, force a
    recluster and a compact underneath: finalize returns the old
    layout's answer."""
    gpu.set_ivf_config(_ivf())
    idx, vecs = _mk_index(tmp_path, pq=pq)
    q = vecs[:5] + np.float32(1.0)
    expected = idx.search_by_vectors(q, 10)
    fin = idx.search_by_vectors_async(q, 10)
    idx.delete(*set(int(i) for i in expected[0][:, 0]))
    idx.add_batch(np.arange(2000, 2600), _vecs(600, seed=21))  # growth: recluster
    idx.compact()
    assert idx._ivf_gen >= 2
    _same(fin(), expected)


def test_compact_reclusters_on_the_dense_slot_space(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, vecs = _mk_index(tmp_path)
    gen0 = idx._ivf_gen
    idx.delete(*range(0, 200))
    idx.compact()
    assert idx._ivf_gen == gen0 + 1
    buckets = idx._read_snapshot().ivf_buckets.numpy()
    assert sorted(buckets[buckets >= 0].tolist()) == list(range(400))
    assert int(idx.search_by_vectors(vecs[300][None], 3)[0][0, 0]) == 300


# -- 4. observability -----------------------------------------------------------


def test_health_reports_partition_layout(tmp_path):
    gpu.set_ivf_config(_ivf())
    idx, vecs = _mk_index(tmp_path)
    idx.search_by_vectors(vecs[:3], 5)
    h = idx.health()["ivf"]
    assert h["enabled"] and h["trained"] and h["nlist"] == 8
    assert h["last_recluster_gen"] == 1
    b = h["buckets"]
    assert 0 <= b["fill_min"] <= b["fill_max"] <= h["bucket_capacity"]
    assert 0.0 <= b["padding_waste"] < 1.0 and b["imbalance"] >= 1.0
    assert len(b["fill_histogram"]) == 8 and sum(b["fill_histogram"]) == 8
    assert h["probes"]["dispatches"] >= 1 and h["probes"]["probed_fraction"] > 0


def test_new_slabs_are_ledger_accounted_bit_equal(tmp_path):
    gpu.set_ivf_config(_ivf(pca_dim=8))
    idx, _ = _mk_index(tmp_path, name="led")
    comps = idx._memory_components()
    for name, t in (("ivf_centroids", idx._ivf_centroids),
                    ("ivf_buckets", idx._ivf_buckets),
                    ("ivf_pca_proj", idx._ivf_pca_proj),
                    ("ivf_pca_rows", idx._ivf_pca_rows)):
        assert name in memory.DEVICE_COMPONENTS
        assert comps[name] == t.numel() * t.element_size()
    host = memory.index_host_components(idx)
    assert host["ivf_host"] == (idx._ivf_centroids_host.nbytes + idx._ivf_pca_host.nbytes
                                + idx._ivf_assign.nbytes)
    idx.drop()
    assert not any(k.startswith("ivf") for k in idx._memory_components())
    assert "ivf_host" not in memory.index_host_components(idx)


def test_top_p_snap_matches_the_reference():
    for v in (1, 5, 7, 128, 300, 4096, 5000, 10000, 20000):
        assert gpu._snap_top_p(v) == tpu._snap_top_p(v), v


def test_dispatch_shape_carries_probed_aware_flops(tmp_path):
    gpu.set_ivf_config(_ivf(nlist=8, top_p=2))
    idx, vecs = _mk_index(tmp_path, n=2000, name="shape")
    tracing.configure(tracing.Tracer(sample_rate=1.0))
    idx.search_by_vectors(vecs[:4], 10)
    shape = idx.pop_dispatch_shape()
    nlist, cap_p, _ = idx._ivf_meta
    probed = 2 * cap_p + nlist
    assert shape.n == probed < 2000
    d = shape.describe()
    assert d["ivf"] is True and d["ivf_top_p"] == 2 and 0 < d["probed_fraction"] < 1.0
    assert shape.flops() == int(round(2.0 * 4 * probed * DIM))


def test_deep_k_widens_the_probe_for_coverage(tmp_path):
    gpu.set_ivf_config(_ivf(nlist=8, top_p=1))
    idx, vecs = _mk_index(tmp_path, name="deepk")
    snap = idx._read_snapshot()
    cap_p = snap.ivf_meta[1]
    assert idx._ivf_plan(snap, 10)[0] == 1
    top_p = idx._ivf_plan(snap, cap_p)[0]
    assert top_p * cap_p >= min(4 * cap_p, 8 * cap_p)
    assert idx.search_by_vectors(vecs[:2], cap_p)[0].shape[1] >= min(cap_p, 600)


def test_controller_cap_steers_the_live_probe_count(tmp_path):
    gpu.set_ivf_config(_ivf(nlist=8, top_p=8))
    idx, vecs = _mk_index(tmp_path, name="steer")
    snap = idx._read_snapshot()
    assert idx._ivf_plan(snap, 10)[0] == 8
    p = ControlPlane(start=False)
    controller.configure(p)
    p._set_knob(KNOB_IVF_TOP_P, 2, "budget")
    assert idx._ivf_plan(snap, 10)[0] == 2
    assert idx.search_by_vectors(vecs[:3], 5)[0].shape == (3, 5)
    controller.configure(None)
    assert idx._ivf_plan(snap, 10)[0] == 8


def test_ivf_settings_env_fallback_and_token_revert(monkeypatch):
    gpu.set_ivf_config(None)
    monkeypatch.delenv("IVF_ENABLED", raising=False)
    assert gpu.ivf_settings() is None
    monkeypatch.setenv("IVF_ENABLED", "true")
    monkeypatch.setenv("IVF_NLIST", "32")
    gpu.set_ivf_config(None)  # revert means re-read
    assert gpu.ivf_settings().nlist == 32
    tok = gpu.set_ivf_config(IvfConfig(enabled=False))
    assert gpu.ivf_settings() is None
    tok2 = gpu.set_ivf_config(IvfConfig(enabled=True, nlist=4))
    gpu.unset_ivf_config(tok)  # stale: the newer override survives
    assert gpu.ivf_settings().nlist == 4
    gpu.unset_ivf_config(tok2)
    assert gpu.ivf_settings().nlist == 32


# -- 5. the probed 4-bit funnel (tests/test_pq4_funnel.py:152) ----------------


def test_funnel_composes_with_ivf_probe(tmp_path):
    """top_p = all partitions and budgets >= n: the probed funnel gives the
    exact answer (integer rows: the bf16 rescore copy holds them exactly,
    so the distances are exact; ids compare as sets, ties allowed)."""
    gpu.set_ivf_config(_ivf(min_n=64))
    vecs = np.random.default_rng(5).integers(-100, 100, (600, DIM)).astype(np.float32)
    idx = GpuVectorIndex(parse_and_validate_config(
        "hnsw_tpu", {"distance": "l2-squared", "pq": {**PQ, "bits": 4}}),
        str(tmp_path / "ivf4"), device="cpu", persist=False)
    idx.add_batch(np.arange(600), vecs)
    assert idx._ivf_centroids is not None and idx._codes4 is not None
    q = vecs[:10] + np.float32(0.25)
    d = ((q[:, None, :] - vecs[None]) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    for fused in (True, False):
        gpu.set_fused_enabled(fused)
        before = idx.health()["pq"]["funnel"]["dispatches"]
        ids, dists = idx.search_by_vectors(q, 5)
        assert idx.health()["pq"]["funnel"]["dispatches"] == before + 1
        for i in range(len(q)):
            np.testing.assert_allclose(dists[i], d[i, want[i]], rtol=0, atol=1e-4)
            assert set(ids[i].tolist()) == set(want[i].tolist())
    allow = Bitmap(np.arange(100, 200).astype(np.uint64))
    ids_f, _ = idx.search_by_vectors(q, 5, allow_list=allow)
    flat = ids_f.ravel()
    assert flat.size and all(100 <= int(x) < 200 for x in flat)


# -- 6. the port against the JAX index ------------------------------------------


def _jax_index(tmp_path, name, conf, persist=False):
    return TpuVectorIndex(jvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path / name),
                          persist=persist)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
@pytest.mark.parametrize("pca", [0, 8])
def test_same_layout_and_answers_as_the_jax_index(tmp_path, metric, store, pca):
    kw = _ivf_kw(nlist=16, top_p=4, pca_dim=pca)
    gpu.set_ivf_config(IvfConfig(**kw))
    tpu.set_ivf_config(JIvfConfig(**kw))
    conf = {"distance": metric, "storeDtype": store}
    vecs = _vecs(3000, seed=8)
    tidx = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", conf), str(tmp_path / "t"),
                          device="cpu", persist=False)
    jidx = _jax_index(tmp_path, "j", conf)
    for idx in (tidx, jidx):
        idx.add_batch(np.arange(3000), vecs)
        idx.delete(*range(0, 300, 7))
        idx.flush()
    np.testing.assert_array_equal(tidx._ivf_buckets.numpy(), np.asarray(jidx._ivf_buckets))
    np.testing.assert_array_equal(tidx._ivf_centroids.numpy(), np.asarray(jidx._ivf_centroids))
    assert tidx._ivf_meta == jidx._ivf_meta
    q = _vecs(16, seed=9)
    allow_t = Bitmap(np.arange(0, 3000, 2, dtype=np.uint64))
    from weaviate_tpu.storage.bitmap import Bitmap as JBitmap
    allow_j = JBitmap(np.arange(0, 3000, 2, dtype=np.uint64))
    for fused in (True, False):
        gpu.set_fused_enabled(fused)
        tpu.set_fused_enabled(fused)
        _same(tidx.search_by_vectors(q, 10), jidx.search_by_vectors(q, 10))
        _same(tidx.search_by_vectors(q, 10, allow_t), jidx.search_by_vectors(q, 10, allow_j))
    assert tidx.ivf_stats()["probed_rows"] == jidx.ivf_stats()["probed_rows"]


@pytest.mark.parametrize("pq", [{**PQ, "rescore": False}, {**PQ, "bits": 4}],
                         ids=["pq_codes", "pq4_funnel"])
def test_jax_written_compressed_shard_probes_alike_in_the_port(tmp_path, pq):
    """A compressed shard written by the JAX index restarts in the port with
    the same codebooks; both retrain the same layout from the same rows and
    give the same answers on the codes and funnel tiers."""
    kw = _ivf_kw(nlist=16, top_p=4)
    gpu.set_ivf_config(IvfConfig(**kw))
    tpu.set_ivf_config(JIvfConfig(**kw))
    conf = {"distance": "l2-squared", "pq": pq}
    vecs = _vecs(3000, seed=12)
    jidx = _jax_index(tmp_path, "shard", conf, persist=True)
    jidx.add_batch(np.arange(3000), vecs)
    jidx.flush()
    jidx.shutdown()
    jidx = _jax_index(tmp_path, "shard", conf, persist=True)
    jidx.post_startup()
    want_buckets = np.asarray(jidx._read_snapshot().ivf_buckets)
    q = _vecs(16, seed=13)
    want = jidx.search_by_vectors(q, 10)
    jidx.shutdown()
    tidx = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", conf), str(tmp_path / "shard"),
                          device="cpu")
    tidx.post_startup()
    assert tidx.compressed
    np.testing.assert_array_equal(tidx._read_snapshot().ivf_buckets.numpy(), want_buckets)
    _same(tidx.search_by_vectors(q, 10), want, atol=1e-4)


@pytest.mark.parametrize("pca", [0, 8])
def test_layout_carried_by_state_from_arrays_answers_the_same(tmp_path, pca):
    kw = _ivf_kw(nlist=16, top_p=4, pca_dim=pca)
    tpu.set_ivf_config(JIvfConfig(**kw))
    gpu.set_ivf_config(IvfConfig(**kw))
    vecs = _vecs(3000, seed=14)
    jidx = _jax_index(tmp_path, "j", {"distance": "l2-squared"})
    jidx.add_batch(np.arange(3000), vecs)
    jidx.delete(*range(5, 900, 11))
    snap = jidx._read_snapshot()
    arrays = {"store": np.asarray(snap.store), "sq_norms": np.asarray(snap.sq_norms),
              "tombs": np.asarray(snap.tombs), "slot_to_doc": snap.slot_to_doc,
              "n": snap.n, "capacity": snap.capacity, "dim": snap.dim,
              "ivf_centroids": np.asarray(snap.ivf_centroids),
              "ivf_buckets": np.asarray(snap.ivf_buckets), "ivf_meta": snap.ivf_meta}
    if pca:
        arrays["ivf_pca_proj"] = np.asarray(snap.ivf_pca_proj)
        arrays["ivf_pca_rows"] = np.asarray(snap.ivf_pca_rows)
    tidx = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                          str(tmp_path / "t"), device="cpu", persist=False)
    tidx.load_state(state_from_arrays(arrays, device="cpu"))
    assert tidx._ivf_meta == snap.ivf_meta and tidx.health()["ivf"]["trained"]
    np.testing.assert_array_equal(tidx._ivf_fills, jidx._ivf_fills)
    np.testing.assert_array_equal(tidx._ivf_assign[: snap.n], jidx._ivf_assign[: snap.n])
    q = _vecs(16, seed=15)
    _same(tidx.search_by_vectors(q, 10), jidx.search_by_vectors(q, 10))
    # the carried layout keeps serving writes: new rows fold into its buckets
    extra = _vecs(8, seed=16)
    for idx in (tidx, jidx):
        idx.add_batch(np.arange(5000, 5008), extra)
        idx.flush()
    assert tidx._ivf_gen == jidx._ivf_gen
    _same(tidx.search_by_vectors(extra, 3), jidx.search_by_vectors(extra, 3))


def test_restart_retrains_the_same_layout(tmp_path):
    """A replay that lands every row at its old slot (an import of at least
    one write chunk, 8192 rows, lands directly) retrains the same layout."""
    gpu.set_ivf_config(_ivf(nlist=16, top_p=4))
    idx, vecs = _mk_index(tmp_path, n=9000, name="durable", persist=True)
    idx.delete(*range(0, 100, 3))
    q = _vecs(16, seed=17)
    want = idx.search_by_vectors(q, 10)
    buckets = idx._read_snapshot().ivf_buckets.numpy()
    idx.shutdown()
    again = GpuVectorIndex(parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                           str(tmp_path / "durable"), device="cpu")
    np.testing.assert_array_equal(again._read_snapshot().ivf_buckets.numpy(), buckets)
    _same(again.search_by_vectors(q, 10), want)
