"""The port's Shard (weaviate_tpu_torch.db.shard) against the JAX
package's Shard, built from the same class definition and the same
objects, on the CPU: vector search (sync and async, unfiltered, through
the gather tier and the masked scan), BM25, filters, listing, sorting,
aggregation columns, writes with updates, deletes and merges, the raw
serving lane, compaction, and a shard directory written by either package
opened by the other.

Tolerances: uuids equal exactly (tie-free gaussian vectors); distances
rtol 1e-5, atol 1e-5 (the same f32 arithmetic in another order); BM25
scores equal exactly (the same host code).
"""

import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.db.shard import Shard as JaxShard
from weaviate_tpu.entities import filters as jfilters
from weaviate_tpu.entities import schema as jschema
from weaviate_tpu.entities import storobj as jstorobj
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu_torch.db.shard import SearchResult, Shard
from weaviate_tpu_torch.entities import filters, schema, storobj
from weaviate_tpu_torch.entities import vectorindex as vi

N, D, B, K = 3000, 32, 16, 10
WORDS = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel")
PORT = (Shard, schema, storobj, filters, vi)
JAX = (JaxShard, jschema, jstorobj, jfilters, jvi)

TAG = {"operator": "Equal", "path": ["tag"], "valueText": "t3"}       # 94 docs: gather
RANGE = {"operator": "LessThan", "path": ["bucket"], "valueInt": 500}  # ~1500: masked
BOTH = {"operator": "And", "operands": [
    {"operator": "GreaterThanEqual", "path": ["bucket"], "valueInt": 100}, TAG]}


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    bucket = rng.integers(0, 1000, n)
    words = rng.integers(0, len(WORDS), (n, 3))
    return vecs, bucket, words, rng


def _props(i, bucket, words):
    j = i % len(bucket)  # docs past N reuse the first rows' properties
    return {"tag": f"t{i % 32}", "bucket": int(bucket[j]),
            "body": " ".join(WORDS[w] for w in words[j]) + f" doc{i % 50}"}


def _objs(pkg, vecs, bucket, words, ids):
    so = pkg[2]
    return [so.StorObj(class_name="Doc", uuid=str(uuidlib.UUID(int=i + 1)),
                       properties=_props(i, bucket, words), vector=vecs[i]) for i in ids]


def _open(pkg, path, metric="l2-squared", **cfg):
    shard_cls, sch, _, _, v = pkg
    cd = sch.ClassDef(name="Doc", properties=[
        sch.Property(name="tag", data_type=["text"]),
        sch.Property(name="bucket", data_type=["int"]),
        sch.Property(name="body", data_type=["text"])], vector_index_type="hnsw_tpu")
    conf = v.parse_and_validate_config("hnsw_tpu", {"distance": metric, **cfg})
    kw = {"device": "cpu"} if pkg is PORT else {}
    return shard_cls("s0", str(path), cd, conf, **kw)


def _pair(tmp_path, metric="l2-squared", **cfg):
    vecs, bucket, words, rng = _data()
    shards = {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        s = _open(pkg, tmp_path / name, metric, **cfg)
        assert s.put_batch(_objs(pkg, vecs, bucket, words, range(N))) == [None] * N
        shards[name] = s
    return shards["jax"], shards["torch"], vecs, rng


def _flt(pkg, d):
    return None if d is None else pkg[3].LocalFilter.from_dict(d)


def _hits(results):
    return ([[r.obj.uuid for r in row] for row in results],
            [[r.distance for r in row] for row in results])


def _assert_same_hits(got, want):
    gu, gd = _hits(got)
    wu, wd = _hits(want)
    assert gu == wu
    for a, b in zip(gd, wd):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _close(*shards):
    for s in shards:
        s.shutdown()


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot"])
@pytest.mark.parametrize("flt", [None, TAG, RANGE, BOTH], ids=["none", "tag", "range", "and"])
def test_vector_search_matches_jax(tmp_path, metric, flt):
    """object_vector_search and its async twin return the JAX Shard's
    hydrated hits at B 16 and B 1, unfiltered, through the gather tier
    (one tag value) and the masked scan (a bucket range)."""
    jshard, tshard, _, rng = _pair(tmp_path, metric)
    q = rng.standard_normal((B, D)).astype(np.float32)
    try:
        for qq in (q, q[0]):
            want = jshard.object_vector_search(qq, K, _flt(JAX, flt))
            _assert_same_hits(tshard.object_vector_search(qq, K, _flt(PORT, flt)), want)
            _assert_same_hits(tshard.object_vector_search_async(
                qq, K, flt=_flt(PORT, flt))(), want)
        tier = tshard.vector_index.dispatch_tier(tshard.vector_index._read_snapshot(),
                                                 tshard.build_allow_list(_flt(PORT, flt)))
        assert tier == jshard.vector_index.dispatch_tier(
            jshard.vector_index._read_snapshot(), jshard.build_allow_list(_flt(JAX, flt)))
    finally:
        _close(jshard, tshard)


def test_target_distance_and_include_vector(tmp_path):
    jshard, tshard, vecs, rng = _pair(tmp_path)
    q = vecs[:4] + 0.05 * rng.standard_normal((4, D)).astype(np.float32)
    try:
        want = jshard.object_vector_search(q, 50, target_distance=40.0)
        got = tshard.object_vector_search(q, 50, target_distance=40.0)
        _assert_same_hits(got, want)
        assert all(r.distance <= 40.0 for row in got for r in row)
        res = tshard.object_vector_search(q[:1], 1, include_vector=True)
        np.testing.assert_array_equal(res[0][0].obj.vector, vecs[0])
        assert isinstance(res[0][0], SearchResult)
    finally:
        _close(jshard, tshard)


def test_bm25_filters_listing_sort_and_aggregation_match_jax(tmp_path):
    """object_search (BM25, filter-only, listing, cursor, sort),
    keyword_search_batch (no device BM25 engine in either package: None),
    find_uuids, find_doc_ids and aggregate_columns equal the JAX Shard's."""
    jshard, tshard, _, _ = _pair(tmp_path)
    try:
        for query in ("alpha doc7", "charlie hotel", "nothingmatches"):
            kr = {"query": query}
            want = jshard.object_search(10, keyword_ranking=kr)
            got = tshard.object_search(10, keyword_ranking=kr)
            assert [(r.obj.uuid, r.score) for r in got] == [(r.obj.uuid, r.score) for r in want]
            got_f = tshard.object_search(10, flt=_flt(PORT, TAG), keyword_ranking=kr, offset=2)
            want_f = jshard.object_search(10, flt=_flt(JAX, TAG), keyword_ranking=kr, offset=2)
            assert [(r.obj.uuid, r.score) for r in got_f] == \
                [(r.obj.uuid, r.score) for r in want_f]
        assert tshard.keyword_search_batch(["alpha"], 10) is None
        assert jshard.keyword_search_batch(["alpha"], 10) is None
        for flt in (None, TAG, RANGE, BOTH):
            assert tshard.find_uuids(_flt(PORT, flt)) == jshard.find_uuids(_flt(JAX, flt))
            np.testing.assert_array_equal(tshard.find_doc_ids(_flt(PORT, flt)).to_array(),
                                          jshard.find_doc_ids(_flt(JAX, flt)).to_array())
            assert tshard.aggregate_columns(_flt(PORT, flt), ["bucket", "tag"]) == \
                jshard.aggregate_columns(_flt(JAX, flt), ["bucket", "tag"])
            for kw in ({}, {"offset": 5}, {"cursor_after": str(uuidlib.UUID(int=40))},
                       {"sort": [{"path": ["bucket"], "order": "desc"}]}):
                got = [r.obj.uuid for r in tshard.object_search(20, flt=_flt(PORT, flt), **kw)]
                want = [r.obj.uuid for r in jshard.object_search(20, flt=_flt(JAX, flt), **kw)]
                assert got == want, (flt, kw)
        assert tshard.object_count() == jshard.object_count() == N
    finally:
        _close(jshard, tshard)


def test_writes_updates_deletes_and_merges_match_jax(tmp_path):
    """put_batch with updates and an in-batch duplicate, put_object,
    delete_object and merge_object (props and vector) leave both Shards
    answering alike: objects, filters, BM25 and vector search."""
    jshard, tshard, vecs, rng = _pair(tmp_path)
    _, bucket, words, _ = _data()
    try:
        upd_vecs = rng.standard_normal((N, D)).astype(np.float32)
        ids = list(range(0, 200, 2)) + [12]  # updates, with doc 12 twice in one batch
        for name, pkg, s in (("jax", JAX, jshard), ("torch", PORT, tshard)):
            objs = _objs(pkg, upd_vecs, bucket, words, ids)
            objs[-1].properties["body"] = "second version only"
            assert s.put_batch(objs) == [None] * len(objs)
            s.put_object(_objs(pkg, upd_vecs, bucket, words, [N - 1])[0])
            for i in range(1, 60, 3):
                assert s.delete_object(str(uuidlib.UUID(int=i + 1)))
            assert not s.delete_object(str(uuidlib.UUID(int=N + 50)))
            m = s.merge_object(str(uuidlib.UUID(int=300)), {"tag": "merged", "extra": None},
                               vector=upd_vecs[299] + 1.0)
            assert m.properties["tag"] == "merged"
            assert s.merge_object(str(uuidlib.UUID(int=N + 50)), {"tag": "x"}) is None
        assert tshard.object_count() == jshard.object_count()
        assert len(tshard.vector_index) == len(jshard.vector_index)
        got = tshard.object_by_uuid(str(uuidlib.UUID(int=13)))
        assert got.properties["body"] == "second version only"
        q = np.concatenate([upd_vecs[:8], upd_vecs[299:300] + 1.0,
                            rng.standard_normal((7, D)).astype(np.float32)])
        for flt in (None, TAG, {"operator": "Equal", "path": ["tag"], "valueText": "merged"}):
            _assert_same_hits(tshard.object_vector_search(q, K, _flt(PORT, flt)),
                              jshard.object_vector_search(q, K, _flt(JAX, flt)))
        kr = {"query": "second version"}
        assert [r.obj.uuid for r in tshard.object_search(5, keyword_ranking=kr)] == \
            [r.obj.uuid for r in jshard.object_search(5, keyword_ranking=kr)]
        assert tshard.find_uuids(None) == jshard.find_uuids(None)
    finally:
        _close(jshard, tshard)


def test_fresh_add_after_staged_deletes(tmp_path):
    """The sequence of ROADMAP queue 3 item 3 through the Shard: deletes
    of each query's own nearest doc, then a batch of fresh objects. The
    port's Shard answers the exact top-k of the live objects. The JAX
    index publishes the fresh batch without the staged tombstones, so its
    search still returns the deleted docs, and its Shard drops them at
    hydration: its rows come back shorter than k."""
    jshard, tshard, vecs, rng = _pair(tmp_path)
    _, bucket, words, _ = _data()
    try:
        extra = rng.standard_normal((N + 4, D)).astype(np.float32)
        q = vecs[:B]
        for pkg, s in ((JAX, jshard), (PORT, tshard)):
            s.object_vector_search(q, K)
            for i in range(B):
                assert s.delete_object(str(uuidlib.UUID(int=i + 1)))
            assert s.put_batch(_objs(pkg, extra, bucket, words, range(N, N + 4))) == [None] * 4
        live = np.concatenate([vecs[B:], extra[N:]])
        live_ids = np.concatenate([np.arange(B, N), np.arange(N, N + 4)])
        d = ((q[:, None, :] - live[None, :, :]) ** 2).sum(-1)
        order = np.argsort(d, axis=1)[:, :K]
        want = [{str(uuidlib.UUID(int=int(live_ids[j]) + 1)) for j in row} for row in order]
        got_u, got_d = _hits(tshard.object_vector_search(q, K))
        # the exact top-k of the live objects, as sets (two of them tie in f32)
        assert [set(r) for r in got_u] == want
        np.testing.assert_allclose(got_d, np.take_along_axis(d, order, 1), rtol=1e-5)
        ref_u, _ = _hits(jshard.object_vector_search(q, K))
        # the reference's difference: each query's deleted doc took a slot
        assert all(len(r) < K and set(r) <= set(w) for r, w in zip(ref_u, want))
    finally:
        _close(jshard, tshard)


def test_compact_matches_jax(tmp_path):
    """Deletes, then the vector index's compact() in both Shards: the same
    answers before and after, and the Shard reopens the compacted
    directory with them."""
    jshard, tshard, vecs, rng = _pair(tmp_path)
    try:
        q = rng.standard_normal((B, D)).astype(np.float32)
        for s in (jshard, tshard):
            for i in range(0, N, 9):
                s.delete_object(str(uuidlib.UUID(int=i + 1)))
        before = tshard.object_vector_search(q, K)
        _assert_same_hits(before, jshard.object_vector_search(q, K))
        for s in (jshard, tshard):
            s.vector_index.compact()
        assert tshard.debug_health()["vector_index"]["tombstones"] == 0
        _assert_same_hits(tshard.object_vector_search(q, K), before)
        _assert_same_hits(tshard.object_vector_search(q, K, _flt(PORT, TAG)),
                          jshard.object_vector_search(q, K, _flt(JAX, TAG)))
        tshard.shutdown()
        again = _open(PORT, tmp_path / "torch")
        _assert_same_hits(again.object_vector_search(q, K), before)
        again.shutdown()
    finally:
        jshard.shutdown()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_shard_directory_restores_across_packages(tmp_path, writer):
    """A Shard directory (LSM store, indexcount, vector.log) written by
    one package opens in the other with the same objects, filters, BM25
    and vector answers, and takes further writes."""
    jshard, tshard, vecs, rng = _pair(tmp_path)
    q = rng.standard_normal((B, D)).astype(np.float32)
    for s in (jshard, tshard):
        for i in range(5, 200, 4):
            s.delete_object(str(uuidlib.UUID(int=i + 1)))
    want = jshard.object_vector_search(q, K, _flt(JAX, RANGE))
    want_uuids = jshard.find_uuids(_flt(JAX, TAG))
    want_bm25 = [r.obj.uuid for r in jshard.object_search(10, keyword_ranking={"query": "golf"})]
    _close(jshard, tshard)
    reader = PORT if writer == "jax" else JAX
    s = _open(reader, tmp_path / writer)
    try:
        assert s.object_count() == N - len(range(5, 200, 4))
        _assert_same_hits(s.object_vector_search(q, K, _flt(reader, RANGE)), want)
        assert s.find_uuids(_flt(reader, TAG)) == want_uuids
        assert [r.obj.uuid for r in s.object_search(
            10, keyword_ranking={"query": "golf"})] == want_bm25
        _, bucket, words, _ = _data()
        new = _objs(reader, vecs, bucket, words, [7])[0]  # doc 7 was deleted: re-put
        s.put_object(new)
        res = s.object_vector_search(vecs[7], 1)
        assert res[0][0].obj.uuid == new.uuid and res[0][0].obj.doc_id >= N
    finally:
        s.shutdown()


def test_raw_lane_matches_the_hydrated_lane(tmp_path):
    """search_raw_packed (the native point-get plane over flushed
    segments) returns the images and distances the hydrated lane returns,
    in the port as in the JAX Shard."""
    jshard, tshard, _, rng = _pair(tmp_path)
    q = rng.standard_normal((B, D)).astype(np.float32)
    try:
        for s in (jshard, tshard):
            s.flush()
            s.store.flush_memtables()
        if not tshard.raw_plane_ready():
            pytest.skip("the native LSM point-get library did not build here")
        packed = tshard.search_raw_packed(q, K)
        want = jshard.search_raw_packed(q, K)
        vbuf, voffs, flags, dists, counts = packed
        np.testing.assert_array_equal(counts, want[4])
        np.testing.assert_allclose(dists, want[3], rtol=1e-5, atol=1e-5)
        hyd = tshard.object_vector_search(q, K)
        images = [bytes(vbuf[voffs[i]:voffs[i + 1]]) for i in range(len(voffs) - 1)]
        assert images == [r.raw_pristine() for row in hyd for r in row]
        # the images carry each package's own write times: compare the uuids
        want_images = [bytes(want[0][want[1][i]:want[1][i + 1]]) for i in range(len(want[1]) - 1)]
        assert [storobj.StorObj.uuid_from_binary(b) for b in images] == \
            [jstorobj.StorObj.uuid_from_binary(b) for b in want_images]
    finally:
        _close(jshard, tshard)


def test_debug_health_and_device_bm25_request(tmp_path, monkeypatch):
    """debug_health has the JAX Shard's keys; asking for device BM25 (by
    config or environment) raises, naming the ROADMAP item, since the
    port has no such engine yet."""
    jshard, tshard, _, _ = _pair(tmp_path)
    try:
        hj, ht = jshard.debug_health(), tshard.debug_health()
        assert set(ht) == set(hj) and set(ht["allow_cache"]) == set(hj["allow_cache"])
        assert ht["objects"] == hj["objects"] == N
        assert ht["vector_index"]["live"] == hj["vector_index"]["live"] == N
        with pytest.raises(ValueError, match="item 11"):
            Shard("s1", str(tmp_path / "bm25"), tshard.class_def, tshard.vector_index.config,
                  invert_cfg={"bm25": {"device": True}}, device="cpu")
        monkeypatch.setenv("WEAVIATE_TPU_BM25_DEVICE", "1")
        with pytest.raises(ValueError, match="item 11"):
            _open(PORT, tmp_path / "bm25env")
    finally:
        _close(jshard, tshard)


def test_observability_planes_through_the_shard(tmp_path):
    """The port's tracer, perf window, quality auditor and memory ledger
    read the Shard's dispatches: the trace carries the dispatch facts the
    index hands over (tier, snapshot generation, lock wait, the device's
    peaks key), the auditor's shadow re-execution on the host plane reads
    recall 1.0 on both tiers, and the ledger sees the compaction."""
    from weaviate_tpu_torch.monitoring import memory, perf, quality, tracing

    vecs, bucket, words, rng = _data()
    shard = _open(PORT, tmp_path)
    shard.put_batch(_objs(PORT, vecs, bucket, words, range(N)))
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0))
    window = perf.configure(perf.PerfWindow(backend="cpu"))
    auditor = quality.configure(quality.QualityAuditor(sample_rate=1.0))
    ledger = memory.configure(memory.MemoryLedger())
    try:
        q = rng.standard_normal((B, D)).astype(np.float32)
        with tracing.request("grpc", "search"):
            shard.object_vector_search(q, K)
            shard.object_vector_search_async(q, K, flt=_flt(PORT, TAG))()
        assert auditor.drain()
        spans = [c for c in tracer.snapshot()[-1]["root"]["children"] if c["name"] == "dispatch"]
        assert [s["attrs"]["tier"] for s in spans] == ["exact_scan", "gather"]
        for s in spans:
            assert s["attrs"]["snapshot_gen"] >= 1 and s["attrs"]["backend"] == "cpu"
            assert "lock_wait_ms" in s["attrs"] and s["attrs"]["n_live"] > 0
        assert window.summary()["dispatches"] == 2
        tiers = auditor.summary()["tiers"]
        assert tiers["exact_scan"]["recall_mean"] == tiers["gather"]["recall_mean"] == 1.0
        for i in range(0, 300):
            shard.delete_object(str(uuidlib.UUID(int=i + 1)))
        shard.vector_index.compact()
        summary = ledger.summary()
        assert summary["write"]["phases"]["compact"]["rows"] == N - 300
        assert summary["device"]["components"]["store"] == shard.vector_index._store.nbytes
    finally:
        memory.unconfigure(ledger)
        quality.unconfigure(auditor)
        perf.unconfigure(window)
        tracing.unconfigure(tracer)
        shard.shutdown()


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", None), ("NVIDIA H100 NVL", None),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_peaks_only_for_the_datasheet_card(name, key):
    """PEAKS quotes the H100 SXM5 datasheet; another card, the H100's PCIe
    and NVL parts included, gets no peaks key (and so no roofline)."""
    from weaviate_tpu_torch.monitoring import costmodel

    assert costmodel.backend_for_device_name(name) == key


def test_tracing_on_a_card_without_datasheet_peaks(tmp_path, monkeypatch):
    """A card with no PEAKS entry: traced searches through the Shard still
    answer, their dispatch spans carry the dispatch facts but no roofline,
    and the perf window reports no roofline."""
    from weaviate_tpu_torch.monitoring import costmodel, perf, tracing

    monkeypatch.setattr(costmodel, "detect_backend", lambda device=None: None)
    vecs, bucket, words, rng = _data()
    shard = _open(PORT, tmp_path)
    shard.put_batch(_objs(PORT, vecs, bucket, words, range(N)))
    want = shard.object_vector_search(vecs[:B], K)
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0))
    window = perf.configure(perf.PerfWindow())
    try:
        with tracing.request("grpc", "search"):
            got = shard.object_vector_search(vecs[:B], K)
        _assert_same_hits(got, want)
        spans = [c for c in tracer.snapshot()[-1]["root"]["children"] if c["name"] == "dispatch"]
        assert len(spans) == 1 and spans[0]["attrs"]["tier"] == "exact_scan"
        assert spans[0]["attrs"]["flops"] > 0
        assert not {"backend", "mfu_pct", "regime"} & set(spans[0]["attrs"])
        summary = window.summary()
        assert summary["dispatches"] == 1 and summary["backend"] is None
        assert "roofline" not in summary
    finally:
        perf.unconfigure(window)
        tracing.unconfigure(tracer)
        shard.shutdown()


def test_geo_filter_and_vector_search_match_jax(tmp_path):
    """A geoCoordinates property (the Shard's lazily built geo index):
    WithinGeoRange filters listing and vector search alike in both
    packages, after a restart too."""
    rng = np.random.default_rng(4)
    lat = rng.uniform(47.0, 55.0, 400)
    lon = rng.uniform(6.0, 15.0, 400)
    vecs = rng.standard_normal((400, 8)).astype(np.float32)
    geo = {"operator": "WithinGeoRange", "path": ["location"], "valueGeoRange": {
        "geoCoordinates": {"latitude": 52.52, "longitude": 13.405}, "distance": {"max": 150_000}}}
    q = rng.standard_normal((4, 8)).astype(np.float32)
    out = {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        shard_cls, sch, so, _, v = pkg
        cd = sch.ClassDef(name="Place", properties=[
            sch.Property(name="location", data_type=["geoCoordinates"])],
            vector_index_type="hnsw_tpu")
        conf = v.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
        kw = {"device": "cpu"} if pkg is PORT else {}
        s = shard_cls("s0", str(tmp_path / name), cd, conf, **kw)
        s.put_batch([so.StorObj(class_name="Place", uuid=str(uuidlib.UUID(int=i + 1)),
                                properties={"location": {"latitude": float(lat[i]),
                                                         "longitude": float(lon[i])}},
                                vector=vecs[i]) for i in range(400)])
        flt = _flt(pkg, geo)
        out[name] = (s.find_uuids(flt), _hits(s.object_vector_search(q, 5, flt)))
        s.shutdown()
        s = shard_cls("s0", str(tmp_path / name), cd, conf, **kw)
        assert s.find_uuids(_flt(pkg, geo)) == out[name][0]
        s.shutdown()
    assert out["torch"][0] == out["jax"][0] and 0 < len(out["torch"][0]) < 400
    assert out["torch"][1][0] == out["jax"][1][0]
    np.testing.assert_allclose(out["torch"][1][1], out["jax"][1][1], rtol=1e-5, atol=1e-5)
