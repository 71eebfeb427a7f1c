"""The port's device BM25 engine (weaviate_tpu_torch/inverted/bm25_device.py
and ops/bm25_scan.py) on the CPU: the contracts of
tests/test_bm25_device.py restated for the port (the same ranking as the
host MaxScore engine, allowLists, the write-generation row cache, the
batched lane and its slices, boosts, explanations, the Shard and the App
lanes under concurrent writes), and the port's engine against the JAX
package's DeviceBM25 on one corpus.

BM25 ties by nature (the same term frequency at the same length), and
`torch.topk` orders ties unlike `lax.top_k`: comparisons are tie-aware.
Scores agree rank by rank at rtol 1e-5 (f32 device sums, an `index_add_`
row build, f64 host scores), and every id is a genuine scorer at its
level; the port's engine breaks exact ties toward the lower doc id, as
the JAX engine's `lax.top_k` does, so against it the ids agree too.
"""

import random
import uuid as uuidlib

import numpy as np
import pytest
import torch

from weaviate_tpu_torch.entities.schema import ClassDef, Property
from weaviate_tpu_torch.entities.storobj import StorObj
from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
from weaviate_tpu_torch.inverted.bm25 import BM25Searcher
from weaviate_tpu_torch.inverted.bm25_device import DeviceBM25
from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.ops import bm25_scan
from weaviate_tpu_torch.storage.bitmap import Bitmap
from weaviate_tpu_torch.storage.lsm import Store


CLASS_DEF = ClassDef.from_dict({
    "class": "Doc",
    "properties": [
        {"name": "body", "dataType": ["text"]},
        {"name": "title", "dataType": ["text"]},
    ],
})


def _corpus(rng, n_docs, vocab, doc_len=20):
    ranks = np.arange(1, len(vocab) + 1, dtype=np.float64)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    docs = []
    for _ in range(n_docs):
        sub = np.random.default_rng(rng.integers(1 << 31))
        docs.append((" ".join(sub.choice(vocab, size=doc_len, p=p)),
                     " ".join(sub.choice(vocab, size=3, p=p))))
    return docs


def _build(tmp_path, docs, name="dev"):
    store = Store(str(tmp_path / name))
    inv = InvertedIndex(store, CLASS_DEF)
    for i, (body, title) in enumerate(docs):
        inv.add_object(i, {"body": body, "title": title})
    return inv


def _score_map(searcher, query, allow):
    """Exhaustive host ground truth: doc id -> f64 score."""
    units = searcher._build_units(
        query, searcher._searchable_props(None),
        max(searcher._doc_count(), 1))
    if not units:
        return {}
    ids, scores = searcher._rank(units, 1 << 30, allow, prune=False)
    return {int(d): float(s) for d, s in zip(ids, scores)}


def test_device_matches_host_ranking(tmp_path):
    rng = np.random.default_rng(42)
    vocab = np.array([f"w{i}" for i in range(150)])
    inv = _build(tmp_path, _corpus(rng, 500, vocab))
    host = BM25Searcher(inv, CLASS_DEF)
    dev = DeviceBM25(host, device="cpu")

    prng = random.Random(7)
    checked = 0
    for trial in range(25):
        nterms = prng.choice([1, 2, 4, 8])
        query = " ".join(prng.choices(list(vocab), k=nterms))
        limit = prng.choice([1, 5, 20])
        allow = None
        if trial % 3 == 0:
            keep = rng.random(500) < prng.choice([0.1, 0.6])
            allow = Bitmap(np.nonzero(keep)[0].astype(np.uint64))
        truth = _score_map(host, query, allow)
        h = host.search(query, limit, allow_list=allow)
        d = dev.search(query, limit, allow_list=allow)
        assert len(d) == len(h)
        for (h_id, h_s, _), (d_id, d_s, _) in zip(h, d):
            # rank-wise score agreement (ids may swap on f32 near-ties)
            assert d_s == pytest.approx(h_s, rel=1e-5, abs=1e-5)
            # the device id must be a genuine scorer at that level
            assert truth[d_id] == pytest.approx(d_s, rel=1e-5, abs=1e-5)
            if allow is not None:
                assert allow.contains(d_id)
        checked += len(d)
    assert checked > 50


def test_device_row_cache_and_write_invalidation(tmp_path):
    rng = np.random.default_rng(3)
    vocab = np.array([f"w{i}" for i in range(40)])
    docs = _corpus(rng, 120, vocab)
    store = Store(str(tmp_path / "gen"))
    inv = InvertedIndex(store, CLASS_DEF)
    for i, (body, title) in enumerate(docs):
        inv.add_object(i, {"body": body, "title": title})

    gen = [0]
    host = BM25Searcher(inv, CLASS_DEF, gen_fn=lambda: gen[0])
    dev = DeviceBM25(host, device="cpu")
    q = " ".join(vocab[:4])
    first = dev.search(q, 10)
    assert dev._rows, "rows should be cached under the generation"
    again = dev.search(q, 10)
    assert [d for d, _, _ in again] == [d for d, _, _ in first]

    # a write bumps the generation BEFORE mutating (shard discipline)
    gen[0] += 1
    inv.add_object(500, {"body": " ".join(list(vocab[:4]) * 5), "title": "x"})
    after = dev.search(q, 10)
    host_after = host.search(q, 10)
    assert [d for d, _, _ in after] == [d for d, _, _ in host_after]
    assert 500 in _score_map(host, q, None), \
        "the new doc must be visible to scoring post-invalidation"
    assert all(v[0] == gen[0] for v in dev._rows.values()), \
        "stale-generation rows must be evicted"


def test_recycled_bitmap_id_never_aliases_mask(tmp_path):
    """A freed Bitmap's address can be recycled by a DIFFERENT filter's
    Bitmap within one write generation; the mask cache must detect this
    (the entry pins the original object and compares identity) instead of
    serving the stale mask. Simulated by planting a poisoned entry under
    the new Bitmap's id."""
    rng = np.random.default_rng(21)
    vocab = np.array([f"w{i}" for i in range(30)])
    inv = _build(tmp_path, _corpus(rng, 200, vocab), "alias")
    gen = [0]
    host = BM25Searcher(inv, CLASS_DEF, gen_fn=lambda: gen[0])
    dev = DeviceBM25(host, device="cpu")
    q = " ".join(vocab[:4])

    allow_a = Bitmap(np.arange(0, 50, dtype=np.uint64))
    res_a = dev.search(q, 10, allow_list=allow_a)
    assert res_a and all(d < 50 for d, _, _ in res_a)
    (mask_a,) = [v[2] for v in dev._masks.values()]

    allow_b = Bitmap(np.arange(150, 200, dtype=np.uint64))
    # worst case: B recycled A's address AND A's entry is still cached
    dev._masks.clear()
    dev._masks[id(allow_b)] = (gen[0], next(iter([16384])), mask_a, allow_a)
    res_b = dev.search(q, 10, allow_list=allow_b)
    assert res_b and all(150 <= d < 200 for d, _, _ in res_b), \
        "stale mask from a recycled id must not leak into results"


def test_search_batch_matches_per_query(tmp_path):
    """One matmul for Q queries == Q single searches (f32 tolerance),
    including empty-term and no-hit queries in the same batch."""
    rng = np.random.default_rng(17)
    vocab = np.array([f"w{i}" for i in range(100)])
    inv = _build(tmp_path, _corpus(rng, 300, vocab), "batch")
    host = BM25Searcher(inv, CLASS_DEF)
    dev = DeviceBM25(host, device="cpu")
    prng = random.Random(3)
    queries = [" ".join(prng.choices(list(vocab), k=prng.choice([1, 2, 4, 8])))
               for _ in range(40)]
    queries[7] = "zzz-not-in-vocab"      # no units at all
    queries[23] = ""                      # empty query
    batched = dev.search_batch(queries, 10)
    assert batched is not None and len(batched) == len(queries)
    assert batched[7] == [] and batched[23] == []
    for q, got in zip(queries, batched):
        want = dev.search(q, 10)
        assert len(got) == len(want)
        for (g_id, g_s, _), (w_id, w_s, _) in zip(got, want):
            assert g_s == pytest.approx(w_s, rel=1e-5, abs=1e-5)
        truth = _score_map(host, q, None)
        for g_id, g_s, _ in got:
            assert truth[g_id] == pytest.approx(g_s, rel=1e-5, abs=1e-5)


def test_duplicate_and_nonpositive_boosts(tmp_path):
    """properties=["body","body"] double-counts in EVERY path (selection
    matrix accumulates); non-positive boosts fall back to the host engine
    (the score>0 empty-slot sentinel cannot represent them)."""
    rng = np.random.default_rng(33)
    vocab = np.array([f"w{i}" for i in range(40)])
    inv = _build(tmp_path, _corpus(rng, 120, vocab), "boosts")
    host = BM25Searcher(inv, CLASS_DEF)
    dev = DeviceBM25(host, device="cpu")
    q = " ".join(vocab[:3])

    dup = ["body", "body"]
    h = host.search(q, 8, properties=dup)
    d = dev.search(q, 8, properties=dup)
    b = dev.search_batch([q], 8, properties=dup)[0]
    assert [x[1] for x in d] == pytest.approx([x[1] for x in h], rel=1e-5)
    assert [x[1] for x in b] == pytest.approx([x[1] for x in h], rel=1e-5)

    neg = ["body^-1"]
    h_neg = host.search(q, 8, properties=neg)
    d_neg = dev.search(q, 8, properties=neg)
    assert len(d_neg) == len(h_neg) > 0, \
        "negative boosts must serve (host fallback), not return empty"
    assert [x[1] for x in d_neg] == pytest.approx(
        [x[1] for x in h_neg], rel=1e-5)
    assert dev.search_batch([q], 8, properties=neg) is None, \
        "batch lane must decline non-positive boosts"


def test_search_batch_slices_under_stack_budget(tmp_path, monkeypatch):
    """With a tiny transient-stack budget the batch must split into
    multiple matmul slices and still produce identical results."""
    from weaviate_tpu_torch.inverted import bm25_device as mod

    rng = np.random.default_rng(29)
    vocab = np.array([f"w{i}" for i in range(60)])
    inv = _build(tmp_path, _corpus(rng, 150, vocab), "slice")
    host = BM25Searcher(inv, CLASS_DEF)
    dev = DeviceBM25(host, device="cpu")
    prng = random.Random(11)
    queries = [" ".join(prng.choices(list(vocab), k=4)) for _ in range(20)]
    full = dev.search_batch(queries, 10)
    # budget of ~2 rows at this n_pad: every query pair forces a new slice
    monkeypatch.setattr(mod, "_BATCH_STACK_MAX_BYTES", 16384 * 4 * 2)
    dev2 = DeviceBM25(BM25Searcher(inv, CLASS_DEF), device="cpu")
    sliced = dev2.search_batch(queries, 10)
    assert len(sliced) == len(full)
    for a, b in zip(sliced, full):
        assert [d for d, _, _ in a] == [d for d, _, _ in b]
        assert [v for _, v, _ in a] == pytest.approx(
            [v for _, v, _ in b], rel=1e-6)  # matmul padding reorders f32 adds


def test_get_class_batched_kw_lane(tmp_path):
    """Explorer groups plain bm25 slots into the batched lane; filtered/
    explained slots take the per-query path; results match the host shard."""
    from weaviate_tpu_torch.db.shard import Shard
    from weaviate_tpu_torch.server import App
    from weaviate_tpu_torch.usecases.traverser import GetParams

    app = App(data_path=str(tmp_path / "kwapp"), device="cpu")
    app.schema.add_class({
        "class": "Kw", "vectorIndexType": "noop",
        "invertedIndexConfig": {"bm25": {"device": True}},
        "properties": [{"name": "t", "dataType": ["text"]}]})
    kidx = app.db.get_index("Kw")
    vocab = [f"w{i}" for i in range(30)]
    from weaviate_tpu_torch.entities.storobj import StorObj
    kidx.put_batch([
        StorObj(class_name="Kw", uuid=str(uuidlib.UUID(int=i + 1)),
                properties={"t": " ".join(
                    np.random.default_rng(i).choice(vocab, size=10))})
        for i in range(200)])
    try:
        qs = [" ".join(vocab[i:i + 3]) for i in range(12)]
        plist = [GetParams(class_name="Kw",
                           keyword_ranking={"query": q}, limit=5)
                 for q in qs]
        # one slot with a filter: must take the per-query path, not break
        from weaviate_tpu_torch.entities.filters import LocalFilter
        plist.append(GetParams(
            class_name="Kw", keyword_ranking={"query": qs[0]}, limit=5,
            filters=LocalFilter.from_dict({
                "path": ["t"], "operator": "Like", "valueText": "w1*"})))
        batched = app.traverser.get_class_batched(plist)
        assert not any(isinstance(r, Exception) for r in batched), batched
        shard = next(iter(kidx.shards.values()))
        assert shard.bm25_device is not None
        for p, got in zip(plist, batched):
            solo = app.traverser.get_class(p)
            assert [r.obj.uuid for r in got] == [r.obj.uuid for r in solo]
            assert [r.score for r in got] == pytest.approx(
                [r.score for r in solo], rel=1e-5)
    finally:
        app.shutdown()


def test_batched_hybrid_matches_solo(tmp_path):
    """Hybrid slots batch both legs (one keyword matmul + one dense kNN
    dispatch); results must equal per-slot get_class across alphas 0 /
    0.5 / 1, with explicit vectors and keyword-only slots mixed."""
    from weaviate_tpu_torch.server import App
    from weaviate_tpu_torch.usecases.traverser import GetParams

    app = App(data_path=str(tmp_path / "hyb"), device="cpu")
    app.schema.add_class({
        "class": "Hy", "vectorIndexType": "hnsw_tpu",
        "vectorIndexConfig": {"distance": "l2-squared"},
        "invertedIndexConfig": {"bm25": {"device": True}},
        "properties": [{"name": "t", "dataType": ["text"]}]})
    hidx = app.db.get_index("Hy")
    vocab = [f"w{i}" for i in range(25)]
    rng = np.random.default_rng(4)
    hidx.put_batch([
        StorObj(class_name="Hy", uuid=str(uuidlib.UUID(int=i + 1)),
                properties={"t": " ".join(
                    np.random.default_rng(i).choice(vocab, size=8))},
                vector=rng.standard_normal(16).astype(np.float32))
        for i in range(200)])
    tr = app.traverser
    try:
        prng = random.Random(2)
        plist = []
        for alpha in (0.0, 0.5, 1.0):
            for _ in range(4):
                q = " ".join(prng.choices(vocab, k=3))
                v = rng.standard_normal(16).astype(np.float32).tolist()
                plist.append(GetParams(
                    class_name="Hy",
                    hybrid={"query": q, "vector": v, "alpha": alpha},
                    limit=6))
        batched = tr.get_class_batched(plist)
        assert not any(isinstance(r, Exception) for r in batched), batched
        shard = next(iter(hidx.shards.values()))
        assert shard.bm25_device is not None \
            and shard.bm25_device.last_batch_stats is not None, \
            "hybrid sparse leg must have used the batched device engine"
        for p, got in zip(plist, batched):
            # the LEGACY per-slot path is the baseline — get_class itself
            # routes through the batched lane, which would compare the new
            # code against itself
            solo = tr.explorer._get_one(p)
            assert [r.score for r in got] == pytest.approx(
                [r.score for r in solo], rel=1e-4, abs=1e-5)
            key = lambda r: (-round(r.score or 0, 4), r.obj.uuid)  # noqa: E731
            assert [r.obj.uuid for r in sorted(got, key=key)] == \
                [r.obj.uuid for r in sorted(solo, key=key)]
    finally:
        app.shutdown()


def test_explanations_fall_back_to_host(tmp_path):
    rng = np.random.default_rng(5)
    vocab = np.array([f"w{i}" for i in range(30)])
    inv = _build(tmp_path, _corpus(rng, 60, vocab), "exp")
    dev = DeviceBM25(BM25Searcher(inv, CLASS_DEF), device="cpu")
    hits = dev.search(str(vocab[0]), 5, additional_explanations=True)
    assert hits and all(h[2] is not None for h in hits)
    assert any("frequency" in k for h in hits for k in h[2])


def test_device_engine_under_concurrent_writes(tmp_path):
    """Writers bump the shard generation mid-search; the device row/mask
    caches must never serve a stale generation's scores, and no search may
    raise. Final state: device ranking == host ranking."""
    import threading

    from weaviate_tpu_torch.db.shard import Shard

    cd = ClassDef(name="Kw", properties=[
        Property(name="t", data_type=["text"]),
    ], vector_index_type="noop")
    cfg = parse_and_validate_config("noop", {})
    shard = Shard("c0", str(tmp_path / "conc"), cd, cfg,
                  invert_cfg={"bm25": {"device": True}}, device="cpu")
    vocab = [f"w{i}" for i in range(20)]
    shard.put_batch([
        StorObj(class_name="Kw", uuid=str(uuidlib.UUID(int=i + 1)),
                properties={"t": " ".join(
                    np.random.default_rng(i).choice(vocab, size=8))})
        for i in range(100)])
    errs: list = []
    stop = threading.Event()

    def writer():
        i = 1000
        while not stop.is_set():
            try:
                shard.put_object(StorObj(
                    class_name="Kw", uuid=str(uuidlib.UUID(int=i + 1)),
                    properties={"t": " ".join(vocab[:4])}))
                i += 1
            except Exception as e:  # noqa: BLE001
                errs.append(e)

    def reader():
        q = " ".join(vocab[:3])
        while not stop.is_set():
            try:
                shard.object_search(5, keyword_ranking={"query": q})
            except Exception as e:  # noqa: BLE001
                errs.append(e)

    threads = [threading.Thread(target=writer)] + \
        [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    import time
    time.sleep(2.5)
    stop.set()
    for t in threads:
        t.join()
    try:
        assert not errs, errs[:3]
        q = " ".join(vocab[:3])
        dev_hits = shard.object_search(10, keyword_ranking={"query": q})
        shard.bm25_device = None
        host_hits = shard.object_search(10, keyword_ranking={"query": q})
        key = lambda r: (-round(r.score, 4), r.obj.uuid)  # noqa: E731
        assert [r.obj.uuid for r in sorted(dev_hits, key=key)] == \
            [r.obj.uuid for r in sorted(host_hits, key=key)]
    finally:
        shard.shutdown()


def test_batched_lane_under_concurrent_writes(tmp_path):
    """The matmul batch lane under a write storm: no exceptions, and the
    post-storm batched ranking equals the host engine's."""
    import threading
    import time

    from weaviate_tpu_torch.server import App
    from weaviate_tpu_torch.usecases.traverser import GetParams

    app = App(data_path=str(tmp_path / "bconc"), device="cpu")
    app.schema.add_class({
        "class": "Kw", "vectorIndexType": "noop",
        "invertedIndexConfig": {"bm25": {"device": True}},
        "properties": [{"name": "t", "dataType": ["text"]}]})
    kidx = app.db.get_index("Kw")
    vocab = [f"w{i}" for i in range(20)]
    kidx.put_batch([
        StorObj(class_name="Kw", uuid=str(uuidlib.UUID(int=i + 1)),
                properties={"t": " ".join(
                    np.random.default_rng(i).choice(vocab, size=8))})
        for i in range(100)])
    tr = app.traverser
    errs: list = []
    stop = threading.Event()

    def writer():
        i = 2000
        while not stop.is_set():
            try:
                kidx.put_batch([StorObj(
                    class_name="Kw", uuid=str(uuidlib.UUID(int=i + 1)),
                    properties={"t": " ".join(vocab[:4])})])
                i += 1
            except Exception as e:  # noqa: BLE001
                errs.append(e)

    def reader(seed):
        rr = random.Random(seed)
        while not stop.is_set():
            qs = [" ".join(rr.choices(vocab, k=3)) for _ in range(6)]
            try:
                res = tr.get_class_batched([
                    GetParams(class_name="Kw",
                              keyword_ranking={"query": q}, limit=5)
                    for q in qs])
                bad = [r for r in res if isinstance(r, Exception)]
                if bad:
                    errs.extend(bad)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

    threads = [threading.Thread(target=writer)] + \
        [threading.Thread(target=reader, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(2.5)
    stop.set()
    for t in threads:
        t.join()
    try:
        assert not errs, errs[:3]
        shard = next(iter(kidx.shards.values()))
        q = " ".join(vocab[:3])
        p = GetParams(class_name="Kw", keyword_ranking={"query": q}, limit=10)
        (batched,) = tr.get_class_batched([p])
        # the matmul lane must have actually served (not a vacuous
        # host-vs-host comparison after a silent fallback)
        assert shard.bm25_device is not None
        assert shard.bm25_device.last_batch_stats is not None, \
            "batched device dispatch did not engage"
        shard.bm25_device = None
        host = tr.get_class(p)
        key = lambda r: (-round(r.score, 4), r.obj.uuid)  # noqa: E731
        assert [r.obj.uuid for r in sorted(batched, key=key)] == \
            [r.obj.uuid for r in sorted(host, key=key)]
    finally:
        app.shutdown()


def test_shard_opt_in_serves_device_path(tmp_path):
    from weaviate_tpu_torch.db.shard import Shard

    cd = ClassDef(name="Kw", properties=[
        Property(name="t", data_type=["text"]),
    ], vector_index_type="hnsw_tpu")
    cfg = parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
    rng = np.random.default_rng(9)
    vocab = [f"w{i}" for i in range(30)]
    objs = [StorObj(class_name="Kw", uuid=str(uuidlib.UUID(int=i + 1)),
                    properties={"t": " ".join(
                        np.random.default_rng(i).choice(vocab, size=12))},
                    vector=rng.standard_normal(8).astype(np.float32))
            for i in range(150)]

    on = Shard("s0", str(tmp_path / "on"), cd, cfg,
               invert_cfg={"bm25": {"device": True}}, device="cpu")
    off = Shard("s1", str(tmp_path / "off"), cd, cfg, device="cpu")
    assert on.bm25_device is not None and off.bm25_device is None
    on.put_batch(objs)
    off.put_batch(objs)
    try:
        q = " ".join(vocab[:3])
        r_on = on.object_search(10, keyword_ranking={"query": q})
        r_off = off.object_search(10, keyword_ranking={"query": q})
        assert [r.score for r in r_on] == pytest.approx(
            [r.score for r in r_off], rel=1e-5)
        # uuid order may swap inside f32 near-tie groups; grouping by
        # rounded score makes the comparison tie-stable (strict ranking
        # equivalence is test_device_matches_host_ranking's job)
        key = lambda r: (-round(r.score, 4), r.obj.uuid)  # noqa: E731
        assert sorted(r_on, key=key)[0].obj.uuid == sorted(r_off, key=key)[0].obj.uuid
        assert [r.obj.uuid for r in sorted(r_on, key=key)] == \
            [r.obj.uuid for r in sorted(r_off, key=key)]
        assert on.bm25_device._rows, "device rows engaged on the shard path"
    finally:
        on.shutdown()
        off.shutdown()


# -- the port's ops and engine against the JAX package's ---------------------


def test_scan_ops_match_the_reference():
    import jax.numpy as jnp

    from weaviate_tpu.ops import bm25_scan as jscan

    rng = np.random.default_rng(8)
    for v in (-1, 0, 16383, 16384, 40000):
        assert bm25_scan.n_bucket(v) == jscan.n_bucket(v)
    for k in (1, 3, 8, 9, 100):
        assert bm25_scan.k_bucket(k) == jscan.k_bucket(k)
    n_pad = 16384
    ids = np.sort(rng.choice(n_pad, 700, replace=False)).astype(np.int32)
    ids[5] = ids[4]  # a duplicate id accumulates in both
    scores = rng.random(700).astype(np.float32) + 0.1
    pi, ps = bm25_scan.pad_postings(ids, scores, n_pad)
    ji, js = jscan.pad_postings(ids, scores, n_pad)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(ps, js)
    row = bm25_scan.build_dense_row(torch.from_numpy(pi.astype(np.int64)),
                                    torch.from_numpy(ps), n_pad)
    jrow = jscan.build_dense_row(jnp.asarray(ji), jnp.asarray(js),
                                 jnp.zeros(n_pad + 1, jnp.float32))
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), rtol=1e-5)
    rows = rng.random((4, n_pad)).astype(np.float32)
    sel = (rng.random((64, 4)) < 0.5).astype(np.float32)  # the reference takes Q % 32 == 0
    got = bm25_scan.batch_topk(torch.from_numpy(rows), torch.from_numpy(sel), 8).numpy()
    want = np.asarray(jscan.batch_topk(jnp.asarray(rows), jnp.asarray(sel), 8))
    gs, gi = bm25_scan.unpack_topk(got[3], 8)
    ws, wi = jscan.unpack_topk(want[3], 8)
    np.testing.assert_array_equal(gi, wi)  # random scores: tie-free
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    mask = rng.random(n_pad) < 0.3
    got1 = bm25_scan.dense_topk(torch.from_numpy(rows[0]), 16, torch.from_numpy(mask))
    want1 = jscan.dense_topk(jnp.asarray(rows[0]), 16, jnp.asarray(mask))
    np.testing.assert_array_equal(bm25_scan.unpack_topk(got1.numpy(), 16)[1],
                                  jscan.unpack_topk(want1, 16)[1])


def test_engine_matches_the_jax_engine_on_one_corpus(tmp_path):
    """The port's DeviceBM25 and the JAX package's, each over its own
    package's inverted index of one corpus: tie-aware agreement on plain,
    filtered and batched queries."""
    from weaviate_tpu.entities.schema import ClassDef as JClassDef
    from weaviate_tpu.inverted.bm25 import BM25Searcher as JBM25Searcher
    from weaviate_tpu.inverted.bm25_device import DeviceBM25 as JDeviceBM25
    from weaviate_tpu.inverted.index import InvertedIndex as JInvertedIndex
    from weaviate_tpu.storage.bitmap import Bitmap as JBitmap
    from weaviate_tpu.storage.lsm import Store as JStore

    rng = np.random.default_rng(77)
    vocab = np.array([f"w{i}" for i in range(200)])
    docs = _corpus(rng, 400, vocab)
    tinv = _build(tmp_path, docs, "port")
    jcd = JClassDef.from_dict({"class": "Doc", "properties": [
        {"name": "body", "dataType": ["text"]}, {"name": "title", "dataType": ["text"]}]})
    jinv = JInvertedIndex(JStore(str(tmp_path / "jax")), jcd)
    for i, (body, title) in enumerate(docs):
        jinv.add_object(i, {"body": body, "title": title})
    tdev = DeviceBM25(BM25Searcher(tinv, CLASS_DEF), device="cpu")
    jdev = JDeviceBM25(JBM25Searcher(jinv, jcd))
    prng = random.Random(5)
    queries = [" ".join(prng.choices(list(vocab[:60]), k=prng.choice([2, 4, 8])))
               for _ in range(24)]
    truth_src = BM25Searcher(tinv, CLASS_DEF)

    def agree(got, want, allow=None, q=None):
        assert len(got) == len(want)
        truth = _score_map(truth_src, q, allow)
        for (_, g_s, _), (_, w_s, _) in zip(got, want):
            assert g_s == pytest.approx(w_s, rel=1e-5, abs=1e-5)
        for g_id, g_s, _ in got:
            assert truth[g_id] == pytest.approx(g_s, rel=1e-5, abs=1e-5)
        # both break exact ties toward the lower doc id: the same ids
        assert [g[0] for g in got] == [w[0] for w in want]

    keep = np.nonzero(rng.random(400) < 0.4)[0].astype(np.uint64)
    for q in queries:
        agree(tdev.search(q, 10), jdev.search(q, 10), q=q)
        agree(tdev.search(q, 10, allow_list=Bitmap(keep)),
              jdev.search(q, 10, allow_list=JBitmap(keep)), Bitmap(keep), q)
    for q, got, want in zip(queries, tdev.search_batch(queries, 10),
                            jdev.search_batch(queries, 10)):
        agree(got, want, q=q)
    assert tdev.last_batch_stats["slices"] == jdev.last_batch_stats["slices"]


def test_selection_breaks_ties_toward_the_lower_doc_id():
    """Tie-heavy scores (a few distinct values, zeros among them): the
    port's selection returns exactly the ids `lax.top_k` returns, in both
    the single-row and the batched packing."""
    import jax.numpy as jnp

    from weaviate_tpu.ops import bm25_scan as jscan

    rng = np.random.default_rng(12)
    n_pad = 16384
    levels = np.array([0.0, 0.5, 1.25, 2.0, 7.5], np.float32)
    rows = levels[rng.integers(0, len(levels), (2, n_pad))]
    for k in (8, 64):
        got = bm25_scan.dense_topk(torch.from_numpy(rows[0]), k).numpy()
        want = np.asarray(jscan.dense_topk(jnp.asarray(rows[0]), k))
        np.testing.assert_array_equal(got, want)
    sel = (rng.random((32, 2)) < 0.7).astype(np.float32)
    got = bm25_scan.batch_topk(torch.from_numpy(rows), torch.from_numpy(sel), 16).numpy()
    want = np.asarray(jscan.batch_topk(jnp.asarray(rows), jnp.asarray(sel), 16))
    np.testing.assert_array_equal(got, want)
