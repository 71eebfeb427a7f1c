"""The port's compressed index (weaviate_tpu_torch.index.gpu.GpuVectorIndex
with `pq.enabled`) against the JAX package's TpuVectorIndex, on the CPU.

A shard is built and compressed in one package, persisted, and restarted
from the same directory (`vector.log` + `pq.npz` [+ `pq4.npz`]) in both:
the two must answer the same batches. Both restart from the same files,
so both lay the replayed rows out in the same slots. Every tier of the
compressed dispatch is covered: the 4-bit funnel, the rescored tier (the
fast scan over the bf16 copy), the codes kernel's tier, the
reconstruction scan (B < 8), the LUT scan (manhattan) and the gather
tier.

Tolerances: doc ids equal exactly (tie-free gaussian data); distances
rtol 1e-5, atol 1e-5 — both packages compute the same f32 (or bf16-operand)
arithmetic in another order.
"""

import os

import numpy as np
import pytest

from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import new_vector_index as jax_new_index
from weaviate_tpu.storage.bitmap import Bitmap as JaxBitmap
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.index import new_vector_index as torch_new_index
from weaviate_tpu_torch.state import state_from_arrays
from weaviate_tpu_torch.storage.bitmap import Bitmap as TorchBitmap

D, N, B, K = 32, 3000, 16, 10
SENTINEL = np.iinfo(np.uint64).max
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "recall_fixture.npz")
PQ = {"enabled": True, "segments": 8, "centroids": 32}


def _conf(metric="l2-squared", **pq):
    return {"distance": metric, "flatSearchCutoff": 500, "pq": {**PQ, **pq}}


def _jax(conf, path):
    return jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(path))


def _torch(conf, path, **kw):
    return torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf), str(path),
                           device="cpu", **kw)


def _vecs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32), rng


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _batches(rng):
    """Queries for every dispatch width: 16 rows (the kernel tiers), 1 row
    (the chunked tiers), a masked allowList and a gather-tier allowList."""
    q = rng.standard_normal((B, D)).astype(np.float32)
    return [(q, None), (q[:1], None), (q, np.arange(0, N, 2)),
            (q[:4], rng.choice(N, 300, replace=False))]


def _compare(tidx, jidx, rng):
    for q, allow in _batches(rng):
        _assert_same(tidx.search_by_vectors(q, K, TorchBitmap(allow) if allow is not None else None),
                     jidx.search_by_vectors(q, K, JaxBitmap(allow) if allow is not None else None))


# (metric, pq overrides)
CASES = {
    "bits8_rescore": ("l2-squared", {}),
    "bits8_codes": ("dot", {"rescore": False}),
    "bits4": ("l2-squared", {"bits": 4}),
    "bits4_codes_opq": ("cosine", {"bits": 4, "rescore": False, "rotation": "opq"}),
    "manhattan_lut": ("manhattan", {"rescore": False}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_written_by_jax_restarts_in_the_port(tmp_path, case):
    metric, pq = CASES[case]
    conf = _conf(metric, **pq)
    vecs, rng = _vecs(1)
    w = _jax(conf, tmp_path)
    w.add_batch(np.arange(N), vecs)
    assert w.compressed
    w.delete(*range(0, 60, 3))
    w.shutdown()
    names = sorted(os.listdir(tmp_path))
    assert "pq.npz" in names and ("pq4.npz" in names) == (pq.get("bits") == 4)
    jidx, tidx = _jax(conf, tmp_path), _torch(conf, tmp_path)
    assert tidx.compressed and len(tidx) == len(jidx) == N - 20
    _compare(tidx, jidx, rng)


def test_shard_written_by_the_port_restarts_in_jax(tmp_path):
    conf = _conf("l2-squared", bits=4)
    vecs, rng = _vecs(2)
    w = _torch(conf, tmp_path)
    w.add_batch(np.arange(N), vecs)
    assert w.compressed
    w.delete(*range(5, 50, 5))
    w.shutdown()
    jidx, tidx = _jax(conf, tmp_path), _torch(conf, tmp_path)
    assert jidx.compressed and jidx._pq4 is not None
    _compare(tidx, jidx, rng)


@pytest.mark.parametrize("route", ["config_update", "compress"])
def test_compress_appends_growth_and_deletes_match_jax(tmp_path, route):
    """Ingest, then compress (config update, or compress()), then appends
    that are encoded on the way in, across a capacity growth, and deletes:
    the same operations on both packages give the same answers."""
    vecs, rng = _vecs(3, n=N + 16000)
    base = {"distance": "l2-squared", "flatSearchCutoff": 500}
    pq_conf = {**base, "pq": PQ}
    built = []
    for make, vi in ((_jax, jvi), (_torch, tvi)):
        idx = make(base if route == "config_update" else {**base, "pq": {**PQ, "enabled": False}},
                   tmp_path / make.__name__)
        idx.add_batch(np.arange(N), vecs[:N])
        if route == "config_update":
            idx.update_user_config(vi.parse_and_validate_config("hnsw_tpu", pq_conf))
        else:
            idx.compress()
        assert idx.compressed and idx.config.pq.enabled
        idx.add_batch(np.arange(N, N + 16000), vecs[N:])  # grows 16384 -> 32768 slots
        for d in range(N + 100, N + 110):
            idx.add(d + 20000, vecs[d])  # single adds through the staging buffer
        idx.delete(*range(0, 300, 7))
        built.append(idx)
    jidx, tidx = built
    assert tidx.capacity == jidx.capacity == 32768 and len(tidx) == len(jidx)
    q = vecs[N: N + B] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    got = tidx.search_by_vectors(q, K)
    _assert_same(got, jidx.search_by_vectors(q, K))
    np.testing.assert_array_equal(got[0][:, 0], np.arange(N, N + B, dtype=np.uint64))
    _compare(tidx, jidx, rng)


def test_declared_compress_matches_jax(tmp_path):
    """A pq block declared at creation compresses at the first write that
    brings enough rows, in both packages alike."""
    conf = _conf("dot", rescore=False)
    vecs, rng = _vecs(4)
    built = []
    for make in (_jax, _torch):
        idx = make(conf, tmp_path / make.__name__)
        idx.add_batch(np.arange(100), vecs[:100])
        assert not idx.compressed  # fewer rows than max(256, centroids)
        idx.add_batch(np.arange(100, N), vecs[100:])
        assert idx.compressed
        built.append(idx)
    _compare(built[1], built[0], rng)


def test_snapshot_before_compress_keeps_the_float_store(tmp_path):
    vecs, _ = _vecs(5)
    idx = _torch({"distance": "l2-squared"}, tmp_path)
    idx.add_batch(np.arange(N), vecs)
    snap = idx._read_snapshot()
    before = idx._dispatch_search(snap, vecs[:B], 1)()
    idx.compress()
    assert idx.compressed and idx._read_snapshot().store is None
    after = idx._dispatch_search(snap, vecs[:B], 1)()
    _assert_same(after, before)
    np.testing.assert_array_equal(before[0].ravel(), np.arange(B, dtype=np.uint64))
    assert np.allclose(before[1], 0.0, atol=1e-4)  # exact f32 distances to themselves


@pytest.mark.parametrize("bad", ["garbage", "hamming_codebook"])
def test_rejected_codebook_serves_uncompressed(tmp_path, bad, caplog):
    conf = _conf("l2-squared")
    vecs, rng = _vecs(6)
    w = _torch(conf, tmp_path)
    w.add_batch(np.arange(N), vecs)
    w.shutdown()
    path = os.path.join(tmp_path, "pq.npz")
    if bad == "garbage":
        with open(path, "wb") as f:
            f.write(b"not a zip")
    else:
        z = dict(np.load(path))
        z["metric"] = np.array("hamming")
        np.savez(path, **z)
    r = _torch(conf, tmp_path)
    assert not r.compressed and not r.config.pq.enabled
    assert any("rejected" in rec.getMessage() for rec in caplog.records)
    plain = _torch({"distance": "l2-squared", "flatSearchCutoff": 500}, tmp_path / "plain")
    plain.add_batch(np.arange(N), vecs)
    q = rng.standard_normal((B, D)).astype(np.float32)
    _assert_same(r.search_by_vectors(q, K), plain.search_by_vectors(q, K))


def test_compressed_state_from_arrays_matches_jax(tmp_path):
    """A compressed JAX snapshot's arrays carried across answer as the JAX
    index does, and a restart of the carried index replays its rows and
    re-enters compressed mode."""
    conf = _conf("l2-squared", bits=4)
    vecs, rng = _vecs(7)
    jidx = _jax(conf, tmp_path / "jax")
    jidx.add_batch(np.arange(N), vecs)
    jidx.delete(*range(0, 100, 3))
    s = jidx._read_snapshot()
    arrays = {"tombs": np.asarray(s.tombs), "slot_to_doc": s.slot_to_doc, "n": s.n,
              "capacity": s.capacity, "dim": s.dim, "metric": "l2-squared",
              "pq_codebook": s.pq.codebook, "codes": np.asarray(s.codes),
              "recon_norms": np.asarray(s.recon_norms), "host_vecs": s.host_vecs,
              "rescore": np.asarray(s.rescore_dev).astype(np.float32),
              "rescore_sq_norms": np.asarray(s.rescore_sq_norms),
              "pq4_codebook": s.pq4.codebook, "codes4": np.asarray(s.codes4),
              "recon_norms4": np.asarray(s.recon_norms4)}
    tidx = _torch(conf, tmp_path / "carried")
    tidx.load_state(state_from_arrays(arrays, device="cpu"))
    assert tidx.compressed and len(tidx) == len(jidx)
    _compare(tidx, jidx, rng)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = tidx.search_by_vectors(q, K)
    tidx.shutdown()
    again = _torch(conf, tmp_path / "carried")
    assert again.compressed
    ids, _ = again.search_by_vectors(q, K)
    # the restart re-packs the slots (deleted rows are not replayed), so
    # the funnel's stage 1 sees other groups: most answers stay
    assert np.mean([len(set(a) & set(b)) for a, b in zip(ids, want[0])]) >= 9


def test_drop_removes_the_codebooks(tmp_path):
    idx = _torch(_conf("l2-squared", bits=4), tmp_path)
    vecs, _ = _vecs(8)
    idx.add_batch(np.arange(N), vecs)
    assert sorted(os.path.basename(p) for p in idx.list_files()) == [
        "pq.npz", "pq4.npz", "vector.log"]
    idx.drop()
    assert not idx.compressed and not os.path.exists(os.path.join(tmp_path, "pq.npz"))
    assert idx.search_by_vectors(vecs[:2], K)[0].shape == (2, 0)


def _recall(index, queries, gt, allow=None):
    ids, _ = index.search_by_vectors(queries, K, allow_list=allow)
    hits = sum(len(set(gt[i][:K].tolist()) & set(int(x) for x in ids[i] if x != SENTINEL))
               for i in range(len(queries)))
    return hits / (len(queries) * K)


@pytest.mark.parametrize("case", ["rescored", "unrescored", "filtered"])
def test_pq_recall_fixture_bars(tmp_path, case):
    """tests/test_recall_fixture.py's PQ bars on the port: rescored >= 0.95,
    unrescored (16 segments) >= 0.70, filtered (masked scan) >= 0.95."""
    data = np.load(FIXTURE)
    vectors, queries = data["vectors"].astype(np.float32), data["queries"].astype(np.float32)
    pq = ({"segments": 16, "centroids": 256, "rescore": False} if case == "unrescored"
          else {"segments": 8, "centroids": 256})
    idx = _torch({"distance": "l2-squared", "flatSearchCutoff": 10,
                  "pq": {"enabled": False, **pq}}, tmp_path)
    idx.add_batch(np.arange(len(vectors)), vectors)
    idx.compress()
    assert idx.compressed
    if case != "filtered":
        assert _recall(idx, queries, data["gt"]) >= (0.95 if case == "rescored" else 0.70)
        return
    rows = np.flatnonzero(np.arange(len(vectors)) % 2 == 0)
    q = queries[:50]
    d = ((q[:, None, :] - vectors[rows][None, :, :]) ** 2).sum(-1)
    gt = rows[np.argsort(d, axis=1, kind="stable")[:, :K]]
    assert _recall(idx, q, gt, allow=TorchBitmap(rows)) >= 0.95
