"""The port's index (weaviate_tpu_torch.index.gpu.GpuVectorIndex) against
the JAX package's TpuVectorIndex on the same inputs, on the CPU: exact
search on both scan paths, tombstones, both filter tiers, sync and async
dispatch, state carried across with state_from_arrays, cross-package
vector.log restore, and the recall fixture bars.

Tolerances: doc ids equal exactly (the data is tie-free gaussian);
distances rtol 1e-5, atol 1e-5 — both packages rescore in f32 and differ
only in the order of summation.
"""

import os

import numpy as np
import pytest

from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import new_vector_index as jax_new_index
from weaviate_tpu.storage.bitmap import Bitmap as JaxBitmap
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.index import new_vector_index as torch_new_index
from weaviate_tpu_torch.index.gpu import GpuVectorIndex
from weaviate_tpu_torch.ops import gmin_scan
from weaviate_tpu_torch.state import state_from_arrays
from weaviate_tpu_torch.storage.bitmap import Bitmap as TorchBitmap

D, N, B, K = 32, 3000, 16, 10
SENTINEL = np.iinfo(np.uint64).max
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "recall_fixture.npz")


def _pair(tmp_path, metric="l2-squared", n=N, seed=0, **cfg):
    """A JAX index and a port index built from one config and one input
    set. -> (jax index, port index, vectors, rng)."""
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, D)).astype(np.float32)
    conf = {"distance": metric, **cfg}
    jidx = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path / "jax"))
    tidx = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf),
                           str(tmp_path / "torch"), device="cpu")
    for idx in (jidx, tidx):
        idx.add_batch(np.arange(n), vecs)
    return jidx, tidx, vecs, rng


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


def _queries(rng, b=B):
    return rng.standard_normal((b, D)).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot", "manhattan"])
@pytest.mark.parametrize("b", [1, B])
def test_exact_search_matches_jax(tmp_path, metric, b):
    jidx, tidx, _, rng = _pair(tmp_path, metric)
    q = _queries(rng, b)
    snap = tidx._read_snapshot()
    assert tidx._use_gmin(snap, tidx.padded_width(b), K) == jidx._use_gmin(
        jidx._read_snapshot(), jidx.padded_width(b), K)
    before = gmin_scan.launches
    _assert_same(tidx.search_by_vectors(q, K), jidx.search_by_vectors(q, K))
    assert gmin_scan.launches == before  # CPU tensors never launch the kernel


def test_exact_topk_config_matches_jax(tmp_path):
    jidx, tidx, _, rng = _pair(tmp_path, exactTopK=True)
    assert not tidx._use_gmin(tidx._read_snapshot(), B, K)
    q = _queries(rng)
    _assert_same(tidx.search_by_vectors(q, K), jidx.search_by_vectors(q, K))


@pytest.mark.parametrize("b", [1, B])
def test_tombstones_match_jax(tmp_path, b):
    jidx, tidx, vecs, rng = _pair(tmp_path)
    q = vecs[:b] + 0.01 * _queries(rng, b)  # each query's nearest doc is doc i
    dead = list(range(0, 40, 2)) + list(range(b))
    for idx in (jidx, tidx):
        idx.delete(*dead)
    got = tidx.search_by_vectors(q, K)
    _assert_same(got, jidx.search_by_vectors(q, K))
    assert not np.isin(got[0], np.array(dead, np.uint64)).any()
    assert len(tidx) == len(jidx) == N - len(set(dead))


@pytest.mark.parametrize("b", [1, B])
@pytest.mark.parametrize("size", ["large", "small"])
def test_allow_list_tiers_match_jax(tmp_path, b, size):
    """A large allowList takes the masked scan (the kernel's bias path), a
    small one the gather tier; both answer as the JAX package does."""
    jidx, tidx, _, rng = _pair(tmp_path, flatSearchCutoff=500)
    allowed = np.arange(0, N, 3) if size == "large" else rng.choice(N, 200, replace=False)
    for idx in (jidx, tidx):
        idx.delete(*allowed[:5].tolist())
    q = _queries(rng, b)
    got = tidx.search_by_vectors(q, K, allow_list=TorchBitmap(allowed))
    _assert_same(got, jidx.search_by_vectors(q, K, allow_list=JaxBitmap(allowed)))
    live = np.setdiff1d(allowed, allowed[:5]).astype(np.uint64)
    assert np.isin(got[0], live).all()


def test_async_matches_sync(tmp_path):
    _, tidx, _, rng = _pair(tmp_path)
    q = _queries(rng)
    fins = [tidx.search_by_vectors_async(q, K), tidx.search_by_vectors_async(q[:3], K)]
    sync = tidx.search_by_vectors(q, K)
    got = fins[0]()
    np.testing.assert_array_equal(got[0], sync[0])
    np.testing.assert_array_equal(got[1], sync[1])
    np.testing.assert_array_equal(fins[1]()[0], tidx.search_by_vectors(q[:3], K)[0])


def test_snapshot_pins_pre_delete_world(tmp_path):
    """A snapshot taken before a delete and an add keeps answering from its
    own state, though rows were written in place after it."""
    _, tidx, vecs, _ = _pair(tmp_path)
    snap = tidx._read_snapshot()
    q = vecs[:B].copy()
    before = tidx._dispatch_search(snap, q, 1)()
    tidx.delete(*range(B))
    tidx.add_batch(np.arange(N, N + B), q)  # exact copies, at slots past snap.n
    after = tidx.search_by_vectors(q, 1)
    np.testing.assert_array_equal(after[0].ravel(), np.arange(N, N + B, dtype=np.uint64))
    np.testing.assert_array_equal(tidx._dispatch_search(snap, q, 1)()[0], before[0])
    np.testing.assert_array_equal(before[0].ravel(), np.arange(B, dtype=np.uint64))


def test_state_from_arrays_round_trip(tmp_path):
    jidx, _, vecs, rng = _pair(tmp_path)
    jidx.delete(*range(0, 100, 3))
    snap = jidx._read_snapshot()
    arrays = {"store": np.asarray(snap.store), "sq_norms": np.asarray(snap.sq_norms),
              "tombs": np.asarray(snap.tombs), "slot_to_doc": snap.slot_to_doc,
              "n": snap.n, "capacity": snap.capacity, "dim": snap.dim}
    tidx = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                           str(tmp_path / "carried"), device="cpu")
    tidx.load_state(state_from_arrays(arrays, device="cpu"))
    assert len(tidx) == len(jidx) and tidx.capacity == snap.capacity
    for b in (1, B):
        q = _queries(rng, b)
        _assert_same(tidx.search_by_vectors(q, K), jidx.search_by_vectors(q, K))
    # the carried state is durable: a restart replays the rewritten log
    q = _queries(rng)
    want = tidx.search_by_vectors(q, K)
    tidx.shutdown()
    again = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                            str(tmp_path / "carried"), device="cpu")
    _assert_same(again.search_by_vectors(q, K), want)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_vector_log_restores_across_packages(tmp_path, writer):
    """A shard's vector.log written by one package restores in the other,
    adds, re-adds and deletes included, and a torn tail is tolerated."""
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    conf = {"distance": "cosine"}
    path = str(tmp_path / "shard")
    if writer == "jax":
        w = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), path)
    else:
        w = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf), path, device="cpu")
    w.add_batch(np.arange(N), vecs)
    w.add(7, vecs[8])  # re-add: slot 7 tombstones, doc 7 moves
    w.delete(*range(100, 150))
    q = _queries(rng)
    want = w.search_by_vectors(q, K)
    w.shutdown()
    with open(os.path.join(path, "vector.log"), "ab") as f:
        f.write(b"\x01\x02\x03")  # torn tail
    if writer == "jax":
        r = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf), path, device="cpu")
    else:
        r = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), path)
    assert len(r) == N - 50
    _assert_same(r.search_by_vectors(q, K), want)


def _recall(index, queries, gt, allow=None):
    ids, _ = index.search_by_vectors(queries, K, allow_list=allow)
    hits = sum(len(set(gt[i][:K].tolist()) & set(int(x) for x in ids[i] if x != SENTINEL))
               for i in range(len(queries)))
    return hits / (len(queries) * K)


@pytest.mark.parametrize("case", ["l2", "cosine", "masked", "gather"])
def test_recall_fixture_bars(tmp_path, case):
    data = np.load(FIXTURE)
    vectors, queries = data["vectors"].astype(np.float32), data["queries"].astype(np.float32)
    metric = "cosine" if case == "cosine" else "l2-squared"
    cutoff = {"masked": 10, "gather": 10 ** 9}.get(case, 40000)
    idx = torch_new_index(tvi.parse_and_validate_config(
        "hnsw_tpu", {"distance": metric, "flatSearchCutoff": cutoff}), str(tmp_path), device="cpu")
    idx.add_batch(np.arange(len(vectors)), vectors)
    if case in ("l2", "cosine"):
        gt = data["gt_cos"] if case == "cosine" else data["gt"]
        assert idx._use_gmin(idx._read_snapshot(), len(queries), K)
        assert _recall(idx, queries, gt) >= 0.99
        return
    mask = np.arange(len(vectors)) % 3 == 0
    rows = np.flatnonzero(mask)
    q = queries[:50]
    d = ((q[:, None, :] - vectors[rows][None, :, :]) ** 2).sum(-1)
    gt = rows[np.argsort(d, axis=1, kind="stable")[:, :K]]
    assert _recall(idx, q, gt, allow=TorchBitmap(rows)) >= 0.99


def test_small_index_edges(tmp_path):
    idx = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                          str(tmp_path), device="cpu")
    q = np.zeros((2, D), np.float32)
    assert idx.search_by_vectors(q, K)[0].shape == (2, 0)  # empty index
    idx.add_batch(np.arange(5), np.eye(5, D, dtype=np.float32))
    ids, dists = idx.search_by_vectors(q, K)  # k > n
    assert ids.shape == (2, 5) and np.isfinite(dists).all()
    ids, dists = idx.search_by_vector_distance(np.eye(1, D, dtype=np.float32)[0], 1.5, 10)
    np.testing.assert_array_equal(ids, [0])  # the others lie at distance 2
    assert dists[0] == 0.0
    with pytest.raises(ValueError):
        idx.add(99, np.zeros(D + 1, np.float32))
    assert idx.contains(3) and not idx.contains(99)
    allow = TorchBitmap([0])
    assert idx.search_by_vectors(q, K, allow_list=allow)[0].tolist() == [[0], [0]]
    idx.drop()
    assert len(idx) == 0 and idx.search_by_vectors(q, K)[0].shape == (2, 0)
    # the same slots now hold other docs: the allowList's cached slot list
    # from before the drop must not carry over
    idx.add_batch(np.arange(10, 15), np.eye(5, D, dtype=np.float32))
    assert idx.search_by_vectors(q, K, allow_list=allow)[0].shape == (2, 0)


def test_unported_types_and_tiers_raise(tmp_path, monkeypatch):
    noop = torch_new_index(tvi.parse_and_validate_config("noop", {}), str(tmp_path), device="cpu")
    with pytest.raises(ValueError):
        noop.search_by_vector(np.zeros(D, np.float32), 1)
    with pytest.raises(NotImplementedError):
        torch_new_index(tvi.parse_and_validate_config(
            "hnsw_tpu", {"pq": {"enabled": True}}), str(tmp_path / "pq"), device="cpu")
    mesh = tvi.HnswUserConfig(index_type="hnsw_tpu_mesh")
    with pytest.raises(ValueError, match="item 10"):
        torch_new_index(mesh, str(tmp_path / "mesh"), device="cpu")
    idx = GpuVectorIndex(tvi.parse_and_validate_config("hnsw_tpu", {}), str(tmp_path / "ivf"),
                         device="cpu", persist=False)
    idx.add_batch(np.arange(64), np.ones((64, D), np.float32))
    monkeypatch.setenv("IVF_ENABLED", "true")
    monkeypatch.setenv("IVF_MIN_N", "10")
    with pytest.raises(NotImplementedError, match="item 9"):
        idx.search_by_vectors(np.ones((1, D), np.float32), 1)


def test_concurrent_reads_and_writes_stress(tmp_path):
    """Readers search lock-free while a writer adds (in place, past every
    snapshot's n) and deletes. Every answer is sorted, names only docs
    written before it ended, and never a doc whose delete returned before
    the search began."""
    import sys
    import threading
    import time

    rng = np.random.default_rng(11)
    idx = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                          str(tmp_path), device="cpu", persist=False)
    idx.add_batch(np.arange(N), rng.standard_normal((N, D)).astype(np.float32))
    lock = threading.Lock()
    state = {"deleted": [], "next_id": N, "errors": [], "searches": 0}
    stop = threading.Event()

    def writer():
        for step in range(20):
            gone = list(range(step * 50, step * 50 + 50))
            idx.delete(*gone)
            with lock:
                state["deleted"].extend(gone)
            base = state["next_id"]
            idx.add_batch(np.arange(base, base + 64), rng.standard_normal((64, D)).astype(np.float32))
            with lock:
                state["next_id"] = base + 64
            time.sleep(0.02)  # let the readers interleave with every step
        stop.set()

    def reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            with lock:
                dead = np.array(state["deleted"], np.uint64)
            q = r.standard_normal((B if seed % 2 else 1, D)).astype(np.float32)
            ids, dists = idx.search_by_vectors(q, K)
            with lock:
                top = state["next_id"]
                state["searches"] += 1
            if (np.isin(ids, dead).any() or (ids >= top).any()
                    or (np.diff(dists, axis=1) < 0).any()):
                state["errors"].append((ids, dists))
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not state["errors"], state["errors"][0]
    assert state["searches"] >= 20
    assert len(idx) == N + 20 * 64 - 1000
