"""The native graph engine ("hnsw") in the port: the tests of
tests/test_hnsw.py restated on the port's HnswIndex, then parity with the
JAX package's engine and the port's serving of an "hnsw" class.

Tolerances: ids and distances bit-equal and snapshots byte-equal between
the packages (the same C++ source built with the same flags on the same
machine).
"""

import numpy as np
import pytest

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.index.hnsw import HnswIndex
from weaviate_tpu_torch.storage.bitmap import Bitmap


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """Each package's App chains its device-trace teardown onto SIGTERM.
    Put the handler and both packages' teardown state back after this
    module, so later tests in the same process find them as they were."""
    import signal

    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    mods, keys = (jax_profiling, torch_profiling), ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    states = [{k: m._teardown_state[k] for k in keys} for m in mods]
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, st in zip(mods, states):
        m._teardown_state.update(st)


def make(tmp_path, metric=vi.DISTANCE_L2, **kw):
    cfg = vi.HnswUserConfig.from_dict({"distance": metric, **kw}, "hnsw")
    return HnswIndex(cfg, str(tmp_path))


def brute(vecs, q, k, metric):
    from weaviate_tpu_torch.ops.distances import single_distance

    d = np.array([single_distance(q, v, metric) for v in vecs])
    order = np.argsort(d, kind="stable")[:k]
    return order


@pytest.mark.parametrize("metric", [vi.DISTANCE_L2, vi.DISTANCE_COSINE])
def test_recall_099(tmp_path, rng, metric):
    n, d, k, nq = 4000, 32, 10, 50
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = make(tmp_path / metric, metric, efConstruction=128, maxConnections=16)
    idx.add_batch(np.arange(n), vecs)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    hits = 0
    for q in queries:
        ids, _ = idx.search_by_vector(q, k)
        want = set(brute(vecs, q, k, metric).tolist())
        hits += len(want & set(ids.tolist()))
    recall = hits / (nq * k)
    assert recall >= 0.99, f"recall {recall}"


def test_batch_search(tmp_path, rng):
    n, d = 1000, 16
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = make(tmp_path)
    idx.add_batch(np.arange(n), vecs)
    qs = vecs[:5]
    ids, dists = idx.search_by_vectors(qs, 3)
    assert ids.shape == (5, 3)
    for i in range(5):
        assert ids[i][0] == i
        assert dists[i][0] < 1e-4


def test_delete_and_entrypoint_move(tmp_path, rng):
    idx = make(tmp_path)
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    idx.add_batch(np.arange(200), vecs)
    idx.delete(*range(100))
    assert len(idx) == 100
    ids, _ = idx.search_by_vector(vecs[150], 10)
    assert ids[0] == 150
    assert all(i >= 100 for i in ids.tolist())


def test_readd_replaces(tmp_path, rng):
    idx = make(tmp_path)
    idx.add(5, np.ones(8, np.float32))
    idx.add(5, -np.ones(8, np.float32))
    assert len(idx) == 1
    ids, dists = idx.search_by_vector(-np.ones(8, np.float32), 1)
    assert ids[0] == 5 and dists[0] < 1e-5


def test_allowlist_flat_and_graph(tmp_path, rng):
    vecs = rng.standard_normal((500, 8)).astype(np.float32)
    # small allowList -> flat path
    idx = make(tmp_path / "flat")
    idx.add_batch(np.arange(500), vecs)
    allow = Bitmap([3, 7, 450])
    ids, _ = idx.search_by_vector(vecs[0], 10, allow)
    assert set(ids.tolist()) == {3, 7, 450}
    # force graph path with cutoff 0
    idx2 = make(tmp_path / "graph", flatSearchCutoff=0)
    idx2.add_batch(np.arange(500), vecs)
    allow2 = Bitmap(np.arange(0, 500, 2))
    ids2, _ = idx2.search_by_vector(vecs[0], 10, allow2)
    assert len(ids2) > 0 and all(i % 2 == 0 for i in ids2.tolist())


def test_persistence_snapshot_and_delta(tmp_path, rng):
    p = tmp_path / "shard"
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    idx = make(p)
    idx.add_batch(np.arange(200), vecs[:200])
    idx.flush()  # snapshot + truncate log
    idx.add_batch(np.arange(200, 300), vecs[200:])  # delta in log only
    idx.delete(0)
    idx._log.flush()
    # simulate crash: no shutdown, reopen
    idx2 = make(p)
    assert len(idx2) == 299
    ids, _ = idx2.search_by_vector(vecs[250], 1)
    assert ids[0] == 250
    ids, _ = idx2.search_by_vector(vecs[0], 3)
    assert 0 not in ids.tolist()


def test_search_by_vector_distance(tmp_path, rng):
    idx = make(tmp_path)
    vecs = rng.standard_normal((200, 4)).astype(np.float32)
    idx.add_batch(np.arange(200), vecs)
    ids, dists = idx.search_by_vector_distance(vecs[0], 0.5, 100)
    assert (dists <= 0.5).all()


def test_manhattan_rejected(tmp_path):
    with pytest.raises(vi.ConfigValidationError):
        make(tmp_path, vi.DISTANCE_MANHATTAN)


def test_tombstone_cleanup_churn(tmp_path, rng):
    """delete.go:177-422 parity: after delete-heavy churn + cleanup, node
    count shrinks back (memory reclaimed), recall stays high, and deleted
    docs never resurface."""
    n, d, k = 3000, 24, 10
    idx = make(tmp_path, efConstruction=64, maxConnections=16)
    idx._CLEANUP_MIN_TOMBS = 10**9  # exercise the EXPLICIT cycle here
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx.add_batch(np.arange(n), vecs)
    n_phys_initial = idx.node_count()
    assert n_phys_initial == n

    # churn: delete 60%, in several waves with interleaved re-adds
    deleted = set()
    for wave in range(3):
        victims = rng.choice(
            [i for i in range(n) if i not in deleted], size=600, replace=False
        )
        idx.delete(*victims.tolist())
        deleted.update(int(v) for v in victims)
        # interleave some fresh inserts so cleanup runs on a live graph
        fresh = rng.standard_normal((100, d)).astype(np.float32)
        base = n + wave * 100
        idx.add_batch(np.arange(base, base + 100), fresh)
        vecs = np.concatenate([vecs, fresh])

    removed = idx.cleanup_tombstones()
    assert removed > 0
    live = len(idx)
    assert idx.node_count() == live  # every tombstone physically gone
    assert live == n + 300 - len(deleted)

    # recall over the surviving set stays high after the repair
    live_ids = np.array(
        [i for i in range(vecs.shape[0]) if i not in deleted], dtype=np.int64
    )
    live_vecs = vecs[live_ids]
    queries = rng.standard_normal((40, d)).astype(np.float32)
    hits = 0
    for q in queries:
        ids, _ = idx.search_by_vector(q, k)
        assert not (set(int(x) for x in ids) & deleted)  # no resurrections
        dd = ((live_vecs - q) ** 2).sum(1)
        want = set(live_ids[np.argsort(dd)[:k]].tolist())
        hits += len(want & set(int(x) for x in ids))
    recall = hits / (len(queries) * k)
    assert recall >= 0.95, recall

    # the index keeps working for inserts + searches after compaction
    idx.add(99_999, vecs[0])
    ids, dists = idx.search_by_vector(vecs[0], 2)
    assert 99_999 in set(int(x) for x in ids)


def _wait_cleanup(idx, want_phys, timeout=10.0):
    import time

    deadline = time.time() + timeout
    while time.time() < deadline:
        if idx.node_count() <= want_phys:
            return
        time.sleep(0.02)
    raise AssertionError(f"cleanup never ran: phys={idx.node_count()}")


def test_cleanup_auto_trigger(tmp_path, rng):
    """Crossing the tombstone threshold kicks the background cycle."""
    idx = make(tmp_path, efConstruction=32, maxConnections=8)
    idx._CLEANUP_MIN_TOMBS = 50  # shrink the threshold for the test
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    idx.add_batch(np.arange(300), vecs)
    idx.delete(*range(200))  # 200 tombs > max(50, live=100)
    _wait_cleanup(idx, 100)  # background cycle reclaims the nodes
    assert len(idx) == 100


def test_cleanup_all_deleted(tmp_path, rng):
    idx = make(tmp_path)
    vecs = rng.standard_normal((50, 8)).astype(np.float32)
    idx.add_batch(np.arange(50), vecs)
    idx.delete(*range(50))
    idx.cleanup_tombstones()
    assert idx.node_count() == 0 and len(idx) == 0
    ids, _ = idx.search_by_vector(vecs[0], 5)
    assert len(ids) == 0
    # and it accepts new data afterwards
    idx.add_batch(np.arange(100, 110), vecs[:10])
    ids, dists = idx.search_by_vector(vecs[3], 1)
    assert ids[0] == 103 and dists[0] < 1e-5


def test_cleanup_triggers_on_readd_churn(tmp_path, rng):
    """Regression: update-heavy workloads (re-adds tombstone old nodes
    without any delete() call) must still trigger the cleanup cycle, or
    physical node count grows without bound."""
    idx = make(tmp_path, efConstruction=32, maxConnections=8)
    idx._CLEANUP_MIN_TOMBS = 64
    base = rng.standard_normal((100, 8)).astype(np.float32)
    idx.add_batch(np.arange(100), base)
    for round_i in range(5):
        idx.add_batch(np.arange(100), base + 0.01 * (round_i + 1))
    assert len(idx) == 100
    # 500 updates => 500 tombstones without cleanup; bounded with it
    _wait_cleanup(idx, 100 + 200)
    ids, dists = idx.search_by_vector(base[7] + 0.05, 1)
    assert ids[0] == 7


# -- parity with the JAX package's engine ----------------------------------

def _open(package, path, cfg):
    """An engine of `package` ("jax" or "port") over `path`, from the same
    config dict."""
    if package == "port":
        return HnswIndex(vi.HnswUserConfig.from_dict(cfg, "hnsw"), str(path))
    from weaviate_tpu.entities import vectorindex as jvi
    from weaviate_tpu.index.hnsw import HnswIndex as JaxHnswIndex

    return JaxHnswIndex(jvi.HnswUserConfig.from_dict(cfg, "hnsw"), str(path))


def _pair(tmp_path, metric):
    """The same config in both packages' engines, each on its own dir."""
    cfg = {"distance": metric, "efConstruction": 64, "maxConnections": 16}
    return _open("jax", tmp_path / "jax", cfg), _open("port", tmp_path / "port", cfg)


def _feed(idx, vecs):
    """One sequence of writes: a batch, single adds, a re-add, deletes."""
    n = len(vecs)
    idx.add_batch(np.arange(n - 50), vecs[: n - 50])
    for i in range(n - 50, n):
        idx.add(i, vecs[i])
    idx.add(7, vecs[n - 1] * 0.5)
    idx.delete(*range(100, 140))


def _bits_equal(a, b):
    assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(np.asarray(a[1]).view(np.uint32),
                                  np.asarray(b[1]).view(np.uint32))


@pytest.mark.parametrize("metric", [vi.DISTANCE_L2, vi.DISTANCE_COSINE, vi.DISTANCE_DOT])
def test_same_inserts_give_byte_equal_snapshots_and_answers(tmp_path, metric):
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((1500, 24)).astype(np.float32)
    qs = rng.standard_normal((32, 24)).astype(np.float32)
    jax_idx, port_idx = _pair(tmp_path, metric)
    for idx in (jax_idx, port_idx):
        _feed(idx, vecs)
    _bits_equal(jax_idx.search_by_vectors(qs, 10), port_idx.search_by_vectors(qs, 10))
    _bits_equal(jax_idx.search_by_vector(qs[0], 5), port_idx.search_by_vector(qs[0], 5))
    allow = Bitmap(np.arange(0, 1500, 3))
    _bits_equal(jax_idx.search_by_vectors(qs, 10, allow),
                port_idx.search_by_vectors(qs, 10, allow))
    small = Bitmap([1, 5, 9, 700])
    _bits_equal(jax_idx.search_by_vector(qs[1], 10, small),
                port_idx.search_by_vector(qs[1], 10, small))
    for idx in (jax_idx, port_idx):
        idx.flush()
    with open(tmp_path / "jax" / "hnsw.snapshot", "rb") as f:
        jax_snap = f.read()
    with open(tmp_path / "port" / "hnsw.snapshot", "rb") as f:
        assert f.read() == jax_snap
    with open(tmp_path / "jax" / "hnsw.log", "rb") as f:
        jax_log = f.read()
    with open(tmp_path / "port" / "hnsw.log", "rb") as f:
        assert f.read() == jax_log
    for idx in (jax_idx, port_idx):
        idx.shutdown()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shard_directory_restores_in_the_other_package(tmp_path, writer):
    """A snapshot plus a delta log written by one package restores in the
    other, with bit-equal answers to the writer's."""
    import shutil

    rng = np.random.default_rng(5)
    vecs = rng.standard_normal((900, 16)).astype(np.float32)
    qs = rng.standard_normal((16, 16)).astype(np.float32)
    cfg = {"distance": vi.DISTANCE_COSINE, "efConstruction": 64, "maxConnections": 16}
    src = _open(writer, tmp_path / writer, cfg)
    src.add_batch(np.arange(600), vecs[:600])
    src.flush()  # snapshot
    src.add_batch(np.arange(600, 900), vecs[600:])  # delta only
    src.delete(*range(0, 50))
    src._log.flush()
    want = src.search_by_vectors(qs, 10)
    shutil.copytree(tmp_path / writer, tmp_path / "copy")
    reader = _open("port" if writer == "jax" else "jax", tmp_path / "copy", cfg)
    assert len(reader) == 850
    _bits_equal(reader.search_by_vectors(qs, 10), want)
    for idx in (src, reader):
        idx.shutdown()


def test_build_flags_carry_openmp_and_key_the_library():
    """The engine is built with -fopenmp (hnsw_search_batch's parallel loop
    runs on every core), and the library's name keys on the flags, so a
    build without them is never reused."""
    import ctypes
    import os

    from weaviate_tpu_torch.index import hnsw
    from weaviate_tpu_torch.storage import lsm_native

    assert "-fopenmp" in hnsw.BUILD_FLAGS
    with_flags = lsm_native.so_path(hnsw._SRC_PATH, "hnsw", hnsw.BUILD_FLAGS)
    assert with_flags != lsm_native.so_path(hnsw._SRC_PATH, "hnsw")
    assert with_flags != lsm_native.so_path(hnsw._SRC_PATH, "hnsw", ("-fopenmp", "-g"))
    hnsw._load_lib()
    assert os.path.exists(with_flags)
    # libgomp is among the library's own dependencies (dlsym on the handle
    # searches only those), so the OpenMP runtime is linked in
    lib = ctypes.CDLL(with_flags)
    assert hasattr(lib, "omp_get_max_threads")
    assert hnsw.omp_threads() >= 1


def test_port_shard_serves_an_hnsw_class_and_restarts(tmp_path):
    """The port's Shard (device="cpu") over an "hnsw" class with the dynamic
    ef keys: the engine reads them, and a restart answers as before."""
    import uuid as uuidlib

    from weaviate_tpu_torch.db.shard import Shard
    from weaviate_tpu_torch.entities.schema import ClassDef, Property
    from weaviate_tpu_torch.entities.storobj import StorObj

    cd = ClassDef(name="G", properties=[Property(name="n", data_type=["int"])],
                  vector_index_type="hnsw")
    cfg = vi.parse_and_validate_config("hnsw", {
        "distance": "l2-squared", "ef": -1, "dynamicEfMin": 40,
        "dynamicEfMax": 200, "dynamicEfFactor": 4})
    assert (cfg.dynamic_ef_min, cfg.dynamic_ef_max, cfg.dynamic_ef_factor) == (40, 200, 4)
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((400, 12)).astype(np.float32)
    objs = [StorObj(class_name="G", uuid=str(uuidlib.UUID(int=i + 1)),
                    properties={"n": i}, vector=vecs[i]) for i in range(400)]
    path = str(tmp_path / "g")
    shard = Shard("s0", path, cd, cfg, device="cpu")
    assert isinstance(shard.vector_index, HnswIndex)
    assert shard.vector_index._ef(10) == 40 and shard.vector_index._ef(30) == 120
    assert all(e is None for e in shard.put_batch(objs))
    res = shard.object_vector_search(vecs[:8], 5)
    before = [[(r.obj.uuid, r.distance) for r in rows] for rows in res]
    assert [rows[0][0] for rows in before] == [o.uuid for o in objs[:8]]
    shard.shutdown()
    shard = Shard("s0", path, cd, cfg, device="cpu")
    res = shard.object_vector_search(vecs[:8], 5)
    assert [[(r.obj.uuid, r.distance) for r in rows] for rows in res] == before
    shard.shutdown()


def test_port_app_serves_hnsw_beside_hnsw_tpu_as_the_jax_app(tmp_path):
    """A port App (device="cpu") holds an "hnsw" class with dynamic-ef keys
    beside an "hnsw_tpu" class; its nearVector answers on the hnsw class are
    the JAX App's, uuid for uuid and distance for distance."""
    import json
    import urllib.request
    import uuid as uuidlib

    from weaviate_tpu.server import App as JaxApp
    from weaviate_tpu.server import RestServer as JaxRestServer
    from weaviate_tpu_torch.server import App, RestServer

    def req(port, path, body):
        r = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                   data=json.dumps(body).encode(), method="POST")
        r.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    graph = {"class": "Graph", "vectorIndexType": "hnsw",
             "properties": [{"name": "n", "dataType": ["int"]}],
             "vectorIndexConfig": {"distance": "l2-squared", "ef": -1,
                                   "dynamicEfMin": 40, "dynamicEfMax": 200,
                                   "dynamicEfFactor": 4}}
    card = {**graph, "class": "Card", "vectorIndexType": "hnsw_tpu",
            "vectorIndexConfig": {"distance": "l2-squared"}}
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    qs = rng.standard_normal((6, 16)).astype(np.float32)
    apps = [App(data_path=str(tmp_path / "port"), device="cpu"),
            JaxApp(data_path=str(tmp_path / "jax"))]
    servers = [RestServer(apps[0], port=0), JaxRestServer(apps[1], port=0)]
    try:
        for s in servers:
            s.start()
        answers = []
        for k, (app, srv) in enumerate(zip(apps, servers)):
            classes = (graph, card) if k == 0 else (graph,)
            for c in classes:
                app.schema.add_class(dict(c))
                objs = [{"class": c["class"], "id": str(uuidlib.UUID(int=i + 1)),
                         "properties": {"n": i}, "vector": vecs[i].tolist()}
                        for i in range(600)]
                st, out = req(srv.port, "/v1/batch/objects", {"objects": objs})
                assert st == 200 and all(o["result"]["status"] == "SUCCESS" for o in out)
            got = {}
            for c in classes:
                rows = []
                for q in qs:
                    st, res = req(srv.port, "/v1/graphql", {"query": (
                        "{ Get { %s(nearVector: {vector: %s}, limit: 10) "
                        "{ n _additional { id distance } } } }"
                        % (c["class"], json.dumps(q.tolist())))})
                    assert st == 200, res
                    rows.append([(h["_additional"]["id"], h["_additional"]["distance"])
                                 for h in res["data"]["Get"][c["class"]]])
                got[c["class"]] = rows
            answers.append(got)
        port_idx = next(iter(apps[0].db.get_index("Graph").shards.values())).vector_index
        assert isinstance(port_idx, HnswIndex) and port_idx.config.dynamic_ef_factor == 4
        assert answers[0]["Graph"] == answers[1]["Graph"]
        # the card class and the graph class agree on the nearest object
        assert [r[0][0] for r in answers[0]["Card"]] == [r[0][0] for r in answers[0]["Graph"]]
    finally:
        for s in servers:
            s.stop()
        for a in apps:
            a.shutdown()
