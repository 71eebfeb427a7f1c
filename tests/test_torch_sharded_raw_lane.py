"""The gRPC raw lane over a class of several local shards (the port's
ClassIndex.search_raw_packed) on the CPU: its BatchSearch replies equal the
general path's bit for bit, the JAX package's on the same class, ids and
vectors (its general path), and the plain scatter-gather reference's
(benchmark/wbench/scatter_reference.py); a shard that cannot serve sends
the whole request to the general path; short shards, ties across shards,
the packed arena's reordering, and the lane's spans and facts.
"""

import os
import signal
import sys
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.server import App as JaxApp
from weaviate_tpu.server.grpc_server import SearchServicer as JaxSearchServicer
from weaviate_tpu_torch.config import load_config
from weaviate_tpu_torch.db.class_index import _merge_shard_arrays, _reorder_arena
from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
from weaviate_tpu_torch.monitoring import profiling, tracing
from weaviate_tpu_torch.server import App
from weaviate_tpu_torch.server.grpc_server import SearchServicer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "benchmark"))
from wbench import reference, scatter_reference  # noqa: E402

D, K, B = 128, 10, 32


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """An App chains its device-trace teardown onto SIGTERM: put the
    handler and the teardown state back after this module."""
    keys = ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    state = {k: profiling._teardown_state[k] for k in keys}
    yield
    signal.signal(signal.SIGTERM, handler)
    profiling._teardown_state.update(state)


class _Ctx:
    def abort(self, *a):
        raise AssertionError(a)


def _uid(i):
    return str(uuidlib.UUID(int=i + 1))


class Served:
    """An App on the CPU with one class of `shards` shards, filled with
    `x` (object i has the id _uid(i)) and flushed, so every shard's packed
    plane serves."""

    def __init__(self, path, shards, metric, x, traced=False, tags=False, ids=None):
        env = {"TRACING_ENABLED": "true"} if traced else {}
        self.app = App(config=load_config(env), data_path=str(path), device="cpu")
        props = [{"name": "tag", "dataType": ["text"]}] if tags else []
        self.class_def = {"class": "Doc", "vectorIndexType": "hnsw_tpu",
                          "vectorIndexConfig": {"distance": metric},
                          "shardingConfig": {"desiredCount": shards}, "properties": props}
        self.app.schema.add_class(dict(self.class_def))
        self.metric, self.x = metric, x
        self.ids = list(range(len(x))) if ids is None else ids
        self.objs = [{"class": "Doc", "id": _uid(i), "vector": v,
                      **({"properties": {"tag": "t" * (i % 7)}} if tags else {})}
                     for i, v in zip(self.ids, x)]
        for s in range(0, len(self.objs), 2000):
            assert all(r.err is None
                       for r in self.app.batch.add_objects(self.objs[s:s + 2000]))
        self.idx = self.app.db.get_index("Doc")
        self.flush()
        self.sv = SearchServicer(self.app)

    def flush(self):
        for shard in self.idx.shards.values():
            shard.flush()
            shard.store.flush_memtables()

    def part(self):
        """Each row's shard, by its number in shard order."""
        names = self.idx.sharding_state.all_physical_shards()
        return np.array([names.index(self.idx.shard_for(_uid(i))) for i in self.ids])

    def raw(self, q):
        got = self.sv._raw_batch_lane(_batch(q), 0.0)
        assert got is not None, "the raw lane did not serve the batch"
        return pb.BatchSearchReply.FromString(got)

    def general(self, q):
        sv = SearchServicer(self.app)
        sv._raw_lane_target = lambda request: None
        got = sv.BatchSearch(_batch(q), _Ctx())
        assert sv.raw_lane_batches == 0
        return pb.BatchSearchReply.FromString(got) if isinstance(got, bytes) else got

    def close(self):
        self.app.shutdown()


class JaxServed:
    """The JAX package's App with the same class (`shards` shards), ids
    and vectors as a Served; it answers a class of several shards through
    its general path."""

    def __init__(self, path, served):
        self.app = JaxApp(data_path=str(path))
        self.app.schema.add_class(served.class_def)
        for s in range(0, len(served.objs), 2000):
            assert all(r.err is None for r in self.app.batch.add_objects(served.objs[s:s + 2000]))
        assert len(self.app.db.get_index("Doc").shards) == len(served.idx.shards)
        self.sv = JaxSearchServicer(self.app)

    def reply(self, q):
        got = self.sv.BatchSearch(_batch(q), _Ctx())
        return pb.BatchSearchReply.FromString(
            got if isinstance(got, (bytes, bytearray)) else got.SerializeToString())

    def close(self):
        self.app.shutdown()


def _same_as_jax(got, jax_reply):
    """The port's answers equal the JAX package's: ids exact, distances at
    rtol 1e-5."""
    ids, d = _answers(jax_reply)
    assert ids.shape == got[0].shape
    assert np.array_equal(got[0], ids)
    np.testing.assert_allclose(got[1], d, rtol=1e-5, atol=0)


def _batch(q):
    return pb.BatchSearchRequest(requests=[pb.SearchRequest(
        class_name="Doc", limit=K, near_vector=pb.NearVectorParams(vector=v.tolist()))
        for v in q])


def _answers(reply):
    """-> (row numbers [m, k], f32 distances [m, k]) of a reply."""
    ids = np.array([[uuidlib.UUID(r.id).int - 1 for r in one.results] for one in reply.replies])
    d = np.array([[r.distance for r in one.results] for one in reply.replies], dtype=np.float32)
    return ids, d


def _gauss(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


CASES = {"l2-4": (4, "l2-squared", False), "cosine-4": (4, "cosine", False),
         "dot-4": (4, "dot", False), "l2-2": (2, "l2-squared", True)}


@pytest.fixture(scope="module", params=list(CASES))
def served(request, tmp_path_factory):
    shards, metric, tags = CASES[request.param]
    s = Served(tmp_path_factory.mktemp(request.param), shards, metric,
               _gauss(1500 * shards, shards), tags=tags)
    s.jax = JaxServed(tmp_path_factory.mktemp(request.param + "-jax"), s)
    yield s
    s.jax.close()
    s.close()


def test_the_lane_equals_the_general_path_and_the_scatter_reference(served):
    q = _gauss(B, 99)
    raw_ids, raw_d = _answers(served.raw(q))
    gen_ids, gen_d = _answers(served.general(q))
    assert raw_ids.shape == (B, K)
    assert np.array_equal(raw_ids, gen_ids)
    assert np.array_equal(raw_d.view(np.uint32), gen_d.view(np.uint32))
    _same_as_jax((raw_ids, raw_d), served.jax.reply(q))
    ref_ids, ref_d = scatter_reference.scatter_gather(q, served.x, served.part(), K,
                                                      served.metric)
    assert np.array_equal(raw_ids, ref_ids)
    np.testing.assert_allclose(raw_d, ref_d, rtol=1e-5, atol=0)


def test_the_shards_partition_the_class_and_the_reference_is_the_exact_top_k(served):
    part = served.part()
    names = served.idx.sharding_state.all_physical_shards()
    held = [set(served.idx.shards[n].find_uuids(None)) for n in names]
    assert sum(len(h) for h in held) == len(served.x)
    assert set().union(*held) == {_uid(i) for i in served.ids}
    for i, u in enumerate(_uid(i) for i in served.ids):
        assert [u in h for h in held] == [j == part[i] for j in range(len(names))]
    assert len(set(part.tolist())) == len(names)
    q = _gauss(B, 98)
    ids, d = scatter_reference.scatter_gather(q, served.x, part, K, served.metric)
    t_ids, t_d = reference.truth(q, served.x, K, served.metric)
    assert np.array_equal(ids, t_ids)
    np.testing.assert_allclose(d, t_d, rtol=1e-9, atol=1e-9)


def test_a_shard_with_rows_in_its_memtable_sends_the_request_to_the_general_path(tmp_path):
    s = Served(tmp_path, 2, "l2-squared", _gauss(1200, 5))
    try:
        q = _gauss(8, 6)
        want = _answers(s.raw(q))
        extra = _gauss(1, 7)[0] + 50.0  # far from every query: the answers stay
        assert s.app.batch.add_objects([{"class": "Doc", "id": _uid(10 ** 6),
                                         "vector": extra}])[0].err is None
        busy = s.idx.shard_for(_uid(10 ** 6))
        assert [sh.raw_plane_ready() for n, sh in sorted(s.idx.shards.items())] == [
            n != busy for n in sorted(s.idx.shards)]
        assert s.idx.raw_lane_shards() is None
        assert s.sv._raw_batch_lane(_batch(q), 0.0) is None
        reply = s.sv.BatchSearch(_batch(q), _Ctx())
        reply = pb.BatchSearchReply.FromString(reply) if isinstance(reply, bytes) else reply
        assert s.sv.raw_lane_batches == 0
        got = _answers(reply)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        s.flush()
        s.sv.BatchSearch(_batch(q), _Ctx())
        assert s.sv.raw_lane_batches == 1
    finally:
        s.close()


def test_a_shard_search_that_raises_sends_the_request_to_the_general_path(tmp_path):
    s = Served(tmp_path, 4, "l2-squared", _gauss(1600, 8))
    try:
        q = _gauss(8, 9)
        want = _answers(s.general(q))
        names = s.idx.sharding_state.all_physical_shards()
        broken = s.idx.shards[names[2]].vector_index

        def fail(*a, **kw):
            raise RuntimeError("planted")
        broken.search_by_vectors_async = fail
        reply = s.sv.BatchSearch(_batch(q), _Ctx())
        reply = pb.BatchSearchReply.FromString(reply) if isinstance(reply, bytes) else reply
        assert s.sv.raw_lane_batches == 0
        got = _answers(reply)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        # the dispatches enqueued before the failure were finalized
        assert [s.idx.shards[n].vector_index._inflight for n in names] == [0, 0, 0, 0]
    finally:
        s.close()


def _ids_for(idx, shard_name, count, start):
    """`count` object numbers from `start` on whose ids route to the shard."""
    out, i = [], start
    while len(out) < count:
        if idx.shard_for(_uid(i)) == shard_name:
            out.append(i)
        i += 1
    return out


def test_short_shards_merge_to_k_and_ties_keep_shard_order(tmp_path):
    """Shard 0 holds 4 rows, fewer than k; a row of shard 1 and a row of
    shard 0 hold the same vector, shard 1's with the smaller doc number:
    the pair comes back shard 0's first, as the general path's stable
    merge orders it."""
    probe = Served(tmp_path / "probe", 2, "l2-squared", _gauss(1, 0))
    names = probe.idx.sharding_state.all_physical_shards()
    ring = probe.idx
    few = _ids_for(ring, names[0], 4, 10)
    many = _ids_for(ring, names[1], 800, 10)
    probe.close()
    x = _gauss(len(few) + len(many), 11)
    x[0] = x[len(few)]  # shard 0's first row = shard 1's first row
    s = Served(tmp_path / "served", 2, "l2-squared", x, ids=few + many)
    try:
        assert s.idx.sharding_state.all_physical_shards() == names
        assert [s.idx.shards[n].object_count() for n in names] == [4, 800]
        q = _gauss(B, 12)
        q[0] = x[0] + 0.01
        raw_ids, raw_d = _answers(s.raw(q))
        gen_ids, gen_d = _answers(s.general(q))
        assert raw_ids.shape == (B, K)
        assert np.array_equal(raw_ids, gen_ids)
        assert np.array_equal(raw_d.view(np.uint32), gen_d.view(np.uint32))
        assert raw_d[0, 0] == raw_d[0, 1]
        assert raw_ids[0, :2].tolist() == [few[0], many[0]]
        jax = JaxServed(tmp_path / "jax", s)
        try:
            _same_as_jax((raw_ids, raw_d), jax.reply(q))
        finally:
            jax.close()
        ref_rows, ref_d = scatter_reference.scatter_gather(q, x, s.part(), K, "l2-squared")
        assert np.array_equal(raw_ids, np.array(few + many)[ref_rows])
        np.testing.assert_allclose(raw_d, ref_d, rtol=1e-5, atol=0)
    finally:
        s.close()


def test_the_lane_traces_scatter_merge_and_gather(tmp_path):
    s = Served(tmp_path, 4, "l2-squared", _gauss(1600, 13), traced=True)
    try:
        tracer = tracing.get_tracer()
        before = len(tracer.snapshot())
        s.sv.BatchSearch(_batch(_gauss(B, 14)), _Ctx())
        assert s.sv.raw_lane_batches == 1
        (tr,) = [t for t in tracer.snapshot()[before:] if t["name"] == "BatchSearch"]
        root = tr["root"]
        assert [c["name"] for c in root["children"]] == [
            "grpc.parse", "class.scatter", "class.merge", "class.gather", "grpc.reply"]
        assert root["attrs"]["shards"] == 4
        assert 4 * K <= root["attrs"]["merge_candidates"] <= 4 * K * B
        (scatter,) = [c for c in root["children"] if c["name"] == "class.scatter"]
        disp = scatter["children"]
        assert [d["name"] for d in disp] == ["dispatch"] * 4
        assert [d["attrs"]["shard"] for d in disp] == s.idx.sharding_state.all_physical_shards()
        for d in disp:
            assert [c["name"] for c in d["children"]] == ["device_search"]
            assert d["attrs"]["graph"] == "eager"
            steps = [c["name"] for c in d["children"][0]["children"]]
            assert steps == ["index.snapshot", "index.stage", "index.enqueue", "index.fetch"]
        for span in root["children"]:
            assert span["duration_ms"] >= 0.0 and "cpu_ms" in span
    finally:
        s.close()


def test_merge_orders_by_distance_then_shard_then_rank():
    inf = np.float32(np.inf)
    parts = [(np.array([[5, 6, 7]], np.uint64), np.array([[1.0, 2.0, inf]], np.float32)),
             (np.array([[8]], np.uint64), np.array([[1.0]], np.float32)),
             (np.zeros((1, 0), np.uint64), np.zeros((1, 0), np.float32)),
             (np.array([[9, 10]], np.uint64), np.array([[0.5, 2.0]], np.float32))]
    ids, d, src = _merge_shard_arrays(parts, 5)
    assert ids.tolist() == [[9, 5, 8, 6, 10]]
    assert d.tolist() == [[0.5, 1.0, 1.0, 2.0, 2.0]]
    assert src.tolist() == [[3, 0, 1, 0, 3]]
    ids, d, src = _merge_shard_arrays(parts[:2], 10)
    assert ids.tolist() == [[5, 8, 6, 7]] and d[0, -1] == inf


@pytest.mark.parametrize("uniform", [True, False])
def test_reorder_arena_moves_every_value_whole(uniform):
    rng = np.random.default_rng(3)
    n = 50
    lens = np.full(n, 9) if uniform else rng.integers(0, 20, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    buf = rng.integers(0, 256, offs[-1]).astype(np.uint8)
    perm = rng.permutation(n)
    out, out_offs = _reorder_arena(buf, offs, perm)
    for j, i in enumerate(perm):
        assert out[out_offs[j]:out_offs[j + 1]].tobytes() == buf[offs[i]:offs[i + 1]].tobytes()
    assert out_offs[-1] == offs[-1] == len(out)


def test_a_shard_without_a_winner_in_the_batch(tmp_path):
    """Shard 1's rows lie far from every query: the gather asks it for no
    row, and the replies are shard 0's alone."""
    probe = Served(tmp_path / "probe", 2, "l2-squared", _gauss(1, 0))
    names = probe.idx.sharding_state.all_physical_shards()
    near = _ids_for(probe.idx, names[0], 300, 0)
    far = _ids_for(probe.idx, names[1], 300, 0)
    probe.close()
    x = _gauss(600, 15)
    x[300:] += 100.0
    s = Served(tmp_path / "served", 2, "l2-squared", x, ids=near + far)
    try:
        q = _gauss(B, 16)
        raw_ids, raw_d = _answers(s.raw(q))
        gen_ids, gen_d = _answers(s.general(q))
        assert np.isin(raw_ids, near).all()
        assert np.array_equal(raw_ids, gen_ids)
        assert np.array_equal(raw_d.view(np.uint32), gen_d.view(np.uint32))
    finally:
        s.close()
