"""The port's native point-get plane (weaviate_tpu_torch/csrc/lsm_get.cpp:
one hash probe a segment, an arena sized before the copy) against the JAX
package's (native/lsm_get.cpp: a binary search a segment, a guessed arena
and a retry): on the same segment files, written by the port's Bucket, the
packed multi-get gives the same arena, offsets and flags byte for byte.
Covers keys of mixed lengths whose probe chains collide, keys in several
segments, newer tombstones, missing and zero-length keys, values past the
old arena's 1,024 bytes a key, a corrupt segment that falls back to the
Python reader, and the trace facts the raw lane records.
"""

import contextlib
import os
import signal
import sys
import threading

import numpy as np
import pytest

from weaviate_tpu.storage import lsm as jax_lsm
from weaviate_tpu.storage import lsm_native as jax_native
from weaviate_tpu_torch.config import load_config
from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
from weaviate_tpu_torch.monitoring import profiling, tracing
from weaviate_tpu_torch.server import App
from weaviate_tpu_torch.server.grpc_server import SearchServicer
from weaviate_tpu_torch.storage import lsm_native
from weaviate_tpu_torch.storage.lsm import STRATEGY_REPLACE, Bucket

pytestmark = pytest.mark.skipif(
    not (lsm_native.available() and jax_native.available()),
    reason="a native lsm plane is unavailable")

N_KEYS = 13_100


def _keys(rng):
    """N_KEYS distinct keys of 1 to 40 bytes; every tenth is the one
    before it with a byte appended, so keys are prefixes of others."""
    keys = []
    for i in range(N_KEYS):
        if i % 10 == 9:
            keys.append(keys[-1] + b"\x00")
        else:
            keys.append(i.to_bytes(3, "little") + rng.bytes(int(rng.integers(0, 38))))
    assert len(set(keys)) == N_KEYS
    return keys


def _value(rng, large: bool) -> bytes:
    n = int(rng.integers(1025, 3000)) if large else int(rng.integers(0, 65))
    return rng.bytes(n)


def _fill(path, rng, large: bool):
    """A port Bucket of four segments: first puts, then overwrites and
    tombstones, then new keys, puts after a tombstone and tombstones over
    overwrites, then zero-length values. -> (bucket, keys, model)."""
    keys = _keys(rng)
    b = Bucket(str(path), STRATEGY_REPLACE, memtable_max_bytes=1 << 30)
    model = {}

    def put(i, v):
        b.put(keys[i], v)
        model[keys[i]] = v

    def delete(i):
        b.delete(keys[i])
        model.pop(keys[i], None)

    for i in range(12_000):
        put(i, _value(rng, large))
    b.flush_memtable()
    for i in range(3_000):
        put(i, _value(rng, large))
    for i in range(3_000, 4_000):
        delete(i)
    b.flush_memtable()
    for i in range(12_000, 13_000):
        put(i, _value(rng, large))
    for i in range(3_500, 3_600):
        put(i, _value(rng, large))
    for i in range(500):
        delete(i)
    b.flush_memtable()
    for i in range(1_000, 1_100):
        put(i, b"")
    for i in range(13_000, N_KEYS):
        put(i, _value(rng, large))
    b.flush_memtable()
    assert b.segment_count() == 4 and not len(b._mem)
    return b, keys, model


def _probe(rng, keys):
    """Every key, missing keys, zero-length keys and repeats, shuffled."""
    probe = list(keys) + [b"missing-%d" % i for i in range(500)] + [b""] * 50
    probe += [keys[int(i)] for i in rng.integers(0, len(keys), 500)]
    return [probe[int(i)] for i in rng.permutation(len(probe))]


def _packed_keys(probe):
    offs = np.zeros(len(probe) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in probe], out=offs[1:])
    return b"".join(probe), offs


@contextlib.contextmanager
def _jax_segments(bucket):
    """The bucket's segment files, newest first, opened by the JAX
    package's Segment (each package caches its own handles on its
    segments)."""
    segs = [jax_lsm.Segment(s.path) for s in reversed(bucket._segments)]
    try:
        yield segs
    finally:
        for s in segs:
            s.close()


@pytest.mark.parametrize("large", [False, True], ids=["small", "over_1024"])
def test_packed_multi_get_equals_the_jax_plane_byte_for_byte(tmp_path, large):
    rng = np.random.default_rng(22 + large)
    b, keys, model = _fill(tmp_path / "b", rng, large)
    try:
        probe = _probe(rng, keys)
        key_buf, key_offs = _packed_keys(probe)
        stats = lsm_native.new_stats()
        got = b.multi_get_packed(key_buf, key_offs, stats=stats)
        with _jax_segments(b) as segs:
            ref = jax_native.multi_get_packed(segs, key_buf, key_offs)
        assert got is not None and ref is not None
        (arena, offs, flags), (r_arena, r_offs, r_flags) = got, ref
        assert np.array_equal(offs, r_offs) and np.array_equal(flags, r_flags)
        assert arena.tobytes() == r_arena[: r_offs[-1]].tobytes()
        # the arena holds exactly the found values
        assert arena.size == offs[-1]
        for i, k in enumerate(probe):
            want = model.get(k) if k else None
            assert bool(flags[i]) == (want is not None), k
            assert arena[offs[i]:offs[i + 1]].tobytes() == (want or b"")
        if large:
            assert offs[-1] > 1024 * len(probe)  # the old guess would overflow
        searched, probes, fills, calls = stats.tolist()
        assert fills == calls == 1
        assert lsm_native.trace_facts(stats)["lsm_arena_passes"] == 1
        # chains collide (some searches touch more than one slot), and a
        # search still touches under two slots on the mean
        assert probes > searched >= len(probe) - 50
        assert 1.0 < lsm_native.trace_facts(stats)["lsm_probes_per_key"] < 2.0
    finally:
        b.shutdown()


def test_a_get_through_two_buckets_equals_the_jax_planes_two_gets(tmp_path):
    """The shard's hydration in one call (doc id -> uuid -> image): the
    same arena, offsets and flags as the JAX plane's two chained calls,
    with doc ids missing, tombstoned or naming a zero-length or a deleted
    uuid."""
    rng = np.random.default_rng(17)
    objects, uuids, model = _fill(tmp_path / "objects", rng, True)
    docids = Bucket(str(tmp_path / "docids"), STRATEGY_REPLACE)
    n = 6_000
    try:
        for i in range(n):
            docids.put(i.to_bytes(8, "little"), uuids[(7 * i) % len(uuids)])
        docids.flush_memtable()
        for i in range(0, n, 13):
            docids.delete(i.to_bytes(8, "little"))
        for i in range(1, n, 29):
            docids.put(i.to_bytes(8, "little"), b"")
        docids.flush_memtable()
        ids = rng.integers(0, n + 300, 5_000).astype("<u8")
        key_offs = np.arange(ids.size + 1, dtype=np.int64) * 8
        stats = lsm_native.new_stats()
        arena, offs, flags = docids.multi_get_packed(ids.tobytes(), key_offs,
                                                      then=objects, stats=stats)
        assert stats[2:].tolist() == [1, 1]
        with _jax_segments(docids) as d_segs, _jax_segments(objects) as o_segs:
            ubuf, uoffs, _ = jax_native.multi_get_packed(d_segs, ids.tobytes(), key_offs)
            r_arena, r_offs, r_flags = jax_native.multi_get_packed(o_segs, ubuf, uoffs)
        assert np.array_equal(offs, r_offs) and np.array_equal(flags, r_flags)
        assert arena.tobytes() == r_arena[: r_offs[-1]].tobytes()
        assert 0 < flags.sum() < ids.size
        # the second bucket unfit for the packed plane (a memtable): None
        objects.put(b"fresh", b"v")
        assert docids.multi_get_packed(ids.tobytes(), key_offs, then=objects) is None
        assert docids._native_inflight == objects._native_inflight == 0
    finally:
        docids.shutdown()
        objects.shutdown()


def test_the_list_multi_get_equals_the_jax_plane(tmp_path):
    """Bucket.multi_get (the general path's hydration) rides the packed
    plane: the same values as the JAX plane and the model, None keys
    kept."""
    rng = np.random.default_rng(5)
    b, keys, model = _fill(tmp_path / "b", rng, False)
    try:
        probe = _probe(rng, keys)[:4000] + [None]
        got = b.multi_get(probe)
        want = [model.get(k) if k else None for k in probe]
        assert got == want
        with _jax_segments(b) as segs:
            assert jax_native.multi_get(segs, probe) == want
    finally:
        b.shutdown()


def test_a_corrupt_segment_falls_back_to_the_python_reader(tmp_path):
    """A footer that points past the file: neither plane opens the
    segment, the packed get says so (None), and the list get serves from
    the Python reader, exactly."""
    rng = np.random.default_rng(9)
    b, keys, model = _fill(tmp_path / "b", rng, False)
    try:
        newest = b._segments[-1]
        assert getattr(newest, "_native_handle", None) is None
        probe = _probe(rng, keys)[:2000]
        key_buf, key_offs = _packed_keys(probe)
        # both packages' readers parse the footer at open; the native
        # planes parse it again at their first use, after the corruption
        with _jax_segments(b) as segs:
            with open(newest.path, "r+b") as f:
                f.seek(-8, os.SEEK_END)
                f.write((1 << 62).to_bytes(8, "little"))
            assert jax_native.multi_get_packed(segs, key_buf, key_offs) is None
        assert b.multi_get_packed(key_buf, key_offs) is None
        assert newest._native_handle == 0
        assert b.multi_get(probe) == [model.get(k) if k else None for k in probe]
    finally:
        b.shutdown()


def test_concurrent_gets_during_compaction_read_every_value(tmp_path):
    """Eight threads get the same keys while the bucket's segments are
    merged under them (retired, then closed once no get is in flight):
    every arena holds the model's values, and each thread's counts hold
    its own calls only."""
    rng = np.random.default_rng(11)
    b, keys, model = _fill(tmp_path / "b", rng, True)
    probe = _probe(rng, keys)[:3000]
    key_buf, key_offs = _packed_keys(probe)
    want = [model.get(k) if k else None for k in probe]
    calls, errors = [], []

    def getter():
        try:
            stats = lsm_native.new_stats()
            for _ in range(6):
                arena, offs, flags = b.multi_get_packed(key_buf, key_offs, stats=stats)
                assert [arena[offs[i]:offs[i + 1]].tobytes() if flags[i] else None
                        for i in range(len(probe))] == want
            calls.append(stats[2:].tolist())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=getter) for _ in range(8)]
        for th in threads:
            th.start()
        while b.compact_pair():
            pass
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
        b.shutdown()
    assert not errors, errors
    assert calls == [[6, 6]] * 8


def test_an_empty_batch_a_batch_of_misses_and_bad_offsets(tmp_path):
    rng = np.random.default_rng(3)
    b, _, _ = _fill(tmp_path / "b", rng, False)
    try:
        stats = lsm_native.new_stats()
        arena, offs, flags = b.multi_get_packed(b"", np.zeros(1, dtype=np.int64),
                                                stats=stats)
        assert arena.size == 0 and offs.tolist() == [0] and flags.size == 0
        key_buf, key_offs = _packed_keys([b"nope", b"", b"nix"])
        arena, offs, flags = b.multi_get_packed(key_buf, key_offs, stats=stats)
        assert arena.size == 0 and offs.tolist() == [0, 0, 0, 0] and flags.tolist() == [0, 0, 0]
        # two calls, no arena filled: no value was found to copy
        assert stats[2:].tolist() == [0, 2]
        assert lsm_native.trace_facts(stats)["lsm_arena_passes"] == 0
        assert lsm_native.trace_facts(lsm_native.new_stats()) == {}
        for bad in ([0, 5, 3, 7], [0, 4, 8]):  # falling; past the buffer
            with pytest.raises(ValueError):
                b.multi_get_packed(key_buf, np.array(bad, dtype=np.int64))
        assert b._native_inflight == 0
    finally:
        b.shutdown()


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


D = 256  # an object image of 1,024 vector bytes and its header: past 1,024 B


def _app(path, shards):
    app = App(config=load_config({"TRACING_ENABLED": "true"}), data_path=str(path),
              device="cpu")
    app.schema.add_class({"class": "Doc", "vectorIndexType": "hnsw_tpu",
                          "vectorIndexConfig": {"distance": "cosine"},
                          "shardingConfig": {"desiredCount": shards}})
    x = np.random.default_rng(shards).standard_normal((600, D)).astype(np.float32)
    objs = [{"class": "Doc", "id": f"00000000-0000-0000-0000-{i + 1:012d}", "vector": v}
            for i, v in enumerate(x)]
    assert all(r.err is None for r in app.batch.add_objects(objs))
    for shard in app.db.get_index("Doc").shards.values():
        shard.flush()
        shard.store.flush_memtables()
    q = np.random.default_rng(7).standard_normal((16, D)).astype(np.float32)
    req = pb.BatchSearchRequest(requests=[pb.SearchRequest(
        class_name="Doc", limit=10, near_vector=pb.NearVectorParams(vector=v.tolist()))
        for v in q])
    return app, req


def _lsm_facts(span):
    return {k: v for k, v in span["attrs"].items() if k.startswith("lsm_")}


@pytest.mark.parametrize("shards", [1, 3])
def test_the_raw_lane_records_the_point_gets_facts(tmp_path, shards):
    """One shard: the facts sit on the dispatch whose `hydrate` phase ran
    the point-gets. Several: on `class.gather`, over all shards' gets."""
    app, req = _app(tmp_path, shards)
    try:
        sv = SearchServicer(app)
        tracer = tracing.get_tracer()
        before = len(tracer.snapshot())
        sv.BatchSearch(req, _Ctx())
        assert sv.raw_lane_batches == 1
        (tr,) = [t for t in tracer.snapshot()[before:] if t["name"] == "BatchSearch"]
        kids = {c["name"]: c for c in tr["root"]["children"]}
        if shards == 1:
            span = kids["dispatch"]
            assert [c["name"] for c in span["children"]] == ["device_search", "hydrate"]
        else:
            span = kids["class.gather"]
            for d in kids["class.scatter"]["children"]:
                assert not _lsm_facts(d)  # a scattered dispatch hydrates nothing
        facts = _lsm_facts(span)
        assert set(facts) == {"lsm_probes_per_key", "lsm_arena_passes"}
        assert facts["lsm_arena_passes"] == 1
        assert 1.0 <= facts["lsm_probes_per_key"] < 2.0
    finally:
        app.shutdown()
