"""The port's mesh index (weaviate_tpu_torch/index/mesh.py over
parallel/mesh_search.py) against the JAX package's (weaviate_tpu/index/
mesh.py) on the same inputs, on the CPU: the JAX mesh on the 8 virtual
host devices (tests/conftest.py), with K1 and K2 in Pallas interpret mode;
the port's over `make_mesh(8, device="cpu")`, its kernel wrappers taking
their plain versions.

Held: placement (counts, slab size, slot->doc) after the same writes;
every search tier (the chunked scan, K1 over an f32 and a bf16 store, K2,
the reconstruction scan with and without its rescore, the 4-bit funnel
with OPQ, IVF), each with tombstones and an allowList, fused and staged,
l2, dot and cosine; the kernels' shape rules; the durability replay onto
another slab count, in both directions; compaction, health and the host
fallback plane. The tiers' own parity is tests/test_torch_mesh_tiers.py.

Data is gaussian (tie-free: `torch.topk` orders ties unlike `lax.top_k`).
Tolerances: ids exact; distances rtol 1e-5, atol 1e-5 (f32 arithmetic in
another summation order; atol for distances near 0), atol 1e-4 over a
bf16 store or codes (the same bf16 or ADC operands summed in another
order).
"""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import tpu
from weaviate_tpu.index.mesh import MeshVectorIndex as JMesh
from weaviate_tpu.ops import gmin_scan as jgmin
from weaviate_tpu.parallel.mesh_search import make_mesh as jmake_mesh
from weaviate_tpu.storage.bitmap import Bitmap as JBitmap
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.index import gpu
from weaviate_tpu_torch.index.gpu import GpuVectorIndex
from weaviate_tpu_torch.index.mesh import MeshVectorIndex as TMesh
from weaviate_tpu_torch.parallel.mesh_search import make_mesh
from weaviate_tpu_torch.storage.bitmap import Bitmap as TBitmap

DIM = 16
METRICS = ("l2-squared", "dot", "cosine")


@pytest.fixture(autouse=True)
def _reset_globals():
    yield
    gpu.set_ivf_config(None)
    gpu.set_fused_enabled(None)
    tpu.set_ivf_config(None)
    tpu.set_fused_enabled(None)


def _vecs(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _configs(conf):
    return (jvi.parse_and_validate_config("hnsw_tpu_mesh", dict(conf)),
            tvi.parse_and_validate_config("hnsw_tpu_mesh", dict(conf)))


def _pair(tmp_path, conf, loc=64, persist=False):
    """A JAX mesh index and the port's on 8 CPU slabs, each in its own
    directory."""
    jc, tc = _configs(conf)
    for sub in ("j", "t"):
        (tmp_path / sub).mkdir(parents=True, exist_ok=True)
    j = JMesh(jc, str(tmp_path / "j"), persist=persist, initial_capacity_per_shard=loc)
    t = TMesh(tc, str(tmp_path / "t"), device="cpu", persist=persist,
              initial_capacity_per_shard=loc)
    return j, t


def _reopen(tmp_path, src, conf, loc, n_dev=None):
    """Both packages restarted on copies of the shard directory `src`."""
    jc, tc = _configs(conf)
    shutil.copytree(src, tmp_path / "rj")
    shutil.copytree(src, tmp_path / "rt")
    j = JMesh(jc, str(tmp_path / "rj"), initial_capacity_per_shard=loc,
              mesh=jmake_mesh(n_dev) if n_dev else None)
    t = TMesh(tc, str(tmp_path / "rt"), device="cpu", initial_capacity_per_shard=loc,
              mesh=make_mesh(n_dev, device="cpu") if n_dev else None)
    return j, t


def _apply(idxs, fn):
    for idx in idxs:
        fn(idx)


def _same(j, t, q, k, allow_ids=None, atol=1e-5):
    """Both indexes answer q alike, fused and staged: ids exact, distances
    rtol 1e-5 (atol as given)."""
    for fused in (True, False):
        tpu.set_fused_enabled(fused)
        gpu.set_fused_enabled(fused)
        ja = JBitmap(allow_ids) if allow_ids is not None else None
        ta = TBitmap(allow_ids) if allow_ids is not None else None
        ji, jd = j.search_by_vectors(q, k, ja)
        ti, td = t.search_by_vectors(q, k, ta)
        assert ti.dtype == np.uint64 and ti.shape == ji.shape, (ti.shape, ji.shape)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=atol)
    tpu.set_fused_enabled(None)
    gpu.set_fused_enabled(None)
    return ti, td


def _mutate_and_compare(j, t, vecs, q, k, atol=1e-5):
    """The shared read matrix: unfiltered, tombstones, an allowList of
    every third doc over the tombstones."""
    _same(j, t, q, k, atol=atol)
    dead = list(range(0, len(vecs), 7))[:40]
    _apply((j, t), lambda x: x.delete(*dead))
    _same(j, t, q, k, atol=atol)
    _same(j, t, q, k, allow_ids=list(range(0, len(vecs), 3)), atol=atol)


def _queries(vecs, b, seed=9):
    rng = np.random.default_rng(seed)
    return vecs[rng.choice(len(vecs), b, replace=False)] + 0.1 * _vecs(b, seed + 1,
                                                                         vecs.shape[1])


# -- placement -----------------------------------------------------------------

def test_make_mesh_counts_and_names():
    assert make_mesh(device="cpu") == [torch.device("cpu")] * 8
    assert make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert make_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        make_mesh(devices=[])


def test_mesh_search_plan_facade_matches_the_jax_one():
    """MeshSearchPlan, the standalone facade (balanced placement, no
    durability, int64 ids), answers as the JAX package's."""
    from weaviate_tpu.parallel.mesh_search import MeshSearchPlan as JPlan
    from weaviate_tpu_torch.parallel import MeshSearchPlan

    vecs, q = _vecs(300, seed=13), _vecs(4, seed=14)
    jp, tp = JPlan(jmake_mesh(), DIM, capacity_per_shard=64), MeshSearchPlan(
        make_mesh(device="cpu"), DIM, capacity_per_shard=64)
    for p in (jp, tp):
        p.add_batch(np.arange(300), vecs)
    (ji, jd), (ti, td) = jp.search(q, 64), tp.search(q, 64)
    assert ti.dtype == np.int64
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan", ["uneven", "growth", "delete_then_grow"])
def test_placement_matches(tmp_path, plan):
    """After the same writes both packages hold the same per-slab counts,
    slab size and global slot->doc map (level-fill placement, doubling)."""
    j, t = _pair(tmp_path, {"distance": "l2-squared"}, loc=64)
    vecs = _vecs(1400, seed=1)
    steps = {"uneven": [(0, 100), (100, 137), (137, 138), (138, 400)],
             "growth": [(0, 300), (300, 1400)],
             "delete_then_grow": [(0, 500), "del", (500, 1400), (1400, 1400)]}[plan]
    for st in steps:
        if st == "del":
            _apply((j, t), lambda x: x.delete(*range(0, 500, 3)))
            continue
        a, b = st
        if b > a:
            _apply((j, t), lambda x: x.add_batch(np.arange(a, b), vecs[a:b]))
    _apply((j, t), lambda x: x.add(5000, vecs[7]))  # a staged single
    _apply((j, t), lambda x: x.flush())
    np.testing.assert_array_equal(t._counts, j._counts)
    assert t.n_loc == j.n_loc and t.live == j.live
    np.testing.assert_array_equal(t._slot_to_doc, j._slot_to_doc)
    np.testing.assert_array_equal(t._host_tombs, j._host_tombs)
    _same(j, t, _queries(vecs, 4), 10)


# -- every search tier ---------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS + ("manhattan",))
def test_chunked_scan_matches(tmp_path, metric):
    """Slabs under 16384 rows (and manhattan always) take the chunked
    scan; k past one slab's live rows merges every slab's candidates."""
    j, t = _pair(tmp_path, {"distance": metric}, loc=64)
    vecs = _vecs(400, seed=2)
    _apply((j, t), lambda x: x.add_batch(np.arange(150), vecs[:150]))
    _apply((j, t), lambda x: x.add_batch(np.arange(150, 400), vecs[150:]))
    assert t._gmin_plan(16, 10, t._read_snapshot()) is None
    q = _queries(vecs, 16)
    _mutate_and_compare(j, t, vecs, q, 60)  # 60 > the 50 live rows of a slab
    _same(j, t, q[:3], 5)


# -- the kernels' shape rules ----------------------------------------------------

def _gate_snap(n_loc, dim, counts_max, itemsize):
    return SimpleNamespace(n_loc=n_loc, dim=dim, counts=np.array([counts_max]),
                           store=SimpleNamespace(dtype=np.dtype(f"f{itemsize}")))


# (b, kk, n_loc, dim, live rows of the fullest slab, store bytes) -> the
# port's K1 gate where it differs from the reference's (`fits_vmem` refuses
# an f32 store of D 768 at 16 live slices, the resident plan holds a bf16
# tile whatever the store's type: the D ~722-6208 band of ROADMAP's routing
# note); everywhere else the two gates agree
_K1_SHAPES = [
    ((16, 10, 16384, 128, 16384, 4), None),      # both open
    ((16, 10, 16384, 128, 1000, 2), None),       # both open, one live slice
    ((4, 10, 16384, 128, 16384, 4), None),       # B < 8: both closed
    ((16, 10, 8192, 128, 8192, 4), None),        # n_loc < 16384: both closed
    ((16, 200, 16384, 128, 16384, 4), None),     # rg < k: both closed
    ((16, 10, 16384, 768, 16384, 4), (32, 16)),  # the band: the port opens
    ((16, 10, 16384, 6272, 16384, 4), None),     # past D 6208: both closed
]


@pytest.mark.parametrize("shape,port_only", _K1_SHAPES)
def test_k1_gate_against_the_reference(shape, port_only):
    b, kk, n_loc, dim, cmax, isz = shape
    conf = {"distance": "l2-squared"}
    j = JMesh(_configs(conf)[0], "", persist=False)
    t = TMesh(_configs(conf)[1], "", device="cpu", persist=False)
    snap = _gate_snap(n_loc, dim, cmax, isz)
    want, got = j._gmin_plan(b, kk, snap), t._gmin_plan(b, kk, snap)
    if port_only is None:
        assert got == want
    else:
        assert want is None and got == port_only
        assert not jgmin.fits_vmem(b, dim, n_loc // 16, 16, isz)


_K2_SHAPES = [
    ((16, 10, 1024, 16, 8, 32), True),     # both open
    ((4, 10, 1024, 16, 8, 32), True),      # B < 8: both closed
    ((16, 10, 512, 16, 8, 32), True),      # 32 group columns: both closed
    ((16, 10, 1024, 16, 8, 512), True),    # C > 256: both closed
    ((16, 10, 16384, 768, 96, 256), False),  # the band (B2's shape): the port opens
    ((16, 10, 16384, 6272, 784, 256), True),  # past D 6208: both closed
]


@pytest.mark.parametrize("shape,agree", _K2_SHAPES)
def test_k2_gate_against_the_reference(shape, agree):
    from weaviate_tpu.ops import pq_gmin as jpq_gmin

    b, kk, n_loc, dim, m, c = shape
    pq = SimpleNamespace(segments=m, centroids=c)
    ncols = n_loc // 16
    want = jpq_gmin.eligible_rg(jgmin.KernelState(), False, "dot", pq, b, ncols, kk, dim, 16)
    t = TMesh(_configs({"distance": "dot"})[1], "", device="cpu", persist=False)
    got = t._pq_gmin_rg(SimpleNamespace(n_loc=n_loc, counts=np.array([n_loc]), pq=pq,
                                        dim=dim), b, kk)
    if agree:
        assert (got[0] if got else None) == want
    else:
        assert want is None and got == (32, 16)


# -- the index as a whole ------------------------------------------------------

def test_replay_onto_another_slab_count_both_ways(tmp_path):
    """A log the port's mesh wrote restores in the JAX mesh and in the
    port's, each onto 3 slabs (the replay re-balances), and the reverse:
    a JAX-written log restores in the port; deletes, re-adds and in-run
    duplicates replay exactly."""
    conf = {"distance": "l2-squared"}
    vecs = _vecs(1500, seed=6)
    for writer in ("torch", "jax"):
        base = tmp_path / writer
        jc, tc = _configs(conf)
        (base / "w").mkdir(parents=True)
        w = (TMesh(tc, str(base / "w"), device="cpu", initial_capacity_per_shard=1024)
             if writer == "torch" else JMesh(jc, str(base / "w"),
                                             initial_capacity_per_shard=1024))
        w.add_batch(np.arange(1500), vecs)
        w.delete(*range(0, 50, 2))
        w.add_batch(np.arange(10), vecs[500:510])
        w.add_batch(np.array([7, 7, 7]), vecs[600:603])
        w.flush()
        q = _queries(vecs, 8)
        want_ids, want_d = w.search_by_vectors(q, 5)
        w.shutdown()
        j, t = _reopen(base, base / "w", conf, 1024, n_dev=3)
        assert t.n_dev == 3 and j.n_dev == 3 and t.live == w.live
        np.testing.assert_array_equal(t._counts, j._counts)
        np.testing.assert_array_equal(t._slot_to_doc, j._slot_to_doc)
        ti, td = _same(j, t, q, 5)
        np.testing.assert_array_equal(ti, want_ids)
        np.testing.assert_allclose(td, want_d, rtol=1e-5, atol=1e-5)
        assert t.search_by_vector(vecs[602], 1)[0][0] == 7


def test_single_device_shard_opens_as_a_mesh(tmp_path):
    """A single-device index's directory (vector.log, pq.npz) opens as a
    mesh of the same answers: the formats are placement-independent."""
    conf = {"distance": "dot", "pq": {"enabled": True, "segments": 8, "centroids": 32,
                                      "rescore": False}}
    vecs = _vecs(2000, seed=7)
    one = GpuVectorIndex(tvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path),
                         device="cpu")
    one.add_batch(np.arange(2000), vecs)
    assert one.compressed
    q = _queries(vecs, 16)
    one_ids, one_d = one.search_by_vectors(q[:4], 5)  # B < 8: exact ADC on both
    one.shutdown()
    mesh = TMesh(tvi.parse_and_validate_config("hnsw_tpu_mesh", conf), str(tmp_path),
                 device="cpu", initial_capacity_per_shard=1024)
    assert mesh.compressed and mesh.live == 2000
    np.testing.assert_array_equal(mesh._pq.codebook, one._pq.codebook)
    ids, d = mesh.search_by_vectors(q[:4], 5)
    np.testing.assert_array_equal(ids, one_ids)
    np.testing.assert_allclose(d, one_d, rtol=1e-5, atol=1e-4)


def test_compact_health_and_host_plane_match(tmp_path):
    """compact() drops tombstoned rows on both sides alike (placement and
    answers), health() carries the same keys and numbers, and the breaker's
    host plane answers as the JAX mesh's."""
    j, t = _pair(tmp_path, {"distance": "l2-squared"}, loc=64, persist=True)
    vecs = _vecs(700, seed=8)
    _apply((j, t), lambda x: x.add_batch(np.arange(700), vecs))
    _apply((j, t), lambda x: x.delete(*range(0, 700, 4)))
    q = _queries(vecs, 6)
    _same(j, t, q, 10)
    hj, ht = j.health(), t.health()
    assert set(hj) == set(ht)
    for key in ("dim", "devices", "rows_per_device", "capacity", "slots", "live",
                "tombstones", "tombstone_fraction", "compressed"):
        assert ht[key] == hj[key], key
    assert [d["rows"] for d in ht["per_device"]] == [d["rows"] for d in hj["per_device"]]
    hi_j, hd_j = j.search_by_vectors_host(q, 10, JBitmap(list(range(0, 700, 3))))
    hi_t, hd_t = t.search_by_vectors_host(q, 10, TBitmap(list(range(0, 700, 3))))
    np.testing.assert_array_equal(hi_t, hi_j)
    np.testing.assert_allclose(hd_t, hd_j, rtol=1e-5, atol=1e-5)
    assert t.health()["host_fallback_cache"]["resident"]
    t.release_host_fallback_cache()
    _apply((j, t), lambda x: x.compact())
    assert t.live == j.live == 525 and t.n_loc == j.n_loc
    np.testing.assert_array_equal(t._counts, j._counts)
    np.testing.assert_array_equal(t._slot_to_doc, j._slot_to_doc)
    _same(j, t, q, 10)
    assert t.list_files() and t.health()["tombstones"] == 0


def test_pq_restart_and_compact_keep_f32_rows(tmp_path):
    """Under PQ, compact() rewrites the log from the f32 host rows (not the
    bf16 store); a restart re-enters compressed mode from pq.npz and
    answers as before."""
    conf = {"distance": "l2-squared", "pq": {"enabled": True, "segments": 4, "centroids": 16}}
    t = TMesh(tvi.parse_and_validate_config("hnsw_tpu_mesh", conf), str(tmp_path),
              device="cpu", initial_capacity_per_shard=64)
    vecs = _vecs(400, seed=10)
    t.add_batch(np.arange(400), vecs)
    t.flush()
    assert t.compressed and t._store[0].dtype == torch.bfloat16
    t.delete(0, 1)
    t.compact()
    q = _queries(vecs, 8)
    ids, d = t.search_by_vectors(q, 5)
    t.shutdown()
    got = {doc: vec for op, doc, vec in gpu.VectorLog.replay(str(tmp_path / "vector.log"))
           if op == "add"}
    np.testing.assert_array_equal(got[42], vecs[42])
    assert 0 not in got and 1 not in got
    t2 = TMesh(tvi.parse_and_validate_config("hnsw_tpu_mesh", conf), str(tmp_path),
               device="cpu", initial_capacity_per_shard=64)
    assert t2.compressed and t2.live == 398
    ids2, d2 = t2.search_by_vectors(q, 5)
    np.testing.assert_array_equal(ids2, ids)
    np.testing.assert_allclose(d2, d, rtol=1e-5, atol=1e-5)


def test_manhattan_refuses_pq_and_keeps_serving(tmp_path):
    t = TMesh(tvi.parse_and_validate_config("hnsw_tpu_mesh", {"distance": "manhattan"}),
              str(tmp_path), device="cpu", initial_capacity_per_shard=64)
    vecs = _vecs(300, seed=11)
    t.add_batch(np.arange(300), vecs)
    with pytest.raises(tvi.ConfigValidationError):
        t.update_user_config(tvi.parse_and_validate_config(
            "hnsw_tpu_mesh", {"distance": "manhattan", "pq": {"enabled": True, "segments": 4}}))
    assert not t.config.pq.enabled
    t.add_batch(np.arange(300, 320), _vecs(20, seed=12))
    assert t.search_by_vectors(vecs[:1], 5)[0][0][0] == 0


def test_entry_point_needs_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    """new_vector_index builds hnsw_tpu_mesh on the card by default and on
    the CPU only when asked."""
    from weaviate_tpu_torch.index import new_vector_index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tvi.parse_and_validate_config("hnsw_tpu_mesh", {"meshDevices": 2})
    with pytest.raises(RuntimeError, match="CUDA"):
        new_vector_index(cfg, str(tmp_path / "a"))
    idx = new_vector_index(cfg, str(tmp_path / "b"), device="cpu")
    assert idx.n_dev == 2 and idx.device.type == "cpu"
