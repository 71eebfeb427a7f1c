"""The port's compressed-tier ops (weaviate_tpu_torch/ops/pq_gmin.py,
ops/pq4.py, and K1 over a bf16 store) against the JAX package's on the
same inputs, on the CPU. Inputs are made with numpy from a seed and handed
to both; the JAX side runs its Pallas kernels in interpret mode, as its own
tests do, and the port's wrappers take their plain versions (CPU tensors).

Tolerances, and why:
- group-min scores (K1-bf16, K2, K3): rtol 1e-5, atol 1e-4, and the same
  +inf pattern: both sides multiply the same bf16-rounded operands (exact
  in f32) and sum in f32 in another order.
- top-k searches: slots exact (the data is tie-free) and distances rtol
  1e-5: both sides rescore in f32 and differ only in summation order.
- layouts and LUT lookups: exact where no arithmetic is involved.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weaviate_tpu.ops import gmin_scan as jgmin
from weaviate_tpu.ops import pq4 as jpq4
from weaviate_tpu.ops import pq_gmin as jpqg
from weaviate_tpu_torch.ops import gmin_scan as tgmin
from weaviate_tpu_torch.ops import pq4 as tpq4
from weaviate_tpu_torch.ops import pq_gmin as tpqg

D, N, CAP, B, K, M = 32, 3000, 16384, 16, 10, 8
G = 16
NCOLS = CAP // G
AG = -(-N // NCOLS)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _state(seed=0, c=32, m=M):
    """Codes and codebooks of a capacity-16384 compressed store with N live
    rows, some tombstoned, one group dead in every member, plus a filter
    bitmap and queries."""
    rng = np.random.default_rng(seed)
    ds = D // m
    cb8 = rng.standard_normal((m, c, ds)).astype(np.float32)
    cb4 = rng.standard_normal((m, 16, ds)).astype(np.float32)
    codes8 = np.zeros((CAP, m), np.uint8)
    codes8[:N] = rng.integers(0, c, (N, m))
    codes4 = np.zeros((CAP, m), np.uint8)
    codes4[:N] = rng.integers(0, 16, (N, m))
    packed = np.concatenate([codes4[:, : m // 2] | (codes4[:, m // 2:] << 4)], axis=1)
    packed = packed.astype(np.uint8)
    tombs = np.zeros(CAP, bool)
    tombs[rng.choice(N, 200, replace=False)] = True
    tombs[7 + NCOLS * np.arange(G)] = True  # group 7: every member dead
    allow = rng.random(CAP) < 0.6
    words = np.packbits(allow.reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).ravel()
    rows = rng.standard_normal((CAP, D)).astype(np.float32)
    rows[N:] = 0.0

    def norms(cb, codes):
        sq = (cb.astype(np.float64) ** 2).sum(-1)
        out = sq[np.arange(m)[None, :], codes.astype(np.int64)].sum(1).astype(np.float32)
        out[N:] = 0.0
        return out

    q = rng.standard_normal((B, D)).astype(np.float32)
    return dict(cb8=cb8, cb4=cb4, codes8=codes8, codes4=codes4, packed=packed, tombs=tombs,
                words=words, rows=rows, norms8=norms(cb8, codes8), norms4=norms(cb4, codes4),
                q=q, rng=rng)


def _bias2(s, metric, norms):
    dead = s["tombs"] | (np.arange(CAP) >= N)
    base, alpha = (norms, -2.0) if metric == "l2-squared" else (np.zeros(CAP, np.float32), -1.0)
    return np.where(dead, np.inf, base).astype(np.float32).reshape(G, NCOLS), alpha


def _chunks(cb):
    return jnp.asarray(jpqg.build_cb_chunks(cb, min(8, cb.shape[0])), dtype=jnp.bfloat16)


def _rotation(rng):
    r, _ = np.linalg.qr(rng.standard_normal((D, D)))
    return r.astype(np.float32)


def _assert_scores(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
def test_pq_group_min_scores_matches_pallas_interpret(metric):
    s = _state()
    bias2, alpha = _bias2(s, metric, s["norms8"])
    codes3 = s["codes8"].reshape(G, NCOLS, M)
    want = np.asarray(jpqg.pq_group_min_scores(
        jnp.asarray(s["q"]), jnp.asarray(codes3), jnp.asarray(bias2), _chunks(s["cb8"]), alpha,
        active_g=AG, interpret=True))
    before = tpqg.launches
    got = tpqg.pq_group_min_scores(_t(s["q"]), _t(codes3), _t(bias2), _t(s["cb8"]), alpha,
                                   active_g=AG).numpy()
    assert tpqg.launches == before  # CPU tensors take the plain version
    assert np.isinf(got[:, 7]).all()  # the whole dead group stays +inf
    _assert_scores(got, want)


@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
def test_pq4_group_min_scores_matches_pallas_interpret(metric):
    s = _state(1)
    bias2, alpha = _bias2(s, metric, s["norms4"])
    codes3p = s["packed"].reshape(G, NCOLS, M // 2)
    want = np.asarray(jpq4.pq4_group_min_scores(
        jnp.asarray(s["q"]), jnp.asarray(codes3p), jnp.asarray(bias2), _chunks(s["cb4"]), alpha,
        active_g=AG, interpret=True))
    before = tpq4.launches
    got = tpq4.pq4_group_min_scores(_t(s["q"]), _t(codes3p), _t(bias2), _t(s["cb4"]), alpha,
                                    active_g=AG).numpy()
    assert tpq4.launches == before
    assert np.isinf(got[:, 7]).all()
    _assert_scores(got, want)


@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
def test_group_min_scores_bf16_store_matches_pallas_interpret(metric):
    """K1 over a bf16 store (the rescore copy of a compressed index)."""
    s = _state(2)
    sq = (s["rows"].astype(np.float64) ** 2).sum(1).astype(np.float32)
    bias2, alpha = _bias2(s, metric, sq)
    store3 = s["rows"].reshape(G, NCOLS, D)
    want = np.asarray(jgmin.group_min_scores(
        jnp.asarray(s["q"]), jnp.asarray(store3, dtype=jnp.bfloat16), jnp.asarray(bias2), alpha,
        active_g=AG, interpret=True))
    got = tgmin.group_min_scores(_t(s["q"]), _t(store3).to(torch.bfloat16), _t(bias2), alpha,
                                 active_g=AG).numpy()
    _assert_scores(got, want)


def test_pq4_byte_lut_scan_matches_jax():
    s = _state(3)
    bias2, _ = _bias2(s, "dot", s["norms4"])
    codes3p = s["packed"].reshape(G, NCOLS, M // 2)
    np.testing.assert_allclose(
        tpq4.byte_lut(_t(s["q"]), _t(s["cb4"])).numpy(),
        np.asarray(jpq4.byte_lut(jnp.asarray(s["q"]), jnp.asarray(s["cb4"]))), rtol=1e-5,
        atol=1e-5)
    want = np.asarray(jpq4.pq4_scores_traceable(jnp.asarray(s["q"]), jnp.asarray(codes3p),
                                                jnp.asarray(bias2), jnp.asarray(s["cb4"]), -1.0))
    got = tpq4.pq4_scores_traceable(_t(s["q"]), _t(codes3p), _t(bias2), _t(s["cb4"]), -1.0)
    _assert_scores(got.numpy(), want)


def test_build_codes_blocks_and_plan_funnel_match():
    s = _state()
    np.testing.assert_array_equal(tpqg.build_codes_blocks(_t(s["codes8"])).numpy(),
                                  np.asarray(jpqg.build_codes_blocks(jnp.asarray(s["codes8"]))))
    for args in ((10, CAP, 4096, 256), (10, 1024, 4096, 256), (300, 4096, 256, 32),
                 (5, 16, 256, 32)):
        assert tpq4.plan_funnel(*args) == jpq4.plan_funnel(*args)


@pytest.mark.parametrize("metric,use_allow,opq", [("l2-squared", False, False),
                                                  ("l2-squared", True, False),
                                                  ("dot", False, True),
                                                  ("cosine", True, True)])
def test_pq_gmin_topk_matches_jax(metric, use_allow, opq):
    s = _state(4)
    q = s["q"]
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    rot = _rotation(s["rng"]) if opq else None
    flat = s["cb8"].reshape(-1, D // M)
    rg = 32
    jt, ji = jpqg.pq_gmin_topk(
        jnp.asarray(s["codes8"]), jnp.asarray(s["norms8"]), jnp.asarray(s["tombs"]), N,
        jnp.asarray(q), _chunks(s["cb8"]), jnp.asarray(flat), jnp.asarray(s["words"]), use_allow,
        K, metric, rg, AG, True, None if rot is None else jnp.asarray(rot),
        jpqg.build_codes_blocks(jnp.asarray(s["codes8"])))
    codes = _t(s["codes8"])
    tt, ti = tpqg.pq_gmin_topk(
        codes, _t(s["norms8"]), _t(s["tombs"]), N, _t(q), _t(s["cb8"]).to(torch.bfloat16),
        _t(flat), _t(s["words"].view(np.int32)), use_allow, K, metric, rg, AG,
        None if rot is None else _t(rot), tpqg.build_codes_blocks(codes))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric,kernel,rescore,use_allow,opq", [
    ("l2-squared", True, True, False, False),
    ("l2-squared", False, True, True, False),
    ("dot", True, False, True, True),
    ("cosine", False, False, False, True),
    ("dot", True, True, True, False),
])
def test_pq4_funnel_topk_matches_jax(metric, kernel, rescore, use_allow, opq):
    """The three-stage funnel on the same arrays: stage 1 through K3's
    plain version (kernel) or the byte-LUT scan, rescore rows on and off,
    allowList, tombstones and OPQ."""
    s = _state(5)
    q = s["q"]
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    rot = _rotation(s["rng"]) if opq else None
    rows = s["rows"] if rescore else None
    flat8 = s["cb8"].reshape(-1, D // M)
    rg4, rc = tpq4.plan_funnel(K, CAP, 4096, 256)
    jt, ji = jpq4.pq4_funnel_topk(
        jnp.asarray(s["packed"]), jnp.asarray(s["codes8"]), jnp.asarray(s["norms4"]),
        jnp.asarray(s["norms8"]), jnp.asarray(s["tombs"]), N, jnp.asarray(q), _chunks(s["cb4"]),
        jnp.asarray(s["cb4"]), jnp.asarray(flat8),
        None if rows is None else jnp.asarray(rows, dtype=jnp.bfloat16),
        jnp.asarray(s["words"]), use_allow, K, metric, rg4, rc, AG, kernel, True, True,
        None if rot is None else jnp.asarray(rot),
        jpqg.build_codes_blocks(jnp.asarray(s["codes8"])))
    codes8 = _t(s["codes8"])
    tt, ti = tpq4.pq4_funnel_topk(
        _t(s["packed"]), codes8, _t(s["norms4"]), _t(s["norms8"]), _t(s["tombs"]), N, _t(q),
        _t(s["cb4"]).to(torch.bfloat16), _t(s["cb4"]), _t(flat8),
        None if rows is None else _t(rows).to(torch.bfloat16), _t(s["words"].view(np.int32)),
        use_allow, K, metric, rg4, rc, AG, kernel, None if rot is None else _t(rot),
        tpqg.build_codes_blocks(codes8))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


# D -> the resident tile's group columns at 16 live slices (None: no plan,
# the tile does not fit even at one column)
_PLANS = {8: 16, 30: 16, 128: 16, 384: 16, 392: 8, 768: 8, 769: 4, 1024: 4, 1536: 4, 1600: 2,
          3072: 2, 3136: 1, 6144: 1, 6208: 1, 6209: None, 6272: None, 8192: None}


def _tile_bytes(n, dp):
    """Shared memory of a tile of n bf16 rows at depth dp and the query
    ring: the widest tile (256 rows) keeps its bias beside them."""
    return n * dp * 2 + tgmin.RING_BYTES + (4 * n if n == 256 else 0) + tgmin.SMEM_RESERVE


@pytest.mark.parametrize("d", sorted(_PLANS))
def test_codes_plan_fits_shared_memory(d):
    """K2/K3's plan is the shared resident plan: the largest SCG of 16, 8,
    4, 2, 1 whose bf16 tile (16 slices x SCG rows x roundup(D, 64)) fits
    beside the query ring in a block's 227 KB."""
    plan = tpqg.codes_plan(d)
    assert plan == tgmin.resident_plan(d)
    if _PLANS[d] is None:
        assert plan is None
        assert _tile_bytes(16, -(-d // 64) * 64) > 232_448
        return
    assert (plan.slices, plan.scg, plan.dp % 64) == (G, _PLANS[d], 0) and 0 <= plan.dp - d < 64
    assert plan.smem == _tile_bytes(G * plan.scg, plan.dp) <= 232_448
    if plan.scg < 16:  # twice the columns would not fit
        assert _tile_bytes(2 * G * plan.scg, plan.dp) > 232_448


# (b, ncols, kk, d, m, c): both packages take their kernel on the first
# three; the port's plan alone takes the next two (the reference's VMEM
# budget refuses them); the last two are past the port's plan
_ROUTES = [(16, 1024, 10, 32, 8, 32), (64, 4096, 10, 128, 16, 256), (8, 64, 5, 64, 64, 16),
           (16, 65536, 10, 768, 96, 256), (16, 4096, 10, 6208, 97, 16),
           (16, 1024, 10, 6272, 98, 16), (16, 1024, 10, 8192, 64, 256)]


@pytest.mark.parametrize("b,ncols,kk,d,m,c", _ROUTES)
@pytest.mark.parametrize("ag", [1, 5, 16])
@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
def test_codes_routing_matches_reference_within_the_plan(b, ncols, kk, d, m, c, ag, metric):
    """eligible_rg and pq4.use_kernel against the reference's eligible_rg
    and pallas_eligible: the same answer where both take the kernel,
    refusal past the port's plan, whatever the live slices."""
    state = SimpleNamespace(_gmin_broken=False)
    pq = SimpleNamespace(centroids=c, segments=m)
    rg = tpqg.eligible_rg(False, metric, pq, b, ncols, kk, d)
    k3 = tpq4.use_kernel(metric, b, ncols, d)
    if tpqg.codes_plan(d) is None:
        assert rg is None and not k3
        return
    assert rg is not None and k3
    want_rg = jpqg.eligible_rg(state, False, metric, pq, b, ncols, kk, d, ag)
    if want_rg is not None:
        assert rg == want_rg
    if jpq4.pallas_eligible(state, metric, b, ncols, d, m // 2, ag):
        assert k3
    # the shapes the plan does not decide route alike
    assert tpqg.eligible_rg(False, metric, pq, 7, ncols, kk, d) is None
    assert not tpq4.use_kernel(metric, 7, ncols, d)
    assert tpqg.eligible_rg(False, "manhattan", pq, b, ncols, kk, d) is None


@pytest.mark.parametrize("pq", [{"rescore": False}, {"bits": 4}])
def test_index_past_the_plan_answers_without_the_codes_kernels(tmp_path, monkeypatch, pq):
    """With a shared-memory limit under the smallest tile of this D, the
    codes-only tier answers through the reconstruction scan and the funnel's
    stage 1 through the byte-LUT scan: neither wrapper is called and no
    launch counted. The answers equal the JAX index's on the same shard
    with its VMEM budget at 0, which routes it to the same scans (slots
    exact, distances rtol 1e-5: the same arithmetic in another order)."""
    from weaviate_tpu.entities import vectorindex as jvi
    from weaviate_tpu.index import new_vector_index as jax_new_index
    from weaviate_tpu_torch.entities import vectorindex as tvi
    from weaviate_tpu_torch.index import new_vector_index

    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    conf = {"distance": "l2-squared", "flatSearchCutoff": 500,
            "pq": {"enabled": True, "segments": M, "centroids": 32, **pq}}

    def port():
        return new_vector_index(tvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path),
                                device="cpu")

    w = port()
    w.add_batch(np.arange(N), vecs)
    assert w.compressed
    w.shutdown()
    calls = []
    for mod, name in ((tpqg, "pq_group_min_scores"), (tpq4, "pq4_group_min_scores")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: (calls.append(_n),
                                                                            _fn(*a, **kw))[1])
    tidx = port()
    tidx.search_by_vectors(q, K)
    assert len(calls) == 1  # the kernel route at the real limit
    monkeypatch.setattr(tgmin, "SMEM_LIMIT",
                        G * 1 * 64 * 2 + tgmin.RING_BYTES + tgmin.SMEM_RESERVE - 1)
    assert tpqg.codes_plan(D) is None
    for mod in (jpqg, jpq4):
        monkeypatch.setattr(mod, "_VMEM_BUDGET", 0)
    jidx = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path))
    before = (tpqg.launches, tpq4.launches)
    ids, d = tidx.search_by_vectors(q, K)
    assert len(calls) == 1 and (tpqg.launches, tpq4.launches) == before
    want_ids, want_d = jidx.search_by_vectors(q, K)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-5)


def test_codes_wrappers_reject_other_devices():
    meta = torch.device("meta")
    q = torch.zeros((B, D), device=meta)
    with pytest.raises(ValueError):
        tpqg.pq_group_min_scores(q, torch.zeros((16, 8, M), dtype=torch.uint8, device=meta),
                                 torch.zeros((16, 8), device=meta),
                                 torch.zeros((M, 4, D // M), device=meta), -1.0)
    with pytest.raises(ValueError):
        tpq4.pq4_group_min_scores(q, torch.zeros((16, 8, M // 2), dtype=torch.uint8, device=meta),
                                  torch.zeros((16, 8), device=meta),
                                  torch.zeros((M, 16, D // M), device=meta), -1.0)
