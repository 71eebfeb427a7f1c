"""The port's IVF scan plane (weaviate_tpu_torch/ops/ivf.py and the probed
funnel in ops/pq4.py) against the JAX package's on the same inputs, on
the CPU. Inputs are made with numpy from a seed and handed to both.

Tolerances, and why:
- the host half (k-means, assignment, PCA, buckets) is the same numpy
  code: bit-equal;
- probed dense searches: slots exact (gaussian data, tie-free) and
  distances rtol 1e-5: both sides rescore in f32 and differ only in the
  summation order;
- probed ADC searches (codes, 4-bit funnel without a rescore copy): slots
  exact, distances rtol 1e-5, atol 1e-4: both sides multiply the same
  bf16-rounded operands (exact in f32) and sum in f32 in another order;
- query blocking and probes per step: bit-equal to one block (selection
  is exact, so the grouping cannot change an answer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weaviate_tpu.ops import ivf as jivf
from weaviate_tpu.ops import pq4 as jpq4
from weaviate_tpu_torch.ops import ivf as tivf
from weaviate_tpu_torch.ops import pq4 as tpq4
from weaviate_tpu_torch.ops.topk import unpack_fused, unpack_topk

D, N, CAP, B, K, NLIST, M = 32, 3000, 4096, 12, 10, 16, 8


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _layout(seed=0, metric="l2-squared", pca_dim=8):
    """A trained layout over N gaussian rows of a capacity-CAP store, with
    some tombstones, a filter bitmap and queries."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    if metric == "cosine":
        rows = _unit(rows).astype(np.float32)
    cent = jivf.kmeans_fit(rows, NLIST, iters=4, seed=seed, sample=2048)
    if metric == "cosine":
        cent = _unit(cent).astype(np.float32)
    cap_t = jivf.bucket_capacity(np.array([int(1.25 * N / NLIST) + 1]))
    assign = np.full(CAP, -1, np.int32)
    assign[:N] = jivf.balanced_assign(rows, cent, cap_t)
    buckets, _ = jivf.build_buckets(assign, NLIST, cap_t)
    store = np.zeros((CAP, D), np.float32)
    store[:N] = rows
    proj = jivf.pca_fit(rows, pca_dim)
    pca_rows = np.zeros((CAP, pca_dim), np.float32)
    pca_rows[:N] = rows @ proj
    tombs = np.zeros(CAP, bool)
    tombs[rng.choice(N, 150, replace=False)] = True
    allow = rng.random(CAP) < 0.6
    words = np.packbits(allow.reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).ravel()
    q = rng.standard_normal((B, D)).astype(np.float32)
    if metric == "cosine":
        q = _unit(q).astype(np.float32)
    s2d = np.full(CAP, -1, np.int64)
    s2d[:N] = rng.permutation(N) + 1000
    return dict(rows=rows, cent=cent, buckets=buckets, store=store, proj=proj,
                pca_rows=pca_rows, tombs=tombs, words=words, q=q, s2d=s2d, rng=rng)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _np_packed(packed):
    return unpack_topk(packed.numpy())


def _check(got, want, rtol=1e-5, atol=0.0, msg=""):
    gd, gi = _np_packed(got)
    wd, wi = unpack_topk(np.asarray(want))
    np.testing.assert_array_equal(gi, wi, err_msg=msg)
    np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol, err_msg=msg)


def test_host_half_is_bit_equal():
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((2500, 16)).astype(np.float32)
    rows[:600] += 6.0  # one dense cluster: the balanced pass has to spill
    for nlist, sample in ((16, 0), (40, 1024)):
        c_t = tivf.kmeans_fit(rows, nlist, iters=3, seed=7, sample=sample)
        c_j = jivf.kmeans_fit(rows, nlist, iters=3, seed=7, sample=sample)
        np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(tivf.assign_partitions(rows, c_t),
                                  jivf.assign_partitions(rows, c_j))
    np.testing.assert_array_equal(tivf.assign_partitions(rows, c_t, chunk=100),
                                  jivf.assign_partitions(rows, c_j, chunk=100))
    cap = jivf.bucket_capacity(np.array([int(1.25 * 2500 / nlist) + 1]))
    assert tivf.bucket_capacity(np.array([int(1.25 * 2500 / nlist) + 1])) == cap
    a_t = tivf.balanced_assign(rows, c_t, cap)
    a_j = jivf.balanced_assign(rows, c_j, cap)
    np.testing.assert_array_equal(a_t, a_j)
    for cap_p in (None, cap, 1 << 12):
        b_t, f_t = tivf.build_buckets(a_t, nlist, cap_p)
        b_j, f_j = jivf.build_buckets(a_j, nlist, cap_p)
        np.testing.assert_array_equal(b_t, b_j)
        np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(tivf.pca_fit(rows, 5), jivf.pca_fit(rows, 5))
    assert tivf.group_steps(256, 384, 128, 256) == jivf.group_steps(256, 384, 128, 256)
    assert tivf.MATMUL_METRICS == jivf.MATMUL_METRICS


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
def test_probe_matches_the_reference(metric):
    lay = _layout(1, metric)
    got = tivf._probe(_t(lay["q"]), _t(lay["cent"]), 5, metric)
    want = jivf._probe(jnp.asarray(lay["q"]), jnp.asarray(lay["cent"]), 5, metric)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dense_args(lay, store_dtype, use_allow, pre_c):
    store = lay["store"]
    t_store = _bf16(store) if store_dtype == "bf16" else _t(store)
    j_store = jnp.asarray(store, jnp.bfloat16 if store_dtype == "bf16" else jnp.float32)
    t = (t_store, _t(lay["tombs"]), N, _t(lay["q"]), _t(lay["words"].view(np.int32)),
         _t(lay["cent"]), _t(lay["buckets"]), _t(lay["proj"]), _t(lay["pca_rows"]))
    j = (j_store, jnp.asarray(lay["tombs"]), N, jnp.asarray(lay["q"]),
         jnp.asarray(lay["words"]), jnp.asarray(lay["cent"]), jnp.asarray(lay["buckets"]),
         jnp.asarray(lay["proj"]), jnp.asarray(lay["pca_rows"]))
    return t, j


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("store_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_allow, pre_c", [(False, 0), (True, 0), (False, 128), (True, 64)],
                         ids=["plain", "allow", "pca", "pca-allow"])
def test_search_ivf_dense_matches_the_reference(metric, store_dtype, use_allow, pre_c):
    lay = _layout(2, metric)
    t, j = _dense_args(lay, store_dtype, use_allow, pre_c)
    top_p = 6
    for exact in (True, False):
        want = jivf.search_ivf_dense(*j, K, metric, use_allow, top_p, pre_c, exact, 2, 2)
        got = tivf.search_ivf_dense(*t, K, metric, use_allow, top_p, pre_c, 2, 2)
        _check(got, want, msg=f"{metric} {store_dtype} allow={use_allow} pre_c={pre_c}")
    want_f = jivf.search_ivf_dense_fused(*j, jnp.asarray(
        np.stack([lay["s2d"] & 0xFFFFFFFF, lay["s2d"] >> 32], 1).astype(np.uint32)),
        K, metric, use_allow, top_p, pre_c, True, 3, 1)
    got_f = tivf.search_ivf_dense_fused(*t, _t(lay["s2d"]), K, metric, use_allow, top_p,
                                        pre_c, 3, 1)
    gi, gd = unpack_fused(got_f.numpy())
    wi, wd = unpack_fused(np.asarray(want_f))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5)


def test_dense_all_partitions_is_the_exact_top_k():
    """top_p = nlist probes every bucket: the answer is the exact top-k of
    every live, allowed row."""
    lay = _layout(3)
    t, _ = _dense_args(lay, "f32", True, 0)
    top, idx = tivf.ivf_dense_topk(*t, K, "l2-squared", True, NLIST, 0, 4, 1)
    allow = np.unpackbits(lay["words"].view(np.uint8), bitorder="little").astype(bool)
    ok = ~lay["tombs"][:N] & allow[:N]
    d = ((lay["q"][:, None, :] - lay["rows"][None]) ** 2).sum(-1)
    d[:, ~ok] = np.inf
    want = np.argsort(d, axis=1)[:, :K]
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_allclose(top.numpy(), np.take_along_axis(d, want, 1), rtol=1e-5)


@pytest.mark.parametrize("pre_c", [0, 64])
def test_blocked_equals_unblocked(pre_c):
    lay = _layout(4)
    t, _ = _dense_args(lay, "f32", True, pre_c)
    base = tivf.search_ivf_dense(*t, K, "l2-squared", True, 8, pre_c, 8, 1)
    for qb, gp, steps2 in ((1, 1, 4), (5, 3, 2), (7, 8, 1)):
        got = tivf.search_ivf_dense(*t, K, "l2-squared", True, 8, pre_c, gp, steps2, qb=qb)
        assert torch.equal(got, base), (qb, gp, steps2)


def test_plan_steps_bounds_one_step():
    qb, gp, steps2 = tivf.plan_steps(16384, 384, 128, 256, second=2048, budget=512 << 20)
    assert qb * gp * 384 * 128 * 4 <= 512 << 20 and gp >= 1 and qb >= 1
    assert qb * -(-2048 // steps2) * 128 * 4 <= 512 << 20
    qb, gp, _ = tivf.plan_steps(256, 384, 128, 256, budget=512 << 20)
    assert qb == 256 and gp > 1 and qb * gp * 384 * 128 * 4 <= 512 << 20
    assert tivf.plan_steps(4, 128, 8, 3) == (4, 3, 1)


def _codes_state(lay, c=32, m=M):
    rng = lay["rng"]
    ds = D // m
    cb8 = rng.standard_normal((m, c, ds)).astype(np.float32)
    cb4 = rng.standard_normal((m, 16, ds)).astype(np.float32)
    codes8 = np.zeros((CAP, m), np.uint8)
    codes8[:N] = rng.integers(0, c, (N, m))
    codes4 = np.zeros((CAP, m), np.uint8)
    codes4[:N] = rng.integers(0, 16, (N, m))
    packed = (codes4[:, : m // 2] | (codes4[:, m // 2:] << 4)).astype(np.uint8)
    seg = np.arange(m)
    # ||recon||^2 of each row: L2 distances stay well above the clamp at 0
    norms8 = (cb8[seg, codes8] ** 2).sum((1, 2)).astype(np.float32)
    norms4 = (cb4[seg, codes4] ** 2).sum((1, 2)).astype(np.float32)
    rot, _ = np.linalg.qr(rng.standard_normal((D, D)))
    return cb8, cb4, codes8, packed, norms8, norms4, rot.astype(np.float32)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("rotated, use_allow, pre_c", [(False, False, 0), (True, True, 0),
                                                       (True, False, 128)],
                         ids=["plain", "rot-allow", "rot-pca"])
def test_search_ivf_codes_matches_the_reference(metric, rotated, use_allow, pre_c):
    lay = _layout(5, metric)
    cb8, _, codes8, _, norms8, _, rot = _codes_state(lay)
    rot = rot if rotated else None
    t_rot = None if rot is None else _t(rot)
    j_rot = None if rot is None else jnp.asarray(rot)
    common_t = (_t(lay["cent"]), _t(lay["buckets"]), _t(lay["proj"]), _t(lay["pca_rows"]))
    common_j = (jnp.asarray(lay["cent"]), jnp.asarray(lay["buckets"]),
                jnp.asarray(lay["proj"]), jnp.asarray(lay["pca_rows"]))
    got = tivf.search_ivf_codes(_t(codes8), _t(norms8), _t(lay["tombs"]), N, _t(lay["q"]),
                                _t(lay["words"].view(np.int32)), _t(cb8), *common_t, t_rot,
                                K, metric, use_allow, 6, pre_c, 2, 2)
    want = jivf.search_ivf_codes(jnp.asarray(codes8), jnp.asarray(norms8),
                                 jnp.asarray(lay["tombs"]), N, jnp.asarray(lay["q"]),
                                 jnp.asarray(lay["words"]), jnp.asarray(cb8), *common_j,
                                 j_rot, K, metric, use_allow, 6, pre_c, True, 2, 2)
    _check(got, want, atol=1e-4, msg=f"{metric} rot={rotated}")
    got_f = tivf.search_ivf_codes_fused(
        _t(codes8), _t(norms8), _t(lay["tombs"]), N, _t(lay["q"]),
        _t(lay["words"].view(np.int32)), _t(cb8), *common_t, t_rot, _t(lay["s2d"]), K,
        metric, use_allow, 6, pre_c, 3, 1, qb=5)
    gi, gd = unpack_fused(got_f.numpy())
    wd, wi = unpack_topk(np.asarray(want))
    np.testing.assert_array_equal(gi.view(np.int64), np.where(wi >= 0, lay["s2d"][wi], -1))
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
@pytest.mark.parametrize("rescore, use_allow", [(True, False), (True, True), (False, True)],
                         ids=["rescore", "rescore-allow", "codes-allow"])
def test_search_ivf_pq4_matches_the_reference(metric, rescore, use_allow):
    lay = _layout(6, metric)
    cb8, cb4, codes8, packed, norms8, norms4, rot = _codes_state(lay)
    rows_bf = lay["store"] if rescore else None
    t_args = (_t(packed), _t(codes8), _t(norms4), _t(norms8), _t(lay["tombs"]), N,
              _t(lay["q"]), _t(lay["words"].view(np.int32)), _t(cb4), _t(cb8),
              _t(lay["cent"]), _t(lay["buckets"]), _t(rot),
              None if rows_bf is None else _bf16(rows_bf))
    j_args = (jnp.asarray(packed), jnp.asarray(codes8), jnp.asarray(norms4),
              jnp.asarray(norms8), jnp.asarray(lay["tombs"]), N, jnp.asarray(lay["q"]),
              jnp.asarray(lay["words"]), jnp.asarray(cb4), jnp.asarray(cb8),
              jnp.asarray(lay["cent"]), jnp.asarray(lay["buckets"]), jnp.asarray(rot),
              None if rows_bf is None else jnp.asarray(rows_bf, jnp.bfloat16))
    c1, rc = 256, 32
    want = jpq4.search_ivf_pq4(*j_args, K, metric, use_allow, 6, c1, rc, True, 2, 2)
    got = tpq4.search_ivf_pq4(*t_args, K, metric, use_allow, 6, c1, rc, 2, 2)
    _check(got, want, atol=0.0 if rescore else 1e-4, msg=f"{metric} rescore={rescore}")
    blocked = tpq4.search_ivf_pq4(*t_args, K, metric, use_allow, 6, c1, rc, 1, 4, qb=5)
    assert torch.equal(blocked, got)
    got_f = tpq4.search_ivf_pq4_fused(*t_args, _t(lay["s2d"]), K, metric, use_allow, 6, c1,
                                      rc, 2, 2)
    gi, _ = unpack_fused(got_f.numpy())
    _, wi = unpack_topk(np.asarray(want))
    np.testing.assert_array_equal(gi.view(np.int64), np.where(wi >= 0, lay["s2d"][wi], -1))
