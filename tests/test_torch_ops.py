"""The port's ops (weaviate_tpu_torch/ops) against the JAX package's on the
same inputs, on the CPU. Inputs are made with numpy from a seed and handed
to both; the JAX side runs as its own tests run it on the CPU (the Pallas
kernel in interpret mode).

Tolerances, and why:
- distances and rescores: rtol 1e-5 — both sides compute in f32; only the
  order of summation differs.
- top-k selection, merging, bitmap expansion, packing: exact — no
  arithmetic, and the data is tie-free.
- group-min scores: rtol 1e-5, atol 1e-4 — both sides multiply the same
  bf16-rounded operands (exact in f32) and sum in f32 in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weaviate_tpu.ops import distances as jdist
from weaviate_tpu.ops import gmin_scan as jgmin
from weaviate_tpu.ops import topk as jtopk
from weaviate_tpu_torch.ops import distances as tdist
from weaviate_tpu_torch.ops import gmin_scan as tgmin
from weaviate_tpu_torch.ops import topk as ttopk

D, N, CAP, B, K = 32, 3000, 16384, 16, 10
METRICS = ["l2-squared", "dot", "cosine", "manhattan", "hamming"]


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32), rng)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distances(metric):
    x, q, _ = _data()
    if metric == "hamming":  # few distinct values, so equal coordinates occur
        x, q = np.round(x), np.round(q)
    if metric == "cosine":
        x = np.asarray(jdist.normalize_rows(jnp.asarray(x)))
        q = np.asarray(jdist.normalize_rows(jnp.asarray(q)))
    want = np.asarray(jdist.pairwise_distances(jnp.asarray(q), jnp.asarray(x), metric))
    got = tdist.pairwise_distances(_t(q), _t(x), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_normalize_rows_and_single_distance():
    x, q, _ = _data()
    # The JAX side gets a private copy, and its result is copied out once
    # complete: on the CPU, jnp.asarray aliases a 64-byte aligned numpy
    # buffer and np.asarray returns a view of the device buffer, so without
    # the copies the compared arrays share memory with JAX's buffers. Both
    # functions land within 2.5e-7 of float64 here, so each side is also
    # held against a float64 reference: a deviation then names its side.
    want = np.array(jdist.normalize_rows(jnp.array(x, copy=True)).block_until_ready())
    x64 = x.astype(np.float64)
    ref = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
    np.testing.assert_allclose(want, ref, rtol=1e-6, err_msg="the JAX package's normalize_rows")
    got = tdist.normalize_rows(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, err_msg="the port's normalize_rows")
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for metric in METRICS:
        assert tdist.single_distance(x[0], q[0], metric) == pytest.approx(
            jdist.single_distance(x[0], q[0], metric), rel=1e-6)


def test_require_full_f32_raises_on_tf32_and_leaves_the_flag():
    """With TF32 on, a card's float32 distances would be rounded: the
    check raises for a cuda device, passes for the CPU, and never changes
    the process-wide flag itself."""
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    try:
        tdist.require_full_f32(torch.device("cuda"))
        flag.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32"):
            tdist.require_full_f32(torch.device("cuda"))
        tdist.require_full_f32(torch.device("cpu"))
        assert flag.allow_tf32 is True
    finally:
        flag.allow_tf32 = prev


def test_masked_top_k_exact():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((B, N)).astype(np.float32)
    valid = rng.random(N) < 0.7
    allow = rng.random((B, N)) < 0.5
    for am in (None, allow, allow[0]):
        jt, ji = jtopk.masked_top_k(jnp.asarray(d), jnp.asarray(valid), K,
                                    None if am is None else jnp.asarray(am))
        tt, ti = ttopk.masked_top_k(_t(d), _t(valid), K, None if am is None else _t(am))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # fewer valid slots than k: the missing ones are (+inf, -1) in both
    few = np.zeros(N, bool)
    few[:3] = True
    jt, ji = jtopk.masked_top_k(jnp.asarray(d), jnp.asarray(few), K)
    tt, ti = ttopk.masked_top_k(_t(d), _t(few), K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_top_k_exact():
    rng = np.random.default_rng(2)
    da, db = (np.sort(rng.standard_normal((B, K)).astype(np.float32), axis=1) for _ in range(2))
    ia, ib = (rng.integers(0, N, (B, K)).astype(np.int32) for _ in range(2))
    jt, ji = jtopk.merge_top_k(*(jnp.asarray(a) for a in (da, ia, db, ib)), K)
    tt, ti = ttopk.merge_top_k(_t(da), _t(ia), _t(db), _t(ib), K)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_bitmap_to_mask_exact():
    rng = np.random.default_rng(3)
    words = rng.integers(0, 2 ** 32, CAP // 32, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 1]  # bit 31 and the edges
    want = np.asarray(jtopk.bitmap_to_mask(jnp.asarray(words), N))
    got = ttopk.bitmap_to_mask(_t(words.view(np.int32)), N).numpy()
    np.testing.assert_array_equal(got, want)


def test_pack_and_translate_layouts_match():
    """Both packages hand the host the same fused [B, 3k] int32 buffer, so
    the same unpack reads either."""
    rng = np.random.default_rng(4)
    top = np.sort(rng.standard_normal((B, K)).astype(np.float32), axis=1)
    idx = rng.integers(0, CAP, (B, K)).astype(np.int32)
    top[0, -3:], idx[0, -3:] = np.inf, -1  # missing results
    docs = np.full(CAP, -1, np.int64)
    docs[: N] = rng.permutation(N) * 7919 + 2 ** 33  # ids past 32 bits
    s2d_words = np.ascontiguousarray(docs.astype("<i8")).view("<u4").reshape(CAP, 2)
    want = np.asarray(jtopk.translate_pack(jnp.asarray(top), jnp.asarray(idx),
                                           jnp.asarray(s2d_words)))
    got = ttopk.translate_pack(_t(top), _t(idx), _t(docs)).numpy()
    np.testing.assert_array_equal(got, want)
    ids, dists = ttopk.unpack_fused(got)
    assert ids[0, -1] == np.iinfo(np.uint64).max and np.isinf(dists[0, -1])
    np.testing.assert_array_equal(ids[1], docs[idx[1]].astype(np.uint64))


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine"])
def test_rescore_distances(metric):
    rng = np.random.default_rng(5)
    cand = rng.standard_normal((B, 64, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    want = np.asarray(jtopk.rescore_distances(jnp.asarray(cand), jnp.asarray(q), metric))
    got = ttopk.rescore_distances(_t(cand), _t(q), metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _store_state(seed=6):
    """A capacity-16384 store with N live rows, some tombstoned, plus a
    filter bitmap: the index's device state at the small test size."""
    x, q, rng = _data(seed)
    store = np.zeros((CAP, D), np.float32)
    store[:N] = x
    sq = (store.astype(np.float64) ** 2).sum(1).astype(np.float32)
    tombs = np.zeros(CAP, bool)
    tombs[rng.choice(N, 200, replace=False)] = True
    allow = rng.random(CAP) < 0.6
    words = np.packbits(allow.reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).ravel()
    return store, sq, tombs, words, q


@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
def test_group_min_scores_matches_pallas_interpret(metric):
    store, sq, tombs, _, q = _store_state()
    ncols = CAP // tgmin.G
    ag = -(-N // ncols)
    dead = tombs | (np.arange(CAP) >= N)
    base, alpha = (sq, -2.0) if metric == "l2-squared" else (np.zeros(CAP, np.float32), -1.0)
    bias2 = np.where(dead, np.inf, base).astype(np.float32).reshape(tgmin.G, ncols)
    store3 = store.reshape(tgmin.G, ncols, D)
    want = np.asarray(jgmin.group_min_scores(jnp.asarray(q), jnp.asarray(store3),
                                             jnp.asarray(bias2), alpha, active_g=ag,
                                             interpret=True))
    before = tgmin.launches
    got = tgmin.group_min_scores(_t(q), _t(store3), _t(bias2), alpha, active_g=ag).numpy()
    assert tgmin.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric,use_allow", [("l2-squared", False), ("l2-squared", True),
                                              ("dot", False), ("cosine", True)])
def test_gmin_topk_matches_jax(metric, use_allow):
    store, sq, tombs, words, q = _store_state()
    if metric == "cosine":
        store[:N] /= np.linalg.norm(store[:N], axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    ag = -(-N // (CAP // tgmin.G))
    jt, ji = jgmin.gmin_topk(jnp.asarray(store), jnp.asarray(sq), jnp.asarray(tombs), N,
                             jnp.asarray(q), jnp.asarray(words), use_allow, K, metric, 32,
                             ag, True, jgmin.build_rescore_blocks(jnp.asarray(store)))
    tstore = _t(store)
    tt, ti = tgmin.gmin_topk(tstore, _t(sq), _t(tombs), N, _t(q), _t(words.view(np.int32)),
                             use_allow, K, metric, 32, ag,
                             tgmin.build_rescore_blocks(tstore))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-5)


def test_build_rescore_blocks_matches():
    store, *_ = _store_state()
    want = np.asarray(jgmin.build_rescore_blocks(jnp.asarray(store)))
    np.testing.assert_array_equal(tgmin.build_rescore_blocks(_t(store)).numpy(), want)


def test_group_min_scores_rejects_other_devices():
    q = torch.zeros((B, D), device="meta")
    with pytest.raises(ValueError):
        tgmin.group_min_scores(q, torch.zeros((16, 8, D), device="meta"),
                               torch.zeros((16, 8), device="meta"), -1.0)

