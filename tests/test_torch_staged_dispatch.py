"""The port's staged (non-fused) dispatch, on the CPU: the fused-dispatch
toggle of weaviate_tpu_torch/index/gpu.py off (`FUSED_DISPATCH_ENABLED=
false` or `set_fused_enabled(False)`), where every tier returns the packed
[B, 2k] slots (`ops/topk.pack_topk`) and finalize() translates them on
the host through the dispatching snapshot's slot->doc mirror.

Held here:
- the packed layout and the packed search entries (`search_gmin`,
  `search_pq_gmin`, `search_pq4_funnel`) against the JAX package's on the
  same inputs (Pallas in interpret mode);
- fused == staged bit for bit on every tier of the port, sync and async,
  with uint64 ids and the 2^64-1 sentinel for a missing slot;
- the port's staged answers against the JAX index's staged answers (its
  own toggle, through its public function);
- snapshot pinning of the staged finalize, and the toggle's contracts.

Tolerances: ids exact (tie-free gaussian data); distances rtol 1e-5, atol
1e-5 across packages (f32 rescores summed in another order); exact within
the port (fused and staged run the same arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import new_vector_index as jax_new_index
from weaviate_tpu.index import tpu as jtpu
from weaviate_tpu.ops import gmin_scan as jgmin
from weaviate_tpu.ops import pq4 as jpq4
from weaviate_tpu.ops import pq_gmin as jpqg
from weaviate_tpu.ops import topk as jtopk
from weaviate_tpu.storage.bitmap import Bitmap as JaxBitmap
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.index import gpu
from weaviate_tpu_torch.index import new_vector_index as torch_new_index
from weaviate_tpu_torch.ops import gmin_scan as tgmin
from weaviate_tpu_torch.ops import pq4 as tpq4
from weaviate_tpu_torch.ops import pq_gmin as tpqg
from weaviate_tpu_torch.ops import topk as ttopk
from weaviate_tpu_torch.storage.bitmap import Bitmap as TorchBitmap

D, N, CAP, B, K, M = 32, 3000, 16384, 16, 10, 8
G = 16
NCOLS = CAP // G
AG = -(-N // NCOLS)
SENTINEL = np.iinfo(np.uint64).max
PQ = {"enabled": True, "segments": M, "centroids": 32}


@pytest.fixture(autouse=True)
def _revert_toggles():
    yield
    gpu.set_fused_enabled(None)
    jtpu.set_fused_enabled(None)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


# -- the packed layout and the packed search entries --------------------------


def test_pack_topk_round_trips_and_matches_jax():
    rng = np.random.default_rng(0)
    top = np.sort(rng.standard_normal((B, K)).astype(np.float32), axis=1)
    idx = rng.integers(0, CAP, (B, K)).astype(np.int32)
    top[0, -2:], idx[0, -2:] = np.inf, -1
    top[1, -1] = np.float32("nan")
    top[2, 0] = -np.inf
    packed = ttopk.pack_topk(_t(top), _t(idx))
    assert packed.dtype == torch.int32 and tuple(packed.shape) == (B, 2 * K)
    want = np.asarray(jtopk.pack_topk(jnp.asarray(top), jnp.asarray(idx)))
    np.testing.assert_array_equal(packed.numpy(), want)
    dists, slots = ttopk.unpack_topk(packed.numpy())
    # every bit pattern survives: the distances ride as bits, never as values
    np.testing.assert_array_equal(dists.view(np.int32), top.view(np.int32))
    np.testing.assert_array_equal(slots, idx)
    # the int64 slots the ops return pack the same as int32 ones
    np.testing.assert_array_equal(ttopk.pack_topk(_t(top), _t(idx).long()).numpy(), want)


def test_retranslate_packed_equals_translate_pack():
    rng = np.random.default_rng(1)
    top = np.sort(rng.standard_normal((B, K)).astype(np.float32), axis=1)
    idx = rng.integers(0, N, (B, K)).astype(np.int32)
    top[0, -3:], idx[0, -3:] = np.inf, -1
    docs = np.full(CAP, -1, np.int64)
    docs[:N] = rng.permutation(N) * 7919 + 2 ** 40
    got = ttopk.retranslate_packed(ttopk.pack_topk(_t(top), _t(idx)), _t(docs))
    np.testing.assert_array_equal(got.numpy(),
                                  ttopk.translate_pack(_t(top), _t(idx), _t(docs)).numpy())


def _store_state(seed=6):
    rng = np.random.default_rng(seed)
    store = np.zeros((CAP, D), np.float32)
    store[:N] = rng.standard_normal((N, D))
    sq = (store.astype(np.float64) ** 2).sum(1).astype(np.float32)
    tombs = np.zeros(CAP, bool)
    tombs[rng.choice(N, 200, replace=False)] = True
    allow = rng.random(CAP) < 0.6
    words = np.packbits(allow.reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).ravel()
    return store, sq, tombs, words, rng.standard_normal((B, D)).astype(np.float32)


def _assert_packed(got, want):
    gd, gi = ttopk.unpack_topk(np.asarray(got))
    wd, wi = jtopk.unpack_topk(np.asarray(want))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric,use_allow", [("l2-squared", False), ("l2-squared", True),
                                              ("dot", False)])
def test_search_gmin_matches_jax(metric, use_allow):
    store, sq, tombs, words, q = _store_state()
    want = jgmin.search_gmin(jnp.asarray(store), jnp.asarray(sq), jnp.asarray(tombs), N,
                             jnp.asarray(q), jnp.asarray(words), use_allow, K, metric, 32, AG,
                             True)
    got = tgmin.search_gmin(_t(store), _t(sq), _t(tombs), N, _t(q), _t(words.view(np.int32)),
                            use_allow, K, metric, 32, AG)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 2 * K)
    _assert_packed(got.numpy(), want)


def _codes_state(seed=4):
    rng = np.random.default_rng(seed)
    ds = D // M
    cb8 = rng.standard_normal((M, 32, ds)).astype(np.float32)
    cb4 = rng.standard_normal((M, 16, ds)).astype(np.float32)
    codes8 = np.zeros((CAP, M), np.uint8)
    codes8[:N] = rng.integers(0, 32, (N, M))
    codes4 = np.zeros((CAP, M), np.uint8)
    codes4[:N] = rng.integers(0, 16, (N, M))
    packed = (codes4[:, : M // 2] | (codes4[:, M // 2:] << 4)).astype(np.uint8)
    tombs = np.zeros(CAP, bool)
    tombs[rng.choice(N, 200, replace=False)] = True

    def norms(cb, codes):
        sq = (cb.astype(np.float64) ** 2).sum(-1)
        out = sq[np.arange(M)[None, :], codes.astype(np.int64)].sum(1).astype(np.float32)
        out[N:] = 0.0
        return out

    rows = np.zeros((CAP, D), np.float32)
    rows[:N] = rng.standard_normal((N, D))
    words = np.zeros(CAP // 32, np.uint32)
    return dict(cb8=cb8, cb4=cb4, codes8=codes8, packed=packed, tombs=tombs, rows=rows,
                norms8=norms(cb8, codes8), norms4=norms(cb4, codes4), words=words,
                q=rng.standard_normal((B, D)).astype(np.float32))


def _chunks(cb):
    return jnp.asarray(jpqg.build_cb_chunks(cb, min(8, cb.shape[0])), dtype=jnp.bfloat16)


def test_search_pq_gmin_matches_jax():
    s = _codes_state()
    flat = s["cb8"].reshape(-1, D // M)
    want = jpqg.search_pq_gmin(
        jnp.asarray(s["codes8"]), jnp.asarray(s["norms8"]), jnp.asarray(s["tombs"]), N,
        jnp.asarray(s["q"]), _chunks(s["cb8"]), jnp.asarray(flat), jnp.asarray(s["words"]),
        False, K, "l2-squared", 32, AG, True, None,
        jpqg.build_codes_blocks(jnp.asarray(s["codes8"])))
    codes = _t(s["codes8"])
    got = tpqg.search_pq_gmin(
        codes, _t(s["norms8"]), _t(s["tombs"]), N, _t(s["q"]), _t(s["cb8"]).to(torch.bfloat16),
        _t(flat), _t(s["words"].view(np.int32)), False, K, "l2-squared", 32, AG, None,
        tpqg.build_codes_blocks(codes))
    _assert_packed(got.numpy(), want)


def test_search_pq4_funnel_matches_jax():
    s = _codes_state(5)
    flat8 = s["cb8"].reshape(-1, D // M)
    rg4, rc = tpq4.plan_funnel(K, CAP, 4096, 256)
    want = jpq4.search_pq4_funnel(
        jnp.asarray(s["packed"]), jnp.asarray(s["codes8"]), jnp.asarray(s["norms4"]),
        jnp.asarray(s["norms8"]), jnp.asarray(s["tombs"]), N, jnp.asarray(s["q"]),
        _chunks(s["cb4"]), jnp.asarray(s["cb4"]), jnp.asarray(flat8),
        jnp.asarray(s["rows"], dtype=jnp.bfloat16), jnp.asarray(s["words"]), False, K, "dot",
        rg4, rc, AG, True, True, True, None, jpqg.build_codes_blocks(jnp.asarray(s["codes8"])))
    codes8 = _t(s["codes8"])
    got = tpq4.search_pq4_funnel(
        _t(s["packed"]), codes8, _t(s["norms4"]), _t(s["norms8"]), _t(s["tombs"]), N,
        _t(s["q"]), _t(s["cb4"]).to(torch.bfloat16), _t(s["cb4"]), _t(flat8),
        _t(s["rows"]).to(torch.bfloat16), _t(s["words"].view(np.int32)), False, K, "dot", rg4,
        rc, AG, True, None, tpqg.build_codes_blocks(codes8))
    _assert_packed(got.numpy(), want)


# -- fused == staged on every tier of the port --------------------------------


def _torch(conf, path):
    return torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf), str(path),
                           device="cpu")


def _vecs(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32), rng


def _built(conf, path, seed=0):
    idx = _torch(conf, path)
    vecs, rng = _vecs(seed)
    idx.add_batch(np.arange(N), vecs)
    idx.delete(*range(0, 60, 3))
    return idx, vecs, rng


# tier -> (config, query rows, allowList docs or None, the counter of the
# kernel the tier runs or None)
BIG_ALLOW = np.arange(0, N, 2)
TIERS = {
    "exact_gmin": ({"distance": "l2-squared"}, 9, None),
    "exact_chunked_b3": ({"distance": "l2-squared"}, 3, None),
    "masked_filter": ({"distance": "dot", "flatSearchCutoff": 500}, 16, BIG_ALLOW),
    "gather": ({"distance": "l2-squared", "flatSearchCutoff": 500}, 16,
               np.array([3, 7, 11, 401, 2999])),
    "pq_rescore": ({"distance": "l2-squared", "pq": PQ}, 16, None),
    "pq_codes": ({"distance": "dot", "pq": {**PQ, "rescore": False}}, 16, None),
    "pq_recon_b3": ({"distance": "l2-squared", "pq": {**PQ, "rescore": False}}, 3, None),
    "pq_manhattan_lut": ({"distance": "manhattan", "pq": {**PQ, "rescore": False}}, 16, None),
    "pq4_funnel": ({"distance": "l2-squared", "pq": {**PQ, "bits": 4}}, 16, None),
    "pq_gather": ({"distance": "l2-squared", "flatSearchCutoff": 500,
                   "pq": {**PQ, "rescore": False}}, 4, np.array([3, 7, 11, 401])),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_fused_and_staged_are_bit_identical_sync_and_async(tmp_path, tier):
    conf, b, allow = TIERS[tier]
    idx, vecs, rng = _built(conf, tmp_path)
    assert idx.compressed == ("pq" in conf)
    q = vecs[rng.choice(N, b, replace=False)] + 0.01 * rng.standard_normal((b, D)).astype(
        np.float32)
    al = TorchBitmap(allow) if allow is not None else None
    gpu.set_fused_enabled(True)
    f_sync = idx.search_by_vectors(q, K, al)
    f_async = idx.search_by_vectors_async(q, K, al)()
    gpu.set_fused_enabled(False)
    s_sync = idx.search_by_vectors(q, K, al)
    s_async = idx.search_by_vectors_async(q, K, al)()
    for got in (f_sync, f_async, s_async):
        np.testing.assert_array_equal(got[0], s_sync[0])
        np.testing.assert_array_equal(got[1].view(np.int32), s_sync[1].view(np.int32))
    for ids, dists in (f_sync, s_sync):
        assert ids.dtype == np.uint64 and dists.dtype == np.float32
        assert ids.shape == dists.shape == (b, K if allow is None or len(allow) >= K
                                            else len(allow))
    assert np.isfinite(s_sync[1]).all() or allow is not None


def test_staged_missing_slots_carry_the_sentinel(tmp_path):
    """Fewer matches than k: a missing slot reads +inf and 2^64-1, as the
    fused translation and the JAX package's host translation emit."""
    idx, vecs, _ = _built({"distance": "l2-squared", "flatSearchCutoff": 500}, tmp_path)
    allow = TorchBitmap(np.array([60, 61, 62] + list(range(10 ** 6, 10 ** 6 + 600))))
    out = {}
    for fused in (True, False):
        gpu.set_fused_enabled(fused)
        out[fused] = idx.search_by_vectors(vecs[60:69] + 0.01, 8, allow)
    ids, dists = out[False]
    assert (ids[:, 3:] == SENTINEL).all() and np.isinf(dists[:, 3:]).all()
    assert {int(x) for x in ids[0, :3]} == {60, 61, 62}
    np.testing.assert_array_equal(out[True][0], ids)
    np.testing.assert_array_equal(out[True][1], dists)


def test_staged_keeps_64bit_doc_ids(tmp_path):
    idx = _torch({"distance": "l2-squared"}, tmp_path)
    big = np.array([2 ** 63 + 7, 2 ** 40 + 1, 3], dtype=np.uint64)
    vecs = np.eye(3, D, dtype=np.float32)
    idx.add_batch(big.astype(np.int64), vecs)
    gpu.set_fused_enabled(False)
    ids, _ = idx.search_by_vectors(vecs, 3)
    assert {int(x) for x in ids[0]} == {int(x) for x in big}


@pytest.mark.parametrize("pq", [None, {**PQ, "rescore": False}])
def test_staged_finalize_pins_the_snapshot_across_writes(tmp_path, pq):
    """Enqueue, then delete the winners, grow the store past its capacity
    (a new slot->doc mirror), drop the index and refill it under other doc
    ids (the live mirror now maps every old slot to a new doc): finalize
    still returns the dispatching snapshot's answer, and a fresh search
    sees the new world."""
    conf = {"distance": "l2-squared", **({"pq": pq} if pq else {})}
    idx, vecs, _ = _built(conf, tmp_path)
    gpu.set_fused_enabled(False)
    q = vecs[100:116] + 0.01
    want = idx.search_by_vectors(q, 5)
    fin = idx.search_by_vectors_async(q, 5)
    idx.delete(*[int(x) for x in np.unique(want[0][:, 0])])
    more, _ = _vecs(9, n=CAP)
    idx.add_batch(np.arange(N, N + CAP), more)  # grows 16384 -> 32768 slots
    assert idx.capacity > CAP
    idx.drop()
    idx.add_batch(np.arange(N) + 10 ** 6, vecs)
    got = fin()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    fresh = idx.search_by_vectors(q, 5)
    assert (fresh[0] >= 10 ** 6).all()


# -- the port's staged answers against the JAX index's ------------------------


def _jax(conf, path):
    return jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(path))


def _compare_staged(tidx, jidx, rng, allows):
    gpu.set_fused_enabled(False)
    jtpu.set_fused_enabled(False)
    q = rng.standard_normal((B, D)).astype(np.float32)
    for b in (B, 1):
        for allow in allows:
            got = tidx.search_by_vectors(q[:b], K, TorchBitmap(allow) if allow is not None
                                         else None)
            want = jidx.search_by_vectors(q[:b], K, JaxBitmap(allow) if allow is not None
                                          else None)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "manhattan"])
def test_staged_uncompressed_matches_jax_staged(tmp_path, metric):
    """The same operations on both packages: exact gmin (B=16), the chunked
    scan (B=1), a masked allowList and the gather tier."""
    conf = {"distance": metric, "flatSearchCutoff": 500}
    vecs, rng = _vecs(2)
    pair = []
    for make, path in ((_torch, tmp_path / "torch"), (_jax, tmp_path / "jax")):
        idx = make(conf, path)
        idx.add_batch(np.arange(N), vecs)
        idx.delete(*range(0, 60, 3))
        pair.append(idx)
    _compare_staged(*pair, rng, [None, BIG_ALLOW, rng.choice(N, 300, replace=False)])


@pytest.mark.parametrize("metric,pq", [("l2-squared", {}), ("dot", {"rescore": False}),
                                       ("l2-squared", {"bits": 4}),
                                       ("manhattan", {"rescore": False})])
def test_staged_compressed_restart_matches_jax_staged(tmp_path, metric, pq):
    """A compressed shard written by the JAX package, restarted from the
    same directory in both packages (both then lay the replayed rows out
    in the same slots), answers alike with both toggles off."""
    conf = {"distance": metric, "flatSearchCutoff": 500, "pq": {**PQ, **pq}}
    vecs, rng = _vecs(3)
    w = _jax(conf, tmp_path)
    w.add_batch(np.arange(N), vecs)
    assert w.compressed
    w.delete(*range(0, 60, 3))
    w.shutdown()
    jidx, tidx = _jax(conf, tmp_path), _torch(conf, tmp_path)
    assert tidx.compressed
    _compare_staged(tidx, jidx, rng, [None, rng.choice(N, 300, replace=False)])


# -- the toggle ---------------------------------------------------------------


def test_fused_override_token_discipline():
    t1 = gpu.set_fused_enabled(False)
    t2 = gpu.set_fused_enabled(True)
    gpu.unset_fused_enabled(t1)  # stale: the newer override survives
    assert gpu.fused_dispatch_enabled() is True
    gpu.unset_fused_enabled(None)  # a None token is a no-op
    assert gpu.fused_dispatch_enabled() is True
    gpu.unset_fused_enabled(t2)  # current: reverts to the environment default
    assert gpu._fused_override is None and gpu._fused_token is None
    assert gpu.fused_dispatch_enabled() is True


@pytest.mark.parametrize("value,want", [("false", False), ("0", False), ("off", False),
                                        ("no", False), (" TRUE ", True), ("enabled", True),
                                        ("On", True), ("1", True)])
def test_fused_toggle_env_and_setter(monkeypatch, value, want):
    """The env knob reads the JAX package's truth table; the setter wins
    over it, and reverting re-reads the environment."""
    gpu.set_fused_enabled(None)
    monkeypatch.setenv("FUSED_DISPATCH_ENABLED", value)
    assert gpu.fused_dispatch_enabled() is want
    monkeypatch.setattr(jtpu, "_fused_env", None)
    monkeypatch.setattr(jtpu, "_fused_override", None)
    assert jtpu.fused_dispatch_enabled() is want
    gpu.set_fused_enabled(not want)
    assert gpu.fused_dispatch_enabled() is (not want)
    gpu.set_fused_enabled(None)
    assert gpu.fused_dispatch_enabled() is want
    monkeypatch.delenv("FUSED_DISPATCH_ENABLED")
    assert gpu.fused_dispatch_enabled() is want  # the cached parse until a revert
    gpu.set_fused_enabled(None)
    assert gpu.fused_dispatch_enabled() is True  # unset: fused by default
