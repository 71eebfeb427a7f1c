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


# -- the CUDA graph key of the gmin dispatch ----------------------------------
#
# On the card a gmin dispatch replays one CUDA graph per staging entry,
# keyed by `GpuVectorIndex._graph_key`. The key is a pure function of the
# snapshot and the dispatch, and the capture rule (`_graph_mode`) a pure
# function of the keys a bucket sees, so both hold here on CPU tensors,
# where no graph is ever captured.


def _graph_key(idx, snap, b=16, k=K, allow=None, ivf_plan=None):
    tier = idx.dispatch_tier(snap, allow)
    s2d = snap.slot_to_doc_dev if gpu.fused_dispatch_enabled() else None
    got = idx._graph_key(snap, tier, allow, ivf_plan, gpu._bucket_b(b), min(k, snap.live), s2d)
    return None if got is None else got[0]


GRAPH_TIERS = {"exact": {"distance": "cosine"}, "exact_dot": {"distance": "dot"},
               "exact_l2": {"distance": "l2-squared"},
               "pq_rescore": {"distance": "l2-squared", "pq": PQ}}


@pytest.mark.parametrize("tier", sorted(GRAPH_TIERS))
def test_graph_key_holds_across_read_only_dispatches(tmp_path, tier):
    idx, vecs, rng = _built(GRAPH_TIERS[tier], tmp_path)
    snap = idx._read_snapshot()
    key = _graph_key(idx, snap)
    assert key is not None
    for _ in range(3):
        idx.search_by_vectors(vecs[:16] + 0.01, K)
        again = idx._read_snapshot()
        assert again is snap and _graph_key(idx, again) == key
    gpu.set_fused_enabled(False)
    staged = _graph_key(idx, snap)
    assert staged is not None and staged != key  # fused and staged are two graphs


def _grow(idx, vecs):
    more, _ = _vecs(9, n=CAP)
    idx.add_batch(np.arange(N, N + CAP), more)  # 16384 -> 32768 slots
    assert idx.capacity > CAP


def _bump_gen(idx, vecs):
    idx._store_gen += 1
    idx._staged_gen += 1


CHANGES = {
    "add": lambda idx, vecs: idx.add(N + 5, vecs[7] + 0.5),
    "delete": lambda idx, vecs: idx.delete(100),
    "grow": _grow,
    "store_gen": _bump_gen,
}


@pytest.mark.parametrize("tier", ["exact", "pq_rescore"])
@pytest.mark.parametrize("change", sorted(CHANGES))
def test_graph_key_changes_with_the_snapshot(tmp_path, tier, change):
    """An add (n and the write generation), a delete (a new tombstone
    tensor), a growth (new tensors) and a bare write-generation bump each
    give another key."""
    idx, vecs, _ = _built(GRAPH_TIERS[tier], tmp_path)
    before = idx._read_snapshot()
    key = _graph_key(idx, before)
    tombs = before.tombs
    CHANGES[change](idx, vecs)
    after = idx._read_snapshot()
    assert after is not before
    assert _graph_key(idx, after) != key
    if change == "delete":
        assert after.tombs is not tombs and not tombs[100]


@pytest.mark.parametrize("what", ["k", "bb"])
def test_graph_key_changes_with_the_dispatch(tmp_path, what):
    idx, _, _ = _built({"distance": "cosine"}, tmp_path)
    snap = idx._read_snapshot()
    key = _graph_key(idx, snap)
    other = _graph_key(idx, snap, k=K + 1) if what == "k" else _graph_key(idx, snap, b=17)
    assert other is not None and other != key
    assert _graph_key(idx, snap, b=9) == key  # 9 and 16 rows share the bucket of 16


NO_GRAPH = {
    "allow_list": ({"distance": "cosine", "flatSearchCutoff": 500}, 16, BIG_ALLOW, None),
    "gather": ({"distance": "cosine", "flatSearchCutoff": 500}, 16, np.array([3, 7, 11]),
               None),
    "chunked_b3": ({"distance": "cosine"}, 3, None, None),
    "exact_topk": ({"distance": "cosine", "exactTopK": True}, 16, None, None),
    "manhattan": ({"distance": "manhattan"}, 16, None, None),
    "ivf": ({"distance": "cosine"}, 16, None, (8, 8)),
    "pq_codes": ({"distance": "dot", "pq": {**PQ, "rescore": False}}, 16, None, None),
    "pq4_funnel": ({"distance": "l2-squared", "pq": {**PQ, "bits": 4}}, 16, None, None),
}


@pytest.mark.parametrize("case", sorted(NO_GRAPH))
def test_filters_and_non_gmin_tiers_never_ask_for_a_graph(tmp_path, case):
    conf, b, allow, ivf_plan = NO_GRAPH[case]
    idx, _, _ = _built(conf, tmp_path)
    al = TorchBitmap(allow) if allow is not None else None
    assert _graph_key(idx, idx._read_snapshot(), b=b, allow=al, ivf_plan=ivf_plan) is None


def test_cpu_tensors_never_ask_for_a_graph(tmp_path):
    """On the CPU a gmin dispatch runs eagerly however often its key
    repeats: its `graph` fact reads eager and no key is remembered."""
    from weaviate_tpu_torch.monitoring import tracing

    idx, vecs, _ = _built({"distance": "cosine"}, tmp_path)
    assert _graph_key(idx, idx._read_snapshot()) is not None
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0))
    try:
        modes = []
        for _ in range(4):
            idx.search_by_vectors(vecs[:16] + 0.01, K)
            modes.append(idx.pop_dispatch_shape().graph)
    finally:
        tracing.unconfigure(tracer)
    assert modes == [gpu.GRAPH_EAGER] * 4
    assert idx._graph_seen == {}
    assert all(isinstance(e, np.ndarray) for lst in idx._stage_free.values() for e in lst)


class _Graph:
    """What `_capture_graph` leaves on an entry, as `_graph_mode` and
    `_release_stage` read it."""

    def __init__(self, key, gen=0, kept=True):
        self.key, self.gen, self.kept = key, gen, kept


class _Pool:
    """A graph pool as `_graph_mode` reads it: the bytes counted for it."""

    def __init__(self, nbytes=0):
        self.booked = [nbytes]


def _entry():
    return gpu._PinnedStage(torch.empty((16, D)))


def _drive(idx, keys, entries=4):
    """Run `_graph_mode` over the dispatch keys `keys` of one bucket, the
    pool's entries taken in turn, a capture leaving its graph and pool on
    the entry as `_capture_graph` does. -> the modes."""
    pool = [_entry() for _ in range(entries)]
    modes = []
    for i, key in enumerate(keys):
        entry = pool[i % entries]
        mode = idx._graph_mode(entry, (16, D), key)
        if mode == gpu.GRAPH_CAPTURE:
            if entry.pool is None:
                entry.pool = _Pool()
                idx._graph_seen[(16, D)].made += 1
            entry.graph = _Graph(key)
        modes.append(mode)
    return modes


@pytest.fixture
def roomy(monkeypatch):
    """A device budget of 1 GiB and no graph pool counted on it."""
    monkeypatch.setattr(gpu, "_graph_budget", lambda device: 1 << 30)
    monkeypatch.setattr(gpu, "_graph_bytes", {})


@pytest.mark.parametrize("life", [1, 4, 32, 33, 35, 60])
def test_graph_mode_captures_a_key_only_once_it_has_lived(tmp_path, roomy, life):
    """A key is captured once it has served `_GRAPH_AFTER` eager
    dispatches of its bucket; each of the four entries then captures once
    and replays after. A key that writes replace within `_GRAPH_AFTER`
    dispatches (searches beside an import) is never captured."""
    idx, _, _ = _built({"distance": "cosine"}, tmp_path)
    after = idx._GRAPH_AFTER
    assert after == 32
    modes = _drive(idx, [("key", i // life) for i in range(10 * life)])
    for n in range(10):
        got = modes[n * life:(n + 1) * life]
        eager = min(life, after)
        capture = min(4, life - eager)
        assert got == ([gpu.GRAPH_EAGER] * eager + [gpu.GRAPH_CAPTURE] * capture
                       + [gpu.GRAPH_REPLAY] * (life - eager - capture)), n
    if life <= after:
        assert gpu.GRAPH_CAPTURE not in modes
    assert idx._graph_seen[(16, D)].made == (4 if life > after else 0)


BUDGET_CASES = {
    # (the entry's pool bytes or None, the bucket's last pool bytes, pools
    # made, spare pool bytes or None, bytes counted on the device) -> capture?
    "fits": ((None, 1 << 20, 0, None, 0), True),
    "bucket_too_big": ((None, (1 << 30) + 1, 0, None, 0), False),
    "device_full": ((None, 1 << 20, 1, None, (1 << 30) - (1 << 19)), False),
    "own_pool_holds_it": ((1 << 20, 1 << 20, 1, None, 1 << 30), True),
    "no_pool_left": ((None, 1 << 20, 4, None, 0), False),
    "a_spare_pool": ((None, 1 << 20, 4, 1 << 20, 4 << 20), True),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_graph_mode_keeps_to_the_pools_and_the_device_budget(tmp_path, roomy, case):
    """A key that has lived long enough is captured only where the entry
    holds a graph pool, the bucket has a spare one or has made fewer than
    `_STAGE_POOL_CAP`, and the pool's growth to the bucket's last pool
    size fits what the device's budget has left."""
    (own, last, made, spare, held), want = BUDGET_CASES[case]
    idx, _, _ = _built({"distance": "cosine"}, tmp_path)
    gpu._graph_bytes[idx.device] = held
    seen = idx._graph_seen[(16, D)] = gpu._GraphBucket()
    seen.key, seen.served, seen.nbytes, seen.made = "key", idx._GRAPH_AFTER, last, made
    if spare is not None:
        seen.spare.append(_Pool(spare))
    entry = _entry()
    if own is not None:
        entry.pool = _Pool(own)
    mode = idx._graph_mode(entry, (16, D), "key")
    assert mode == (gpu.GRAPH_CAPTURE if want else gpu.GRAPH_EAGER)
    assert seen.served == idx._GRAPH_AFTER + (0 if want else 1)
    booked = [1 << 20]
    gpu._graph_bytes[idx.device] = held + booked[0]
    gpu._unbook_graph(idx.device, booked)
    assert gpu._graph_bytes[idx.device] == held


@pytest.mark.parametrize("graph", ["fresh", "stale", "refused", "turned_away"])
def test_release_drops_a_stale_or_refused_graph(tmp_path, graph):
    """An entry goes back to the pool without its graph when a publish
    since the capture made the graph stale, and without its graph pool too
    when the device's budget refused the pool (the graph served only the
    dispatch that captured it). An entry the full pool turns away leaves
    its graph pool to the bucket's spares."""
    idx, vecs, _ = _built({"distance": "cosine"}, tmp_path)
    gen = idx._read_snapshot().gen
    seen = idx._graph_seen[(16, D)] = gpu._GraphBucket()
    seen.made = 1
    entry = _entry()
    entry.pool = pool = _Pool(1 << 20)
    entry.graph = _Graph("key", gen=gen, kept=graph != "refused")
    if graph == "stale":
        idx.add(N + 5, vecs[7] + 0.5)
        assert idx._read_snapshot().gen != gen
    if graph == "turned_away":
        idx._stage_free[(16, D)] = [_entry() for _ in range(idx._STAGE_POOL_CAP)]
    idx._release_stage(entry)
    parked = idx._stage_free[(16, D)]
    assert (entry in parked) == (graph != "turned_away")
    assert (entry.graph is not None) == (graph == "fresh")
    assert (entry.pool is pool) == (graph in ("fresh", "stale"))
    assert seen.spare == ([pool] if graph == "turned_away" else [])
    assert seen.made == (0 if graph == "refused" else 1)
