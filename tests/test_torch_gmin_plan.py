"""The resident-tile plan shared by the port's scan kernels K1, K1-bf16, K2
and K3 (weaviate_tpu_torch/ops/gmin_scan.resident_plan), the index's
routing rule built on it, and K1's plain version against the JAX package's
Pallas kernel (interpret mode) at the live-slice counts that pick each tile
height. CPU only: tests/test_torch_kernels_cuda.py holds the kernels
against these plain versions on the card.

Tolerances, and why:
- group-min scores: rtol 1e-5, atol 1e-4 and the same +inf pattern: both
  sides multiply the same bf16-rounded operands (exact in f32) and sum in
  f32 in another order.
- index answers: ids exact (tie-free gaussian data), distances rtol 1e-5:
  both packages rescore in f32 and differ only in summation order.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.index import new_vector_index as jax_new_index
from weaviate_tpu.ops import gmin_scan as jgmin
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.index import new_vector_index as torch_new_index
from weaviate_tpu_torch.ops import gmin_scan as tgmin
from weaviate_tpu_torch.ops import pq_gmin as tpqg

G = 16
SMEM_LIMIT = 232_448  # shared memory one block may use on sm_90

# D -> tile rows N whatever the live slices; None: no plan
_PLANS = {30: 256, 128: 256, 384: 256, 392: 128, 768: 128, 1536: 64, 3072: 32, 6208: 16,
          6272: None}


def _slices(ag):
    return next(s for s in (1, 2, 4, 8, 16) if s >= ag)


def _smem(n, dp):
    """The tile, the 32 KB query ring, the bias of the widest tile, 1 KB
    of barriers and alignment."""
    return n * dp * 2 + 32768 + (4 * n if n == 256 else 0) + 1024


@pytest.mark.parametrize("d", sorted(_PLANS))
@pytest.mark.parametrize("ag", range(1, G + 1))
def test_resident_plan_values(d, ag):
    """S is the least power of two >= ag; the tile has the widest wgmma N
    (256 up to D 384, 128 up to D 768, 16 up to D 6208) whose rows fit
    beside the query ring, so SCG = N / S doubles as S halves. K2/K3's
    codes_plan is the same plan."""
    plan = tgmin.resident_plan(d, ag)
    assert tpqg.codes_plan(d, ag) == plan
    if _PLANS[d] is None:
        assert plan is None
        assert _smem(16, -(-d // 64) * 64) > SMEM_LIMIT
        return
    n = _PLANS[d]
    dp = -(-d // 64) * 64
    s = _slices(ag)
    assert plan == (s, n // s, dp, _smem(n, dp))
    assert plan.width == n and plan.smem <= SMEM_LIMIT
    if n < 256:  # a wider tile would not fit
        assert _smem(2 * n, dp) > SMEM_LIMIT


def test_resident_plan_options():
    """ag 1, 5 and 9 land on S = 1, 8, 16, and SCG doubles as S halves;
    workload A's depth (128) takes the N 256 tile (SCG 16 at 16 slices),
    workload B's (768) the N 128 tile."""
    assert tgmin.resident_plan(128, 16) == (16, 16, 128, _smem(256, 128))
    assert tgmin.resident_plan(128, 8) == (8, 32, 128, _smem(256, 128))
    assert [tgmin.resident_plan(768, ag).slices for ag in (1, 5, 9)] == [1, 8, 16]
    assert [tgmin.resident_plan(768, ag).scg for ag in (1, 5, 9)] == [128, 16, 8]
    assert [tgmin.tile_slices(ag) for ag in (0, 1, 2, 3, 4, 5, 8, 9, 16, 17)] == \
        [1, 1, 2, 4, 4, 8, 8, 16, 16, 16]


def test_group_min_scores_refuses_other_devices():
    """The wrapper runs the kernel on a CUDA tensor and the plain version on
    a CPU one; any other device is refused, never silently scanned."""
    q = torch.zeros((8, 32), device="meta")
    store3 = torch.zeros((G, 64, 32), device="meta")
    bias2 = torch.zeros((G, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgmin.group_min_scores(q, store3, bias2, -2.0)


@pytest.mark.parametrize("metric", ["l2-squared", "dot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [700, 4500, 8500, 16000])
def test_group_min_scores_matches_pallas_interpret_per_live_slices(metric, dtype, n):
    """K1's plain version against the Pallas kernel at 1, 5, 9 and 16 live
    slices (the tiles of S 1, 8 and 16), over an f32 and a bf16 store: the
    slots past n are dead, as in an index, so the reference's padding of
    the live slices to a multiple of 8 reads only +inf slots."""
    cap, d, b = 16384, 32, 16
    ncols = cap // G
    ag = -(-n // ncols)
    rng = np.random.default_rng(n)
    store = rng.standard_normal((cap, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    dead = np.arange(cap) >= n
    dead[rng.choice(n, n // 10, replace=False)] = True
    sq = (store.astype(np.float64) ** 2).sum(1).astype(np.float32)
    base, alpha = (sq, -2.0) if metric == "l2-squared" else (np.zeros(cap, np.float32), -1.0)
    bias2 = np.where(dead, np.inf, base).astype(np.float32).reshape(G, ncols)
    store3 = torch.from_numpy(store.reshape(G, ncols, d)).to(dtype)
    jstore = jnp.asarray(store3.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                        else jnp.float32)
    want = np.asarray(jgmin.group_min_scores(jnp.asarray(q), jstore, jnp.asarray(bias2), alpha,
                                             active_g=ag, interpret=True))
    before = tgmin.launches
    got = tgmin.group_min_scores(torch.from_numpy(q), store3, torch.from_numpy(bias2), alpha,
                                 active_g=ag).numpy()
    assert tgmin.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_use_gmin_routes_depths_without_a_plan(tmp_path):
    """_use_gmin's shape rule: a depth whose tile has no plan (D > 6208)
    takes the chunked scan; every depth up to it keeps the fast scan."""
    idx = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", {"distance": "dot"}),
                          str(tmp_path), device="cpu")
    for d, want in ((30, True), (768, True), (6208, True), (6209, False), (6272, False)):
        assert idx._use_gmin(SimpleNamespace(capacity=1 << 20, dim=d), 16, 10) is want


def test_index_past_the_plan_answers_like_jax(tmp_path, monkeypatch):
    """A D 6272 index (no resident plan) takes the chunked scan, never the
    group-min scan, and answers like the JAX index on the same inputs,
    which its VMEM plan sends to the same scan."""
    d, n, b, k = 6272, 400, 16, 10
    rng = np.random.default_rng(6272)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    conf = {"distance": "l2-squared"}
    tidx = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf),
                           str(tmp_path / "torch"), device="cpu")
    tidx.add_batch(np.arange(n), vecs)
    snap = tidx._read_snapshot()
    assert snap.capacity >= 16384 and not tidx._use_gmin(snap, tidx.padded_width(b), k)

    def refuse(*a, **kw):
        raise AssertionError("the group-min scan ran past the plan")

    monkeypatch.setattr(tgmin, "group_min_scores", refuse)
    got = tidx.search_by_vectors(q, k)
    tidx.shutdown()
    del tidx, snap
    jidx = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path / "jax"))
    jidx.add_batch(np.arange(n), vecs)
    want = jidx.search_by_vectors(q, k)
    jidx.shutdown()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
