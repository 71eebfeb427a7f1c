"""The port's CUDA kernels on the card: each against its plain torch
version, and the index on the card against the same index on the CPU.

Every test here is marked `cuda` and skips without a card. This file
imports neither jax nor weaviate_tpu, so it also runs where only the port
is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.index import gpu, new_vector_index
from weaviate_tpu_torch.ops import _kernels, gmin_scan, pq4, pq_gmin
from weaviate_tpu_torch.storage.bitmap import Bitmap
from weaviate_tpu_torch.tools import profile_gmin


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _dead_bias(rng, ncols, card):
    bias = torch.from_numpy(rng.standard_normal((16, ncols)).astype(np.float32)).to(card)
    bias[:, ::7] = float("inf")
    bias[:, ::5] = float("inf")  # every 35th group is dead in all slices
    return bias


def _scaled_queries(rng, b, d, card):
    """Gaussian queries, scaled past D = 768 so the products keep D = 768's
    magnitude: the f32 sums of the kernel and the plain version differ by
    about eps * sqrt(D) * |partial sums|, which the stated atol bounds at
    that magnitude."""
    q = rng.standard_normal((b, d)).astype(np.float32) * min(1.0, (768 / d) ** 0.5)
    return torch.from_numpy(q.astype(np.float32)).to(card)


# K1's resident plans (ops/gmin_scan.resident_plan): every tile width (N
# 256 up to D 384, 128 at D 392 and 768, 64 at 1536, 32 at 3072, 16 at
# the plan's limit D 6208), D 30 (D % 4 != 0: the element fills), ag 1, 5,
# 9, 16 (tiles of S 1, 8, 16 slices), B 8 and 65, ncols 1001 off every SCG
_K1_PLAN_SHAPES = [(8 if ag in (1, 9) else 65, 1001, d, ag)
                   for d in (30, 128, 384, 392, 768, 1536, 3072, 6208) for ag in (1, 5, 9, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,ag", [(16, 1024, 32, 3), (77, 1000, 129, 16),
                                          (5, 130, 30, 1), (300, 4096, 128, 16)]
                         + _K1_PLAN_SHAPES)
def test_gmin_kernel_matches_plain_version(card, b, ncols, d, ag):
    """Ragged edges included: B and ncols off the block tile, D off 16 and
    off 4 (the element fill), D over one 64-deep chunk, and every plan.
    Tolerance rtol 1e-4, atol 1e-3: the same bf16 operands, summed in f32
    by the tensor cores in another order."""
    rng = np.random.default_rng(b * d + ag)
    q = _scaled_queries(rng, b, d, card)
    x = torch.from_numpy(rng.standard_normal((16, ncols, d)).astype(np.float32)).to(card)
    bias = _dead_bias(rng, ncols, card)
    before = gmin_scan.launches
    got = gmin_scan.group_min_scores(q, x, bias, -2.0, active_g=ag)
    torch.cuda.synchronize()
    assert gmin_scan.launches == before + 1
    want = gmin_scan.group_min_scores_reference(q, x, bias, -2.0, active_g=ag)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,ag", [(16, 1024, 32, 3), (77, 1000, 136, 16),
                                          (5, 130, 30, 1), (300, 4096, 768, 16)]
                         + _K1_PLAN_SHAPES)
def test_gmin_kernel_bf16_store_matches_plain_version(card, b, ncols, d, ag):
    """K1's bf16-store filler: the 16-byte copy (D % 8 == 0) and the
    element copy (D = 30), ragged B and ncols, D over one 64-deep chunk,
    every plan. Same tolerance as the f32 store."""
    rng = np.random.default_rng(b * d + ag + 1)
    q = _scaled_queries(rng, b, d, card)
    x = torch.from_numpy(rng.standard_normal((16, ncols, d)).astype(np.float32)).to(card)
    x = x.to(torch.bfloat16)
    bias = _dead_bias(rng, ncols, card)
    before = gmin_scan.launches
    got = gmin_scan.group_min_scores(q, x, bias, -1.0, active_g=ag)
    torch.cuda.synchronize()
    assert gmin_scan.launches == before + 1
    want = gmin_scan.group_min_scores_reference(q, x, bias, -1.0, active_g=ag)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


# (B, ncols, D, M, C, ag): ds = 4 (element path), 8 and 16 (16-byte path),
# 25 (segments straddle the 64-deep chunks), 1 (the tile encoder's M = D)
_CODES_SHAPES = [(16, 1024, 32, 8, 32, 3), (77, 1000, 768, 96, 256, 16),
                 (9, 130, 200, 8, 200, 2), (40, 700, 64, 64, 16, 5),
                 (300, 4096, 128, 8, 256, 16)]
# the resident tile's plans (ops/pq_gmin.codes_plan at 16 live slices): SCG
# 8 (D 768), 4 (D 1024, 1536), 2 (D 3072), 1 at the plan's limit (D 6208);
# D = 30 with ds = 3 (the padded query path, SCG 16); B 8 and 65, ncols off
# every SCG, ag 1, 5, 16
_PLAN_SHAPES = [(65, 1001, 768, 96, 256, 16), (8, 1001, 1024, 128, 256, 5),
                (65, 300, 1536, 96, 64, 1), (8, 257, 3072, 96, 32, 16),
                (65, 101, 6208, 194, 16, 5), (8, 1001, 30, 10, 200, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,m,c,ag", _CODES_SHAPES + _PLAN_SHAPES)
@pytest.mark.parametrize("alpha", [-2.0, -1.0])
def test_pq8_kernel_matches_plain_version(card, b, ncols, d, m, c, ag, alpha):
    """K2 against its plain version; tolerance as K1's (the same bf16
    operands summed in another order)."""
    rng = np.random.default_rng(b * m)
    q = _scaled_queries(rng, b, d, card)
    codes = torch.from_numpy(rng.integers(0, c, (16, ncols, m)).astype(np.uint8)).to(card)
    cb = torch.from_numpy(rng.standard_normal((m, c, d // m)).astype(np.float32)).to(card)
    cb = cb.to(torch.bfloat16)
    bias = _dead_bias(rng, ncols, card)
    before = pq_gmin.launches
    got = pq_gmin.pq_group_min_scores(q, codes, bias, cb, alpha, active_g=ag)
    torch.cuda.synchronize()
    assert pq_gmin.launches == before + 1
    want = pq_gmin.pq_group_min_scores_reference(q, codes, bias, cb, alpha, active_g=ag)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,m,c,ag",
                         [s for s in _CODES_SHAPES + _PLAN_SHAPES if s[3] % 2 == 0])
def test_pq4_kernel_matches_plain_version(card, b, ncols, d, m, c, ag):
    """K3 against its plain version over nibble-packed codes."""
    rng = np.random.default_rng(b * m + 1)
    q = _scaled_queries(rng, b, d, card)
    packed = torch.from_numpy(rng.integers(0, 256, (16, ncols, m // 2)).astype(np.uint8)).to(card)
    cb = torch.from_numpy(rng.standard_normal((m, 16, d // m)).astype(np.float32)).to(card)
    cb = cb.to(torch.bfloat16)
    bias = _dead_bias(rng, ncols, card)
    before = pq4.launches
    got = pq4.pq4_group_min_scores(q, packed, bias, cb, -2.0, active_g=ag)
    torch.cuda.synchronize()
    assert pq4.launches == before + 1
    want = pq4.pq4_group_min_scores_reference(q, packed, bias, cb, -2.0, active_g=ag)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_codes_kernels_raise_past_the_plan(card):
    """A depth whose store tile fits in no plan (D 6272: 16 x 6272 bf16 is
    over 227 KB with the ring) is refused on the card, never served by a
    plain version; the routers send such shapes to the other scans."""
    q = torch.zeros((8, 6272), device=card)
    bias = torch.zeros((16, 64), device=card)
    for fn, nb, c in ((pq_gmin.pq_group_min_scores, 98, 16),
                      (pq4.pq4_group_min_scores, 49, 16)):
        codes = torch.zeros((16, 64, nb), dtype=torch.uint8, device=card)
        cb = torch.zeros((98, c, 64), dtype=torch.bfloat16, device=card)
        with pytest.raises(ValueError, match="does not fit"):
            fn(q, codes, bias, cb, -1.0)


@pytest.mark.cuda
def test_gmin_kernel_raises_past_the_plan(card):
    """K1 at a depth with no resident plan (D 6272) is refused on the card
    for either store, never served by its plain version and never
    counted; `_use_gmin` routes such depths to the chunked scan."""
    q = torch.zeros((8, 6272), device=card)
    bias = torch.zeros((16, 64), device=card)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros((16, 64, 6272), dtype=dtype, device=card)
        before = gmin_scan.launches
        with pytest.raises(ValueError, match="does not fit"):
            gmin_scan.group_min_scores(q, x, bias, -1.0)
        assert gmin_scan.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("pq,counter", [({"rescore": True}, gmin_scan),
                                        ({"rescore": False}, pq_gmin),
                                        ({"bits": 4}, pq4)])
def test_compressed_index_on_card_matches_cpu(card, tmp_path, pq, counter):
    """A compressed index on the card and the same on the CPU, from the
    same codebook (the card restarts from the CPU index's pq.npz): equal
    ids for the kernel tier (B=16), the B=1 tier and a masked allowList;
    distances rtol 1e-5."""
    rng = np.random.default_rng(1)
    vecs = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    cfg = {"distance": "l2-squared", "flatSearchCutoff": 500,
           "pq": {"enabled": True, "segments": 8, "centroids": 32, **pq}}
    cpu = new_vector_index(vi.parse_and_validate_config("hnsw_tpu", cfg), str(tmp_path), device="cpu")
    cpu.add_batch(np.arange(3000), vecs)
    cpu.delete(*range(0, 60, 3))
    cpu.shutdown()
    idx = {dev: new_vector_index(vi.parse_and_validate_config("hnsw_tpu", cfg), str(tmp_path),
                                 device=dev) for dev in ("cpu", "cuda")}
    before = counter.launches
    for b, allow in ((16, None), (1, None), (16, Bitmap(np.arange(0, 3000, 2)))):
        got = idx["cuda"].search_by_vectors(q[:b], 10, allow_list=allow)
        want = idx["cpu"].search_by_vectors(q[:b], 10, allow_list=allow)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert counter.launches == before + 2  # B=16 unfiltered and masked


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot"])
def test_index_on_card_matches_cpu(card, tmp_path, metric):
    """The same index on the card and on the CPU: equal ids on tie-free
    data, for the kernel path (B=16), the chunked scan (B=1), a masked
    allowList and the gather tier; distances rtol 1e-5 (f32 rescores)."""
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    cfg = vi.parse_and_validate_config("hnsw_tpu", {"distance": metric, "flatSearchCutoff": 500})
    idx = {dev: new_vector_index(cfg, str(tmp_path / dev), device=dev) for dev in ("cuda", "cpu")}
    for ix in idx.values():
        ix.add_batch(np.arange(3000), vecs)
        ix.delete(*range(0, 60, 3))
    before = gmin_scan.launches
    for b, allow in ((16, None), (1, None), (16, Bitmap(np.arange(0, 3000, 2))),
                     (16, Bitmap(np.arange(0, 3000, 11)))):
        got = idx["cuda"].search_by_vectors(q[:b], 10, allow_list=allow)
        want = idx["cpu"].search_by_vectors(q[:b], 10, allow_list=allow)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert gmin_scan.launches == before + 2  # B=16 unfiltered and masked


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,g", [(16, 1024, 32, 16), (77, 1000, 129, 16),
                                         (5, 130, 30, 3), (300, 4096, 128, 16)])
@pytest.mark.parametrize("alpha", [-2.0, -1.0])
def test_nt_kernel_matches_plain_version(card, b, ncols, d, g, alpha):
    """K4 over a transposed store: ragged B and ncols, the scalar staging
    path (ncols % 4 != 0), D off 16 and over one staged depth. Same
    tolerance as K1, and against K1 on the untransposed store."""
    rng = np.random.default_rng(b + ncols)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((g, ncols, d)).astype(np.float32)).to(card)
    bias = _dead_bias(rng, ncols, card)[:g].contiguous()
    xt = profile_gmin.transpose_store(x)
    before = profile_gmin.nt_launches
    got = profile_gmin.nt_scores(q, xt, bias, alpha)
    torch.cuda.synchronize()
    assert profile_gmin.nt_launches == before + 1
    want = profile_gmin.nt_scores_reference(q, xt, bias, alpha)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    k1 = gmin_scan.group_min_scores(q, x, bias, alpha, active_g=g)
    assert torch.equal(torch.isinf(got), torch.isinf(k1))
    torch.testing.assert_close(got, k1, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,scg", [(16, 1024, 32, 64), (77, 960, 129, 64),
                                           (5, 320, 30, 64), (300, 4096, 128, 128),
                                           (33, 1024, 64, 256), (9, 1536, 136, 256)])
@pytest.mark.parametrize("gc", [2, 4])
def test_c4_kernel_matches_plain_version(card, b, ncols, d, scg, gc):
    """K5 over the interleaved store: scg 64 (ncols ragged against the
    128-column tile), 128 and 256, gc 2 and 4, ragged B, D off 16 and over
    one staged depth. Same tolerance as K1, and against K1."""
    rng = np.random.default_rng(b * gc + scg)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((16, ncols, d)).astype(np.float32)).to(card)
    bias = _dead_bias(rng, ncols, card)
    s4, b4 = profile_gmin.interleave(profile_gmin.transpose_store(x), bias, gc, scg)
    before = profile_gmin.c4_launches.get(gc, 0)
    got = profile_gmin.c4_scores(q, s4, b4, -2.0, scg, gc)
    torch.cuda.synchronize()
    assert profile_gmin.c4_launches[gc] == before + 1
    want = profile_gmin.c4_scores_reference(q, s4, b4, -2.0, scg, gc)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    k1 = gmin_scan.group_min_scores(q, x, bias, -2.0)
    assert torch.equal(torch.isinf(got), torch.isinf(k1))
    torch.testing.assert_close(got, k1, rtol=1e-4, atol=1e-3)


# (kind, B, ncols, D, groups, gc, iw): the N 128 plan (D 500, bias in
# registers); tiles of S below 16 (K4 g 3 at SCG 64, K5 nslice * gc 8 at
# SCG 32); interleave widths under the tile's SCG 16 (iw 4 on the float4
# path, iw 2 on the element path); SCG 2 and 1 (D 3072, 6208: the element
# path, the plan's limit)
_LAYOUT_PLAN_SHAPES = [("nt", 40, 1000, 500, 16, 1, 0), ("c4", 40, 1024, 500, 16, 2, 64),
                       ("nt", 33, 1000, 128, 3, 1, 0), ("c4", 65, 1024, 64, 8, 2, 128),
                       ("c4", 17, 960, 129, 8, 4, 64), ("c4", 65, 1024, 128, 16, 4, 4),
                       ("c4", 9, 1000, 128, 16, 2, 2), ("nt", 8, 257, 3072, 16, 1, 0),
                       ("nt", 8, 101, 6208, 16, 1, 0), ("c4", 8, 128, 6208, 16, 4, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,b,ncols,d,groups,gc,iw", _LAYOUT_PLAN_SHAPES)
def test_layout_kernels_on_other_plans(card, kind, b, ncols, d, groups, gc, iw):
    """K4 and K5 on plans other than the profiler's: against their plain
    versions and against K1 on the untransposed store, the same tolerance
    and the same +inf groups."""
    rng = np.random.default_rng(b * d + groups + iw)
    q = _scaled_queries(rng, b, d, card)
    x = torch.from_numpy(rng.standard_normal((groups, ncols, d)).astype(np.float32)).to(card)
    bias = _dead_bias(rng, ncols, card)[:groups].contiguous()
    xt = profile_gmin.transpose_store(x)
    if kind == "nt":
        before = profile_gmin.nt_launches
        got = profile_gmin.nt_scores(q, xt, bias, -2.0)
        torch.cuda.synchronize()
        assert profile_gmin.nt_launches == before + 1
        want = profile_gmin.nt_scores_reference(q, xt, bias, -2.0)
    else:
        s4, b4 = profile_gmin.interleave(xt, bias, gc, iw)
        before = profile_gmin.c4_launches.get(gc, 0)
        got = profile_gmin.c4_scores(q, s4, b4, -2.0, iw, gc)
        torch.cuda.synchronize()
        assert profile_gmin.c4_launches[gc] == before + 1
        want = profile_gmin.c4_scores_reference(q, s4, b4, -2.0, iw, gc)
    k1 = gmin_scan.group_min_scores(q, x, bias, -2.0)
    for ref in (want, k1):
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_layout_kernels_raise_past_the_plan(card):
    """K4 and K5 at a depth with no resident plan (D 6272) raise before
    any launch, never served by a plain version and never counted."""
    q = torch.zeros((8, 6272), device=card)
    before = (profile_gmin.nt_launches, dict(profile_gmin.c4_launches))
    with pytest.raises(ValueError, match="does not fit"):
        profile_gmin.nt_scores(q, torch.zeros((16, 6272, 64), device=card),
                               torch.zeros((16, 64), device=card), -1.0)
    with pytest.raises(ValueError, match="does not fit"):
        profile_gmin.c4_scores(q, torch.zeros((8, 6272, 128), device=card),
                               torch.zeros((8, 128), device=card), -1.0, 64, 2)
    assert (profile_gmin.nt_launches, profile_gmin.c4_launches) == before


@pytest.mark.cuda
def test_layout_kernels_raise_when_the_launch_or_the_build_fails(card, monkeypatch, tmp_path):
    """No fallback: a launch the kernel refuses (a tile of 512 rows, no
    wgmma width) raises and is not counted, and so does a source that does
    not build."""
    q = torch.zeros((8, 128), device=card)
    xt = torch.zeros((16, 128, 64), device=card)
    bias = torch.zeros((16, 64), device=card)
    bad = gmin_scan.resident_plan(128, 16)._replace(scg=32)
    monkeypatch.setattr(profile_gmin, "layout_plan", lambda d, groups: bad)
    before = profile_gmin.nt_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        profile_gmin.nt_scores(q, xt, bias, -1.0)
    assert profile_gmin.nt_launches == before
    (tmp_path / "gmin_layouts.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(profile_gmin, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        profile_gmin.nt_scores(q, xt, bias, -1.0)
    assert profile_gmin.nt_launches == before


@pytest.mark.cuda
def test_staged_dispatch_on_card_equals_fused(card, tmp_path):
    """The toggle off on the card: the same ids and distances, bit for
    bit, on the kernel tier, the chunked scan and the gather tier."""
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    cfg = vi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared",
                                                    "flatSearchCutoff": 500})
    idx = new_vector_index(cfg, str(tmp_path))
    idx.add_batch(np.arange(3000), vecs)
    try:
        for b, allow in ((16, None), (1, None), (16, Bitmap(np.arange(0, 3000, 11)))):
            gpu.set_fused_enabled(True)
            fused = idx.search_by_vectors(q[:b], 10, allow_list=allow)
            gpu.set_fused_enabled(False)
            staged = idx.search_by_vectors(q[:b], 10, allow_list=allow)
            np.testing.assert_array_equal(staged[0], fused[0])
            np.testing.assert_array_equal(staged[1], fused[1])
    finally:
        gpu.set_fused_enabled(None)


@pytest.mark.cuda
def test_real_cuda_out_of_memory_is_a_device_error(card):
    """An allocation the card cannot hold raises torch.OutOfMemoryError, and
    the breaker's classifier counts it as a device fault."""
    from weaviate_tpu_torch.serving import robustness

    with pytest.raises(torch.OutOfMemoryError) as err:
        torch.empty(1 << 50, dtype=torch.uint8, device=card)
    assert robustness.is_device_error(err.value)


# words of the CUDA runtime's own message for each code of
# _kernels.DEVICE_FAULT_CODES (cudaGetErrorString), and for codes of a
# refused call, which are not in it
_FAULT_WORDS = {2: "memory", 3: "initialization", 46: "unavailable", 100: "no cuda-capable",
                214: "ecc", 220: "nvlink", 700: "illegal memory access", 702: "timed out",
                709: "destroyed", 710: "assert", 714: "stack", 715: "illegal instruction",
                716: "misaligned", 717: "address space", 718: "program counter",
                719: "launch failure"}
_CALL_WORDS = {1: "invalid argument", 9: "invalid configuration", 701: "too many resources"}


@pytest.mark.cuda
def test_kernel_error_codes_are_the_runtimes_card_faults(card, monkeypatch):
    """DEVICE_FAULT_CODES are the runtime's codes of card faults, read back
    through the kernel library's own cudaGetErrorString; a launch the
    kernel refuses (a tile of 512 rows) raises KernelCallError, which is
    not a device error."""
    from weaviate_tpu_torch.serving import robustness

    lib = gmin_scan._gmin_lib()
    assert set(_FAULT_WORDS) == _kernels.DEVICE_FAULT_CODES
    for words, fault in ((_FAULT_WORDS, True), (_CALL_WORDS, False)):
        for rc, word in words.items():
            text = lib.gmin_scan_error_string(rc).decode()
            assert word in text.lower(), (rc, text)
            assert (rc in _kernels.DEVICE_FAULT_CODES) is fault
    bad = gmin_scan.resident_plan(128, 16)._replace(scg=32)
    monkeypatch.setattr(profile_gmin, "layout_plan", lambda d, groups: bad)
    with pytest.raises(_kernels.KernelCallError, match="launch failed") as err:
        profile_gmin.nt_scores(torch.zeros((8, 128), device=card),
                               torch.zeros((16, 128, 64), device=card),
                               torch.zeros((16, 64), device=card), -1.0)
    assert not robustness.is_device_error(err.value)


@pytest.mark.cuda
def test_pinned_staging_buffer_is_not_reused_before_its_fetch(card, tmp_path):
    """Two back-to-back async dispatches of different queries each get
    their own answer: the second checkout does not receive the buffer the
    first upload may still read. The pool's buffers are pinned and go back
    only after the fetches."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((20000, 64)).astype(np.float32)
    q1, q2 = (rng.standard_normal((16, 64)).astype(np.float32) for _ in range(2))
    idx = new_vector_index(vi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                           str(tmp_path / "i"), device=card)
    idx.add_batch(np.arange(len(x)), x)
    want1, want2 = idx.search_by_vectors(q1, 10), idx.search_by_vectors(q2, 10)
    parked = idx._stage_free[(16, 64)]
    assert len(parked) == 1 and parked[0].buf.is_pinned()
    f1 = idx.search_by_vectors_async(q1, 10)  # takes the parked buffer
    assert idx._stage_free[(16, 64)] == []
    f2 = idx.search_by_vectors_async(q2, 10)  # must not get it back
    got2, got1 = f2(), f1()
    for got, want in ((got1, want1), (got2, want2)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert len(idx._stage_free[(16, 64)]) == 2
    assert idx.health()["memory"]["host_components"]["stage_buffers"] == 2 * 16 * 64 * 4
    idx.drop()
    assert idx._stage_free == {}


@pytest.mark.cuda
def test_bf16_store_k1_matches_plain_version_through_the_index(card, tmp_path):
    """`storeDtype: bfloat16`: the index's store is bf16 on the card, its
    search launches K1's bf16 filler on the store itself, and that kernel
    equals its plain version (rtol 1e-4, atol 1e-3); the card's answer
    matches the same index on the CPU."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((40000, 128)).astype(np.float32)
    q = rng.standard_normal((64, 128)).astype(np.float32)
    cfg = vi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared",
                                                    "storeDtype": "bfloat16"})
    idx = {dev: new_vector_index(cfg, str(tmp_path / dev), device=dev) for dev in ("cuda", "cpu")}
    for i in idx.values():
        i.add_batch(np.arange(len(x)), x)
    snap = idx["cuda"]._read_snapshot()
    assert snap.store.dtype == torch.bfloat16
    ncols = snap.capacity // gmin_scan.G
    ag = -(-snap.n // ncols)
    bias2, alpha = gmin_scan.scan_bias(snap.tombs, snap.n, snap.sq_norms, None, False,
                                       vi.DISTANCE_L2)
    store3 = snap.store.view(gmin_scan.G, ncols, 128)
    qd = torch.from_numpy(q).to(card)
    got = gmin_scan.group_min_scores(qd, store3, bias2, alpha, active_g=ag)
    want = gmin_scan.group_min_scores_reference(qd, store3, bias2, alpha, ag)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    before = gmin_scan.launches
    ids, dists = idx["cuda"].search_by_vectors(q, 10)
    assert gmin_scan.launches == before + 1
    ids_c, dists_c = idx["cpu"].search_by_vectors(q, 10)
    np.testing.assert_array_equal(ids, ids_c)
    np.testing.assert_allclose(dists, dists_c, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_app_on_card_under_concurrent_rest_and_the_coalescer(card, tmp_path):
    """The port's App on the card with the coalescer on: 16 REST client
    threads send single-query GraphQL nearVector requests at once, so the
    handler threads, the coalescer's flusher and the pinned staging pool
    all reach one index. Every answer equals the same App's sequential
    answer on the CPU (ids equal, distances rtol 1e-5, atol 1e-5), the
    lanes merge requests, and K1 runs."""
    import json
    import threading
    import urllib.request
    import uuid as uuidlib

    from weaviate_tpu_torch.config import Config
    from weaviate_tpu_torch.server import App, RestServer

    rng = np.random.default_rng(21)
    x = rng.standard_normal((20000, 64)).astype(np.float32)
    qs = rng.standard_normal((128, 64)).astype(np.float32)
    apps = {}
    for name, dev in (("card", card), ("cpu", "cpu")):
        cfg = Config()
        cfg.coalescer.enabled = True
        cfg.coalescer.window_ms = 20.0
        app = App(config=cfg, data_path=str(tmp_path / name), device=dev)
        app.schema.add_class({"class": "Doc", "vectorIndexType": "hnsw_tpu",
                              "vectorIndexConfig": {"distance": "l2-squared"},
                              "properties": [{"name": "rank", "dataType": ["int"]}]})
        app.batch.add_objects([{"class": "Doc", "id": str(uuidlib.UUID(int=i + 1)),
                                "properties": {"rank": i}, "vector": x[i].tolist()}
                               for i in range(len(x))])
        srv = RestServer(app, port=0)
        srv.start()
        apps[name] = (app, srv)

    def near(port, q):
        body = {"query": "{ Get { Doc(nearVector: {vector: %s}, limit: 10) "
                         "{ _additional { id distance } } } }" % json.dumps(q.tolist())}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/graphql",
                                     data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            rows = json.loads(r.read())["data"]["Get"]["Doc"]
        return ([r["_additional"]["id"] for r in rows],
                np.array([r["_additional"]["distance"] for r in rows]))

    try:
        want = [near(apps["cpu"][1].port, q) for q in qs]
        got = [None] * len(qs)
        launches0 = gmin_scan.launches

        def client(t):
            for i in range(t, len(qs), 16):
                got[i] = near(apps["card"][1].port, qs[i])

        threads = [threading.Thread(target=client, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for g, w in zip(got, want):
            assert g is not None and g[0] == w[0]
            np.testing.assert_allclose(g[1], w[1], rtol=1e-5, atol=1e-5)
        st = apps["card"][0].coalescer.stats()
        assert st["requests"] == len(qs) and st["dispatches"] < len(qs)
        assert gmin_scan.launches > launches0
    finally:
        for app, srv in apps.values():
            srv.stop()
            app.shutdown()


@pytest.mark.cuda
def test_launch_runs_under_the_tensors_device(card, monkeypatch):
    """K1 and K2 launch with the tensor's device current (the C entry
    points launch on the thread's current device). With a second card the
    tensors sit on cuda:1 while cuda:0 is current, and the answers equal
    the plain versions there; with one card the launch still runs inside a
    guard naming the tensor's device."""
    dev = torch.device("cuda", 1) if torch.cuda.device_count() > 1 else card
    seen = []
    real_k1, real_k2 = gmin_scan._gmin_lib(), pq_gmin.codes_lib()

    class _Proxy:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            fn = getattr(self._lib, name)
            if not name.endswith("_launch"):
                return fn

            def launch(*args):
                seen.append(torch.cuda.current_device())
                return fn(*args)
            return launch

    monkeypatch.setattr(gmin_scan, "_gmin_lib", lambda: _Proxy(real_k1))
    monkeypatch.setattr(pq_gmin, "codes_lib", lambda: _Proxy(real_k2))
    rng = np.random.default_rng(5)
    b, ncols, d, m, c = 64, 1024, 128, 16, 256
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    store3 = torch.from_numpy(rng.standard_normal((16, ncols, d)).astype(np.float32)).to(dev)
    bias = _dead_bias(rng, ncols, dev)
    codes3 = torch.from_numpy(rng.integers(0, c, (16, ncols, m)).astype(np.uint8)).to(dev)
    cb = torch.from_numpy(rng.standard_normal((m, c, d // m)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    with torch.cuda.device(card):
        got1 = gmin_scan.group_min_scores(q, store3, bias, -2.0)
        got2 = pq_gmin.pq_group_min_scores(q, codes3, bias, cb, -1.0)
    torch.testing.assert_close(got1, gmin_scan.group_min_scores_reference(q, store3, bias, -2.0),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got2, pq_gmin.pq_group_min_scores_reference(q, codes3, bias, cb,
                                                                           -1.0),
                               rtol=1e-4, atol=1e-3)
    assert seen == [dev.index, dev.index]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_on_card_matches_cpu(card, tmp_path, dtype):
    """The mesh index over four slabs on the card (one card named four
    times) and over four CPU slabs: equal ids on tie-free data for K1 per
    slab (B 16, slabs of 16384 rows), the chunked scan (B 1) and a masked
    allowList, fused and staged; K1 launches once per slab."""
    from weaviate_tpu_torch.index.mesh import MeshVectorIndex
    from weaviate_tpu_torch.parallel.mesh_search import make_mesh

    rng = np.random.default_rng(6)
    vecs = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    cfg = {"distance": "l2-squared", "storeDtype": dtype}
    idx = {dev: MeshVectorIndex(vi.parse_and_validate_config("hnsw_tpu_mesh", cfg),
                                str(tmp_path / dev), mesh=make_mesh(devices=[dev] * 4),
                                initial_capacity_per_shard=16384)
           for dev in ("cuda", "cpu")}
    for ix in idx.values():
        ix.add_batch(np.arange(6000), vecs)
        ix.delete(*range(0, 90, 3))
    for fused in (True, False):
        gpu.set_fused_enabled(fused)
        try:
            before = gmin_scan.launches
            for b, allow in ((16, None), (1, None), (16, Bitmap(np.arange(0, 6000, 2)))):
                got = idx["cuda"].search_by_vectors(q[:b], 10, allow_list=allow)
                want = idx["cpu"].search_by_vectors(q[:b], 10, allow_list=allow)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-4)
            assert gmin_scan.launches == before + 8  # 4 slabs x (unfiltered, masked)
        finally:
            gpu.set_fused_enabled(None)


# -- the gmin dispatch as one CUDA graph per staging entry ---------------------
#
# A gmin dispatch on the card replays one CUDA graph per staging entry
# once its key (`GpuVectorIndex._graph_key`) has served `_GRAPH_AFTER`
# eager dispatches unchanged: the next one captures, later ones replay.
# Every answer is held bit for bit against the eager path's.

_GRAPH_D, _GRAPH_N = 64, 20000
_GRAPH_CONFS = {
    "cosine": {"distance": "cosine"},
    "dot": {"distance": "dot"},
    "l2": {"distance": "l2-squared"},
    "pq_rescore": {"distance": "l2-squared",
                   "pq": {"enabled": True, "segments": 8, "centroids": 32}},
}


@pytest.fixture
def tracer():
    from weaviate_tpu_torch.monitoring import tracing

    t = tracing.configure(tracing.Tracer(sample_rate=1.0))
    yield t
    tracing.unconfigure(t)


def _graph_index(card, path, conf, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((_GRAPH_N, _GRAPH_D)).astype(np.float32)
    idx = new_vector_index(vi.parse_and_validate_config("hnsw_tpu", conf), str(path),
                           device=card)
    idx.add_batch(np.arange(_GRAPH_N), x)
    idx.delete(*range(0, 90, 3))
    return idx, x, rng


def _searches(idx, q, times, k=10):
    """-> (answers, graph facts) of `times` searches of q in a row."""
    outs, modes = [], []
    for _ in range(times):
        outs.append(idx.search_by_vectors(q, k))
        modes.append(idx.pop_dispatch_shape().graph)
    return outs, modes


def _warm(idx, q, replays=1, k=10):
    """-> (answers, graph facts) of the searches of q that take one staging
    entry from its key's first dispatch through its capture and `replays`
    replays."""
    return _searches(idx, q, idx._GRAPH_AFTER + 1 + replays, k)


def _warm_modes(idx, replays=1):
    return ["eager"] * idx._GRAPH_AFTER + ["capture"] + ["replay"] * replays


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))


def _eager(idx, monkeypatch, q, k=10):
    """The eager path's answer on the current snapshot."""
    with monkeypatch.context() as m:
        m.setattr(idx, "_graph_key", lambda *a: None)
        return idx.search_by_vectors(q, k)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("conf", sorted(_GRAPH_CONFS))
def test_graph_replay_equals_eager(card, tmp_path, tracer, conf, fused):
    """f32 cosine, dot and l2, and the PQ rescore tier (K1-bf16 over the
    bf16 copy), fused and staged: eager, capture and replay give the same
    ids and distances, bit for bit."""
    idx, x, rng = _graph_index(card, tmp_path, _GRAPH_CONFS[conf])
    assert idx.compressed == (conf == "pq_rescore")
    gpu.set_fused_enabled(fused)
    try:
        q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
        outs, modes = _warm(idx, q, replays=2)
    finally:
        gpu.set_fused_enabled(None)
    assert modes == _warm_modes(idx, replays=2)
    for got in outs[1:]:
        _assert_same(got, outs[0])
    (entry,) = idx._stage_free[(16, _GRAPH_D)]
    assert entry.graph is not None


def _add(idx, x, rng):
    idx.add_batch(np.arange(_GRAPH_N, _GRAPH_N + 100),
                  rng.standard_normal((100, _GRAPH_D)).astype(np.float32))


def _delete(idx, x, rng):
    idx.delete(*range(1000, 1100))


def _grow(idx, x, rng):
    cap = idx.capacity
    idx.add_batch(np.arange(10 ** 6, 10 ** 6 + cap),
                  rng.standard_normal((cap, _GRAPH_D)).astype(np.float32))
    assert idx.capacity > cap


@pytest.mark.cuda
@pytest.mark.parametrize("conf", ["cosine", "pq_rescore"])
def test_graph_recaptures_after_writes_and_matches_eager(card, tmp_path, tracer,
                                                         monkeypatch, conf):
    """After an add, a delete and a growth, no stale graph replays: the
    parked one is dropped, the new key runs eagerly until it has lived
    long enough, then captures, and every answer equals the eager path's
    on the new snapshot."""
    idx, x, rng = _graph_index(card, tmp_path, _GRAPH_CONFS[conf])
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    assert _warm(idx, q)[1] == _warm_modes(idx)
    for change in (_add, _delete, _grow):
        change(idx, x, rng)
        want = _eager(idx, monkeypatch, q)
        assert all(e.graph is None for e in idx._stage_free[(16, _GRAPH_D)]), change
        outs, modes = _warm(idx, q)
        assert modes == _warm_modes(idx), change
        for got in outs:
            _assert_same(got, want)


@pytest.mark.cuda
def test_graph_capture_while_four_threads_dispatch(card, tmp_path, monkeypatch):
    """Four threads search their own queries (16 rows) while a fifth runs
    new bucket shapes, each its eager dispatches, a capture and a replay:
    every answer equals the eager path's."""
    import threading

    idx, x, rng = _graph_index(card, tmp_path, {"distance": "cosine"})
    qs = [rng.standard_normal((16, _GRAPH_D)).astype(np.float32) for _ in range(4)]
    wants = [_eager(idx, monkeypatch, q) for q in qs]
    sizes = (64, 256, 1024, 2048, 3072, 4096)
    big = {b: rng.standard_normal((b, _GRAPH_D)).astype(np.float32) for b in sizes}
    big_wants = {b: _eager(idx, monkeypatch, q) for b, q in big.items()}
    done, errors, modes = threading.Event(), [], []

    def reader(q, want):
        try:
            n = 0
            while not done.is_set() or n < 20:
                got = idx.search_by_vectors(q, 10)
                _assert_same(got, want)
                n += 1
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    def capturer():
        from weaviate_tpu_torch.monitoring import tracing

        t = tracing.configure(tracing.Tracer(sample_rate=1.0))
        try:
            for b in sizes:
                outs, m = _warm(idx, big[b])
                modes.extend(m)
                for got in outs:
                    _assert_same(got, big_wants[b])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            tracing.unconfigure(t)
            done.set()

    threads = [threading.Thread(target=reader, args=(q, w)) for q, w in zip(qs, wants)]
    threads.append(threading.Thread(target=capturer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert modes.count("capture") == len(sizes)


@pytest.mark.cuda
def test_graph_replay_counts_one_k1_launch(card, tmp_path, tracer):
    idx, x, rng = _graph_index(card, tmp_path, {"distance": "dot"})
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    before = gmin_scan.launches
    assert _warm(idx, q, replays=0)[1] == _warm_modes(idx, replays=0)
    warm = idx._GRAPH_AFTER + 1
    assert gmin_scan.launches == before + warm
    assert _searches(idx, q, 5)[1] == ["replay"] * 5
    assert gmin_scan.launches == before + warm + 5


@pytest.mark.cuda
def test_no_graph_replays_after_drop(card, tmp_path, tracer, monkeypatch):
    """drop() takes the parked graphs and the remembered keys with it: a
    refill of the same shape starts eager again and answers from the new
    rows."""
    idx, x, rng = _graph_index(card, tmp_path, {"distance": "l2-squared"})
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    assert _warm(idx, q)[1] == _warm_modes(idx)
    idx.drop()
    assert idx._graph_seen == {} and idx._stage_free == {}
    idx.add_batch(np.arange(_GRAPH_N) + 10 ** 6,
                  rng.standard_normal((_GRAPH_N, _GRAPH_D)).astype(np.float32))
    want = _eager(idx, monkeypatch, q)
    outs, modes = _warm(idx, q)
    assert modes == _warm_modes(idx)
    for got in outs:
        _assert_same(got, want)
    assert (want[0] >= 10 ** 6).all()


@pytest.mark.cuda
def test_freeing_a_staging_buffer_during_a_capture(card, tmp_path, tracer, monkeypatch):
    """A pinned staging buffer that a graph's dispatches read is freed,
    and pinned memory allocated, while another capture runs: the capture
    holds (no pinned buffer carries the capture stream, so its free
    records no event there) and answers as the eager path does."""
    idx, x, rng = _graph_index(card, tmp_path, {"distance": "cosine"})
    q16 = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    assert _warm(idx, q16)[1] == _warm_modes(idx)
    (entry,) = idx._stage_free.pop((16, _GRAPH_D))
    q64 = rng.standard_normal((64, _GRAPH_D)).astype(np.float32)
    want = _eager(idx, monkeypatch, q64)
    scan = idx._scan_packed
    freed = []

    def free():
        entry.graph = entry.buf = None  # the last reference: the pinned block is freed
        freed.append(torch.empty(1 << 16, pin_memory=True))  # the allocator's event sweep

    def scan_and_free(*a, **k):
        if torch.cuda.is_current_stream_capturing() and not freed:
            import threading

            t = threading.Thread(target=free)  # another serving thread's work
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        return scan(*a, **k)

    monkeypatch.setattr(idx, "_scan_packed", scan_and_free)
    outs, modes = _warm(idx, q64)
    assert modes == _warm_modes(idx) and freed
    for got in outs:
        _assert_same(got, want)


@pytest.mark.cuda
def test_no_collection_frees_a_graph_during_a_capture(card, tmp_path, tracer, monkeypatch):
    """An unreachable index still holding CUDA graphs, and a collection
    due in the middle of a capture: the capture runs with the collector
    off, so no graph is freed on the capturing thread, and it answers as
    the eager path does."""
    import gc
    import weakref

    old, _, rng = _graph_index(card, tmp_path / "old", {"distance": "cosine"})
    q16 = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    assert _warm(old, q16)[1] == _warm_modes(old)
    idx, x, rng = _graph_index(card, tmp_path / "new", {"distance": "cosine"}, seed=4)
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    want = _eager(idx, monkeypatch, q)
    scan = idx._scan_packed
    thresholds = gc.get_threshold()

    def scan_with_garbage(*a, **k):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1, 1, 1)  # any allocation makes a collection due
            try:
                junk = [[i] for i in range(1000)]  # noqa: F841
            finally:
                gc.set_threshold(*thresholds)
        return scan(*a, **k)

    monkeypatch.setattr(idx, "_scan_packed", scan_with_garbage)
    cycle = {"index": old}
    cycle["self"] = cycle
    gone = weakref.ref(old)
    del old, cycle  # unreachable; its parked entry still holds a graph
    outs, modes = _warm(idx, q)
    assert modes == _warm_modes(idx)
    for got in outs:
        _assert_same(got, want)
    gc.collect()
    assert gone() is None  # a collection during the capture would have freed it


@pytest.mark.cuda
def test_graph_pools_are_counted_against_the_device_budget(card, tmp_path, tracer,
                                                           monkeypatch):
    """A capture counts its entry's graph pool (more than 0 bytes) against
    the device's budget while the pool lives, and a recapture after a
    write goes into the same pool. Where a new pool does not fit the
    budget, its capture serves its own dispatch, the graph and the pool go
    at the entry's release, and the bucket stays eager after. Every answer
    equals the eager path's."""
    import gc

    gc.collect()  # earlier tests' unreachable indexes give their pools back now
    idx, x, rng = _graph_index(card, tmp_path, {"distance": "cosine"})
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    held = gpu._graph_bytes.get(idx.device, 0)
    want = _eager(idx, monkeypatch, q)
    outs, modes = _warm(idx, q)
    assert modes == _warm_modes(idx)
    (entry,) = idx._stage_free[(16, _GRAPH_D)]
    pool, nbytes = entry.pool, idx._graph_seen[(16, _GRAPH_D)].nbytes
    assert nbytes > 0 and entry.graph.kept and pool.booked == [nbytes]
    assert gpu._graph_bytes[idx.device] == held + nbytes
    for got in outs:
        _assert_same(got, want)
    _add(idx, x, rng)
    want = _eager(idx, monkeypatch, q)
    outs, modes = _warm(idx, q)
    assert modes == _warm_modes(idx)
    assert entry.pool is pool and idx._graph_seen[(16, _GRAPH_D)].made == 1
    assert pool.booked == [nbytes]  # the recapture reused the pool's blocks
    assert gpu._graph_bytes[idx.device] == held + nbytes
    for got in outs:
        _assert_same(got, want)
    monkeypatch.setattr(gpu, "_graph_budget", lambda device: held + nbytes)
    q64 = rng.standard_normal((64, _GRAPH_D)).astype(np.float32)
    want = _eager(idx, monkeypatch, q64)
    outs, modes = _searches(idx, q64, idx._GRAPH_AFTER + 3)
    assert modes == ["eager"] * idx._GRAPH_AFTER + ["capture", "eager", "eager"]
    (e64,) = idx._stage_free[(64, _GRAPH_D)]
    assert e64.graph is None and e64.pool is None
    assert idx._graph_seen[(64, _GRAPH_D)].made == 0
    assert gpu._graph_bytes[idx.device] == held + nbytes
    for got in outs:
        _assert_same(got, want)


@pytest.mark.cuda
def test_no_capture_while_a_profiler_session_is_up(card, tmp_path, tracer, monkeypatch):
    """While a profiler session starts, runs or stops, a key that has lived
    long enough runs eagerly in place of its capture; the first dispatch
    after the session captures. Every answer equals the eager path's."""
    from weaviate_tpu_torch.monitoring import profiling

    idx, x, rng = _graph_index(card, tmp_path, {"distance": "dot"})
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    want = _eager(idx, monkeypatch, q)
    outs, modes = _searches(idx, q, idx._GRAPH_AFTER)
    profiling._begin_session()
    try:
        during, modes_during = _searches(idx, q, 2)
    finally:
        profiling._end_session()
    after, modes_after = _searches(idx, q, 2)
    assert modes + modes_during == ["eager"] * (idx._GRAPH_AFTER + 2)
    assert modes_after == ["capture", "replay"]
    for got in outs + during + after:
        _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("conf", ["cosine", "pq_rescore"])
def test_searches_beside_writes_stay_eager(card, tmp_path, tracer, monkeypatch, conf):
    """A write every four searches replaces the key before it has served
    `_GRAPH_AFTER` dispatches: nothing is captured, and every answer
    equals the eager path's on its snapshot."""
    idx, x, rng = _graph_index(card, tmp_path, _GRAPH_CONFS[conf])
    q = rng.standard_normal((16, _GRAPH_D)).astype(np.float32)
    modes = []
    for i in range(2 * idx._GRAPH_AFTER):
        if i % 4 == 0:
            ids = np.arange(_GRAPH_N + 10 * i, _GRAPH_N + 10 * i + 10)
            idx.add_batch(ids, rng.standard_normal((10, _GRAPH_D)).astype(np.float32))
            want = _eager(idx, monkeypatch, q)
        got, m = _searches(idx, q, 1)
        modes += m
        _assert_same(got[0], want)
    assert modes == ["eager"] * len(modes)
