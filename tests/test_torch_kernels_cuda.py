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
