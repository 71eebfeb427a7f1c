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
from weaviate_tpu_torch.index import new_vector_index
from weaviate_tpu_torch.ops import gmin_scan
from weaviate_tpu_torch.storage.bitmap import Bitmap


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ncols,d,ag", [(16, 1024, 32, 3), (77, 1000, 129, 16),
                                          (5, 130, 30, 1), (300, 4096, 128, 16)])
def test_gmin_kernel_matches_plain_version(card, b, ncols, d, ag):
    """Ragged edges included: B and ncols off the block tile, D off 16 and
    off 4 (the scalar staging path), D over one staged depth. Tolerance
    rtol 1e-4, atol 1e-3: the same bf16 operands, summed in f32 by the
    tensor cores in another order."""
    rng = np.random.default_rng(b)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((16, ncols, d)).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.standard_normal((16, ncols)).astype(np.float32)).to(card)
    bias[:, ::7] = float("inf")
    bias[:, ::5] = float("inf")  # every 35th group is dead in all slices
    before = gmin_scan.launches
    got = gmin_scan.group_min_scores(q, x, bias, -2.0, active_g=ag)
    torch.cuda.synchronize()
    assert gmin_scan.launches == before + 1
    want = gmin_scan.group_min_scores_reference(q, x, bias, -2.0, active_g=ag)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


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
