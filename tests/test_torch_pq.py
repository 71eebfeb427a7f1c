"""The port's product quantizer (weaviate_tpu_torch/compress/pq.py) against
the JAX package's on the same inputs, on the CPU, and the pq config
surface.

Tolerances, and why:
- fit: codebooks within 1e-4 — both sides run the same Lloyd steps from
  the same numpy-chosen initial rows in f32; the sums differ only in
  order (the data is tie-free, so no assignment flips).
- encode, pack/unpack, decode: exact — the same codebook, an argmin over
  distances far apart, and lookups.
- LUTs, LUT scans, recon norms: rtol 1e-5 — f32 arithmetic in another
  order (recon norms are summed in f64 on both sides).
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from weaviate_tpu.compress import pq as jpq
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu_torch.compress import pq as tpq
from weaviate_tpu_torch.entities import vectorindex as tvi

D, N, M, C = 32, 3000, 8, 32


def _data(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32), rng


def _pair(**kw):
    args = dict(dim=D, segments=M, centroids=C, metric="l2-squared", **kw)
    return jpq.ProductQuantizer(**args), tpq.ProductQuantizer(**args, device="cpu")


def _copy_codebook(src, dst):
    dst.codebook = np.array(src.codebook, np.float32)
    if src.rotation_matrix is not None:
        dst.rotation_matrix = np.array(src.rotation_matrix, np.float32)


@pytest.mark.parametrize("kind", ["kmeans", "kmeans_sampled", "tile_lognormal", "tile_normal"])
def test_fit_matches_jax(kind):
    """The same codebook from the same rows: k-means (with the 16384-row
    fit sample drawn when the store is larger) and both tile encoders."""
    if kind.startswith("tile"):
        x, _ = _data(1, d=8)
        x = np.abs(x) + 0.1 if kind == "tile_lognormal" else x
        dist = "log-normal" if kind == "tile_lognormal" else "normal"
        args = dict(dim=8, segments=8, centroids=16, metric="l2-squared", encoder="tile",
                    distribution=dist)
        j, t = jpq.ProductQuantizer(**args), tpq.ProductQuantizer(**args, device="cpu")
    else:
        x, _ = _data(1, n=20000 if kind == "kmeans_sampled" else N)  # a tie-free seed
        j, t = _pair()
    j.fit(x, seed=3)
    t.fit(x, seed=3)
    np.testing.assert_allclose(t.codebook, j.codebook, rtol=1e-4, atol=1e-4)


def test_encode_decode_and_norms_match_jax():
    x, _ = _data(4)
    j, t = _pair()
    j.fit(x)
    _copy_codebook(j, t)
    codes = t.encode(x)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), j.encode(x))
    np.testing.assert_array_equal(t.decode(codes).numpy(), j.decode(j.encode(x)))
    np.testing.assert_allclose(t.recon_sq_norms(codes).numpy(), j.recon_sq_norms(j.encode(x)),
                               rtol=1e-5)


def test_opq_rotation_is_orthogonal_and_round_trips_as_the_reference():
    x, _ = _data(5, n=1000)
    args = dict(dim=D, segments=M, centroids=16, metric="l2-squared", rotation="opq")
    t = tpq.ProductQuantizer(**args, device="cpu")
    t.fit(x)
    r = t.rotation_matrix
    np.testing.assert_allclose(r @ r.T, np.eye(D), atol=1e-4)
    # given the same rotation and codebook, both packages encode to the
    # same codes and decode to the same rows in the original space
    j = jpq.ProductQuantizer(**args)
    _copy_codebook(t, j)
    codes = t.encode(x)
    np.testing.assert_array_equal(codes.numpy(), j.encode(x))
    np.testing.assert_allclose(t.decode(codes).numpy(), j.decode(j.encode(x)), rtol=1e-5,
                               atol=1e-5)
    # the 4-bit quantizer pins the 8-bit one's rotation
    t4 = tpq.ProductQuantizer(dim=D, segments=M, centroids=16, metric="l2-squared",
                              device="cpu")
    t4.fit(x, rotation_matrix=r)
    np.testing.assert_array_equal(t4.rotation_matrix, r)


@pytest.mark.parametrize("metric", ["l2-squared", "dot", "cosine", "manhattan"])
def test_build_lut_and_scan_match_jax(metric):
    x, rng = _data(6)
    j, t = _pair()
    j.fit(x)
    _copy_codebook(j, t)
    q = rng.standard_normal((16, D)).astype(np.float32)
    want = np.asarray(jpq.build_lut(jnp.asarray(q), jnp.asarray(j.codebook), metric))
    lut = tpq.build_lut(torch.from_numpy(q), torch.from_numpy(t.codebook), metric)
    np.testing.assert_allclose(lut.numpy(), want, rtol=1e-5, atol=1e-5)
    codes = j.encode(x)
    want_d = np.asarray(jpq.lut_scan_block(jnp.asarray(codes.astype(np.int32)), jnp.asarray(want)))
    got_d = tpq.lut_scan_block(torch.from_numpy(codes), lut)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-5, atol=1e-5)


def test_pack_codes4_round_trip_matches_jax():
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 16, (100, M)).astype(np.uint8)
    packed = tpq.pack_codes4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), jpq.pack_codes4(codes))
    np.testing.assert_array_equal(tpq.unpack_codes4(packed).numpy(), codes)
    with pytest.raises(ValueError):
        tpq.pack_codes4(torch.from_numpy(codes[:, :7]))
    with pytest.raises(ValueError):
        tpq.pack_codes4(torch.from_numpy(codes) + 16)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pq_npz_loads_in_the_other_package(tmp_path, writer):
    x, _ = _data(8, n=1000)
    args = dict(dim=D, segments=M, centroids=16, metric="dot", rotation="opq")
    path = str(tmp_path / "pq.npz")
    if writer == "jax":
        w = jpq.ProductQuantizer(**args)
        w.fit(x)
        w.save(path)
        r = tpq.ProductQuantizer.load(path, device="cpu")
    else:
        w = tpq.ProductQuantizer(**args, device="cpu")
        w.fit(x)
        w.save(path)
        r = jpq.ProductQuantizer.load(path)
    for attr in ("dim", "segments", "centroids", "metric", "encoder", "distribution", "rotation"):
        assert getattr(r, attr) == getattr(w, attr), attr
    np.testing.assert_array_equal(r.codebook, w.codebook)
    np.testing.assert_array_equal(r.rotation_matrix, w.rotation_matrix)


def test_quantizer_rejects_what_the_reference_rejects():
    bad = [dict(dim=D, segments=5, centroids=C, metric="l2-squared"),
           dict(dim=D, segments=M, centroids=C, metric="hamming"),
           dict(dim=D, segments=M, centroids=C, metric="l2-squared", encoder="tile"),
           dict(dim=D, segments=M, centroids=C, metric="manhattan", rotation="opq"),
           dict(dim=D, segments=M, centroids=70000, metric="l2-squared")]
    for args in bad:
        with pytest.raises(jvi.ConfigValidationError):
            jpq.ProductQuantizer(**args)
        with pytest.raises(tvi.ConfigValidationError):
            tpq.ProductQuantizer(**args, device="cpu")


@pytest.mark.parametrize("pq", [{"bits": 5}, {"bits": 4, "encoder": {"type": "tile"}},
                                {"rotation": "pca"}, {"encoder": {"type": "lsh"}},
                                {"centroids": 0}])
def test_pq_config_validation_matches_jax(pq):
    cfg = {"distance": "l2-squared", "pq": {"enabled": True, **pq}}
    with pytest.raises(jvi.ConfigValidationError):
        jvi.parse_and_validate_config("hnsw_tpu", cfg)
    with pytest.raises(tvi.ConfigValidationError):
        tvi.parse_and_validate_config("hnsw_tpu", cfg)


def test_pq_config_parses_as_the_reference():
    d = {"distance": "dot", "pq": {"enabled": True, "segments": 96, "centroids": 256,
                                   "encoder": {"type": "kmeans", "distribution": "normal"},
                                   "rescore": False, "rescoreLimit": 512, "rotation": "opq",
                                   "bits": 4, "bitCompression": True}}
    j = jvi.parse_and_validate_config("hnsw_tpu", d).pq
    t = tvi.parse_and_validate_config("hnsw_tpu", d).pq
    for attr in ("enabled", "segments", "centroids", "rescore",
                 "rescore_limit", "rotation", "bits"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert (t.encoder.type, t.encoder.distribution) == (j.encoder.type, j.encoder.distribution)
    with pytest.raises(tvi.ConfigValidationError):  # bits 4 needs a matmul metric
        tvi.parse_and_validate_config("hnsw_tpu", {**d, "distance": "manhattan"})


def test_rescore_off_warning_is_rate_limited(caplog, monkeypatch):
    monkeypatch.setattr(tvi, "_rescore_warn_last", [0.0])
    cfg = {"distance": "l2-squared", "pq": {"enabled": True, "rescore": False}}
    with caplog.at_level(logging.WARNING, logger=tvi.__name__):
        for _ in range(3):
            tvi.parse_and_validate_config("hnsw_tpu", cfg)
    assert sum("pq.rescore=false" in r.getMessage() for r in caplog.records) == 1
