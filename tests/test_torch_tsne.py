"""The port's t-SNE (weaviate_tpu_torch.ops.tsne, torch ops on the given
device) against the JAX program (weaviate_tpu.ops.tsne, on JAX's CPU
backend), on the same seeded inputs, the port on device="cpu".

Tolerances: the host halves (`_affinities`, the PCA init) are bit-equal.
The descent runs the same ops in another f32 summation order, which
momentum amplifies with the iteration count: up to 20 iterations the
layouts agree to max abs error <= 1e-4 x spread (max |y| of the JAX
layout); at the default 100 iterations each package is held to the
reference test's structure instead (two clusters separate, two runs equal
to the bit).
"""

import itertools

import numpy as np
import pytest
import torch

from weaviate_tpu.ops import tsne as jax_tsne
from weaviate_tpu_torch.ops import tsne as torch_tsne


def _vectors(n, d=32, seed=0):
    return np.random.default_rng(seed + n).standard_normal((n, d)).astype(np.float32)


def _jax_host_inputs(x, **kw):
    """(P, y0) the JAX tsne_project hands to its device program."""
    seen = {}

    def program(n, dims, iterations, learning_rate):
        def run(p, y0):
            seen["p"], seen["y0"] = np.asarray(p), np.asarray(y0)
            return y0
        return run

    orig = jax_tsne._tsne_program
    jax_tsne._tsne_program = program
    try:
        jax_tsne.tsne_project(x, **kw)
    finally:
        jax_tsne._tsne_program = orig
    return seen["p"], seen["y0"]


@pytest.mark.parametrize("n, dims", [(4, 2), (16, 2), (64, 3), (256, 2)])
def test_host_inputs_bit_equal(n, dims):
    x = _vectors(n)
    perplexity = float(min(5.0, max(1.0, (n - 1) / 3.0)))
    p, y0 = _jax_host_inputs(x, dims=dims)
    np.testing.assert_array_equal(torch_tsne._affinities(x, perplexity), p)
    np.testing.assert_array_equal(jax_tsne._affinities(x, perplexity), p)
    np.testing.assert_array_equal(torch_tsne._pca_init(x, dims), y0)


@pytest.mark.parametrize("n", [4, 16, 64, 256])
@pytest.mark.parametrize("iterations", [1, 5, 20])
def test_projection_tracks_the_jax_program(n, iterations):
    x = _vectors(n)
    want = jax_tsne.tsne_project(x, iterations=iterations)
    got = torch_tsne.tsne_project(x, iterations=iterations, device="cpu")
    assert got.shape == want.shape == (n, 2) and got.dtype == np.float32
    spread = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * spread


def test_projection_in_three_dims_and_explicit_knobs():
    x = _vectors(16)
    kw = dict(dims=3, perplexity=3.0, iterations=5, learning_rate=50.0)
    want = jax_tsne.tsne_project(x, **kw)
    got = torch_tsne.tsne_project(x, device="cpu", **kw)
    assert got.shape == (16, 3)
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())


def _two_clusters(seed=4):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((2, 32)).astype(np.float32) * 4
    return np.concatenate([centers[0] + 0.1 * rng.standard_normal((6, 32)),
                           centers[1] + 0.1 * rng.standard_normal((6, 32))]).astype(np.float32)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_default_iterations_separate_clusters_and_repeat(package):
    x = _two_clusters()

    def project():
        if package == "jax":
            return jax_tsne.tsne_project(x)
        return torch_tsne.tsne_project(x, device="cpu")

    pts = project()
    d = lambda i, j: float(np.linalg.norm(pts[i] - pts[j]))  # noqa: E731
    intra = max(d(i, j) for group in (range(6), range(6, 12))
                for i, j in itertools.combinations(group, 2))
    inter = min(d(i, j) for i, j in itertools.product(range(6), range(6, 12)))
    assert inter > intra, (pts, intra, inter)
    np.testing.assert_array_equal(project(), pts)


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("dims", [2, 3])
def test_fewer_than_two_points(n, dims):
    x = _vectors(4)[:n]
    got = torch_tsne.tsne_project(x, dims=dims, device="cpu")
    want = jax_tsne.tsne_project(x, dims=dims)
    assert got.shape == want.shape == (n, dims)
    np.testing.assert_array_equal(got, want)


def test_projection_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_tsne.tsne_project(_vectors(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_tsne.tsne_project(_vectors(4), device="cuda")


@pytest.mark.parametrize("params", [
    {},
    {"dimensions": 7, "iterations": 10 ** 6, "perplexity": 1e9, "learningRate": 1e9},
    {"dimensions": 0, "iterations": -5, "perplexity": -3, "learningRate": 1e-9},
    {"dimensions": 3, "iterations": 40, "perplexity": 2.5, "learningRate": 10},
])
def test_explain_clamps_equal_across_packages(monkeypatch, params):
    """featureProjection clamps the GraphQL knobs the same way in both
    packages, and the port passes its module's device."""
    from weaviate_tpu.modules.text2vec_local import LocalTextVectorizer as RefLocal
    from weaviate_tpu.db.shard import SearchResult as RefResult
    from weaviate_tpu.entities.storobj import StorObj as RefStorObj
    from weaviate_tpu_torch.db.shard import SearchResult
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.modules.text2vec_local import LocalTextVectorizer

    calls = []

    def record(vectors, **kw):
        calls.append(kw)
        return np.zeros((len(vectors), kw["dims"]), np.float32)

    monkeypatch.setattr(jax_tsne, "tsne_project", record)
    monkeypatch.setattr(torch_tsne, "tsne_project", record)
    texts = ["quantum qubits", "bread flour", "running shoes"]
    for v, obj, res in ((RefLocal(), RefStorObj, RefResult),
                        (LocalTextVectorizer(device="cpu"), StorObj, SearchResult)):
        rows = [res(obj=obj(class_name="D", uuid=f"00000000-0000-0000-0000-00000000000{i}",
                            properties={"b": t}, vector=v.vectorize_text([t])[0]))
                for i, t in enumerate(texts)]
        out = v.resolve_additional("featureProjection", rows, dict(params))
        assert [len(o["vector"]) for o in out] == [calls[-1]["dims"]] * 3
    ref_kw, port_kw = calls
    assert port_kw.pop("device") == "cpu"
    assert port_kw == ref_kw
    assert 1 <= ref_kw["dims"] <= 3 and 1 <= ref_kw["iterations"] <= 2000
