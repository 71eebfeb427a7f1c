"""The port's stage profiler (weaviate_tpu_torch/tools/profile_gmin.py) and
its two layout kernels, K4 (`nt_scores`) and K5 (`c4_scores`), on the CPU.

The plain versions are held against the reference's Pallas kernels
(`tools/profile_gmin.py`) run in interpret mode: that file passes no
`interpret` flag, and on the CPU backend Pallas runs only interpreted, so
the test loads it as a module of its own and gives that module object a
`pl` whose `pallas_call` interprets. The file on disk is not touched.

Tolerances, and why:
- scores: rtol 1e-5, atol 1e-4, and the same +inf pattern: both sides
  multiply the same bf16-rounded operands (exact in f32) and sum in f32 in
  another order (the port's bf16 fast-scan tolerance).
- layouts: exact (no arithmetic).
"""

import functools
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from weaviate_tpu_torch.ops import gmin_scan as tgmin
from weaviate_tpu_torch.tools import profile_gmin as tprof

ROOT = Path(__file__).resolve().parents[1]
G, NCOLS, D, B, QB = 16, 256, 32, 16, 8


def _reference_profiler():
    spec = importlib.util.spec_from_file_location("_reference_profile_gmin",
                                                  ROOT / "tools" / "profile_gmin.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                             BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def jprof():
    return _reference_profiler()


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _data(metric, seed=0):
    """store3 [G, NCOLS, D], its bias2 with dead slots and one whole dead
    group (column 5), queries, alpha."""
    rng = np.random.default_rng(seed)
    store3 = rng.standard_normal((G, NCOLS, D)).astype(np.float32)
    q = rng.standard_normal((B, D)).astype(np.float32)
    if metric == "l2":
        base = (store3.astype(np.float64) ** 2).sum(-1).astype(np.float32)
        alpha = -2.0
    else:
        base, alpha = np.zeros((G, NCOLS), np.float32), -1.0
    dead = rng.random((G, NCOLS)) < 0.1
    dead[:, 5] = True
    return store3, np.where(dead, np.inf, base).astype(np.float32), q, alpha


def _assert_scores(got, want):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _jax_layouts(store3, bias2, gc, scg):
    """The reference's reshapes (tools/profile_gmin.py:213, :222-227)."""
    store3t = jnp.transpose(jnp.asarray(store3), (0, 2, 1))
    view = store3t.reshape(G // gc, gc, D, NCOLS // scg, scg)
    s4 = view.transpose(0, 2, 3, 1, 4).reshape(G // gc, D, NCOLS * gc)
    b4 = (jnp.asarray(bias2).reshape(G // gc, gc, NCOLS // scg, scg)
          .transpose(0, 2, 1, 3).reshape(G // gc, NCOLS * gc))
    return np.asarray(store3t), np.asarray(s4), np.asarray(b4)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_nt_scores_matches_pallas_interpret(jprof, metric):
    store3, bias2, q, alpha = _data(metric)
    store3t = np.ascontiguousarray(store3.transpose(0, 2, 1))
    want = np.asarray(jprof.nt_scores(jnp.asarray(q), jnp.asarray(store3t), jnp.asarray(bias2),
                                      alpha, QB, 128))
    before = tprof.nt_launches
    got = tprof.nt_scores(_t(q), _t(store3t), _t(bias2), alpha).numpy()
    assert tprof.nt_launches == before  # CPU tensors take the plain version
    assert np.isinf(got[:, 5]).all()
    _assert_scores(got, want)


@pytest.mark.parametrize("gc,scg", [(2, 64), (2, 128), (4, 64), (4, 128)])
@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_c4_scores_matches_pallas_interpret(jprof, metric, gc, scg):
    store3, bias2, q, alpha = _data(metric, seed=gc * scg)
    _, s4, b4 = _jax_layouts(store3, bias2, gc, scg)
    want = np.asarray(jprof.c4_scores(jnp.asarray(q), jnp.asarray(s4), jnp.asarray(b4), alpha,
                                      QB, scg, gc))
    before = dict(tprof.c4_launches)
    got = tprof.c4_scores(_t(q), _t(s4), _t(b4), alpha, scg, gc).numpy()
    assert tprof.c4_launches == before
    assert np.isinf(got[:, 5]).all()
    _assert_scores(got, want)


@pytest.mark.parametrize("gc,scg", [(2, 64), (4, 128), (4, 256)])
def test_layout_builders_match_the_reference_reshapes(gc, scg):
    store3, bias2, _, _ = _data("l2")
    want_t, want_s4, want_b4 = _jax_layouts(store3, bias2, gc, scg)
    store3t = tprof.transpose_store(_t(store3))
    assert store3t.is_contiguous()
    np.testing.assert_array_equal(store3t.numpy(), want_t)
    s4, b4 = tprof.interleave(store3t, _t(bias2), gc, scg)
    assert s4.is_contiguous() and b4.is_contiguous()
    np.testing.assert_array_equal(s4.numpy(), want_s4)
    np.testing.assert_array_equal(b4.numpy(), want_b4)


@pytest.mark.parametrize("metric", ["l2", "dot"])
def test_plain_versions_match_group_min_scores(metric):
    """K4 and K5 compute K1's function: their plain versions against K1's
    on the same data."""
    store3, bias2, q, alpha = _data(metric, seed=3)
    want = tgmin.group_min_scores_reference(_t(q), _t(store3), _t(bias2), alpha).numpy()
    store3t = tprof.transpose_store(_t(store3))
    _assert_scores(tprof.nt_scores_reference(_t(q), store3t, _t(bias2), alpha).numpy(), want)
    for gc, scg in ((2, 64), (4, 128), (4, 256)):
        s4, b4 = tprof.interleave(store3t, _t(bias2), gc, scg)
        _assert_scores(tprof.c4_scores_reference(_t(q), s4, b4, alpha, scg, gc).numpy(), want)


def _c4_column(g, c, iw, gc):
    """K5's column map as csrc/gmin_layouts.cu's `Interleave::col` computes
    it: group g's column c within its store slice's depth row."""
    blk = c // iw
    return (blk * gc + g % gc) * iw + (c - blk * iw)


@pytest.mark.parametrize("ncols,iw,gc", [(1024, 64, 2), (320, 64, 4), (4096, 128, 4),
                                         (64, 4, 4)])
def test_c4_filler_map_reads_the_interleave(ncols, iw, gc):
    """The addresses K5's filler reads, x + (slice(g) * D + d) * width +
    col(g, c), and its bias_index, slice(g) * width + col(g, c) (slice(g)
    = g // gc, width = gc * ncols), hold every member's elements of
    `interleave`'s layout."""
    rng = np.random.default_rng(ncols + iw + gc)
    d = 3
    store3t = torch.from_numpy(rng.standard_normal((G, d, ncols)).astype(np.float32))
    bias2 = torch.from_numpy(rng.standard_normal((G, ncols)).astype(np.float32))
    s4, b4 = tprof.interleave(store3t, bias2, gc, iw)
    x, bias, width = s4.numpy().ravel(), b4.numpy().ravel(), gc * ncols
    c = np.arange(ncols)
    for g in range(G):
        col = _c4_column(g, c, iw, gc)
        for dd in range(d):
            np.testing.assert_array_equal(x[((g // gc) * d + dd) * width + col],
                                          store3t[g, dd].numpy())
        np.testing.assert_array_equal(bias[(g // gc) * width + col], bias2[g].numpy())


@pytest.mark.parametrize("groups", [3, 8, 16])
def test_layout_wrappers_take_k1s_plan(groups):
    """K4 and K5 launch K1's resident-tile plan for the store's groups:
    S = pow2ceil(groups), the widest tile that fits."""
    for d in (30, 128, 500, 3072, 6208):
        assert tprof.layout_plan(d, groups) == tgmin.resident_plan(d, groups)
    if groups == 3:
        assert tprof.layout_plan(128, 3) == tgmin.ResidentPlan(4, 64, 128, 100352)


def test_layout_wrappers_have_no_plan_past_the_tile():
    """Past D 6208 no store tile fits; the wrappers raise before a launch
    (the reference's layouts have no such limit)."""
    assert tgmin.resident_plan(6272, 16) is None
    with pytest.raises(ValueError, match="does not fit"):
        tprof.layout_plan(6272, 16)


def test_layout_wrappers_reject_other_devices():
    meta = torch.device("meta")
    q = torch.zeros((B, D), device=meta)
    with pytest.raises(ValueError):
        tprof.nt_scores(q, torch.zeros((G, D, NCOLS), device=meta),
                        torch.zeros((G, NCOLS), device=meta), -1.0)
    with pytest.raises(ValueError):
        tprof.c4_scores(q, torch.zeros((G // 2, D, 2 * NCOLS), device=meta),
                        torch.zeros((G // 2, 2 * NCOLS), device=meta), -1.0, 128, 2)


STAGES = {
    "component": ["kernel", "select", "topk", "legacy", "kernel_nt", "kernel_c2", "kernel_c4"],
    "gather": ["search_gmin", "kernel", "select", "gather_strided", "gather_blocked",
               "rescore_nogather"],
    "loop": ["kernel", "kernsel", "topk_strided", "topk_block", "legacy"],
}


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_profiler_cli_runs_every_stage_on_the_cpu(mode, capsys):
    assert tprof.main(["--device", "cpu", "--mode", mode, "32768", "64", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"device=cpu mode={mode} N=32768 B=64")
    printed = {ln.split()[0] for ln in lines[1:-1] if "ms/batch" in ln}
    assert printed == set(STAGES[mode])
    last = json.loads(lines[-1])
    assert last["mode"] == mode and last["device"] == "cpu"
    assert sorted(last["stages_ms"]) == sorted(STAGES[mode])
    assert all(ms > 0 for ms in last["stages_ms"].values())


def test_profiler_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprof.main(["--mode", "component", "32768", "64"])


def test_kernel_timer_needs_a_card(monkeypatch):
    """tools/time_kernels.py measures only on the card: without one it
    exits non-zero and times nothing."""
    from weaviate_tpu_torch.tools import time_kernels
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert time_kernels.main(["--checkout", str(ROOT)]) == 1
