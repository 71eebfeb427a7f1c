"""The reference's exact top-k and its readings, the controls, and the
roofline's operation and byte counts, against brute force on tiny data."""

import numpy as np
import pytest
import torch

from wbench import reference, roofline


def brute(q, x, k, metric):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    if metric == "cosine":
        q64 = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        x64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
        d = 1.0 - q64 @ x64.T
    elif metric == "dot":
        d = -(q64 @ x64.T)
    else:
        d = ((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1)
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2-squared"])
def test_truth_is_brute_force(metric):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((700, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    ids, d = reference.truth(q, x, 10, metric)
    want_ids, want_d = brute(q, x, 10, metric)
    assert np.array_equal(ids, want_ids)
    np.testing.assert_allclose(d, want_d, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_exact_answers_read_clean_and_recall_one(metric):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((30, 16)).astype(np.float32)
    t_ids, t_d = reference.truth(q, x, 10, metric)
    r = reference.judge(q, x, 10, metric, t_ids, t_d.astype(np.float32), t_ids, t_d)
    assert r["bad"] == 0 and r["recall"] == 1.0 and r["kth_gap"] == 0.0
    assert r["dist_gap"] < 1e-6


def test_judge_sees_each_kind_of_wrong_answer():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((30, 16)).astype(np.float32)
    t_ids, t_d = reference.truth(q, x, 10, "cosine")
    d32 = t_d.astype(np.float32)
    short = t_ids.copy()
    short[3, 5:] = -1
    assert reference.judge(q, x, 10, "cosine", short, d32, t_ids, t_d)["bad"] == 1
    swapped = t_ids.copy()
    swapped[0, [0, -1]] = swapped[0, [-1, 0]]
    assert reference.judge(q, x, 10, "cosine", swapped, d32, t_ids, t_d)["dist_gap"] > 1e-3
    far = t_ids.copy()
    far[:, -1] = np.argsort(reference.distances64(q, x, np.tile(np.arange(500), (30, 1)),
                                                  "cosine"), axis=1)[:, -1]
    far_d = reference.distances64(q, x, far, "cosine").astype(np.float32)
    r = reference.judge(q, x, 10, "cosine", far, far_d, t_ids, t_d)
    assert r["kth_gap"] > 0.1 and r["recall"] == pytest.approx(0.9)


def test_judge_counts_a_repeated_row_and_a_fall_in_distance_as_bad():
    """The nearest row given k times, or the right rows farthest first,
    name every distance right and lie inside the true top k: only `bad`
    can see them."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    q = rng.standard_normal((30, 16)).astype(np.float32)
    t_ids, t_d = reference.truth(q, x, 10, "cosine")
    d32 = t_d.astype(np.float32)
    rep_ids, rep_d = t_ids.copy(), d32.copy()
    rep_ids[4, 1:], rep_d[4, 1:] = rep_ids[4, :1], rep_d[4, :1]
    r = reference.judge(q, x, 10, "cosine", rep_ids, rep_d, t_ids, t_d, 2e-5)
    assert r["bad"] == 1 and r["dist_gap"] < 1e-6 and r["kth_gap"] == 0.0
    rev = reference.judge(q, x, 10, "cosine", t_ids[:, ::-1], d32[:, ::-1], t_ids, t_d, 2e-5)
    assert rev["bad"] == 30 and rev["dist_gap"] < 1e-6 and rev["kth_gap"] == 0.0
    assert rev["order_gap"] > 1e-3
    # a fall within the tolerance is rounding: two near ties received swapped
    tie = d32.copy()
    tie[0, [1, 2]] = tie[0, 2] + 1e-6, tie[0, 2]
    ok = reference.judge(q, x, 10, "cosine", t_ids, tie, t_ids, t_d, 2e-5)
    assert ok["bad"] == 0 and 0 < ok["order_gap"] <= 2e-5


@pytest.mark.parametrize("name", ["bfloat16", "fp8_e4m3"])
def test_controls_round_below_f32(name):
    t = torch.randn(8, 64)
    r = reference.CONTROLS[name](t)
    err = (r - t).abs().max().item()
    assert 0.0 < err < 0.2 * t.abs().max().item()


def test_search_work_counts_operations_and_bytes():
    ops, nbytes = roofline.search_work(queries=512, rows=1000, dim=64, dispatches=2,
                                       store_bytes_per_value=4)
    assert ops == 2 * 512 * 1000 * 64
    assert nbytes == 2 * 1000 * 64 * 4 + 4 * 512 * 64
    t, which = roofline.least_seconds(ops, nbytes)
    assert which == "bytes" and t == pytest.approx(nbytes / roofline.PEAK_BYTES)
    t, which = roofline.least_seconds(1e15, 1.0)
    assert which == "operations" and t == pytest.approx(1e15 / 989e12)
