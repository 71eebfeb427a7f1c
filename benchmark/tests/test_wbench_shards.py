"""The four-shard SIFT1M cell: its configuration and cell load by name; the
CPU rehearsal of its run is correct and served by the raw lane over the
shards; a broken path and the control come out not correct; the readers of
the lane's scatter, merge and gather spans; and the plain scatter-gather
reference, which imports nothing of the program, against the exact top k
on random partitions."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wbench import devtrace, isolation, load, reference, scatter_reference, spec
from test_wbench_flow import last_json, run_cmd
from test_wbench_readers import fake_run, trace, write_trace

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
CELL = "sift1m-l2-4shards.grpc-batch256"
READERS = ["raw_lane_pct.shards", "shard_scatter_ms.shards", "shard_merge_ms.shards",
           "shard_gather_ms.shards"]
DEVICE_READERS = ["search_roofline_pct.shards", "device_idle_pct.shards",
                  "dispatch_graph_pct.shards"]


def test_the_cell_loads_with_its_configuration():
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert cell.chips == 1 and cell.traffic_name == "grpc-batch256"
    assert cfg["n_objects"] == cfg["published"]["n_objects"] == 1_000_000
    assert cfg["data"]["dim"] == cfg["published"]["dim"] == 128 and cfg["reduced"] == []
    assert cfg["class"]["shardingConfig"] == {"desiredCount": 4}
    assert cfg["class"]["vectorIndexConfig"]["distance"] == "l2-squared"
    assert set(cfg["limits"]["grpc_batch_search"]) == {"bad", "dist_gap", "kth_gap"}
    assert {m["name"] for m in cell.per_layer} == set(READERS) | set(DEVICE_READERS) | {
        "qps.shards"}
    # the rate spreads too widely for an end-to-end bound: it is read per layer
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "recall_at_10"}
    assert {m["moves"] for m in cell.per_layer} == {"recall_at_10"}


def test_cpu_rehearsal_is_correct_and_served_by_the_raw_lane_over_the_shards():
    out = run_cmd("--workload", CELL, "--seed", "6000000011", "--seconds", "1.5",
                  "--trace", "1", "--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["path"]["raw_lane_share"] == 1.0
    assert res["metrics"]["raw_lane_pct.shards"]["value"] == 100.0
    for n in READERS[1:]:
        assert res["metrics"][n]["value"] >= 0.0
    # a CPU server records eager dispatches and no device trace
    assert res["metrics"]["dispatch_graph_pct.shards"]["value"] == 0.0
    assert "device_idle_pct.shards" not in res["metrics"]
    assert res["metrics"]["qps.shards"]["value"] > 0.0


def test_a_broken_sharded_path_comes_out_not_correct():
    out = run_cmd("--workload", CELL, "--seed", "78", "--seconds", "1.5", "--trace", "0",
                  "--rehearse", fault="alter")
    assert out.returncode == 0, out.stderr[-3000:]
    res = last_json(out)
    assert res["path"]["raw_lane_share"] == 1.0
    assert res["correct"] is False


def test_the_control_fails_the_limits():
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", CELL,
                          "--seeds", "5,6,7", "--rehearse"], capture_output=True, text=True,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    limits = spec.load_cell(CELL).config["limits"]["grpc_batch_search"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert any(r[n] > limits[n] for n in limits), r


def span(name, ms, children=()):
    return {"name": name, "duration_ms": ms, "children": list(children)}


def sharded_trace(i, graph=("replay",) * 4):
    disp = [dict(span("dispatch", 5.0, [span("device_search", 5.0)]), attrs={"graph": g})
            for g in graph]
    return trace("grpc", "BatchSearch", 40.0, [
        span("grpc.parse", 4.0), span("class.scatter", 20.0 + i, disp),
        span("class.merge", 0.5 + i), span("class.gather", 9.0 + i), span("grpc.reply", 2.0)])


def single_trace():
    return trace("grpc", "BatchSearch", 30.0, [
        span("grpc.parse", 4.0), span("dispatch", 20.0, [span("device_search", 8.0)]),
        span("grpc.reply", 2.0)])


def test_the_readers_of_the_lanes_spans():
    run = fake_run([], traces=[sharded_trace(i) for i in range(3)] + [single_trace()])
    read = {n: spec.metric_reader(n)(run) for n in READERS}
    assert read == {"raw_lane_pct.shards": 75.0, "shard_scatter_ms.shards": 21.0,
                    "shard_merge_ms.shards": 1.5, "shard_gather_ms.shards": 10.0}


def test_the_readers_of_the_device_and_the_graph_replays(tmp_path):
    """The roofline share counts the class's rows once a request (its four
    shards a quarter each), the idle share is the device trace's, and the
    graph share counts every shard dispatch under the scatter."""
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 2e6},
          {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0.0, "dur": 8e6}]
    d = devtrace.read(write_trace(tmp_path, ev))
    reqs = [load.Req(key=i, rows=256, due=0.0, sent=0.0, done=1.0 + i * 0.01, ok=True)
            for i in range(10)]
    cfg = {"n_objects": 1_000_000, "data": {"dim": 128}, "store_bytes_per_value": 4}
    traces = [sharded_trace(0, ("eager", "replay", "replay", "capture")),
              sharded_trace(1), single_trace()]
    run = fake_run(reqs, device=d, capture={"t0": 0.5, "t1": 1.045}, config=cfg, traces=traces)
    read = {n: spec.metric_reader(n)(run) for n in DEVICE_READERS}
    least = max(2 * 5 * 256 * 1_000_000 * 128 / 989e12,
                (5 * 1_000_000 * 128 * 4 + 4 * 5 * 256 * 128) / 3.35e12)
    assert read["search_roofline_pct.shards"] == pytest.approx(100 * least / 2.0)
    assert read["device_idle_pct.shards"] == pytest.approx(75.0)
    assert read["dispatch_graph_pct.shards"] == pytest.approx(100 * 6 / 8)
    assert all(spec.metric_reader(n)(fake_run([])) is None for n in DEVICE_READERS)


def test_the_rate_is_over_the_whole_window():
    reqs = [load.Req(key=i, rows=256, due=i * 0.1, sent=i * 0.1, done=i * 0.1 + 0.05, ok=True)
            for i in range(50)]
    reqs.append(load.Req(key=99, rows=256, due=9.9, sent=9.9, done=10.5, ok=True))  # late
    assert spec.metric_reader("qps.shards")(fake_run(reqs)) == pytest.approx(50 * 256 / 10.0)


def test_a_program_without_the_lanes_spans_reads_nothing():
    run = fake_run([], traces=[single_trace(), single_trace()])
    assert all(spec.metric_reader(n)(run) is None for n in READERS)
    assert all(spec.metric_reader(n)(fake_run([])) is None for n in READERS)


@pytest.mark.parametrize("metric", ["l2-squared", "cosine", "dot"])
def test_the_scatter_reference_is_the_exact_top_k_of_any_partition(metric):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((900, 24)).astype(np.float32)
    q = rng.standard_normal((20, 24)).astype(np.float32)
    t_ids, t_d = reference.truth(q, x, 10, metric)
    for shards in (1, 3, 5):
        part = rng.integers(0, shards, len(x))
        ids, d = scatter_reference.scatter_gather(q, x, part, 10, metric, block=128)
        assert np.array_equal(ids, t_ids)
        np.testing.assert_allclose(d, t_d, rtol=1e-9, atol=1e-9)


def test_the_scatter_reference_keeps_ties_in_shard_then_row_order():
    x = np.zeros((6, 4), np.float32)
    x[:, 0] = [1.0, 3.0, 1.0, 2.0, 1.0, 3.0]
    part = np.array([1, 1, 0, 0, 1, 0])
    ids, d = scatter_reference.scatter_gather(np.zeros((1, 4), np.float32), x, part, 5,
                                              "l2-squared", block=2)
    # distance 1: row 2 (shard 0), then rows 0 and 4 (shard 1); distance 4: row 3
    assert ids.tolist() == [[2, 0, 4, 3, 5]]
    assert d.tolist() == [[1.0, 1.0, 1.0, 4.0, 9.0]]


def test_the_scatter_reference_imports_nothing_of_the_program():
    names = isolation.imported_names(BENCH / "wbench" / "scatter_reference.py")
    assert not names & {"weaviate_tpu", "weaviate_tpu_torch", "jax", "jaxlib", "flax"}
    code = ("import sys; sys.path.insert(0, %r); import wbench.scatter_reference; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('weaviate')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax')))" % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
