"""The metric readers over hand-made runs and traces: rates over the whole
window, span self times, the device trace."""

import json
from types import SimpleNamespace

import pytest

from wbench import devtrace, load, spec


def reader(name):
    return spec.metric_reader(name)


def fake_run(reqs, seconds=10.0, **kw):
    win = load.Window(start=0.0, end=seconds, reqs=reqs)
    done_in = [r for r in reqs if r.ok and r.done <= win.end]
    base = dict(traffic={"protocol": "grpc_batch_search"}, config={}, seconds=seconds,
                window=win, rows_done=sum(r.rows for r in done_in),
                readings={}, traces=[], device=None, capture={}, setup_s=1.0)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("name", ["qps", "qps.pq"])
def test_rate_is_over_the_whole_window(name):
    reqs = [load.Req(key=i, rows=256, due=i * 0.1, sent=i * 0.1, done=i * 0.1 + 0.05, ok=True)
            for i in range(50)]                       # all answered in the first 5 s
    reqs.append(load.Req(key=99, rows=256, due=9.9, sent=9.9, done=10.5, ok=True))  # late
    run = fake_run(reqs)
    assert reader(name)(run) == pytest.approx(50 * 256 / 10.0)


def test_import_rate_and_bytes_per_object():
    reqs = [load.Req(key=i, rows=100, due=0.0, sent=0.0, done=1.0, ok=True) for i in range(30)]
    run = fake_run(reqs, traffic={"protocol": "rest_batch_import"}, data_bytes=3_000_000)
    assert reader("import_objects_s")(run) == pytest.approx(300.0)
    assert reader("disk_bytes_per_object.import")(run) == pytest.approx(1000.0)
    assert reader("qps")(run) is None
    assert reader("qps.pq")(run) is None


def trace(kind, name, dur, children):
    return {"kind": kind, "name": name, "root": {"name": "request", "duration_ms": dur,
                                                  "children": children}}


def test_span_readers():
    disp = {"name": "dispatch", "duration_ms": 6.0, "attrs": {"queue_wait_ms": 1.5},
            "children": [{"name": "device_search", "duration_ms": 2.0},
                         {"name": "hydrate", "duration_ms": 4.0}]}
    traces = [trace("grpc", "BatchSearch", 10.0 + i, [disp]) for i in range(3)]
    traces.append(trace("rest", "POST /v1/graphql", 9.0, [
        {"name": "graphql.get", "duration_ms": 7.0, "children": [disp]}]))  # not BatchSearch
    run = fake_run([], traces=traces)
    assert reader("server_self_ms.batch")(run) == pytest.approx(5.0)
    assert reader("shard_hydrate_ms.batch")(run) == pytest.approx(4.0)
    assert reader("index_search_ms.batch")(run) == pytest.approx(2.0)
    assert reader("index_search_ms.pq")(run) == pytest.approx(2.0)
    assert reader("server_self_ms.batch")(fake_run([])) is None


def write_trace(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def test_device_trace_busy_idle_and_gaps(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 150.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 600.0, "dur": 350.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 300.0,
           "dur": 250.0}]
    d = devtrace.read(write_trace(tmp_path, ev))
    assert d.window_s == pytest.approx(1e-3) and d.busy_s == pytest.approx(500e-6)
    assert d.idle_share == pytest.approx(0.5)
    assert d.device_ops == [["copy", pytest.approx(350e-6)], ["k1", pytest.approx(200e-6)]]
    assert d.idle_gaps[0][1] == pytest.approx(350e-6)
    assert "cudaMemcpyAsync" in d.idle_gaps[0][0]
    run = fake_run([], device=d)
    assert reader("device_idle_pct.batch")(run) == pytest.approx(50.0)


def test_a_trace_with_no_device_work_reads_nothing(tmp_path):
    ev = [{"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0.0, "dur": 1000.0}]
    assert devtrace.read(write_trace(tmp_path, ev)) is None
    assert reader("device_idle_pct.import")(fake_run([])) is None
    assert reader("search_roofline_pct.batch")(fake_run([])) is None
    assert reader("search_roofline_pct.pq")(fake_run([])) is None


@pytest.mark.parametrize("name", ["search_roofline_pct.batch", "search_roofline_pct.pq"])
def test_roofline_reader_counts_the_served_work(tmp_path, name):
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0, "dur": 2e6}]
    d = devtrace.read(write_trace(tmp_path, ev))
    reqs = [load.Req(key=i, rows=256, due=0.0, sent=0.0, done=1.0 + i * 0.01, ok=True)
            for i in range(10)]
    cfg = {"n_objects": 1000, "data": {"dim": 64}, "store_bytes_per_value": 4}
    run = fake_run(reqs, device=d, capture={"t0": 0.5, "t1": 1.045}, config=cfg)
    least = max(2 * 5 * 256 * 1000 * 64 / 989e12,
                (5 * 1000 * 64 * 4 + 4 * 5 * 256 * 64) / 3.35e12)
    assert reader(name)(run) == pytest.approx(100 * least / 2.0)
