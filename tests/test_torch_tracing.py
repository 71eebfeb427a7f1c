"""The port's tracing (weaviate_tpu_torch.monitoring.tracing) on the CPU:
the span trees of the gRPC BatchSearch lanes and of the REST batch import,
every span with its start and its thread's CPU time; the device trace
(monitoring/profiling.py) with the spans laid on the profiler's clock; the
dispatch facts the port keeps and the ones it dropped; the perf window's
device time; and the zero-cost contract with the tracer off.
"""

import glob
import json
import os
import signal
import sys
import threading
import time
import urllib.request
import uuid as uuidlib

import numpy as np
import pytest
import torch

from weaviate_tpu_torch.config import load_config
from weaviate_tpu_torch.db.shard import Shard
from weaviate_tpu_torch.entities import schema, storobj
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
from weaviate_tpu_torch.monitoring import costmodel, perf, profiling, tracing
from weaviate_tpu_torch.server import App, RestServer
from weaviate_tpu_torch.server.grpc_server import GrpcServer, SearchClient

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "benchmark"))
from wbench import devtrace  # noqa: E402

N, D, B, K = 2048, 16, 32, 10
DEVICE_STEPS = ["index.snapshot", "index.stage", "index.enqueue", "index.fetch"]
IMPORT_TREE = ("request", [
    ("rest.read", []), ("rest.decode", []),
    ("usecase.add_objects", [
        ("shard.put_batch", [
            ("lsm.put", []), ("inverted.add", []),
            ("index.add_batch", [("index.vector_log", []), ("index.device_write", [])])])]),
    ("rest.reply", [])])
DROPPED = {"mfu_pct", "hbm_bw_pct", "arith_intensity", "regime", "dispatch_wall_ms",
           "dispatch_flops", "dispatch_bytes", "jit_shape_first_seen"}


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """An App chains its device-trace teardown onto SIGTERM: put the
    handler and the teardown state back after this module."""
    keys = ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    state = {k: profiling._teardown_state[k] for k in keys}
    yield
    signal.signal(signal.SIGTERM, handler)
    profiling._teardown_state.update(state)


def _vecs(n=N, seed=0):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def _import_body(vecs, lo, hi):
    return json.dumps({"objects": [
        {"class": "Doc", "id": str(uuidlib.UUID(int=i + 1)), "properties": {"tag": f"t{i % 4}"},
         "vector": vecs[i].tolist()} for i in range(lo, hi)]}).encode()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


@pytest.fixture
def served(tmp_path):
    """-> (app, rest port, gRPC client, the vectors) for an App on the CPU,
    tracing as the environment says, with a filled and flushed class."""
    def make(traced: bool):
        env = {"TRACING_ENABLED": "true"} if traced else {}
        app = App(config=load_config(env), data_path=str(tmp_path / "data"), device="cpu")
        rest = RestServer(app, host="127.0.0.1", port=0)
        rest.start()
        grpc_srv = GrpcServer(app, port=0)
        grpc_srv.start()
        app.schema.add_class({"class": "Doc", "vectorIndexType": "hnsw_tpu",
                              "properties": [{"name": "tag", "dataType": ["text"]}],
                              "vectorIndexConfig": {"distance": "cosine"}})
        vecs = _vecs()
        for lo in range(0, N, 512):
            assert _post(rest.port, "/v1/batch/objects", _import_body(vecs, lo, lo + 512))[0] == 200
        shard = app.db.get_index("Doc").single_local_shard()
        shard.flush()
        shard.store.flush_memtables()
        cli = SearchClient(f"127.0.0.1:{grpc_srv.port}")
        made.append((app, rest, grpc_srv, cli))
        return app, rest.port, cli, vecs

    made = []
    yield make
    for app, rest, grpc_srv, cli in made:
        cli.close()
        grpc_srv.stop()
        rest.stop()
        app.shutdown()


def _new_trace(tracer, before: int, name: str) -> dict:
    """The one trace named `name` past the first `before` of the ring. A
    REST reply goes out before its handler closes the trace: wait for it."""
    deadline = time.monotonic() + 10.0
    while True:
        got = [t for t in tracer.snapshot()[before:] if t["name"] == name]
        if got or time.monotonic() > deadline:
            (tr,) = got
            return tr
        time.sleep(0.01)


def _batch(vecs, **kw):
    return pb.BatchSearchRequest(requests=[pb.SearchRequest(
        class_name="Doc", limit=K, near_vector=pb.NearVectorParams(vector=q.tolist()), **kw)
        for q in vecs[:B]])


def _names(span):
    return [c["name"] for c in span.get("children", [])]


def _child(span, name):
    (c,) = [c for c in span.get("children", []) if c["name"] == name]
    return c


def _walk(span):
    yield span
    for c in span.get("children", []):
        yield from _walk(c)


def _timed_tree(root):
    """Every span has a start, a duration and a CPU time, and each child
    lies inside its parent's interval."""
    for s in _walk(root):
        assert s["duration_ms"] >= 0.0 and s["cpu_ms"] >= 0.0 and "start_ms" in s
        for c in s.get("children", []):
            assert c["start_ms"] >= s["start_ms"] - 1e-3
            assert c["start_ms"] + c["duration_ms"] <= s["start_ms"] + s["duration_ms"] + 1e-2


@pytest.mark.parametrize("lane", ["raw", "general"])
def test_batch_search_span_tree(served, lane):
    """The raw lane: grpc.parse, the shard's dispatch with device_search's
    four steps, grpc.reply, and the protobuf decode as the root's
    attribute (grpc deserializes on a thread of its own). The general
    lane reads alike: grpc.parse and grpc.reply beside the traverser."""
    app, _, cli, vecs = served(True)
    kw = {} if lane == "raw" else {"properties": ["tag"]}
    before = len(app.tracer.snapshot())
    cli.batch_search(_batch(vecs, **kw))
    root = _new_trace(app.tracer, before, "BatchSearch")["root"]
    _timed_tree(root)
    assert root["attrs"]["decode_ms"] >= 0.0 and root["attrs"]["decode_cpu_ms"] >= 0.0
    if lane == "raw":
        assert _names(root) == ["grpc.parse", "dispatch", "grpc.reply"]
        dispatch = _child(root, "dispatch")
    else:
        assert _names(root) == ["grpc.parse", "traverser.get_class_batched", "grpc.reply"]
        dispatch = _child(_child(root, "traverser.get_class_batched"), "dispatch")
    assert _names(dispatch) == ["device_search", "hydrate"]
    # the general lane's dispatch is asynchronous: device_search is the
    # wait on the result, and of the dispatch's steps it holds the fetch
    steps = DEVICE_STEPS if lane == "raw" else ["index.fetch"]
    assert _names(_child(dispatch, "device_search")) == steps
    assert {s["tid"] for s in _walk(root)} == {root["tid"]}


def test_import_span_tree(served):
    """A REST batch import traces once a batch: the body's read and
    decode, the use case, the shard's LSM put, inverted add and index add
    with its vector log and device write, and the reply."""
    app, port, _, vecs = served(True)
    before = len(app.tracer.snapshot())
    assert _post(port, "/v1/batch/objects", _import_body(_vecs(100, 1), 0, 100))[0] == 200
    tr = _new_trace(app.tracer, before, "POST /v1/batch/objects")
    _timed_tree(tr["root"])

    def shape(s):
        return (s["name"], [shape(c) for c in s.get("children", [])])
    assert shape(tr["root"]) == IMPORT_TREE


def _shard(path):
    cd = schema.ClassDef(name="Doc", properties=[], vector_index_type="hnsw_tpu")
    conf = vi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
    shard = Shard("s0", str(path), cd, conf, device="cpu")
    vecs = _vecs()
    shard.put_batch([storobj.StorObj(class_name="Doc", uuid=str(uuidlib.UUID(int=i + 1)),
                                     properties={}, vector=vecs[i]) for i in range(N)])
    return shard, vecs


def _dispatch_attrs(tracer):
    (d,) = [c for c in tracer.snapshot()[-1]["root"]["children"] if c["name"] == "dispatch"]
    return d


def test_dispatch_facts_kept_dropped_and_stage_alloc(tmp_path):
    """A dispatch span keeps the tier and the work as plain facts, carries
    none of the dropped roofline and shape facts, and counts one staging
    allocation on a new bucket shape and none after it."""
    shard, vecs = _shard(tmp_path)
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0))
    try:
        allocs = []
        for rows in (B, B, 3 * B, B):
            with tracing.request("grpc", "search"):
                shard.object_vector_search(vecs[:rows], K)
            d = _dispatch_attrs(tracer)
            allocs.append(d["attrs"]["stage_alloc"])
            assert not DROPPED & set(d["attrs"])
            assert d["attrs"]["tier"] == "exact_scan" and d["attrs"]["flops"] == 2 * rows * N * D
            assert {"n_live", "dim", "bytes"} <= set(d["attrs"])
            assert "device_ms" not in d["attrs"]  # no CUDA events on the CPU
            steps = _child(d, "device_search")
            assert _names(steps) == DEVICE_STEPS
            if allocs[-1]:
                assert _names(_child(steps, "index.stage")) == ["index.stage_alloc"]
        assert allocs == [1, 0, 1, 0]
        assert not hasattr(tracer, "first_shape") and not hasattr(tracing, "note_shape")
    finally:
        tracing.unconfigure(tracer)
        shard.shutdown()


def _capture(tmp_path, during, monkeypatch):
    """A CPU device trace whose window runs `during` on the capturing
    thread in place of its sleep, with a tracer up -> trace.json."""
    sleep, me = time.sleep, threading.current_thread()
    monkeypatch.setattr(profiling.time, "sleep",
                        lambda s: during() if threading.current_thread() is me else sleep(s))
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0, ring_size=1024))
    try:
        profiling.device_trace(str(tmp_path), device="cpu")
    finally:
        tracing.unconfigure(tracer)
        monkeypatch.setattr(profiling.time, "sleep", sleep)
    (path,) = glob.glob(str(tmp_path / "traces" / "*" / "trace.json"))
    with open(path) as f:
        return path, json.load(f)


def test_spans_lie_on_the_profilers_clock(tmp_path, monkeypatch):
    """A traced shard search on the capturing thread: the exported
    device_search event holds the thread's aten:: ops the profiler
    recorded, within 100 us; the two clock readings agree; and every
    exported event lies inside the profiler's first and last event."""
    shard, vecs = _shard(tmp_path / "shard")

    def during():
        for rows in (B, 2 * B):
            with tracing.request("grpc", "search"):
                shard.object_vector_search(vecs[:rows], K)

    try:
        _, doc = _capture(tmp_path, during, monkeypatch)
    finally:
        shard.shutdown()
    events = doc["traceEvents"]
    mine = [e for e in events if "trace_id" in (e.get("args") or {})]
    theirs = [e for e in events if e.get("ph") == "X" and e not in mine]
    assert abs(doc["weaviateClockSync"]["drift_us"]) < 250.0
    lo = min(e["ts"] for e in theirs)
    hi = max(e["ts"] + e["dur"] for e in theirs)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in mine)
    searches = [e for e in mine if e["name"] == "device_search"]
    assert len(searches) == 2 and {e["cat"] for e in searches} == {"program"}
    tid = searches[0]["tid"]
    marks = [e for e in theirs if e["name"] == profiling.CLOCK_MARK]
    ops = [e for e in theirs if e["name"].startswith("aten::") and e["tid"] == tid
           and marks[len(marks) // 2 - 1]["ts"] < e["ts"] < marks[len(marks) // 2]["ts"]]
    assert ops
    for op in ops:
        assert any(s["ts"] - 100.0 <= op["ts"] and op["ts"] + op["dur"] <= s["ts"] + s["dur"] + 100.0
                   for s in searches), op["name"]
    cats = {e["name"]: e["cat"] for e in mine}
    assert cats["grpc search"] == cats["dispatch"] == "program"
    assert cats["hydrate"] == cats["index.fetch"] == "user_annotation"


def test_exported_spans_leave_the_device_window_alone(tmp_path, monkeypatch):
    """devtrace.read gives the same window and busy time with and without
    the exported span events; an idle gap is named by the leaf span open
    in it."""
    shard, vecs = _shard(tmp_path / "shard")

    def during():
        with tracing.request("grpc", "search"):
            shard.object_vector_search(vecs[:B], K)

    try:
        path, doc = _capture(tmp_path, during, monkeypatch)
    finally:
        shard.shutdown()
    events = doc["traceEvents"]
    x = [e for e in events if e.get("ph") == "X" and "trace_id" not in (e.get("args") or {})]
    lo, hi = min(e["ts"] for e in x), max(e["ts"] + e["dur"] for e in x)
    # the CPU profiler records no device work: plant two kernels
    kernels = [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 0,
                "ts": lo + f * (hi - lo), "dur": 0.01 * (hi - lo)} for f in (0.05, 0.9)]
    both = str(tmp_path / "both.json")
    bare = str(tmp_path / "bare.json")
    with open(both, "w") as f:
        json.dump(dict(doc, traceEvents=events + kernels), f)
    with open(bare, "w") as f:
        json.dump(dict(doc, traceEvents=[e for e in events if "trace_id" not in (e.get("args") or {})]
                       + kernels), f)
    a, b = devtrace.read(both), devtrace.read(bare)
    assert a.window_s == b.window_s and a.busy_s == b.busy_s
    leaves = {e["name"] for e in events if e.get("cat") == "user_annotation"
              and "trace_id" in (e.get("args") or {})}
    assert any(g[0].removeprefix("host: ") in leaves for g in a.idle_gaps)


def test_no_timing_event_while_a_profiler_session_is_up(tmp_path, monkeypatch):
    """From before a capture's warm session to after its stop returns, a
    profiler session is up and `hold_off()` refuses, so no traced dispatch
    records a CUDA timing event then. A session starts only once the event
    calls under way are done."""
    seen = []

    def up():
        return profiling._gate_state["sessions"] > 0

    class Prof(torch.profiler.profile):
        def start(self):
            seen.append(("start", up(), profiling.hold_off()))
            super().start()

        def stop(self):
            seen.append(("stop", up(), profiling.hold_off()))
            super().stop()
            seen.append(("stopped", up(), profiling.hold_off()))

    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(profiling, "_warmed", set())  # the warm session runs
    assert profiling.hold_off()  # an event call under way
    capture = threading.Thread(target=profiling.device_trace, args=(str(tmp_path),),
                               kwargs={"seconds": 0.05, "device": "cpu"})
    capture.start()
    time.sleep(0.3)
    assert seen == [] and up()  # waiting for the call
    profiling.let_go()
    capture.join(60)
    assert [s[0] for s in seen] == ["start", "stop", "stopped"] * 2  # warm, then capture
    assert all(up and not held for _, up, held in seen)
    assert not up() and profiling.hold_off()
    profiling.let_go()


class _Trap:
    """Stands for anything the tracer-off path must not touch."""

    def __init__(self, *a, **kw):
        raise AssertionError("touched with the tracer off")

    def __getattr__(self, name):
        raise AssertionError(f"{name} touched with the tracer off")


def test_tracer_off_makes_no_tracer_call_and_no_cuda_event(served, monkeypatch):
    """With the tracer off, the raw lane and the import path stop at the
    `_tracer is None` check: no span, trace, dispatch record, dispatch
    shape or context-variable access, and no CUDA event."""
    app, port, cli, vecs = served(False)
    assert tracing.get_tracer() is None
    for obj, name in ((tracing, "_CURRENT"), (tracing, "_DISPATCH"), (tracing, "Span"),
                      (tracing, "Trace"), (tracing, "DispatchRecord"),
                      (costmodel, "DispatchShape"), (torch.cuda, "Event")):
        monkeypatch.setattr(obj, name, _Trap)
    served_before = app.db.get_index("Doc").object_count()
    assert _post(port, "/v1/batch/objects", _import_body(_vecs(100, 2), 0, 100))[0] == 200
    assert app.db.get_index("Doc").object_count() == served_before  # the same ids, updated
    shard = app.db.get_index("Doc").single_local_shard()
    shard.flush()
    shard.store.flush_memtables()
    raw = sum(1 for _ in range(2) if len(cli.batch_search(_batch(vecs)).replies) == B)
    assert raw == 2


def test_app_on_the_cpu_traces_without_a_card(tmp_path):
    """TRACING_ENABLED on an App on the CPU: the perf window names the
    CPU's peaks instead of asking the card."""
    app = App(config=load_config({"TRACING_ENABLED": "true"}), data_path=str(tmp_path),
              device="cpu")
    try:
        assert app.perf_window.backend == "cpu"
    finally:
        app.shutdown()


@pytest.mark.parametrize("device_ms", [4.0, -1.0], ids=["card-events", "no-events"])
def test_perf_window_reads_the_device_time(device_ms):
    """The duty cycle has one source, the host's enqueue-to-fetch
    interval, whether or not the dispatch's CUDA events measured a
    `device_ms` (they do not during a capture); the blocked fetch is the
    `fetch` stage."""
    busy_ms = 10.0
    w = perf.PerfWindow(window_s=60.0, backend="cpu")
    shape = costmodel.DispatchShape(costmodel.TIER_EXACT, n=1000, dim=16, batch=8,
                                    bytes_per_row=64)
    shape.t_start, shape.t_fetch, shape.t_end = 100.0, 100.010, 100.012
    shape.fetch_ms, shape.device_ms = 1.0, device_ms
    shape.t_fetch_mono = time.monotonic()
    w.record_dispatch(shape, rows=8)
    out = w.summary()
    assert out["device_busy_s"] == pytest.approx(busy_ms / 1000.0, abs=1e-4)
    assert out["device_fetch_s"] == pytest.approx(0.001)
    assert "fetch" in out["phases"] and "device" not in out["phases"]


def _leaf(tid, ts, dur):
    return {"cat": "user_annotation", "tid": tid, "ts": ts, "dur": dur}


def _call(tid, ts):
    return {"ph": "X", "cat": "cuda_runtime", "tid": tid, "ts": ts, "dur": 1.0}


@pytest.mark.parametrize("case", ["pthread-id", "overlapping", "no-calls"])
def test_spans_go_on_the_profilers_track_of_their_thread(case):
    """A span's thread takes the track whose CUDA calls fall most often in
    its leaf spans, whatever id the profiler gave that track; two threads
    never share a track; a thread with no calls in its spans keeps its id."""
    if case == "pthread-id":
        spans = [_leaf(939, 0.0, 100.0)]
        events = [_call(92289344, t) for t in (10.0, 50.0, 90.0)] + [_call(5, 200.0)]
        want = {939: 92289344}
    elif case == "overlapping":
        spans = [_leaf(1, 0.0, 100.0), _leaf(2, 40.0, 100.0)]
        events = ([_call(-7, t) for t in (5.0, 10.0, 20.0, 45.0)]
                  + [_call(3_000_000_000, t) for t in (50.0, 60.0, 70.0, 110.0, 130.0)])
        want = {1: -7, 2: 3_000_000_000}
    else:
        spans = [_leaf(4321, 0.0, 10.0)]
        events = [_call(8, 50.0)]
        want = {}
    assert profiling._tracks(spans, events) == want
