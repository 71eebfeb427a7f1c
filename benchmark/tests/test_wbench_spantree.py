"""The readers of single span-tree steps over hand-made traces: the gRPC
raw lane's parse and reply, the dispatch's fetch, off-CPU time and device
time, the import's decode, storage writes and device write; and nothing
read from a program that does not record those steps."""

import pytest

from wbench import spec
from test_wbench_readers import fake_run, trace

BATCH_NAMES = ["grpc_parse_ms.batch", "grpc_reply_ms.batch", "index_fetch_ms.batch",
               "index_offcpu_ms.batch", "device_dispatch_ms.batch"]
IMPORT_NAMES = ["import_decode_ms.import", "import_store_ms.import",
                "import_device_add_ms.import"]


def span(name, ms, children=(), **kw):
    return {"name": name, "duration_ms": ms, "children": list(children), **kw}


def batch_trace(i):
    steps = [span("index.snapshot", 0.1), span("index.stage", 0.4),
             span("index.enqueue", 0.3), span("index.fetch", 2.0 + i)]
    disp = span("dispatch", 10.0, [span("device_search", 3.0 + i, steps, cpu_ms=1.0),
                                   span("hydrate", 7.0)], attrs={"device_ms": 0.5 + i})
    return trace("grpc", "BatchSearch", 20.0,
                 [span("grpc.parse", 4.0 + i), disp, span("grpc.reply", 1.0 + i)])


def import_trace(i):
    put = span("shard.put_batch", 12.0, [
        span("lsm.put", 3.0 + i), span("inverted.add", 1.0),
        span("index.add_batch", 5.0, [span("index.vector_log", 2.0),
                                      span("index.device_write", 2.5 + i)])])
    return trace("rest", "POST /v1/batch/objects", 22.0, [
        span("rest.read", 0.5), span("rest.decode", 6.0 + i),
        span("usecase.add_objects", 14.0, [put]), span("rest.reply", 1.0)])


def test_span_tree_readers():
    run = fake_run([], traces=[batch_trace(i) for i in range(3)]
                   + [import_trace(i) for i in range(3)])
    want = {"grpc_parse_ms.batch": 5.0, "grpc_reply_ms.batch": 2.0,
            "index_fetch_ms.batch": 3.0, "index_offcpu_ms.batch": 3.0,
            "device_dispatch_ms.batch": 1.5, "import_decode_ms.import": 7.0,
            "import_store_ms.import": 7.0, "import_device_add_ms.import": 3.5}
    for name, value in want.items():
        assert spec.metric_reader(name)(run) == pytest.approx(value), name
    # the root's self time now leaves out the parse and the reply
    assert spec.metric_reader("server_self_ms.batch")(run) == pytest.approx(20.0 - 17.0)


def test_offcpu_is_the_mean_over_tick_sampled_cpu_time():
    """Where the thread CPU clock advances in 10 ms ticks, `cpu_ms` reads
    0 or 10 for the same 3 ms of work: the mean of wall less CPU comes out
    right where a p50 would read the wall."""
    traces = []
    for i in range(10):
        t = batch_trace(0)
        (ds,) = [c for c in t["root"]["children"][1]["children"] if c["name"] == "device_search"]
        ds.update(duration_ms=8.0, cpu_ms=10.0 if i < 3 else 0.0)
        traces.append(t)
    assert spec.metric_reader("index_offcpu_ms.batch")(fake_run([], traces=traces)) == \
        pytest.approx(5.0)


@pytest.mark.parametrize("name", BATCH_NAMES + IMPORT_NAMES)
def test_a_program_without_the_steps_reads_nothing(name):
    """The traces of a program before these spans: a dispatch with only
    its phases, the host's shared `device_ms`, no cpu_ms; an import root
    with no children."""
    disp = span("dispatch", 10.0, [span("device_search", 3.0), span("hydrate", 7.0)],
                attrs={"device_ms": 3.0, "dispatch_device_ms": 3.0})
    run = fake_run([], traces=[trace("grpc", "BatchSearch", 20.0, [disp]),
                               trace("rest", "POST /v1/batch/objects", 22.0, [])])
    assert spec.metric_reader(name)(run) is None
