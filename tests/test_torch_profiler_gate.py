"""The port's gate between a profiler session's start and stop and the
index's device work (monitoring/profiling.py `launching`, `_switching`):
a start or stop waits for the dispatches under way and holds new ones off,
each wait bounded; a device trace on the CPU passes through it beside
searches that keep running, and traces how long each start and stop
holds the dispatches off."""

import signal
import threading
import time

import numpy as np
import pytest

from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.index.gpu import GpuVectorIndex
from weaviate_tpu_torch.monitoring import profiling, tracing


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """A device trace chains its teardown onto SIGTERM: put the handler and
    the teardown state back after this module."""
    keys = ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    state = {k: profiling._teardown_state[k] for k in keys}
    yield
    signal.signal(signal.SIGTERM, handler)
    profiling._teardown_state.update(state)


def _held(cm, entered, release):
    with cm:
        entered.set()
        release.wait(10)


def test_a_dispatch_waits_for_a_start_or_stop_under_way():
    entered, release, done = threading.Event(), threading.Event(), threading.Event()
    t = threading.Thread(target=_held, args=(profiling._switching(), entered, release))
    t.start()
    assert entered.wait(5)

    def dispatch():
        with profiling.launching():
            done.set()
    d = threading.Thread(target=dispatch)
    d.start()
    assert not done.wait(0.3)
    release.set()
    assert done.wait(5)
    t.join(5)
    d.join(5)
    assert profiling._gate_state["switching"] == profiling._gate_state["launching"] == 0


def test_a_start_or_stop_waits_for_the_dispatches_under_way(monkeypatch):
    entered, release, switched = threading.Event(), threading.Event(), threading.Event()
    t = threading.Thread(target=_held, args=(profiling.launching(), entered, release))
    t.start()
    assert entered.wait(5)

    def switch():
        with profiling._switching():
            switched.set()
    s = threading.Thread(target=switch)
    s.start()
    assert not switched.wait(0.3)
    release.set()
    assert switched.wait(5)
    t.join(5)
    s.join(5)
    # bounded: a dispatch that does not end holds a switch off for _GATE_WAIT_S only
    monkeypatch.setattr(profiling, "_GATE_WAIT_S", 0.2)
    entered.clear()
    release.clear()
    t = threading.Thread(target=_held, args=(profiling.launching(), entered, release))
    t.start()
    assert entered.wait(5)
    t0 = time.monotonic()
    with profiling._switching():
        assert 0.15 <= time.monotonic() - t0 < 5
    release.set()
    t.join(5)
    assert profiling._gate_state["switching"] == profiling._gate_state["launching"] == 0


def test_a_device_trace_beside_running_searches(tmp_path):
    rng = np.random.default_rng(0)
    idx = GpuVectorIndex(vi.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                         str(tmp_path / "idx"), device="cpu")
    idx.add_batch(list(range(500)), rng.standard_normal((500, 16)).astype(np.float32))
    q = rng.standard_normal((8, 16)).astype(np.float32)
    want = idx.search_by_vectors(q, 5)
    stop, got = threading.Event(), []

    def search():
        while not stop.is_set():
            got.append(idx.search_by_vectors(q, 5))
    threads = [threading.Thread(target=search) for _ in range(3)]
    for t in threads:
        t.start()
    try:
        out = profiling.device_trace(str(tmp_path / "data"), seconds=0.2, device=None)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert "device trace written to" in out
    assert got and all(np.array_equal(g[0], want[0]) for g in got)
    assert profiling._gate_state["switching"] == profiling._gate_state["launching"] == 0


def test_each_start_and_stop_is_traced_as_the_time_it_holds_dispatches_off(tmp_path):
    tracer = tracing.configure(tracing.Tracer(sample_rate=1.0, ring_size=64))
    try:
        profiling.device_trace(str(tmp_path), seconds=0.05, device="cpu")
        (tr,) = [t for t in tracer.snapshot() if t["name"] == "device_trace"]
    finally:
        tracing.unconfigure(tracer)
    names = [c["name"] for c in tr["root"]["children"]]
    assert names[-2:] == ["profiler.start", "profiler.stop"]
    assert set(names) <= {"profiler.warm_start", "profiler.warm_stop", "profiler.start",
                          "profiler.stop"}
    assert all(c["duration_ms"] >= 0.0 for c in tr["root"]["children"])
    assert profiling._gate_state["switching"] == profiling._gate_state["launching"] == 0
