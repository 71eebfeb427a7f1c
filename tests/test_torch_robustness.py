"""The device circuit breaker over the port: `is_device_error` routed for
torch and the port's kernel wrappers, and the breaker's journey on the
port's Shard under injected device faults, held against the JAX
package's Shard on the same objects, on the CPU.

The vectors are integer-valued (exact in f32), as in
tests/test_robustness.py, so the host fallback plane and the device
answer compare exactly.
"""

import time
import uuid as uuidlib

import numpy as np
import pytest
import torch

from weaviate_tpu.db.shard import Shard as JaxShard
from weaviate_tpu.entities import schema as jschema
from weaviate_tpu.entities import storobj as jstorobj
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.serving import robustness as jrobustness
from weaviate_tpu_torch.db.shard import Shard
from weaviate_tpu_torch.entities import filters, schema, storobj
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops import _kernels
from weaviate_tpu_torch.serving import robustness
from weaviate_tpu_torch.testing import faults

N, DIM, K = 300, 16, 5


# -- classification ---------------------------------------------------------------


def _shape_error() -> RuntimeError:
    try:
        torch.zeros(3, 4) @ torch.zeros(5, 6)
    except RuntimeError as e:
        return e
    raise AssertionError("a shape mismatch did not raise")


def _build_error(tmp_path, monkeypatch) -> RuntimeError:
    """The error `_kernels.build` raises for a source that does not
    compile (a stand-in compiler that fails, as nvcc would)."""
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: expected a declaration' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="nvcc failed") as err:
        _kernels.build("broken")
    return err.value


@pytest.mark.parametrize("make,device", [
    (lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB"), True),
    (lambda: torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (lambda: _kernels.KernelLaunchError("gmin_scan kernel launch failed: invalid argument"),
     True),
    (lambda: RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (lambda: RuntimeError("CUDA driver error: unknown error"), True),
    (lambda: faults.InjectedDeviceError("x"), True),
    (lambda: faults.InjectedOOMError("x"), True),
    (lambda: ValueError("dim mismatch: index has 16, got 8"), False),
    (lambda: ValueError("the kernel takes at most 16 store slices, got 32"), False),
    (_shape_error, False),
    (lambda: RuntimeError("logic bug"), False),
], ids=["torch-oom", "cuda-oom", "kernel-launch", "cuda-error", "cuda-driver-error",
        "injected", "injected-oom", "value-error", "kernel-shape", "shape-mismatch", "plain"])
def test_is_device_error_classification(make, device):
    assert robustness.is_device_error(make()) is device


def test_accelerator_error_is_a_device_error():
    """torch.AcceleratorError, where this torch has it, by its module and
    name (the classifier imports no torch)."""
    acc = getattr(torch, "AcceleratorError", None)
    if acc is None:
        fake = type("AcceleratorError", (RuntimeError,), {})
        fake.__module__ = "torch"
        acc = fake
    assert robustness.is_device_error(acc("an accelerator fault"))
    sub = type("LaterAcceleratorError", (acc,), {})
    assert robustness.is_device_error(sub("a subclass counts too"))


def test_a_failed_kernel_build_is_not_a_device_error(tmp_path, monkeypatch):
    err = _build_error(tmp_path, monkeypatch)
    assert not isinstance(err, _kernels.KernelLaunchError)
    assert not robustness.is_device_error(err)


@pytest.mark.parametrize("rc,device", [
    (2, True), (214, True), (700, True), (702, True), (710, True), (715, True), (719, True),
    (1, False), (9, False), (98, False), (701, False), (801, False), (999, False),
], ids=["alloc", "ecc", "illegal-address", "timeout", "assert", "illegal-instruction",
        "launch-failure", "invalid-value", "invalid-configuration", "invalid-image",
        "too-many-resources", "not-supported", "unknown"])
def test_a_kernel_error_code_is_a_device_error_only_for_a_card_fault(rc, device):
    """A wrapper's error for its C entry point's code: a card fault is a
    KernelLaunchError and feeds the breaker; a code the same call gives
    on a healthy card (an argument or plan fault) is a KernelCallError
    and does not."""
    err = _kernels.launch_error("gmin_scan kernel launch failed", rc, "some text")
    assert isinstance(err, RuntimeError) and "launch failed" in str(err)
    assert isinstance(err, _kernels.KernelLaunchError) is device
    assert isinstance(err, _kernels.KernelCallError) is not device
    assert robustness.is_device_error(err) is device


def test_jax_errors_keep_their_own_classification():
    """The reference's classifier is untouched: it still keys on jaxlib,
    and the port's keys on torch; both honour the device_error attribute."""
    launch = _kernels.KernelLaunchError("launch failed")
    assert jrobustness.is_device_error(launch)  # the shared attribute rule
    assert not jrobustness.is_device_error(RuntimeError("CUDA error: x"))
    rt = type("SomeRuntimeFault", (RuntimeError,), {})
    rt.__module__ = "jaxlib.xla_extension"
    assert jrobustness.is_device_error(rt("device halted"))
    assert not robustness.is_device_error(rt("device halted"))


# -- the breaker on the Shard ---------------------------------------------------------


def _vectors():
    rng = np.random.default_rng(23)
    return rng.integers(-8, 8, (N, DIM)).astype(np.float32)


def _tie_free_queries(vecs, count):
    out, i = [], 0
    while len(out) < count:
        q = vecs[i] + 0.5
        i += 1
        d = np.sort(((vecs - q) ** 2).sum(1))[: K + 8]
        if len(np.unique(d)) == len(d):
            out.append(q)
    return np.stack(out)


def _shard(pkg, path, vecs):
    sch, so, v = pkg
    cd = sch.ClassDef(name="Ro", properties=[sch.Property(name="tag", data_type=["text"])],
                      vector_index_type="hnsw_tpu")
    cfg = v.parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
    kw = {"device": "cpu"} if v is vi else {}
    shard = (Shard if v is vi else JaxShard)("s0", str(path), cd, cfg, **kw)
    errs = shard.put_batch([
        so.StorObj(class_name="Ro", uuid=str(uuidlib.UUID(int=i + 1)),
                   properties={"tag": "even" if i % 2 == 0 else "odd"}, vector=vecs[i])
        for i in range(len(vecs))])
    assert errs == [None] * len(vecs)
    return shard


PORT = (schema, storobj, vi)
JAX = (jschema, jstorobj, jvi)


def _rows(results):
    return [[(r.obj.uuid, r.distance) for r in row] for row in results]


@pytest.fixture
def breaker():
    br = robustness.configure_breaker(robustness.CircuitBreaker(failure_threshold=3,
                                                                reset_timeout_s=0.15))
    inj = faults.configure(faults.FaultInjector())
    yield br, inj
    faults.unconfigure(inj)
    robustness.unconfigure_breaker(br)


def test_device_error_journey_breaker_trips_and_recovers(tmp_path, breaker):
    """Injected device errors at the port's dispatch (index.gpu.dispatch,
    under db.shard.search) each degrade to the host plane with the right
    answer, trip the breaker open after three, the host plane serves while
    it is open, and once the fault clears a half-open probe closes it and
    the host rows are released. Every answer equals the JAX Shard's on the
    same objects."""
    br, inj = breaker
    vecs = _vectors()
    shard = _shard(PORT, tmp_path / "torch", vecs)
    jshard = _shard(JAX, tmp_path / "jax", vecs)
    try:
        queries = _tie_free_queries(vecs, 6)
        expected = _rows(jshard.object_vector_search(queries, K))
        assert _rows(shard.object_vector_search(queries, K)) == expected
        inj.plan("index.gpu.dispatch", "device_error", times=None)
        for i in range(3):
            assert br.state() == robustness.STATE_CLOSED
            assert _rows(shard.object_vector_search(queries, K)) == expected
        assert br.state() == robustness.STATE_OPEN
        assert inj.injected("index.gpu.dispatch") == 3
        # open: the shard does not dispatch, the host plane serves
        assert _rows(shard.object_vector_search(queries, K)) == expected
        assert inj.injected("index.gpu.dispatch") == 3
        assert shard.vector_index._host_rows_cache is not None
        assert shard.debug_health()["host_fallback_cache_bytes"] > 0
        # the async lane's open-breaker closure serves from the host too
        assert _rows(shard.object_vector_search_async(queries, K)()) == expected
        inj.clear()
        time.sleep(0.2)
        assert _rows(shard.object_vector_search(queries, K)) == expected
        assert br.state() == robustness.STATE_CLOSED
        assert shard.vector_index._host_rows_cache is None
    finally:
        shard.shutdown()
        jshard.shutdown()


def test_device_error_at_fetch_degrades_the_async_lane(tmp_path, breaker):
    """A device error at the finalize fetch (index.gpu.finalize) of an
    async dispatch feeds the breaker and answers from the host plane."""
    br, inj = breaker
    vecs = _vectors()
    shard = _shard(PORT, tmp_path, vecs)
    try:
        queries = _tie_free_queries(vecs, 4)
        expected = _rows(shard.object_vector_search(queries, K))
        inj.plan("index.gpu.finalize", "device_error", times=1)
        done = shard.object_vector_search_async(queries, K)
        assert _rows(done()) == expected
        assert br._consecutive == 1
    finally:
        shard.shutdown()


def test_zero_device_work_never_feeds_the_breaker(tmp_path, breaker):
    """A search that succeeds WITHOUT device work (an empty allowList)
    must not reset the consecutive-failure count."""
    br, inj = breaker
    robustness.unconfigure_breaker(br)
    br = robustness.configure_breaker(robustness.CircuitBreaker(failure_threshold=2,
                                                                reset_timeout_s=60.0))
    vecs = _vectors()
    shard = _shard(PORT, tmp_path, vecs)
    try:
        empty = filters.LocalFilter.from_dict(
            {"path": ["tag"], "operator": "Equal", "valueText": "nosuchtag"})
        inj.plan("index.gpu.dispatch", "device_error", times=1)
        assert shard.object_vector_search(vecs[0], K)[0]  # failure 1, host plane
        assert br.state() == robustness.STATE_CLOSED
        assert shard.object_vector_search(vecs[0], K, flt=empty) == [[]]
        inj.plan("index.gpu.dispatch", "device_error", times=1)
        shard.object_vector_search(vecs[0], K)  # failure 2 trips it
        assert br.state() == robustness.STATE_OPEN
    finally:
        robustness.unconfigure_breaker(br)
        shard.shutdown()


def test_a_programming_error_is_raised_not_served_from_the_host(tmp_path, breaker):
    """A query of the wrong width raises its ValueError; the breaker does
    not count it and the host plane does not answer it."""
    br, _ = breaker
    shard = _shard(PORT, tmp_path, _vectors())
    try:
        with pytest.raises(ValueError, match="dim mismatch"):
            shard.object_vector_search(np.zeros(DIM + 1, np.float32), K)
        assert br._consecutive == 0
        assert shard.vector_index._host_rows_cache is None
    finally:
        shard.shutdown()


@pytest.mark.parametrize("rc", [1, 700], ids=["call-fault", "card-fault"])
def test_a_kernel_error_through_the_shard(tmp_path, breaker, monkeypatch, rc):
    """A kernel wrapper's error under Shard.object_vector_search: a card
    fault counts against the breaker and the host plane answers; a
    refused call raises to the caller, uncounted, and no host rows are
    made."""
    br, _ = breaker
    vecs = _vectors()
    shard = _shard(PORT, tmp_path, vecs)
    err = _kernels.launch_error("gmin_scan kernel launch failed", rc, "some text")

    def refuse(*args, **kwargs):
        raise err

    monkeypatch.setattr(shard.vector_index, "_dispatch_scan", refuse)
    try:
        if rc in _kernels.DEVICE_FAULT_CODES:
            got = shard.object_vector_search(vecs[0], K)[0]
            assert [r.obj.uuid for r in got][0] == str(uuidlib.UUID(int=1))
            assert br._consecutive == 1
        else:
            with pytest.raises(_kernels.KernelCallError, match="launch failed"):
                shard.object_vector_search(vecs[0], K)
            assert br._consecutive == 0
            assert shard.vector_index._host_rows_cache is None
    finally:
        shard.shutdown()
