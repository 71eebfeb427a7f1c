"""The port's query coalescer (weaviate_tpu_torch.serving.coalescer) and
control plane (serving/controller.py) on the port's App, on the CPU:
concurrent single-query Gets coalesce into shared dispatches and answer
exactly what the direct path and the JAX package's coalesced App answer;
lanes form; the queue sheds at `max_queued_rows`; and a control plane that
steps `rescore_r_cap` down gives the port's PQ tiers the same candidate
depth r and the same answers as the JAX index at the same cap.

Small-integer vectors make every distance exact in f32, so a coalesced
answer equals the direct one bit for bit (the reference's
tests/test_coalescer.py contract); the PQ comparison holds doc ids equal
and distances at rtol 1e-5, atol 1e-5.
"""

import signal
import threading
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.config import Config as JaxConfig
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.entities.storobj import StorObj as JaxStorObj
from weaviate_tpu.index import new_vector_index as jax_new_index
from weaviate_tpu.serving import controller as jcontroller
from weaviate_tpu.server import App as JaxApp
from weaviate_tpu.usecases.traverser import GetParams as JaxGetParams
from weaviate_tpu_torch.config import Config
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.entities.storobj import StorObj
from weaviate_tpu_torch.index import new_vector_index as torch_new_index
from weaviate_tpu_torch.serving import controller, robustness
from weaviate_tpu_torch.server import App
from weaviate_tpu_torch.usecases.traverser import GetParams

N, DIM, K = 400, 16, 5
PORT = (App, Config, StorObj, GetParams, {"device": "cpu"})
JAX = (JaxApp, JaxConfig, JaxStorObj, JaxGetParams, {})


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """Each package's App chains its device-trace teardown onto SIGTERM.
    Put the handler and both packages' teardown state back after this
    module, so later tests in the same process find them as they were."""
    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    mods, keys = (jax_profiling, torch_profiling), ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    states = [{k: m._teardown_state[k] for k in keys} for m in mods]
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, st in zip(mods, states):
        m._teardown_state.update(st)


def _mk_app(pkg, path, window_ms=200.0, max_batch=256, max_request_rows=16,
            max_queued_rows=4096):
    app_cls, cfg_cls, obj_cls, _, kw = pkg
    cfg = cfg_cls()
    cfg.coalescer.enabled = True
    cfg.coalescer.window_ms = window_ms
    cfg.coalescer.max_batch = max_batch
    cfg.coalescer.max_request_rows = max_request_rows
    cfg.coalescer.max_queued_rows = max_queued_rows
    app = app_cls(config=cfg, data_path=str(path), **kw)
    app.schema.add_class({
        "class": "Co", "vectorIndexType": "hnsw_tpu",
        "vectorIndexConfig": {"distance": "l2-squared"},
        "properties": [{"name": "tag", "dataType": ["text"]}],
    })
    vecs = np.random.default_rng(11).integers(-8, 8, (N, DIM)).astype(np.float32)
    idx = app.db.get_index("Co")
    idx.put_batch([obj_cls(class_name="Co", uuid=str(uuidlib.UUID(int=i + 1)),
                           properties={"tag": "even" if i % 2 == 0 else "odd"}, vector=vecs[i])
                   for i in range(N)])
    return app, idx, vecs


def _tie_free_queries(vecs, count):
    """Queries whose top-(K+8) exact distances are all distinct: a tie at
    the top-k boundary is resolved by selection order, which differs
    between a 1-wide and a coalesced dispatch."""
    out, i = [], 0
    while len(out) < count:
        q = vecs[i] + 0.5
        i += 1
        d = np.sort(((vecs - q) ** 2).sum(1))[:K + 8]
        if len(np.unique(d)) == len(d):
            out.append(q)
    return out


def _rows(results):
    return [(r.obj.uuid, r.distance) for r in results]


def _concurrent_gets(app, params_cls, queries):
    got = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def run(i):
        barrier.wait()
        got[i] = _rows(app.traverser.get_class(params_cls(
            class_name="Co", near_vector={"vector": queries[i].tolist()}, limit=K)))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return got


def test_coalesced_equals_direct_and_the_reference(tmp_path):
    answers, stats = {}, {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        app, idx, vecs = _mk_app(pkg, tmp_path / name)
        try:
            queries = _tie_free_queries(vecs, 12)
            direct = [_rows(idx.object_vector_search(q, K)[0]) for q in queries]
            answers[name] = _concurrent_gets(app, pkg[3], queries)
            assert answers[name] == direct
            stats[name] = app.coalescer.stats()
        finally:
            app.shutdown()
    assert answers["torch"] == answers["jax"]
    assert stats["torch"]["requests"] == 12


def test_lanes_form(tmp_path):
    """Barrier-released threads land inside one 200 ms window: the lane
    merges them into fewer dispatches than requests."""
    app, idx, vecs = _mk_app(PORT, tmp_path)
    try:
        queries = _tie_free_queries(vecs, 16)
        _concurrent_gets(app, GetParams, queries)
        st = app.coalescer.stats()
        assert st["requests"] == 16 and st["rows"] == 16
        assert 1 <= st["dispatches"] < 16
    finally:
        app.shutdown()


def test_queue_sheds_at_max_queued_rows(tmp_path):
    app, idx, vecs = _mk_app(PORT, tmp_path, window_ms=5000.0, max_queued_rows=3)
    try:
        shard = idx.single_local_shard()
        co = app.coalescer
        waits = [co.submit(shard, vecs[i], K) for i in range(3)]
        assert all(w is not None for w in waits)
        with pytest.raises(robustness.OverloadedError) as ei:
            co.submit(shard, vecs[3], K)
        assert ei.value.retry_after_s > 0
        assert co.stats()["shed"].get("queue_full") == 1
        # a shed request does not fall through to the direct path
        with pytest.raises(robustness.OverloadedError):
            app.traverser.get_class(GetParams(
                class_name="Co", near_vector={"vector": vecs[5].tolist()}, limit=K))
    finally:
        app.shutdown()  # the queued waiters get the shutdown error


# -- the control plane's rescore cap in both packages' PQ tiers ---------------

PQ_N, PQ_D, PQ_K = 3000, 32, 10


def _pq_pair(tmp_path, rescore, **pq):
    """A JAX index built and compressed, then restarted from its directory
    in both packages (both lay the replayed rows out in the same slots)."""
    conf = {"distance": "l2-squared",
            "pq": {"enabled": True, "segments": 8, "centroids": 32, "rescore": rescore, **pq}}
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((PQ_N, PQ_D)).astype(np.float32)
    w = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path))
    w.add_batch(np.arange(PQ_N), vecs)
    w.flush()
    w.shutdown()
    j = jax_new_index(jvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path))
    t = torch_new_index(tvi.parse_and_validate_config("hnsw_tpu", conf), str(tmp_path),
                        device="cpu")
    assert j.compressed and t.compressed
    return j, t, rng.standard_normal((4, PQ_D)).astype(np.float32)


def _spy_r(idx, seen):
    orig = idx._rescore_r

    def spy(k, n):
        r = orig(k, n)
        seen.append(r)
        return r

    idx._rescore_r = spy


@pytest.mark.parametrize("rescore", [True, False], ids=["rescored", "codes"])
@pytest.mark.parametrize("cap", [128, 64, 32])
def test_stepped_down_rescore_cap_gives_both_packages_the_same_r_and_answers(
        tmp_path, rescore, cap):
    j, t, q = _pq_pair(tmp_path, rescore)
    planes = (jcontroller.configure(jcontroller.ControlPlane(start=False)),
              controller.configure(controller.ControlPlane(start=False)))
    try:
        for p, mod in zip(planes, (jcontroller, controller)):
            assert p._set_knob(mod.KNOB_RESCORE_CAP, cap, "test") == cap
            assert mod.rescore_r_cap(128) == cap
        seen_j, seen_t = [], []
        _spy_r(j, seen_j)
        _spy_r(t, seen_t)
        for b in (1, 4):
            got_t = t.search_by_vectors(q[:b], PQ_K)
            got_j = j.search_by_vectors(q[:b], PQ_K)
            np.testing.assert_array_equal(got_t[0], got_j[0])
            np.testing.assert_allclose(got_t[1], got_j[1], rtol=1e-5, atol=1e-5)
        want_r = min(4 * PQ_K, cap)  # 40, or the cap below it
        assert j._rescore_r(PQ_K, PQ_N) == t._rescore_r(PQ_K, PQ_N) == want_r
        assert seen_t == seen_j
        if rescore:
            assert seen_t and set(seen_t) == {want_r}
    finally:
        jcontroller.unconfigure(planes[0])
        controller.unconfigure(planes[1])
        j.shutdown()
        t.shutdown()


@pytest.mark.parametrize("c_cap, rc_cap", [(4096, 256), (1024, 64), (256, 32)])
def test_stepped_down_funnel_caps_give_both_packages_the_same_funnel(tmp_path, c_cap, rc_cap):
    """The 4-bit funnel reads the plane's two caps with the reference's
    floors: the same stage budgets in health() and the same answers."""
    j, t, q = _pq_pair(tmp_path, True, bits=4)
    planes = (jcontroller.configure(jcontroller.ControlPlane(start=False)),
              controller.configure(controller.ControlPlane(start=False)))
    try:
        for p, mod in zip(planes, (jcontroller, controller)):
            assert p._set_knob(mod.KNOB_FUNNEL_C, c_cap, "test") == c_cap
            assert p._set_knob(mod.KNOB_FUNNEL_RESCORE, rc_cap, "test") == rc_cap
        got_t, got_j = t.search_by_vectors(q, PQ_K), j.search_by_vectors(q, PQ_K)
        np.testing.assert_array_equal(got_t[0], got_j[0])
        np.testing.assert_allclose(got_t[1], got_j[1], rtol=1e-5, atol=1e-5)
        keys = ("stage1_c", "stage2_rescore", "c_cap", "rescore_cap")
        ft, fj = t.health()["pq"]["funnel"], j.health()["pq"]["funnel"]
        assert {k: ft[k] for k in keys} == {k: fj[k] for k in keys}
        assert (ft["c_cap"], ft["rescore_cap"]) == (c_cap, rc_cap)
    finally:
        jcontroller.unconfigure(planes[0])
        controller.unconfigure(planes[1])
        j.shutdown()
        t.shutdown()


def test_rescore_cap_scales_the_codes_tier_pool_with_its_floor(tmp_path, monkeypatch):
    """Past one scan chunk the codes tier's per-chunk depth follows the
    pool (1024 rows by default): the plane's cap scales the pool down,
    never below 512 rows (the reference's rule, index/tpu.py)."""
    from weaviate_tpu_torch.index import gpu

    monkeypatch.setattr(gpu, "_SCAN_CHUNK", 1024)  # 3000 rows: 3 chunks
    _, t, q = _pq_pair(tmp_path, False)
    seen = []
    orig = gpu._search_pq_recon

    def spy(*a, **kw):
        seen.append(a[8])  # r_chunk
        return orig(*a, **kw)

    monkeypatch.setattr(gpu, "_search_pq_recon", spy)
    plane = controller.configure(controller.ControlPlane(start=False))
    try:
        want = {}
        for cap in (128, 64, 32):
            plane._set_knob(controller.KNOB_RESCORE_CAP, cap, "test")
            ids, _ = t.search_by_vectors(q[:2], PQ_K)
            assert (ids != np.iinfo(np.uint64).max).all()
            want[cap] = seen[-1]
        # a pool of 1024 over 3 chunks -> 342 a chunk, capped at 256; cap
        # 64 halves the pool to 512 -> 171; cap 32 would quarter it to
        # 256 (86 a chunk), but the pool's 512 floor holds
        assert want == {128: 256, 64: 171, 32: 171}
    finally:
        controller.unconfigure(plane)
        t.shutdown()
