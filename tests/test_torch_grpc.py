"""The port's gRPC servicer (weaviate_tpu_torch.server.grpc_server) against
the JAX package's, each over its own App in one process, fed the same
objects (the committed recall fixture, 8192 x 32) and the same requests:
`Search`, `BatchSearch` narrow (the hydrated lane) and wide, the raw batch
lane against the hydrated lane, the native reply marshaller against the
upb path, and the reference's `SearchClient` talking to the port's server.

The two packages' `weaviate_pb2` are byte-identical copies of one
descriptor, so their message classes are shared in one process.

Tolerances: uuids equal (tie-free fixture data); distances rtol 1e-5, atol
1e-5; recall@10 against the fixture's exact ground truth >= 0.99.
"""

import json
import signal
import os
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.grpcapi import weaviate_pb2 as jpb
from weaviate_tpu.server import App as JaxApp
from weaviate_tpu.server.grpc_server import GrpcServer as JaxGrpcServer
from weaviate_tpu.server.grpc_server import SearchClient as JaxSearchClient
from weaviate_tpu.server.grpc_server import SearchServicer as JaxSearchServicer
from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
from weaviate_tpu_torch.server import App
from weaviate_tpu_torch.server.grpc_server import (GrpcServer, SearchClient, SearchServicer,
                                                    fast_reply_bytes, result_to_proto)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "recall_fixture.npz")
K = 10


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


class _Ctx:
    def abort(self, *a):
        raise AssertionError(a)


def _fill(app, vecs):
    app.schema.add_class({
        "class": "Doc",
        "properties": [{"name": "tag", "dataType": ["text"]},
                       {"name": "rank", "dataType": ["int"]}],
        "vectorIndexType": "hnsw_tpu",
        "vectorIndexConfig": {"distance": "l2-squared"},
    })
    for s in range(0, len(vecs), 4096):
        app.batch.add_objects([{
            "class": "Doc", "id": str(uuidlib.UUID(int=i + 1)),
            "properties": {"tag": f"t{i % 32}", "rank": i}, "vector": vecs[i].tolist(),
        } for i in range(s, min(s + 4096, len(vecs)))])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data = np.load(FIXTURE)
    vecs, queries, gt = data["vectors"].astype(np.float32), data["queries"].astype(np.float32), data["gt"]
    out = {}
    for name, app_cls, srv_cls, cli_cls, kw in (
            ("jax", JaxApp, JaxGrpcServer, JaxSearchClient, {}),
            ("torch", App, GrpcServer, SearchClient, {"device": "cpu"})):
        app = app_cls(data_path=str(tmp_path_factory.mktemp(name)), **kw)
        _fill(app, vecs)
        srv = srv_cls(app, port=0)
        srv.start()
        out[name] = (app, srv, cli_cls(f"127.0.0.1:{srv.port}"))
    yield out, vecs, queries, gt
    for app, srv, cli in out.values():
        cli.close()
        srv.stop()
        app.shutdown()


def _search_req(q, **kw):
    return pb.SearchRequest(class_name="Doc", limit=K,
                            near_vector=pb.NearVectorParams(vector=q.tolist()), **kw)


def _batch(queries, **kw):
    return pb.BatchSearchRequest(requests=[_search_req(q, **kw) for q in queries])


def _parse_batch(got):
    if isinstance(got, (bytes, bytearray)):
        return pb.BatchSearchReply.FromString(got)
    return got


def _same_reply(a, b, one_app=False):
    """Replies equal in ids, distances and properties; from one App, in
    the objects' timestamps too (two Apps stamp their imports apart)."""
    assert len(a.results) == len(b.results) > 0
    for x, y in zip(a.results, b.results):
        assert x.id == y.id
        np.testing.assert_allclose(x.distance, y.distance, rtol=1e-5, atol=1e-5)
        assert json.loads(x.properties_json) == json.loads(y.properties_json)
        if one_app:
            assert x.creation_time_unix == y.creation_time_unix


def _recall(replies, gt):
    got = [[uuidlib.UUID(r.id).int - 1 for r in one.results] for one in replies]
    return np.mean([len(set(g) & set(w[:K])) / K for g, w in zip(got, gt)])


def test_search_matches_reference(setup):
    servers, _, queries, gt = setup
    replies = []
    for q in queries[:40]:
        want = servers["jax"][2].search(_search_req(q, additional_properties=["distance"]))
        got = servers["torch"][2].search(_search_req(q, additional_properties=["distance"]))
        _same_reply(got, want)
        replies.append(got)
    assert _recall(replies, gt[:40]) >= 0.99


@pytest.mark.parametrize("width", [8, 200], ids=["narrow", "wide"])
def test_batch_search_matches_reference(setup, width):
    servers, _, queries, gt = setup
    breq = _batch(queries[:width])
    want = servers["jax"][2].batch_search(breq)
    got = servers["torch"][2].batch_search(breq)
    assert len(got.replies) == len(want.replies) == width
    for a, b in zip(got.replies, want.replies):
        _same_reply(a, b)
    assert _recall(got.replies, gt[:width]) >= 0.99


def test_reference_client_gets_the_same_answers_from_the_port(setup):
    servers, _, queries, _ = setup
    ref_client = servers["jax"][2]
    port_client_on_ref = JaxSearchClient(f"127.0.0.1:{servers['torch'][1].port}")
    try:
        for q in queries[:8]:
            req = jpb.SearchRequest(class_name="Doc", limit=K,
                                    near_vector=jpb.NearVectorParams(vector=q.tolist()))
            _same_reply(port_client_on_ref.search(req), ref_client.search(req))
        breq = jpb.BatchSearchRequest(requests=[
            jpb.SearchRequest(class_name="Doc", limit=K,
                              near_vector=jpb.NearVectorParams(vector=q.tolist()))
            for q in queries[:32]])
        for a, b in zip(port_client_on_ref.batch_search(breq).replies,
                        ref_client.batch_search(breq).replies):
            _same_reply(a, b)
    finally:
        port_client_on_ref.close()


def test_raw_lane_equals_hydrated_lane_and_the_reference(tmp_path):
    """The raw lane declines while objects sit in memtables (exactness),
    engages once they are flushed, and replies as the hydrated lane did —
    in the port and against the reference's raw lane."""
    data = np.load(FIXTURE)
    vecs, queries = data["vectors"][:3000].astype(np.float32), data["queries"].astype(np.float32)
    replies = {}
    for name, app_cls, sv_cls, kw in (("jax", JaxApp, JaxSearchServicer, {}),
                                      ("torch", App, SearchServicer, {"device": "cpu"})):
        app = app_cls(data_path=str(tmp_path / name), **kw)
        _fill(app, vecs)
        shard = app.db.get_index("Doc").single_local_shard()
        sv = sv_cls(app)
        breq = _batch(queries[:64])
        assert sv._raw_batch_lane(breq, 0.0) is None
        hydrated = _parse_batch(sv.BatchSearch(breq, _Ctx()))
        for b in (shard.objects, shard.docid_lookup):
            b.flush_memtable()
        raw_bytes = sv._raw_batch_lane(breq, 0.0)
        assert raw_bytes is not None, "raw lane did not engage on flushed segments"
        raw = pb.BatchSearchReply.FromString(raw_bytes)
        assert len(raw.replies) == 64
        for a, b in zip(raw.replies, hydrated.replies):
            _same_reply(a, b, one_app=True)
        # ineligible slots (a property selection) decline the raw lane
        assert sv._raw_batch_lane(_batch(queries[:2], properties=["rank"]), 0.0) is None
        replies[name] = raw
        app.shutdown()
    for a, b in zip(replies["torch"].replies, replies["jax"].replies):
        _same_reply(a, b)


def test_servicer_counts_the_batches_the_raw_lane_answers(tmp_path):
    """raw_lane_batches counts the BatchSearch requests the raw lane
    answered: none while objects sit in memtables or a slot is
    ineligible, one per request once the segments serve."""
    data = np.load(FIXTURE)
    vecs, queries = data["vectors"][:2000].astype(np.float32), data["queries"].astype(np.float32)
    app = App(data_path=str(tmp_path), device="cpu")
    try:
        _fill(app, vecs)
        sv = SearchServicer(app)
        breq = _batch(queries[:16])
        sv.BatchSearch(breq, _Ctx())
        assert sv.raw_lane_batches == 0
        shard = app.db.get_index("Doc").single_local_shard()
        for b in (shard.objects, shard.docid_lookup):
            b.flush_memtable()
        sv.BatchSearch(breq, _Ctx())
        sv.BatchSearch(_batch(queries[:2], properties=["rank"]), _Ctx())
        sv.BatchSearch(breq, _Ctx())
        assert sv.raw_lane_batches == 2
    finally:
        app.shutdown()


def test_message_limit_admits_a_request_past_grpcs_default(setup):
    """The port's server and client take messages up to MAX_MESSAGE_BYTES:
    a 4.8 MB BatchSearch, which grpc's 4 MiB default refuses (as the
    reference's server does), reaches the servicer and gets its slot's
    error back."""
    import grpc

    from weaviate_tpu_torch.server.grpc_server import MAX_MESSAGE_BYTES

    servers, _, _, _ = setup
    breq = _batch([np.zeros(1_200_000, dtype=np.float32)])
    assert 4 << 20 < breq.ByteSize() < MAX_MESSAGE_BYTES
    got = servers["torch"][2].batch_search(breq)
    assert len(got.replies) == 1 and got.replies[0].error_message
    with pytest.raises(grpc.RpcError) as e:
        servers["jax"][2].batch_search(breq)
    assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED


def test_native_reply_bytes_equal_the_upb_path(setup):
    from weaviate_tpu_torch.db.shard import SearchResult
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.server import reply_native

    assert reply_native.available(), "native reply marshaller must build"
    cases = [{"tag": "héllo wörld é中文", "rank": 1, "tags": ["a", "b"]}, {},
             {"nested": {"x": [1.5, None, True], "y": "z"}}]
    results = []
    for i, props in enumerate(cases):
        raw = StorObj(class_name="Doc", uuid=str(uuidlib.UUID(int=900 + i)), properties=props,
                      vector=np.arange(4, dtype=np.float32), doc_id=900 + i).to_binary()
        results.append(SearchResult(obj=StorObj.from_binary(raw, include_vector=False),
                                    distance=0.25 * i if i != 1 else None, shard="s"))
    req = pb.SearchRequest(class_name="Doc", limit=3)
    fast = fast_reply_bytes(results, req, took=0.125)
    assert fast is not None
    want = pb.SearchReply(took_seconds=0.125)
    want.results.extend(result_to_proto(r, req) for r in results)
    assert fast == want.SerializeToString()
    assert pb.SearchReply.FromString(fast) == want
    raws = [r.obj.raw_if_pristine() for r in results]
    batch = reply_native.build_batch_reply(raws, [r.distance for r in results], [None] * 3,
                                           [2, 1], 0.125)
    want_b = pb.BatchSearchReply()
    for rows in (results[:2], results[2:]):
        one = pb.SearchReply(took_seconds=0.125)
        one.results.extend(result_to_proto(r, req) for r in rows)
        want_b.replies.append(one)
    assert batch == want_b.SerializeToString()


def test_native_library_builds_into_the_checkouts_build_dir():
    from weaviate_tpu_torch.server import reply_native
    from weaviate_tpu_torch.storage import lsm_native

    assert reply_native.available()
    so = lsm_native.so_path(reply_native._SRC_PATH, "reply")
    assert os.path.exists(so)
    assert os.path.dirname(so).endswith(os.path.join("build", "native"))
