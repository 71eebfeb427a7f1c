"""The port's App (weaviate_tpu_torch.server) against the JAX package's App,
each behind its own REST server in one process, fed the same requests: the
schema, `/v1/batch/objects` with the committed recall fixture (8192 x 32,
200 queries), object CRUD, GraphQL `Get` nearVector k=10 on all 200
queries (unfiltered, through the gather tier and through the masked scan),
`Aggregate`, and `/v1/meta`. The reference App runs on JAX's CPU backend,
the port's on device="cpu".

Tolerances: uuids equal (tie-free fixture data); distances rtol 1e-5, atol
1e-5; recall@10 against the fixture's exact ground truth >= 0.99, the bar of
tests/test_recall_fixture.py, filtered too (ground truth within the
allowed set, numpy brute force).
"""

import json
import signal
import os
import urllib.error
import urllib.request
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.server import App as JaxApp
from weaviate_tpu.server import RestServer as JaxRestServer
from weaviate_tpu_torch.server import App, RestServer

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "recall_fixture.npz")
K = 10
CUTOFF = 1000  # flatSearchCutoff: tag's 256 rows gather, bucket < 500 scans masked
TAG = {"operator": "Equal", "path": ["tag"], "valueText": "t3"}
RANGE = {"operator": "LessThan", "path": ["bucket"], "valueInt": 500}


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


def _req(port, method, path, body=None, timeout=60):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            payload = resp.read()
            return resp.status, json.loads(payload) if payload else None
    except urllib.error.HTTPError as e:
        payload = e.read()
        return e.code, json.loads(payload) if payload else None


def _props(i):
    return {"tag": f"t{i % 32}", "bucket": (i * 7919) % 1000}


CLASS = {
    "class": "Doc",
    "properties": [{"name": "tag", "dataType": ["text"]},
                   {"name": "bucket", "dataType": ["int"]}],
    "vectorIndexType": "hnsw_tpu",
    "vectorIndexConfig": {"distance": "l2-squared", "flatSearchCutoff": CUTOFF},
}


@pytest.fixture(scope="module")
def fixture():
    data = np.load(FIXTURE)
    return data["vectors"].astype(np.float32), data["queries"].astype(np.float32), data["gt"]


@pytest.fixture(scope="module")
def servers(tmp_path_factory, fixture):
    vecs = fixture[0]
    out = {}
    for name, app_cls, srv_cls, kw in (("jax", JaxApp, JaxRestServer, {}),
                                       ("torch", App, RestServer, {"device": "cpu"})):
        app = app_cls(data_path=str(tmp_path_factory.mktemp(name)), **kw)
        srv = srv_cls(app, port=0)
        srv.start()
        st, _ = _req(srv.port, "POST", "/v1/schema", CLASS)
        assert st == 200
        for s in range(0, len(vecs), 2048):
            st, res = _req(srv.port, "POST", "/v1/batch/objects", {"objects": [
                {"class": "Doc", "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": _props(i), "vector": vecs[i].tolist()}
                for i in range(s, min(s + 2048, len(vecs)))]})
            assert st == 200 and all("errors" not in r["result"] for r in res)
        out[name] = (app, srv.port)
    yield out
    for app, _ in out.values():
        app.shutdown()


def _near(port, q, where=None):
    w = ""
    if where is not None:
        w = ", where: " + _gql_where(where)
    query = ("{ Get { Doc(nearVector: {vector: %s}, limit: %d%s) "
             "{ tag bucket _additional { id distance } } } }" % (json.dumps(q.tolist()), K, w))
    st, res = _req(port, "POST", "/v1/graphql", {"query": query})
    assert st == 200 and "errors" not in res, res
    rows = res["data"]["Get"]["Doc"]
    return ([r["_additional"]["id"] for r in rows],
            np.array([r["_additional"]["distance"] for r in rows], np.float64), rows)


def _gql_where(w):
    key = [k for k in w if k.startswith("value")][0]
    val = json.dumps(w[key])
    return '{operator: %s, path: ["%s"], %s: %s}' % (w["operator"], w["path"][0], key, val)


def _allowed(n, where):
    ids = np.arange(n)
    if where is TAG:
        return ids[ids % 32 == 3]
    return ids[(ids * 7919) % 1000 < 500]


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def _uuid_ids(ids):
    return [uuidlib.UUID(u).int - 1 for u in ids]


def test_get_near_vector_matches_reference_on_all_fixture_queries(servers, fixture):
    vecs, queries, gt = fixture
    got_ids = []
    for q in queries:
        ids_j, d_j, rows_j = _near(servers["jax"][1], q)
        ids_t, d_t, rows_t = _near(servers["torch"][1], q)
        assert ids_t == ids_j
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
        assert [(r["tag"], r["bucket"]) for r in rows_t] == [(r["tag"], r["bucket"]) for r in rows_j]
        got_ids.append(_uuid_ids(ids_t))
    assert _recall(got_ids, gt[:, :K]) >= 0.99


@pytest.mark.parametrize("where", [TAG, RANGE], ids=["gather", "masked"])
def test_filtered_get_matches_reference_and_exact(servers, fixture, where):
    vecs, queries, _ = fixture
    allowed = _allowed(len(vecs), where)
    assert (len(allowed) < CUTOFF) == (where is TAG)
    got, want = [], []
    for q in queries[:50]:
        ids_j, d_j, _ = _near(servers["jax"][1], q, where)
        ids_t, d_t, _ = _near(servers["torch"][1], q, where)
        assert ids_t == ids_j
        np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
        dist = ((vecs[allowed] - q) ** 2).sum(1)
        want.append(allowed[np.argsort(dist)[:K]].tolist())
        got.append(_uuid_ids(ids_t))
        assert set(got[-1]) <= set(allowed.tolist())
    assert _recall(got, want) >= 0.99


def test_graphql_batch_matches_single_requests(servers, fixture):
    _, queries, _ = fixture
    body = [{"query": "{ Get { Doc(nearVector: {vector: %s}, limit: %d) "
                      "{ _additional { id distance } } } }" % (json.dumps(q.tolist()), K)}
            for q in queries[:16]]
    replies = {}
    for name, (_, port) in servers.items():
        st, res = _req(port, "POST", "/v1/graphql/batch", body)
        assert st == 200 and len(res) == 16
        replies[name] = [[r["_additional"]["id"] for r in one["data"]["Get"]["Doc"]] for one in res]
    assert replies["torch"] == replies["jax"]
    assert replies["torch"][0] == _near(servers["torch"][1], queries[0])[0]


@pytest.mark.parametrize("query", [
    "{ Aggregate { Doc { meta { count } } } }",
    "{ Aggregate { Doc { bucket { count minimum maximum sum } } } }",
    '{ Aggregate { Doc(where: {operator: Equal, path: ["tag"], valueText: "t3"}) '
    "{ meta { count } bucket { mean } } } }",
], ids=["count", "int-column", "filtered"])
def test_aggregate_matches_reference(servers, query):
    res = {name: _req(port, "POST", "/v1/graphql", {"query": query})
           for name, (_, port) in servers.items()}
    assert res["torch"][0] == 200 and res["torch"] == res["jax"]


def test_meta_and_schema_match_reference(servers):
    for path in ("/v1/meta", "/v1/schema", "/v1/schema/Doc", "/v1/.well-known/ready"):
        got = {name: _req(port, "GET", path) for name, (_, port) in servers.items()}
        assert got["torch"] == got["jax"], path


def _strip(obj):
    return {k: v for k, v in obj.items() if k not in ("creationTimeUnix", "lastUpdateTimeUnix")}


def test_object_crud_matches_reference(servers):
    uid = str(uuidlib.UUID(int=10**6))
    vec = np.linspace(-1, 1, 32).astype(np.float32).tolist()
    seq = [
        ("POST", "/v1/objects", {"class": "Doc", "id": uid,
                                 "properties": {"tag": "new", "bucket": 1}, "vector": vec}),
        ("GET", f"/v1/objects/Doc/{uid}", None),
        ("PATCH", f"/v1/objects/Doc/{uid}", {"class": "Doc", "properties": {"bucket": 2}}),
        ("GET", f"/v1/objects/Doc/{uid}?include=vector", None),
        ("PUT", f"/v1/objects/Doc/{uid}", {"class": "Doc", "id": uid,
                                           "properties": {"tag": "put", "bucket": 3},
                                           "vector": vec}),
        ("GET", f"/v1/objects/Doc/{uid}", None),
        ("HEAD", f"/v1/objects/Doc/{uid}", None),
        ("DELETE", f"/v1/objects/Doc/{uid}", None),
        ("GET", f"/v1/objects/Doc/{uid}", None),
    ]
    for method, path, body in seq:
        got = {}
        for name, (_, port) in servers.items():
            st, res = _req(port, method, path, body)
            got[name] = (st, _strip(res) if isinstance(res, dict) else res)
        assert got["torch"] == got["jax"], (method, path, got)
    assert got["torch"][0] == 404


def test_many_clients_connecting_at_once_are_served(servers):
    """The port's listener keeps the system's backlog (Go's net/http
    does), so a burst of 64 clients connecting at once is served, not
    reset."""
    import threading

    from weaviate_tpu_torch.server import rest

    assert rest._Server.request_queue_size >= 64
    port = servers["torch"][1]
    barrier = threading.Barrier(64)
    codes = []

    def hit():
        barrier.wait()
        codes.append(_req(port, "GET", "/v1/.well-known/ready")[0])

    threads = [threading.Thread(target=hit) for _ in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert codes == [200] * 64


def _raw(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _shape(v):
    """A JSON value's key structure (dict keys, list lengths of dicts),
    without the values that differ between two processes' clocks."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items() if k not in _VOLATILE}
    if isinstance(v, list):
        return [_shape(x) for x in v] if v and isinstance(v[0], dict) else "list"
    return type(v).__name__ if not isinstance(v, (int, float)) else "number"


# keys whose presence follows the process, not the server: per-device and
# per-host names, the packages' own version strings
_VOLATILE = {"devices", "device", "backend", "platform", "host", "hostname", "peaks",
             "jax", "torch", "kind"}


@pytest.mark.parametrize("path", [
    "/v1/objects?class=Doc&limit=3", "/v1/schema/Doc/shards", "/v1/nodes",
    "/debug/", "/debug/traces", "/debug/perf", "/debug/quality", "/debug/slo",
    "/debug/controllers", "/debug/incidents", "/debug/pprof/", "/debug/pprof/cmdline",
    "/debug/index",
])
def test_read_endpoints_answer_like_the_reference(servers, path):
    got = {name: _raw(port, path) for name, (_, port) in servers.items()}
    (st_t, ct_t, body_t), (st_j, ct_j, body_j) = got["torch"], got["jax"]
    assert st_t == st_j and ct_t == ct_j, (path, st_t, st_j)
    if ct_t.startswith("application/json"):
        assert _shape(json.loads(body_t)) == _shape(json.loads(body_j)), path
    else:
        assert bool(body_t) == bool(body_j)
