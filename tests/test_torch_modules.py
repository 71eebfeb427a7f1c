"""The port's module system (weaviate_tpu_torch.modules) against the JAX
package's: the tests of tests/test_modules.py restated against the port
(provider dispatch, the local vectorizer, nearText end to end over REST
and GraphQL, the gRPC sidecar client against a fake service, ref2vec-
centroid, the filesystem backup backend, the explanation props), every
port entry point on device="cpu"; then the two packages on the same
seeded inputs: text2vec-local vectors of 512 texts bit-equal, the
vectorizer corpus equal, the nearestNeighbors, interpretation and
semanticPath payloads equal, the ref2vec centroid at rtol 1e-6, and an
extensions file written by either package read by the other.
"""

import json
import signal
import uuid as uuidlib
from concurrent import futures

import numpy as np
import pytest

from weaviate_tpu_torch.config import Config
from weaviate_tpu_torch.entities.schema import ClassDef, Property
from weaviate_tpu_torch.modules import ModuleError, Provider, build_provider
from weaviate_tpu_torch.modules.text2vec_local import LocalTextVectorizer
from weaviate_tpu_torch.server import App, RestServer


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


def make_class(vectorizer="text2vec-local"):
    return ClassDef(
        name="Doc",
        properties=[
            Property(name="title", data_type=["text"]),
            Property(name="body", data_type=["text"]),
            Property(name="count", data_type=["int"]),
        ],
        vectorizer=vectorizer,
        vector_index_type="hnsw_tpu",
        vector_index_config={"distance": "cosine"},
    )


def test_local_vectorizer_semantics():
    v = LocalTextVectorizer()
    vecs = v.vectorize_text([
        "quantum computing hardware",
        "quantum computing research",
        "banana bread recipe",
    ])
    sim_close = float(vecs[0] @ vecs[1])
    sim_far = float(vecs[0] @ vecs[2])
    assert sim_close > sim_far + 0.2  # token overlap => closer
    # determinism across instances
    v2 = LocalTextVectorizer()
    np.testing.assert_allclose(v2.vectorize_text(["quantum computing hardware"])[0], vecs[0])


def test_provider_vectorize_object_and_query():
    p = Provider()
    p.register(LocalTextVectorizer())
    cd = make_class()
    from weaviate_tpu_torch.entities.storobj import StorObj

    obj = StorObj(class_name="Doc", uuid=str(uuidlib.uuid4()),
                  properties={"title": "quantum computing", "body": "qubits", "count": 3})
    vec = p.vectorize_object(cd, obj)
    assert vec is not None and vec.shape == (256,)

    qv = p.vectorize_query(cd, {"concepts": ["quantum computing qubits"]})
    assert float(qv @ vec) > 0.3  # query near the object it describes

    # moveTo pulls the query toward a concept
    base = p.vectorize_query(cd, {"concepts": ["quantum"]})
    moved = p.vectorize_query(cd, {"concepts": ["quantum"],
                                   "moveTo": {"concepts": ["banana"], "force": 0.8}})
    banana = p.vectorize_query(cd, {"concepts": ["banana"]})
    assert float(moved @ banana) > float(base @ banana)

    # moveAwayFrom pushes it away
    away = p.vectorize_query(cd, {"concepts": ["quantum"],
                                  "moveAwayFrom": {"concepts": ["banana"], "force": 0.8}})
    assert float(away @ banana) < float(base @ banana)


def test_provider_errors():
    p = Provider()
    cd = make_class(vectorizer="text2vec-local")
    with pytest.raises(ModuleError):
        p.vectorize_query(cd, {"concepts": ["x"]})  # module not enabled
    p.register(LocalTextVectorizer())
    with pytest.raises(ModuleError):
        p.vectorize_query(cd, {})  # no concepts


def test_build_provider_unknown_module():
    c = Config()
    c.enable_modules = ["no-such-module"]
    with pytest.raises(ModuleError):
        build_provider(c)


@pytest.fixture(scope="module")
def neartext_app(tmp_path_factory):
    c = Config()
    c.enable_modules = ["text2vec-local"]
    c.default_vectorizer_module = "text2vec-local"
    app = App(config=c, data_path=str(tmp_path_factory.mktemp("moddata")), device="cpu")
    srv = RestServer(app, port=0)
    srv.start()
    yield app, srv
    srv.stop()
    app.shutdown()


def _req(port, method, path, body=None):
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    r.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(r, timeout=30) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None


def test_neartext_end_to_end(neartext_app):
    """Import WITHOUT vectors (module vectorizes at import), then nearText
    retrieves by meaning — the full journey the reference runs against a
    contextionary container, with zero external services."""
    app, srv = neartext_app
    st, _ = _req(srv.port, "POST", "/v1/schema", {
        "class": "Doc",
        "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "title", "dataType": ["text"]},
                       {"name": "body", "dataType": ["text"]}],
    })
    assert st == 200
    docs = [
        ("quantum computing breakthrough", "qubits entanglement superposition"),
        ("quantum hardware scaling", "qubit error correction"),
        ("sourdough bread baking", "flour water salt yeast"),
        ("marathon training plan", "running endurance intervals"),
    ]
    payloads = [{"class": "Doc", "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": {"title": t, "body": b}} for i, (t, b) in enumerate(docs)]
    st, out = _req(srv.port, "POST", "/v1/batch/objects", {"objects": payloads})
    assert st == 200 and all(o["result"]["status"] == "SUCCESS" for o in out)

    # objects got vectors at import
    st, got = _req(srv.port, "GET", f"/v1/objects/Doc/{payloads[0]['id']}?include=vector")
    assert st == 200 and len(got["vector"]) == 256

    q = '{ Get { Doc(nearText: {concepts: ["quantum qubits"]}, limit: 2) { title _additional { distance } } } }'
    st, res = _req(srv.port, "POST", "/v1/graphql", {"query": q})
    assert st == 200, res
    hits = res["data"]["Get"]["Doc"]
    assert len(hits) == 2
    titles = {h["title"] for h in hits}
    assert titles == {"quantum computing breakthrough", "quantum hardware scaling"}

    # bread query finds bread
    q2 = '{ Get { Doc(nearText: {concepts: ["bread flour baking"]}, limit: 1) { title } } }'
    st, res2 = _req(srv.port, "POST", "/v1/graphql", {"query": q2})
    assert res2["data"]["Get"]["Doc"][0]["title"] == "sourdough bread baking"


def test_module_extension_endpoints(neartext_app):
    """/v1/modules/text2vec-local/* user-facing extensions (the reference's
    text2vec-contextionary extensions/rest_user_facing.go + concepts/rest.go
    surface): store a custom concept, then USE it — nearText with the new
    concept must retrieve by the concept's definition."""
    app, srv = neartext_app
    # the fixture's Doc class may already hold the bread/quantum docs from
    # the previous test — add one doc the custom concept should find
    _req(srv.port, "POST", "/v1/schema", {
        "class": "ExtDoc", "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "title", "dataType": ["text"]},
                       {"name": "body", "dataType": ["text"]}],
    })
    payloads = [
        {"class": "ExtDoc", "id": str(uuidlib.UUID(int=101)),
         "properties": {"title": "element post",
                        "body": "a naturally occurring element seen by programmers"}},
        {"class": "ExtDoc", "id": str(uuidlib.UUID(int=102)),
         "properties": {"title": "cooking post",
                        "body": "flour water salt yeast oven"}},
    ]
    st, out = _req(srv.port, "POST", "/v1/batch/objects", {"objects": payloads})
    assert st == 200 and all(o["result"]["status"] == "SUCCESS" for o in out)

    # validation first: bad concept casing / missing definition / bad weight
    st, _ = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions",
                 {"concept": "FooBarium", "definition": "x", "weight": 1})
    assert st == 422
    st, _ = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions",
                 {"concept": "foobarium", "weight": 1})
    assert st == 422
    st, _ = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions",
                 {"concept": "foobarium", "definition": "x", "weight": 2})
    assert st == 422
    # a brand-new concept must be defined at weight 1
    st, _ = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions",
                 {"concept": "zzzconcept", "definition": "x", "weight": 0.5})
    assert st == 400

    st, ext = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions", {
        "concept": "foobarium",
        "definition": "a naturally occurring element seen by programmers",
        "weight": 1,
    })
    assert st == 200 and ext["concept"] == "foobarium"
    st, all_ext = _req(srv.port, "GET", "/v1/modules/text2vec-local/extensions")
    assert st == 200 and any(
        e["concept"] == "foobarium" for e in all_ext["extensions"])

    # USE the concept: nearText ["foobarium"] ranks the definition-matching
    # doc first even though no document contains the word itself
    q = '{ Get { ExtDoc(nearText: {concepts: ["foobarium"]}, limit: 1) { title } } }'
    st, res = _req(srv.port, "POST", "/v1/graphql", {"query": q})
    assert st == 200, res
    assert res["data"]["Get"]["ExtDoc"][0]["title"] == "element post", res

    # concepts introspection, incl. a percent-encoded compound concept
    st, info = _req(srv.port, "GET", "/v1/modules/text2vec-local/concepts/foobarium")
    assert st == 200
    assert info["individualWords"][0]["word"] == "foobarium"
    assert info["individualWords"][0]["info"]["custom"] is True
    st, _ = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions", {
        "concept": "machine learning",
        "definition": "statistical models trained from data", "weight": 1})
    assert st == 200
    st, info = _req(srv.port, "GET",
                    "/v1/modules/text2vec-local/concepts/machine%20learning")
    assert st == 200 and info["custom"] is True
    assert [w["word"] for w in info["individualWords"]] == ["machine", "learning"]

    # unknown module / module without a REST surface
    st, _ = _req(srv.port, "GET", "/v1/modules/nope/extensions")
    assert st == 404
    st, _ = _req(srv.port, "GET", "/v1/modules/text2vec-local/unknown")
    assert st == 404

    # meta reports the module
    st, meta = _req(srv.port, "GET", "/v1/meta")
    assert "text2vec-local" in meta["modules"]


def test_module_extensions_survive_restart(tmp_path):
    """Extensions persist (the reference's extensions-storage role): a
    restarted node keeps embedding the custom concept the way the already-
    imported vectors saw it."""
    from weaviate_tpu_torch.config import Config

    c = Config()
    c.enable_modules = ["text2vec-local"]
    c.persistence.data_path = str(tmp_path / "data")
    app = App(config=c, data_path=str(tmp_path / "data"), device="cpu")
    srv = RestServer(app, port=0)
    srv.start()
    st, _ = _req(srv.port, "POST", "/v1/modules/text2vec-local/extensions", {
        "concept": "glorp", "definition": "distributed vector database",
        "weight": 1})
    assert st == 200
    vec_before = app.modules.get("text2vec-local").vectorize_text(["glorp"])[0]
    srv.stop()
    app.shutdown()

    c2 = Config()
    c2.enable_modules = ["text2vec-local"]
    c2.persistence.data_path = str(tmp_path / "data")
    app2 = App(config=c2, data_path=str(tmp_path / "data"), device="cpu")
    srv2 = RestServer(app2, port=0)
    srv2.start()
    try:
        st, all_ext = _req(srv2.port, "GET", "/v1/modules/text2vec-local/extensions")
        assert st == 200 and [e["concept"] for e in all_ext["extensions"]] == ["glorp"]
        vec_after = app2.modules.get("text2vec-local").vectorize_text(["glorp"])[0]
        np.testing.assert_array_equal(vec_before, vec_after)
    finally:
        srv2.stop()
        app2.shutdown()


def test_patch_revectorizes(neartext_app):
    """Regression: PATCHing text must recompute the module vector, or
    nearText keeps ranking the object by its pre-edit text."""
    app, srv = neartext_app
    uid = str(uuidlib.UUID(int=777))
    st, _ = _req(srv.port, "POST", "/v1/objects", {
        "class": "Doc", "id": uid,
        "properties": {"title": "quantum physics lecture", "body": "entanglement"},
    })
    assert st == 200
    st, before = _req(srv.port, "GET", f"/v1/objects/Doc/{uid}?include=vector")
    st, _ = _req(srv.port, "PATCH", f"/v1/objects/Doc/{uid}", {
        "class": "Doc", "properties": {"title": "chocolate cake dessert",
                                       "body": "sugar butter cocoa"}})
    st, after = _req(srv.port, "GET", f"/v1/objects/Doc/{uid}?include=vector")
    assert st == 200
    assert not np.allclose(before["vector"], after["vector"])
    # the edited object now answers dessert queries, not quantum ones
    q = '{ Get { Doc(nearText: {concepts: ["chocolate dessert"]}, limit: 1) { _additional { id } } } }'
    st, res = _req(srv.port, "POST", "/v1/graphql", {"query": q})
    assert res["data"]["Get"]["Doc"][0]["_additional"]["id"] == uid
    _req(srv.port, "DELETE", f"/v1/objects/Doc/{uid}")


def test_disabled_vectorizer_rejected_at_class_creation(neartext_app):
    app, srv = neartext_app
    st, body = _req(srv.port, "POST", "/v1/schema", {
        "class": "Bad", "vectorizer": "text2vec-typo",
        "properties": [{"name": "t", "dataType": ["text"]}],
    })
    assert st == 422
    assert "not an enabled module" in json.dumps(body)


def test_contextionary_grpc_client(tmp_path):
    """Drive the gRPC sidecar client against an in-process fake vectorizer
    service (the contextionary dial pattern, client/contextionary.go:41)."""
    import grpc

    from weaviate_tpu_torch.modules import contextionary_pb2 as pb
    from weaviate_tpu_torch.modules.text2vec_contextionary import (
        _SERVICE,
        ContextionaryVectorizer,
    )

    local = LocalTextVectorizer(dim=64)

    def vectorize(request, context):
        vecs = local.vectorize_text(list(request.texts))
        return pb.VectorizeReply(
            vectors=[pb.Vector(values=v.tolist()) for v in vecs]
        )

    def meta(request, context):
        return pb.MetaReply(version="fake-1.0", word_count=1000, dimensions=64)

    handlers = {
        "Vectorize": grpc.unary_unary_rpc_method_handler(
            vectorize,
            request_deserializer=pb.VectorizeRequest.FromString,
            response_serializer=pb.VectorizeReply.SerializeToString,
        ),
        "Meta": grpc.unary_unary_rpc_method_handler(
            meta,
            request_deserializer=pb.MetaRequest.FromString,
            response_serializer=pb.MetaReply.SerializeToString,
        ),
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_SERVICE.strip("/"), handlers),)
    )
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        mod = ContextionaryVectorizer(url=f"127.0.0.1:{port}")
        vecs = mod.vectorize_text(["quantum computing", "bread"])
        assert vecs.shape == (2, 64)
        want = local.vectorize_text(["quantum computing"])[0]
        np.testing.assert_allclose(vecs[0], want, rtol=1e-6)
        assert mod.meta()["version"] == "fake-1.0"
        cd = make_class(vectorizer="text2vec-contextionary")
        from weaviate_tpu_torch.entities.storobj import StorObj

        obj = StorObj(class_name="Doc", uuid=str(uuidlib.uuid4()),
                      properties={"title": "hello world"})
        assert mod.vectorize_object(cd, obj, {}).shape == (64,)
        mod.shutdown()
    finally:
        server.stop(0)


def test_ref2vec_centroid(tmp_path):
    from weaviate_tpu_torch.db import DB
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.modules.ref2vec_centroid import Ref2VecCentroid

    db = DB(str(tmp_path / "data"), device="cpu")
    target_cls = ClassDef(name="Item", properties=[Property(name="t", data_type=["text"])],
                          vector_index_type="hnsw_tpu")
    idx = db.add_class(target_cls, parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}))
    u1, u2 = str(uuidlib.UUID(int=1)), str(uuidlib.UUID(int=2))
    idx.put_object(StorObj(class_name="Item", uuid=u1, properties={"t": "a"},
                           vector=np.array([1, 0, 0, 0], np.float32)))
    idx.put_object(StorObj(class_name="Item", uuid=u2, properties={"t": "b"},
                           vector=np.array([0, 1, 0, 0], np.float32)))

    mod = Ref2VecCentroid()
    mod.set_db(db)
    owner_cls = ClassDef(
        name="Owner",
        properties=[Property(name="items", data_type=["Item"])],
        vectorizer="ref2vec-centroid",
    )
    owner = StorObj(class_name="Owner", uuid=str(uuidlib.uuid4()), properties={
        "items": [{"beacon": f"weaviate://localhost/Item/{u1}"},
                  {"beacon": f"weaviate://localhost/Item/{u2}"}],
    })
    vec = mod.vectorize_object(owner_cls, owner, {})
    np.testing.assert_allclose(vec, [0.5, 0.5, 0, 0])
    db.shutdown()


def test_backup_fs_backend(tmp_path):
    from weaviate_tpu_torch.modules.backup_fs import FilesystemBackupBackend

    be = FilesystemBackupBackend(str(tmp_path / "backups"))
    be.put_object("b1", "node-0/Doc/shard-0/vector.log", b"\x01\x02")
    assert be.get_object("b1", "node-0/Doc/shard-0/vector.log") == b"\x01\x02"
    be.write_meta("b1", {"status": "SUCCESS"})
    assert be.read_meta("b1")["status"] == "SUCCESS"
    assert be.read_meta("nope") is None
    with pytest.raises(ValueError):
        be.put_object("b1", "../escape", b"x")


# -- explanation additional props (explain.py) -------------------------------
# reference: modules/text2vec-contextionary/additional/{nearestneighbors,
# sempath, interpretation, projector}, payload shapes in additional/models


def _mk_results(vectorizer, texts):
    """SearchResult-shaped rows with module-vectorized objects."""
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.usecases.traverser import SearchResult

    rows = []
    for i, t in enumerate(texts):
        vec = vectorizer.vectorize_text([t])[0]
        obj = StorObj(class_name="Doc", uuid=str(uuidlib.UUID(int=i + 1)),
                      properties={"body": t}, vector=vec)
        rows.append(SearchResult(obj=obj, distance=0.1 * i))
    return rows


def test_explain_nearest_neighbors_and_interpretation():
    v = LocalTextVectorizer()
    results = _mk_results(v, [
        "quantum qubits entanglement physics",
        "bread flour yeast baking oven",
    ])
    nn = v.resolve_additional("nearestNeighbors", results, {"limit": 3})
    assert len(nn) == 2
    concepts0 = [x["concept"] for x in nn[0]["neighbors"]]
    assert len(concepts0) == 3
    # a quantum doc's nearest concepts come from its own wordlist, not bread's
    assert set(concepts0) <= {"quantum", "qubits", "entanglement", "physics"}
    assert nn[0]["neighbors"][0]["distance"] <= nn[0]["neighbors"][-1]["distance"]

    interp = v.resolve_additional("interpretation", results, {})
    src = interp[1]["source"]
    assert {s["concept"] for s in src} == {"bread", "flour", "yeast", "baking", "oven"}
    assert all(0.0 <= s["weight"] <= 1.0 and s["occurrence"] == 1 for s in src)


def test_explain_semantic_path_requires_neartext():
    from weaviate_tpu_torch.modules.provider import ModuleError

    v = LocalTextVectorizer()
    results = _mk_results(v, ["quantum qubits computing"])
    with pytest.raises(ModuleError):
        v.resolve_additional("semanticPath", results, {})

    out = v.resolve_additional(
        "semanticPath", results, {"near_text": {"concepts": ["quantum physics"]}})
    path = out[0]["path"]
    assert len(path) >= 1
    for el in path:
        assert "concept" in el and "distanceToQuery" in el and "distanceToResult" in el
    # the walk moves toward the result: last element is closest to it
    assert path[-1]["distanceToResult"] <= path[0]["distanceToResult"] + 1e-6
    # neighbors in the path link distances both ways
    if len(path) > 1:
        assert "distanceToNext" in path[0] and "distanceToPrevious" in path[-1]


def test_explain_feature_projection_tsne():
    v = LocalTextVectorizer(device="cpu")
    # two tight clusters of texts -> the 2-D projection must separate them
    results = _mk_results(v, [
        "quantum qubits entanglement", "quantum qubits physics",
        "bread flour yeast", "bread flour oven",
    ])
    fp = v.resolve_additional("featureProjection", results, {"dimensions": 2})
    pts = np.array([x["vector"] for x in fp])
    assert pts.shape == (4, 2)
    import itertools

    def d(i, j):
        return float(np.linalg.norm(pts[i] - pts[j]))

    intra = max(d(0, 1), d(2, 3))
    inter = min(d(i, j) for i, j in itertools.product((0, 1), (2, 3)))
    assert inter > intra, (pts, intra, inter)
    # deterministic: same inputs, same layout
    fp2 = v.resolve_additional("featureProjection", results, {"dimensions": 2})
    np.testing.assert_allclose(pts, np.array([x["vector"] for x in fp2]))


def test_explain_props_graphql_e2e(neartext_app):
    """featureProjection + nearestNeighbors + semanticPath through the full
    GraphQL stack (vector fetch is triggered by the selection alone)."""
    app, srv = neartext_app
    _req(srv.port, "POST", "/v1/schema", {
        "class": "XDoc",
        "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "body", "dataType": ["text"]}],
    })
    payloads = [{"class": "XDoc", "id": str(uuidlib.UUID(int=100 + i)),
                 "properties": {"body": b}}
                for i, b in enumerate([
                    "quantum qubits entanglement computing",
                    "quantum hardware error correction",
                    "sourdough bread flour yeast",
                ])]
    st, out = _req(srv.port, "POST", "/v1/batch/objects", {"objects": payloads})
    assert st == 200

    q = ('{ Get { XDoc(nearText: {concepts: ["quantum"]}, limit: 3) { body '
         '_additional { nearestNeighbors { neighbors { concept distance } } '
         'semanticPath { path { concept distanceToQuery distanceToResult } } '
         'featureProjection(dimensions: 2) { vector } } } } }')
    st, res = _req(srv.port, "POST", "/v1/graphql", {"query": q})
    assert st == 200 and not res.get("errors"), res
    hits = res["data"]["Get"]["XDoc"]
    assert len(hits) == 3
    for h in hits:
        add = h["_additional"]
        assert add["nearestNeighbors"]["neighbors"]
        assert add["semanticPath"]["path"]
        assert len(add["featureProjection"]["vector"]) == 2


def test_neartext_aggregate(neartext_app):
    """Aggregate with nearText restricts the doc set via the module
    vectorizer (objectLimit semantics) instead of silently counting all."""
    app, srv = neartext_app
    _req(srv.port, "POST", "/v1/schema", {
        "class": "AggT", "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "body", "dataType": ["text"]}]})
    payloads = [{"class": "AggT", "id": str(uuidlib.UUID(int=200 + i)),
                 "properties": {"body": b}} for i, b in enumerate(
        ["quantum qubits", "quantum errors", "bread flour", "bread yeast", "running shoes"])]
    st, _ = _req(srv.port, "POST", "/v1/batch/objects", {"objects": payloads})
    assert st == 200
    q = ('{ Aggregate { AggT(nearText: {concepts: ["quantum"]}, objectLimit: 2) '
         '{ meta { count } } } }')
    st, res = _req(srv.port, "POST", "/v1/graphql", {"query": q})
    assert st == 200 and not res.get("errors"), res
    assert res["data"]["Aggregate"]["AggT"][0]["meta"]["count"] == 2
    # objectLimit required with nearText
    q2 = '{ Aggregate { AggT(nearText: {concepts: ["quantum"]}) { meta { count } } } }'
    st, res2 = _req(srv.port, "POST", "/v1/graphql", {"query": q2})
    assert res2.get("errors") and "objectLimit" in res2["errors"][0]["message"]


# -- the two packages on the same inputs -------------------------------------

WORDS = [f"w{i}" for i in range(400)] + [
    "quantum", "qubits", "entanglement", "bread", "flour", "yeast", "oven",
    "physics", "marathon", "running", "error", "correction", "hardware"]


def seeded_texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 17))))
            for _ in range(n)]


def test_local_vectors_bit_equal_across_packages():
    from weaviate_tpu.modules.text2vec_local import LocalTextVectorizer as RefLocal

    texts = seeded_texts(512, 11)
    texts[:4] = ["", "UPPER lower 123", "a a a a b", "punctuation, only!?"]
    np.testing.assert_array_equal(LocalTextVectorizer().vectorize_text(texts),
                                  RefLocal().vectorize_text(texts))
    np.testing.assert_array_equal(LocalTextVectorizer(dim=64).vectorize_text(texts[:32]),
                                  RefLocal(dim=64).vectorize_text(texts[:32]))


CORPUS_CASES = [
    ({}, {}, ""),
    ({"vectorizeClassName": False}, {}, ""),
    ({}, {"text2vec-local": {"skip": True}}, ""),
    ({}, {"skip": True}, ""),
    ({}, {"other-module": {"skip": True}}, ""),
    ({}, {}, "text2vec-local"),
    ({}, {"text2vec-local": {"skip": True}}, "text2vec-local"),
]


@pytest.mark.parametrize("class_cfg, body_cfg, module_name", CORPUS_CASES)
def test_corpus_from_object_equal_across_packages(class_cfg, body_cfg, module_name):
    from weaviate_tpu.entities.schema import ClassDef as RefClassDef
    from weaviate_tpu.entities.schema import Property as RefProperty
    from weaviate_tpu.entities.storobj import StorObj as RefStorObj
    from weaviate_tpu.modules.provider import corpus_from_object as ref_corpus
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.modules.provider import corpus_from_object

    props = [("title", ["text"], {}), ("body", ["text"], body_cfg),
             ("tags", ["text[]"], {}), ("count", ["int"], {}), ("code", ["string"], {})]
    values = {"title": "Quantum Computing", "body": "Qubits AND Gates",
              "tags": ["Alpha", "beta"], "count": 3, "code": "X-1"}
    out = []
    for cls, prop, obj, fn in ((ClassDef, Property, StorObj, corpus_from_object),
                               (RefClassDef, RefProperty, RefStorObj, ref_corpus)):
        cd = cls(name="Doc", vectorizer="text2vec-local",
                 properties=[prop(name=n, data_type=dt, module_config=mc)
                             for n, dt, mc in props])
        o = obj(class_name="Doc", uuid=str(uuidlib.UUID(int=1)), properties=dict(values))
        out.append(fn(cd, o, class_cfg, module_name))
    assert out[0] == out[1]


def _results_both(texts):
    from weaviate_tpu.db.shard import SearchResult as RefResult
    from weaviate_tpu.entities.storobj import StorObj as RefStorObj
    from weaviate_tpu.modules.text2vec_local import LocalTextVectorizer as RefLocal
    from weaviate_tpu_torch.db.shard import SearchResult
    from weaviate_tpu_torch.entities.storobj import StorObj

    sides = []
    for vec_cls, obj_cls, res_cls in ((LocalTextVectorizer, StorObj, SearchResult),
                                      (RefLocal, RefStorObj, RefResult)):
        v = vec_cls(device="cpu") if vec_cls is LocalTextVectorizer else vec_cls()
        rows = [res_cls(obj=obj_cls(class_name="Doc", uuid=str(uuidlib.UUID(int=i + 1)),
                                    properties={"body": t},
                                    vector=v.vectorize_text([t])[0]),
                        distance=0.1 * i)
                for i, t in enumerate(texts)]
        sides.append((v, rows))
    return sides


@pytest.mark.parametrize("prop, params", [
    ("nearestNeighbors", {"limit": 5}),
    ("interpretation", {}),
    ("semanticPath", {"near_text": {"concepts": ["quantum physics"]}}),
])
def test_explain_payloads_equal_across_packages(prop, params):
    texts = seeded_texts(24, 5) + ["quantum qubits entanglement physics",
                                   "bread flour yeast baking oven"]
    (port, rows), (ref, ref_rows) = _results_both(texts)
    assert port.resolve_additional(prop, rows, params) == \
        ref.resolve_additional(prop, ref_rows, params)


def test_ref2vec_centroid_matches_across_packages(tmp_path):
    from weaviate_tpu.db import DB as RefDB
    from weaviate_tpu.entities.schema import ClassDef as RefClassDef
    from weaviate_tpu.entities.schema import Property as RefProperty
    from weaviate_tpu.entities.storobj import StorObj as RefStorObj
    from weaviate_tpu.entities.vectorindex import parse_and_validate_config as ref_parse
    from weaviate_tpu.modules.ref2vec_centroid import Ref2VecCentroid as RefCentroid
    from weaviate_tpu_torch.db import DB
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.modules.ref2vec_centroid import Ref2VecCentroid

    vecs = np.random.default_rng(3).standard_normal((7, 32)).astype(np.float32)
    uuids = [str(uuidlib.UUID(int=i + 1)) for i in range(7)]
    refs = {"items": [{"beacon": f"weaviate://localhost/Item/{u}"} for u in uuids[1:6]]}
    got = []
    for db, cls, prop, obj, parse, mod in (
            (DB(str(tmp_path / "port"), device="cpu"), ClassDef, Property, StorObj,
             parse_and_validate_config, Ref2VecCentroid()),
            (RefDB(str(tmp_path / "ref")), RefClassDef, RefProperty, RefStorObj,
             ref_parse, RefCentroid())):
        try:
            idx = db.add_class(cls(name="Item", vector_index_type="hnsw_tpu",
                                   properties=[prop(name="t", data_type=["text"])]),
                               parse("hnsw_tpu", {"distance": "l2-squared"}))
            for u, v in zip(uuids, vecs):
                idx.put_object(obj(class_name="Item", uuid=u, properties={"t": "x"}, vector=v))
            mod.set_db(db)
            owner = cls(name="Owner", vectorizer="ref2vec-centroid",
                        properties=[prop(name="items", data_type=["Item"])])
            got.append(mod.vectorize_object(
                owner, obj(class_name="Owner", uuid=str(uuidlib.uuid4()), properties=refs), {}))
        finally:
            db.shutdown()
    np.testing.assert_allclose(got[0], got[1], rtol=1e-6)
    np.testing.assert_allclose(got[0], vecs[1:6].mean(axis=0), rtol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_extensions_file_read_across_packages(tmp_path, writer):
    from weaviate_tpu.modules.text2vec_local import LocalTextVectorizer as RefLocal

    path = str(tmp_path / "modules" / "text2vec-local" / "extensions.json")
    make = {"port": LocalTextVectorizer, "reference": RefLocal}
    w = make[writer](persist_path=path)
    for concept, definition, weight in (("glorp", "distributed vector database", 1.0),
                                        ("glorp", "a quantum computer", 0.3),
                                        ("machine learning", "statistical models", 1.0)):
        st, _ = w.handle_rest("POST", "/extensions", {
            "concept": concept, "definition": definition, "weight": weight})
        assert st == 200
    other = make["reference" if writer == "port" else "port"](persist_path=path)
    texts = ["glorp", "machine learning", "glorp and machine learning", "plain words"]
    np.testing.assert_array_equal(other.vectorize_text(texts), w.vectorize_text(texts))
    assert other.handle_rest("GET", "/extensions", None) == w.handle_rest("GET", "/extensions", None)
