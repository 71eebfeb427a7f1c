"""The port's Python client (weaviate_tpu_torch/client.py) driven against
the port's RestServer on the CPU: the tests of tests/test_client.py
restated, then the port's client against a JAX-package App. Values that
cross the wire compare exactly.
"""

import time
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu_torch.client import Client, ClientError
from weaviate_tpu_torch.config import Config
from weaviate_tpu_torch.server import App, RestServer

UUID1 = str(uuidlib.UUID(int=1))


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """Each package's App chains its device-trace teardown onto SIGTERM.
    Put the handler and both packages' teardown state back after this
    module, so later tests in the same process find them as they were."""
    import signal

    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    mods, keys = (jax_profiling, torch_profiling), ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    states = [{k: m._teardown_state[k] for k in keys} for m in mods]
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, st in zip(mods, states):
        m._teardown_state.update(st)


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    c = Config()
    c.enable_modules = ["text2vec-local", "backup-filesystem"]
    c.backup_filesystem_path = str(tmp_path_factory.mktemp("bk"))
    app = App(config=c, data_path=str(tmp_path_factory.mktemp("data")),
              device="cpu")
    srv = RestServer(app, port=0)
    srv.start()
    cl = Client(f"http://127.0.0.1:{srv.port}")
    yield cl
    srv.stop()
    app.shutdown()


def test_liveness_meta(client):
    assert client.is_ready() and client.is_live()
    assert "version" in client.get_meta()


def test_schema_and_crud(client):
    client.schema.create_class({
        "class": "Book",
        "vectorIndexType": "hnsw_tpu",
        "vectorIndexConfig": {"distance": "l2-squared"},
        "properties": [{"name": "title", "dataType": ["text"]},
                       {"name": "pages", "dataType": ["int"]}],
    })
    assert any(c["class"] == "Book" for c in client.schema.get()["classes"])
    client.schema.add_property("Book", {"name": "isbn", "dataType": ["text"]})

    uid = client.data_object.create(
        {"title": "Snow Crash", "pages": 440}, "Book", uuid=UUID1,
        vector=np.arange(4, dtype=float).tolist())
    assert uid == UUID1
    got = client.data_object.get_by_id(UUID1, "Book", with_vector=True)
    assert got["properties"]["title"] == "Snow Crash"
    assert len(got["vector"]) == 4
    assert client.data_object.exists(UUID1, "Book")

    client.data_object.update({"pages": 441}, "Book", UUID1)
    assert client.data_object.get_by_id(UUID1, "Book")["properties"]["pages"] == 441
    client.data_object.replace({"title": "Snow Crash 2", "pages": 500}, "Book",
                               UUID1, vector=[1.0, 2.0, 3.0, 4.0])
    got = client.data_object.get_by_id(UUID1, "Book")
    assert got["properties"]["title"] == "Snow Crash 2"

    shards = client.schema.get_class_shards("Book")
    assert shards and shards[0]["status"] == "READY"

    client.data_object.delete(UUID1, "Book")
    assert client.data_object.get_by_id(UUID1, "Book") is None


def test_batch_and_query_builder(client):
    client.schema.create_class({
        "class": "Film",
        "vectorIndexType": "hnsw_tpu",
        "vectorIndexConfig": {"distance": "l2-squared"},
        "properties": [{"name": "title", "dataType": ["text"]},
                       {"name": "year", "dataType": ["int"]}],
    })
    rng = np.random.default_rng(5)
    objs = [{"class": "Film", "id": str(uuidlib.UUID(int=100 + i)),
             "properties": {"title": f"film about topic {i}", "year": 1990 + i},
             "vector": rng.standard_normal(8).tolist()} for i in range(20)]
    out = client.batch.create_objects(objs)
    assert all(o["result"]["status"] == "SUCCESS" for o in out)

    res = (client.query.get("Film", ["title", "year"])
           .with_near_vector({"vector": objs[7]["vector"]})
           .with_limit(3)
           .with_additional(["id", "distance"])
           .do())
    assert res[0]["_additional"]["id"] == objs[7]["id"]
    assert res[0]["_additional"]["distance"] < 1e-5

    res = (client.query.get("Film", ["title", "year"])
           .with_where({"operator": "LessThan", "path": ["year"], "valueInt": 1995})
           .with_sort({"path": ["year"], "order": "desc"})
           .with_limit(10)
           .do())
    years = [r["year"] for r in res]
    assert years == sorted(years, reverse=True) and max(years) < 1995

    res = (client.query.get("Film", ["title"])
           .with_bm25("topic 7", properties=["title"]).with_limit(3).do())
    assert any("7" in r["title"] for r in res)

    agg = client.query.aggregate("Film", "meta { count }")
    assert agg[0]["meta"]["count"] == 20

    dry = client.batch.delete_objects(
        "Film", {"operator": "GreaterThan", "path": ["year"], "valueInt": 2005},
        dry_run=True)
    assert dry["results"]["matches"] == 4
    out = client.batch.delete_objects(
        "Film", {"operator": "GreaterThan", "path": ["year"], "valueInt": 2005})
    assert out["results"]["successful"] == 4


def test_neartext_and_refs(client):
    client.schema.create_class({
        "class": "Note", "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "text", "dataType": ["text"]}],
    })
    a = client.data_object.create({"text": "gradient descent optimizer"}, "Note")
    client.data_object.create({"text": "pizza dough hydration"}, "Note")
    res = (client.query.get("Note", ["text"])
           .with_near_text({"concepts": ["gradient descent"]})
           .with_limit(1).with_additional("id").do())
    assert res[0]["_additional"]["id"] == a

    client.schema.create_class({
        "class": "Author",
        "properties": [{"name": "name", "dataType": ["text"]},
                       {"name": "wrote", "dataType": ["Note"]}],
    })
    au = client.data_object.create({"name": "ada"}, "Author")
    client.data_object.reference_add("Author", au, "wrote", "Note", a)
    got = client.data_object.get_by_id(au, "Author")
    assert got["properties"]["wrote"][0]["beacon"].endswith(a)


def test_backup_via_client(client):
    client.backup.create("filesystem", "clibak", include=["Note"])
    deadline = time.time() + 30
    while time.time() < deadline:
        st = client.backup.status("filesystem", "clibak")
        if st["status"] in ("SUCCESS", "FAILED"):
            break
        time.sleep(0.05)
    assert st["status"] == "SUCCESS"


def test_nodes_and_errors(client):
    nodes = client.cluster.get_nodes_status()
    assert nodes and nodes[0]["status"] == "HEALTHY"
    with pytest.raises(ClientError) as ei:
        client.schema.create_class({"class": "Book"})  # duplicate
    assert ei.value.status == 422


def test_module_extensions_via_client(client):
    """client.modules: store a custom concept, list it, introspect it, and
    USE it through nearText — the full extensions journey client-side."""
    ext = client.modules.create_extension(
        "text2vec-local", "zanthor",
        "a mythical creature that reviews pull requests")
    assert ext["concept"] == "zanthor" and ext["weight"] == 1.0
    assert any(e["concept"] == "zanthor"
               for e in client.modules.get_extensions("text2vec-local"))
    info = client.modules.get_concept("text2vec-local", "zanthor")
    assert info["individualWords"][0]["info"]["custom"] is True

    client.schema.create_class({
        "class": "ExtClientDoc", "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "body", "dataType": ["text"]}]})
    client.batch.create_objects([
        {"class": "ExtClientDoc",
         "properties": {"body": "a mythical creature reviewing pull requests"}},
        {"class": "ExtClientDoc",
         "properties": {"body": "sourdough starter hydration schedule"}},
    ])
    hits = (client.query.get("ExtClientDoc", ["body"])
            .with_near_text({"concepts": ["zanthor"]}).with_limit(1).do())
    assert "mythical" in hits[0]["body"]

    # validation surfaces as ClientError
    with pytest.raises(ClientError):
        client.modules.create_extension("text2vec-local", "BadCase", "x")
    with pytest.raises(ClientError):
        client.modules.get_extensions("no-such-module")


def test_port_client_against_a_jax_app(tmp_path):
    """The port's client speaks only the public /v1 API, so it drives a JAX
    App as it drives the port's: the same calls to both Apps give the same
    answers, exactly, but for the search distances, which each package
    computes in its own order of summation (rtol 1e-5)."""
    from weaviate_tpu.server import App as JaxApp
    from weaviate_tpu.server import RestServer as JaxRestServer

    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((40, 8))
    apps = [JaxApp(data_path=str(tmp_path / "jax")),
            App(data_path=str(tmp_path / "port"), device="cpu")]
    servers = [JaxRestServer(apps[0], port=0), RestServer(apps[1], port=0)]
    answers = []
    try:
        for srv in servers:
            srv.start()
            cl = Client(f"http://127.0.0.1:{srv.port}")
            cl.schema.create_class({
                "class": "Mixed", "vectorIndexType": "hnsw_tpu",
                "vectorIndexConfig": {"distance": "l2-squared"},
                "properties": [{"name": "n", "dataType": ["int"]}]})
            out = cl.batch.create_objects([
                {"class": "Mixed", "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": {"n": i}, "vector": vecs[i].tolist()} for i in range(40)])
            assert all(o["result"]["status"] == "SUCCESS" for o in out)
            got = cl.data_object.get_by_id(str(uuidlib.UUID(int=5)), "Mixed",
                                           with_vector=True)
            hits = [(cl.query.get("Mixed", ["n"]).with_near_vector({"vector": q.tolist()})
                     .with_limit(5).with_additional(["id", "distance"]).do())
                    for q in vecs[:6]]
            agg = cl.query.aggregate("Mixed", "meta { count } n { sum }")
            answers.append((got["properties"], got["vector"], hits, agg))
        (jp, jv, jhits, jagg), (pp, pv, phits, pagg) = answers
        assert (jp, jv, jagg) == (pp, pv, pagg)
        for jrows, prows in zip(jhits, phits):
            assert [(r["n"], r["_additional"]["id"]) for r in jrows] == \
                [(r["n"], r["_additional"]["id"]) for r in prows]
            np.testing.assert_allclose([r["_additional"]["distance"] for r in prows],
                                       [r["_additional"]["distance"] for r in jrows],
                                       rtol=1e-5)
        assert jv == [float(np.float32(v)) for v in vecs[4]]
    finally:
        for srv in servers:
            srv.stop()
        for a in apps:
            a.shutdown()
