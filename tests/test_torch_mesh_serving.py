"""The port's mesh index above the index seam, against the JAX package's
on the same inputs, on the CPU: a class of vectorIndexType hnsw_tpu_mesh
through the DB, its ClassIndex and Shard (search, filters, deletes, a
restart through the DB: tests/test_mesh_index.py:305 and :330), and
through the App over REST and gRPC BatchSearch with a restart onto a
smaller mesh (tests/test_mesh_serving.py:65).

Tolerances: uuids equal (tie-free gaussian vectors); distances rtol 1e-5,
atol 1e-5.
"""

import json
import signal
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.db import DB as JaxDB
from weaviate_tpu.entities import filters as jfilters
from weaviate_tpu.entities import schema as jschema
from weaviate_tpu.entities import storobj as jstorobj
from weaviate_tpu.entities import vectorindex as jvi
from weaviate_tpu.grpcapi import weaviate_pb2 as jpb
from weaviate_tpu.server import App as JaxApp
from weaviate_tpu.server import RestServer as JaxRestServer
from weaviate_tpu.server.grpc_server import GrpcServer as JaxGrpcServer
from weaviate_tpu.server.grpc_server import SearchClient as JaxSearchClient
from weaviate_tpu_torch.db import DB
from weaviate_tpu_torch.entities import filters, schema, storobj
from weaviate_tpu_torch.entities import vectorindex as tvi
from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
from weaviate_tpu_torch.index.mesh import MeshVectorIndex
from weaviate_tpu_torch.server import App, RestServer
from weaviate_tpu_torch.server.grpc_server import GrpcServer, SearchClient

PORT = (DB, schema, storobj, filters, tvi)
JAX = (JaxDB, jschema, jstorobj, jfilters, jvi)


@pytest.fixture(scope="module", autouse=True)
def _sigterm_state_restored():
    """Each package's App chains its device-trace teardown onto SIGTERM:
    put the handler and both packages' teardown state back afterwards."""
    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    mods, keys = (jax_profiling, torch_profiling), ("signal_installed", "prev_sigterm")
    handler = signal.getsignal(signal.SIGTERM)
    states = [{k: m._teardown_state[k] for k in keys} for m in mods]
    yield
    signal.signal(signal.SIGTERM, handler)
    for m, st in zip(mods, states):
        m._teardown_state.update(st)


def _class(pkg, name="MeshArticle"):
    sch = pkg[1]
    return sch.ClassDef(name=name, properties=[
        sch.Property(name="title", data_type=["text"]),
        sch.Property(name="wordCount", data_type=["int"]),
        sch.Property(name="published", data_type=["boolean"])],
        vector_index_type="hnsw_tpu_mesh")


def _obj(pkg, i, dim=8, cls="MeshArticle"):
    vec = np.random.default_rng(i).standard_normal(dim).astype(np.float32)
    return pkg[2].StorObj(class_name=cls, uuid=str(uuidlib.UUID(int=i + 1)),
                          properties={"title": f"hello {i}", "wordCount": i,
                                      "published": i % 2 == 0}, vector=vec)


def _open_db(pkg, path):
    db_cls, _, _, _, v = pkg
    db = db_cls(str(path), **({"device": "cpu"} if pkg is PORT else {}))
    cfg = v.parse_and_validate_config("hnsw_tpu_mesh", {"distance": "l2-squared"})
    return db, db.add_class(_class(pkg), cfg)


def _hits(res):
    return [[(r.obj.uuid, float(r.distance)) for r in row] for row in res]


def _same_hits(a, b):
    assert [[u for u, _ in row] for row in a] == [[u for u, _ in row] for row in b]
    np.testing.assert_allclose([[d for _, d in row] for row in a],
                               [[d for _, d in row] for row in b], rtol=1e-5, atol=1e-5)


def test_mesh_through_shard_and_db_restart(tmp_path):
    """Search, a boolean filter (the masked scan), a delete and a restart
    through the DB answer alike in both packages."""
    answers = {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        db, idx = _open_db(pkg, tmp_path / name)
        shard = next(iter(idx.shards.values()))
        if pkg is PORT:
            assert isinstance(shard.vector_index, MeshVectorIndex)
            assert shard.vector_index.n_dev == 8
        objs = [_obj(pkg, i) for i in range(60)]
        idx.put_batch(objs)
        q = np.stack([objs[17].vector, objs[4].vector])
        out = [_hits(idx.object_vector_search(q, k=5))]
        flt = pkg[3].LocalFilter.from_dict(
            {"operator": "Equal", "path": ["published"], "valueBoolean": True})
        res = idx.object_vector_search(q, k=10, flt=flt)
        assert all(r.obj.properties["published"] is True for row in res for r in row)
        out.append(_hits(res))
        idx.delete_object(objs[17].uuid)
        res = idx.object_vector_search(q, k=5)
        assert all(r.obj.uuid != objs[17].uuid for r in res[0])
        out.append(_hits(res))
        db.flush()
        db.shutdown()
        db2, idx2 = _open_db(pkg, tmp_path / name)
        assert idx2.object_count() == 59
        out.append(_hits(idx2.object_vector_search(q, k=5)))
        db2.shutdown()
        answers[name] = out
    assert answers["torch"][0][0][0][0] == str(uuidlib.UUID(int=18))
    for a, b in zip(answers["torch"], answers["jax"]):
        _same_hits(a, b)


def _req(port, method, path, body=None):
    import urllib.request

    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=30) as resp:
        raw = resp.read()
        return resp.status, json.loads(raw) if raw else None


def _mk_app(path, port_pkg):
    if port_pkg:
        app = App(data_path=str(path), device="cpu")
        srv, gsrv = RestServer(app, port=0), GrpcServer(app, port=0)
    else:
        app = JaxApp(data_path=str(path))
        srv, gsrv = JaxRestServer(app, port=0), JaxGrpcServer(app, port=0)
    srv.start()
    gsrv.start()
    return app, srv, gsrv


def _batch_search(gport, vecs, port_pkg, k=3):
    client = (SearchClient if port_pkg else JaxSearchClient)(f"127.0.0.1:{gport}")
    m = pb if port_pkg else jpb
    try:
        return client.batch_search(m.BatchSearchRequest(requests=[
            m.SearchRequest(class_name="MeshDoc", limit=k,
                            near_vector=m.NearVectorParams(vector=v.tolist())) for v in vecs]))
    finally:
        client.close()


def _reply_rows(reply):
    return [[(r.id, json.loads(r.properties_json)["rank"], r.distance) for r in one.results]
            for one in reply.replies]


def test_mesh_app_grpc_batch_search_and_mesh_size_change(tmp_path):
    """REST schema and batch import, gRPC BatchSearch, a delete, then the
    whole App restarted onto a smaller mesh (meshDevices 8 -> 4 in the
    persisted schema): the port's App answers as the JAX App does at each
    step."""
    n, dim = 300, 16
    data = np.random.default_rng(21).standard_normal((n, dim)).astype(np.float32)
    rows = {}
    for port_pkg in (True, False):
        path = tmp_path / ("torch" if port_pkg else "jax") / "data"
        app, srv, gsrv = _mk_app(path, port_pkg)
        st, _ = _req(srv.port, "POST", "/v1/schema", {
            "class": "MeshDoc", "vectorIndexType": "hnsw_tpu_mesh",
            "vectorIndexConfig": {"distance": "l2-squared", "meshDevices": 8},
            "properties": [{"name": "rank", "dataType": ["int"]}]})
        assert st == 200
        objs = [{"class": "MeshDoc", "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": {"rank": i}, "vector": data[i].tolist()} for i in range(n)]
        st, res = _req(srv.port, "POST", "/v1/batch/objects", {"objects": objs})
        assert st == 200 and all(o["result"]["status"] == "SUCCESS" for o in res)
        if port_pkg:
            shard = next(iter(app.db.get_index("MeshDoc").shards.values()))
            assert isinstance(shard.vector_index, MeshVectorIndex)
            assert shard.vector_index.n_dev == 8
        first = _reply_rows(_batch_search(gsrv.port, data[:8], port_pkg))
        assert [r[0][0] for r in first] == [str(uuidlib.UUID(int=i + 1)) for i in range(8)]
        st, _ = _req(srv.port, "DELETE", f"/v1/objects/MeshDoc/{uuidlib.UUID(int=3)}")
        assert st == 204
        srv.stop()
        gsrv.stop()
        app.shutdown()
        schema_path = path / "schema.json"
        raw = json.loads(schema_path.read_text())
        for cd in raw["classes"]:
            if cd["class"] == "MeshDoc":
                cd["vectorIndexConfig"]["meshDevices"] = 4
        schema_path.write_text(json.dumps(raw))
        app2, srv2, gsrv2 = _mk_app(path, port_pkg)
        try:
            vidx = next(iter(app2.db.get_index("MeshDoc").shards.values())).vector_index
            assert vidx.n_dev == 4 and vidx.live == n - 1
            after = _reply_rows(_batch_search(gsrv2.port, data[:8], port_pkg))
        finally:
            srv2.stop()
            gsrv2.stop()
            app2.shutdown()
        assert after[2][0][0] != str(uuidlib.UUID(int=3))
        rows[port_pkg] = (first, after)
    for got, want in zip(rows[True], rows[False]):
        assert [[(u, r) for u, r, _ in row] for row in got] == \
            [[(u, r) for u, r, _ in row] for row in want]
        np.testing.assert_allclose([[d for _, _, d in row] for row in got],
                                   [[d for _, _, d in row] for row in want],
                                   rtol=1e-5, atol=1e-5)
