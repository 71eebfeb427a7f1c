"""The port's App with modules against the JAX package's App, each behind its
own REST server in one process, both with ENABLE_MODULES=text2vec-local,
ref2vec-centroid,backup-filesystem, fed the same schema and objects: 400
documents of seeded text vectorized at import. The reference App runs on
JAX's CPU backend, the port's on device="cpu".

Checked: nearText with moveTo/moveAwayFrom (the same ids, distances rtol
1e-5), vectors at import bit-equal, Aggregate with nearText, the
explanation props through GraphQL (nearestNeighbors, semanticPath and
interpretation equal; featureProjection at 20 iterations within 1e-4 x
spread), PATCH re-vectorizing, ref2vec-centroid vectors (rtol 1e-6), the
contextual classification journey (the same references), and a backup
written by either App and restored by the other (the restored class
answers nearText as the writer's does).
"""

import json
import signal
import time
import urllib.error
import urllib.request
import uuid as uuidlib

import numpy as np
import pytest

from weaviate_tpu.config import load_config as jax_load_config
from weaviate_tpu.server import App as JaxApp
from weaviate_tpu.server import RestServer as JaxRestServer
from weaviate_tpu_torch.config import load_config
from weaviate_tpu_torch.server import App, RestServer

N_DOCS = 400
WORDS = ["quantum", "qubits", "physics", "bread", "flour", "yeast", "oven", "running",
         "marathon", "shoes", "error", "correction", "hardware", "science", "football",
         "match", "goal", "stadium", "research", "experiment"] + [f"w{i}" for i in range(180)]


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


def _both(ports, method, path, body=None):
    out = [_req(p, method, path, body) for p in ports]
    for st, payload in out:
        assert st == 200, payload
    return [payload for _, payload in out]


def _gql(ports, query):
    out = _both(ports, "POST", "/v1/graphql", {"query": query})
    for res in out:
        assert not res.get("errors"), res
    return [res["data"] for res in out]


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(4, 13)))) for _ in range(n)]


def _doc_class(name):
    return {"class": name, "vectorizer": "text2vec-local",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "title", "dataType": ["text"]},
                           {"name": "body", "dataType": ["text"]},
                           {"name": "n", "dataType": ["int"]}]}


def _import_docs(ports, cls, n, seed, base=0):
    titles, bodies = _texts(n, seed), _texts(n, seed + 1)
    objs = [{"class": cls, "id": str(uuidlib.UUID(int=base + i + 1)),
             "properties": {"title": titles[i], "body": bodies[i], "n": i}} for i in range(n)]
    for out in _both(ports, "POST", "/v1/batch/objects", {"objects": objs}):
        assert all(o["result"]["status"] == "SUCCESS" for o in out)
    return objs


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    root = tmp_path_factory.mktemp("appmods")
    env = {"ENABLE_MODULES": "text2vec-local,ref2vec-centroid,backup-filesystem",
           "BACKUP_FILESYSTEM_PATH": str(root / "backups")}
    port_app = App(config=load_config(env), data_path=str(root / "port"), device="cpu")
    jax_app = JaxApp(config=jax_load_config(env), data_path=str(root / "jax"))
    servers = [RestServer(port_app, port=0), JaxRestServer(jax_app, port=0)]
    for s in servers:
        s.start()
    ports = [s.port for s in servers]
    try:
        _both(ports, "POST", "/v1/schema", _doc_class("Doc"))
        _import_docs(ports, "Doc", N_DOCS, 21)
        yield (port_app, jax_app), ports
    finally:
        for s in servers:
            s.stop()
        port_app.shutdown()
        jax_app.shutdown()


def _hits(data, cls="Doc"):
    rows = data["Get"][cls]
    return [r["_additional"]["id"] for r in rows], [r["_additional"]["distance"] for r in rows]


def _same_answers(datas, cls="Doc"):
    (ids, d), (ref_ids, ref_d) = _hits(datas[0], cls), _hits(datas[1], cls)
    assert ids == ref_ids
    np.testing.assert_allclose(d, ref_d, rtol=1e-5, atol=1e-6)


NEAR_TEXT = {
    "plain": '{concepts: ["quantum physics"]}',
    "moveTo": '{concepts: ["bread oven"], moveTo: {concepts: ["marathon"], force: 0.6}}',
    "moveAwayFrom": '{concepts: ["football goal"], '
                    'moveAwayFrom: {concepts: ["stadium"], force: 0.4}}',
    "both": '{concepts: ["science research"], moveTo: {concepts: ["hardware"], force: 0.3}, '
            'moveAwayFrom: {concepts: ["experiment"], force: 0.5}}',
}


@pytest.mark.parametrize("kind", sorted(NEAR_TEXT))
def test_neartext_answers_equal(apps, kind):
    _, ports = apps
    datas = _gql(ports, '{ Get { Doc(nearText: %s, limit: 10) '
                        '{ _additional { id distance } } } }' % NEAR_TEXT[kind])
    assert len(datas[0]["Get"]["Doc"]) == 10
    _same_answers(datas)


def test_vectors_at_import_bit_equal(apps):
    _, ports = apps
    for i in (0, 17, N_DOCS - 1):
        uid = str(uuidlib.UUID(int=i + 1))
        got = _both(ports, "GET", f"/v1/objects/Doc/{uid}?include=vector")
        assert len(got[0]["vector"]) == 256
        np.testing.assert_array_equal(np.asarray(got[0]["vector"], np.float32),
                                      np.asarray(got[1]["vector"], np.float32))


def test_neartext_aggregate_equal(apps):
    _, ports = apps
    datas = _gql(ports, '{ Aggregate { Doc(nearText: {concepts: ["bread flour"]}, '
                        'objectLimit: 7) { meta { count } n { sum minimum maximum } } } }')
    assert datas[0] == datas[1]
    assert datas[0]["Aggregate"]["Doc"][0]["meta"]["count"] == 7


def test_explain_props_graphql_equal(apps):
    _, ports = apps
    datas = _gql(ports, '{ Get { Doc(nearText: {concepts: ["quantum qubits"]}, limit: 10) '
                        '{ _additional { id '
                        'nearestNeighbors { neighbors { concept distance } } '
                        'semanticPath { path { concept distanceToQuery distanceToResult } } '
                        'interpretation { source { concept weight occurrence } } '
                        'featureProjection(dimensions: 2, iterations: 20) { vector } } } } }')
    rows, ref_rows = datas[0]["Get"]["Doc"], datas[1]["Get"]["Doc"]
    proj = np.array([r["_additional"].pop("featureProjection")["vector"] for r in rows])
    ref_proj = np.array([r["_additional"].pop("featureProjection")["vector"] for r in ref_rows])
    assert rows == ref_rows
    assert proj.shape == (10, 2)
    assert float(np.abs(proj - ref_proj).max()) <= 1e-4 * float(np.abs(ref_proj).max())


def test_patch_revectorizes_equal(apps):
    _, ports = apps
    uid = str(uuidlib.UUID(int=5000))
    _both(ports, "POST", "/v1/objects", {"class": "Doc", "id": uid, "properties": {
        "title": "quantum lecture", "body": "entanglement", "n": -1}})
    before = _both(ports, "GET", f"/v1/objects/Doc/{uid}?include=vector")
    for port in ports:
        st, _ = _req(port, "PATCH", f"/v1/objects/Doc/{uid}", {
            "class": "Doc", "properties": {"title": "chocolate cake", "body": "sugar cocoa"}})
        assert st in (200, 204)
    after = _both(ports, "GET", f"/v1/objects/Doc/{uid}?include=vector")
    assert not np.allclose(before[0]["vector"], after[0]["vector"])
    np.testing.assert_array_equal(np.asarray(after[0]["vector"], np.float32),
                                  np.asarray(after[1]["vector"], np.float32))
    datas = _gql(ports, '{ Get { Doc(nearText: {concepts: ["chocolate cocoa"]}, limit: 3) '
                        '{ _additional { id distance } } } }')
    _same_answers(datas)
    assert datas[0]["Get"]["Doc"][0]["_additional"]["id"] == uid
    for port in ports:
        assert _req(port, "DELETE", f"/v1/objects/Doc/{uid}")[0] in (200, 204)


def test_ref2vec_centroid_vectors_equal(apps):
    _, ports = apps
    _both(ports, "POST", "/v1/schema", {
        "class": "Owner", "vectorizer": "ref2vec-centroid",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "items", "dataType": ["Doc"]}]})
    uid = str(uuidlib.UUID(int=6000))
    beacons = [{"beacon": f"weaviate://localhost/Doc/{uuidlib.UUID(int=i + 1)}"}
               for i in (3, 9, 27, 81)]
    _both(ports, "POST", "/v1/objects", {"class": "Owner", "id": uid,
                                         "properties": {"items": beacons}})
    got = _both(ports, "GET", f"/v1/objects/Owner/{uid}?include=vector")
    docs = [_both(ports, "GET", f"/v1/objects/Doc/{uuidlib.UUID(int=i + 1)}?include=vector")[0]
            for i in (3, 9, 27, 81)]
    np.testing.assert_allclose(got[0]["vector"], got[1]["vector"], rtol=1e-6)
    np.testing.assert_allclose(got[0]["vector"], np.mean([d["vector"] for d in docs], axis=0),
                               rtol=1e-6, atol=1e-7)


def _wait_job(port, job_id, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        st, job = _req(port, "GET", f"/v1/classifications/{job_id}")
        assert st == 200
        if job["status"] in ("completed", "failed"):
            return job
        time.sleep(0.05)
    raise TimeoutError("classification job still running")


def test_contextual_classification_equal(apps):
    """tests/test_classification.py's contextual journey on both Apps: the
    sources gain the same references."""
    _, ports = apps
    _both(ports, "POST", "/v1/schema", {
        "class": "Topic", "vectorizer": "text2vec-local",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "name", "dataType": ["text"]}]})
    topics = {"science": "science physics research experiment",
              "sports": "sports football match goal stadium"}
    topic_ids = {}
    for i, (label, words) in enumerate(sorted(topics.items())):
        topic_ids[label] = str(uuidlib.UUID(int=7000 + i))
        _both(ports, "POST", "/v1/objects", {"class": "Topic", "id": topic_ids[label],
                                             "properties": {"name": words}})
    _both(ports, "POST", "/v1/schema", {
        "class": "Post", "vectorizer": "none",
        "vectorIndexConfig": {"distance": "cosine"},
        "properties": [{"name": "body", "dataType": ["text"]},
                       {"name": "ofTopic", "dataType": ["Topic"]}]})
    bodies = {"science": "the physics experiment confirmed the research result",
              "sports": "the football match ended with a late goal at the stadium"}
    posts = []
    for label, body in sorted(bodies.items()):
        for i in range(3):
            uid = str(uuidlib.UUID(int=7100 + len(posts)))
            posts.append((uid, label))
            _both(ports, "POST", "/v1/objects", {"class": "Post", "id": uid,
                                                 "properties": {"body": f"{body} number {i}"},
                                                 "vector": [0.0] * 256})
    jobs = []
    for port in ports:
        st, job = _req(port, "POST", "/v1/classifications", {
            "class": "Post", "classifyProperties": ["ofTopic"],
            "basedOnProperties": ["body"], "type": "text2vec-contextionary-contextual"})
        assert st == 201, job
        jobs.append(_wait_job(port, job["id"]))
    for job in jobs:
        assert job["status"] == "completed" and job["meta"]["countSucceeded"] == 6, job
    assert jobs[0]["settings"] == jobs[1]["settings"]
    for uid, label in posts:
        got = _both(ports, "GET", f"/v1/objects/Post/{uid}")
        beacons = [g["properties"]["ofTopic"][0]["beacon"] for g in got]
        assert beacons[0] == beacons[1] and beacons[0].endswith(topic_ids[label])


@pytest.mark.parametrize("writer", [0, 1], ids=["port_to_reference", "reference_to_port"])
def test_backup_restores_across_packages(apps, writer):
    (port_app, jax_app), ports = apps
    reader = 1 - writer
    cls = f"Bk{writer}"
    bid = f"cross-{writer}"
    w_port, r_port = ports[writer], ports[reader]
    st, _ = _req(w_port, "POST", "/v1/schema", _doc_class(cls))
    assert st == 200
    titles, bodies = _texts(64, 40 + writer), _texts(64, 50 + writer)
    objs = [{"class": cls, "id": str(uuidlib.UUID(int=8000 + i)),
             "properties": {"title": titles[i], "body": bodies[i], "n": i}} for i in range(64)]
    st, out = _req(w_port, "POST", "/v1/batch/objects", {"objects": objs})
    assert st == 200 and all(o["result"]["status"] == "SUCCESS" for o in out)
    query = ('{ Get { %s(nearText: {concepts: ["quantum bread"], moveTo: {concepts: '
             '["marathon"], force: 0.2}}, limit: 10) { n _additional { id distance } } } }' % cls)
    st, want = _req(w_port, "POST", "/v1/graphql", {"query": query})
    assert st == 200 and not want.get("errors"), want

    st, out = _req(w_port, "POST", "/v1/backups/filesystem", {"id": bid, "include": [cls]})
    assert st == 200, out
    w_app, r_app = (port_app, jax_app)[writer], (port_app, jax_app)[reader]
    assert w_app.backup_scheduler.wait(bid)["status"] == "SUCCESS"
    st, out = _req(r_port, "POST", f"/v1/backups/filesystem/{bid}/restore", {})
    assert st == 200, out
    final = r_app.backup_scheduler.wait(bid, restore=True)
    assert final["status"] == "SUCCESS", final

    st, got = _req(r_port, "POST", "/v1/graphql", {"query": query})
    assert st == 200 and not got.get("errors"), got
    _same_answers([got["data"], want["data"]], cls)
    uid = objs[9]["id"]
    vecs = [_req(p, "GET", f"/v1/objects/{cls}/{uid}?include=vector")[1] for p in ports]
    assert vecs[reader]["properties"]["n"] == 9
    np.testing.assert_array_equal(vecs[0]["vector"], vecs[1]["vector"])
