"""`python -m weaviate_tpu_torch`: the port's process entry point serves
REST and gRPC on the CPU when asked with `--device cpu`, answers
readiness, and stops cleanly on SIGTERM; without a card and without
`--device cpu` it exits non-zero with the device's message; and importing
the port's serving chain (App, REST, gRPC, the entry point) loads neither
jax nor anything of weaviate_tpu."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.update(extra)
    return env


def _wait_ready(proc, port, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/v1/.well-known/ready", timeout=2) as r:
                return r.status == 200
        except OSError:
            if proc.poll() is not None:
                raise AssertionError(f"server exited early:\n{proc.stdout.read()}")
            time.sleep(0.2)
    return False


def test_main_on_cpu_serves_and_stops_on_sigterm(tmp_path):
    port, gport = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "weaviate_tpu_torch", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), "--grpc-port", str(gport),
         "--data-path", str(tmp_path / "data")],
        env=_env(), cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert _wait_ready(proc, port), "server never became ready"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/meta", timeout=5) as r:
            assert "version" in json.loads(r.read())
        socket.create_connection(("127.0.0.1", gport), timeout=5).close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        out = proc.stdout.read()
        assert "serving on cpu" in out and "shutdown complete" in out
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]], ids=["default", "cuda"])
def test_main_without_a_card_exits_nonzero(tmp_path, argv):
    out = subprocess.run(
        [sys.executable, "-m", "weaviate_tpu_torch", "--port", str(_free_port()),
         "--grpc-port", str(_free_port()), "--data-path", str(tmp_path / "data"), *argv],
        env=_env(CUDA_VISIBLE_DEVICES=""), cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr and "device='cpu'" in out.stderr
    assert not (tmp_path / "data").exists()


def test_serving_chain_imports_no_jax_or_reference_module():
    code = ("import sys\n"
            "before = set(sys.modules)\n"
            "import weaviate_tpu_torch.server, weaviate_tpu_torch.server.app, "
            "weaviate_tpu_torch.server.rest, weaviate_tpu_torch.server.grpc_server, "
            "weaviate_tpu_torch.server.reply_native, weaviate_tpu_torch.__main__, "
            "weaviate_tpu_torch.serving.coalescer, weaviate_tpu_torch.serving.controller, "
            "weaviate_tpu_torch.monitoring.profiling, weaviate_tpu_torch.graphql, "
            "weaviate_tpu_torch.usecases.backup, weaviate_tpu_torch.usecases.classification, "
            "weaviate_tpu_torch.auth.oidc, weaviate_tpu_torch.modules, "
            "weaviate_tpu_torch.modules.backup_cloud, weaviate_tpu_torch.modules.backup_fs, "
            "weaviate_tpu_torch.modules.explain, weaviate_tpu_torch.modules.interface, "
            "weaviate_tpu_torch.modules.media, weaviate_tpu_torch.modules.provider, "
            "weaviate_tpu_torch.modules.readers, weaviate_tpu_torch.modules.ref2vec_centroid, "
            "weaviate_tpu_torch.modules.sidecar, "
            "weaviate_tpu_torch.modules.text2vec_contextionary, "
            "weaviate_tpu_torch.modules.contextionary_pb2, "
            "weaviate_tpu_torch.modules.text2vec_http, "
            "weaviate_tpu_torch.modules.text2vec_local, weaviate_tpu_torch.ops.tsne, "
            "weaviate_tpu_torch.client, weaviate_tpu_torch.cluster, "
            "weaviate_tpu_torch.cluster.httputil, weaviate_tpu_torch.cluster.payloads, "
            "weaviate_tpu_torch.cluster.membership, weaviate_tpu_torch.cluster.gossip, "
            "weaviate_tpu_torch.cluster.tx, weaviate_tpu_torch.cluster.remote_client, "
            "weaviate_tpu_torch.cluster.clusterapi, weaviate_tpu_torch.cluster.node, "
            "weaviate_tpu_torch.usecases.replica, weaviate_tpu_torch.usecases.scaler, "
            "weaviate_tpu_torch.index.hnsw\n"
            "bad = sorted(m for m in set(sys.modules) - before if m.startswith('jax') "
            "or m.split('.')[0] == 'weaviate_tpu')\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_app_serves_a_cluster(tmp_path):
    """CLUSTER_HOSTNAME / CLUSTER_JOIN build the port's ClusterNode on the
    App's device: two App nodes over REST (as tests/test_cluster.py's
    full-App test does) share the schema, spread a class's shards over
    both, and a nearVector through either node finds objects on both."""
    import uuid as uuidlib

    import numpy as np

    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.server import App, RestServer

    pa, pb = _free_port(), _free_port()
    envs = [{"CLUSTER_HOSTNAME": "node-a", "CLUSTER_DATA_BIND_PORT": str(pa),
             "CLUSTER_JOIN": f"node-b@127.0.0.1:{pb}"},
            {"CLUSTER_HOSTNAME": "node-b", "CLUSTER_DATA_BIND_PORT": str(pb),
             "CLUSTER_JOIN": f"node-a@127.0.0.1:{pa}"}]
    apps, servers = [], []
    try:
        for i, env in enumerate(envs):
            app = App(config=load_config(env), data_path=str(tmp_path / f"n{i}"),
                      device="cpu")
            assert app.cluster_node is not None
            assert app.cluster_node.device.type == "cpu"
            srv = RestServer(app, port=0)
            srv.start()
            apps.append(app)
            servers.append(srv)

        def req(port, method, path, body=None):
            data = json.dumps(body).encode() if body is not None else None
            r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                       method=method)
            r.add_header("Content-Type", "application/json")
            with urllib.request.urlopen(r, timeout=30) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else None

        st, _ = req(servers[0].port, "POST", "/v1/schema", {
            "class": "Two", "properties": [{"name": "n", "dataType": ["int"]}],
            "vectorIndexType": "hnsw_tpu",
            "vectorIndexConfig": {"distance": "l2-squared"},
            "shardingConfig": {"desiredCount": 2}})
        assert st == 200
        st, sch = req(servers[1].port, "GET", "/v1/schema")
        assert [c["class"] for c in sch["classes"]] == ["Two"]
        vecs = np.random.default_rng(3).standard_normal((24, 4)).astype(np.float32)
        objs = [{"class": "Two", "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": {"n": i}, "vector": vecs[i].tolist()} for i in range(24)]
        st, out = req(servers[0].port, "POST", "/v1/batch/objects", {"objects": objs})
        assert st == 200 and all(o["result"]["status"] == "SUCCESS" for o in out)
        local = [sum(s.object_count() for s in a.db.get_index("Two").shards.values())
                 for a in apps]
        assert sum(local) == 24 and all(c > 0 for c in local)
        for srv in servers:
            for i in (2, 19):
                q = {"query": "{ Get { Two(nearVector: {vector: %s}, limit: 1) "
                              "{ n } } }" % json.dumps(vecs[i].tolist())}
                st, res = req(srv.port, "POST", "/v1/graphql", q)
                assert st == 200 and res["data"]["Get"]["Two"][0]["n"] == i
        st, nodes = req(servers[1].port, "GET", "/v1/nodes")
        assert {n["name"] for n in nodes["nodes"]} == {"node-a", "node-b"}
    finally:
        for s in servers:
            s.stop()
        for a in apps:
            a.shutdown()


def test_app_serves_enable_modules(tmp_path):
    """ENABLE_MODULES builds the port's provider on the App's device:
    /v1/meta lists the module, and a class may name it as its
    vectorizer."""
    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.server import App, RestServer

    app = App(config=load_config({"ENABLE_MODULES": "text2vec-local"}),
              data_path=str(tmp_path), device="cpu")
    srv = RestServer(app, port=0)
    srv.start()
    try:
        assert app.modules.device.type == "cpu"
        assert app.modules.get("text2vec-local").device.type == "cpu"
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/meta", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta["modules"]["text2vec-local"]["dimensions"] == 256
        app.schema.add_class({"class": "Doc", "vectorizer": "text2vec-local",
                              "properties": [{"name": "body", "dataType": ["text"]}]})
        with pytest.raises(ValueError, match="not an enabled module"):
            app.schema.add_class({"class": "Bad", "vectorizer": "text2vec-typo",
                                  "properties": [{"name": "t", "dataType": ["text"]}]})
    finally:
        srv.stop()
        app.shutdown()


def test_app_accepts_mesh_shards_and_serves_a_mesh_class(tmp_path):
    """TPU_DEVICE_MESH_SHARDS is accepted and reported in the config
    digest, as the JAX App does (it drives nothing there either); a class
    of vectorIndexType hnsw_tpu_mesh is served through the App, its
    meshDevices slabs on the CPU, and answers nearVector as the JAX App
    does."""
    import uuid as uuidlib

    import numpy as np

    from weaviate_tpu.config import load_config as jax_load_config
    from weaviate_tpu.entities.storobj import StorObj as JaxStorObj
    from weaviate_tpu.server import App as JaxApp
    from weaviate_tpu.usecases.traverser import GetParams as JaxGetParams
    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.index.mesh import MeshVectorIndex
    from weaviate_tpu_torch.server import App
    from weaviate_tpu_torch.usecases.traverser import GetParams

    env = {"TPU_DEVICE_MESH_SHARDS": "2"}
    cls = {"class": "Mv", "vectorIndexType": "hnsw_tpu_mesh",
           "vectorIndexConfig": {"distance": "l2-squared", "meshDevices": 4},
           "properties": [{"name": "tag", "dataType": ["text"]}]}
    vecs = np.random.default_rng(3).standard_normal((300, 8)).astype(np.float32)
    answers = []
    for app_cls, cfg, obj_cls, params in (
            (App, load_config(env), StorObj, GetParams),
            (JaxApp, jax_load_config(env), JaxStorObj, JaxGetParams)):
        kw = {"device": "cpu"} if app_cls is App else {}
        app = app_cls(config=cfg, data_path=str(tmp_path / app_cls.__module__), **kw)
        try:
            knobs = app._config_fingerprint()["knobs"]
            assert knobs["device_mesh_shards"] == 2
            app.schema.add_class(dict(cls))
            idx = app.db.get_index("Mv")
            idx.put_batch([obj_cls(class_name="Mv", uuid=str(uuidlib.UUID(int=i + 1)),
                                   properties={"tag": "t"}, vector=vecs[i])
                           for i in range(300)])
            vidx = next(iter(idx.shards.values())).vector_index
            if app_cls is App:
                assert isinstance(vidx, MeshVectorIndex) and vidx.n_dev == 4
            res = app.traverser.get_class(params(
                class_name="Mv", near_vector={"vector": vecs[7].tolist()}, limit=5))
            answers.append([(r.obj.uuid, round(float(r.distance), 4)) for r in res])
        finally:
            app.shutdown()
    assert answers[0][0][0] == str(uuidlib.UUID(int=8))
    assert answers[0] == answers[1]


def test_app_with_ivf_enabled_serves_probed_answers(tmp_path):
    """IVF_ENABLED is served: the App installs its IVF settings, the class's
    index trains a layout at import and nearVector answers through the
    probe; shutdown reverts the setting."""
    import uuid as uuidlib

    import numpy as np

    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.index import gpu
    from weaviate_tpu_torch.server import App
    from weaviate_tpu_torch.usecases.traverser import GetParams

    env = {"IVF_ENABLED": "true", "IVF_MIN_N": "256", "IVF_NLIST": "8", "IVF_TOP_P": "8"}
    app = App(config=load_config(env), data_path=str(tmp_path), device="cpu")
    try:
        assert gpu.ivf_settings().nlist == 8
        app.schema.add_class({"class": "Iv", "vectorIndexType": "hnsw_tpu",
                              "vectorIndexConfig": {"distance": "l2-squared"},
                              "properties": [{"name": "tag", "dataType": ["text"]}]})
        vecs = np.random.default_rng(2).standard_normal((600, 8)).astype(np.float32)
        idx = app.db.get_index("Iv")
        idx.put_batch([StorObj(class_name="Iv", uuid=str(uuidlib.UUID(int=i + 1)),
                               properties={"tag": "t"}, vector=vecs[i]) for i in range(600)])
        shard = next(iter(idx.shards.values()))
        res = app.traverser.get_class(GetParams(
            class_name="Iv", near_vector={"vector": vecs[5].tolist()}, limit=3))
        assert res[0].obj.uuid == str(uuidlib.UUID(int=6)) and len(res) == 3
        assert shard.vector_index.ivf_stats()["dispatches"] >= 1
        assert shard.vector_index.health()["ivf"]["trained"]
    finally:
        app.shutdown()
    assert gpu._ivf_override is None


def test_app_needs_a_card_or_an_explicit_cpu(tmp_path, monkeypatch):
    import torch

    from weaviate_tpu_torch.config import Config
    from weaviate_tpu_torch.server import App

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        App(config=Config(), data_path=str(tmp_path / "a"))
    app = App(config=Config(), data_path=str(tmp_path / "b"), device="cpu")
    try:
        assert app.device.type == "cpu" and app.db.device.type == "cpu"
    finally:
        app.shutdown()


@pytest.mark.parametrize("order", ["jax_first", "torch_first"])
def test_both_packages_sigterm_teardowns_chain_in_either_order(monkeypatch, order):
    """Two Apps of the two packages in one process each install their
    trace teardown on SIGTERM; whichever comes second chains the first,
    so one SIGTERM runs both teardowns and then the process's own
    handler."""
    from weaviate_tpu.monitoring import profiling as jax_profiling
    from weaviate_tpu_torch.monitoring import profiling as torch_profiling

    ran = []
    mods = [jax_profiling, torch_profiling]
    if order == "torch_first":
        mods.reverse()
    for m in mods:
        monkeypatch.setitem(m._teardown_state, "signal_installed", False)
        monkeypatch.setattr(m, "stop_active_trace",
                            lambda m=m: ran.append(m.__name__.split(".")[0]))
    signal.signal(signal.SIGTERM, lambda *a: ran.append("process"))
    for m in mods:
        assert m.install_trace_teardown() is True
    signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    assert ran == [mods[1].__name__.split(".")[0], mods[0].__name__.split(".")[0], "process"]


def test_app_hands_its_device_to_an_injected_provider(tmp_path):
    """A provider built without a device (as the reference's tests inject
    one) takes the App's: featureProjection's t-SNE then runs on the CPU
    here instead of asking for a card."""
    from weaviate_tpu_torch.config import Config
    from weaviate_tpu_torch.modules import Provider
    from weaviate_tpu_torch.modules.text2vec_local import LocalTextVectorizer
    from weaviate_tpu_torch.server import App

    provider = Provider()
    provider.register(LocalTextVectorizer())
    app = App(config=Config(), data_path=str(tmp_path), modules=provider, device="cpu")
    try:
        assert provider.get("text2vec-local").device.type == "cpu"
        app.schema.add_class({"class": "Doc", "vectorizer": "text2vec-local",
                              "vectorIndexConfig": {"distance": "cosine"},
                              "properties": [{"name": "body", "dataType": ["text"]}]})
        for body in ("quantum qubits", "quantum physics", "bread flour", "bread oven"):
            app.objects.add({"class": "Doc", "properties": {"body": body}})
        res = app.graphql.execute('{ Get { Doc(nearText: {concepts: ["quantum"]}, limit: 4) '
                                  '{ _additional { featureProjection { vector } } } } }')
        assert "errors" not in res, res
        assert all(len(r["_additional"]["featureProjection"]["vector"]) == 2
                   for r in res["data"]["Get"]["Doc"])
    finally:
        app.shutdown()
