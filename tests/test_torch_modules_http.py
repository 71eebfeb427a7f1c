"""The port's HTTP/SaaS module family restated from tests/test_modules_http.py:
sidecar vectorizers, readers (qna/sum/ner/spellcheck), generative, media
and the cloud backup backends, driven against in-process fake services (a
copy of that file's FakeService, built on the port's LocalTextVectorizer),
the port's App on device="cpu"; plus the S3 SigV4 headers of the two
packages, equal for the same clock, keys and request."""

import base64
import datetime
import json
import signal
import threading
import uuid as uuidlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from weaviate_tpu_torch.config import Config
from weaviate_tpu_torch.entities.schema import ClassDef, Property
from weaviate_tpu_torch.entities.storobj import StorObj
from weaviate_tpu_torch.modules import Provider
from weaviate_tpu_torch.modules.text2vec_local import LocalTextVectorizer



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

class FakeService:
    """One fake server covering every sidecar + SaaS route."""

    def __init__(self):
        self.local = LocalTextVectorizer(dim=32)
        self.requests = []
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _body(self):
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}")

            def _send(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/meta":
                    return self._send({"model": "fake"})
                self._send({}, 404)

            def do_POST(self):
                body = self._body()
                svc.requests.append((self.path, body, dict(self.headers)))
                if self.path == "/vectors":
                    key = body.get("text") or body.get("image") or ""
                    return self._send(
                        {"vector": svc.local.vectorize_text([key])[0].tolist()})
                if self.path == "/answers":
                    has = "quantum" in body.get("text", "")
                    return self._send({
                        "answer": "qubits" if has else None,
                        "certainty": 0.9 if has else None, "property": "body"})
                if self.path == "/sum":
                    return self._send({"summary": body.get("text", "")[:10] + "..."})
                if self.path == "/ner":
                    return self._send({"tokens": [
                        {"entity": "MISC", "word": w}
                        for w in body.get("text", "").split()[:2]]})
                if self.path == "/spellcheck":
                    return self._send({
                        "text": body.get("text", ""), "didYouMean": "quantum",
                        "numberOfCorrections": 1})
                if self.path == "/vectorize":
                    texts = body.get("texts") or []
                    images = body.get("images") or []
                    return self._send({
                        "textVectors": [svc.local.vectorize_text([t])[0].tolist()
                                        for t in texts],
                        "imageVectors": [svc.local.vectorize_text([i])[0].tolist()
                                         for i in images]})
                if self.path == "/v1/embeddings":  # openai
                    return self._send({"data": [
                        {"index": i,
                         "embedding": svc.local.vectorize_text([t])[0].tolist()}
                        for i, t in enumerate(body.get("input", []))]})
                if self.path == "/v1/embed":  # cohere
                    return self._send({"embeddings": [
                        svc.local.vectorize_text([t])[0].tolist()
                        for t in body.get("texts", [])]})
                if self.path.startswith("/pipeline/feature-extraction/"):  # hf
                    return self._send([
                        svc.local.vectorize_text([t])[0].tolist()
                        for t in body.get("inputs", [])])
                if self.path == "/v1/chat/completions":  # generative
                    prompt = body["messages"][0]["content"]
                    return self._send({"choices": [{"message": {
                        "content": f"GEN[{prompt[:30]}]"}}]})
                self._send({"error": "no route"}, 404)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture(scope="module")
def svc():
    s = FakeService()
    yield s
    s.close()


def make_doc_class(vectorizer="text2vec-transformers"):
    return ClassDef(
        name="Doc",
        properties=[Property(name="title", data_type=["text"]),
                    Property(name="body", data_type=["text"])],
        vectorizer=vectorizer,
    )


def obj(title, body="", cls="Doc"):
    return StorObj(class_name=cls, uuid=str(uuidlib.uuid4()),
                   properties={"title": title, "body": body})


def test_transformers_vectorizer(svc):
    from weaviate_tpu_torch.modules.text2vec_http import TransformersVectorizer

    v = TransformersVectorizer(svc.url)
    vecs = v.vectorize_text(["hello world"])
    assert vecs.shape == (1, 32)
    out = v.vectorize_object(make_doc_class(), obj("quantum", "qubits"), {})
    assert out is not None and out.shape == (32,)
    assert v.meta().get("model") == "fake"


def test_saas_vectorizers(svc):
    from weaviate_tpu_torch.modules.text2vec_http import (
        CohereVectorizer,
        HuggingFaceVectorizer,
        OpenAIVectorizer,
    )

    oa = OpenAIVectorizer("sk-test", base_url=f"{svc.url}/v1")
    assert oa.vectorize_text(["a", "b"]).shape == (2, 32)
    # auth header actually sent
    path, _, headers = svc.requests[-1]
    assert headers.get("Authorization") == "Bearer sk-test"

    co = CohereVectorizer("co-test", base_url=f"{svc.url}/v1")
    assert co.vectorize_text(["a"]).shape == (1, 32)
    hf = HuggingFaceVectorizer("hf-test", base_url=svc.url)
    assert hf.vectorize_text(["a"]).shape == (1, 32)


def _mk_app(tmp_path, provider):
    from weaviate_tpu_torch.server import App

    return App(config=Config(), data_path=str(tmp_path / "data"), modules=provider,
               device="cpu")


def test_qna_answer_through_graphql(svc, tmp_path):
    from weaviate_tpu_torch.modules.readers import QnATransformers

    p = Provider()
    p.register(LocalTextVectorizer())
    p.register(QnATransformers(svc.url))
    app = _mk_app(tmp_path, p)
    try:
        app.schema.add_class({
            "class": "Doc", "vectorizer": "text2vec-local",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "title", "dataType": ["text"]},
                           {"name": "body", "dataType": ["text"]}]})
        app.objects.add({"class": "Doc", "properties": {
            "title": "physics", "body": "quantum computers use qubits"}})
        app.objects.add({"class": "Doc", "properties": {
            "title": "baking", "body": "bread needs flour"}})
        res = app.graphql.execute(
            '{ Get { Doc(ask: {question: "what do quantum computers use?"},'
            ' nearText: {concepts: ["quantum"]}, limit: 1)'
            ' { title _additional { answer { result hasAnswer certainty } } } } }'
        )
        assert "errors" not in res, res
        hit = res["data"]["Get"]["Doc"][0]
        assert hit["title"] == "physics"
        assert hit["_additional"]["answer"]["result"] == "qubits"
        assert hit["_additional"]["answer"]["hasAnswer"] is True
    finally:
        app.shutdown()


def test_generative_and_sum_and_ner(svc, tmp_path):
    from weaviate_tpu_torch.modules.readers import (
        GenerativeOpenAI,
        NerTransformers,
        SumTransformers,
    )

    p = Provider()
    p.register(LocalTextVectorizer())
    p.register(GenerativeOpenAI("sk-gen", base_url=f"{svc.url}/v1"))
    p.register(SumTransformers(svc.url))
    p.register(NerTransformers(svc.url))
    app = _mk_app(tmp_path, p)
    try:
        app.schema.add_class({
            "class": "Doc", "vectorizer": "text2vec-local",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "title", "dataType": ["text"]},
                           {"name": "body", "dataType": ["text"]}]})
        app.objects.add({"class": "Doc", "properties": {
            "title": "physics news", "body": "quantum entanglement discovery"}})
        res = app.graphql.execute(
            '{ Get { Doc(limit: 1) { title _additional {'
            ' generate(singleResult: {prompt: "Summarize {title}"}) { singleResult }'
            ' summary(properties: ["body"]) { property result }'
            ' tokens { entity word } } } } }'
        )
        assert "errors" not in res, res
        add = res["data"]["Get"]["Doc"][0]["_additional"]
        assert add["generate"]["singleResult"].startswith("GEN[Summarize physics news")
        assert add["summary"][0]["property"] == "body"
        assert add["tokens"][0]["word"] == "physics"
    finally:
        app.shutdown()


def test_media_modules(svc):
    from weaviate_tpu_torch.modules.media import Img2VecNeural, Multi2VecClip

    img_b64 = base64.b64encode(b"\x89PNGfake").decode()
    img_cls = ClassDef(name="Pic", vectorizer="img2vec-neural",
                       properties=[Property(name="image", data_type=["blob"])])
    pic = StorObj(class_name="Pic", uuid=str(uuidlib.uuid4()),
                  properties={"image": img_b64})

    iv = Img2VecNeural(svc.url)
    v = iv.vectorize_object(img_cls, pic, {})
    assert v.shape == (32,)

    clip = Multi2VecClip(svc.url)
    both_cls = ClassDef(name="Pic", vectorizer="multi2vec-clip",
                        properties=[Property(name="caption", data_type=["text"]),
                                    Property(name="image", data_type=["blob"])])
    both = StorObj(class_name="Pic", uuid=str(uuidlib.uuid4()),
                   properties={"caption": "a cat", "image": img_b64})
    v2 = clip.vectorize_object(both_cls, both, {})
    assert v2.shape == (32,)
    assert abs(float(np.linalg.norm(v2)) - 1.0) < 1e-5
    assert clip.vectorize_text(["a dog"]).shape == (1, 32)


def test_near_image_query(svc, tmp_path):
    from weaviate_tpu_torch.modules.media import Img2VecNeural

    p = Provider()
    p.register(Img2VecNeural(svc.url))
    app = _mk_app(tmp_path, p)
    try:
        app.schema.add_class({
            "class": "Pic", "vectorizer": "img2vec-neural",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "image", "dataType": ["blob"]},
                           {"name": "label", "dataType": ["text"]}]})
        imgs = {}
        for label in ("cat", "dog", "fish"):
            b64 = base64.b64encode(f"IMG-{label}".encode()).decode()
            imgs[label] = b64
            app.objects.add({"class": "Pic",
                             "properties": {"image": b64, "label": label}})
        q = json.dumps(imgs["dog"])
        res = app.graphql.execute(
            '{ Get { Pic(nearImage: {image: %s}, limit: 1) { label } } }' % q)
        assert "errors" not in res, res
        assert res["data"]["Get"]["Pic"][0]["label"] == "dog"
    finally:
        app.shutdown()


class FakeBlobStore:
    """One fake server speaking enough S3 / GCS / Azure REST for the backends."""

    def __init__(self):
        self.objects = {}
        self.auth_headers = []
        store = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_PUT(self):
                n = int(self.headers.get("Content-Length") or 0)
                store.objects[self.path.split("?")[0]] = self.rfile.read(n)
                store.auth_headers.append(dict(self.headers))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_POST(self):  # gcs upload
                n = int(self.headers.get("Content-Length") or 0)
                store.objects[self.path] = self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def do_GET(self):
                data = store.objects.get(self.path.split("?")[0])
                # gcs read paths differ from upload paths: match by suffix
                if data is None:
                    for k, v in store.objects.items():
                        if k.split("name=")[-1] == self.path.split("/o/")[-1].split("?")[0]:
                            data = v
                            break
                if data is None:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_s3_backend_sigv4():
    from weaviate_tpu_torch.modules.backup_cloud import S3BackupBackend

    store = FakeBlobStore()
    try:
        be = S3BackupBackend(bucket="bk", access_key="AKIATEST",
                             secret_key="secret", endpoint=store.url)
        be.put_object("b1", "node-0/C/s/vector.log", b"\x01\x02\x03")
        assert be.get_object("b1", "node-0/C/s/vector.log") == b"\x01\x02\x03"
        be.write_meta("b1", {"status": "SUCCESS"})
        assert be.read_meta("b1")["status"] == "SUCCESS"
        assert be.read_meta("ghost") is None
        # SigV4 headers present on writes
        h = store.auth_headers[-1]
        assert h.get("Authorization", "").startswith("AWS4-HMAC-SHA256 Credential=AKIATEST/")
        assert "x-amz-content-sha256" in {k.lower() for k in h}
    finally:
        store.close()


def test_gcs_and_azure_backends():
    from weaviate_tpu_torch.modules.backup_cloud import AzureBackupBackend, GCSBackupBackend

    store = FakeBlobStore()
    try:
        gcs = GCSBackupBackend(bucket="bk", token="tok", base_url=store.url)
        gcs.write_meta("g1", {"status": "SUCCESS"})
        assert gcs.read_meta("g1")["status"] == "SUCCESS"

        az = AzureBackupBackend(account="acct", container="c",
                                sas_token="sv=x&sig=y", base_url=store.url)
        az.put_object("a1", "f.bin", b"zz")
        assert az.get_object("a1", "f.bin") == b"zz"
        az.write_meta("a1", {"status": "SUCCESS"})
        assert az.read_meta("a1")["status"] == "SUCCESS"
        assert az.read_meta("ghost") is None
    finally:
        store.close()


def test_build_provider_full_registry(svc, monkeypatch):
    from weaviate_tpu_torch.modules.provider import build_provider

    monkeypatch.setenv("TRANSFORMERS_INFERENCE_API", svc.url)
    monkeypatch.setenv("QNA_INFERENCE_API", svc.url)
    monkeypatch.setenv("SUM_INFERENCE_API", svc.url)
    monkeypatch.setenv("NER_INFERENCE_API", svc.url)
    monkeypatch.setenv("SPELLCHECK_INFERENCE_API", svc.url)
    monkeypatch.setenv("IMAGE_INFERENCE_API", svc.url)
    monkeypatch.setenv("CLIP_INFERENCE_API", svc.url)
    monkeypatch.setenv("OPENAI_APIKEY", "sk")
    monkeypatch.setenv("COHERE_APIKEY", "co")
    monkeypatch.setenv("HUGGINGFACE_APIKEY", "hf")
    monkeypatch.setenv("BACKUP_S3_BUCKET", "b")
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "k")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "s")
    monkeypatch.setenv("BACKUP_GCS_BUCKET", "b")
    monkeypatch.setenv("BACKUP_GCS_TOKEN", "t")
    monkeypatch.setenv("AZURE_STORAGE_ACCOUNT", "a")
    monkeypatch.setenv("BACKUP_AZURE_CONTAINER", "c")
    monkeypatch.setenv("AZURE_STORAGE_SAS_TOKEN", "sas")
    c = Config()
    c.enable_modules = [
        "text2vec-local", "text2vec-contextionary", "text2vec-transformers",
        "text2vec-openai", "text2vec-cohere", "text2vec-huggingface",
        "ref2vec-centroid", "img2vec-neural", "multi2vec-clip",
        "qna-transformers", "sum-transformers", "ner-transformers",
        "text-spellcheck", "generative-openai",
        "backup-filesystem", "backup-s3", "backup-gcs", "backup-azure",
    ]
    c.contextionary_url = "127.0.0.1:1"
    p = build_provider(c)
    assert len(p.names()) == 18
    assert set(p.additional_properties()) >= {
        "answer", "generate", "summary", "tokens", "spellCheck"}


def test_ask_drives_retrieval(svc, tmp_path):
    """Regression: ask{question} must vectorize the question and retrieve
    relevant objects (not hand arbitrary doc-id-ordered objects to qna)."""
    from weaviate_tpu_torch.modules.readers import QnATransformers

    p = Provider()
    p.register(LocalTextVectorizer())
    p.register(QnATransformers(svc.url))
    app = _mk_app(tmp_path, p)
    try:
        app.schema.add_class({
            "class": "Doc", "vectorizer": "text2vec-local",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "title", "dataType": ["text"]},
                           {"name": "body", "dataType": ["text"]}]})
        # many irrelevant docs FIRST (lower doc ids), relevant one last
        for i in range(10):
            app.objects.add({"class": "Doc", "properties": {
                "title": f"cooking {i}", "body": f"recipe number {i}"}})
        app.objects.add({"class": "Doc", "properties": {
            "title": "physics", "body": "quantum computers use qubits"}})
        res = app.graphql.execute(
            '{ Get { Doc(ask: {question: "quantum computers"}, limit: 1)'
            ' { title _additional { answer { result } } } } }')
        assert "errors" not in res, res
        hit = res["data"]["Get"]["Doc"][0]
        assert hit["title"] == "physics"
        assert hit["_additional"]["answer"]["result"] == "qubits"
    finally:
        app.shutdown()


def test_qna_openai(svc):
    """qna-openai: extractive answers via the chat-completions API."""
    import uuid as _uuid

    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.modules.readers import QnAOpenAI
    from weaviate_tpu_torch.usecases.traverser import SearchResult

    mod = QnAOpenAI("sk-qna", base_url=f"{svc.url}/v1")
    rows = [SearchResult(obj=StorObj(
        class_name="D", uuid=str(_uuid.uuid4()),
        properties={"body": "the GEN answer lives here"}))]
    out = mod.resolve_additional("answer", rows, {"question": "where?"})
    assert out[0]["hasAnswer"] and out[0]["result"].startswith("GEN[")
    # auth header reached the API
    assert any(h.get("Authorization") == "Bearer sk-qna"
               for _, _, h in svc.requests)

    with pytest.raises(Exception):
        mod.resolve_additional("answer", rows, {})  # question required
    with pytest.raises(Exception):
        QnAOpenAI("")  # api key required


def test_autocorrect_transformer(svc, tmp_path):
    """bm25/nearText with autocorrect: true run the query through the
    text-spellcheck transformer before searching (texttransformer.go;
    the fake corrects everything to 'quantum')."""
    from weaviate_tpu_torch.modules.readers import TextSpellcheck

    p = Provider()
    p.register(LocalTextVectorizer())
    p.register(TextSpellcheck(svc.url))
    assert p.transform_text(["quntum"]) == ["quantum"]

    app = _mk_app(tmp_path, p)
    try:
        app.schema.add_class({
            "class": "AC", "vectorizer": "text2vec-local",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "body", "dataType": ["text"]}]})
        import uuid as _uuid

        for i, b in enumerate(["quantum qubits physics", "bread flour yeast"]):
            app.objects.add({"class": "AC", "id": str(_uuid.UUID(int=900 + i)),
                             "properties": {"body": b}})
        # bm25 with a typo: without autocorrect no hits, with it the
        # corrected term matches
        q_plain = '{ Get { AC(bm25: {query: "quntum"}) { body } } }'
        q_fix = '{ Get { AC(bm25: {query: "quntum", autocorrect: true}) { body } } }'
        assert app.graphql.execute(q_plain)["data"]["Get"]["AC"] == []
        hits = app.graphql.execute(q_fix)["data"]["Get"]["AC"]
        assert hits and hits[0]["body"].startswith("quantum")
        # nearText autocorrect: corrected concept ranks the quantum doc first
        q_nt = ('{ Get { AC(nearText: {concepts: ["quntum"], autocorrect: true}, '
                'limit: 1) { body } } }')
        out = app.graphql.execute(q_nt)
        assert out["data"]["Get"]["AC"][0]["body"].startswith("quantum")
    finally:
        app.shutdown()


def test_autocorrect_without_module_errors(tmp_path):
    """autocorrect: true with no transformer enabled is a loud error, not a
    silently-uncorrected search."""
    p = Provider()
    p.register(LocalTextVectorizer())
    app = _mk_app(tmp_path, p)
    try:
        app.schema.add_class({
            "class": "NA", "vectorizer": "text2vec-local",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "body", "dataType": ["text"]}]})
        out = app.graphql.execute(
            '{ Get { NA(bm25: {query: "x", autocorrect: true}) { body } } }')
        assert out.get("errors") and "transformer" in out["errors"][0]["message"]
    finally:
        app.shutdown()



class _FrozenClock:
    """Stands in for the datetime module in backup_cloud: a fixed now()."""

    timezone = datetime.timezone

    class datetime(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return datetime.datetime(2026, 3, 1, 12, 34, 56, tzinfo=tz)


@pytest.mark.parametrize("endpoint, prefix", [
    ("http://127.0.0.1:9000", ""),
    ("", "backups/prod"),
], ids=["path-style", "virtual-host"])
@pytest.mark.parametrize("method, key, payload", [
    ("PUT", "node-0/Doc/shard-0/vector.log", b"\x01\x02\x03"),
    ("GET", "node-0/Doc/shard 0/lsm/objects/segment-1.db", b""),
    ("PUT", "backup_config.json", b'{"status": "SUCCESS"}'),
])
def test_s3_sigv4_equal_across_packages(monkeypatch, endpoint, prefix, method, key, payload):
    import urllib.parse

    from weaviate_tpu.modules import backup_cloud as ref_cloud
    from weaviate_tpu_torch.modules import backup_cloud

    signed = []
    for mod in (backup_cloud, ref_cloud):
        monkeypatch.setattr(mod, "datetime", _FrozenClock)
        be = mod.S3BackupBackend(bucket="bk", access_key="AKIATEST", secret_key="secret",
                                 region="eu-west-1", endpoint=endpoint, path_prefix=prefix)
        enc = urllib.parse.quote(be._key("b1", key), safe="/-_.~")
        path = f"/{be.bucket}/{enc}" if be.path_style else f"/{enc}"
        signed.append(be._sign(method, path, payload))
    assert signed[0] == signed[1]
    assert signed[0]["x-amz-date"] == "20260301T123456Z"
    assert "Credential=AKIATEST/20260301/eu-west-1/s3/aws4_request" in signed[0]["Authorization"]
