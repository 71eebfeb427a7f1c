# The port's copy of weaviate_tpu/cluster/clusterapi.py, its imports pointed at the port.
"""Internal node-to-node HTTP API.

Reference: adapters/handlers/rest/clusterapi/serve.go:36-53 + indices.go
(regex routing over /indices/... shard ops) + replication endpoints
(/replicas/indices/...). This is the second listener a node runs — the data
plane other nodes call for remote-shard ops, schema transactions, replica
2PC, digest reads, and shard file transfer (scaler / backup).

Routes:
  GET    /cluster/health
  GET    /cluster/schema
  GET    /nodes/status
  POST   /schema/transactions/{id}/open|commit|abort
  POST   /indices/{c}/shards/{s}/objects               (batch put)
  POST   /indices/{c}/shards/{s}/objects:search        (vector search)
  POST   /indices/{c}/shards/{s}/objects:find          (bm25/filter/list)
  POST   /indices/{c}/shards/{s}/objects:deletebyfilter
  GET    /indices/{c}/shards/{s}/objects:count
  GET    /indices/{c}/shards/{s}/objects/{uuid}        (?vector=0)
  GET    /indices/{c}/shards/{s}/objects/{uuid}:exists
  DELETE /indices/{c}/shards/{s}/objects/{uuid}
  POST   /indices/{c}/shards/{s}/objects/{uuid}:merge
  GET    /indices/{c}/shards/{s}:files                 (list, relative paths)
  GET    /indices/{c}/shards/{s}/files/{path}          (download)
  POST   /indices/{c}/shards/{s}/files/{path}          (upload; scaler push)
  POST   /indices/{c}/shards/{s}:create                (scaler: init shard)
  POST   /replicas/indices/{c}/shards/{s}/objects      (2PC prepare/commit/abort)
  GET    /replicas/indices/{c}/shards/{s}/objects/{uuid}:digest
  POST   /replicas/indices/{c}/shards/{s}/objects:overwrite (read repair)

The port's listener differs in one setting: its accept backlog is the
system's (socket.SOMAXCONN), as the port's REST listener's is, where the JAX
package keeps socketserver's default of 5, which refuses connections when
a scatter-gather fan-out and replica traffic arrive together.
"""

from __future__ import annotations

import json
import os
import re
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np

from weaviate_tpu_torch.cluster import payloads as wire

_RE_SHARD_OP = re.compile(r"^/indices/([^/]+)/shards/([^/:]+)/objects(:[a-z]+)?$")
_RE_SHARD_OBJ = re.compile(r"^/indices/([^/]+)/shards/([^/:]+)/objects/([0-9a-fA-F-]+)(:[a-z]+)?$")
_RE_SHARD_META = re.compile(r"^/indices/([^/]+)/shards/([^/:]+)(:[a-z]+)$")
_RE_SHARD_FILE = re.compile(r"^/indices/([^/]+)/shards/([^/:]+)/files/(.+)$")
_RE_REPL_OP = re.compile(r"^/replicas/indices/([^/]+)/shards/([^/:]+)/objects(:[a-z]+)?$")
_RE_REPL_OBJ = re.compile(r"^/replicas/indices/([^/]+)/shards/([^/:]+)/objects/([0-9a-fA-F-]+):digest$")
_RE_TX = re.compile(r"^/schema/transactions/([^/]+)/(open|commit|abort)$")
_RE_BACKUP = re.compile(r"^/backups/([^/]+)/([^/:]+):(shards|restore-shards)$")


class _StagedTx:
    __slots__ = ("class_name", "shard_name", "ops", "staged_at")

    def __init__(self, class_name: str, shard_name: str, ops: list[dict]):
        import time

        self.class_name = class_name
        self.shard_name = shard_name
        self.ops = ops
        self.staged_at = time.time()


class ClusterApi:
    """The app-side facade the HTTP handler calls into."""

    def __init__(self, db, schema=None, tx_participant=None, cluster_state=None,
                 node_name: str = "node-0"):
        self.db = db
        self.schema = schema
        self.tx = tx_participant
        self.cluster = cluster_state
        self.node_name = node_name
        self.backup = None  # BackupScheduler, set by node wiring
        self._staged: dict[str, _StagedTx] = {}
        self._staged_lock = threading.Lock()

    # -- shard resolution ----------------------------------------------------

    def _shard(self, class_name: str, shard_name: str):
        idx = self.db.get_index(class_name)
        if idx is None:
            return None
        return idx.shards.get(shard_name)

    # -- replica 2PC (usecases/replica coordinator participant side) ---------

    def replica_prepare(self, req_id: str, class_name: str, shard_name: str,
                        ops: list[dict]) -> None:
        if self._shard(class_name, shard_name) is None:
            # a freshly-promoted replica (scale-out in flight) may not have
            # the shard yet: create it empty — the scaler's file push and
            # read repair converge it
            idx = self.db.get_index(class_name)
            if idx is None:
                raise KeyError(f"class {class_name} not on this node")
            idx._load_shard(shard_name)
        import time

        with self._staged_lock:
            # TTL sweep: a coordinator that died between prepare and commit
            # must not leak staged batches (abort is best-effort)
            now = time.time()
            for rid in [r for r, s in self._staged.items() if now - s.staged_at > 120]:
                del self._staged[rid]
            self._staged[req_id] = _StagedTx(class_name, shard_name, ops)

    def replica_commit(self, req_id: str) -> list:
        with self._staged_lock:
            staged = self._staged.pop(req_id, None)
        if staged is None:
            raise KeyError(f"unknown replication request {req_id}")
        shard = self._shard(staged.class_name, staged.shard_name)
        if shard is None:
            raise KeyError("shard vanished")
        return [self._apply_op(shard, op) for op in staged.ops]

    def replica_abort(self, req_id: str) -> None:
        with self._staged_lock:
            self._staged.pop(req_id, None)

    @staticmethod
    def _apply_op(shard, op: dict):
        """Timestamps inside ops are COORDINATOR-stamped and preserved, so
        every replica stores identical times and digests converge."""
        kind = op["op"]
        if kind == "put":
            stored = shard.put_object(wire.obj_from_wire(op["object"]), preserve_times=True)
            return {
                "creationTimeUnix": stored.creation_time_unix,
                "lastUpdateTimeUnix": stored.last_update_time_unix,
            }
        if kind == "put_batch":
            errs = shard.put_batch(
                wire.objs_from_wire(op["objects"]), preserve_times=True
            )
            return [str(e) if e else None for e in errs]
        if kind == "delete":
            return shard.delete_object(op["uuid"], deletion_time=op.get("deletionTime"))
        if kind == "merge":
            vec = np.asarray(op["vector"], np.float32) if op.get("vector") else None
            got = shard.merge_object(
                op["uuid"], op.get("properties") or {}, vec,
                update_time=op.get("updateTime"),
                meta=op.get("meta"),
            )
            return got is not None
        if kind == "overwrite":
            # read repair: force-apply newer replicas / deletions (repairer.go)
            for s in op.get("objects") or []:
                shard.put_object(wire.obj_from_wire(s), preserve_times=True)
            for d in op.get("deletes") or []:
                shard.delete_object(d["uuid"], deletion_time=d.get("time"))
            return True
        raise ValueError(f"unknown replica op {kind!r}")

    def digest(self, class_name: str, shard_name: str, uuid: str) -> dict:
        shard = self._shard(class_name, shard_name)
        if shard is None:
            raise KeyError("shard not found")
        obj = shard.object_by_uuid(uuid, include_vector=False)
        if obj is None:
            # a known deletion carries its time so reads can order it
            # against stale replicas (otherwise repair would resurrect it)
            dt = shard.deletion_time(uuid)
            return {"uuid": uuid, "exists": False, "updateTime": dt or 0,
                    "deleted": dt is not None}
        return {
            "uuid": uuid,
            "exists": True,
            "updateTime": obj.last_update_time_unix,
        }

    def digest_many(self, class_name: str, shard_name: str,
                    uuids: list[str]) -> list[dict]:
        """Batch digest (finder.go DigestObjects): one request covers every
        uuid — consistency probes cost one roundtrip per replica, not one
        per object."""
        return [self.digest(class_name, shard_name, u) for u in uuids]

    # -- node status (usecases/nodes) ----------------------------------------

    def node_status(self) -> dict:
        shards = []
        total = 0
        for cname, idx in self.db.indexes.items():
            for sname, shard in idx.shards.items():
                cnt = shard.object_count()
                total += cnt
                shards.append({
                    "name": sname, "class": cname, "objectCount": cnt,
                    "vectorIndexingStatus": "READY" if shard.status == "READY" else shard.status,
                })
        return {
            "name": self.node_name,
            "status": "HEALTHY",
            "shards": shards,
            "stats": {"objectCount": total, "shardCount": len(shards)},
            "gitHash": "", "version": "",
        }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    api: ClusterApi = None  # set by subclass factory

    # -- plumbing ------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, code: int, data: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body_json(self):
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def _body_raw(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    # -- dispatch ------------------------------------------------------------

    def _handle(self, method: str) -> None:
        if getattr(self.server, "dead", False):
            # a shut-down node must also stop answering on keep-alive
            # connections opened before shutdown (process-death semantics)
            self.close_connection = True
            raise ConnectionAbortedError("server is shut down")
        try:
            self._route(method)
        except KeyError as e:
            self._json(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — surface as 500 to the peer
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):
        self._handle("GET")

    def do_POST(self):
        self._handle("POST")

    def do_DELETE(self):
        self._handle("DELETE")

    def _route(self, method: str) -> None:
        api = self.api
        parsed = urlparse(self.path)
        path = unquote(parsed.path)
        qs = parse_qs(parsed.query)

        if path == "/cluster/health":
            return self._json(200, {"status": "HEALTHY"})
        if path == "/cluster/schema":
            sch = api.schema.get_schema().to_dict() if api.schema else {"classes": []}
            return self._json(200, sch)
        if path == "/nodes/status":
            return self._json(200, api.node_status())

        m = _RE_TX.match(path)
        if m and method == "POST":
            if api.tx is None:
                return self._json(501, {"error": "no tx participant"})
            tx_id, action = m.group(1), m.group(2)
            body = self._body_json()
            try:
                if action == "open":
                    api.tx.open(tx_id, body["type"], body["payload"])
                elif action == "commit":
                    api.tx.commit(tx_id)
                else:
                    api.tx.abort(tx_id)
            except Exception as e:  # validation failures => reject the tx
                return self._json(409, {"error": str(e)})
            return self._json(200, {"status": "ok"})

        m = _RE_BACKUP.match(path)
        if m and method == "POST":
            if api.backup is None:
                return self._json(501, {"error": "backup not configured on this node"})
            backend, bid, action = m.groups()
            body = self._body_json()
            classes = body.get("classes") or []
            if action == "shards":
                files = api.backup.backup_local(backend, bid, classes)
                return self._json(200, {"files": files})
            api.backup.restore_local(backend, bid, classes)
            return self._json(200, {"status": "ok"})

        m = _RE_REPL_OBJ.match(path)
        if m and method == "GET":
            return self._json(200, api.digest(m.group(1), m.group(2), m.group(3)))

        m = _RE_REPL_OP.match(path)
        if m and method == "POST":
            cname, sname, op = m.group(1), m.group(2), m.group(3)
            body = self._body_json()
            if op == ":digest":
                return self._json(200, {
                    "digests": api.digest_many(cname, sname, body.get("uuids") or [])
                })
            if op == ":overwrite":
                shard = api._shard(cname, sname)
                if shard is None:
                    raise KeyError("shard not found")
                ClusterApi._apply_op(shard, {
                    "op": "overwrite",
                    "objects": body.get("objects") or [],
                    "deletes": body.get("deletes") or [],
                })
                return self._json(200, {"status": "ok"})
            phase = body.get("phase", "prepare")
            req_id = body["requestId"]
            if phase == "prepare":
                api.replica_prepare(req_id, cname, sname, body.get("ops") or [])
                return self._json(200, {"status": "staged"})
            if phase == "commit":
                return self._json(200, {"results": api.replica_commit(req_id)})
            api.replica_abort(req_id)
            return self._json(200, {"status": "aborted"})

        m = _RE_SHARD_FILE.match(path)
        if m:
            cname, sname, rel = m.group(1), m.group(2), m.group(3)
            idx = api.db.get_index(cname)
            if idx is None:
                raise KeyError(f"class {cname}")
            base = os.path.join(idx.path, sname)
            full = os.path.normpath(os.path.join(base, rel))
            if not full.startswith(os.path.normpath(base) + os.sep):
                return self._json(400, {"error": "path escapes shard dir"})
            if method == "GET":
                if not os.path.exists(full):
                    raise KeyError(rel)
                with open(full, "rb") as f:
                    return self._bytes(200, f.read())
            if method == "POST":
                os.makedirs(os.path.dirname(full), exist_ok=True)
                with open(full, "wb") as f:
                    f.write(self._body_raw())
                return self._json(200, {"status": "ok"})

        m = _RE_SHARD_META.match(path)
        if m:
            cname, sname, op = m.group(1), m.group(2), m.group(3)
            if op == ":files" and method == "GET":
                shard = api._shard(cname, sname)
                if shard is None:
                    raise KeyError(f"shard {cname}/{sname}")
                with shard.paused_writes():
                    base = shard.path
                    rels = []
                    for root, _, files in os.walk(base):
                        for fn in files:
                            if fn.endswith(".tmp"):
                                continue
                            rels.append(os.path.relpath(os.path.join(root, fn), base))
                return self._json(200, {"files": sorted(rels)})
            if op == ":create" and method == "POST":
                idx = api.db.get_index(cname)
                if idx is None:
                    raise KeyError(f"class {cname}")
                if sname not in idx.shards:
                    idx._load_shard(sname)
                return self._json(201, {"status": "ok"})
            if op == ":reload" and method == "POST":
                # scaler: pick up freshly-pushed files
                idx = api.db.get_index(cname)
                if idx is None:
                    raise KeyError(f"class {cname}")
                old = idx.shards.pop(sname, None)
                if old is not None:
                    old.shutdown()
                idx._load_shard(sname)
                return self._json(200, {"status": "ok"})

        m = _RE_SHARD_OBJ.match(path)
        if m:
            cname, sname, uid, op = m.groups()
            shard = api._shard(cname, sname)
            if shard is None:
                raise KeyError(f"shard {cname}/{sname}")
            if method == "GET" and op == ":exists":
                return self._json(200, {"exists": shard.exists(uid)})
            if method == "GET":
                include_vec = qs.get("vector", ["1"])[0] != "0"
                obj = shard.object_by_uuid(uid, include_vec)
                if obj is None:
                    return self._json(404, {"error": "not found"})
                return self._json(200, {"object": wire.obj_to_wire(obj)})
            if method == "DELETE":
                return self._json(200, {"deleted": shard.delete_object(uid)})
            if method == "POST" and op == ":merge":
                body = self._body_json()
                vec = (
                    np.asarray(body["vector"], np.float32)
                    if body.get("vector") is not None
                    else None
                )
                got = shard.merge_object(uid, body.get("properties") or {}, vec,
                                         meta=body.get("meta"))
                if got is None:
                    return self._json(404, {"error": "not found"})
                return self._json(200, {"object": wire.obj_to_wire(got)})

        m = _RE_SHARD_OP.match(path)
        if m:
            cname, sname, op = m.groups()
            shard = api._shard(cname, sname)
            if shard is None:
                raise KeyError(f"shard {cname}/{sname}")
            if method == "GET" and op == ":count":
                return self._json(200, {"count": shard.object_count()})
            if method == "POST" and op is None:
                body = self._body_json()
                errs = shard.put_batch(wire.objs_from_wire(body["objects"]))
                return self._json(200, {"errors": [str(e) if e else None for e in errs]})
            if method == "POST" and op == ":search":
                body = self._body_json()
                q = wire.vectors_from_wire(body["vectors"])
                res = shard.object_vector_search(
                    q,
                    int(body["k"]),
                    wire.filter_from_wire(body.get("filter")),
                    body.get("targetDistance"),
                    bool(body.get("includeVector", False)),
                )
                return self._json(
                    200, {"results": [wire.results_to_wire(rows) for rows in res]}
                )
            if method == "POST" and op == ":find":
                body = self._body_json()
                rows = shard.object_search(
                    int(body.get("limit", 25)),
                    wire.filter_from_wire(body.get("filter")),
                    body.get("keywordRanking"),
                    0,
                    bool(body.get("includeVector", False)),
                    body.get("cursorAfter"),
                    body.get("sort"),
                )
                return self._json(200, {"results": wire.results_to_wire(rows)})
            if method == "POST" and op == ":aggregations":
                # remote half of distributed Aggregate (reference:
                # clusterapi indices.go :aggregations): ship back only what
                # the coordinator asked for — one integer (countOnly), the
                # referenced columns (columns), or the full object set for
                # peers predating pushdown; the coordinator runs the same
                # aggregation math over the concatenated columns, so
                # median/mode/topOccurrences/groupBy stay exact
                body = self._body_json()
                flt = wire.filter_from_wire(body.get("filter"))
                if body.get("countOnly"):
                    # meta-count aggregations need one integer, not objects
                    return self._json(
                        200, {"count": len(shard.find_doc_ids(flt))})
                if body.get("columns") is not None:
                    return self._json(200, shard.aggregate_columns(
                        flt, [str(p) for p in body["columns"]]))
                return self._json(200, {"objects": wire.objs_to_wire(
                    shard.find_objects(flt, include_vector=False))})
            if method == "POST" and op == ":deletebyfilter":
                body = self._body_json()
                flt = wire.filter_from_wire(body.get("filter"))
                dry = bool(body.get("dryRun", False))
                results = []
                for u in shard.find_uuids(flt):
                    if dry:
                        results.append({"id": u, "status": "DRYRUN"})
                    else:
                        ok = shard.delete_object(u)
                        results.append({"id": u, "status": "SUCCESS" if ok else "FAILED"})
                return self._json(200, {"objects": results})

        raise KeyError(f"no route {method} {path}")


class _Listener(ThreadingHTTPServer):
    request_queue_size = socket.SOMAXCONN


class ClusterApiServer:
    """serve.go analog: the second HTTP listener."""

    def __init__(self, api: ClusterApi, host: str = "127.0.0.1", port: int = 0):
        handler = type("BoundHandler", (_Handler,), {"api": api})
        self.httpd = _Listener((host, port), handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="clusterapi"
        )
        self._thread.start()

    def shutdown(self) -> None:
        self.httpd.dead = True
        self.httpd.shutdown()
        self.httpd.server_close()
