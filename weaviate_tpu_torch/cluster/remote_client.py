# The port's copy of weaviate_tpu/cluster/remote_client.py, its imports pointed at the port.
"""Outbound cluster clients — the `remote_client` seam of ClassIndex/DB.

Reference: adapters/clients/ (RemoteIndex + ReplicationClient): HTTP clients
for remote-shard CRUD/search, replica 2PC, digest reads, and shard file
transfer. Addressing goes through a resolver callable
(class_name, shard_name) -> "host:port" built from the sharding state +
membership, mirroring sharding.RemoteIndex's node lookup
(usecases/sharding/remote_index.go).

Connections are cached per (thread, host); retries are bounded and
jittered (httputil.Http): the `timeout` each client takes is PER ATTEMPT,
the first retry (stale keep-alive socket) is immediate, and later retries
back off exponentially with 0.5x-1.5x jitter so replica fan-out from many
coordinators never retries in lockstep after a node blip.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from weaviate_tpu_torch.cluster import payloads as wire
from weaviate_tpu_torch.cluster.httputil import Http as _Http, RemoteError
from weaviate_tpu_torch.db.shard import SearchResult
from weaviate_tpu_torch.entities.filters import LocalFilter
from weaviate_tpu_torch.entities.storobj import StorObj

__all__ = ["RemoteError", "RemoteIndex", "ReplicationClient", "NodeClient"]


class RemoteIndex:
    """RemoteClient for ClassIndex's non-local shard ops
    (adapters/clients/remote_index.go analog)."""

    def __init__(self, resolver: Callable[[str, str], Optional[str]],
                 timeout: float = 30.0, attempts: int = 3):
        # timeout is per attempt; see httputil.Http's retry policy
        self.resolve = resolver
        self.http = _Http(timeout, attempts=attempts)

    def _host(self, class_name: str, shard_name: str) -> str:
        host = self.resolve(class_name, shard_name)
        if host is None:
            raise RemoteError(503, f"no node for shard {class_name}/{shard_name}")
        return host

    # -- single-object ops ---------------------------------------------------

    def put_object(self, class_name: str, shard: str, obj: StorObj) -> StorObj:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST", f"/indices/{class_name}/shards/{shard}/objects",
            {"objects": [wire.obj_to_wire(obj)]},
        )
        errs = data.get("errors") or [None]
        if errs[0]:
            raise RemoteError(500, errs[0])
        return obj

    def get_object(self, class_name: str, shard: str, uuid: str,
                   include_vector: bool = True) -> Optional[StorObj]:
        host = self._host(class_name, shard)
        vec = "1" if include_vector else "0"
        data = self.http.json(
            host, "GET",
            f"/indices/{class_name}/shards/{shard}/objects/{uuid}?vector={vec}",
        )
        if data["_status"] == 404:
            return None
        return wire.obj_from_wire(data["object"], include_vector)

    def exists(self, class_name: str, shard: str, uuid: str) -> bool:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "GET",
            f"/indices/{class_name}/shards/{shard}/objects/{uuid}:exists",
        )
        return bool(data.get("exists"))

    def delete_object(self, class_name: str, shard: str, uuid: str) -> bool:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "DELETE", f"/indices/{class_name}/shards/{shard}/objects/{uuid}"
        )
        return bool(data.get("deleted"))

    def merge_object(self, class_name: str, shard: str, uuid: str,
                     props: dict, vector=None,
                     meta: Optional[dict] = None) -> Optional[StorObj]:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST",
            f"/indices/{class_name}/shards/{shard}/objects/{uuid}:merge",
            {
                "properties": props,
                "vector": np.asarray(vector, np.float32).tolist() if vector is not None else None,
                "meta": meta,
            },
        )
        if data["_status"] == 404:
            return None
        return wire.obj_from_wire(data["object"])

    # -- batch ---------------------------------------------------------------

    def put_batch(self, class_name: str, shard: str,
                  objs: Sequence[StorObj]) -> list[Optional[Exception]]:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST", f"/indices/{class_name}/shards/{shard}/objects",
            {"objects": wire.objs_to_wire(objs)},
        )
        return [RuntimeError(e) if e else None for e in data.get("errors", [])]

    def delete_by_filter(self, class_name: str, shard: str,
                         flt: Optional[LocalFilter], dry_run: bool) -> list[dict]:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST",
            f"/indices/{class_name}/shards/{shard}/objects:deletebyfilter",
            {"filter": wire.filter_to_wire(flt), "dryRun": dry_run},
        )
        return data.get("objects", [])

    # -- search --------------------------------------------------------------

    def search_shard(
        self, class_name: str, shard: str, q: np.ndarray, k: int,
        flt: Optional[LocalFilter], target_distance: Optional[float],
        include_vector: bool,
    ) -> list[list[SearchResult]]:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST", f"/indices/{class_name}/shards/{shard}/objects:search",
            {
                "vectors": wire.vectors_to_wire(q),
                "k": k,
                "filter": wire.filter_to_wire(flt),
                "targetDistance": target_distance,
                "includeVector": include_vector,
            },
        )
        return [wire.results_from_wire(rows) for rows in data.get("results", [])]

    def search_shard_objects(
        self, class_name: str, shard: str, limit: int,
        flt: Optional[LocalFilter], keyword_ranking: Optional[dict],
        include_vector: bool, cursor_after: Optional[str],
        sort: Optional[list] = None,
    ) -> list[SearchResult]:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST", f"/indices/{class_name}/shards/{shard}/objects:find",
            {
                "limit": limit,
                "filter": wire.filter_to_wire(flt),
                "keywordRanking": keyword_ranking,
                "includeVector": include_vector,
                "cursorAfter": cursor_after,
                "sort": sort,
            },
        )
        return wire.results_from_wire(data.get("results", []))

    def count_shard_filtered(self, class_name: str, shard: str,
                             flt: Optional[LocalFilter]) -> int:
        """Matching-doc count of a remote shard (meta-count aggregations
        move one integer, not the object set)."""
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST", f"/indices/{class_name}/shards/{shard}/objects:aggregations",
            {"filter": wire.filter_to_wire(flt), "countOnly": True},
        )
        if "count" in data:
            return int(data["count"])
        # a peer that predates countOnly replies with the object set —
        # count it rather than silently contributing 0 (rolling upgrades)
        return len(data.get("objects", []))

    def aggregate_shard_columns(self, class_name: str, shard: str,
                                flt: Optional[LocalFilter],
                                props: list[str]) -> dict:
        """Referenced property columns of a remote shard for Aggregate (the
        coordinator concatenates columns and aggregates once — clusterapi
        :aggregations). Only the named columns cross the wire."""
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "POST", f"/indices/{class_name}/shards/{shard}/objects:aggregations",
            {"filter": wire.filter_to_wire(flt), "columns": list(props)},
        )
        if "cols" in data:
            return {"count": int(data.get("count", 0)), "cols": data["cols"]}
        # a peer that predates column pushdown ships the object set —
        # project it here rather than failing (rolling upgrades)
        objs = wire.objs_from_wire(data.get("objects", []))
        return {"count": len(objs),
                "cols": {p: [o.properties.get(p) for o in objs] for p in props}}

    def object_count(self, class_name: str, shard: str) -> int:
        host = self._host(class_name, shard)
        data = self.http.json(
            host, "GET", f"/indices/{class_name}/shards/{shard}/objects:count"
        )
        return int(data.get("count", 0))


class ReplicationClient:
    """Per-replica 2PC + digest + repair transport, addressed by explicit
    node hosts (adapters/clients/replication.go analog)."""

    def __init__(self, timeout: float = 30.0, attempts: int = 3):
        # per-attempt timeout + jittered backoff (httputil.Http): a 2PC
        # coordinator retrying a blipped replica must not hammer it in
        # lockstep with every other coordinator doing the same
        self.http = _Http(timeout, attempts=attempts)

    def prepare(self, host: str, class_name: str, shard: str,
                req_id: str, ops: list[dict]) -> None:
        self.http.json(
            host, "POST", f"/replicas/indices/{class_name}/shards/{shard}/objects",
            {"requestId": req_id, "phase": "prepare", "ops": ops},
        )

    def commit(self, host: str, class_name: str, shard: str, req_id: str) -> list:
        data = self.http.json(
            host, "POST", f"/replicas/indices/{class_name}/shards/{shard}/objects",
            {"requestId": req_id, "phase": "commit"},
        )
        return data.get("results", [])

    def abort(self, host: str, class_name: str, shard: str, req_id: str) -> None:
        try:
            self.http.json(
                host, "POST", f"/replicas/indices/{class_name}/shards/{shard}/objects",
                {"requestId": req_id, "phase": "abort"},
            )
        except (RemoteError, OSError):
            pass  # abort is best-effort; participant TTL cleans up

    def digest(self, host: str, class_name: str, shard: str, uuid: str) -> dict:
        return self.http.json(
            host, "GET",
            f"/replicas/indices/{class_name}/shards/{shard}/objects/{uuid}:digest",
        )

    def digest_many(self, host: str, class_name: str, shard: str,
                    uuids: Sequence[str]) -> list[dict]:
        """Batch digest: one roundtrip for the whole uuid list
        (finder.go DigestObjects)."""
        data = self.http.json(
            host, "POST",
            f"/replicas/indices/{class_name}/shards/{shard}/objects:digest",
            {"uuids": list(uuids)},
        )
        return data.get("digests", [])

    def overwrite(self, host: str, class_name: str, shard: str,
                  objs: Sequence[StorObj], deletes=None) -> None:
        self.http.json(
            host, "POST",
            f"/replicas/indices/{class_name}/shards/{shard}/objects:overwrite",
            {"objects": wire.objs_to_wire(objs), "deletes": deletes or []},
        )

    def fetch_object(self, host: str, class_name: str, shard: str, uuid: str) -> Optional[StorObj]:
        data = self.http.json(
            host, "GET", f"/indices/{class_name}/shards/{shard}/objects/{uuid}?vector=1"
        )
        if data["_status"] == 404:
            return None
        return wire.obj_from_wire(data["object"])


class NodeClient:
    """Cluster-wide node status + schema fetch + shard files (scaler/nodes)."""

    def __init__(self, timeout: float = 30.0, attempts: int = 3):
        self.http = _Http(timeout, attempts=attempts)

    def node_status(self, host: str) -> dict:
        return self.http.json(host, "GET", "/nodes/status")

    def schema(self, host: str) -> dict:
        return self.http.json(host, "GET", "/cluster/schema")

    def list_shard_files(self, host: str, class_name: str, shard: str) -> list[str]:
        data = self.http.json(host, "GET", f"/indices/{class_name}/shards/{shard}:files")
        return data.get("files", [])

    def download_file(self, host: str, class_name: str, shard: str, rel: str) -> bytes:
        status, raw = self.http.request(
            host, "GET", f"/indices/{class_name}/shards/{shard}/files/{rel}"
        )
        if status != 200:
            raise RemoteError(status, raw.decode("utf-8", "replace"))
        return raw

    def upload_file(self, host: str, class_name: str, shard: str,
                    rel: str, data: bytes) -> None:
        status, raw = self.http.request(
            host, "POST", f"/indices/{class_name}/shards/{shard}/files/{rel}",
            body=data, content_type="application/octet-stream",
        )
        if status != 200:
            raise RemoteError(status, raw.decode("utf-8", "replace"))

    def backup_shards(self, host: str, backend: str, backup_id: str,
                      classes: list) -> dict:
        data = self.http.json(
            host, "POST", f"/backups/{backend}/{backup_id}:shards",
            {"classes": classes},
        )
        return data.get("files", {})

    def restore_shards(self, host: str, backend: str, backup_id: str,
                       classes: list) -> None:
        self.http.json(
            host, "POST", f"/backups/{backend}/{backup_id}:restore-shards",
            {"classes": classes},
        )

    def create_shard(self, host: str, class_name: str, shard: str) -> None:
        self.http.json(host, "POST", f"/indices/{class_name}/shards/{shard}:create")

    def reload_shard(self, host: str, class_name: str, shard: str) -> None:
        self.http.json(host, "POST", f"/indices/{class_name}/shards/{shard}:reload")
