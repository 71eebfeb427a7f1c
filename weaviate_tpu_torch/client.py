# The port's copy of weaviate_tpu/client.py, its imports pointed at the port.
"""Python client for a weaviate_tpu server.

Reference: client/ (the generated Go client used by acceptance tests) and
the weaviate-python-client surface users actually write against. The client
speaks the same public /v1 REST API any third-party client would — nothing
in here reaches into server internals — so it doubles as the acceptance
harness the reference drives through its generated client.

    client = Client("http://localhost:8080", api_key="...")
    client.schema.create_class({"class": "Article", ...})
    client.data_object.create({"title": "hi"}, "Article", vector=[...])
    res = (client.query.get("Article", ["title"])
           .with_near_vector({"vector": [...]})
           .with_limit(5)
           .do())
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional, Sequence


class ClientError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class _Transport:
    def __init__(self, base_url: str, api_key: Optional[str] = None,
                 bearer_token: Optional[str] = None, timeout: float = 60.0):
        self.base = base_url.rstrip("/")
        self.token = api_key or bearer_token
        self.timeout = timeout

    def request(self, method: str, path: str, body: Any = None,
                params: Optional[dict] = None) -> tuple[int, Any]:
        url = f"{self.base}{path}"
        if params:
            clean = {k: v for k, v in params.items() if v is not None}
            if clean:
                url += "?" + urllib.parse.urlencode(clean)
        data = json.dumps(body).encode("utf-8") if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                return resp.status, json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raw = e.read()
            payload = None
            if raw:
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError:
                    payload = raw.decode("utf-8", "replace")
            return e.code, payload

    def expect(self, method: str, path: str, body: Any = None,
               params: Optional[dict] = None, ok=(200, 201, 204)) -> Any:
        status, payload = self.request(method, path, body, params)
        if status not in ok:
            raise ClientError(status, json.dumps(payload) if payload else "")
        return payload


class _SchemaApi:
    def __init__(self, t: _Transport):
        self._t = t

    def get(self) -> dict:
        return self._t.expect("GET", "/v1/schema")

    def create_class(self, class_def: dict) -> dict:
        return self._t.expect("POST", "/v1/schema", class_def)

    def delete_class(self, name: str) -> None:
        self._t.expect("DELETE", f"/v1/schema/{name}")

    def update_config(self, name: str, updated: dict) -> dict:
        return self._t.expect("PUT", f"/v1/schema/{name}", updated)

    def add_property(self, name: str, prop: dict) -> dict:
        return self._t.expect("POST", f"/v1/schema/{name}/properties", prop)

    def get_class_shards(self, name: str) -> list:
        return self._t.expect("GET", f"/v1/schema/{name}/shards")


class _DataObjectApi:
    def __init__(self, t: _Transport):
        self._t = t

    def create(self, properties: dict, class_name: str,
               uuid: Optional[str] = None, vector: Optional[Sequence[float]] = None,
               consistency_level: Optional[str] = None) -> str:
        body: dict = {"class": class_name, "properties": properties}
        if uuid:
            body["id"] = uuid
        if vector is not None:
            body["vector"] = list(map(float, vector))
        out = self._t.expect("POST", "/v1/objects", body,
                             params={"consistency_level": consistency_level})
        return out["id"]

    def get_by_id(self, uuid: str, class_name: Optional[str] = None,
                  with_vector: bool = False,
                  consistency_level: Optional[str] = None) -> Optional[dict]:
        path = (f"/v1/objects/{class_name}/{uuid}" if class_name
                else f"/v1/objects/{uuid}")
        params = {"consistency_level": consistency_level}
        if with_vector:
            params["include"] = "vector"
        status, payload = self._t.request("GET", path, params=params)
        if status == 404:
            return None
        if status != 200:
            raise ClientError(status, json.dumps(payload) if payload else "")
        return payload

    def exists(self, uuid: str, class_name: Optional[str] = None) -> bool:
        path = (f"/v1/objects/{class_name}/{uuid}" if class_name
                else f"/v1/objects/{uuid}")
        status, _ = self._t.request("HEAD", path)
        return status == 204

    def replace(self, properties: dict, class_name: str, uuid: str,
                vector: Optional[Sequence[float]] = None) -> dict:
        body: dict = {"class": class_name, "properties": properties}
        if vector is not None:
            body["vector"] = list(map(float, vector))
        return self._t.expect("PUT", f"/v1/objects/{class_name}/{uuid}", body)

    def update(self, properties: dict, class_name: str, uuid: str) -> None:
        self._t.expect("PATCH", f"/v1/objects/{class_name}/{uuid}",
                       {"class": class_name, "properties": properties})

    def delete(self, uuid: str, class_name: Optional[str] = None,
               consistency_level: Optional[str] = None) -> None:
        path = (f"/v1/objects/{class_name}/{uuid}" if class_name
                else f"/v1/objects/{uuid}")
        self._t.expect("DELETE", path,
                       params={"consistency_level": consistency_level})

    def reference_add(self, from_class: str, from_uuid: str, prop: str,
                      to_class: str, to_uuid: str) -> None:
        beacon = f"weaviate://localhost/{to_class}/{to_uuid}"
        self._t.expect(
            "POST", f"/v1/objects/{from_class}/{from_uuid}/references/{prop}",
            {"beacon": beacon})


class _BatchApi:
    def __init__(self, t: _Transport):
        self._t = t

    def create_objects(self, objects: list[dict],
                       consistency_level: Optional[str] = None) -> list[dict]:
        return self._t.expect("POST", "/v1/batch/objects", {"objects": objects},
                              params={"consistency_level": consistency_level})

    def delete_objects(self, class_name: str, where: dict,
                       dry_run: bool = False, output: str = "minimal") -> dict:
        return self._t.expect("DELETE", "/v1/batch/objects", {
            "match": {"class": class_name, "where": where},
            "dryRun": dry_run, "output": output})


def _gql_value(v: Any) -> str:
    """Python -> GraphQL literal (enum-ish keys handled by callers)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return json.dumps(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_gql_value(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}: {_gql_value(x)}" for k, x in v.items()) + "}"
    if v is None:
        return "null"
    return str(v)


_ENUM_KEYS = {"operator", "order", "fusionType"}


def _gql_args(args: dict) -> str:
    parts = []
    for k, v in args.items():
        if k in _ENUM_KEYS and isinstance(v, str):
            parts.append(f"{k}: {v}")
        elif isinstance(v, dict):
            inner = _gql_args(v)
            parts.append(f"{k}: {{{inner}}}")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            items = ", ".join(f"{{{_gql_args(x)}}}" for x in v)
            parts.append(f"{k}: [{items}]")
        else:
            parts.append(f"{k}: {_gql_value(v)}")
    return ", ".join(parts)


class QueryBuilder:
    """Fluent Get query (the with_* builder surface users know)."""

    def __init__(self, t: _Transport, class_name: str, properties: Sequence[str]):
        self._t = t
        self.class_name = class_name
        self.properties = list(properties)
        self._args: dict = {}
        self._additional: list[str] = []

    def with_near_vector(self, near: dict) -> "QueryBuilder":
        self._args["nearVector"] = near
        return self

    def with_near_object(self, near: dict) -> "QueryBuilder":
        self._args["nearObject"] = near
        return self

    def with_near_text(self, near: dict) -> "QueryBuilder":
        self._args["nearText"] = near
        return self

    def with_bm25(self, query: str, properties: Optional[list[str]] = None) -> "QueryBuilder":
        arg: dict = {"query": query}
        if properties:
            arg["properties"] = properties
        self._args["bm25"] = arg
        return self

    def with_hybrid(self, query: str, alpha: Optional[float] = None,
                    vector: Optional[list[float]] = None) -> "QueryBuilder":
        arg: dict = {"query": query}
        if alpha is not None:
            arg["alpha"] = alpha
        if vector is not None:
            arg["vector"] = vector
        self._args["hybrid"] = arg
        return self

    def with_where(self, where: dict) -> "QueryBuilder":
        self._args["where"] = where
        return self

    def with_sort(self, sort: list[dict] | dict) -> "QueryBuilder":
        self._args["sort"] = sort if isinstance(sort, list) else [sort]
        return self

    def with_limit(self, limit: int) -> "QueryBuilder":
        self._args["limit"] = limit
        return self

    def with_offset(self, offset: int) -> "QueryBuilder":
        self._args["offset"] = offset
        return self

    def with_after(self, after: str) -> "QueryBuilder":
        self._args["after"] = after
        return self

    def with_ask(self, ask: dict) -> "QueryBuilder":
        self._args["ask"] = ask
        return self

    def with_additional(self, props: Sequence[str] | str) -> "QueryBuilder":
        self._additional.extend([props] if isinstance(props, str) else props)
        return self

    def with_consistency_level(self, level: str) -> "QueryBuilder":
        self._args["consistencyLevel"] = level
        return self

    def build(self) -> str:
        args = f"({_gql_args(self._args)})" if self._args else ""
        fields = " ".join(self.properties)
        if self._additional:
            fields += " _additional { " + " ".join(self._additional) + " }"
        return f"{{ Get {{ {self.class_name}{args} {{ {fields} }} }} }}"

    def do(self) -> list[dict]:
        payload = self._t.expect("POST", "/v1/graphql", {"query": self.build()})
        if payload.get("errors"):
            raise ClientError(422, json.dumps(payload["errors"]))
        return payload["data"]["Get"][self.class_name]


class _QueryApi:
    def __init__(self, t: _Transport):
        self._t = t

    def get(self, class_name: str, properties: Sequence[str]) -> QueryBuilder:
        return QueryBuilder(self._t, class_name, properties)

    def aggregate(self, class_name: str, fields: str) -> dict:
        q = f"{{ Aggregate {{ {class_name} {{ {fields} }} }} }}"
        payload = self.raw(q)
        return payload["data"]["Aggregate"][class_name]

    def raw(self, query: str, variables: Optional[dict] = None) -> dict:
        body: dict = {"query": query}
        if variables:
            body["variables"] = variables
        return self._t.expect("POST", "/v1/graphql", body)


class _BackupApi:
    def __init__(self, t: _Transport):
        self._t = t

    def create(self, backend: str, backup_id: str,
               include: Optional[list[str]] = None,
               exclude: Optional[list[str]] = None) -> dict:
        body: dict = {"id": backup_id}
        if include:
            body["include"] = include
        if exclude:
            body["exclude"] = exclude
        return self._t.expect("POST", f"/v1/backups/{backend}", body)

    def status(self, backend: str, backup_id: str) -> dict:
        return self._t.expect("GET", f"/v1/backups/{backend}/{backup_id}")

    def restore(self, backend: str, backup_id: str,
                include: Optional[list[str]] = None) -> dict:
        body: dict = {}
        if include:
            body["include"] = include
        return self._t.expect("POST", f"/v1/backups/{backend}/{backup_id}/restore", body)

    def restore_status(self, backend: str, backup_id: str) -> dict:
        return self._t.expect("GET", f"/v1/backups/{backend}/{backup_id}/restore")


class _ClassificationApi:
    def __init__(self, t: _Transport):
        self._t = t

    def schedule(self, body: dict) -> dict:
        return self._t.expect("POST", "/v1/classifications", body)

    def get(self, job_id: str) -> dict:
        return self._t.expect("GET", f"/v1/classifications/{job_id}")


class _ClusterApi:
    def __init__(self, t: _Transport):
        self._t = t

    def get_nodes_status(self) -> list[dict]:
        return self._t.expect("GET", "/v1/nodes")["nodes"]


class _ModulesApi:
    """User-facing module endpoints under /v1/modules/<module>/ (the
    contextionary extensions surface)."""

    def __init__(self, t: _Transport):
        self._t = t

    def create_extension(self, module: str, concept: str, definition: str,
                         weight: float = 1.0) -> dict:
        return self._t.expect(
            "POST", f"/v1/modules/{module}/extensions",
            {"concept": concept, "definition": definition, "weight": weight})

    def get_extensions(self, module: str) -> list[dict]:
        return self._t.expect(
            "GET", f"/v1/modules/{module}/extensions")["extensions"]

    def get_concept(self, module: str, concept: str) -> dict:
        return self._t.expect(
            "GET",
            f"/v1/modules/{module}/concepts/{urllib.parse.quote(concept)}")


class Client:
    def __init__(self, url: str = "http://localhost:8080",
                 api_key: Optional[str] = None,
                 bearer_token: Optional[str] = None, timeout: float = 60.0):
        self._t = _Transport(url, api_key, bearer_token, timeout)
        self.schema = _SchemaApi(self._t)
        self.data_object = _DataObjectApi(self._t)
        self.batch = _BatchApi(self._t)
        self.query = _QueryApi(self._t)
        self.backup = _BackupApi(self._t)
        self.classification = _ClassificationApi(self._t)
        self.cluster = _ClusterApi(self._t)
        self.modules = _ModulesApi(self._t)

    def is_ready(self) -> bool:
        try:
            status, _ = self._t.request("GET", "/v1/.well-known/ready")
            return status == 200
        except OSError:
            return False

    def is_live(self) -> bool:
        try:
            status, _ = self._t.request("GET", "/v1/.well-known/live")
            return status == 200
        except OSError:
            return False

    def get_meta(self) -> dict:
        return self._t.expect("GET", "/v1/meta")
