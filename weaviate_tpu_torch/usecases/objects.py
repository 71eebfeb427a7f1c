# The port's copy of weaviate_tpu/usecases/objects.py, its imports pointed at the port.
"""Objects manager: single-object CRUD + batch with validation/auto-schema.

Reference: usecases/objects — Manager (add/get/update/merge/delete/validate,
manager.go) and BatchManager (batch_add.go:29 AddObjects: concurrent
validation, auto-schema, module vectorization, then repo batch put).
"""

from __future__ import annotations

import uuid as uuidlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from weaviate_tpu_torch.entities.storobj import StorObj


class ObjectsError(ValueError):
    pass


class NotFoundError(ObjectsError):
    pass


def _valid_uuid(u: str) -> str:
    try:
        return str(uuidlib.UUID(u))
    except (ValueError, AttributeError, TypeError) as e:
        raise ObjectsError(f"invalid uuid {u!r}") from e


@dataclass
class BatchResult:
    """Per-object batch outcome (reference BatchObject with Err)."""

    obj: Optional[StorObj] = None
    err: Optional[str] = None
    original: dict = field(default_factory=dict)


class ObjectsManager:
    def __init__(self, db, schema_manager, auto_schema=None, modules=None, metrics=None):
        self.db = db
        self.schema = schema_manager
        self.auto = auto_schema
        self.modules = modules  # modules provider (vectorize-at-import)
        self.metrics = metrics

    # -- validation + vectorization ------------------------------------------

    def _prepare(self, payload: dict, require_class: bool = True) -> StorObj:
        class_name = payload.get("class") or payload.get("class_name")
        if not class_name:
            raise ObjectsError("object is missing a class")
        props = payload.get("properties") or {}
        if self.auto is not None:
            class_name = self.auto.ensure(class_name, props)
        else:
            resolved = self.schema.resolve_class_name(class_name)
            if resolved is None:
                raise ObjectsError(f"class {class_name!r} not found in schema")
            class_name = resolved
        cd = self.schema.get_class(class_name)
        props = self._validate_props(cd, props)
        obj_uuid = payload.get("id")
        obj_uuid = _valid_uuid(obj_uuid) if obj_uuid else str(uuidlib.uuid4())
        vector = payload.get("vector")
        obj = StorObj(
            class_name=class_name,
            uuid=obj_uuid,
            properties=props,
            vector=np.asarray(vector, dtype=np.float32) if vector is not None else None,
        )
        if obj.vector is None and self.modules is not None:
            vec = self.modules.vectorize_object(cd, obj)
            if vec is not None:
                obj.vector = np.asarray(vec, dtype=np.float32)
        return obj

    def _validate_props(self, cd, props: dict) -> dict:
        """Validate the payload's properties; -> a normalized COPY (parsed
        phoneNumbers etc.) so validate-only callers never see their input
        mutated."""
        from weaviate_tpu_torch.entities.phone import PhoneNumberError, parse_phone_number
        from weaviate_tpu_torch.entities.schema import DataType

        props = dict(props)
        for key, value in props.items():
            prop = cd.get_property(key)
            if prop is None:
                if self.auto is None or not self.auto.enabled:
                    raise ObjectsError(
                        f"property {key!r} not in schema of class {cd.name!r}"
                    )
                continue
            pt = prop.primitive_type()
            if pt is None:
                # cross-reference: list of beacons
                if value is not None and not isinstance(value, list):
                    raise ObjectsError(f"reference property {key!r} must be a list of beacons")
            elif pt.base is DataType.PHONE_NUMBER and value is not None:
                # validate-and-parse at import (validation/phone_numbers.go):
                # the stored value gains the read-only parsed fields
                try:
                    props[key] = parse_phone_number(value, key, cd.name)
                except PhoneNumberError as e:
                    raise ObjectsError(str(e)) from e
            elif value is not None:
                # per-type shape validation (validation/
                # properties_validation.go): bad values are 422s at import,
                # not corrupt rows discovered at query time
                if pt.is_array:
                    if not isinstance(value, list):
                        raise ObjectsError(
                            f"invalid {pt.value} property {key!r} on class "
                            f"{cd.name!r}: must be a list")
                    vals = value
                else:
                    vals = [value]
                for v in vals:
                    self._validate_primitive(pt.base, v, key, cd.name)
        return props

    @staticmethod
    def _validate_primitive(base, v, key: str, cls: str) -> None:
        from weaviate_tpu_torch.entities.schema import DataType

        where = f"property {key!r} on class {cls!r}"
        if base is DataType.DATE:
            from datetime import datetime

            if not isinstance(v, str):
                raise ObjectsError(
                    f"invalid date {where}: requires an RFC3339 string, got "
                    f"{type(v).__name__}")
            try:
                datetime.fromisoformat(v.replace("Z", "+00:00"))
            except ValueError as e:
                raise ObjectsError(f"invalid date {where}: {v!r}") from e
        elif base is DataType.GEO_COORDINATES:
            if not isinstance(v, dict):
                raise ObjectsError(f"invalid geoCoordinates {where}: must be a map")
            for fld in ("latitude", "longitude"):
                if fld not in v:
                    raise ObjectsError(
                        f"invalid geoCoordinates {where}: missing required "
                        f"field {fld!r}")
                if not isinstance(v[fld], (int, float)) or isinstance(v[fld], bool):
                    raise ObjectsError(
                        f"invalid geoCoordinates {where}: {fld} must be a number")
            if not (-90.0 <= float(v["latitude"]) <= 90.0):
                raise ObjectsError(f"invalid geoCoordinates {where}: latitude out of range")
            if not (-180.0 <= float(v["longitude"]) <= 180.0):
                raise ObjectsError(f"invalid geoCoordinates {where}: longitude out of range")
        elif base is DataType.BLOB:
            import base64
            import binascii

            if not isinstance(v, str):
                raise ObjectsError(f"invalid blob {where}: must be a base64 string")
            try:
                base64.b64decode(v, validate=True)
            except (binascii.Error, ValueError) as e:
                raise ObjectsError(f"invalid blob {where}: not valid base64") from e
        elif base is DataType.UUID:
            try:
                uuidlib.UUID(str(v))
            except ValueError as e:
                raise ObjectsError(f"invalid uuid {where}: {v!r}") from e

    def _index_or_raise(self, class_name: str):
        resolved = self.schema.resolve_class_name(class_name)
        idx = self.db.get_index(resolved) if resolved else None
        if idx is None:
            raise NotFoundError(f"class {class_name!r} not found")
        return idx

    # -- CRUD (usecases/objects/manager.go) ----------------------------------

    def add(self, payload: dict, cl: Optional[str] = None) -> StorObj:
        obj = self._prepare(payload)
        idx = self._index_or_raise(obj.class_name)
        if payload.get("id") and idx.exists(obj.uuid):
            raise ObjectsError(f"id {obj.uuid!r} already exists")
        return idx.put_object(obj, cl=cl)

    def get(
        self, uuid: str, class_name: Optional[str] = None, include_vector: bool = False,
        cl: Optional[str] = None,
    ) -> StorObj:
        uuid = _valid_uuid(uuid)
        if class_name:
            idx = self._index_or_raise(class_name)
            obj = idx.object_by_uuid(uuid, include_vector, cl=cl)
        else:
            obj, _ = self.db.object_by_uuid_any_class(uuid, include_vector)
        if obj is None:
            raise NotFoundError(f"object {uuid} not found")
        return obj

    def exists(self, uuid: str, class_name: Optional[str] = None) -> bool:
        uuid = _valid_uuid(uuid)
        if class_name:
            resolved = self.schema.resolve_class_name(class_name)
            idx = self.db.get_index(resolved) if resolved else None
            return idx.exists(uuid) if idx else False
        obj, _ = self.db.object_by_uuid_any_class(uuid, include_vector=False)
        return obj is not None

    def update(self, uuid: str, payload: dict, cl: Optional[str] = None) -> StorObj:
        """PUT semantics: full replace (keeps creation time via shard upsert)."""
        uuid = _valid_uuid(uuid)
        payload = dict(payload)
        payload["id"] = uuid
        obj = self._prepare(payload)
        idx = self._index_or_raise(obj.class_name)
        if not idx.exists(uuid):
            raise NotFoundError(f"object {uuid} not found")
        return idx.put_object(obj, cl=cl)

    def _revectorize(self, idx, cd, uuid: str, new_props: dict) -> Optional[np.ndarray]:
        """Recompute the module vector for an object whose properties are
        about to change (PATCH / reference mutation): without this, nearText
        keeps ranking the object by its pre-edit text."""
        if self.modules is None or not cd.vectorizer or cd.vectorizer == "none":
            return None
        cur = idx.object_by_uuid(uuid, include_vector=False)
        if cur is None:
            return None
        merged = dict(cur.properties)
        merged.update(new_props)
        before = StorObj(class_name=cd.name, uuid=uuid, properties=cur.properties)
        preview = StorObj(class_name=cd.name, uuid=uuid, properties=merged)
        # only recompute when the edit changes what the module would embed —
        # a PATCH of non-vectorized props must not clobber a custom vector.
        # Inputs are compared instead of embeddings: one (zero, usually)
        # vectorizer call, and embedder outages surface as errors rather
        # than silently keeping a stale vector.
        input_before = self.modules.vectorization_input(cd, before)
        input_after = self.modules.vectorization_input(cd, preview)
        if input_before is not None and input_before == input_after:
            return None
        return self.modules.vectorize_object(cd, preview)

    def merge(self, uuid: str, class_name: str, props: dict, vector=None,
              cl: Optional[str] = None) -> StorObj:
        """PATCH semantics (MergeObject)."""
        uuid = _valid_uuid(uuid)
        idx = self._index_or_raise(class_name)
        cd = self.schema.get_class(idx.class_name)
        if self.auto is not None:
            self.auto.ensure(idx.class_name, props)
        props = self._validate_props(cd, props)
        if vector is None:
            vector = self._revectorize(idx, cd, uuid, props)
        out = idx.merge_object(uuid, props, vector, cl=cl)
        if out is None:
            raise NotFoundError(f"object {uuid} not found")
        return out

    def delete(self, uuid: str, class_name: Optional[str] = None,
               cl: Optional[str] = None) -> None:
        uuid = _valid_uuid(uuid)
        if class_name:
            idx = self._index_or_raise(class_name)
            if not idx.delete_object(uuid, cl=cl):
                raise NotFoundError(f"object {uuid} not found")
            return
        obj, idx = self.db.object_by_uuid_any_class(uuid, include_vector=False)
        if obj is None:
            raise NotFoundError(f"object {uuid} not found")
        idx.delete_object(uuid, cl=cl)

    def list_objects(
        self,
        class_name: Optional[str] = None,
        limit: int = 25,
        offset: int = 0,
        after: Optional[str] = None,
        include_vector: bool = False,
    ) -> list[StorObj]:
        if class_name:
            idx = self._index_or_raise(class_name)
            res = idx.object_search(
                limit, offset=offset, include_vector=include_vector, cursor_after=after
            )
            return [r.obj for r in res]
        out: list[StorObj] = []
        for idx in self.db.indexes.values():
            res = idx.object_search(limit + offset, offset=0, include_vector=include_vector)
            out.extend(r.obj for r in res)
        return out[offset : offset + limit]

    def validate(self, payload: dict) -> None:
        """POST /v1/objects/validate: prepare without writing."""
        self._prepare(payload)

    # -- references ----------------------------------------------------------

    def _merge_with_revector(self, idx, uuid: str, props: dict) -> None:
        """Reference mutations go through merge + re-vectorization so a
        ref2vec-centroid class keeps its vector in sync with its refs."""
        cd = self.schema.get_class(idx.class_name)
        vec = self._revectorize(idx, cd, uuid, props)
        idx.merge_object(uuid, props, vec)

    def add_reference(self, uuid: str, class_name: str, prop: str, beacon: str) -> None:
        idx = self._index_or_raise(class_name)
        obj = idx.object_by_uuid(_valid_uuid(uuid), include_vector=False)
        if obj is None:
            raise NotFoundError(f"object {uuid} not found")
        refs = obj.properties.get(prop) or []
        refs.append({"beacon": beacon})
        self._merge_with_revector(idx, obj.uuid, {prop: refs})

    def put_references(self, uuid: str, class_name: str, prop: str, beacons: list[str]) -> None:
        idx = self._index_or_raise(class_name)
        uuid = _valid_uuid(uuid)
        if not idx.exists(uuid):
            raise NotFoundError(f"object {uuid} not found")
        self._merge_with_revector(idx, uuid, {prop: [{"beacon": b} for b in beacons]})

    def delete_reference(self, uuid: str, class_name: str, prop: str, beacon: str) -> None:
        idx = self._index_or_raise(class_name)
        obj = idx.object_by_uuid(_valid_uuid(uuid), include_vector=False)
        if obj is None:
            raise NotFoundError(f"object {uuid} not found")
        refs = [r for r in (obj.properties.get(prop) or []) if r.get("beacon") != beacon]
        self._merge_with_revector(idx, obj.uuid, {prop: refs})


class BatchManager:
    """Batch import (usecases/objects/batch_add.go)."""

    def __init__(self, objects_manager: ObjectsManager):
        self.om = objects_manager

    def add_objects(self, payloads: Sequence[dict],
                    cl: Optional[str] = None) -> list[BatchResult]:
        results = [BatchResult(original=p) for p in payloads]
        by_class: dict[str, list[int]] = {}
        for i, p in enumerate(payloads):
            try:
                obj = self.om._prepare(p)
                results[i].obj = obj
                by_class.setdefault(obj.class_name, []).append(i)
            except Exception as e:
                results[i].err = str(e)
        for class_name, idxs in by_class.items():
            index = self.om.db.get_index(class_name)
            if index is None:
                for i in idxs:
                    results[i].err = f"class {class_name!r} not found"
                continue
            errs = index.put_batch([results[i].obj for i in idxs], cl=cl)
            for i, e in zip(idxs, errs):
                if e is not None:
                    results[i].err = str(e)
        return results

    def add_references(self, refs: Sequence[dict]) -> list[dict]:
        """POST /v1/batch/references: [{from: beacon w/ prop, to: beacon}]."""
        out = []
        for r in refs:
            try:
                frm, to = r.get("from", ""), r.get("to", "")
                # from format: weaviate://localhost/{Class}/{uuid}/{prop}
                parts = frm.split("weaviate://")[-1].split("/")
                if len(parts) < 4:
                    raise ObjectsError(f"invalid 'from' beacon {frm!r}")
                _, class_name, uuid, prop = parts[:4]
                self.om.add_reference(uuid, class_name, prop, to)
                out.append({"from": frm, "to": to, "result": {"status": "SUCCESS"}})
            except Exception as e:
                out.append(
                    {
                        "from": r.get("from"),
                        "to": r.get("to"),
                        "result": {"status": "FAILED", "errors": {"error": [{"message": str(e)}]}},
                    }
                )
        return out

    def delete_objects(
        self,
        class_name: str,
        where: Optional[dict],
        dry_run: bool = False,
        output: str = "minimal",
    ) -> dict:
        from weaviate_tpu_torch.entities.filters import LocalFilter

        idx = self.om._index_or_raise(class_name)
        flt = LocalFilter.from_dict(where) if where else None
        res = idx.delete_by_filter(flt, dry_run=dry_run)
        successful = sum(1 for o in res["objects"] if o["status"] == "SUCCESS")
        failed = sum(1 for o in res["objects"] if o["status"] == "FAILED")
        out = {
            "match": {"class": class_name, "where": where},
            "output": output,
            "dryRun": dry_run,
            "results": {
                "matches": res["matches"],
                "limit": 10000,
                "successful": successful,
                "failed": failed,
            },
        }
        if output == "verbose":
            out["results"]["objects"] = res["objects"]
        return out
