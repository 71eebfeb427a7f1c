# The port's copy of weaviate_tpu/entities/storobj.py, its imports pointed at the port.
"""Versioned binary object codec.

Reference: entities/storobj/storage_object.go (MarshallerVersion 1: docID,
timestamps, UUID, vector as float32 LE, props as JSON; partial decode via
FromBinaryUUIDOnly / FromBinaryOptional :83,111; batched hydration
ObjectsByDocID :211).

Our layout (version 1, little-endian):

    u8  version
    u64 doc_id
    i64 creation_time_unix_ms
    i64 last_update_time_unix_ms
    16B uuid
    u16 len(class_name) | class_name utf-8
    u32 dim            | dim * f32 vector
    u32 len(props_json)| props json utf-8 (includes refs under their prop name)
    u32 len(meta_json) | additional meta json (vector-weights etc.)

Partial decodes read only the fixed prefix (uuid-only) or skip the vector
(no-vector hydration for keyword-only queries).
"""

from __future__ import annotations

import json
import struct
import time
import uuid as uuidlib
from typing import Optional, Sequence

import numpy as np

MARSHALLER_VERSION = 1

_FIXED = struct.Struct("<BQqq16s")  # version, doc_id, created, updated, uuid


class StorObjError(ValueError):
    pass


def _format_uuid(b: bytes) -> str:
    h = b.hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


class StorObj:
    """One stored object: identity + vector + properties.

    `from_binary` is FULLY LAZY: the serving hot path hydrates thousands of
    winners per batch and the native gRPC marshaller re-encodes them straight
    from the stored image, so decoding eagerly would be pure waste. The raw
    buffer is kept; header fields parse on first attribute access, property
    JSON parses on first `.properties` touch, and `raw_if_pristine()` hands
    the storage image back verbatim while nothing was mutated (any setter
    marks the object dirty; mutating the props dict requires materializing
    it, which also voids pristineness)."""

    __slots__ = ("_raw", "_include_vector", "_dirty", "_header",
                 "_class_name", "_uuid", "_uuid_b", "_props", "_props_raw",
                 "_vector", "_vec_span", "_doc_id", "_created", "_updated",
                 "_meta", "_meta_raw")

    def __init__(self, class_name: str, uuid: str, properties: Optional[dict] = None,
                 vector=None, doc_id: int = 0, creation_time_unix: int = 0,
                 last_update_time_unix: int = 0, meta: Optional[dict] = None):
        self._raw = None
        self._include_vector = True
        self._dirty = True  # constructed in memory, not a storage image
        self._header = True
        self._class_name = class_name
        self._uuid = uuid
        self._uuid_b = None
        self._props = properties if properties is not None else {}
        self._props_raw = None
        self._vec_span = None
        self._doc_id = doc_id
        if creation_time_unix == 0:
            now = int(time.time() * 1000)
            creation_time_unix = now
            last_update_time_unix = now
        self._created = creation_time_unix
        self._updated = last_update_time_unix
        self._meta = meta if meta is not None else {}
        self._meta_raw = None
        if vector is not None and not isinstance(vector, np.ndarray):
            vector = np.asarray(vector, dtype=np.float32)
        self._vector = vector

    # -- lazy decode ---------------------------------------------------------

    def _decode_header(self) -> None:
        data = self._raw
        _, self._doc_id, self._created, self._updated, self._uuid_b = _FIXED.unpack_from(data, 0)
        off = _FIXED.size
        (cls_len,) = struct.unpack_from("<H", data, off)
        off += 2
        self._class_name = data[off : off + cls_len].decode("utf-8")
        off += cls_len
        (dim,) = struct.unpack_from("<I", data, off)
        off += 4
        if dim:
            self._vec_span = (off, dim)
            off += dim * 4
        (plen,) = struct.unpack_from("<I", data, off)
        off += 4
        self._props_raw = data[off : off + plen] if plen else b"{}"
        off += plen
        (mlen,) = struct.unpack_from("<I", data, off)
        off += 4
        self._meta_raw = data[off : off + mlen] if mlen else b""
        self._header = True

    # -- attributes -----------------------------------------------------------

    @property
    def class_name(self) -> str:
        if not self._header:
            self._decode_header()
        return self._class_name

    @class_name.setter
    def class_name(self, v: str) -> None:
        if not self._header:
            self._decode_header()
        self._class_name = v
        self._dirty = True

    @property
    def uuid(self) -> str:
        if self._uuid is None:
            if not self._header:
                self._decode_header()
            self._uuid = _format_uuid(self._uuid_b)
        return self._uuid

    @uuid.setter
    def uuid(self, v: str) -> None:
        if not self._header:
            self._decode_header()
        self._uuid = v
        self._uuid_b = None
        self._dirty = True

    @property
    def doc_id(self) -> int:
        if not self._header:
            self._decode_header()
        return self._doc_id

    @doc_id.setter
    def doc_id(self, v: int) -> None:
        if not self._header:
            self._decode_header()
        self._doc_id = v
        self._dirty = True

    @property
    def creation_time_unix(self) -> int:
        if not self._header:
            self._decode_header()
        return self._created

    @creation_time_unix.setter
    def creation_time_unix(self, v: int) -> None:
        if not self._header:
            self._decode_header()
        self._created = v
        self._dirty = True

    @property
    def last_update_time_unix(self) -> int:
        if not self._header:
            self._decode_header()
        return self._updated

    @last_update_time_unix.setter
    def last_update_time_unix(self, v: int) -> None:
        if not self._header:
            self._decode_header()
        self._updated = v
        self._dirty = True

    @property
    def vector(self) -> Optional[np.ndarray]:
        if self._vector is None and self._include_vector:
            if not self._header:
                self._decode_header()
            if self._vec_span is not None:
                off, dim = self._vec_span
                self._vector = np.frombuffer(
                    self._raw, dtype="<f4", count=dim, offset=off).copy()
        return self._vector

    @vector.setter
    def vector(self, v) -> None:
        if not self._header:
            self._decode_header()
        if v is not None and not isinstance(v, np.ndarray):
            v = np.asarray(v, dtype=np.float32)
        self._vector = v
        self._vec_span = None
        self._include_vector = True
        self._dirty = True

    @property
    def properties(self) -> dict:
        if self._props is None:
            if not self._header:
                self._decode_header()
            self._props = json.loads(self._props_raw) if self._props_raw else {}
        return self._props

    @properties.setter
    def properties(self, value: dict) -> None:
        self._props = value
        self._props_raw = None
        self._dirty = True

    @property
    def meta(self) -> dict:
        if self._meta is None:
            if not self._header:
                self._decode_header()
            self._meta = json.loads(self._meta_raw) if self._meta_raw else {}
        return self._meta

    @meta.setter
    def meta(self, value: dict) -> None:
        self._meta = value
        self._meta_raw = None
        self._dirty = True

    # -- hot-path accessors ---------------------------------------------------

    def props_json_bytes(self) -> Optional[bytes]:
        """The stored properties JSON, ONLY while the dict was never
        materialized (=> cannot have been mutated); None once touched."""
        if self._props is not None:
            return None
        if not self._header:
            self._decode_header()
        return self._props_raw

    def raw_if_pristine(self) -> Optional[bytes]:
        """The full storage image, ONLY while nothing was mutated — the
        native reply marshaller and replication file copies reuse it
        verbatim. None for constructed or touched objects."""
        if self._raw is not None and not self._dirty and self._props is None \
                and self._meta is None:
            return self._raw
        return None

    def __repr__(self) -> str:  # debugging parity with the old dataclass
        return (f"StorObj(class_name={self.class_name!r}, uuid={self.uuid!r}, "
                f"doc_id={self.doc_id})")

    # -- codec ---------------------------------------------------------------

    def to_binary(self) -> bytes:
        raw = self.raw_if_pristine()
        if raw is not None:
            return raw
        u = self._uuid_b if self._uuid_b is not None else uuidlib.UUID(self.uuid).bytes
        cls_b = self.class_name.encode("utf-8")
        props_b = self.props_json_bytes()
        if props_b is None:
            props_b = json.dumps(self.properties, separators=(",", ":"),
                                 default=str).encode("utf-8")
        meta = self.meta
        meta_b = json.dumps(meta, separators=(",", ":")).encode("utf-8") if meta else b""
        vec = self.vector
        if vec is not None:
            vec = np.ascontiguousarray(vec, dtype=np.float32)
            vec_b = vec.tobytes()
            dim = vec.shape[0]
        else:
            vec_b = b""
            dim = 0
        parts = [
            _FIXED.pack(
                MARSHALLER_VERSION,
                self.doc_id,
                self.creation_time_unix,
                self.last_update_time_unix,
                u,
            ),
            struct.pack("<H", len(cls_b)),
            cls_b,
            struct.pack("<I", dim),
            vec_b,
            struct.pack("<I", len(props_b)),
            props_b,
            struct.pack("<I", len(meta_b)),
            meta_b,
        ]
        return b"".join(parts)

    @classmethod
    def from_binary(cls, data: bytes, include_vector: bool = True) -> "StorObj":
        if data[0] != MARSHALLER_VERSION:
            raise StorObjError(f"unsupported marshaller version {data[0]}")
        o = cls.__new__(cls)
        o._raw = data
        o._include_vector = include_vector
        o._dirty = False
        o._header = False
        o._class_name = None
        o._uuid = None
        o._uuid_b = None
        o._props = None
        o._props_raw = None
        o._vector = None
        o._vec_span = None
        o._doc_id = None
        o._created = None
        o._updated = None
        o._meta = None
        o._meta_raw = None
        return o

    @staticmethod
    def uuid_from_binary(data: bytes) -> str:
        """Partial decode of only the UUID (reference FromBinaryUUIDOnly :83)."""
        _, _, _, _, u = _FIXED.unpack_from(data, 0)
        return _format_uuid(u)

    @staticmethod
    def doc_id_from_binary(data: bytes) -> int:
        _, doc_id, _, _, _ = _FIXED.unpack_from(data, 0)
        return doc_id

    @staticmethod
    def vector_from_binary(data: bytes) -> Optional[np.ndarray]:
        """Decode only the vector (skips identity + class name)."""
        off = _FIXED.size
        (cls_len,) = struct.unpack_from("<H", data, off)
        off += 2 + cls_len
        (dim,) = struct.unpack_from("<I", data, off)
        off += 4
        if not dim:
            return None
        return np.frombuffer(data, dtype="<f4", count=dim, offset=off).copy()

    # -- API shape -----------------------------------------------------------

    def to_rest(self, include_vector: bool = False, additional: Optional[dict] = None) -> dict:
        d = {
            "class": self.class_name,
            "id": self.uuid,
            "properties": self.properties,
            "creationTimeUnix": self.creation_time_unix,
            "lastUpdateTimeUnix": self.last_update_time_unix,
        }
        if include_vector and self.vector is not None:
            d["vector"] = [float(x) for x in self.vector]
        if additional:
            d["additional"] = additional
        return d


def objects_by_doc_id(
    getter, doc_ids: Sequence[int], include_vector: bool = True
) -> list[Optional[StorObj]]:
    """Batched hydration of winners by docID (reference storage_object.go:211).
    `getter(doc_id) -> Optional[bytes]`."""
    out: list[Optional[StorObj]] = []
    for d in doc_ids:
        raw = getter(d)
        out.append(StorObj.from_binary(raw, include_vector) if raw is not None else None)
    return out
