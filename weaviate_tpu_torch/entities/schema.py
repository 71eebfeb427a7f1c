# The port's copy of weaviate_tpu/entities/schema.py, its imports pointed at the port.
"""Schema data model: classes, properties, data types, tokenizations.

Reference: entities/schema/data_types.go:24-58 (data types),
entities/models/property.go:88-98 (tokenizations),
entities/models (swagger models for Class / Property).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


class DataType(str, Enum):
    # primitive
    CREF = "cref"
    TEXT = "text"
    STRING = "string"  # deprecated alias of text (reference keeps it)
    INT = "int"
    NUMBER = "number"
    BOOLEAN = "boolean"
    DATE = "date"
    GEO_COORDINATES = "geoCoordinates"
    PHONE_NUMBER = "phoneNumber"
    BLOB = "blob"
    UUID = "uuid"
    # array variants
    TEXT_ARRAY = "text[]"
    STRING_ARRAY = "string[]"
    INT_ARRAY = "int[]"
    NUMBER_ARRAY = "number[]"
    BOOLEAN_ARRAY = "boolean[]"
    DATE_ARRAY = "date[]"
    UUID_ARRAY = "uuid[]"

    @property
    def is_array(self) -> bool:
        return self.value.endswith("[]")

    @property
    def base(self) -> "DataType":
        if self.is_array:
            return DataType(self.value[:-2])
        return self

    @property
    def is_reference(self) -> bool:
        return self is DataType.CREF


PRIMITIVE_DATA_TYPES = {d.value for d in DataType}


class Tokenization(str, Enum):
    """Property tokenizations (entities/models/property.go:88-98)."""

    WORD = "word"
    LOWERCASE = "lowercase"
    WHITESPACE = "whitespace"
    FIELD = "field"


_CLASS_NAME_RE = re.compile(r"^[A-Z][_0-9A-Za-z]*$")
_PROP_NAME_RE = re.compile(r"^[_A-Za-z][_0-9A-Za-z]*$")


class SchemaError(ValueError):
    pass


@dataclass
class Property:
    """A class property (entities/models/property.go)."""

    name: str
    data_type: list[str]  # either one primitive DataType value or class names (cref)
    description: str = ""
    tokenization: str = Tokenization.WORD.value
    index_filterable: bool = True   # roaring-set bucket (reference indexFilterable)
    index_searchable: bool = True   # map bucket w/ term frequencies (indexSearchable)
    module_config: dict = field(default_factory=dict)
    nested_properties: list = field(default_factory=list)

    def primitive_type(self) -> Optional[DataType]:
        if len(self.data_type) == 1 and self.data_type[0] in PRIMITIVE_DATA_TYPES:
            return DataType(self.data_type[0])
        return None

    def is_reference(self) -> bool:
        return self.primitive_type() is None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "dataType": list(self.data_type),
            "description": self.description,
            "tokenization": self.tokenization,
            "indexFilterable": self.index_filterable,
            "indexSearchable": self.index_searchable,
            "moduleConfig": self.module_config,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Property":
        return cls(
            name=d["name"],
            data_type=list(d.get("dataType") or ["text"]),
            description=d.get("description", ""),
            tokenization=d.get("tokenization") or Tokenization.WORD.value,
            index_filterable=d.get("indexFilterable", True),
            index_searchable=d.get("indexSearchable", True),
            module_config=d.get("moduleConfig") or {},
        )


@dataclass
class ClassDef:
    """A schema class (reference: entities/models.Class)."""

    name: str
    description: str = ""
    properties: list[Property] = field(default_factory=list)
    vectorizer: str = ""  # empty = unset -> DEFAULT_VECTORIZER_MODULE applies
    vector_index_type: str = "hnsw_tpu"
    vector_index_config: dict = field(default_factory=dict)
    inverted_index_config: dict = field(default_factory=dict)
    sharding_config: dict = field(default_factory=dict)
    replication_config: dict = field(default_factory=dict)
    module_config: dict = field(default_factory=dict)
    multi_tenancy_config: dict = field(default_factory=dict)

    def get_property(self, name: str) -> Optional[Property]:
        for p in self.properties:
            if p.name == name:
                return p
        return None

    def to_dict(self) -> dict:
        return {
            "class": self.name,
            "description": self.description,
            "properties": [p.to_dict() for p in self.properties],
            "vectorizer": self.vectorizer,
            "vectorIndexType": self.vector_index_type,
            "vectorIndexConfig": self.vector_index_config,
            "invertedIndexConfig": self.inverted_index_config,
            "shardingConfig": self.sharding_config,
            "replicationConfig": self.replication_config,
            "moduleConfig": self.module_config,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ClassDef":
        return cls(
            name=d.get("class") or d["name"],
            description=d.get("description", ""),
            properties=[Property.from_dict(p) for p in d.get("properties") or []],
            # empty = "not specified": the schema manager substitutes
            # DEFAULT_VECTORIZER_MODULE; an explicit "none" stays none
            vectorizer=d.get("vectorizer", ""),
            vector_index_type=d.get("vectorIndexType", "hnsw_tpu"),
            vector_index_config=d.get("vectorIndexConfig") or {},
            inverted_index_config=d.get("invertedIndexConfig") or {},
            sharding_config=d.get("shardingConfig") or {},
            replication_config=d.get("replicationConfig") or {},
            module_config=d.get("moduleConfig") or {},
        )


@dataclass
class Schema:
    """The full data schema (map class-name → ClassDef)."""

    classes: dict[str, ClassDef] = field(default_factory=dict)

    def get(self, name: str) -> Optional[ClassDef]:
        return self.classes.get(name)

    def to_dict(self) -> dict:
        return {"classes": [c.to_dict() for c in self.classes.values()]}

    @classmethod
    def from_dict(cls, d: dict) -> "Schema":
        s = cls()
        for c in d.get("classes") or []:
            cd = ClassDef.from_dict(c)
            s.classes[cd.name] = cd
        return s


def validate_class_name(name: str) -> str:
    if not _CLASS_NAME_RE.match(name or ""):
        raise SchemaError(
            f"{name!r} is not a valid class name: must be GraphQL-compatible "
            "(start with capital letter)"
        )
    return name


def validate_property_name(name: str) -> str:
    if not _PROP_NAME_RE.match(name or ""):
        raise SchemaError(f"{name!r} is not a valid property name")
    return name


def datatype_of_value(v: Any) -> DataType:
    """Infer the schema data type of a raw JSON value (auto-schema support,
    reference: usecases/objects/auto_schema.go)."""
    if isinstance(v, bool):
        return DataType.BOOLEAN
    if isinstance(v, int):
        return DataType.INT
    if isinstance(v, float):
        return DataType.NUMBER
    if isinstance(v, str):
        return DataType.TEXT
    if isinstance(v, dict):
        if set(v.keys()) >= {"latitude", "longitude"}:
            return DataType.GEO_COORDINATES
        if "input" in v and ("internationalFormatted" in v or "defaultCountry" in v):
            return DataType.PHONE_NUMBER
        return DataType.TEXT
    if isinstance(v, list):
        if not v:
            return DataType.TEXT_ARRAY
        inner = datatype_of_value(v[0])
        return DataType(inner.value + "[]")
    raise SchemaError(f"cannot infer data type of {type(v)}")
