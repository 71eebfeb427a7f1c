# The port's copy of weaviate_tpu/entities/filters.py, its imports pointed at the port.
"""Where-filter clause tree and operators.

Reference: entities/filters/filters.go:24-35 (operators), filters.go (LocalFilter,
Clause, Path, Value), inverted/like_regexp.go (Like wildcards).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Optional


class Operator(str, Enum):
    AND = "And"
    OR = "Or"
    NOT = "Not"
    EQUAL = "Equal"
    NOT_EQUAL = "NotEqual"
    GREATER_THAN = "GreaterThan"
    GREATER_THAN_EQUAL = "GreaterThanEqual"
    LESS_THAN = "LessThan"
    LESS_THAN_EQUAL = "LessThanEqual"
    LIKE = "Like"
    WITHIN_GEO_RANGE = "WithinGeoRange"
    IS_NULL = "IsNull"
    CONTAINS_ANY = "ContainsAny"
    CONTAINS_ALL = "ContainsAll"

    @property
    def on_value(self) -> bool:
        return self not in (Operator.AND, Operator.OR, Operator.NOT)


# GraphQL value-type keys → python coercion (reference: common_filters parser)
VALUE_KEYS = {
    "valueText": str,
    "valueString": str,
    "valueInt": int,
    "valueNumber": float,
    "valueBoolean": bool,
    "valueDate": str,
    "valueGeoRange": dict,
}


@dataclass
class GeoRange:
    latitude: float
    longitude: float
    distance_max: float  # meters

    @classmethod
    def from_dict(cls, d: dict) -> "GeoRange":
        geo = d.get("geoCoordinates") or d
        return cls(
            latitude=float(geo["latitude"]),
            longitude=float(geo["longitude"]),
            distance_max=float((d.get("distance") or {}).get("max", 0.0)),
        )


@dataclass
class Clause:
    """One node of the where-filter tree."""

    operator: Operator
    on: list[str] = field(default_factory=list)  # property path; refs: [RefProp, Class, prop...]
    value: Any = None
    value_type: Optional[str] = None  # the value* key used
    operands: list["Clause"] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Clause":
        op = Operator(d["operator"])
        operands = [cls.from_dict(o) for o in d.get("operands") or []]
        value = None
        vt = None
        for k in VALUE_KEYS:
            if k in d and d[k] is not None:
                vt = k
                value = d[k]
                if k == "valueGeoRange":
                    value = GeoRange.from_dict(d[k])
                break
        path = [str(p) for p in (d.get("path") or [])]
        if op.on_value and not operands:
            if op is not Operator.IS_NULL and value is None and op is not Operator.WITHIN_GEO_RANGE:
                raise FilterValidationError(f"operator {op.value} requires a value")
            if not path:
                raise FilterValidationError(f"operator {op.value} requires a path")
        return cls(operator=op, on=path, value=value, value_type=vt, operands=operands)

    def to_dict(self) -> dict:
        d: dict = {"operator": self.operator.value}
        if self.on:
            d["path"] = self.on
        if self.operands:
            d["operands"] = [o.to_dict() for o in self.operands]
        if self.value_type:
            if isinstance(self.value, GeoRange):
                d[self.value_type] = {
                    "geoCoordinates": {
                        "latitude": self.value.latitude,
                        "longitude": self.value.longitude,
                    },
                    "distance": {"max": self.value.distance_max},
                }
            else:
                d[self.value_type] = self.value
        return d


class FilterValidationError(ValueError):
    pass


@dataclass
class LocalFilter:
    """Root of a where filter (reference: entities/filters.LocalFilter)."""

    root: Clause

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["LocalFilter"]:
        if not d:
            return None
        return cls(root=Clause.from_dict(d))

    def to_dict(self) -> dict:
        return self.root.to_dict()


def like_to_regex(pattern: str) -> str:
    """Translate Like wildcards to a regex (reference: inverted/like_regexp.go):
    `?` → exactly one character, `*` → zero or more characters."""
    out = []
    for ch in pattern:
        if ch == "?":
            out.append(".")
        elif ch == "*":
            out.append(".*")
        else:
            out.append("\\" + ch if ch in ".^$+{}[]|()\\" else ch)
    return "^" + "".join(out) + "$"
