# The port's copy of weaviate_tpu/schema/auto.py, its imports pointed at the port.
"""Auto-schema: infer classes and properties from object payloads.

Reference: usecases/objects/auto_schema.go — when AUTOSCHEMA_ENABLED (default
true), an import referencing a missing class creates it, and missing
properties are added with inferred data types (defaults configurable:
AUTOSCHEMA_DEFAULT_STRING=text, _NUMBER=number, _DATE=date).
"""

from __future__ import annotations

import datetime
from typing import Any, Optional

from weaviate_tpu_torch.entities.schema import ClassDef, Property, SchemaError, datatype_of_value


def _looks_like_date(v: str) -> bool:
    try:
        datetime.datetime.fromisoformat(v.replace("Z", "+00:00"))
        return True
    except (ValueError, TypeError):
        return False


class AutoSchema:
    def __init__(
        self,
        manager,
        enabled: bool = True,
        default_string: str = "text",
        default_number: str = "number",
        default_date: str = "date",
    ):
        self.manager = manager
        self.enabled = enabled
        self.default_string = default_string
        self.default_number = default_number
        self.default_date = default_date

    def infer_type(self, value: Any) -> Optional[str]:
        """Delegates to entities.schema.datatype_of_value; layers the
        configurable defaults (string->text|date, number) on top."""
        if isinstance(value, str):
            return self.default_date if _looks_like_date(value) else self.default_string
        if isinstance(value, float):
            return self.default_number
        if isinstance(value, list) and value:
            if isinstance(value[0], str):
                inner = self.infer_type(value[0])
                return f"{inner}[]"
            if isinstance(value[0], dict):
                return "object"  # list of nested objects: not auto-indexable
        if isinstance(value, dict) and not (
            {"latitude", "longitude"} <= set(value)
            or ("input" in value or "internationalFormatted" in value)
        ):
            return "object"  # plain nested object: not auto-indexable
        if isinstance(value, dict) and ("input" in value or "internationalFormatted" in value):
            return "phoneNumber"
        try:
            return datatype_of_value(value).value
        except SchemaError:
            return None

    def ensure(self, class_name: str, properties: dict) -> str:
        """Create the class and/or add missing properties as needed.
        -> resolved class name. Raises if auto-schema disabled and missing."""
        resolved = self.manager.resolve_class_name(class_name)
        if resolved is None:
            if not self.enabled:
                from weaviate_tpu_torch.schema.manager import SchemaValidationError

                raise SchemaValidationError(f"class {class_name!r} not found")
            cd = ClassDef(name=class_name[:1].upper() + class_name[1:], properties=[])
            self.manager.add_class(cd)
            resolved = cd.name
        if not self.enabled or not properties:
            return resolved
        cd = self.manager.get_class(resolved)
        for key, value in properties.items():
            if cd.get_property(key) is not None or value is None:
                continue
            dt = self.infer_type(value)
            if dt is None or dt == "object":
                continue
            self.manager.add_property(resolved, Property(name=key, data_type=[dt]))
        return resolved
