# The port's copy of weaviate_tpu/schema/__init__.py, its imports pointed at the port.
"""Schema subsystem: manager, validation, auto-schema, persistence.

Reference: usecases/schema (manager, 2-phase cluster transactions),
adapters/repos/schema (BoltDB persistence), usecases/objects/auto_schema.go.
"""

from weaviate_tpu_torch.schema.manager import SchemaManager, SchemaValidationError
from weaviate_tpu_torch.schema.auto import AutoSchema

__all__ = ["SchemaManager", "SchemaValidationError", "AutoSchema"]
