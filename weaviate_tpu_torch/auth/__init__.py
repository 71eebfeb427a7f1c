# The port's copy of weaviate_tpu/auth/__init__.py, its imports pointed at the port.
from weaviate_tpu_torch.auth.auth import (
    AuthError,
    Authenticator,
    Authorizer,
    ForbiddenError,
    Principal,
    UnauthorizedError,
)

__all__ = [
    "AuthError",
    "Authenticator",
    "Authorizer",
    "ForbiddenError",
    "Principal",
    "UnauthorizedError",
]
