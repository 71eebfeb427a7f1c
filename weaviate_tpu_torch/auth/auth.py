# The port's copy of weaviate_tpu/auth/auth.py, its imports pointed at the port.
"""Authentication (anonymous / API key / OIDC) and admin-list authorization.

Reference: usecases/auth/ — the authentication composer picks the first
scheme that applies to a request (authentication/composer), API keys map
positionally onto AUTHENTICATION_APIKEY_USERS, and authorization is the
adminlist model: admins may do everything, readonly users only get/list,
anonymous counts as the pseudo-user "anonymous" when enabled.

OIDC here validates structure only (issuer/client-id config is accepted and
bearer tokens are parsed for the username claim) — signature verification
needs the issuer's JWKS, an external fetch, so it is pluggable via
`Authenticator.oidc_validator`.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from typing import Callable, Optional

from weaviate_tpu_torch.config.config import AuthConfig, AuthzConfig


class AuthError(Exception):
    pass


class UnauthorizedError(AuthError):
    """401: no/invalid credentials."""


class ForbiddenError(AuthError):
    """403: authenticated but not allowed."""


@dataclass
class Principal:
    username: str
    groups: list[str] = field(default_factory=list)
    anonymous: bool = False


ANONYMOUS = Principal(username="anonymous", anonymous=True)

READ_VERBS = frozenset({"get", "list"})


class Authenticator:
    """Scheme composer (usecases/auth/authentication)."""

    def __init__(self, cfg: AuthConfig,
                 oidc_validator: Optional[Callable[[str], Principal]] = None):
        self.cfg = cfg
        self.oidc_validator = oidc_validator
        # positional key->user mapping (environment.go: one user for all keys
        # or one user per key)
        self._key_to_user: dict[str, str] = {}
        if cfg.apikey.enabled:
            users = cfg.apikey.users
            for i, key in enumerate(cfg.apikey.allowed_keys):
                self._key_to_user[key] = users[0] if len(users) == 1 else users[i]

    def principal_from_bearer(self, token: Optional[str]) -> Principal:
        """Resolve an Authorization: Bearer token (or None) to a Principal."""
        if token:
            if self.cfg.apikey.enabled and token in self._key_to_user:
                return Principal(username=self._key_to_user[token])
            if self.cfg.oidc.enabled:
                if self.oidc_validator is None:
                    # fail closed: accepting unverified JWTs would let any
                    # forged token impersonate any user
                    raise UnauthorizedError(
                        "OIDC is enabled but no token validator is configured")
                return self.oidc_validator(token)
            raise UnauthorizedError("invalid token")
        if self.cfg.anonymous.enabled:
            return ANONYMOUS
        raise UnauthorizedError("anonymous access not enabled, credentials required")

    def unverified_claims_validator(self) -> Callable[[str], Principal]:
        """A validator that trusts JWT claims WITHOUT signature verification.
        Only for tests/dev behind an authenticating proxy — production must
        wire a JWKS-backed validator instead."""

        def validate(token: str) -> Principal:
            p = self._parse_jwt_unverified(token)
            if p is None:
                raise UnauthorizedError("malformed bearer token")
            return p

        return validate

    def _parse_jwt_unverified(self, token: str) -> Optional[Principal]:
        parts = token.split(".")
        if len(parts) != 3:
            return None
        try:
            pad = "=" * (-len(parts[1]) % 4)
            claims = json.loads(base64.urlsafe_b64decode(parts[1] + pad))
        except Exception:
            return None
        username = claims.get(self.cfg.oidc.username_claim or "sub")
        if not username:
            return None
        groups = claims.get(self.cfg.oidc.groups_claim) if self.cfg.oidc.groups_claim else []
        return Principal(username=str(username), groups=list(groups or []))


class Authorizer:
    """Admin-list authorization (usecases/auth/authorization/adminlist)."""

    def __init__(self, cfg: AuthzConfig):
        self.cfg = cfg

    def authorize(self, principal: Principal, verb: str, resource: str) -> None:
        """Raise ForbiddenError unless `principal` may `verb` on `resource`.
        With the admin list disabled everything is allowed (reference
        default)."""
        if not self.cfg.admin_list_enabled:
            return
        name = principal.username
        if name in self.cfg.admin_users:
            return
        if verb in READ_VERBS and name in self.cfg.readonly_users:
            return
        raise ForbiddenError(
            f"user {name!r} may not {verb} {resource!r} (adminlist)")
