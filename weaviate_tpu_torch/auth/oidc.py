# The port's copy of weaviate_tpu/auth/oidc.py, its imports pointed at the port.
"""OIDC token validation backed by the issuer's JWKS.

Reference: usecases/auth/authentication/oidc/ — fetch the issuer's
discovery document, pull the JWKS, verify RS256 bearer tokens (signature,
issuer, audience, expiry), and map the configured claims onto a Principal.
Plugs into the existing `Authenticator.oidc_validator` seam.

Signature verification is RSASSA-PKCS1-v1_5/SHA-256 implemented directly on
big-int modular exponentiation — no third-party JWT/crypto dependency on the
serving path (the test suite uses `cryptography` only to mint keys and sign
tokens against a fake issuer).

Key handling: keys are cached by kid; an unknown kid triggers one JWKS
refetch (rotation) with a cooldown so a flood of forged kids cannot hammer
the issuer.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.request
from typing import Callable, Optional

from weaviate_tpu_torch.auth.auth import Principal, UnauthorizedError

# DER DigestInfo prefix for SHA-256 (RFC 8017, EMSA-PKCS1-v1_5)
_SHA256_PREFIX = bytes.fromhex("3031300d060960864801650304020105000420")
_REFRESH_COOLDOWN = 30.0  # seconds between JWKS refetches


def _b64url(data: str) -> bytes:
    return base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))


def _b64url_uint(data: str) -> int:
    return int.from_bytes(_b64url(data), "big")


def _rsa_pkcs1v15_sha256_verify(n: int, e: int, message: bytes, sig: bytes) -> bool:
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    digest = hashlib.sha256(message).digest()
    pad_len = k - 3 - len(_SHA256_PREFIX) - len(digest)
    if pad_len < 8:
        return False
    expected = b"\x00\x01" + b"\xff" * pad_len + b"\x00" + _SHA256_PREFIX + digest
    return hmac.compare_digest(em, expected)


class OIDCValidator:
    """Callable[[token], Principal] for Authenticator.oidc_validator."""

    def __init__(self, oidc_cfg, http_get: Optional[Callable[[str], bytes]] = None,
                 timeout: float = 10.0, leeway: float = 30.0):
        self.cfg = oidc_cfg
        self.timeout = timeout
        self.leeway = leeway
        self._http_get = http_get or self._default_get
        self._keys: dict[str, tuple[int, int]] = {}  # kid -> (n, e)
        self._last_fetch = 0.0
        self._lock = threading.Lock()

    def _default_get(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return resp.read()

    # -- JWKS ----------------------------------------------------------------

    def _load_keys(self) -> None:
        issuer = (self.cfg.issuer or "").rstrip("/")
        if not issuer:
            raise UnauthorizedError("OIDC issuer not configured")
        discovery = json.loads(
            self._http_get(f"{issuer}/.well-known/openid-configuration")
        )
        jwks_uri = discovery.get("jwks_uri")
        if not jwks_uri:
            raise UnauthorizedError("OIDC discovery document has no jwks_uri")
        jwks = json.loads(self._http_get(jwks_uri))
        keys: dict[str, tuple[int, int]] = {}
        for k in jwks.get("keys", []):
            if k.get("kty") != "RSA" or not k.get("n") or not k.get("e"):
                continue
            keys[k.get("kid", "")] = (_b64url_uint(k["n"]), _b64url_uint(k["e"]))
        if not keys:
            raise UnauthorizedError("issuer JWKS contains no usable RSA keys")
        self._keys = keys
        self._last_fetch = time.monotonic()

    def _key_for(self, kid: str) -> Optional[tuple[int, int]]:
        with self._lock:
            if not self._keys:
                self._load_keys()
            key = self._keys.get(kid)
            if key is None and kid not in self._keys:
                # possible rotation: refetch, rate-limited
                if time.monotonic() - self._last_fetch > _REFRESH_COOLDOWN:
                    self._load_keys()
                    key = self._keys.get(kid)
            return key

    # -- validation ----------------------------------------------------------

    def __call__(self, token: str) -> Principal:
        parts = token.split(".")
        if len(parts) != 3:
            raise UnauthorizedError("malformed bearer token")
        try:
            header = json.loads(_b64url(parts[0]))
            claims = json.loads(_b64url(parts[1]))
            sig = _b64url(parts[2])
        except (ValueError, json.JSONDecodeError):
            raise UnauthorizedError("malformed bearer token") from None

        if header.get("alg") != "RS256":
            raise UnauthorizedError(
                f"unsupported token alg {header.get('alg')!r} (RS256 only)"
            )
        try:
            key = self._key_for(header.get("kid", ""))
        except OSError as e:
            raise UnauthorizedError(f"cannot reach OIDC issuer: {e}") from e
        if key is None:
            raise UnauthorizedError("token signed with unknown key")
        signed = f"{parts[0]}.{parts[1]}".encode("ascii")
        if not _rsa_pkcs1v15_sha256_verify(key[0], key[1], signed, sig):
            raise UnauthorizedError("token signature verification failed")

        now = time.time()
        exp = claims.get("exp")
        if exp is not None and now > float(exp) + self.leeway:
            raise UnauthorizedError("token expired")
        nbf = claims.get("nbf")
        if nbf is not None and now < float(nbf) - self.leeway:
            raise UnauthorizedError("token not yet valid")
        issuer = (self.cfg.issuer or "").rstrip("/")
        if claims.get("iss", "").rstrip("/") != issuer:
            raise UnauthorizedError("token issuer mismatch")
        client_id = getattr(self.cfg, "client_id", "")
        if client_id and not getattr(self.cfg, "skip_client_id_check", False):
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if client_id not in auds:
                raise UnauthorizedError("token audience mismatch")

        username = claims.get(self.cfg.username_claim or "sub")
        if not username:
            raise UnauthorizedError(
                f"token missing username claim {self.cfg.username_claim or 'sub'!r}"
            )
        groups = []
        if self.cfg.groups_claim:
            groups = list(claims.get(self.cfg.groups_claim) or [])
        return Principal(username=str(username), groups=groups)
