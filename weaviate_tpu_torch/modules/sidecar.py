# The port's copy of weaviate_tpu/modules/sidecar.py, its imports pointed at the port.
"""Shared HTTP plumbing for module sidecars and SaaS inference APIs.

Reference: every non-contextionary module is an HTTP client onto either a
sidecar container (text2vec-transformers, qna-transformers, ...) or a SaaS
API (text2vec-openai, generative-openai, ...) — modules/*/clients/. One
JSON-POST helper with keep-alive serves them all here.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional


class SidecarError(ValueError):
    pass


def http_json(
    url: str,
    payload: Optional[dict] = None,
    headers: Optional[dict] = None,
    method: str = "POST",
    timeout: float = 30.0,
) -> dict:
    data = json.dumps(payload).encode("utf-8") if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
    except urllib.error.HTTPError as e:
        body = e.read().decode("utf-8", "replace")[:500]
        raise SidecarError(f"{url}: HTTP {e.code}: {body}") from None
    except OSError as e:
        raise SidecarError(f"{url}: {e}") from e
    try:
        return json.loads(raw) if raw else {}
    except json.JSONDecodeError as e:
        raise SidecarError(f"{url}: invalid JSON response: {e}") from None
