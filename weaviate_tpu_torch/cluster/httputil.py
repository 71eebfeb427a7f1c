# The port's copy of weaviate_tpu/cluster/httputil.py, its imports pointed at the port.
"""Shared intra-cluster HTTP client plumbing.

One connection stack for every outbound cluster caller (remote index ops,
replication, schema 2PC, liveness probes): per-thread keep-alive connection
cache with bounded, jittered retries. Divergent hand-rolled http.client
code paths are how exception-handling bugs creep in — everything routes
through here.

Retry policy (replica fan-out hardening): `timeout` applies PER ATTEMPT
(connect + each socket op), so one attempt can never exceed it and the
total is bounded by attempts * timeout. A retry fires only when the
request plausibly never EXECUTED on the peer: a REUSED keep-alive socket
failed (the peer closed it between calls — the request died at send), the
connection was refused outright, or the method is idempotent (GET/HEAD).
A FRESH connection that fails mid-send/mid-read on a non-idempotent
method does NOT retry — the peer may already have applied the op, and
re-sending a 2PC prepare/commit or an object write would apply it twice.
The FIRST retry is immediate (the dominant cause is the stale cached
keep-alive socket, detected on first use); every later one backs off
exponentially WITH JITTER (0.5x..1.5x): after a node blip, N coordinators
that all fan out to the same replica must not retry in lockstep and
re-create the overload that caused the blip (thundering herd)."""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
from typing import Optional


class RemoteError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"remote error {status}: {message}")
        self.status = status


class Http:
    """Per-thread keep-alive connection cache with jittered retry."""

    def __init__(self, timeout: float = 30.0, attempts: int = 3,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0):
        self.timeout = timeout            # per ATTEMPT, not per call
        self.attempts = max(int(attempts), 1)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._local = threading.local()
        # per-instance rng: jitter must not be process-synchronized either
        # (a shared seeded rng would correlate the very retries it
        # decorrelates); tests monkeypatch _sleep for determinism
        self._rng = random.Random()

    def _sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def _backoff_s(self, attempt: int) -> float:
        """Jittered exponential delay BEFORE `attempt` (0-based). Attempt 1
        (the stale-socket retry) is immediate; attempt k >= 2 waits
        base * 2^(k-2), capped, scaled by uniform(0.5, 1.5)."""
        if attempt < 2:
            return 0.0
        delay = min(self.backoff_max_s,
                    self.backoff_base_s * (2 ** (attempt - 2)))
        return delay * (0.5 + self._rng.random())

    def _conn(self, host: str) -> tuple[http.client.HTTPConnection, bool]:
        """-> (connection, reused): `reused` marks a cached keep-alive
        socket — the one failure class where a send error reliably means
        the request never executed (the peer closed it between calls)."""
        cache = getattr(self._local, "conns", None)
        if cache is None:
            cache = self._local.conns = {}
        conn = cache.get(host)
        if conn is not None:
            return conn, True
        h, p = host.rsplit(":", 1)
        conn = http.client.HTTPConnection(h, int(p), timeout=self.timeout)
        cache[host] = conn
        return conn, False

    def request(
        self, host: str, method: str, path: str,
        body: Optional[bytes] = None, content_type: str = "application/json",
    ) -> tuple[int, bytes]:
        for attempt in range(self.attempts):
            delay = self._backoff_s(attempt)
            if delay > 0.0:
                self._sleep(delay)
            conn, reused = self._conn(host)
            try:
                conn.request(method, path, body=body,
                             headers={"Content-Type": content_type} if body else {})
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                getattr(self._local, "conns", {}).pop(host, None)
                # non-idempotent ops only retry when the request provably
                # never executed: stale keep-alive, or connect refused on
                # a fresh socket (nothing was ever sent)
                retriable = (reused or method in ("GET", "HEAD")
                             or isinstance(e, ConnectionRefusedError))
                if not retriable or attempt == self.attempts - 1:
                    raise
        raise AssertionError("unreachable")

    def json(self, host: str, method: str, path: str, payload=None) -> dict:
        body = json.dumps(payload).encode("utf-8") if payload is not None else None
        status, raw = self.request(host, method, path, body)
        try:
            data = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            data = {"error": raw.decode("utf-8", "replace")}
        if status >= 400 and status != 404:
            raise RemoteError(status, str(data.get("error", data)))
        data["_status"] = status
        return data
