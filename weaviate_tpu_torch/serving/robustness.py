# The port's copy of weaviate_tpu/serving/robustness.py, its imports pointed at the port.
"""Request-lifecycle robustness: deadlines, overload shedding, breaker.

The serving stack before this module had three failure modes unbecoming of
a system meant to serve heavy traffic: a request admitted to the coalescer
had no deadline (a wedged flush thread could hang a client forever), a full
pipeline applied backpressure by silently stalling rather than shedding
(every queued client eventually timed out instead of a few failing fast
with a retry hint), and a device error mid-dispatch had no engineered
recovery beyond per-kernel fallbacks. This module supplies the three
primitives; the wiring lives where the requests flow:

  Deadline        REST ``X-Request-Timeout-Ms`` / gRPC deadline / config
                  ``QUERY_TIMEOUT_MS`` -> a monotonic expiry carried in a
                  ContextVar through usecases/traverser into
                  serving/coalescer lanes and db/shard dispatches. Expired
                  requests fail fast (``DeadlineExceededError`` -> 504 /
                  DEADLINE_EXCEEDED) instead of occupying a dispatch slot,
                  and every waiter wait on the serving path is bounded by
                  the remaining deadline.

  OverloadedError the shed signal (-> 429 / RESOURCE_EXHAUSTED with a
                  Retry-After hint). Raised by the coalescer's bounded
                  admission queue when the queue is full (cost-aware:
                  queued ROWS, not requests) or the estimated queue wait
                  already exceeds the request's remaining deadline.

  CircuitBreaker  trips OPEN after N consecutive device dispatch failures;
                  while open the shard serves reads from the index's host
                  fallback plane (``search_by_vectors_host``) instead of
                  queueing doomed device work; after a cooldown it
                  HALF-OPENs and lets a bounded number of probe dispatches
                  through — one success closes it, one failure re-opens.

  Tenant scope    WHO a request belongs to (multi-tenant fairness): a
                  ContextVar riding the same plumbing as the deadline.
                  Defaults to the queried class name when no explicit
                  identity arrives; REST ``X-Tenant-Id`` / gRPC
                  ``x-tenant-id`` metadata override it (validated against
                  header injection like ``X-Request-Id`` — an invalid
                  value is REJECTED, not cleaned, because a tenant id is
                  an accounting key, not an echo). The coalescer's
                  weighted-fair admission, the per-tenant shed/deadline
                  metrics, the allowList cache's share bound, and the
                  tenant tags on traces all read it through
                  ``effective_tenant``.

Like monitoring/tracing.py, the module state is process-wide globals with
one-comparison disabled fast paths: no deadline set => ``check_deadline``
is a ContextVar read and a None compare; breaker disabled => ``get_breaker``
returns None and the shard gate is one comparison. The module imports only
the stdlib, so every layer (db, index, usecases, server) can import it
without cycles.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import re
import threading
import time
from typing import Any, Iterator, Optional

_LOG = logging.getLogger(__name__)


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed — mapped to HTTP 504 / gRPC
    DEADLINE_EXCEEDED by the frontends. Fail-fast by design: the holder
    must NOT retry on the direct path (the budget is already spent)."""


class OverloadedError(RuntimeError):
    """The request was shed by admission control — mapped to HTTP 429 (+
    Retry-After) / gRPC RESOURCE_EXHAUSTED. ``retry_after_s`` is the
    server's drain estimate; clients should back off at least that long."""

    def __init__(self, message: str, retry_after_s: float = 0.1):
        super().__init__(message)
        self.retry_after_s = max(float(retry_after_s), 0.001)


class Deadline:
    """Monotonic expiry for one request. Immutable; cheap to test."""

    __slots__ = ("expires_at",)

    def __init__(self, timeout_s: float):
        self.expires_at = time.monotonic() + max(float(timeout_s), 0.0)

    def remaining_s(self) -> float:
        return self.expires_at - time.monotonic()

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at


# the active request's deadline (None = unbounded). Rides contextvars like
# the trace span, so it follows the request through the graphql executor,
# batch pool slots, and into coalescer admission on the serving thread.
_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "weaviate_deadline", default=None)


@contextlib.contextmanager
def deadline_scope(timeout_ms: float) -> Iterator[Optional[Deadline]]:
    """Install a deadline for the enclosed request. timeout_ms <= 0 is the
    unbounded no-op (yields None, touches nothing)."""
    if timeout_ms is None or timeout_ms <= 0:
        yield None
        return
    d = Deadline(timeout_ms / 1000.0)
    token = _DEADLINE.set(d)
    try:
        yield d
    finally:
        _DEADLINE.reset(token)


def current_deadline() -> Optional[Deadline]:
    return _DEADLINE.get()


def remaining_s() -> Optional[float]:
    """Seconds until the current deadline (clamped >= 0), or None when the
    request is unbounded."""
    d = _DEADLINE.get()
    if d is None:
        return None
    return max(d.remaining_s(), 0.0)


def check_deadline(where: str) -> None:
    """Raise (and count) if the current request's deadline already passed.
    The fail-fast gate at every stage boundary: an expired request must
    not occupy a dispatch slot, a gate permit, or a coalescer lane."""
    d = _DEADLINE.get()
    if d is None or not d.expired():
        return
    count_deadline(where)
    raise DeadlineExceededError(f"request deadline expired at {where}")


# -- tenant identity ----------------------------------------------------------

# the active request's tenant (None = not explicitly set; consumers fall
# back to the queried class name via effective_tenant). Rides contextvars
# exactly like the deadline: installed by the REST/gRPC frontends, copied
# into batch pool slots, read at coalescer admission and in the shard's
# allowList cache.
_TENANT: contextvars.ContextVar = contextvars.ContextVar(
    "weaviate_tenant", default=None)

# printable ASCII, no separators that could smuggle into a header or a
# metric label, bounded length. Deliberately stricter than the request-id
# cleaner: a tenant id keys ACCOUNTING (queues, budgets, metrics), so an
# invalid one is rejected with a 4xx instead of silently rewritten — two
# spellings of one tenant must never split its budget.
_TENANT_ID_RE = re.compile(r"^[\x21-\x7e]{1,64}$")


# identities the SYSTEM emits: "other" is the TenantLabeler's aggregate
# metric bucket, "multi" tags merged cross-tenant dispatches in traces. A
# client claiming either would hide its accounting inside the aggregate.
_RESERVED_TENANT_IDS = frozenset({"other", "multi"})


def validate_tenant_id(value: Optional[str]) -> Optional[str]:
    """Parse an inbound tenant header/metadata value. None/empty -> None
    (the class-name default applies). Invalid (injection bytes, blanks,
    over-long, a reserved system identity) -> ValueError — the frontends
    map it to 400 / INVALID_ARGUMENT; it is never cleaned-and-echoed."""
    if value is None:
        return None
    v = value.strip()
    if not v:
        return None
    if not _TENANT_ID_RE.match(v):
        raise ValueError(
            "invalid tenant id: printable ASCII without spaces, "
            "at most 64 chars")
    if v.lower() in _RESERVED_TENANT_IDS:
        raise ValueError(
            f"invalid tenant id: {v!r} is reserved (system aggregate "
            "bucket)")
    return v


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]) -> Iterator[Optional[str]]:
    """Install the request's explicit tenant identity. None is the no-op
    scope (consumers fall back to the class-name default)."""
    if not tenant:
        yield None
        return
    token = _TENANT.set(tenant)
    try:
        yield tenant
    finally:
        _TENANT.reset(token)


def current_tenant() -> Optional[str]:
    return _TENANT.get()


def effective_tenant(default: Optional[str] = None) -> Optional[str]:
    """The accounting identity for the current request: the explicitly
    installed tenant when one rode in on the request, else `default`
    (callers pass the queried class name — per-class isolation is the
    sane default when clients send no identity at all)."""
    t = _TENANT.get()
    if t is not None:
        return t
    return default


def count_tenant_shed(tenant: Optional[str], reason: str) -> None:
    """Per-tenant shed accounting, cardinality-bounded by the metrics
    registry's TenantLabeler (top-K by traffic + 'other')."""
    m = _metrics
    if m is not None and tenant:
        try:
            m.tenant_shed.labels(m.tenant_labels.observe(tenant),
                                 reason).inc()
        except Exception:  # noqa: BLE001 — metrics must not break serving
            pass


def count_tenant_deadline(tenant: Optional[str]) -> None:
    """Per-tenant deadline-expired accounting (same bounded labels)."""
    m = _metrics
    if m is not None and tenant:
        try:
            m.tenant_deadline.labels(m.tenant_labels.observe(tenant)).inc()
        except Exception:  # noqa: BLE001 — metrics must not break serving
            pass


class TenantConcurrencyGate:
    """Front-door bound on one tenant's CONCURRENT in-server requests.

    The admission queue bounds a tenant's rows, but the Python work a
    request costs BEFORE admission (transport, parse, traverse) is paid
    per concurrent request — a tenant opening hundreds of connections
    starves every other tenant's handler threads on the host CPU no
    matter how hard the queue sheds it. This gate is the cheapest
    possible refusal: one dict increment at the frontend, before any
    per-request work, shedding the excess with the same
    429/RESOURCE_EXHAUSTED + Retry-After contract as the queue. Applied
    to requests carrying an EXPLICIT tenant identity (anonymous traffic
    resolves its class-name tenant too deep for a front-door check).
    """

    # per-tenant shed counters kept at most this many distinct keys; a
    # storm of invented tenant ids overflows into the "other" bucket (the
    # TenantLabeler discipline, without the traffic-ranking machinery)
    _SHED_KEYS_MAX = 256

    def __init__(self, max_concurrent: int, metrics=None):
        self.max_concurrent = max(int(max_concurrent), 1)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._inflight_total = 0
        self._shed_total = 0
        self._shed: dict[str, int] = {}

    def enter(self, tenant: str) -> bool:
        with self._lock:
            c = self._counts.get(tenant, 0)
            if c >= self.max_concurrent:
                # refusal accounting lives ON the gate (coalescer.stats()
                # surfaces it; the caller still counts the per-tenant shed
                # vecs) — ROADMAP item-4 follow-up
                self._shed_total += 1
                key = (tenant if tenant in self._shed
                       or len(self._shed) < self._SHED_KEYS_MAX else "other")
                self._shed[key] = self._shed.get(key, 0) + 1
                self._gate_metrics(shed=True)
                return False
            self._counts[tenant] = c + 1
            self._inflight_total += 1
            total = self._inflight_total
        self._set_inflight_gauge(total)
        return True

    def leave(self, tenant: str) -> None:
        with self._lock:
            c = self._counts.get(tenant, 0) - 1
            if c <= 0:
                # drop zeros so a storm of invented tenant ids cannot
                # grow the dict without bound
                self._counts.pop(tenant, None)
            else:
                self._counts[tenant] = c
            self._inflight_total = max(self._inflight_total - 1, 0)
            total = self._inflight_total
        self._set_inflight_gauge(total)

    def _gate_metrics(self, shed: bool = False) -> None:
        m = self.metrics
        if m is not None and shed:
            try:
                m.tenant_gate_shed.inc()
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def _set_inflight_gauge(self, total: int) -> None:
        m = self.metrics
        if m is not None:
            try:
                m.tenant_gate_inflight.set(total)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def in_flight(self, tenant: str) -> int:
        with self._lock:
            return self._counts.get(tenant, 0)

    def stats(self) -> dict:
        """The gate's operator view (surfaced in coalescer.stats())."""
        with self._lock:
            return {
                "max_concurrent": self.max_concurrent,
                "in_flight_total": self._inflight_total,
                "tenants_in_flight": len(self._counts),
                "shed_total": self._shed_total,
                "shed": dict(self._shed),
            }


_tenant_gate: Optional[TenantConcurrencyGate] = None

# drain-rate Retry-After hints (PR-11 satellite): the coalescer registers
# its per-tenant drain-rate estimator here so FRONT-DOOR sheds (the
# concurrency gate below) hint with the tenant's measured queue-drain
# time instead of a fixed constant — a protocol-conformant abuser then
# backs off proportionally to how backed up it actually is.
_retry_hint_provider = None


def set_retry_hint_provider(fn) -> None:
    """Install the per-tenant drain estimator (fn(tenant) -> seconds or
    None). The coalescer owns it; None-clearing goes through
    clear_retry_hint_provider (still-ours discipline)."""
    global _retry_hint_provider
    _retry_hint_provider = fn


def clear_retry_hint_provider(fn) -> None:
    global _retry_hint_provider
    if _retry_hint_provider is fn:
        _retry_hint_provider = None


def drain_retry_hint(tenant: Optional[str], default: float) -> float:
    """Retry-After for `tenant` from the registered drain estimator,
    clamped to a sane band; `default` when no estimator (or no signal
    yet) — never raises (a broken estimator must not break a shed)."""
    fn = _retry_hint_provider
    if fn is None:
        return default
    try:
        h = fn(tenant)
    except Exception:  # noqa: BLE001 — a shed path must always produce a hint
        return default
    if h is None:
        return default
    return min(max(float(h), 0.05), 30.0)


def configure_tenant_gate(
        gate: Optional[TenantConcurrencyGate]
) -> Optional[TenantConcurrencyGate]:
    """Install (or clear, with None) the process-wide concurrency gate."""
    global _tenant_gate
    _tenant_gate = gate
    return gate


def unconfigure_tenant_gate(gate: TenantConcurrencyGate) -> None:
    global _tenant_gate
    if _tenant_gate is gate:
        _tenant_gate = None


def get_tenant_gate() -> Optional[TenantConcurrencyGate]:
    return _tenant_gate


@contextlib.contextmanager
def tenant_concurrency(tenant: Optional[str]) -> Iterator[None]:
    """Hold one slot of `tenant`'s concurrent-request budget for the
    enclosed request. No gate configured or no explicit tenant => no-op
    (one comparison). Over budget => OverloadedError, counted per tenant
    under reason ``concurrency`` — shed BEFORE any per-request work."""
    gate = _tenant_gate
    if gate is None or not tenant:
        yield
        return
    if not gate.enter(tenant):
        count_shed("tenant_concurrency")
        count_tenant_shed(tenant, "concurrency")
        # the hint is the tenant's MEASURED queue-drain estimate when the
        # coalescer has one (a slot frees when one of the tenant's own
        # in-flight requests finishes — its drain rate is the right
        # clock); the 1 s fallback stays deliberately generous for the
        # cold case, because fast retries from its other connections
        # would just burn frontend CPU on more refusals. The 0.25 s floor
        # covers the gate-specific blind spot: a tenant whose slots are
        # held by DIRECT-path requests puts no rows in the coalescer, so
        # an idle queue would hint the generic 0.05 s shed floor against
        # slots that free on a request-duration cadence
        raise OverloadedError(
            f"tenant {tenant!r} exceeds its concurrent-request budget "
            f"({gate.max_concurrent})",
            retry_after_s=max(drain_retry_hint(tenant, 1.0), 0.25))
    try:
        yield
    finally:
        gate.leave(tenant)


# -- circuit breaker ----------------------------------------------------------

STATE_CLOSED = 0
STATE_OPEN = 1
STATE_HALF_OPEN = 2

_STATE_NAMES = {STATE_CLOSED: "closed", STATE_OPEN: "open",
                STATE_HALF_OPEN: "half_open"}


class CircuitBreaker:
    """Device-dispatch circuit breaker (three-state, consecutive-failure
    trip). One instance guards the process's device: dispatch failures are
    a property of the accelerator, not of one shard. This scoping holds
    for the multi-chip mesh too — a mesh dispatch is ONE SPMD program
    spanning every chip, so any chip failing fails the whole program and
    the mesh is one failure domain, not eight (docs/mesh_serving.md);
    per-chip breakers would just trip in lockstep.

    CLOSED     normal serving; ``allow()`` is lock-free. N consecutive
               device errors (``record_failure``) trip to OPEN.
    OPEN       ``allow()`` returns False — callers serve from the host
               fallback plane instead of dispatching doomed device work.
               After ``reset_timeout_s`` the next ``allow()`` moves to
               HALF_OPEN.
    HALF_OPEN  up to ``half_open_probes`` callers get True (probe
               dispatches); the first probe success closes the breaker,
               the first failure re-opens it for another cooldown.
    """

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 2.0, half_open_probes: int = 1,
                 metrics=None, name: str = "device"):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.reset_timeout_s = max(float(reset_timeout_s), 0.0)
        self.half_open_probes = max(int(half_open_probes), 1)
        self.metrics = metrics
        self.name = name
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive = 0
        self._open_until = 0.0
        self._probes_out = 0
        self._half_open_since = 0.0
        self._publish_state()

    # -- gate ---------------------------------------------------------------

    def allow(self) -> bool:
        """May this dispatch go to the device? False => host fallback. The
        CLOSED read is deliberately lockless (a stale read during a
        transition admits/rejects one extra dispatch, which the next
        record_* call corrects)."""
        if self._state == STATE_CLOSED:
            return True
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            now = time.monotonic()
            if self._state == STATE_OPEN:
                if now < self._open_until:
                    return False
                self._transition(STATE_HALF_OPEN)
                self._probes_out = 0
                self._half_open_since = now
            # HALF_OPEN: bounded probe admission. Probe slots EXPIRE: a
            # probe whose dispatch died without reaching record_success/
            # record_failure (a non-device exception, an abandoned lane)
            # must not wedge the breaker in HALF_OPEN forever — after one
            # cooldown with no verdict, the slots recycle
            if self._probes_out >= self.half_open_probes \
                    and now - self._half_open_since > self.reset_timeout_s:
                self._probes_out = 0
                self._half_open_since = now
            if self._probes_out < self.half_open_probes:
                self._probes_out += 1
                return True
            return False

    def record_success(self) -> bool:
        """-> True when this success RECOVERED the breaker (a transition
        back to CLOSED) — callers use it to release degraded-mode
        resources (e.g. the index's host fallback copy) exactly once."""
        # hot-path fast exit: a healthy breaker pays one attr compare
        if self._state == STATE_CLOSED and self._consecutive == 0:
            return False
        with self._lock:
            self._consecutive = 0
            if self._state != STATE_CLOSED:
                self._transition(STATE_CLOSED)
                return True
        return False

    def record_failure(self, err: Optional[BaseException] = None) -> None:
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                # the probe failed: straight back to OPEN for a cooldown
                self._reopen(err)
                return
            self._consecutive += 1
            if self._state == STATE_CLOSED \
                    and self._consecutive >= self.failure_threshold:
                self._reopen(err)

    def _reopen(self, err: Optional[BaseException]) -> None:
        self._open_until = time.monotonic() + self.reset_timeout_s
        self._transition(STATE_OPEN, err)

    def state(self) -> int:
        return self._state

    # -- observability -------------------------------------------------------

    def _transition(self, state: int, err: Optional[BaseException] = None) -> None:
        """Caller holds the lock (or is __init__). Gauge + counter + one log
        line per transition — transitions are rare by construction."""
        prev, self._state = self._state, state
        if state != prev:
            detail = f" ({type(err).__name__}: {err})" if err is not None else ""
            _LOG.warning(
                "%s circuit breaker %s -> %s after %d consecutive "
                "failure(s)%s", self.name, _STATE_NAMES[prev],
                _STATE_NAMES[state], self._consecutive, detail)
        self._publish_state()
        m = self.metrics
        if m is not None and state != prev:
            try:
                m.breaker_transitions.labels(_STATE_NAMES[state]).inc()
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass
        if state != prev:
            # ops-event journal + flight recorder (monitoring/incidents.py):
            # a transition is exactly the fire-once semantics the journal
            # wants, and OPEN is THE canonical incident trigger. Lazy
            # import keeps this module stdlib-only at import time; both
            # entries are one-comparison no-ops when the plane is off and
            # exception-guarded internally. The journal/recorder locks
            # never take the breaker lock, so emitting under it is safe.
            try:
                from weaviate_tpu_torch.monitoring import incidents

                cause = f"{type(err).__name__}: {err}" if err is not None \
                    else ""
                if state == STATE_OPEN:
                    incidents.emit("breaker_open", scope=self.name,
                                   consecutive=self._consecutive,
                                   error=cause)
                    incidents.trigger(
                        "breaker_open",
                        reason=f"{self.name} breaker tripped OPEN after "
                               f"{self._consecutive} consecutive device "
                               "failure(s)",
                        detail={"error": cause})
                elif state == STATE_HALF_OPEN:
                    incidents.emit("breaker_half_open", scope=self.name)
                else:
                    incidents.emit("breaker_closed", scope=self.name)
            except Exception:  # noqa: BLE001 — observability must not break serving
                pass

    def _publish_state(self) -> None:
        m = self.metrics
        if m is not None:
            try:
                m.breaker_state.set(self._state)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass


# torch's device-failure types, by (module, class name) so this module stays
# stdlib-only: a CUDA allocation failure (torch.OutOfMemoryError, the same
# class as torch.cuda.OutOfMemoryError) and, where the installed torch has
# it, the runtime's own accelerator fault (torch.AcceleratorError)
_DEVICE_ERROR_TYPES = (("torch", "OutOfMemoryError"), ("torch", "AcceleratorError"))
# what torch's CUDA runtime and driver checks put at the start of the
# message of the plain RuntimeError they raise
_CUDA_MESSAGE_PREFIXES = ("CUDA error", "CUDA driver error")


def is_device_error(exc: BaseException) -> bool:
    """Does this exception mean the DEVICE dispatch failed (vs. a logic
    error in the request)? Only device errors feed the breaker — tripping
    on a caller's ValueError would take a healthy accelerator out of
    service. Recognized: anything carrying a truthy ``device_error``
    attribute (the port's ``ops._kernels.KernelLaunchError``, raised when
    a hand-written kernel's C entry point returns a code of a card fault,
    and the fault harness's injected errors), torch's CUDA out-of-memory
    and accelerator errors (by module and class name, subclasses
    included), and a RuntimeError whose message starts the way torch's
    CUDA runtime and driver checks start theirs. Deliberately NOT any
    other RuntimeError: a shape mismatch, a failed ``nvcc`` build or a
    launch the kernel refuses (``ops._kernels.KernelCallError``: an
    invalid value or configuration) is a deterministic programming or
    deployment fault — tripping on one
    would mask it behind 'device incident' metrics while the host plane
    quietly serves around it."""
    if getattr(exc, "device_error", False):
        return True
    for t in type(exc).__mro__:
        if ((getattr(t, "__module__", "") or "").split(".")[0], t.__name__) \
                in _DEVICE_ERROR_TYPES:
            return True
    return isinstance(exc, RuntimeError) and str(exc).startswith(
        _CUDA_MESSAGE_PREFIXES)


# -- module state + accessors (the tracing.py pattern) ------------------------

_breaker: Optional[CircuitBreaker] = None
_metrics: Optional[Any] = None


def configure_breaker(breaker: Optional[CircuitBreaker]) -> Optional[CircuitBreaker]:
    """Install (or clear, with None) the process-wide device breaker."""
    global _breaker
    _breaker = breaker
    return breaker


def unconfigure_breaker(breaker: CircuitBreaker) -> None:
    """Clear the global only if still `breaker` (an App shutdown must not
    tear down a newer App's breaker)."""
    global _breaker
    if _breaker is breaker:
        _breaker = None


def get_breaker() -> Optional[CircuitBreaker]:
    return _breaker


def set_metrics(metrics) -> None:
    """Metrics registry for the shed/deadline counters (None to clear)."""
    global _metrics
    _metrics = metrics


def unset_metrics(metrics) -> None:
    global _metrics
    if _metrics is metrics:
        _metrics = None


def count_shed(reason: str) -> None:
    m = _metrics
    if m is not None:
        try:
            m.requests_shed.labels(reason).inc()
        except Exception:  # noqa: BLE001 — metrics must not break serving
            pass
    # journal the shed (monitoring/incidents.py): this is the one
    # chokepoint every shed reason funnels through (queue_full /
    # deadline_unreachable / tenant_budget / tenant_concurrency), so the
    # journal sees every burst; the burst-coalescing ring folds a storm
    # into one counted entry per reason. Lazy import keeps this module
    # stdlib-only at import time; emit() is a one-comparison no-op when
    # the plane is off and exception-guarded internally.
    try:
        from weaviate_tpu_torch.monitoring import incidents

        incidents.emit("shed_burst", scope=reason)
    except Exception:  # noqa: BLE001 — observability must not break serving
        pass


def count_deadline(where: str) -> None:
    m = _metrics
    if m is not None:
        try:
            m.deadline_expired.labels(where).inc()
        except Exception:  # noqa: BLE001 — metrics must not break serving
            pass
    # deadline-miss chokepoint, same contract as the shed journal above
    try:
        from weaviate_tpu_torch.monitoring import incidents

        incidents.emit("deadline_burst", scope=where)
    except Exception:  # noqa: BLE001 — observability must not break serving
        pass
