# The port's copy of weaviate_tpu/monitoring/tracing.py, its imports pointed at the port.
"""Request tracing with device-time attribution across the coalesced path.

The existing observability surface — the per-phase histograms of
shard_read.go parity (filter / device_search / hydrate) and the pprof
mount — aggregates across requests. The cross-request query coalescer
(serving/coalescer.py) broke the implicit 1:1 mapping between a request and
its device work: ~21 requests share one padded dispatch, so no histogram
can answer "where did THIS slow query spend its time" or "how much
padding / queue wait did tenant X pay". This module restores per-request
answers with a low-overhead span tracer:

  - handlers (REST / GraphQL / gRPC) accept and emit W3C ``traceparent``
    (``X-Request-Id`` fallback) and open a sampled request trace;
  - the active span travels in a ``contextvars.ContextVar`` through
    usecases/traverser.py into serving/coalescer.py lanes, and across the
    coalescer's flush-thread / dispatch-pool handoffs as explicit captures
    (a ``_Waiter`` carries its submitter's span; the dispatch record rides
    a second ContextVar set around the shard call);
  - each shard dispatch (db/shard.py, index/gpu.py) records device-phase
    timings (filter, device_search, rescore, hydrate — rescore is fused
    into device_search on this implementation: upload+scan+rescore+topk
    are one XLA program) plus dispatch facts: padded-vs-actual rows, the
    first-sighting-of-this-jit-shape bit, lane queue wait, occupancy.

Fan-in/fan-out attribution — the key design problem — happens in
``DispatchRecord.finish()``: ONE coalesced dispatch splits its device time
back across every rider request's trace proportionally by rows
(``share = rows_i / actual_rows``), so the riders' attributed device times
sum exactly to the dispatch's device span (padding overhead is reported
separately as ``padding_waste``, never smeared into shares). Attribution
creates already-closed spans atomically, and every open span closes in a
``finally`` (handler roots) — bypass, error, and shutdown paths annotate
the rider traces instead of leaking spans.

Exposure (all bounded):
  - a fixed-size ring buffer of completed traces, served as JSON at
    ``GET /debug/traces`` behind the same authorizer as pprof;
  - a structured slow-query log: one JSON line (full span tree) on the
    ``weaviate_tpu_torch.slowquery`` logger when a trace exceeds
    ``SLOW_QUERY_THRESHOLD_MS``;
  - exemplar counters in the existing ``Metrics`` registry
    (``weaviate_traces_total``, ``weaviate_trace_phase_ms``,
    ``weaviate_trace_dispatch_rows_total``), observation exception-guarded
    like every other serving-path metric.

Disabled (``TRACING_ENABLED`` unset) the module global ``_tracer`` is
``None`` and every entry point returns after that one comparison: no span
objects, no ContextVar writes, no locks — the serving hot path makes zero
tracing calls (pinned by a spy test in tests/test_tracing.py). Enabled,
the cost is O(spans) per sampled request with no locks on the dispatch
hot path (phase recording appends to a plain list owned by one thread;
the only locks are per-trace child-append and the ring append at finish).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import random
import re
import threading
import time
import uuid
from collections import deque
from typing import Any, Iterator, Optional

from weaviate_tpu_torch.monitoring import costmodel

_SLOW_LOG = logging.getLogger("weaviate_tpu_torch.slowquery")

# one traceparent shape only: version 00, 32-hex trace id, 16-hex parent id
_TRACEPARENT_RE = re.compile(
    r"^\s*00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})\s*$")

# monotonically increasing dispatch ids: lets a reader of /debug/traces (or
# the attribution-identity test) regroup rider spans of one device dispatch
_dispatch_seq = itertools.count(1)


def parse_traceparent(value: Optional[str]) -> Optional[tuple[str, str, str]]:
    """W3C traceparent -> (trace_id, parent_span_id, flags), or None."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value)
    if m is None:
        return None
    if m.group(1) == "0" * 32 or m.group(2) == "0" * 16:
        return None  # the spec's invalid all-zero ids
    return m.group(1), m.group(2), m.group(3)


def gen_request_id() -> str:
    """Request id for responses — independent of tracing enablement (the
    X-Request-Id contract holds even with the tracer off)."""
    return uuid.uuid4().hex


_RID_BAD = re.compile(r"[^\x21-\x7e]")


def clean_request_id(value: Optional[str]) -> str:
    """Inbound request id made safe to ECHO into a response header /
    trailing metadata: printable ASCII only (a CR/LF smuggled through an
    obs-folded header must not become header injection), bounded length;
    empty after cleaning => a generated id."""
    rid = _RID_BAD.sub("", (value or "").strip())[:128]
    return rid or gen_request_id()


class Span:
    """One timed node in a request's trace tree. Children may be appended
    from other threads (coalesced-dispatch attribution), so the append goes
    through the owning trace's lock; everything else is single-writer."""

    __slots__ = ("name", "trace", "attrs", "children", "duration_ms", "_t0")

    def __init__(self, name: str, trace: "Trace",
                 attrs: Optional[dict] = None,
                 duration_ms: Optional[float] = None):
        self.name = name
        self.trace = trace
        self.attrs: dict[str, Any] = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        self.duration_ms = duration_ms
        self._t0 = time.perf_counter() if duration_ms is None else None

    def end(self) -> None:
        if self.duration_ms is None and self._t0 is not None:
            self.duration_ms = (time.perf_counter() - self._t0) * 1000.0

    def child_start(self, name: str, attrs: Optional[dict] = None) -> "Span":
        """Open a child span (the caller owns closing it — prefer the
        ``span()`` context manager, which can't leak)."""
        c = Span(name, self.trace, attrs)
        with self.trace.lock:
            self.children.append(c)
        return c

    def child_done(self, name: str, duration_ms: float,
                   attrs: Optional[dict] = None) -> "Span":
        """Attach an already-closed child (post-hoc attribution): created
        and finished atomically, so attribution can never leak an open
        span on an error path."""
        c = Span(name, self.trace, attrs, duration_ms=float(duration_ms))
        with self.trace.lock:
            self.children.append(c)
        return c

    def annotate(self, key: str, value: Any) -> None:
        with self.trace.lock:
            self.attrs[key] = value

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"name": self.name}
        if self.duration_ms is not None:
            d["duration_ms"] = round(self.duration_ms, 3)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class Trace:
    """One sampled request: ids + the root span + a lock guarding
    cross-thread attachment (dispatch-pool attribution)."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "request_id",
                 "kind", "name", "root", "lock", "start_unix_ms")

    def __init__(self, kind: str, name: str, trace_id: str,
                 parent_span_id: Optional[str], request_id: str,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_span_id = parent_span_id
        self.request_id = request_id
        self.kind = kind
        self.name = name
        self.lock = threading.Lock()
        self.start_unix_ms = time.time() * 1000.0
        self.root = Span("request", self, attrs)

    def traceparent(self) -> str:
        """The outbound W3C header value for this trace's root."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "request_id": self.request_id,
            "kind": self.kind,
            "name": self.name,
            "start_unix_ms": round(self.start_unix_ms, 1),
            "duration_ms": (round(self.root.duration_ms, 3)
                            if self.root.duration_ms is not None else None),
            "root": self.root.to_dict(),
        }


class DispatchRecord:
    """Phase/fact accumulator for ONE device dispatch, attributed at
    ``finish()`` across every rider request's trace.

    riders: ``[(span, rows, queue_wait_ms)]`` — the span each rider's
    attribution attaches under (captured on the submitting thread), its row
    count, and its admission-queue wait. ``owned=True`` means the creator
    (the shard, on the direct path) must call finish(); the coalescer
    creates unowned records and finishes them after the device work, before
    waking the waiters, so attribution is complete when a request thread
    reads its own trace.

    Attribution math: ``share_i = rows_i / actual_rows``; every phase (and
    the dispatch total) is split by share, so when all riders are sampled
    ``sum_i(device_ms_i) == dispatch device_ms`` exactly (float error
    aside) — the identity tests/test_tracing.py pins. Padding overhead is
    NOT smeared into shares: it is reported as ``padding_waste =
    1 - actual_rows/padded_rows`` so "how much padding did this request
    pay" stays answerable separately.
    """

    __slots__ = ("riders", "owned", "attrs", "phases", "ledger_entries",
                 "_finished")

    def __init__(self, riders: list[tuple[Span, int, float]],
                 owned: bool = True, **attrs):
        self.riders = riders
        self.owned = owned
        self.attrs: dict[str, Any] = {"dispatch_id": next(_dispatch_seq)}
        self.attrs.update(attrs)
        self.phases: list[tuple[str, float]] = []
        # host-overhead ledger (monitoring/perf.py stages): finer than the
        # attribution phases — enqueue / device fetch / gather hop — and
        # kept SEPARATE from `phases` so the attribution identity (rider
        # phase shares sum to the dispatch span) is untouched by ledger
        # stages that overlap the device_search interval
        self.ledger_entries: list[tuple[str, float]] = []
        self._finished = False

    def phase(self, name: str, ms: float) -> None:
        """Record one device-phase duration (filter, device_search, rescore,
        hydrate). Single-threaded by construction (the dispatching thread),
        so no lock on the hot path."""
        self.phases.append((name, float(ms)))

    def fact(self, **kw) -> None:
        self.attrs.update(kw)

    def attach_shape(self, shape) -> None:
        """Fold a costmodel.DispatchShape's analytic facts + host-overhead
        ledger into this record (db/shard.py calls it right after the
        dispatch's phases land, before finish()). The roofline facts
        themselves are computed at finish()."""
        self.attrs.update(tier=shape.tier, n_live=shape.n,
                          dim=shape.dim, flops=shape.flops(),
                          bytes=shape.bytes())
        if shape.backend is not None:
            # the PEAKS key of the device the dispatch ran on
            self.attrs["backend"] = shape.backend
        if shape.t_end > shape.t_start:
            # the dispatch's enqueue->fetch wall: the per-dispatch roofline
            # denominator. The blocked-fetch time is only a LOWER bound on
            # device time (a result that landed while the host was doing
            # enqueue/compile work fetches in ~0 ms), so dividing by it
            # can fabricate >100% MFU; the wall form is an honest
            # serving-level number (kernel-level lives in /debug/perf's
            # device-busy aggregate)
            self.attrs["dispatch_wall_ms"] = round(
                (shape.t_end - shape.t_start) * 1000.0, 3)
        for name, ms in shape.ledger().items():
            self.ledger_entries.append((name, ms))

    def finish(self) -> None:
        """Split this dispatch across its riders' traces. Idempotent, and
        every span it creates is born closed — no error path can leak."""
        if self._finished:
            return
        self._finished = True
        total_ms = sum(ms for _, ms in self.phases)
        device_ms = sum(ms for n, ms in self.phases if n == "device_search")
        rows_total = int(self.attrs.get("actual_rows") or 0) \
            or sum(r for _, r, _ in self.riders) or 1
        padded = int(self.attrs.get("padded_rows") or 0)
        if padded > 0:
            self.attrs["padding_waste"] = round(
                max(0.0, 1.0 - rows_total / padded), 4)
        # roofline facts (costmodel): the dispatch's analytic work over its
        # enqueue->fetch WALL — the serving-level per-dispatch utilization.
        # Deliberately NOT over the blocked-fetch time: that is a lower
        # bound on device time (a dispatch overlapping host work fetches
        # in ~0 ms and would read as >100% MFU); kernel-level utilization
        # comes from /debug/perf's device-busy aggregate instead.
        flops = self.attrs.get("flops")
        ledger = dict(self.ledger_entries)
        if flops:
            dev_ms = self.attrs.get("dispatch_wall_ms") or device_ms
            # no roofline for a card with no datasheet peaks (roofline None)
            rf = (costmodel.roofline(flops, self.attrs.get("bytes", 0), dev_ms / 1000.0,
                                     self.attrs.get("backend"))
                  if dev_ms > 0.0 else None)
            if rf is not None:
                self.attrs.update(
                    mfu_pct=rf["mfu_pct"], hbm_bw_pct=rf["bw_pct"],
                    arith_intensity=rf["arith_intensity_flops_per_byte"],
                    regime=rf["regime"])
        if ledger:
            self.attrs["ledger_ms"] = {
                k: round(v, 3) for k, v in ledger.items()}
        # per-rider flops/bytes: telescoping integer split, so when every
        # rider is sampled the parts sum BIT-EXACTLY to the dispatch
        # totals (the flops/bytes twin of the device-time identity)
        rider_rows = [r for _, r, _ in self.riders]
        rider_flops = (costmodel.split_exact(flops, rider_rows, rows_total)
                       if flops else None)
        rider_bytes = (costmodel.split_exact(
            self.attrs.get("bytes", 0), rider_rows, rows_total)
            if flops else None)
        t = _tracer
        m = t.metrics if t is not None else None
        for i, (span, rows, wait_ms) in enumerate(self.riders):
            share = rows / rows_total
            attrs = {
                **self.attrs,
                "rows": rows,
                "share": round(share, 6),
                "queue_wait_ms": round(wait_ms, 3),
                "device_ms": device_ms * share,
                "dispatch_device_ms": device_ms,
                "dispatch_total_ms": total_ms,
            }
            if rider_flops is not None:
                attrs["flops"] = rider_flops[i]
                attrs["bytes"] = rider_bytes[i]
                attrs["dispatch_flops"] = flops
                attrs["dispatch_bytes"] = self.attrs.get("bytes", 0)
            d = span.child_done("dispatch", duration_ms=total_ms * share,
                                attrs=attrs)
            for nm, ms in self.phases:
                d.child_done(nm, duration_ms=ms * share)
            if m is not None:
                try:
                    if wait_ms > 0.0:
                        m.trace_phase.labels("queue_wait").observe(wait_ms)
                    for nm, ms in self.phases:
                        m.trace_phase.labels(nm).observe(ms * share)
                except Exception:  # noqa: BLE001 — metrics must not break serving
                    pass
        if m is not None:
            try:
                m.trace_dispatch_rows.labels("actual").inc(rows_total)
                if padded:
                    m.trace_dispatch_rows.labels("padded").inc(padded)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass


class Tracer:
    """Process-wide trace collector: sampling decision, completed-trace
    ring buffer, slow-query log, exemplar metrics, and the seen-jit-shape
    set behind the compile-vs-cache-hit dispatch fact."""

    def __init__(self, sample_rate: float = 1.0, ring_size: int = 256,
                 slow_ms: float = 1000.0, metrics=None):
        self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)
        self.slow_ms = float(slow_ms)
        self.metrics = metrics
        self._ring: deque = deque(maxlen=max(int(ring_size), 1))
        self._ring_lock = threading.Lock()
        # (id(index), padded_rows, k) shapes seen since tracing began: the
        # first dispatch of a shape is (a proxy for) the jit compile. Bounded
        # so a pathological shape churn cannot grow it without limit.
        self._shapes: set = set()
        self._shapes_lock = threading.Lock()

    def set_sample_rate(self, rate: float) -> None:
        """Adjust the trace sampling gate (clamped to [0, 1]). The
        control plane's brownout stage 3 pauses sampling with 0 and
        restores the configured rate on recovery/revert; /debug/perf
        coverage is unaffected (the shard feeds every dispatch while the
        tracer is up, independent of sampling). serving/controller.py is
        the only caller outside tests (graftlint JGL014)."""
        self.sample_rate = min(max(float(rate), 0.0), 1.0)

    # -- request lifecycle ---------------------------------------------------

    def start_request(self, kind: str, name: str,
                      traceparent: Optional[str] = None,
                      request_id: Optional[str] = None,
                      attrs: Optional[dict] = None) -> Optional[Trace]:
        """-> a sampled Trace, or None (sampled out; counted)."""
        if self.sample_rate < 1.0 and random.random() >= self.sample_rate:
            m = self.metrics
            if m is not None:
                try:
                    m.traces.labels(kind, "unsampled").inc()
                except Exception:  # noqa: BLE001
                    pass
            return None
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_span_id, _flags = parsed
        else:
            trace_id, parent_span_id = uuid.uuid4().hex, None
        return Trace(kind, name, trace_id, parent_span_id,
                     request_id or gen_request_id(), attrs)

    def finish(self, trace: Trace, error: Optional[BaseException] = None) -> None:
        """Close the root span, push the trace to the ring, slow-log and
        count it. Exactly once per trace (the request() context manager's
        finally owns the call)."""
        if error is not None:
            trace.root.attrs["error"] = f"{type(error).__name__}: {error}"
        trace.root.end()
        doc = trace.to_dict()
        with self._ring_lock:
            self._ring.append(doc)
        dur = trace.root.duration_ms or 0.0
        slow = self.slow_ms > 0.0 and dur >= self.slow_ms
        if slow:
            try:
                _SLOW_LOG.warning("%s", json.dumps(
                    {"slow_query": True, "threshold_ms": self.slow_ms, **doc},
                    default=str))
            except Exception:  # noqa: BLE001 — logging must not break serving
                pass
        m = self.metrics
        if m is not None:
            try:
                outcome = ("error" if error is not None
                           else "slow" if slow else "ok")
                m.traces.labels(trace.kind, outcome).inc()
            except Exception:  # noqa: BLE001
                pass

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Completed traces, oldest first (the /debug/traces body)."""
        with self._ring_lock:
            return list(self._ring)

    def clear(self) -> None:
        """Drop buffered traces (bench windows reset between measurements)."""
        with self._ring_lock:
            self._ring.clear()

    def first_shape(self, key: tuple) -> bool:
        """True the first time a dispatch shape is seen since tracing began
        — a proxy for "this dispatch paid the jit compile" (shapes warmed
        before the tracer came up read as first sightings once)."""
        with self._shapes_lock:
            if key in self._shapes:
                return False
            if len(self._shapes) >= 8192:  # runaway shape churn backstop
                self._shapes.clear()
            self._shapes.add(key)
        # a first sighting is (a proxy for) a jit compile — journal it so
        # an incident bundle shows whether the window around a latency
        # spike was paying compiles (monitoring/incidents.py; burst-
        # coalesced, one-comparison no-op when the plane is off). Lazy
        # import: incidents is off tracing's import path by design.
        try:
            from weaviate_tpu_torch.monitoring import incidents

            incidents.emit("jit_compile", scope="dispatch",
                           padded_rows=int(key[1]), k=int(key[2]))
        except Exception:  # noqa: BLE001 — observability must not break serving
            pass
        return True


# -- module state + zero-hop accessors ----------------------------------------

_tracer: Optional[Tracer] = None

# the active span of the current request (serving thread + anything
# contextvars copies into); None when disabled, unsampled, or off-request
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "weaviate_trace_span", default=None)
# the coalescer-owned dispatch record, set around the shard call on the
# flush/dispatch-pool threads so shard phase recording lands in the record
# that knows the lane's riders
_DISPATCH = contextvars.ContextVar("weaviate_trace_dispatch", default=None)


def configure(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or clear, with None) the process-wide tracer."""
    global _tracer
    _tracer = tracer
    return tracer


def unconfigure(tracer: Tracer) -> None:
    """Clear the global only if it is still `tracer` (App shutdown must not
    tear down a newer App's tracer)."""
    global _tracer
    if _tracer is tracer:
        _tracer = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def current_span() -> Optional[Span]:
    """The active span, or None. First check is the disabled fast path."""
    if _tracer is None:
        return None
    return _CURRENT.get()


@contextlib.contextmanager
def request(kind: str, name: str, traceparent: Optional[str] = None,
            request_id: Optional[str] = None, **attrs) -> Iterator[Optional[Trace]]:
    """Root context manager for one request: sampling, contextvar install,
    guaranteed finish (error recorded) in finally."""
    t = _tracer
    if t is None:
        yield None
        return
    tr = t.start_request(kind, name, traceparent=traceparent,
                         request_id=request_id, attrs=attrs or None)
    if tr is None:
        yield None
        return
    token = _CURRENT.set(tr.root)
    err: Optional[BaseException] = None
    try:
        yield tr
    except BaseException as e:
        err = e
        raise
    finally:
        _CURRENT.reset(token)
        t.finish(tr, error=err)


@contextlib.contextmanager
def span(name: str, **attrs) -> Iterator[Optional[Span]]:
    """Child span under the current one; no-op (yields None) when there is
    no active trace. Closing is structural — this is the API the JGL007
    graftlint rule steers serving/db code toward."""
    parent = current_span()
    if parent is None:
        yield None
        return
    s = parent.child_start(name, attrs or None)
    token = _CURRENT.set(s)
    try:
        yield s
    except BaseException as e:
        s.attrs["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _CURRENT.reset(token)
        s.end()


def dispatch_record(actual_rows: int = 0) -> Optional[DispatchRecord]:
    """The record a shard dispatch should record phases into:

    - the coalescer-installed record (its lifecycle is the coalescer's:
      ``owned`` False), when one is set for this thread;
    - else a fresh single-rider record bound to the current request span
      (direct path; ``owned`` True — the caller must finish() in a
      ``finally``);
    - else None (disabled / unsampled / off-request): the zero-hop path.
    """
    if _tracer is None:
        return None
    rec = _DISPATCH.get()
    if rec is not None:
        return rec
    s = _CURRENT.get()
    if s is None:
        return None
    rows = max(int(actual_rows), 1)
    return DispatchRecord([(s, rows, 0.0)], owned=True, actual_rows=rows)


def push_dispatch(rec: Optional[DispatchRecord]):
    """Install `rec` for this thread (coalescer, around the shard call).
    -> token for pop_dispatch; None rec => None token, both no-ops."""
    if rec is None:
        return None
    return _DISPATCH.set(rec)


def pop_dispatch(token) -> None:
    if token is not None:
        _DISPATCH.reset(token)


def note_shape(key: tuple) -> Optional[bool]:
    """First-sighting bit for a dispatch jit shape; None when disabled."""
    t = _tracer
    if t is None:
        return None
    return t.first_shape(key)


def annotate_current(key: str, value: Any) -> None:
    """Set an attribute on the current request's active span (bypass
    reasons, retry markers). No-op off-trace."""
    s = current_span()
    if s is not None:
        s.annotate(key, value)


def annotate_span(s: Optional[Span], key: str, value: Any) -> None:
    """Set an attribute on a captured span from another thread (the
    coalescer's error/shutdown paths annotating rider traces)."""
    if _tracer is None or s is None:
        return
    s.annotate(key, value)
