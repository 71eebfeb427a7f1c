# The port's copy of weaviate_tpu/monitoring/tracing.py, its imports pointed at the port.
"""Request tracing with device-time attribution across the coalesced path.

The per-phase histograms (shard_read.go parity) and the pprof mount
aggregate across requests, and the query coalescer (serving/coalescer.py)
shares one padded dispatch among many requests; this module answers
"where did THIS request spend its time" with a low-overhead span tracer:

  - handlers (REST / GraphQL / gRPC) accept and emit W3C ``traceparent``
    (``X-Request-Id`` fallback) and open a sampled request trace;
  - the active span travels in a ``contextvars.ContextVar`` through
    usecases/traverser.py into serving/coalescer.py lanes, and across the
    coalescer's flush-thread / dispatch-pool handoffs as explicit captures
    (a ``_Waiter`` carries its submitter's span; the dispatch record rides
    a second ContextVar set around the shard call);
  - each shard dispatch (db/shard.py, index/gpu.py) records its phases
    (filter, device_search, hydrate), device_search's own steps (the
    snapshot read, the query staging, the launches, the one fetch) and
    dispatch facts: padded-vs-actual rows, lane queue wait, the staging
    buffers it had to allocate, and on the card its device time from two
    CUDA events.

Every span carries its start on ``time.perf_counter_ns()`` and the CPU
time of the thread that ran it (``thread_time_ns``), so a device trace
(monitoring/profiling.py) can lay the spans beside the card's kernels on
one clock and tell a thread that worked from one that waited.

Fan-in/fan-out attribution — the key design problem — happens in
``DispatchRecord.finish()``: ONE coalesced dispatch splits its device time
back across every rider request's trace proportionally by rows
(``share = rows_i / actual_rows``), so the riders' attributed device times
sum exactly to the dispatch's phases (padding overhead is reported
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
  - the spans of the traces that ran during a device-trace capture, in
    its trace.json on the profiler's clock (monitoring/profiling.py);
  - exemplar counters (``weaviate_traces_total``, ``weaviate_trace_phase_ms``,
    ``weaviate_trace_dispatch_rows_total``), exception-guarded.

Disabled (``TRACING_ENABLED`` unset) the module global ``_tracer`` is
``None`` and every entry point returns after that one comparison: no span
objects, no ContextVar writes, no locks — the serving hot path makes zero
tracing calls (pinned by spy tests in tests/test_torch_tracing.py). Enabled,
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


_local = threading.local()


def _tid() -> int:
    """The calling thread's native id (cached: a system call each time)."""
    t = getattr(_local, "tid", None)
    if t is None:
        t = _local.tid = threading.get_native_id()
    return t


class Span:
    """One timed node in a request's trace tree. Children may be appended
    from other threads (coalesced-dispatch attribution), so the append goes
    through the owning trace's lock; everything else is single-writer.
    ``start_ns`` is on ``time.perf_counter_ns()``; ``cpu_ms`` is the CPU
    time of the thread ``tid`` (its native id, as the profiler names
    threads) over the span."""

    __slots__ = ("name", "trace", "attrs", "children", "duration_ms",
                 "start_ns", "cpu_ms", "tid", "_c0")

    def __init__(self, name: str, trace: "Trace",
                 attrs: Optional[dict] = None,
                 duration_ms: Optional[float] = None,
                 start_ns: Optional[int] = None,
                 cpu_ms: Optional[float] = None,
                 tid: Optional[int] = None):
        self.name = name
        self.trace = trace
        self.attrs: dict[str, Any] = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        self.duration_ms = duration_ms
        self.cpu_ms = cpu_ms
        self.tid = _tid() if tid is None else tid
        self._c0 = None
        if duration_ms is None:
            self.start_ns = time.perf_counter_ns()
            self._c0 = time.thread_time_ns()
        else:
            self.start_ns = (time.perf_counter_ns() - int(duration_ms * 1e6)
                             if start_ns is None else int(start_ns))

    def end(self) -> None:
        """Close an open span; on the thread that opened it."""
        if self.duration_ms is None:
            self.duration_ms = (time.perf_counter_ns() - self.start_ns) / 1e6
            self.cpu_ms = (time.thread_time_ns() - self._c0) / 1e6

    def child_start(self, name: str, attrs: Optional[dict] = None) -> "Span":
        """Open a child span (the caller owns closing it — prefer the
        ``span()`` context manager, which can't leak)."""
        c = Span(name, self.trace, attrs)
        with self.trace.lock:
            self.children.append(c)
        return c

    def child_done(self, name: str, duration_ms: float,
                   attrs: Optional[dict] = None, start_ns: Optional[int] = None,
                   cpu_ms: Optional[float] = None,
                   tid: Optional[int] = None) -> "Span":
        """Attach an already-closed child (post-hoc attribution): created
        and finished atomically, so attribution can never leak an open
        span on an error path. `start_ns` is the real start of the work it
        stands for (default: `duration_ms` before now)."""
        c = Span(name, self.trace, attrs, duration_ms=float(duration_ms),
                 start_ns=start_ns, cpu_ms=cpu_ms, tid=tid)
        with self.trace.lock:
            self.children.append(c)
        return c

    def annotate(self, key: str, value: Any) -> None:
        with self.trace.lock:
            self.attrs[key] = value

    def to_dict(self, t0_ns: int) -> dict:
        """-> the span tree; `start_ms` relative to `t0_ns`, the trace's."""
        d: dict[str, Any] = {"name": self.name,
                             "start_ms": round((self.start_ns - t0_ns) / 1e6, 4)}
        if self.duration_ms is not None:
            d["duration_ms"] = round(self.duration_ms, 3)
        if self.cpu_ms is not None:
            d["cpu_ms"] = round(self.cpu_ms, 3)
        d["tid"] = self.tid
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.children:
            d["children"] = [c.to_dict(t0_ns) for c in self.children]
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
        """The trace's one absolute stamp is `start_unix_ms`; its spans'
        starts are relative to the root's."""
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
            "root": self.root.to_dict(self.root.start_ns),
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
    its steps) is split by share, so when all riders are sampled the
    riders' phase durations sum to the dispatch's exactly (float error
    aside). Starts and CPU times are the dispatching thread's, unsplit.
    Padding overhead is NOT smeared into shares: it is reported as
    ``padding_waste = 1 - actual_rows/padded_rows``.
    """

    __slots__ = ("riders", "owned", "attrs", "phases", "ledger_entries",
                 "_finished")

    def __init__(self, riders: list[tuple[Span, int, float]],
                 owned: bool = True, **attrs):
        self.riders = riders
        self.owned = owned
        self.attrs: dict[str, Any] = {"dispatch_id": next(_dispatch_seq)}
        self.attrs.update(attrs)
        # (name, start_ns, end_ns, cpu_ns, tid, steps)
        self.phases: list[tuple] = []
        # host-overhead ledger (monitoring/perf.py stages), kept apart
        # from `phases`: its stages overlap the device_search interval
        self.ledger_entries: list[tuple[str, float]] = []
        self._finished = False

    def phase(self, name: str, start_ns: int, end_ns: int,
              cpu_ns: Optional[int] = None, steps=()) -> None:
        """Record one phase (filter, device_search, hydrate) by its
        perf_counter_ns interval and its thread CPU time. `steps` are
        ``(name, start_ns, end_ns, cpu_ns, steps)`` of the work inside it
        (index/gpu.py's). Single-threaded by construction (the dispatching
        thread), so no lock on the hot path."""
        self.phases.append((name, int(start_ns), int(end_ns), cpu_ns,
                            _tid(), steps))

    def fact(self, **kw) -> None:
        self.attrs.update(kw)

    def attach_shape(self, shape) -> None:
        """Fold a costmodel.DispatchShape's facts and host-overhead ledger
        into this record (db/shard.py calls it right after the dispatch's
        phases land, before finish()): the tier and the work as plain
        facts, the staging buffers allocated, whether a CUDA graph ran the
        work, and on the card the device time the dispatch's CUDA events
        measured."""
        self.attrs.update(tier=shape.tier, n_live=shape.n,
                          dim=shape.dim, flops=shape.flops(),
                          bytes=shape.bytes(), stage_alloc=shape.stage_alloc,
                          graph=shape.graph)
        if shape.backend is not None:
            # the PEAKS key of the device the dispatch ran on
            self.attrs["backend"] = shape.backend
        if shape.device_ms >= 0.0:
            self.attrs["device_ms"] = round(shape.device_ms, 4)
        for name, ms in shape.ledger().items():
            self.ledger_entries.append((name, ms))

    def finish(self) -> None:
        """Split this dispatch across its riders' traces. Idempotent, and
        every span it creates is born closed — no error path can leak."""
        if self._finished:
            return
        self._finished = True
        total_ms = sum((e - s) / 1e6 for _, s, e, *_ in self.phases)
        rows_total = int(self.attrs.get("actual_rows") or 0) \
            or sum(r for _, r, _ in self.riders) or 1
        padded = int(self.attrs.get("padded_rows") or 0)
        if padded > 0:
            self.attrs["padding_waste"] = round(
                max(0.0, 1.0 - rows_total / padded), 4)
        if self.ledger_entries:
            self.attrs["ledger_ms"] = {
                k: round(v, 3) for k, v in self.ledger_entries}
        start = min((s for _, s, *_ in self.phases), default=None)
        cpu = sum(c or 0 for *_, c, _, _ in self.phases) / 1e6
        tid = self.phases[0][4] if self.phases else None
        t = _tracer
        m = t.metrics if t is not None else None
        for span, rows, wait_ms in self.riders:
            share = rows / rows_total
            attrs = {**self.attrs, "rows": rows, "share": round(share, 6),
                     "queue_wait_ms": round(wait_ms, 3),
                     "dispatch_total_ms": total_ms}
            d = span.child_done("dispatch", total_ms * share, attrs,
                                start_ns=start, cpu_ms=cpu, tid=tid)
            for nm, s, e, c, tid_p, steps in self.phases:
                _closed(d, nm, s, e, c, tid_p, steps, share)
            if m is not None:
                try:
                    if wait_ms > 0.0:
                        m.trace_phase.labels("queue_wait").observe(wait_ms)
                    for nm, s, e, *_ in self.phases:
                        m.trace_phase.labels(nm).observe((e - s) / 1e6 * share)
                except Exception:  # noqa: BLE001 — metrics must not break serving
                    pass
        if m is not None:
            try:
                m.trace_dispatch_rows.labels("actual").inc(rows_total)
                if padded:
                    m.trace_dispatch_rows.labels("padded").inc(padded)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass


def _closed(parent: Span, name: str, start_ns: int, end_ns: int,
            cpu_ns: Optional[int], tid: int, steps, share: float) -> None:
    """A closed child of `parent` for one recorded interval, its steps
    nested under it; durations split by `share`."""
    s = parent.child_done(name, (end_ns - start_ns) / 1e6 * share,
                          start_ns=start_ns, tid=tid,
                          cpu_ms=None if cpu_ns is None else cpu_ns / 1e6)
    for nm, s0, e0, c0, sub in steps:
        _closed(s, nm, s0, e0, c0, tid, sub, share)


class Tracer:
    """Process-wide trace collector: sampling decision, completed-trace
    ring buffer, slow-query log and exemplar metrics."""

    def __init__(self, sample_rate: float = 1.0, ring_size: int = 256,
                 slow_ms: float = 1000.0, metrics=None):
        self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)
        self.slow_ms = float(slow_ms)
        self.metrics = metrics
        self._ring: deque = deque(maxlen=max(int(ring_size), 1))
        self._ring_lock = threading.Lock()

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
            self._ring.append((trace.root.start_ns, doc))
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
            return [doc for _, doc in self._ring]

    def timed(self) -> list[tuple[int, dict]]:
        """Completed traces with their roots' perf_counter_ns starts, oldest
        first: what a device trace lays on its own clock."""
        with self._ring_lock:
            return list(self._ring)

    def clear(self) -> None:
        """Drop buffered traces (bench windows reset between measurements)."""
        with self._ring_lock:
            self._ring.clear()


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


@contextlib.contextmanager
def resume(s: Optional[Span]) -> Iterator[None]:
    """Make `s`, captured on another thread, the current span here (a pool
    thread doing part of that request's work). No-op for None."""
    if s is None or _tracer is None:
        yield
        return
    token = _CURRENT.set(s)
    try:
        yield
    finally:
        _CURRENT.reset(token)


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
