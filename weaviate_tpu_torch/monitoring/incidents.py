# The port's copy of weaviate_tpu/monitoring/incidents.py, its imports pointed at the port.
"""Incident flight recorder + SLO burn-rate engine: the capstone layer.

The four observability planes — tracing/perf (PR 3/7), quality (PR 8),
and the memory ledger (PR 9) — each answer "what is happening" on their
own axis, but nothing connects a *symptom* (breaker OPEN, recall
degradation, headroom alert, SLO burn) to a *preserved, correlated
diagnostic bundle*: BENCH_r02-r05 chip sessions all died on an
unreachable device with their evidence lost (an opaque rc=3), and the
north star ("heavy traffic from millions of users") had no SLO
definition to alert against. This module is the layer that turns the
planes into an incident-response system, with three cooperating pieces:

**Ops-event journal** (``OpsJournal``): a bounded, lock-cheap ring of
structured events the existing planes emit at their state transitions —
breaker CLOSED/OPEN/HALF_OPEN, shed bursts, quality degradation
fire/recover, memory exhaustion alert/recover, jit-shape first
sightings, device fallbacks, flusher death, write-path compress/compact,
fault-injection firings, SLO budget crossings. Each event is a typed
record ``{ts, kind, scope, tenant?, detail}`` under a **bounded kind
taxonomy** (``EVENT_KINDS``; foreign kinds fold to ``other`` — the
JGL010 discipline applied to event kinds, with graftlint JGL013 as the
static twin: every ``emit()`` call site outside this module must pass a
literal registered kind). High-frequency kinds (sheds, fallbacks, jit
compiles) are **burst-coalesced**: within ``BURST_WINDOW_S`` the ring
entry's count increments instead of appending, so a 10k-QPS shed storm
reads as one event with a count, not a ring wipe.

**SLO engine** (``SloEngine``): config-declared objectives
(``SLO_AVAILABILITY_TARGET``, ``SLO_LATENCY_P99_MS``, optional
per-tenant availability overrides under bounded labels) evaluated
continuously from the request outcomes the serving frontends already
classify (ok / shed / deadline / error — the same taxonomy the shed and
deadline counters use) into the standard fast-burn/slow-burn
multi-window pair (5m / 1h): ``burn = bad_fraction / error_budget``.
Exposed as ``weaviate_slo_burn_rate{slo,window}`` and
``weaviate_slo_error_budget_remaining{slo}``; budget-exhaustion
crossings are themselves journal events AND incident triggers, with
fire-once-per-transition + rate-limited-log semantics (the
quality/memory alert idiom).

**Flight recorder** (``FlightRecorder``): on an incident trigger
(breaker OPEN, SLO fast/slow burn, quality degradation, memory
exhaustion, flusher death, SIGTERM/atexit teardown with a live server,
explicit ``POST /debug/incidents/dump``), atomically capture a
correlated bundle — perf/quality/memory window summaries, breaker +
coalescer + tenant-gate stats, the ``/debug/traces`` tail, the journal
tail, a config fingerprint — to ``INCIDENT_DIR`` as one JSON file.
Rate-limited per incident class (``INCIDENT_RATE_LIMIT_S``) and
disk-budgeted (oldest bundles pruned against ``INCIDENT_DIR_MAX_BYTES``,
the directory accounted as an ``incident_bundles`` component in the
memory ledger's disk scope). Captures run on a lazily-started worker
thread (exception-guarded run loop — JGL011) so a serving thread that
trips the breaker never does file IO; the teardown and bench paths dump
synchronously (``dump_now``) because the process is about to die.

Exposure: ``GET /debug/incidents`` (bundle index + journal tail),
``GET /debug/slo``, both behind the pprof authorizer and listed on the
``/debug`` index page. See docs/incidents.md.

Lifecycle mirrors the tracer/perf/quality/memory planes: process-wide
module globals installed by App (``INCIDENTS_ENABLED``, default on) and
cleared on shutdown; disabled, every serving-path entry point
(``emit``/``note_request``/``trigger``) returns after one comparison
and constructs nothing (spy-pinned in tests/test_incidents.py). Every
module-level entry point is exception-guarded internally, so a journal
or recorder fault can never take down a serving path.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Optional

from weaviate_tpu_torch.testing import sanitizers

_LOG = logging.getLogger(__name__)

# -- the bounded event-kind taxonomy ------------------------------------------
# This tuple IS the journal's kind set and the weaviate_ops_events_total
# label set: a foreign kind folds into "other" at emit time (runtime
# bound), and graftlint JGL013 statically requires every emit() call site
# outside this module to pass one of these as a literal (static twin).

EVENT_KINDS = (
    "breaker_open", "breaker_half_open", "breaker_closed",
    "shed_burst", "deadline_burst",
    "quality_degraded", "quality_recovered",
    "memory_alert", "memory_recovered",
    "jit_compile", "device_fallback", "flusher_dead",
    "write_phase", "fault_injected",
    "slo_burn", "slo_recovered",
    "incident_dump", "teardown",
    # the control plane (serving/controller.py): every knob actuation,
    # brownout-ladder stage transition, and fail-static revert
    "controller_actuation", "controller_brownout", "controller_revert",
)
OTHER = "other"

# kinds that arrive per-request/per-dispatch under load: coalesced per
# (kind, scope) into one ring entry with a count within this window, so a
# storm cannot wipe the ring's low-frequency transition events
BURST_KINDS = frozenset({
    "shed_burst", "deadline_burst", "jit_compile", "device_fallback",
    "write_phase", "fault_injected", "flusher_dead",
    # a controller re-actuating one knob every tick under a sustained
    # signal must read as one counted entry per (kind, knob), not a wipe
    "controller_actuation",
})
BURST_WINDOW_S = 5.0

# incident classes (bundle file names, rate-limit buckets, and the
# weaviate_incident_bundles_total label set; foreign classes fold)
INCIDENT_CLASSES = (
    "breaker_open", "slo_fast_burn", "slo_slow_burn", "quality_degraded",
    "memory_exhaustion", "flusher_dead", "teardown", "manual", "bench",
)

# the standard fast-burn/slow-burn window pair; label values are the
# literal window names on weaviate_slo_burn_rate{slo,window}
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
_SLO_BUCKET_S = 5.0  # per-bucket tally resolution inside the windows

# request outcomes the frontends classify (REST _dispatch / gRPC
# servicer); "bad" ones spend availability error budget. "client" (a 4xx
# caller mistake) counts toward totals but never against the budget.
BAD_OUTCOMES = frozenset({"shed", "deadline", "error"})
REQUEST_OUTCOMES = ("ok", "client", "shed", "deadline", "error")

# seconds between SLO-burn log lines per slo (the counter/journal event
# always fires once per transition; the log is what gets rate-limited)
ALERT_LOG_INTERVAL_S = 60.0


# -- the ops-event journal ----------------------------------------------------


class OpsJournal:
    """Bounded ring of structured ops events. ``emit`` is the serving-path
    entry: one small lock, a dict build, a deque append (or, for burst
    kinds, a count bump on the ring's most recent (kind, scope) entry).
    ``tail``/``summary`` are the on-demand introspection bodies."""

    def __init__(self, size: int = 512, metrics=None,
                 burst_window_s: float = BURST_WINDOW_S):
        self.size = max(int(size), 1)
        self.metrics = metrics
        self.burst_window_s = float(burst_window_s)
        self._lock = sanitizers.register_lock(
            threading.Lock(), "monitoring.incidents.journal")
        self._ring: deque = deque(maxlen=self.size)
        # (kind, scope) -> the live ring dict a burst is coalescing into
        self._burst: dict = {}
        self._counts: dict[str, int] = {}  # lifetime, per folded kind

    def emit(self, kind: str, scope: str = "", tenant: Optional[str] = None,
             **detail) -> None:
        k = kind if kind in EVENT_KINDS else OTHER
        now = time.time()
        with self._lock:
            self._counts[k] = self._counts.get(k, 0) + 1
            if k in BURST_KINDS:
                key = (k, scope)
                evt = self._burst.get(key)
                if evt is not None and now - evt["ts_last"] \
                        <= self.burst_window_s:
                    evt["count"] += 1
                    evt["ts_last"] = now
                    return
            evt = {"ts": round(now, 3), "ts_last": now, "kind": k,
                   "scope": scope, "count": 1}
            if tenant:
                evt["tenant"] = tenant
            if detail:
                evt["detail"] = detail
            if len(self._ring) == self.size:
                # the append below evicts the oldest entry — drop its burst
                # mapping, else an ongoing storm keeps coalescing into the
                # evicted dict and never reappears in the ring
                old = self._ring[0]
                okey = (old["kind"], old["scope"])
                if self._burst.get(okey) is old:
                    del self._burst[okey]
            self._ring.append(evt)
            if k in BURST_KINDS:
                self._burst[(k, scope)] = evt
                if len(self._burst) > 4 * self.size:
                    # a scope-churning storm must not grow the burst map
                    # without bound; dropping it only ends coalescing early
                    self._burst.clear()
        m = self.metrics
        if m is not None:
            try:
                m.ops_events.labels(k).inc()
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def tail(self, n: int = 128) -> list:
        """The most recent events, oldest first (ts_last dropped from the
        copies only where it equals ts)."""
        with self._lock:
            events = list(self._ring)[-max(int(n), 1):]
        out = []
        for e in events:
            d = dict(e)
            if d.get("count", 1) == 1:
                d.pop("ts_last", None)
            else:
                d["ts_last"] = round(d["ts_last"], 3)
            out.append(d)
        return out

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def summary(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            n = len(self._ring)
        return {
            "size": self.size,
            "events_buffered": n,
            "events_total": sum(counts.values()),
            "counts": dict(sorted(counts.items(), key=lambda kv: -kv[1])),
            "tail": self.tail(64),
        }

    def clear(self) -> None:
        """Reset the ring (bench measurement slices); lifetime counts
        survive, like the perf window's dispatch counter."""
        with self._lock:
            self._ring.clear()
            self._burst.clear()


# -- the SLO engine -----------------------------------------------------------


class _Slo:
    """One objective's state: bucketed (total, bad) tallies over the slow
    window, the config target, and the fire-once alert latch."""

    __slots__ = ("name", "kind", "target", "budget", "tenant", "latency_ms",
                 "buckets", "alerting", "alert_window", "fired")

    def __init__(self, name: str, kind: str, target: float,
                 budget: float, tenant: Optional[str] = None,
                 latency_ms: float = 0.0):
        self.name = name
        self.kind = kind            # "availability" | "latency"
        self.target = target
        self.budget = max(budget, 1e-9)
        self.tenant = tenant
        self.latency_ms = latency_ms
        # deque[[bucket_epoch, total, bad]] spanning <= SLOW_WINDOW_S
        self.buckets: deque = deque()
        self.alerting = False       # fire-once latch (either window)
        self.alert_window = ""      # "fast"/"slow" while alerting
        self.fired = 0


class SloEngine:
    """Config-declared SLOs evaluated continuously from request outcomes.

    ``note`` is the per-request entry (one lock, O(1) bucket updates);
    burn rates are evaluated at most once per second under traffic (no
    background thread — a request-driven system's SLO only moves when
    requests do) and on every ``summary()``. Burn math: over a window,
    ``bad_fraction = bad / total``; the burn rate is
    ``bad_fraction / (1 - target)`` — burn 1.0 spends the budget exactly
    at the sustainable rate, the fast threshold (default 14.4, the
    SRE-workbook 5m pair) catches a cliff, the slow threshold (default
    3.0) catches a smolder."""

    def __init__(self, availability_target: float = 0.999,
                 latency_p99_ms: float = 0.0,
                 fast_burn_threshold: float = 14.4,
                 slow_burn_threshold: float = 3.0,
                 min_events: int = 20,
                 tenant_targets: Optional[dict] = None,
                 metrics=None):
        self.fast_burn_threshold = float(fast_burn_threshold)
        self.slow_burn_threshold = float(slow_burn_threshold)
        self.min_events = max(int(min_events), 1)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._slos: list[_Slo] = [
            _Slo("availability", "availability", float(availability_target),
                 1.0 - float(availability_target)),
        ]
        if latency_p99_ms > 0:
            # p99 objective: 1% of completed requests may run over target
            self._slos.append(_Slo(
                "latency_p99", "latency", 0.99, 0.01,
                latency_ms=float(latency_p99_ms)))
        # per-tenant availability overrides: label values are built ONCE
        # here from config (bounded by the config's own size — JGL010's
        # no-construction-at-the-call-site rule holds at .labels() time)
        for t, target in sorted((tenant_targets or {}).items()):
            self._slos.append(_Slo(
                "availability:" + t, "availability", float(target),
                1.0 - float(target), tenant=t))
        self._last_eval = 0.0
        self._alert_last_log: dict[str, float] = {}
        self._requests_total = 0  # lifetime, never evicted
        self._outcomes: dict[str, int] = {}

    # -- the per-request entry -----------------------------------------------

    def note(self, outcome: str, dur_ms: float = 0.0,
             tenant: Optional[str] = None) -> None:
        """Fold one completed request in. ``outcome`` is the frontend's
        classification (REQUEST_OUTCOMES); foreign values count as
        ``error`` (an unclassifiable request is not a good one)."""
        if outcome not in REQUEST_OUTCOMES:
            outcome = "error"
        now = time.monotonic()
        bucket = int(now // _SLO_BUCKET_S)
        bad = outcome in BAD_OUTCOMES
        with self._lock:
            self._requests_total += 1
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
            for slo in self._slos:
                if slo.tenant is not None and slo.tenant != tenant:
                    continue
                if slo.kind == "latency":
                    # the latency objective judges COMPLETED requests;
                    # sheds/errors are availability's problem
                    if outcome not in ("ok", "client"):
                        continue
                    self._bucket_add(slo, bucket,
                                     bad=dur_ms > slo.latency_ms)
                else:
                    self._bucket_add(slo, bucket, bad=bad)
        self._maybe_evaluate(now)

    @staticmethod
    def _bucket_add(slo: _Slo, bucket: int, bad: bool) -> None:
        b = slo.buckets
        if b and b[-1][0] == bucket:
            b[-1][1] += 1
            b[-1][2] += 1 if bad else 0
        else:
            b.append([bucket, 1, 1 if bad else 0])
            horizon = bucket - int(SLOW_WINDOW_S / _SLO_BUCKET_S) - 1
            while b and b[0][0] < horizon:
                b.popleft()

    # -- burn evaluation ------------------------------------------------------

    def _window_tally(self, slo: _Slo, window_s: float, now: float) -> tuple:
        """(total, bad) over the trailing window (caller holds the lock)."""
        first = int((now - window_s) // _SLO_BUCKET_S)
        total = bad = 0
        for bucket, t, b in reversed(slo.buckets):
            if bucket < first:
                break
            total += t
            bad += b
        return total, bad

    def _burn(self, slo: _Slo, window_s: float, now: float) -> Optional[float]:
        total, bad = self._window_tally(slo, window_s, now)
        if total < self.min_events:
            return None  # a cold window over two requests is noise
        return (bad / total) / slo.budget

    def _maybe_evaluate(self, now: float, force: bool = False) -> None:
        with self._lock:
            if not force and now - self._last_eval < 1.0:
                return
            self._last_eval = now
            rows = []
            for slo in self._slos:
                fast = self._burn(slo, FAST_WINDOW_S, now)
                slow = self._burn(slo, SLOW_WINDOW_S, now)
                burning = ((fast is not None
                            and fast >= self.fast_burn_threshold)
                           or (slow is not None
                               and slow >= self.slow_burn_threshold))
                transitioned = burning != slo.alerting
                slo.alerting = burning
                if burning:
                    slo.alert_window = ("fast" if fast is not None
                                        and fast >= self.fast_burn_threshold
                                        else "slow")
                    if transitioned:
                        slo.fired += 1
                rows.append((slo, fast, slow, burning, transitioned))
        for slo, fast, slow, burning, transitioned in rows:
            self._publish(slo, fast, slow, now)
            if burning:
                self._alert(slo, fast, slow, transitioned)
            elif transitioned:
                _LOG.info("SLO burn recovered: slo=%s", slo.name)
                emit("slo_recovered", scope=slo.name)

    def _alert(self, slo: _Slo, fast, slow, transitioned: bool) -> None:
        cls = ("slo_fast_burn" if slo.alert_window == "fast"
               else "slo_slow_burn")
        if transitioned:
            emit("slo_burn", scope=slo.name, window=slo.alert_window,
                 fast_burn=round(fast, 2) if fast is not None else None,
                 slow_burn=round(slow, 2) if slow is not None else None)
            trigger(cls, reason=f"slo {slo.name} {slo.alert_window}-burn",
                    detail={"slo": slo.name, "fast_burn": fast,
                            "slow_burn": slow, "target": slo.target})
        now = time.monotonic()
        last = self._alert_last_log.get(slo.name)
        if transitioned or last is None \
                or now - last >= ALERT_LOG_INTERVAL_S:
            self._alert_last_log[slo.name] = now
            _LOG.warning(
                "SLO error budget burning: slo=%s window=%s fast=%.2fx "
                "slow=%.2fx (thresholds %.1f/%.1f, target %.4g) — journaled "
                "as slo_burn; further lines rate-limited to one per %.0fs",
                slo.name, slo.alert_window,
                fast if fast is not None else float("nan"),
                slow if slow is not None else float("nan"),
                self.fast_burn_threshold, self.slow_burn_threshold,
                slo.target, ALERT_LOG_INTERVAL_S)

    def _publish(self, slo: _Slo, fast, slow, now: float) -> None:
        m = self.metrics
        if m is None:
            return
        try:
            if fast is not None:
                m.slo_burn_rate.labels(slo.name, "5m").set(round(fast, 4))
            if slow is not None:
                m.slo_burn_rate.labels(slo.name, "1h").set(round(slow, 4))
            remaining = self._budget_remaining(slo, now)
            if remaining is not None:
                m.slo_budget_remaining.labels(slo.name).set(remaining)
        except Exception:  # noqa: BLE001 — metrics must not break serving
            pass

    def _budget_remaining(self, slo: _Slo, now: float) -> Optional[float]:
        """Error budget left over the slow (1h) window, 0..1 — 1.0 = no
        budget spent, 0.0 = the hour's budget is gone."""
        with self._lock:
            total, bad = self._window_tally(slo, SLOW_WINDOW_S, now)
        if total == 0:
            return None
        spent = (bad / total) / slo.budget
        return round(min(max(1.0 - spent, 0.0), 1.0), 4)

    def burn_rates(self) -> tuple:
        """(max fast burn, max slow burn) across the AVAILABILITY SLOs —
        the control plane's brownout sensor (serving/controller.py). A
        cold window (under min_events) contributes None; both None when
        nothing qualifies. Per-tenant overrides are deliberately
        included: one tenant's SLO burning is a real burn."""
        now = time.monotonic()
        fast_max = slow_max = None
        with self._lock:
            for slo in self._slos:
                if slo.kind != "availability":
                    continue
                fast = self._burn(slo, FAST_WINDOW_S, now)
                slow = self._burn(slo, SLOW_WINDOW_S, now)
                if fast is not None and (fast_max is None or fast > fast_max):
                    fast_max = fast
                if slow is not None and (slow_max is None or slow > slow_max):
                    slow_max = slow
        return fast_max, slow_max

    # -- introspection --------------------------------------------------------

    def summary(self) -> dict:
        now = time.monotonic()
        self._maybe_evaluate(now, force=True)
        slos = []
        with self._lock:
            requests_total = self._requests_total
            outcomes = dict(self._outcomes)
            rows = [(slo,
                     self._window_tally(slo, FAST_WINDOW_S, now),
                     self._window_tally(slo, SLOW_WINDOW_S, now),
                     self._burn(slo, FAST_WINDOW_S, now),
                     self._burn(slo, SLOW_WINDOW_S, now))
                    for slo in self._slos]
        for slo, (ft, fb), (st, sb), fast, slow in rows:
            doc = {
                "slo": slo.name,
                "kind": slo.kind,
                "target": slo.target,
                "error_budget": round(slo.budget, 6),
                "windows": {
                    "5m": {"requests": ft, "bad": fb,
                           "burn_rate": round(fast, 4)
                           if fast is not None else None},
                    "1h": {"requests": st, "bad": sb,
                           "burn_rate": round(slow, 4)
                           if slow is not None else None},
                },
                "budget_remaining_1h": self._budget_remaining(slo, now),
                "alerting": slo.alerting,
                "alerts_fired": slo.fired,
            }
            if slo.kind == "latency":
                doc["latency_target_ms"] = slo.latency_ms
            if slo.tenant is not None:
                doc["tenant"] = slo.tenant
            slos.append(doc)
        return {
            "requests_total": requests_total,
            "outcomes": outcomes,
            "fast_burn_threshold": self.fast_burn_threshold,
            "slow_burn_threshold": self.slow_burn_threshold,
            "min_events": self.min_events,
            "slos": slos,
        }

    def clear(self) -> None:
        """Reset windows and alert latches (bench measurement slices);
        lifetime counters survive."""
        with self._lock:
            for slo in self._slos:
                slo.buckets.clear()
                slo.alerting = False
                slo.alert_window = ""
            self._alert_last_log.clear()


# -- the flight recorder ------------------------------------------------------

# bundle-name sequence, process-wide: with the pid in the filename, a
# (pid, seq) pair is unique even when several recorders (CI runs many
# Apps per process) share one INCIDENT_DIR within the same second
_bundle_seq = 0
_seq_lock = threading.Lock()


class FlightRecorder:
    """Captures correlated diagnostic bundles to ``INCIDENT_DIR``.

    ``trigger`` is the serving-path entry: a rate-limit check per
    incident class and a drop-not-queue enqueue; the capture (plane
    summaries + file IO) runs on a lazily-started worker thread.
    ``dump_now`` captures synchronously for the paths where the process
    is about to die (SIGTERM/atexit teardown, bench rc=3)."""

    def __init__(self, incident_dir: str, max_bytes: int = 64 * 1024 * 1024,
                 rate_limit_s: float = 300.0, journal: Optional[OpsJournal]
                 = None, engine: Optional[SloEngine] = None, metrics=None):
        self.incident_dir = incident_dir
        self.max_bytes = max(int(max_bytes), 0)
        self.rate_limit_s = float(rate_limit_s)
        self.journal = journal
        self.engine = engine
        self.metrics = metrics
        self._lock = sanitizers.register_lock(
            threading.Lock(), "monitoring.incidents.recorder")
        self._last_dump: dict[str, float] = {}  # folded class -> monotonic
        self._dumped = 0
        self._rate_limited = 0
        self._queue: queue.Queue = queue.Queue(maxsize=4)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # the App's live serving stats (coalescer, tenant gate): pull
        # callables registered at wiring time, each exception-guarded
        self._stats_providers: dict[str, Callable[[], dict]] = {}
        self._config_fingerprint: Optional[dict] = None

    # -- wiring ---------------------------------------------------------------

    def add_stats_provider(self, name: str, fn: Callable[[], dict]) -> None:
        self._stats_providers[name] = fn

    def set_config_fingerprint(self, doc: dict) -> None:
        self._config_fingerprint = doc

    # -- triggers -------------------------------------------------------------

    @staticmethod
    def _fold_class(cls: str) -> str:
        return cls if cls in INCIDENT_CLASSES else OTHER

    def _rate_limited_now(self, cls: str, force: bool) -> bool:
        """Check-only: True when ``cls`` is inside its rate-limit window.
        The window stamp is written only once a capture is actually
        admitted (enqueued) or written — a dropped or failed capture must
        not silence its incident class for the whole window."""
        if force:
            return False
        with self._lock:
            last = self._last_dump.get(cls)
            if last is not None and \
                    time.monotonic() - last < self.rate_limit_s:
                self._rate_limited += 1
                return True
        return False

    def _stamp(self, cls: str) -> None:
        with self._lock:
            self._last_dump[cls] = time.monotonic()

    def _unstamp(self, cls: str) -> None:
        with self._lock:
            self._last_dump.pop(cls, None)

    def trigger(self, cls: str, reason: str = "",
                detail: Optional[dict] = None) -> bool:
        """Request an asynchronous bundle capture. -> True when a capture
        was admitted (not rate-limited, queue not full)."""
        cls = self._fold_class(cls)
        self._ensure_worker()
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(cls)
            if last is not None and now - last < self.rate_limit_s:
                self._rate_limited += 1
                return False
            try:
                self._queue.put_nowait((cls, reason, detail))
            except queue.Full:
                # the worker is saturated with captures — the in-flight
                # ones already preserve the incident window; drop (and
                # leave the class un-stamped so the next trigger retries)
                return False
            self._last_dump[cls] = now
        return True

    def dump_now(self, cls: str, reason: str = "",
                 detail: Optional[dict] = None,
                 force: bool = False) -> Optional[str]:
        """Capture + write synchronously (teardown/bench paths). -> the
        bundle path, or None when rate-limited or the write failed."""
        cls = self._fold_class(cls)
        if self._rate_limited_now(cls, force=force):
            return None
        try:
            path = self._write(self.capture(cls, reason, detail))
        except Exception:  # noqa: BLE001 — a dump must never take down a caller
            _LOG.warning("incident dump failed", exc_info=True)
            return None
        self._stamp(cls)
        return path

    # -- worker (exception-guarded run loop: a dead recorder thread would
    # -- silently drop every later incident — graftlint JGL011) --------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is not None and self._worker.is_alive():
                return
            t = threading.Thread(target=self._run, daemon=True,
                                 name="incident-recorder")
            # start() under the lock: a created-but-unstarted thread reads
            # is_alive() False, and a concurrent caller would spawn a
            # duplicate run loop
            t.start()
            self._worker = t

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if item is None:
                continue  # shutdown wake-up sentinel
            try:
                self._write(self.capture(*item))
            except Exception:  # noqa: BLE001 — the recorder loop must survive
                _LOG.warning("incident capture failed", exc_info=True)
                # re-arm the class: the admission stamp must not silence
                # an incident whose capture produced no bundle
                self._unstamp(item[0])

    # -- capture --------------------------------------------------------------

    def capture(self, cls: str, reason: str = "",
                detail: Optional[dict] = None) -> dict:
        """Build one correlated bundle. Every plane section is captured
        under its own guard — one broken plane must not cost the bundle —
        and stamps its own ``captured_unix`` so sections are provably
        time-consistent."""
        bundle: dict = {
            "incident": {
                "class": cls,
                "reason": reason,
                "detail": detail or {},
                "ts_unix": round(time.time(), 3),
                "iso": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "pid": os.getpid(),
            },
        }
        if self._config_fingerprint is not None:
            bundle["config"] = self._config_fingerprint

        def section(name: str, fn: Callable[[], Optional[dict]]) -> None:
            try:
                doc = fn()
            except Exception as e:  # noqa: BLE001 — capture what survives
                bundle[name] = {"error": f"{type(e).__name__}: {e}"}
                return
            if doc is not None:
                if isinstance(doc, dict):
                    doc = {"captured_unix": round(time.time(), 3), **doc}
                bundle[name] = doc

        journal = self.journal if self.journal is not None else _journal
        if journal is not None:
            section("journal", journal.summary)
        engine = self.engine if self.engine is not None else _engine
        if engine is not None:
            section("slo", engine.summary)

        def _perf():
            from weaviate_tpu_torch.monitoring import perf

            w = perf.get_window()
            return w.summary() if w is not None else None

        def _quality():
            from weaviate_tpu_torch.monitoring import quality

            a = quality.get_auditor()
            return a.summary() if a is not None else None

        def _memory():
            from weaviate_tpu_torch.monitoring import memory

            led = memory.get_ledger()
            return led.summary() if led is not None else None

        def _traces():
            from weaviate_tpu_torch.monitoring import tracing

            t = tracing.get_tracer()
            if t is None:
                return None
            return {"tail": t.snapshot()[-32:]}

        def _breaker():
            from weaviate_tpu_torch.serving import robustness

            br = robustness.get_breaker()
            if br is None:
                return None
            state = br.state()
            return {
                "state": state,
                "state_name": {0: "closed", 1: "open",
                               2: "half_open"}.get(state, "?"),
                "failure_threshold": br.failure_threshold,
                "reset_timeout_s": br.reset_timeout_s,
            }

        section("perf", _perf)
        section("quality", _quality)
        section("memory", _memory)
        section("traces", _traces)
        section("breaker", _breaker)
        for name, fn in list(self._stats_providers.items()):
            section(name, fn)
        return bundle

    # -- persistence ----------------------------------------------------------

    def _write(self, bundle: dict) -> Optional[str]:
        """Atomic single-file write (tmp + rename) followed by the disk-
        budget prune: oldest bundles go first, the one just written is
        never pruned (a cap smaller than one bundle keeps the newest)."""
        os.makedirs(self.incident_dir, exist_ok=True)
        cls = bundle.get("incident", {}).get("class", OTHER)
        with _seq_lock:
            global _bundle_seq
            _bundle_seq += 1
            seq = _bundle_seq
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        # pid in the name: recorders in different processes (CI shares one
        # INCIDENT_DIR across Apps) must never compute the same path and
        # silently overwrite each other's evidence; class stays the LAST
        # dash-segment (index() parses it from there)
        name = f"incident-{stamp}-{os.getpid()}-{seq:04d}-{cls}.json"
        path = os.path.join(self.incident_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        os.replace(tmp, path)
        with self._lock:
            self._dumped += 1
        m = self.metrics
        if m is not None:
            try:
                m.incident_bundles.labels(cls).inc()
            except Exception:  # noqa: BLE001
                pass
        journal = self.journal if self.journal is not None else _journal
        if journal is not None:
            try:
                journal.emit("incident_dump", scope=cls, file=name)
            except Exception:  # noqa: BLE001
                pass
        self._prune(keep=name)
        _LOG.warning("incident bundle written: %s (class=%s)", path, cls)
        return path

    def _bundles(self) -> list:
        """(mtime, name, bytes) for every bundle on disk, oldest first."""
        try:
            names = os.listdir(self.incident_dir)
        except OSError:
            return []
        out = []
        for n in names:
            if not (n.startswith("incident-") and n.endswith(".json")):
                continue
            p = os.path.join(self.incident_dir, n)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((st.st_mtime, n, st.st_size))
        out.sort()
        return out

    def _prune(self, keep: Optional[str] = None) -> None:
        if self.max_bytes <= 0:
            return
        bundles = self._bundles()
        total = sum(b for _, _, b in bundles)
        for _, n, b in bundles:
            if total <= self.max_bytes:
                break
            if n == keep:
                continue
            try:
                os.unlink(os.path.join(self.incident_dir, n))
                total -= b
            except OSError:
                pass

    def dir_bytes(self) -> int:
        """Bundle bytes on disk — the memory ledger's disk-scope
        ``incident_bundles`` component."""
        return sum(b for _, _, b in self._bundles())

    def index(self) -> list:
        """Bundle listing for /debug/incidents, newest first."""
        return [{"file": n, "bytes": b,
                 "mtime_unix": round(t, 1),
                 "class": n[:-5].rsplit("-", 1)[-1]}
                for t, n, b in reversed(self._bundles())]

    def stats(self) -> dict:
        with self._lock:
            return {
                "incident_dir": self.incident_dir,
                "dir_max_bytes": self.max_bytes,
                "rate_limit_s": self.rate_limit_s,
                "dumped": self._dumped,
                "rate_limited": self._rate_limited,
            }

    def shutdown(self) -> None:
        self._stop.set()
        w = self._worker
        if w is not None:
            try:
                self._queue.put_nowait(None)  # wake a blocked worker
            except queue.Full:
                pass
            w.join(timeout=2)


# -- module state + zero-hop accessors ----------------------------------------

_journal: Optional[OpsJournal] = None
_engine: Optional[SloEngine] = None
_recorder: Optional[FlightRecorder] = None

# final journal summaries of recently-unconfigured Apps (CI failure
# artifact: tests/conftest.py dumps these beside the perf/quality/memory
# stashes). Guarded by its own lock — concurrent App teardowns share it.
_final_summaries: deque = deque(maxlen=8)
_summaries_lock = threading.Lock()


def configure(journal: Optional[OpsJournal] = None,
              engine: Optional[SloEngine] = None,
              recorder: Optional[FlightRecorder] = None) -> None:
    """Install the process-wide incident plane (any subset)."""
    global _journal, _engine, _recorder
    if journal is not None:
        _journal = journal
    if engine is not None:
        _engine = engine
    if recorder is not None:
        _recorder = recorder


def unconfigure(journal: Optional[OpsJournal] = None,
                engine: Optional[SloEngine] = None,
                recorder: Optional[FlightRecorder] = None) -> None:
    """Clear each global only if still ours (App shutdown must not tear
    down a newer App's plane); stash the journal's final summary for the
    CI artifact dump when it recorded anything; stop the recorder."""
    global _journal, _engine, _recorder
    if journal is not None:
        try:
            doc = journal.summary()
            if doc.get("events_total"):
                with _summaries_lock:
                    _final_summaries.append(doc)
        except Exception:  # noqa: BLE001 — teardown must never fail shutdown
            pass
        if _journal is journal:
            _journal = None
    if engine is not None and _engine is engine:
        _engine = None
    if recorder is not None:
        if _recorder is recorder:
            _recorder = None
        recorder.shutdown()


def get_journal() -> Optional[OpsJournal]:
    return _journal


def get_engine() -> Optional[SloEngine]:
    return _engine


def get_recorder() -> Optional[FlightRecorder]:
    return _recorder


def emit(kind: str, scope: str = "", tenant: Optional[str] = None,
         **detail) -> None:
    """The serving-path journal entry. Disabled => one comparison.
    Exception-guarded HERE, once, so the planes' emission call sites can
    never take down a serving path."""
    j = _journal
    if j is None:
        return
    try:
        j.emit(kind, scope=scope, tenant=tenant, **detail)
    except Exception:  # noqa: BLE001 — the journal must never break serving
        pass


def note_request(outcome: str, dur_ms: float = 0.0,
                 tenant: Optional[str] = None) -> None:
    """The per-request SLO feed (REST/gRPC frontends). Disabled => one
    comparison; exception-guarded like emit()."""
    e = _engine
    if e is None:
        return
    try:
        e.note(outcome, dur_ms, tenant)
    except Exception:  # noqa: BLE001 — SLO accounting must never break serving
        pass


def trigger(cls: str, reason: str = "",
            detail: Optional[dict] = None) -> bool:
    """Fire an incident (asynchronous capture). Disabled => one
    comparison; exception-guarded like emit()."""
    r = _recorder
    if r is None:
        return False
    try:
        return r.trigger(cls, reason=reason, detail=detail)
    except Exception:  # noqa: BLE001 — triggers must never break serving
        return False


def teardown_dump() -> Optional[str]:
    """The SIGTERM/atexit hook (chained by profiling.install_trace_
    teardown): dump a forced ``teardown`` bundle IF a recorder is still
    live — a cleanly shut-down App has already unconfigured, so normal
    exits write nothing; a process dying with a live server preserves its
    evidence."""
    r = _recorder
    if r is None:
        return None
    try:
        return r.dump_now("teardown",
                          reason="process teardown with a live server "
                                 "(SIGTERM/atexit)", force=True)
    except Exception:  # noqa: BLE001 — teardown must never raise
        return None


def emergency_dump(reason: str, directory: Optional[str] = None,
                   detail: Optional[dict] = None) -> Optional[str]:
    """Best-effort bundle for processes without a wired recorder (the
    bench's rc=3 unreachable-device exit, the storm modes): uses the
    configured recorder when one is live (forced), else writes a one-shot
    bundle of whatever plane state this process still holds — including
    the perf/quality/memory ``recent_summaries()`` stashes, which survive
    App teardowns — to ``directory`` (default: $INCIDENT_DIR, else
    ./incidents)."""
    try:
        r = _recorder
        if r is not None:
            return r.dump_now("bench", reason=reason, detail=detail,
                              force=True)
        directory = directory or os.environ.get("INCIDENT_DIR") \
            or "./incidents"
        one_shot = FlightRecorder(directory, journal=_journal,
                                  engine=_engine)
        bundle = one_shot.capture("bench", reason=reason, detail=detail)
        # the module-level stashes outlive any torn-down App: a dying
        # bench session still preserves its duty-cycle/ledger evidence
        for name, mod in (("perf_history", "perf"),
                          ("quality_history", "quality"),
                          ("memory_history", "memory")):
            try:
                import importlib

                m = importlib.import_module(
                    f"weaviate_tpu_torch.monitoring.{mod}")
                hist = m.recent_summaries()
                if hist:
                    bundle[name] = hist
            except Exception:  # noqa: BLE001 — capture what survives
                pass
        return one_shot._write(bundle)
    except Exception:  # noqa: BLE001 — an emergency dump must never raise
        _LOG.warning("emergency incident dump failed", exc_info=True)
        return None


def recent_summaries() -> list:
    """Final journal summaries of Apps torn down this process (newest
    last), plus the live journal's current summary when one is
    installed."""
    with _summaries_lock:
        out = list(_final_summaries)
    j = _journal
    if j is not None:
        try:
            out.append(j.summary())
        except Exception:  # noqa: BLE001
            pass
    return out
