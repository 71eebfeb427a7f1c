# The port's copy of weaviate_tpu/monitoring/metrics.py, its imports pointed at the port.
"""Prometheus metric registry.

Reference: usecases/monitoring/prometheus.go:22-58 — a process-wide singleton
(`GetMetrics`, prometheus.go:70) holding ~40 metric vecs covering batch
durations, object counts, LSM activity, vector-index operations/durations/
tombstones, query durations, the filtered-vector-search phase breakdown
(shard_read.go:236-287), startup and backup timings.

Device-first delta: device-side timings come from whole batched dispatches,
so the per-phase breakdown is {filter, device_search (one metric — upload,
scan and top-k are one dispatch), rescore, hydrate} rather than the
reference's per-edge accounting. Exposition uses prometheus_client; the REST
layer mounts it on PROMETHEUS_MONITORING_PORT like configure_api.go:116-121.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)

_MS_BUCKETS = (0.1, 0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 10000)

# occupancy buckets (requests/rows per coalesced dispatch): powers of two to
# mirror the index's query-padding buckets
_COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class TenantLabeler:
    """Bounded-cardinality mapper from tenant ids to metric label values:
    the top-K tenants by observed traffic get their own label, everyone
    else aggregates under ``other`` — 10k distinct tenants must not mint
    10k prometheus series (graftlint JGL010 is the static twin of this
    runtime bound: label values may never be dynamically-built strings).

    Prometheus series are forever once emitted, so the promotion policy is
    conservative: a tenant is labeled while fewer than ``top_k`` are, and
    afterwards only DISPLACES the weakest labeled tenant when its traffic
    exceeds twice the weakest's — and the total number of tenants ever
    labeled in one process is hard-capped at ``3 * top_k`` (after that the
    set freezes; latecomers stay in ``other``). Traffic counts live in a
    dict pruned to its heaviest half at ``max_tracked``, so memory is
    bounded no matter how many tenant ids a storm invents."""

    OTHER = "other"

    # observations between halvings of every traffic count: ages out a
    # tenant that was heavy long ago, so a CURRENTLY-abusive tenant can
    # displace it within ~one decay window instead of having to out-count
    # its whole lifetime history
    DECAY_EVERY = 50_000

    def __init__(self, top_k: int = 10, max_tracked: int = 4096):
        self.top_k = max(int(top_k), 1)
        self.max_tracked = max(int(max_tracked), 16)
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._labeled: set[str] = set()
        self._ever_labeled = 0
        self._since_decay = 0

    def observe(self, tenant: str) -> str:
        """Count one unit of traffic for `tenant` -> its label value."""
        with self._lock:
            self._since_decay += 1
            if self._since_decay >= self.DECAY_EVERY:
                self._since_decay = 0
                self._counts = {t: c // 2 for t, c in self._counts.items()
                                if c // 2 > 0 or t in self._labeled}
            c = self._counts.get(tenant, 0) + 1
            self._counts[tenant] = c
            if tenant in self._labeled:
                return tenant
            if len(self._labeled) < self.top_k \
                    and self._ever_labeled < 3 * self.top_k:
                self._labeled.add(tenant)
                self._ever_labeled += 1
                return tenant
            if self._ever_labeled < 3 * self.top_k and self._labeled:
                weakest = min(self._labeled,
                              key=lambda t: self._counts.get(t, 0))
                if c > 2 * self._counts.get(weakest, 0):
                    self._labeled.discard(weakest)
                    self._labeled.add(tenant)
                    self._ever_labeled += 1
                    return tenant
            if len(self._counts) > self.max_tracked:
                # keep the heaviest half (labeled tenants always survive)
                keep = sorted(self._counts, key=self._counts.get,
                              reverse=True)[: self.max_tracked // 2]
                self._counts = {t: self._counts[t]
                                for t in set(keep) | self._labeled
                                if t in self._counts}
            return self.OTHER

    def label_for(self, tenant: str) -> str:
        """The label value for `tenant` WITHOUT counting traffic."""
        with self._lock:
            return tenant if tenant in self._labeled else self.OTHER


class Metrics:
    """All metric vecs; label names mirror the reference's (class_name,
    shard_name, operation ...)."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        r = self.registry

        def h(name, doc, labels=()):
            return Histogram(name, doc, labels, registry=r, buckets=_MS_BUCKETS)

        def g(name, doc, labels=()):
            return Gauge(name, doc, labels, registry=r)

        def c(name, doc, labels=()):
            return Counter(name, doc, labels, registry=r)

        # batch / object write path (prometheus.go batch metrics)
        self.batch_durations = h(
            "weaviate_batch_durations_ms", "Batch import phase durations",
            ("operation", "class_name", "shard_name"))
        self.batch_delete_durations = h(
            "weaviate_batch_delete_durations_ms", "Batch delete durations",
            ("class_name", "shard_name"))
        self.objects_durations = h(
            "weaviate_objects_durations_ms", "Single-object op durations",
            ("operation", "step", "class_name", "shard_name"))
        self.object_count = g(
            "weaviate_object_count", "Objects per shard", ("class_name", "shard_name"))

        # queries
        self.queries_count = g(
            "weaviate_concurrent_queries_count", "In-flight queries",
            ("class_name", "query_type"))
        self.query_durations = h(
            "weaviate_queries_durations_ms", "Query durations",
            ("class_name", "query_type"))
        self.query_dimensions = c(
            "weaviate_query_dimensions_total", "Vector dimensions searched",
            ("query_type", "operation", "class_name"))
        # filtered vector search phase breakdown (shard_read.go:236-287)
        self.filtered_vector_filter = h(
            "weaviate_filtered_vector_filter_durations_ms", "allowList build",
            ("class_name", "shard_name"))
        self.filtered_vector_search = h(
            "weaviate_filtered_vector_search_durations_ms",
            "device search dispatch (upload+scan+topk)", ("class_name", "shard_name"))
        self.filtered_vector_rescore = h(
            "weaviate_filtered_vector_rescore_durations_ms", "PQ rescoring pass",
            ("class_name", "shard_name"))
        self.filtered_vector_objects = h(
            "weaviate_filtered_vector_objects_durations_ms", "result hydration",
            ("class_name", "shard_name"))

        # vector index lifecycle (hnsw metrics.go / insert_metrics.go analogs)
        self.vector_index_ops = c(
            "weaviate_vector_index_operations_total", "add/delete/search ops",
            ("operation", "class_name", "shard_name"))
        self.vector_index_durations = h(
            "weaviate_vector_index_durations_ms", "index op durations",
            ("operation", "step", "class_name", "shard_name"))
        self.vector_index_tombstones = g(
            "weaviate_vector_index_tombstones", "live tombstones",
            ("class_name", "shard_name"))
        self.vector_index_tombstone_cleanups = c(
            "weaviate_vector_index_tombstone_cleanup_threads_total",
            "tombstone cleanup runs", ("class_name", "shard_name"))
        self.vector_index_size = g(
            "weaviate_vector_index_size", "index capacity (slots)",
            ("class_name", "shard_name"))
        # per-shard labels so multi-shard classes sum() correctly in prom
        # (a class-only gauge would be overwritten by whichever shard
        # flushed last)
        self.vector_dimensions = g(
            "weaviate_vector_dimensions_sum", "tracked vector dimensions",
            ("class_name", "shard_name"))
        self.vector_segments = g(
            "weaviate_vector_segments_sum", "tracked PQ segments",
            ("class_name", "shard_name"))

        # LSM (prometheus.go lsm metrics)
        self.lsm_active_segments = g(
            "weaviate_lsm_active_segments", "segments per bucket",
            ("strategy", "class_name", "shard_name", "path"))
        self.lsm_segment_objects = g(
            "weaviate_lsm_segment_objects", "entries per segment level",
            ("strategy", "class_name", "shard_name", "path", "level"))
        self.lsm_compactions = c(
            "weaviate_lsm_compactions_total", "compactions run",
            ("strategy", "path"))
        self.lsm_memtable_durations = h(
            "weaviate_lsm_memtable_durations_ms", "memtable op durations",
            ("strategy", "operation"))

        # startup (prometheus.go startup metrics)
        self.startup_durations = h(
            "weaviate_startup_durations_ms", "startup phase durations", ("operation",))
        self.startup_progress = g(
            "weaviate_startup_progress", "0..1 progress", ("operation",))

        # backup
        self.backup_store_durations = h(
            "weaviate_backup_store_ms", "backup store durations",
            ("backend", "class_name"))
        self.backup_restore_durations = h(
            "weaviate_backup_restore_ms", "restore durations",
            ("backend", "class_name"))

        # schema / cluster
        self.schema_tx = c(
            "weaviate_schema_tx_total", "schema transactions", ("type", "status"))
        self.replication_ops = c(
            "weaviate_replication_operations_total", "replication coordinator ops",
            ("operation", "status"))

        # cross-request query coalescer (serving/coalescer.py). Registered
        # here, once, at Metrics construction — the same pattern as
        # weaviate_device_fallback_total: the serving path only ever touches
        # already-registered vecs (inside try/except in the coalescer), so a
        # broken/missing metrics stack can never take down query serving.
        self.coalescer_queue_depth = g(
            "weaviate_coalescer_queue_depth",
            "query rows admission-queued awaiting a coalesced device dispatch")
        self.coalescer_batch_requests = Histogram(
            "weaviate_coalescer_batch_requests",
            "requests per coalesced device dispatch (occupancy)",
            registry=r, buckets=_COUNT_BUCKETS)
        self.coalescer_batch_rows = Histogram(
            "weaviate_coalescer_batch_rows",
            "query rows per coalesced device dispatch (occupancy)",
            registry=r, buckets=_COUNT_BUCKETS)
        self.coalescer_wait = h(
            "weaviate_coalescer_wait_ms",
            "time a request spent in the admission queue before its "
            "dispatch started")
        self.coalescer_bypass = c(
            "weaviate_coalescer_bypass_total",
            "requests that bypassed the coalescer queue to the direct path",
            ("reason",))

        # request tracing (monitoring/tracing.py): exemplar counters so a
        # dashboard sees trace volume/outcomes and the attributed phase
        # shape without scraping /debug/traces. Same registration-once
        # pattern as the coalescer vecs: the tracer only touches
        # already-registered metrics, inside try/except.
        self.traces = c(
            "weaviate_traces_total", "completed request traces",
            ("kind", "outcome"))
        self.trace_phase = h(
            "weaviate_trace_phase_ms",
            "per-request attributed dispatch-phase durations "
            "(device time split across coalesced riders by rows)",
            ("phase",))
        self.trace_dispatch_rows = c(
            "weaviate_trace_dispatch_rows_total",
            "rows in traced device dispatches (actual vs padded — the "
            "fleet-wide padding-waste ratio)", ("kind",))

        # snapshot-isolated read plane (index/gpu.py IndexSnapshot):
        # contention observability for the lock-free search path.
        # Registered once here; the index sets them unguarded, in the same
        # style as its existing gauge updates (_update_index_gauges) —
        # metrics is either None or this working registry.
        self.index_snapshot_gen = g(
            "weaviate_index_snapshot_generation",
            "published device-state snapshot generation (one bump per "
            "writer publication; readers dispatch on it lock-free)",
            ("class_name", "shard_name"))
        self.index_lock_wait = h(
            "weaviate_index_lock_wait_ms",
            "time a snapshot read waited on the index write lock (0 on "
            "the lock-free fast path; nonzero = read-your-writes flush)",
            ("class_name", "shard_name"))
        self.index_inflight_dispatches = g(
            "weaviate_index_inflight_dispatches",
            "search dispatches enqueued on a snapshot but not yet "
            "finalized (the read pipeline's depth)",
            ("class_name", "shard_name"))

        # request-lifecycle robustness (serving/robustness.py): breaker
        # state + shed/deadline counters. Registered once here (the same
        # pattern as the coalescer vecs); the serving path only touches
        # them through exception-guarded helpers.
        self.breaker_state = g(
            "weaviate_breaker_state",
            "device circuit breaker state (0=closed 1=open 2=half-open)")
        self.breaker_transitions = c(
            "weaviate_breaker_transitions_total",
            "device circuit breaker state transitions", ("state",))
        self.requests_shed = c(
            "weaviate_requests_shed_total",
            "requests shed by admission control (429/RESOURCE_EXHAUSTED "
            "with a Retry-After hint)", ("reason",))
        self.deadline_expired = c(
            "weaviate_deadline_expired_total",
            "requests that failed fast on an expired deadline, by the "
            "stage that detected it", ("where",))

        # multi-tenant fairness (serving/coalescer.py weighted-fair
        # admission): per-tenant shed/deadline/queue-depth accounting.
        # EVERY tenant label value is routed through `tenant_labels`
        # (top-K by traffic + "other"), so cardinality stays bounded no
        # matter how many tenant ids traffic invents — the runtime twin
        # of the JGL010 static rule.
        self.tenant_labels = TenantLabeler()
        self.tenant_requests = c(
            "weaviate_tenant_requests_total",
            "requests admitted to the serving path, by (bounded) tenant",
            ("tenant",))
        self.tenant_shed = c(
            "weaviate_tenant_requests_shed_total",
            "requests shed by admission control, by (bounded) tenant — an "
            "abusive tenant's sheds land on ITS label, not the fleet's",
            ("tenant", "reason"))
        self.tenant_deadline = c(
            "weaviate_tenant_deadline_expired_total",
            "requests that failed fast on an expired deadline in the "
            "serving queue, by (bounded) tenant", ("tenant",))
        self.tenant_queued_rows = g(
            "weaviate_tenant_queued_rows",
            "query rows in the serving pipeline per (bounded) tenant, "
            "admission until lane settle — the occupancy the "
            "tenant_budget cap bounds (queue-only depth is "
            "weaviate_coalescer_queue_depth)",
            ("tenant",))

        # continuous device-performance attribution (monitoring/perf.py):
        # rolling-window roofline gauges + the host-overhead ledger's
        # per-dispatch phase shares. Registered once here (the coalescer
        # pattern); the perf window only touches them inside try/except.
        self.device_mfu = g(
            "weaviate_device_mfu_pct",
            "achieved model FLOPs utilization over the rolling perf "
            "window, percent of platform peak (wall-clock form — the "
            "serving-level number; the device-busy form is in "
            "/debug/perf)")
        self.device_hbm_bw = g(
            "weaviate_device_hbm_bw_pct",
            "achieved HBM bandwidth over the rolling perf window, "
            "percent of platform peak")
        self.device_duty_cycle = g(
            "weaviate_device_duty_cycle",
            "fraction of wall-clock with an in-flight device dispatch "
            "(enqueue->fetch intervals, overlap-merged) — low duty at "
            "high kernel MFU = the orchestration gap")
        self.perf_phase_share = Histogram(
            "weaviate_perf_phase_share",
            "per-dispatch share of the host-overhead ledger "
            "(filter/enqueue/device/gather_hop/hydrate) each stage took",
            ("phase",), registry=r,
            buckets=(0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0))

        # front-door tenant concurrency gate (serving/robustness.py
        # TenantConcurrencyGate): aggregate occupancy + refusals. Per-shed
        # tenant attribution already rides weaviate_tenant_requests_shed_
        # total{reason="concurrency"}; these are the label-free gate-level
        # twins an operator alerts on (ROADMAP item 4 follow-up).
        self.tenant_gate_inflight = g(
            "weaviate_tenant_gate_inflight",
            "requests currently holding a tenant-gate concurrency slot, "
            "summed over tenants")
        self.tenant_gate_shed = c(
            "weaviate_tenant_gate_shed_total",
            "requests refused at the front-door tenant concurrency gate "
            "(also counted per tenant/reason in the shed vecs)")

        # online quality observability (monitoring/quality.py): the shadow
        # recall auditor's rolling estimates + audit accounting. Tier label
        # values come from the costmodel TIER_* enum (bounded; JGL010-
        # clean); the auditor only touches these inside try/except.
        self.recall_at_k = g(
            "weaviate_recall_at_k",
            "EWMA recall@k of shadow-audited live searches vs the exact "
            "host plane, per dispatch tier (1.0 = every audited answer "
            "was exact)", ("tier",))
        self.distance_relerr = g(
            "weaviate_distance_relerr",
            "mean rank-aligned relative distance error of shadow-audited "
            "live searches vs the exact host plane, per dispatch tier",
            ("tier",))
        self.quality_audits = c(
            "weaviate_quality_audits_total",
            "shadow recall audits by outcome (ok / shed = dropped under "
            "the drop-not-queue budget / deadline = host scan over its "
            "audit budget / error)", ("outcome",))
        self.quality_audit_lag = h(
            "weaviate_quality_audit_lag_ms",
            "time between a sampled dispatch's finalize and its audit "
            "completing (how stale the recall estimate runs)")
        self.quality_degraded = c(
            "weaviate_quality_degraded_total",
            "degradation alerts: a tier's EWMA recall crossed below "
            "RECALL_ALERT_THRESHOLD (one increment per transition; the "
            "log line is rate-limited separately)", ("tier",))

        # cheap always-on index health (stamped on the write path by
        # index/gpu.py _update_index_gauges — independent of tracing and
        # auditing, so /debug/index and /metrics report health even with
        # both planes disabled)
        self.vector_index_live = g(
            "weaviate_vector_index_live_count", "live (non-tombstoned) "
            "vectors per shard", ("class_name", "shard_name"))
        self.index_tombstone_fraction = g(
            "weaviate_index_tombstone_fraction",
            "tombstoned fraction of the shard's occupied slots — creeping "
            "growth after deletes is the compaction-debt signal",
            ("class_name", "shard_name"))

        # memory & capacity observability (monitoring/memory.py): the
        # device/host/disk byte ledger's bounded component gauges + the
        # write-path lifecycle + exhaustion alerting. Component label
        # values come from the memory.DEVICE_COMPONENTS/HOST_COMPONENTS/
        # DISK_COMPONENTS taxonomies (bounded; foreign names fold into
        # "other" — JGL010-clean); the ledger only touches these inside
        # try/except.
        self.device_bytes = g(
            "weaviate_device_bytes",
            "HBM bytes the ledger accounts per buffer component "
            "(analytic shape x dtype at snapshot publish — equals the "
            "buffers' nbytes exactly; zero device syncs)", ("component",))
        self.host_bytes = g(
            "weaviate_host_bytes",
            "host RAM bytes the ledger accounts per consumer component "
            "(slot/tombstone mirrors, PQ host rows, staged rows, breaker "
            "fallback rows, auditor rows, allowList cache)", ("component",))
        self.disk_bytes = g(
            "weaviate_disk_bytes",
            "data-volume bytes (used/free) so device/host/disk capacity "
            "read from one dashboard", ("component",))
        self.memory_headroom = g(
            "weaviate_memory_headroom_pct",
            "remaining capacity percentage per scope (device HBM vs the "
            "backend's bytes_limit, host vs MemTotal, disk vs the data "
            "volume) — the number the exhaustion alert thresholds",
            ("scope",))
        self.write_flush = h(
            "weaviate_write_flush_ms",
            "write-path flush/device-write durations (staged rows landing "
            "on device, COW copy included)")
        self.cow_copy_bytes = c(
            "weaviate_cow_copy_bytes_total",
            "host bytes duplicated by copy-on-write so a published "
            "snapshot's pinned arrays are never mutated under a reader")
        self.memory_alerts = c(
            "weaviate_memory_exhaustion_alerts_total",
            "memory-headroom degradation alerts per scope (one increment "
            "per below-threshold transition; the log line is rate-limited "
            "separately)", ("scope",))
        self.memory_drift = g(
            "weaviate_memory_ledger_drift_bytes",
            "allocator-reported bytes_in_use minus the ledger's analytic "
            "per-device total where the backend provides memory_stats() — "
            "a cross-check gauge, never the primary accounting", ("scope",))

        # incident flight recorder + SLO burn-rate engine (monitoring/
        # incidents.py): the ops-event journal's bounded kind counter, the
        # config-declared SLOs' multi-window burn gauges, and the bundle
        # counter. Label values are bounded taxonomies (incidents.EVENT_
        # KINDS / INCIDENT_CLASSES, with foreign values folded to "other";
        # SLO names are built once at engine init from config) — the
        # JGL010 discipline, with JGL013 as the journal's static twin;
        # the incident plane only touches these inside try/except.
        self.ops_events = c(
            "weaviate_ops_events_total",
            "structured ops-journal events by (bounded) kind — breaker "
            "transitions, shed bursts, quality/memory alerts, jit "
            "compiles, device fallbacks, SLO burns (monitoring/"
            "incidents.py)", ("kind",))
        self.slo_burn_rate = g(
            "weaviate_slo_burn_rate",
            "error-budget burn rate per SLO and window (5m fast / 1h "
            "slow): bad-request fraction over the window divided by the "
            "SLO's error budget — 1.0 spends budget exactly at the "
            "sustainable rate", ("slo", "window"))
        self.slo_budget_remaining = g(
            "weaviate_slo_error_budget_remaining",
            "error budget left over the trailing 1h window per SLO "
            "(1.0 = untouched, 0.0 = the hour's budget is gone)",
            ("slo",))
        self.incident_bundles = c(
            "weaviate_incident_bundles_total",
            "flight-recorder bundles written to INCIDENT_DIR, by "
            "(bounded) incident class", ("class",))

        # self-tuning control plane (serving/controller.py): knob names
        # and controller names are FIXED sets (controller.KNOB_NAMES /
        # the four controllers) — bounded by construction, the JGL010
        # discipline; all writes ride the tick thread inside try/except.
        self.controller_brownout_stage = g(
            "weaviate_controller_brownout_stage",
            "current brownout-ladder stage (0 = normal serving, 1 = "
            "tightened admission margins, 2 = shrunken tenant budgets + "
            "scaled Retry-After, 3 = optional work paused)")
        self.controller_knob = g(
            "weaviate_controller_knob",
            "current value of each controller-actuated serving knob "
            "(equals its configured default while unactuated)", ("knob",))
        self.controller_actuations = c(
            "weaviate_controller_actuations_total",
            "knob actuations applied, per controller (brownout / budget "
            "/ lanes / rate)", ("controller",))

        # device-dispatch degradation (graftlint JGL004): every path that
        # silently falls back from the device to a host engine counts here, so
        # a fleet serving at CPU speed is visible on a dashboard instead of
        # only in a benchmark regression
        self.device_fallbacks = c(
            "weaviate_device_fallback_total",
            "device dispatches that degraded to a host fallback",
            ("component", "reason"))

    def expose(self) -> bytes:
        """Text exposition (the /metrics handler body)."""
        return generate_latest(self.registry)


_lock = threading.Lock()
_instance: Optional[Metrics] = None


def get_metrics() -> Metrics:
    """Process-wide singleton (GetMetrics, prometheus.go:70)."""
    global _instance
    with _lock:
        if _instance is None:
            _instance = Metrics()
        return _instance


def noop_metrics() -> Metrics:
    """Fresh isolated registry (tests / embedded use)."""
    return Metrics(CollectorRegistry())


# -- device-fallback observability (graftlint JGL004) -------------------------

FALLBACK_LOG_INTERVAL_S = 60.0

_fallback_log_lock = threading.Lock()
_fallback_last_log: dict[tuple[str, str], float] = {}


def record_device_fallback(
    component: str,
    reason: str,
    exc: Optional[BaseException] = None,
    *,
    note: str = "",
    log: bool = True,
    interval: float = FALLBACK_LOG_INTERVAL_S,
) -> bool:
    """Make host degradation observable: ALWAYS increment the fallback
    counter, and log at most once per (component, reason) per `interval`
    seconds so a hot loop that falls back per request cannot flood the log.
    Callers that already emit a richer one-shot message pass log=False and
    still get counted. -> True when a log line was emitted."""
    get_metrics().device_fallbacks.labels(
        component=component, reason=reason).inc()
    if not log:
        return False
    now = time.monotonic()
    with _fallback_log_lock:
        last = _fallback_last_log.get((component, reason))
        if last is not None and now - last < interval:
            return False
        _fallback_last_log[(component, reason)] = now
    detail = f" ({type(exc).__name__}: {exc})" if exc is not None else ""
    logging.getLogger("weaviate_tpu_torch.monitoring.fallback").warning(
        "device dispatch degraded to host fallback: component=%s reason=%s%s%s"
        " — further occurrences are counted in weaviate_device_fallback_total"
        " and logged at most every %.0fs",
        component, reason, detail, f" [{note}]" if note else "", interval)
    return True
