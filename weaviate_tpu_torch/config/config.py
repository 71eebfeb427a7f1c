# The port's copy of weaviate_tpu/config/config.py, its imports pointed at the port.
"""Environment-driven server configuration.

Reference: usecases/config/environment.go (env parsing) +
config_handler.go:73-99 (the Config struct) — the full env surface is listed
in SURVEY.md Appendix A. Same variable names, same defaults; the device
extensions (device mesh shape, store dtype) are additive.

The port reads the env surface letter for letter. Two knobs name parts it
does not serve yet, and the port's App refuses them (`server/app.py`):
IVF_ENABLED (ROADMAP queue 1 item 9) and TPU_DEVICE_MESH_SHARDS > 1
(item 10). The index reads the control plane's recall-guarded budgets
(`serving/controller.py`) as the reference's does; without a plane
installed each cap is its ladder's top bucket.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Mapping, Optional

from weaviate_tpu_torch.entities.vectorindex import STORE_DTYPES


class ConfigError(ValueError):
    pass


# The ONE table of PQ fast-scan candidate-depth buckets. Two consumers
# import it and may never drift apart (the fused-dispatch satellite):
#   - serving/controller.py's recall-guarded budget controller steps the
#     rescore_r cap DOWN this ladder (and snaps operator overrides to it);
#   - index/gpu.py's `_rescore_r` / codes-tier pool sizing treat the top
#     bucket as the static maximum and clamp against the controller cap.
# Because every cap value is a bucket and the index's own static choices
# are {max(4k, 32)} ∪ buckets, a controller cut can never mint a jit
# shape the static path wouldn't also compile.
RESCORE_R_BUCKETS = (32, 48, 64, 96, 128)

# The ONE table of IVF probe-count buckets (ROADMAP item 3). Same
# discipline as RESCORE_R_BUCKETS, same two consumers:
#   - serving/controller.py's recall-guarded budget controller steps the
#     ivf_top_p cap DOWN this ladder (the second recall-guarded knob);
#   - index/gpu.py snaps every effective probe count to a bucket (or to
#     nlist exactly when the request covers all partitions), so top_p —
#     a jit static argument — can only take bounded values and a
#     controller cut can never mint a jit shape the static path
#     wouldn't also compile.
# ~1.5x steps up to the 4096 auto-nlist ceiling: the budget controller's
# one-bucket-per-hold-period gradualism must hold for large layouts too
# (a ladder topping out at 128 would make the first cut on a 256-probe
# layout a 2.7x jump)
IVF_TOP_P_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                     192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)

# The ONE table of 4-bit funnel stage-C buckets (the pq.bits=4 three-stage
# re-ranking funnel's FIRST budget: how many 4-bit ADC scan survivors reach
# the 8-bit reconstruction rescore). Same discipline and the same two
# consumers as RESCORE_R_BUCKETS:
#   - serving/controller.py's recall-guarded budget controller steps the
#     funnel_c cap DOWN this ladder (the third recall-guarded knob);
#   - index/gpu.py's funnel planner snaps C to a bucket (clamped to the
#     candidate-set size), and the fused kernel keeps C/G whole groups, so
#     a controller cut can never mint a jit shape the static path wouldn't
#     also compile. Values are multiples of the group width G=16.
PQ4_FUNNEL_C_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)

# The ONE table of 4-bit funnel stage-c buckets (the funnel's SECOND
# budget: how many 8-bit rescore survivors reach the final bf16/exact
# rescore). Mirrors RESCORE_R_BUCKETS — the two knobs are the same kind of
# recall-budget, one per funnel hand-off.
PQ4_FUNNEL_RESCORE_BUCKETS = (32, 48, 64, 96, 128, 192, 256)


def _bool(env: Mapping[str, str], key: str, default: bool = False) -> bool:
    v = env.get(key)
    if v is None:
        return default
    return v.strip().lower() in ("true", "enabled", "on", "1")


def store_dtype_from_env(env: Mapping[str, str]) -> str:
    """TPU_STORE_DTYPE (float32 by default), checked as Config.validate
    checks it; a class's `storeDtype` is what an index reads."""
    v = env.get("TPU_STORE_DTYPE", "float32")
    if v not in STORE_DTYPES:
        raise ValueError("STORE_DTYPE must be float32|bfloat16")
    return v


def _int(env: Mapping[str, str], key: str, default: int) -> int:
    v = env.get(key)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ConfigError(f"invalid {key}: {v!r} (want int)") from None


def _float(env: Mapping[str, str], key: str, default: float) -> float:
    v = env.get(key)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ConfigError(f"invalid {key}: {v!r} (want float)") from None


def _list(env: Mapping[str, str], key: str) -> list[str]:
    v = env.get(key, "")
    return [s.strip() for s in v.split(",") if s.strip()]


@dataclass
class AnonymousAccess:
    enabled: bool = True  # environment.go default: anonymous on unless auth set


@dataclass
class APIKeyAuth:
    enabled: bool = False
    allowed_keys: list[str] = field(default_factory=list)
    users: list[str] = field(default_factory=list)  # positional key->user map


@dataclass
class OIDCAuth:
    enabled: bool = False
    issuer: str = ""
    client_id: str = ""
    username_claim: str = "sub"
    groups_claim: str = ""
    skip_client_id_check: bool = False


@dataclass
class AuthConfig:
    anonymous: AnonymousAccess = field(default_factory=AnonymousAccess)
    apikey: APIKeyAuth = field(default_factory=APIKeyAuth)
    oidc: OIDCAuth = field(default_factory=OIDCAuth)

    def validate(self) -> None:
        if self.apikey.enabled:
            if not self.apikey.allowed_keys:
                raise ConfigError(
                    "AUTHENTICATION_APIKEY_ENABLED requires AUTHENTICATION_APIKEY_ALLOWED_KEYS")
            if not self.apikey.users:
                raise ConfigError(
                    "AUTHENTICATION_APIKEY_ENABLED requires AUTHENTICATION_APIKEY_USERS")
            if len(self.apikey.users) not in (1, len(self.apikey.allowed_keys)):
                raise ConfigError(
                    "AUTHENTICATION_APIKEY_USERS must have one user or one per key")


@dataclass
class AuthzConfig:
    admin_list_enabled: bool = False
    admin_users: list[str] = field(default_factory=list)
    readonly_users: list[str] = field(default_factory=list)


@dataclass
class ClusterConfig:
    hostname: str = ""
    gossip: bool = False  # UDP gossip membership (seed nodes set this too)
    gossip_bind_port: int = 7946
    data_bind_port: int = 7947
    join: list[str] = field(default_factory=list)
    ignore_schema_sync: bool = False


@dataclass
class PersistenceConfig:
    data_path: str = "./data"
    memtables_max_size_mb: int = 200
    memtables_min_active_seconds: int = 10
    memtables_max_active_seconds: int = 300
    flush_idle_memtables_after: int = 60


@dataclass
class MonitoringConfig:
    enabled: bool = False
    port: int = 2112
    group_classes: bool = False


@dataclass
class DiskUseConfig:
    warning_percentage: int = 80
    readonly_percentage: int = 90


@dataclass
class MemUseConfig:
    warning_percentage: int = 80
    readonly_percentage: int = 0  # 0 = disabled (environment.go default)


@dataclass
class CoalescerConfig:
    """Cross-request query coalescing (serving/coalescer.py). TPU extension:
    concurrent single-query kNN requests admission-queue per
    (shard, k, metric, filter-signature) lane and flush as one padded
    device dispatch on bucket-fill or deadline. Disabled => the serving
    path is byte-for-byte the direct dispatch (zero queue hops)."""

    enabled: bool = False
    window_ms: float = 1.5        # deadline flush window per lane
    max_batch: int = 256          # rows that force an immediate flush
    max_request_rows: int = 16    # wider requests bypass to the direct path
    # admission control (serving/robustness.py): the queue bound is
    # cost-aware — queued ROWS, not requests — and overflow sheds with
    # 429/RESOURCE_EXHAUSTED + Retry-After instead of silently stalling
    max_queued_rows: int = 4096
    # liveness bound on a queued request's wait for its coalesced result:
    # even with no deadline set, a wedged flush thread can only cost a
    # client this long before the request falls back to the direct path
    wait_timeout_s: float = 30.0
    # lanes in flight between async enqueue and finalize. With the
    # snapshot-isolated read path (PR 4) finalize no longer contends with
    # the next lane's enqueue on an index lock, but on a CPU backend two
    # in-flight scans still contend for host cores — depth 1 (the flusher's
    # stall IS the backpressure that fills lanes) remains the measured
    # default; a real TPU backend is the case for 2.
    pipeline_depth: int = 1


@dataclass
class TracingConfig:
    """End-to-end request tracing (monitoring/tracing.py). TPU extension:
    per-request span trees with device-time attribution across coalesced
    dispatches, a /debug/traces ring buffer, and a slow-query JSON log.
    Disabled => no tracer object anywhere on the serving path (the module
    global stays None; every tracing entry point is a one-comparison
    no-op)."""

    enabled: bool = False
    sample_rate: float = 1.0      # fraction of requests traced (0..1)
    ring_size: int = 256          # completed traces kept for /debug/traces
    slow_query_threshold_ms: float = 1000.0  # <=0 disables the slow log
    # rolling window of the perf-attribution plane (monitoring/perf.py):
    # /debug/perf summaries, duty cycle, and the roofline gauges aggregate
    # over this many trailing seconds. Rides TRACING_ENABLED.
    perf_window_s: float = 60.0


@dataclass
class RobustnessConfig:
    """Request-lifecycle robustness (serving/robustness.py). TPU extension:
    end-to-end deadlines, a device circuit breaker with a host fallback
    plane, and the fault-injection harness gate (testing/faults.py)."""

    # default per-request deadline when the caller sends none
    # (X-Request-Timeout-Ms / gRPC deadline override it). 0 = unbounded.
    query_timeout_ms: float = 0.0
    breaker_enabled: bool = True
    breaker_failure_threshold: int = 5   # consecutive device errors to trip
    breaker_reset_ms: float = 2000.0     # OPEN cooldown before half-open
    breaker_half_open_probes: int = 1    # concurrent probe dispatches
    # fault-injection spec (testing/faults.py from_spec); "" = harness off
    # (the module global stays None; every injection point is a
    # one-comparison no-op)
    fault_injection: str = ""
    fault_injection_seed: int = 0


@dataclass
class QualityConfig:
    """Online quality observability (monitoring/quality.py). TPU
    extension: a shadow recall auditor re-executes a sampled fraction of
    completed live searches against the exact host plane (snapshot-
    generation-pinned) and reports recall@k / rank-biased overlap /
    distance error into ``GET /debug/quality`` and bounded-label gauges.
    Disabled (sample rate 0, the default) => no auditor object anywhere
    on the serving path (the module global stays None; every capture
    point is a one-comparison no-op)."""

    # fraction of completed live searches shadow-audited (0..1); 0 = off
    audit_sample_rate: float = 0.0
    # background audit worker threads (hard concurrency budget); the
    # pending queue is bounded to the same number — overflow DROPS the
    # sample (counted), never queues behind live load
    audit_concurrency: int = 1
    # query rows audited per sampled dispatch (a wide coalesced batch
    # audits a uniform row subset)
    audit_max_rows: int = 64
    # per-audit budget for the host-plane scan; the scan streams row
    # chunks and abandons the audit when over (counted). <= 0 = unbounded
    audit_deadline_ms: float = 1000.0
    # rolling QualityWindow horizon for /debug/quality and the gauges
    window_s: float = 300.0
    # per-tier EWMA recall below this fires the degradation alert
    alert_threshold: float = 0.95
    # audited dispatches of a tier before its EWMA may alert (a cold
    # EWMA over two samples is noise, not a regression)
    alert_min_samples: int = 20


@dataclass
class MemoryLedgerConfig:
    """Memory & capacity observability (monitoring/memory.py). TPU
    extension: an always-on device/host/disk byte ledger stamped
    analytically at every index-snapshot publish (zero device syncs),
    write-path lifecycle instrumentation, and a time-to-exhaustion
    forecast with fire-once headroom alerts at ``GET /debug/memory``.
    Disabled => no ledger object anywhere on the write path (the module
    global stays None; every stamping entry point is a one-comparison
    no-op)."""

    ledger_enabled: bool = True
    # rolling window for write-phase percentiles / COW peaks / forecast
    window_s: float = 300.0
    # headroom percentage below which a scope fires its exhaustion alert
    headroom_alert_pct: float = 10.0
    # per-device HBM budget override; 0 = autodetect from the backend's
    # memory_stats()['bytes_limit'] (0 when the backend reports none)
    device_budget_bytes: int = 0
    # host RAM budget override; 0 = autodetect from /proc/meminfo MemTotal
    host_budget_bytes: int = 0


@dataclass
class IncidentsConfig:
    """Incident flight recorder + SLO burn-rate engine (monitoring/
    incidents.py). TPU extension: a bounded ops-event journal fed by
    every plane's state transitions, config-declared availability/
    latency SLOs evaluated into 5m/1h burn rates, and trigger-driven
    post-mortem bundles (perf/quality/memory/trace/journal state) dumped
    to ``INCIDENT_DIR``. Disabled => no journal/engine/recorder object
    anywhere on the serving path (the module globals stay None; every
    entry point is a one-comparison no-op)."""

    enabled: bool = True
    # ops-journal ring size (events retained for /debug/incidents and
    # bundle tails; burst kinds coalesce so a storm is one entry)
    journal_size: int = 512
    # bundle directory; "" = <data_path>/incidents
    dir: str = ""
    # disk budget for the bundle directory: oldest bundles pruned past
    # this (accounted in the memory ledger's disk scope). 0 = unbounded.
    dir_max_bytes: int = 64 * 1024 * 1024
    # min seconds between bundles of one incident class (teardown/manual
    # dumps are forced and exempt)
    rate_limit_s: float = 300.0
    # availability SLO: the fraction of serving requests that must not
    # shed/expire/error (bad fraction / (1-target) = burn rate)
    slo_availability_target: float = 0.999
    # latency SLO: p99 target in ms over completed requests; 0 disables
    # the latency objective (there is no universally right target)
    slo_latency_p99_ms: float = 0.0
    # burn-rate alert thresholds for the 5m (fast) and 1h (slow) windows
    # (14.4/3.0: the SRE-workbook pairing — a cliff vs a smolder)
    slo_fast_burn: float = 14.4
    slo_slow_burn: float = 3.0
    # requests a window must hold before its burn rate may alert (a cold
    # window over two requests is noise, not an incident)
    slo_min_events: int = 20
    # "tenantA=0.999,tenantB=0.99" — per-tenant availability overrides;
    # each adds ONE bounded SLO series (config-sized, never traffic-sized)
    slo_tenant_targets: dict = field(default_factory=dict)


@dataclass
class IvfConfig:
    """Partition-pruned search: the clustered IVF scan plane with a
    low-dim PCA prefilter (index/gpu.py + ops/ivf.py, ROADMAP item 3).
    TPU extension: a k-means partition layout trained on the write path
    (assignments ride the staged-generation snapshot handshake, stored
    as padded partition buckets so jit shapes stay cached across
    inserts); at query time a cheap centroid scan probes the top-P
    partitions and only their buckets are scored, making per-dispatch
    scan cost sublinear in N. Disabled (the default) => a true zero-hop
    no-op: no centroids/buckets/PCA slabs exist anywhere, the write path
    never trains, and every dispatch-path gate is one comparison."""

    enabled: bool = False     # IVF_ENABLED
    # partitions; 0 = auto: ~256 rows per partition, ceil-pow2-snapped,
    # clamped 16..4096 (the host k-means budget — index/gpu.py
    # _ivf_nlist; fill-targeted sizing measured 2-4x better than
    # sqrt(n) in both probe recall and probed_fraction)
    nlist: int = 0            # IVF_NLIST
    # partitions probed per query; 0 = auto (nlist/16, min 1). Snapped to
    # IVF_TOP_P_BUCKETS; the controller's recall-guarded budget may cut
    # it further down the same ladder, never raise it.
    top_p: int = 0            # IVF_TOP_P
    # rows before the first k-means training pass (an IVF layout over a
    # few thousand rows costs more in probe overhead than it prunes)
    min_n: int = 20000        # IVF_MIN_N
    # PCA prefilter subspace dims; 0 = prefilter off
    pca_dim: int = 0          # IVF_PCA_DIM
    # candidates surviving the PCA prefilter per query; 0 = auto
    # (max(8k, probed/8), pow2-snapped). Only meaningful with pca_dim>0.
    prefilter_c: int = 0      # IVF_PREFILTER_C
    # k-means training sample / iterations (bounded — training must stay
    # a write-path pause, not an offline job)
    train_sample: int = 65536  # IVF_TRAIN_SAMPLE
    train_iters: int = 6       # IVF_TRAIN_ITERS
    # recluster (full retrain) once n outgrows the trained layout by
    # this fraction; between retrains new rows are assigned to the
    # existing centroids incrementally
    retrain_growth: float = 0.5  # IVF_RETRAIN_GROWTH


@dataclass
class ControllerConfig:
    """Self-tuning degradation control plane (serving/controller.py).
    TPU extension: four clamped sense->decide->actuate->journal
    controllers on one supervised tick thread — burn-rate brownout
    (SLO burn -> a staged degradation ladder), a recall-guarded PQ
    candidate budget (the shadow auditor's recall EWMA -> the fast-scan
    ``rescore_r`` cap), coalescer window/pipeline-depth steering (the
    perf window's duty-cycle/queue-wait split), and per-tenant
    token-bucket rate quotas. Disabled (the default) => no plane object
    anywhere (the module global stays None; every knob reader on the
    serving path is a one-comparison no-op returning its configured
    default)."""

    enabled: bool = False           # CONTROL_PLANE_ENABLED
    # seconds between control ticks; knob leases expire at ~8 ticks, so
    # a stalled thread fail-statics in bounded time
    tick_s: float = 1.0
    # consecutive qualifying ticks before a held actuation applies (and
    # before the brownout ladder steps DOWN) — the hysteresis that keeps
    # a square-wave signal from flapping the knobs
    hold_ticks: int = 3
    # per-controller kill switches (the whole plane gates on `enabled`)
    brownout_enabled: bool = True   # CONTROLLER_BROWNOUT_ENABLED
    budget_enabled: bool = True    # CONTROLLER_BUDGET_ENABLED
    lanes_enabled: bool = True     # CONTROLLER_LANES_ENABLED
    # brownout: burn thresholds the ladder reacts to (defaults mirror
    # the SLO engine's alert pair) and the per-stage knob values
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 3.0
    brownout_margin: float = 2.0       # stage 1: admission-estimate x
    brownout_cap_scale: float = 0.5    # stage 2: tenant row cap x
    brownout_retry_scale: float = 2.0  # stage 2: Retry-After hints x
    brownout_rate_scale: float = 0.5   # stage 2: rate-quota refill x
    # recall-guarded budget: the EWMA floor the bench/acceptance pins,
    # the slack that must exist before a cut, the margin that forces an
    # immediate back-off, and the per-tier sample count before acting
    recall_floor: float = 0.98
    recall_slack: float = 0.015
    recall_backoff_margin: float = 0.005
    recall_min_samples: int = 8
    # lane steering: the clamp band for the coalescer flush window, the
    # pipeline-depth ceiling, and the duty-cycle hysteresis bands
    window_min_ms: float = 0.5
    window_max_ms: float = 6.0
    depth_max: int = 2
    duty_hi: float = 0.85
    duty_lo: float = 0.3
    # per-tenant token-bucket rate quotas: base QPS (x the tenant's DRR
    # weight); 0 = quota off. Enforced at coalescer admission while the
    # control plane is enabled, shedding `tenant_rate` with
    # Retry-After = time-to-next-token.
    tenant_rate_qps: float = 0.0   # TENANT_RATE_QPS
    tenant_rate_burst_s: float = 2.0  # TENANT_RATE_BURST_S


def _tenant_targets(env: Mapping[str, str], key: str) -> dict:
    """Parse "a=0.999,b=0.99" into {tenant: float target in (0,1)};
    reject malformed entries at startup, not at the first request."""
    out: dict = {}
    for item in _list(env, key):
        if "=" not in item:
            raise ConfigError(
                f"invalid {key} entry {item!r} (want tenant=target)")
        name, t = item.split("=", 1)
        name = name.strip()
        try:
            target = float(t)
        except ValueError:
            raise ConfigError(
                f"invalid {key} target for {name!r}: {t!r}") from None
        if not name or not (0.0 < target < 1.0):
            raise ConfigError(
                f"invalid {key} entry {item!r} (want nonempty tenant, "
                "target in (0, 1))")
        out[name] = target
    return out


@dataclass
class TenancyConfig:
    """Multi-tenant fairness (serving/coalescer.py weighted-fair
    admission + monitoring/metrics.py bounded tenant labels). TPU
    extension: tenant identity defaults to the queried class name and is
    overridable per request via REST ``X-Tenant-Id`` / gRPC
    ``x-tenant-id`` metadata."""

    # "tenantA=4,tenantB=2" — DRR weights; unlisted tenants weigh 1
    weights: dict = field(default_factory=dict)
    # the fraction of QUERY_COALESCER_MAX_QUEUED_ROWS one tenant may
    # occupy while OTHER tenants have rows waiting (alone it may use the
    # whole queue); overflow sheds that tenant with `tenant_budget`
    max_queued_rows_fraction: float = 0.5
    # per-tenant metric labels: the top-K tenants by traffic get their
    # own label value, the rest aggregate under "other" (bounded
    # prometheus cardinality no matter how many tenant ids exist)
    metrics_top_k: int = 10
    # front-door bound on ONE tenant's concurrent in-server requests
    # (explicit X-Tenant-Id traffic): excess sheds with 429/
    # RESOURCE_EXHAUSTED before any per-request work. 0 = disabled.
    max_concurrent_requests: int = 0


def _tenant_weights(env: Mapping[str, str], key: str) -> dict:
    """Parse "a=4,b=2" into {tenant: float}; reject non-positive or
    malformed entries at startup, not at the first admission."""
    out: dict = {}
    for item in _list(env, key):
        if "=" not in item:
            raise ConfigError(
                f"invalid {key} entry {item!r} (want tenant=weight)")
        name, w = item.split("=", 1)
        name = name.strip()
        try:
            weight = float(w)
        except ValueError:
            raise ConfigError(
                f"invalid {key} weight for {name!r}: {w!r}") from None
        if not name or weight <= 0:
            raise ConfigError(
                f"invalid {key} entry {item!r} (want nonempty tenant, "
                "weight > 0)")
        out[name] = weight
    return out


@dataclass
class AutoSchemaConfig:
    enabled: bool = True
    default_string: str = "text"
    default_number: str = "number"
    default_date: str = "date"


@dataclass
class Config:
    """config_handler.go:73-99 twin."""

    persistence: PersistenceConfig = field(default_factory=PersistenceConfig)
    auth: AuthConfig = field(default_factory=AuthConfig)
    authz: AuthzConfig = field(default_factory=AuthzConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    disk_use: DiskUseConfig = field(default_factory=DiskUseConfig)
    mem_use: MemUseConfig = field(default_factory=MemUseConfig)
    auto_schema: AutoSchemaConfig = field(default_factory=AutoSchemaConfig)

    origin: str = ""
    enable_modules: list[str] = field(default_factory=list)
    default_vectorizer_module: str = "none"
    default_vector_distance_metric: str = ""
    query_defaults_limit: int = 25
    query_maximum_results: int = 10000
    max_import_goroutines_factor: float = 1.5
    maximum_concurrent_get_requests: int = 0  # 0 = unlimited
    track_vector_dimensions: bool = False
    reindex_vector_dimensions_at_startup: bool = False
    index_missing_text_filterable_at_startup: bool = False
    grpc_port: int = 50051
    contextionary_url: str = ""
    backup_filesystem_path: str = ""

    # TPU extensions
    device_mesh_shards: int = 0  # 0 = one shard per local device
    store_dtype: str = "float32"
    # fully fused device dispatch (index/gpu.py): final top-k ->
    # tombstone/allowList masking -> slot->doc translation run in ONE XLA
    # program, so a search's single packed fetch carries final doc ids
    # and finalize() does zero host translation. Off = the legacy host
    # slot_to_doc path (the bench's --fused A/B lever)
    fused_dispatch_enabled: bool = True
    ivf: IvfConfig = field(default_factory=IvfConfig)
    coalescer: CoalescerConfig = field(default_factory=CoalescerConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    robustness: RobustnessConfig = field(default_factory=RobustnessConfig)
    tenancy: TenancyConfig = field(default_factory=TenancyConfig)
    quality: QualityConfig = field(default_factory=QualityConfig)
    memory: MemoryLedgerConfig = field(default_factory=MemoryLedgerConfig)
    incidents: IncidentsConfig = field(default_factory=IncidentsConfig)
    controller: ControllerConfig = field(default_factory=ControllerConfig)

    def validate(self) -> None:
        self.auth.validate()
        if self.query_defaults_limit < 1:
            raise ConfigError("QUERY_DEFAULTS_LIMIT must be >= 1")
        if self.query_maximum_results < 1:
            raise ConfigError("QUERY_MAXIMUM_RESULTS must be >= 1")
        if not (0 <= self.disk_use.warning_percentage <= 100):
            raise ConfigError("DISK_USE_WARNING_PERCENTAGE must be 0..100")
        if not (0 <= self.disk_use.readonly_percentage <= 100):
            raise ConfigError("DISK_USE_READONLY_PERCENTAGE must be 0..100")
        if self.store_dtype not in ("float32", "bfloat16"):
            raise ConfigError("STORE_DTYPE must be float32|bfloat16")
        ivf = self.ivf
        if ivf.nlist < 0:
            raise ConfigError("IVF_NLIST must be >= 0 (0 = auto)")
        if ivf.top_p < 0:
            raise ConfigError("IVF_TOP_P must be >= 0 (0 = auto)")
        if ivf.min_n < 1:
            raise ConfigError("IVF_MIN_N must be >= 1")
        if ivf.pca_dim < 0:
            raise ConfigError("IVF_PCA_DIM must be >= 0 (0 = prefilter off)")
        if ivf.prefilter_c < 0:
            raise ConfigError("IVF_PREFILTER_C must be >= 0 (0 = auto)")
        if ivf.train_sample < 256:
            raise ConfigError("IVF_TRAIN_SAMPLE must be >= 256")
        if ivf.train_iters < 1:
            raise ConfigError("IVF_TRAIN_ITERS must be >= 1")
        if ivf.retrain_growth <= 0:
            raise ConfigError("IVF_RETRAIN_GROWTH must be > 0")
        if self.coalescer.window_ms < 0:
            raise ConfigError("QUERY_COALESCER_WINDOW_MS must be >= 0")
        if self.coalescer.max_batch < 2:
            raise ConfigError("QUERY_COALESCER_MAX_BATCH must be >= 2")
        if not (1 <= self.coalescer.max_request_rows
                <= self.coalescer.max_batch):
            raise ConfigError(
                "QUERY_COALESCER_MAX_REQUEST_ROWS must be in "
                "[1, QUERY_COALESCER_MAX_BATCH]")
        if self.coalescer.pipeline_depth < 1:
            raise ConfigError("QUERY_COALESCER_PIPELINE_DEPTH must be >= 1")
        if self.coalescer.max_queued_rows < 1:
            raise ConfigError("QUERY_COALESCER_MAX_QUEUED_ROWS must be >= 1")
        if self.coalescer.wait_timeout_s <= 0:
            raise ConfigError("QUERY_COALESCER_WAIT_TIMEOUT_S must be > 0")
        if self.robustness.query_timeout_ms < 0:
            raise ConfigError("QUERY_TIMEOUT_MS must be >= 0")
        if self.robustness.breaker_failure_threshold < 1:
            raise ConfigError("BREAKER_FAILURE_THRESHOLD must be >= 1")
        if self.robustness.breaker_reset_ms < 0:
            raise ConfigError("BREAKER_RESET_TIMEOUT_MS must be >= 0")
        if self.robustness.breaker_half_open_probes < 1:
            raise ConfigError("BREAKER_HALF_OPEN_PROBES must be >= 1")
        if self.robustness.fault_injection:
            # fail at startup, not at the first injection-point firing
            from weaviate_tpu_torch.testing import faults

            try:
                faults.from_spec(self.robustness.fault_injection)
            except ValueError as e:
                raise ConfigError(f"invalid FAULT_INJECTION: {e}") from None
        if not (0.0 <= self.tracing.sample_rate <= 1.0):
            raise ConfigError("TRACING_SAMPLE_RATE must be in [0, 1]")
        if self.tracing.ring_size < 1:
            raise ConfigError("TRACING_RING_SIZE must be >= 1")
        if self.tracing.perf_window_s <= 0:
            raise ConfigError("PERF_WINDOW_S must be > 0")
        if not (0.0 < self.tenancy.max_queued_rows_fraction <= 1.0):
            raise ConfigError(
                "TENANT_MAX_QUEUED_ROWS_FRACTION must be in (0, 1]")
        if self.tenancy.metrics_top_k < 1:
            raise ConfigError("TENANT_METRICS_TOP_K must be >= 1")
        if self.tenancy.max_concurrent_requests < 0:
            raise ConfigError(
                "TENANT_MAX_CONCURRENT_REQUESTS must be >= 0 (0 disables)")
        for t, w in self.tenancy.weights.items():
            if not t or w <= 0:
                raise ConfigError(
                    f"TENANT_WEIGHTS entry {t!r}={w!r} must have a "
                    "nonempty tenant and weight > 0")
        if not (0.0 <= self.quality.audit_sample_rate <= 1.0):
            raise ConfigError("RECALL_AUDIT_SAMPLE_RATE must be in [0, 1]")
        if self.quality.audit_concurrency < 1:
            raise ConfigError("RECALL_AUDIT_CONCURRENCY must be >= 1")
        if self.quality.audit_max_rows < 1:
            raise ConfigError("RECALL_AUDIT_MAX_ROWS must be >= 1")
        if self.quality.window_s <= 0:
            raise ConfigError("QUALITY_WINDOW_S must be > 0")
        if not (0.0 <= self.quality.alert_threshold <= 1.0):
            raise ConfigError("RECALL_ALERT_THRESHOLD must be in [0, 1]")
        if self.quality.alert_min_samples < 1:
            raise ConfigError("RECALL_ALERT_MIN_SAMPLES must be >= 1")
        if self.memory.window_s <= 0:
            raise ConfigError("MEMORY_LEDGER_WINDOW_S must be > 0")
        if not (0.0 <= self.memory.headroom_alert_pct <= 100.0):
            raise ConfigError("MEMORY_HEADROOM_ALERT_PCT must be 0..100")
        if self.memory.device_budget_bytes < 0:
            raise ConfigError("MEMORY_DEVICE_BUDGET_BYTES must be >= 0")
        if self.memory.host_budget_bytes < 0:
            raise ConfigError("MEMORY_HOST_BUDGET_BYTES must be >= 0")
        if self.incidents.journal_size < 1:
            raise ConfigError("INCIDENT_JOURNAL_SIZE must be >= 1")
        if self.incidents.dir_max_bytes < 0:
            raise ConfigError(
                "INCIDENT_DIR_MAX_BYTES must be >= 0 (0 = unbounded)")
        if self.incidents.rate_limit_s < 0:
            raise ConfigError("INCIDENT_RATE_LIMIT_S must be >= 0")
        if not (0.0 < self.incidents.slo_availability_target < 1.0):
            raise ConfigError("SLO_AVAILABILITY_TARGET must be in (0, 1)")
        if self.incidents.slo_latency_p99_ms < 0:
            raise ConfigError(
                "SLO_LATENCY_P99_MS must be >= 0 (0 disables)")
        if self.incidents.slo_fast_burn <= 0 \
                or self.incidents.slo_slow_burn <= 0:
            raise ConfigError(
                "SLO_FAST_BURN_THRESHOLD and SLO_SLOW_BURN_THRESHOLD "
                "must be > 0")
        if self.incidents.slo_min_events < 1:
            raise ConfigError("SLO_MIN_EVENTS must be >= 1")
        if len(self.incidents.slo_tenant_targets) > 64:
            raise ConfigError(
                "SLO_TENANT_AVAILABILITY_TARGETS: at most 64 per-tenant "
                "overrides (each mints a bounded metric series)")
        for t, tv in self.incidents.slo_tenant_targets.items():
            if not t or not (0.0 < tv < 1.0):
                raise ConfigError(
                    f"SLO_TENANT_AVAILABILITY_TARGETS entry {t!r}={tv!r} "
                    "must have a nonempty tenant and target in (0, 1)")
        ctl = self.controller
        if ctl.tick_s <= 0:
            raise ConfigError("CONTROLLER_TICK_S must be > 0")
        if ctl.hold_ticks < 1:
            raise ConfigError("CONTROLLER_HOLD_TICKS must be >= 1")
        if ctl.fast_burn_threshold <= 0 or ctl.slow_burn_threshold <= 0:
            raise ConfigError(
                "CONTROLLER_FAST_BURN and CONTROLLER_SLOW_BURN must be > 0")
        if ctl.brownout_margin < 1.0:
            raise ConfigError(
                "CONTROLLER_BROWNOUT_MARGIN must be >= 1 (1 = no "
                "tightening)")
        if not (0.0 < ctl.brownout_cap_scale <= 1.0) \
                or not (0.0 < ctl.brownout_rate_scale <= 1.0):
            raise ConfigError(
                "CONTROLLER_BROWNOUT_CAP_SCALE and "
                "CONTROLLER_BROWNOUT_RATE_SCALE must be in (0, 1]")
        if ctl.brownout_retry_scale < 1.0:
            raise ConfigError(
                "CONTROLLER_BROWNOUT_RETRY_SCALE must be >= 1")
        if not (0.0 < ctl.recall_floor < 1.0):
            raise ConfigError("CONTROLLER_RECALL_FLOOR must be in (0, 1)")
        if ctl.recall_slack <= 0 or ctl.recall_backoff_margin < 0:
            raise ConfigError(
                "CONTROLLER_RECALL_SLACK must be > 0 and "
                "CONTROLLER_RECALL_BACKOFF_MARGIN >= 0")
        if ctl.recall_min_samples < 1:
            raise ConfigError("CONTROLLER_RECALL_MIN_SAMPLES must be >= 1")
        if not (0.0 < ctl.window_min_ms <= ctl.window_max_ms):
            raise ConfigError(
                "CONTROLLER_WINDOW_MIN_MS must be in (0, "
                "CONTROLLER_WINDOW_MAX_MS]")
        if ctl.depth_max < 1:
            raise ConfigError("CONTROLLER_DEPTH_MAX must be >= 1")
        if not (0.0 < ctl.duty_lo < ctl.duty_hi <= 1.0):
            raise ConfigError(
                "CONTROLLER_DUTY_LO/HI must satisfy 0 < lo < hi <= 1")
        if ctl.tenant_rate_qps < 0:
            raise ConfigError("TENANT_RATE_QPS must be >= 0 (0 disables)")
        if ctl.tenant_rate_burst_s <= 0:
            raise ConfigError("TENANT_RATE_BURST_S must be > 0")


def ivf_from_env(env: Optional[Mapping[str, str]] = None) -> IvfConfig:
    """Parse the IVF knob surface. Shared by load_config AND the index
    layer's bare-library fallback (index/gpu.py ivf_settings) — one knob
    must never read differently with vs without an App (the
    FUSED_DISPATCH_ENABLED discipline)."""
    e = dict(os.environ) if env is None else env
    return IvfConfig(
        enabled=_bool(e, "IVF_ENABLED"),
        nlist=_int(e, "IVF_NLIST", 0),
        top_p=_int(e, "IVF_TOP_P", 0),
        min_n=_int(e, "IVF_MIN_N", 20000),
        pca_dim=_int(e, "IVF_PCA_DIM", 0),
        prefilter_c=_int(e, "IVF_PREFILTER_C", 0),
        train_sample=_int(e, "IVF_TRAIN_SAMPLE", 65536),
        train_iters=_int(e, "IVF_TRAIN_ITERS", 6),
        retrain_growth=_float(e, "IVF_RETRAIN_GROWTH", 0.5),
    )


def load_config(env: Optional[Mapping[str, str]] = None) -> Config:
    """LoadConfig twin (environment.go): parse the env surface, validate."""
    e = dict(os.environ) if env is None else dict(env)
    cfg = Config()

    cfg.persistence.data_path = e.get("PERSISTENCE_DATA_PATH", "./data")
    cfg.persistence.memtables_max_size_mb = _int(e, "PERSISTENCE_MEMTABLES_MAX_SIZE_MB", 200)
    cfg.persistence.memtables_min_active_seconds = _int(
        e, "PERSISTENCE_MEMTABLES_MIN_ACTIVE_DURATION_SECONDS", 10)
    cfg.persistence.memtables_max_active_seconds = _int(
        e, "PERSISTENCE_MEMTABLES_MAX_ACTIVE_DURATION_SECONDS", 300)
    cfg.persistence.flush_idle_memtables_after = _int(
        e, "PERSISTENCE_FLUSH_IDLE_MEMTABLES_AFTER", 60)

    apikey_enabled = _bool(e, "AUTHENTICATION_APIKEY_ENABLED")
    oidc_enabled = _bool(e, "AUTHENTICATION_OIDC_ENABLED")
    anon_default = not (apikey_enabled or oidc_enabled)
    cfg.auth.anonymous.enabled = _bool(
        e, "AUTHENTICATION_ANONYMOUS_ACCESS_ENABLED", anon_default)
    cfg.auth.apikey.enabled = apikey_enabled
    cfg.auth.apikey.allowed_keys = _list(e, "AUTHENTICATION_APIKEY_ALLOWED_KEYS")
    cfg.auth.apikey.users = _list(e, "AUTHENTICATION_APIKEY_USERS")
    cfg.auth.oidc.enabled = oidc_enabled
    cfg.auth.oidc.issuer = e.get("AUTHENTICATION_OIDC_ISSUER", "")
    cfg.auth.oidc.client_id = e.get("AUTHENTICATION_OIDC_CLIENT_ID", "")
    cfg.auth.oidc.username_claim = e.get("AUTHENTICATION_OIDC_USERNAME_CLAIM", "sub")
    cfg.auth.oidc.groups_claim = e.get("AUTHENTICATION_OIDC_GROUPS_CLAIM", "")
    cfg.auth.oidc.skip_client_id_check = _bool(e, "AUTHENTICATION_OIDC_SKIP_CLIENT_ID_CHECK")

    cfg.authz.admin_list_enabled = _bool(e, "AUTHORIZATION_ADMINLIST_ENABLED")
    cfg.authz.admin_users = _list(e, "AUTHORIZATION_ADMINLIST_USERS")
    cfg.authz.readonly_users = _list(e, "AUTHORIZATION_ADMINLIST_READONLY_USERS")

    cfg.cluster.hostname = e.get("CLUSTER_HOSTNAME", "")
    cfg.cluster.gossip = _bool(e, "CLUSTER_GOSSIP")
    cfg.cluster.gossip_bind_port = _int(e, "CLUSTER_GOSSIP_BIND_PORT", 7946)
    cfg.cluster.data_bind_port = _int(e, "CLUSTER_DATA_BIND_PORT", 7947)
    cfg.cluster.join = _list(e, "CLUSTER_JOIN")
    cfg.cluster.ignore_schema_sync = _bool(e, "CLUSTER_IGNORE_SCHEMA_SYNC")

    cfg.monitoring.enabled = _bool(e, "PROMETHEUS_MONITORING_ENABLED")
    cfg.monitoring.port = _int(e, "PROMETHEUS_MONITORING_PORT", 2112)
    cfg.monitoring.group_classes = _bool(e, "PROMETHEUS_MONITORING_GROUP_CLASSES")

    cfg.disk_use.warning_percentage = _int(e, "DISK_USE_WARNING_PERCENTAGE", 80)
    cfg.disk_use.readonly_percentage = _int(e, "DISK_USE_READONLY_PERCENTAGE", 90)
    cfg.mem_use.warning_percentage = _int(e, "MEMORY_WARNING_PERCENTAGE", 80)
    cfg.mem_use.readonly_percentage = _int(e, "MEMORY_READONLY_PERCENTAGE", 0)

    cfg.auto_schema.enabled = _bool(e, "AUTOSCHEMA_ENABLED", True)
    cfg.auto_schema.default_string = e.get("AUTOSCHEMA_DEFAULT_STRING", "text")
    cfg.auto_schema.default_number = e.get("AUTOSCHEMA_DEFAULT_NUMBER", "number")
    cfg.auto_schema.default_date = e.get("AUTOSCHEMA_DEFAULT_DATE", "date")

    cfg.origin = e.get("ORIGIN", "")
    cfg.enable_modules = _list(e, "ENABLE_MODULES")
    cfg.default_vectorizer_module = e.get("DEFAULT_VECTORIZER_MODULE", "none")
    cfg.default_vector_distance_metric = e.get("DEFAULT_VECTOR_DISTANCE_METRIC", "")
    cfg.query_defaults_limit = _int(e, "QUERY_DEFAULTS_LIMIT", 25)
    cfg.query_maximum_results = _int(e, "QUERY_MAXIMUM_RESULTS", 10000)
    cfg.max_import_goroutines_factor = _float(e, "MAX_IMPORT_GOROUTINES_FACTOR", 1.5)
    cfg.maximum_concurrent_get_requests = _int(e, "MAXIMUM_CONCURRENT_GET_REQUESTS", 0)
    cfg.track_vector_dimensions = _bool(e, "TRACK_VECTOR_DIMENSIONS")
    cfg.reindex_vector_dimensions_at_startup = _bool(
        e, "REINDEX_VECTOR_DIMENSIONS_AT_STARTUP")
    cfg.index_missing_text_filterable_at_startup = _bool(
        e, "INDEX_MISSING_TEXT_FILTERABLE_AT_STARTUP")
    cfg.grpc_port = _int(e, "GRPC_PORT", 50051)
    cfg.contextionary_url = e.get("CONTEXTIONARY_URL", "")
    cfg.backup_filesystem_path = e.get("BACKUP_FILESYSTEM_PATH", "")

    cfg.device_mesh_shards = _int(e, "TPU_DEVICE_MESH_SHARDS", 0)
    cfg.store_dtype = e.get("TPU_STORE_DTYPE", "float32")
    cfg.fused_dispatch_enabled = _bool(e, "FUSED_DISPATCH_ENABLED", True)

    cfg.ivf = ivf_from_env(e)

    cfg.coalescer.enabled = _bool(e, "QUERY_COALESCER_ENABLED")
    cfg.coalescer.window_ms = _float(e, "QUERY_COALESCER_WINDOW_MS", 1.5)
    cfg.coalescer.max_batch = _int(e, "QUERY_COALESCER_MAX_BATCH", 256)
    cfg.coalescer.max_request_rows = _int(
        e, "QUERY_COALESCER_MAX_REQUEST_ROWS", 16)
    cfg.coalescer.pipeline_depth = _int(
        e, "QUERY_COALESCER_PIPELINE_DEPTH", 1)
    cfg.coalescer.max_queued_rows = _int(
        e, "QUERY_COALESCER_MAX_QUEUED_ROWS", 4096)
    cfg.coalescer.wait_timeout_s = _float(
        e, "QUERY_COALESCER_WAIT_TIMEOUT_S", 30.0)

    cfg.robustness.query_timeout_ms = _float(e, "QUERY_TIMEOUT_MS", 0.0)
    cfg.robustness.breaker_enabled = _bool(e, "BREAKER_ENABLED", True)
    cfg.robustness.breaker_failure_threshold = _int(
        e, "BREAKER_FAILURE_THRESHOLD", 5)
    cfg.robustness.breaker_reset_ms = _float(
        e, "BREAKER_RESET_TIMEOUT_MS", 2000.0)
    cfg.robustness.breaker_half_open_probes = _int(
        e, "BREAKER_HALF_OPEN_PROBES", 1)
    cfg.robustness.fault_injection = e.get("FAULT_INJECTION", "")
    cfg.robustness.fault_injection_seed = _int(e, "FAULT_INJECTION_SEED", 0)

    cfg.tenancy.weights = _tenant_weights(e, "TENANT_WEIGHTS")
    cfg.tenancy.max_queued_rows_fraction = _float(
        e, "TENANT_MAX_QUEUED_ROWS_FRACTION", 0.5)
    cfg.tenancy.metrics_top_k = _int(e, "TENANT_METRICS_TOP_K", 10)
    cfg.tenancy.max_concurrent_requests = _int(
        e, "TENANT_MAX_CONCURRENT_REQUESTS", 0)

    cfg.quality.audit_sample_rate = _float(e, "RECALL_AUDIT_SAMPLE_RATE", 0.0)
    cfg.quality.audit_concurrency = _int(e, "RECALL_AUDIT_CONCURRENCY", 1)
    cfg.quality.audit_max_rows = _int(e, "RECALL_AUDIT_MAX_ROWS", 64)
    cfg.quality.audit_deadline_ms = _float(
        e, "RECALL_AUDIT_DEADLINE_MS", 1000.0)
    cfg.quality.window_s = _float(e, "QUALITY_WINDOW_S", 300.0)
    cfg.quality.alert_threshold = _float(e, "RECALL_ALERT_THRESHOLD", 0.95)
    cfg.quality.alert_min_samples = _int(e, "RECALL_ALERT_MIN_SAMPLES", 20)

    cfg.memory.ledger_enabled = _bool(e, "MEMORY_LEDGER_ENABLED", True)
    cfg.memory.window_s = _float(e, "MEMORY_LEDGER_WINDOW_S", 300.0)
    cfg.memory.headroom_alert_pct = _float(
        e, "MEMORY_HEADROOM_ALERT_PCT", 10.0)
    cfg.memory.device_budget_bytes = _int(
        e, "MEMORY_DEVICE_BUDGET_BYTES", 0)
    cfg.memory.host_budget_bytes = _int(e, "MEMORY_HOST_BUDGET_BYTES", 0)

    cfg.incidents.enabled = _bool(e, "INCIDENTS_ENABLED", True)
    cfg.incidents.journal_size = _int(e, "INCIDENT_JOURNAL_SIZE", 512)
    cfg.incidents.dir = e.get("INCIDENT_DIR", "")
    cfg.incidents.dir_max_bytes = _int(
        e, "INCIDENT_DIR_MAX_BYTES", 64 * 1024 * 1024)
    cfg.incidents.rate_limit_s = _float(e, "INCIDENT_RATE_LIMIT_S", 300.0)
    cfg.incidents.slo_availability_target = _float(
        e, "SLO_AVAILABILITY_TARGET", 0.999)
    cfg.incidents.slo_latency_p99_ms = _float(e, "SLO_LATENCY_P99_MS", 0.0)
    cfg.incidents.slo_fast_burn = _float(e, "SLO_FAST_BURN_THRESHOLD", 14.4)
    cfg.incidents.slo_slow_burn = _float(e, "SLO_SLOW_BURN_THRESHOLD", 3.0)
    cfg.incidents.slo_min_events = _int(e, "SLO_MIN_EVENTS", 20)
    cfg.incidents.slo_tenant_targets = _tenant_targets(
        e, "SLO_TENANT_AVAILABILITY_TARGETS")

    cfg.controller.enabled = _bool(e, "CONTROL_PLANE_ENABLED")
    cfg.controller.tick_s = _float(e, "CONTROLLER_TICK_S", 1.0)
    cfg.controller.hold_ticks = _int(e, "CONTROLLER_HOLD_TICKS", 3)
    cfg.controller.brownout_enabled = _bool(
        e, "CONTROLLER_BROWNOUT_ENABLED", True)
    cfg.controller.budget_enabled = _bool(
        e, "CONTROLLER_BUDGET_ENABLED", True)
    cfg.controller.lanes_enabled = _bool(
        e, "CONTROLLER_LANES_ENABLED", True)
    cfg.controller.fast_burn_threshold = _float(
        e, "CONTROLLER_FAST_BURN", 14.4)
    cfg.controller.slow_burn_threshold = _float(
        e, "CONTROLLER_SLOW_BURN", 3.0)
    cfg.controller.brownout_margin = _float(
        e, "CONTROLLER_BROWNOUT_MARGIN", 2.0)
    cfg.controller.brownout_cap_scale = _float(
        e, "CONTROLLER_BROWNOUT_CAP_SCALE", 0.5)
    cfg.controller.brownout_retry_scale = _float(
        e, "CONTROLLER_BROWNOUT_RETRY_SCALE", 2.0)
    cfg.controller.brownout_rate_scale = _float(
        e, "CONTROLLER_BROWNOUT_RATE_SCALE", 0.5)
    cfg.controller.recall_floor = _float(
        e, "CONTROLLER_RECALL_FLOOR", 0.98)
    cfg.controller.recall_slack = _float(
        e, "CONTROLLER_RECALL_SLACK", 0.015)
    cfg.controller.recall_backoff_margin = _float(
        e, "CONTROLLER_RECALL_BACKOFF_MARGIN", 0.005)
    cfg.controller.recall_min_samples = _int(
        e, "CONTROLLER_RECALL_MIN_SAMPLES", 8)
    cfg.controller.window_min_ms = _float(
        e, "CONTROLLER_WINDOW_MIN_MS", 0.5)
    cfg.controller.window_max_ms = _float(
        e, "CONTROLLER_WINDOW_MAX_MS", 6.0)
    cfg.controller.depth_max = _int(e, "CONTROLLER_DEPTH_MAX", 2)
    cfg.controller.duty_hi = _float(e, "CONTROLLER_DUTY_HI", 0.85)
    cfg.controller.duty_lo = _float(e, "CONTROLLER_DUTY_LO", 0.3)
    cfg.controller.tenant_rate_qps = _float(e, "TENANT_RATE_QPS", 0.0)
    cfg.controller.tenant_rate_burst_s = _float(
        e, "TENANT_RATE_BURST_S", 2.0)

    cfg.tracing.enabled = _bool(e, "TRACING_ENABLED")
    cfg.tracing.sample_rate = _float(e, "TRACING_SAMPLE_RATE", 1.0)
    cfg.tracing.ring_size = _int(e, "TRACING_RING_SIZE", 256)
    cfg.tracing.slow_query_threshold_ms = _float(
        e, "SLOW_QUERY_THRESHOLD_MS", 1000.0)
    cfg.tracing.perf_window_s = _float(e, "PERF_WINDOW_S", 60.0)

    cfg.validate()
    return cfg
