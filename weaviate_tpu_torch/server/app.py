# The port's copy of weaviate_tpu/server/app.py, its imports pointed at the port.
"""App: the whole-server object graph.

Reference: adapters/handlers/rest/configure_api.go:105 `configureAPI` — the
one place every singleton is wired: DB, schema manager (with the vector-index
config parser injected), objects/batch managers, traverser/explorer,
aggregator, GraphQL executor, auth, metrics. The REST/gRPC layers only ever
see this object.

The port's App differs from the JAX package's in three ways:
- a `device` keyword, passed to the DB and from there to every Shard's
  index; None (the default) is the CUDA card, and the App raises at once
  when torch sees none unless the caller passes device="cpu";
- the fused-dispatch toggle goes to the port's index (`index/gpu.py`);
- it refuses, with a ValueError naming the ROADMAP item that brings each,
  what the port does not serve yet: IVF_ENABLED (queue 1 item 9),
  TPU_DEVICE_MESH_SHARDS > 1 (item 10), ENABLE_MODULES or an injected
  module provider (item 14), and a cluster config, CLUSTER_HOSTNAME or
  CLUSTER_JOIN (item 15). With none of them set the reference App has no
  modules, no cluster and no IVF either, so the default App is whole.
"""

from __future__ import annotations

import os
from typing import Optional

from weaviate_tpu_torch.auth import Authenticator, Authorizer
from weaviate_tpu_torch.config import Config, load_config
from weaviate_tpu_torch.db import DB
from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.graphql import GraphQLExecutor
from weaviate_tpu_torch.monitoring import noop_metrics
from weaviate_tpu_torch.schema import AutoSchema, SchemaManager
from weaviate_tpu_torch.usecases.aggregator import Aggregator
from weaviate_tpu_torch.usecases.objects import BatchManager, ObjectsManager
from weaviate_tpu_torch.usecases.traverser import Explorer, Traverser
from weaviate_tpu_torch.version import __version__ as VERSION


def _refuse_unported(config: Config, modules) -> None:
    """Raise a ValueError naming the ROADMAP item that brings whatever the
    config asks for that the port does not serve yet."""
    if config.ivf.enabled:
        raise ValueError("IVF_ENABLED: the IVF scan plane is not ported yet: "
                         "ROADMAP queue 1 item 9")
    if config.device_mesh_shards > 1:
        raise ValueError("TPU_DEVICE_MESH_SHARDS > 1: the multi-device mesh "
                         "is not ported yet: ROADMAP queue 1 item 10")
    if modules is not None or config.enable_modules:
        raise ValueError("ENABLE_MODULES: the vectorizer and reader modules "
                         "(modules/) are not ported yet: ROADMAP queue 1 item 14")
    if config.cluster.hostname or config.cluster.join:
        raise ValueError("CLUSTER_HOSTNAME/CLUSTER_JOIN: the cluster, "
                         "replication and backup transfer (cluster/) are "
                         "not ported yet: ROADMAP queue 1 item 15")


class App:
    def __init__(self, config: Optional[Config] = None, data_path: Optional[str] = None,
                 metrics=None, modules=None, device=None):
        # no config given => read the process environment (environment.go)
        self.config = config or load_config()
        _refuse_unported(self.config, modules)
        # the card unless the caller names the CPU; no card => raise now
        self.device = resolve_device(device)
        path = data_path or self.config.persistence.data_path
        os.makedirs(path, exist_ok=True)
        if metrics is not None:
            self.metrics = metrics
        elif self.config.monitoring.enabled:
            from weaviate_tpu_torch.monitoring import get_metrics

            self.metrics = get_metrics()
        else:
            self.metrics = noop_metrics()

        # pprof twin: one sampler per process (profile runs are serialized
        # by its lock the way pprof serializes CPU profiles)
        from weaviate_tpu_torch.monitoring.profiling import StackSampler

        self.stack_sampler = StackSampler()

        # fused device dispatch (index/gpu.py): apply the config knob to
        # the index layer's process-wide toggle — like the tracer, the
        # index reaches it without plumbing. Default on;
        # FUSED_DISPATCH_ENABLED flips it.
        from weaviate_tpu_torch.index import gpu as gpu_index

        self._fused_token = gpu_index.set_fused_enabled(
            self.config.fused_dispatch_enabled)

        # end-to-end request tracing (monitoring/tracing.py): the tracer is
        # a process-wide module global — shards and the coalescer reach it
        # without plumbing — installed here and cleared on shutdown.
        # Disabled => the global stays None and every tracing entry point
        # on the serving path is a one-comparison no-op.
        tc = self.config.tracing
        if tc.enabled:
            from weaviate_tpu_torch.monitoring import perf, tracing

            self.tracer = tracing.configure(tracing.Tracer(
                sample_rate=tc.sample_rate,
                ring_size=tc.ring_size,
                slow_ms=tc.slow_query_threshold_ms,
                metrics=self.metrics))
            # continuous device-performance attribution (monitoring/
            # perf.py): rides the tracer's enablement — the perf window is
            # fed by every dispatch's cost-model shape, which the index
            # only builds while the tracer is up (one zero-cost contract
            # for both planes). /debug/perf + the rolling roofline gauges.
            self.perf_window = perf.configure(perf.PerfWindow(
                window_s=tc.perf_window_s,
                metrics=self.metrics,
                sample_hint=tc.sample_rate))
        else:
            self.tracer = None
            self.perf_window = None
        # online quality observability (monitoring/quality.py): the shadow
        # recall auditor is its own module global with the same lifecycle
        # discipline as the tracer/perf window — sample rate 0 (the
        # default) leaves the global None and every capture point on the
        # serving path a one-comparison no-op that constructs nothing.
        qc = self.config.quality
        if qc.audit_sample_rate > 0.0:
            from weaviate_tpu_torch.monitoring import quality

            self.quality_auditor = quality.configure(quality.QualityAuditor(
                sample_rate=qc.audit_sample_rate,
                concurrency=qc.audit_concurrency,
                max_rows=qc.audit_max_rows,
                deadline_ms=qc.audit_deadline_ms,
                window_s=qc.window_s,
                alert_threshold=qc.alert_threshold,
                alert_min_samples=qc.alert_min_samples,
                metrics=self.metrics))
        else:
            self.quality_auditor = None
        # memory & capacity observability (monitoring/memory.py): the
        # device/host/disk byte ledger is ALWAYS-ON by default (unlike the
        # tracer it costs nothing on the search path — stamps ride the
        # write path only), installed before the DB so restore-time
        # flushes are accounted; same module-global lifecycle discipline.
        mc = self.config.memory
        if mc.ledger_enabled:
            from weaviate_tpu_torch.monitoring import memory as memledger

            self.memory_ledger = memledger.configure(memledger.MemoryLedger(
                metrics=self.metrics,
                window_s=mc.window_s,
                headroom_alert_pct=mc.headroom_alert_pct,
                device_budget_bytes=mc.device_budget_bytes,
                host_budget_bytes=mc.host_budget_bytes))
            # the data volume backs the ledger's disk scope, so device/
            # host/disk capacity read from one /debug/memory page
            self.memory_ledger.set_disk_path(path)
        else:
            self.memory_ledger = None
        # incident flight recorder + SLO burn-rate engine (monitoring/
        # incidents.py): the capstone layer that connects the planes above
        # — an ops-event journal fed by their state transitions, config-
        # declared SLOs evaluated into 5m/1h burn rates, and trigger-
        # driven post-mortem bundles under INCIDENT_DIR. Same module-
        # global lifecycle discipline; disabled => the globals stay None
        # and every emit/note_request/trigger is a one-comparison no-op
        # that constructs nothing (spy-pinned in tests/test_incidents.py).
        ic = self.config.incidents
        if ic.enabled:
            from weaviate_tpu_torch.monitoring import incidents
            from weaviate_tpu_torch.monitoring import memory as memledger_mod

            self.ops_journal = incidents.OpsJournal(
                size=ic.journal_size, metrics=self.metrics)
            self.slo_engine = incidents.SloEngine(
                availability_target=ic.slo_availability_target,
                latency_p99_ms=ic.slo_latency_p99_ms,
                fast_burn_threshold=ic.slo_fast_burn,
                slow_burn_threshold=ic.slo_slow_burn,
                min_events=ic.slo_min_events,
                tenant_targets=ic.slo_tenant_targets,
                metrics=self.metrics)
            self.flight_recorder = incidents.FlightRecorder(
                ic.dir or os.path.join(path, "incidents"),
                max_bytes=ic.dir_max_bytes,
                rate_limit_s=ic.rate_limit_s,
                journal=self.ops_journal,
                engine=self.slo_engine,
                metrics=self.metrics)
            self.flight_recorder.set_config_fingerprint(
                self._config_fingerprint())
            # the bundle directory is a disk consumer the capacity plane
            # should see: registered as the ledger's `incident_bundles`
            # disk component (weakref provider, PR-9 idiom)
            memledger_mod.register_disk_provider(
                self.flight_recorder,
                lambda rec: {"incident_bundles": rec.dir_bytes()})
            incidents.configure(journal=self.ops_journal,
                                engine=self.slo_engine,
                                recorder=self.flight_recorder)
        else:
            self.ops_journal = None
            self.slo_engine = None
            self.flight_recorder = None
        # a SIGTERM mid device-trace capture must still stop the
        # profiler session: install the signal/atexit teardown
        # from the main thread while we are likely on it — REST handler
        # threads cannot install signal handlers themselves
        from weaviate_tpu_torch.monitoring import profiling

        profiling.install_trace_teardown()
        if self.flight_recorder is not None:
            # chain the flight-recorder dump into the same teardown:
            # stop capture -> dump bundle -> re-deliver. The hook reads
            # the LIVE module global, so a cleanly shut-down App (already
            # unconfigured) dumps nothing at exit, while a process dying
            # with a live server preserves its evidence.
            from weaviate_tpu_torch.monitoring import incidents

            profiling.register_teardown_hook(incidents.teardown_dump)

        # request-lifecycle robustness (serving/robustness.py): shed/
        # deadline counters bind to this App's metrics; the device circuit
        # breaker is a process-wide global (the device is shared — dispatch
        # failures are a property of the accelerator, not of one shard),
        # installed here and cleared on shutdown like the tracer.
        from weaviate_tpu_torch.serving import robustness

        robustness.set_metrics(self.metrics)
        rb = self.config.robustness
        if rb.breaker_enabled:
            self.breaker = robustness.configure_breaker(
                robustness.CircuitBreaker(
                    failure_threshold=rb.breaker_failure_threshold,
                    reset_timeout_s=rb.breaker_reset_ms / 1000.0,
                    half_open_probes=rb.breaker_half_open_probes,
                    metrics=self.metrics))
        else:
            self.breaker = None
        # fault-injection harness (testing/faults.py): config-gated; off =>
        # the module global stays None and every injection point on the
        # serving path is a one-comparison no-op
        if rb.fault_injection:
            from weaviate_tpu_torch.testing import faults

            self.fault_injector = faults.configure(faults.from_spec(
                rb.fault_injection, seed=rb.fault_injection_seed))
        else:
            self.fault_injector = None

        # single node: the cluster graph (CLUSTER_HOSTNAME/CLUSTER_JOIN)
        # and the module provider (ENABLE_MODULES) were refused above
        self.cluster_node = None
        self.db = DB(path, metrics=self.metrics,
                     store_opts=self._store_opts(), device=self.device)
        self.schema = SchemaManager(
            os.path.join(path, "schema.json"), migrator=self.db,
            default_vectorizer=self.config.default_vectorizer_module)
        self.modules = None
        # class creation must fail fast on a vectorizer, since no module is
        # enabled (instead of importing vectorless objects)
        self.schema.vectorizer_validator = lambda name: False
        self.auto_schema = (
            AutoSchema(
                self.schema,
                default_string=self.config.auto_schema.default_string,
                default_number=self.config.auto_schema.default_number,
                default_date=self.config.auto_schema.default_date,
            )
            if self.config.auto_schema.enabled
            else None
        )
        self.objects = ObjectsManager(
            self.db, self.schema, auto_schema=self.auto_schema,
            modules=self.modules, metrics=self.metrics)
        self.batch = BatchManager(self.objects)
        # cross-request query coalescing (serving/coalescer.py): disabled =>
        # self.coalescer is None and every read path below is untouched
        # (zero queue hops) — the knob must be a true no-op when off
        cc = self.config.coalescer
        # multi-tenant fairness: the bounded tenant-label mapper is sized
        # here (it lives on the metrics registry so robustness counters
        # and the coalescer share ONE top-K view of who is heavy)
        tn = self.config.tenancy
        self.metrics.tenant_labels.top_k = max(int(tn.metrics_top_k), 1)
        # front-door per-tenant concurrency gate: process-wide like the
        # breaker (the frontends check it before any per-request work)
        if tn.max_concurrent_requests > 0:
            self.tenant_gate = robustness.configure_tenant_gate(
                robustness.TenantConcurrencyGate(tn.max_concurrent_requests,
                                                 metrics=self.metrics))
        else:
            self.tenant_gate = None
        if cc.enabled:
            from concurrent.futures import ThreadPoolExecutor

            from weaviate_tpu_torch.serving.coalescer import QueryCoalescer

            self.coalescer = QueryCoalescer(
                window_s=cc.window_ms / 1000.0,
                max_batch=cc.max_batch,
                max_request_rows=cc.max_request_rows,
                metrics=self.metrics,
                pipeline_depth=cc.pipeline_depth,
                max_queued_rows=cc.max_queued_rows,
                waiter_timeout_s=cc.wait_timeout_s,
                tenant_weights=tn.weights,
                tenant_rows_fraction=tn.max_queued_rows_fraction)
            # persistent slot pool for concurrent batch fan-out (REST
            # /v1/graphql/batch): per-request executors would pay thread
            # churn on the exact hot path the coalescer optimizes
            self.serving_pool = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="serving-batch")
        else:
            self.coalescer = None
            self.serving_pool = None
        # self-tuning degradation control plane (serving/controller.py):
        # the layer that ACTS on the observability stack — burn-rate
        # brownout, the recall-guarded candidate budget, coalescer
        # window/depth steering, tenant rate quotas. Module-global
        # lifecycle like the tracer; disabled (the default) => the
        # global stays None and every knob reader on the serving path is
        # a one-comparison no-op that constructs nothing (spy-pinned in
        # tests/test_controller.py). Wired AFTER the coalescer so the
        # plane captures its configured defaults.
        ctl = self.config.controller
        if ctl.enabled:
            from weaviate_tpu_torch.serving import controller as control

            self.control_plane = control.configure(control.ControlPlane(
                config=ctl,
                coalescer=self.coalescer,
                metrics=self.metrics,
                tenant_weights=tn.weights))
        else:
            self.control_plane = None
        if self.flight_recorder is not None:
            # live serving stats ride into every bundle: the coalescer's
            # lane/shed/tenant picture and the front-door gate occupancy
            # (pull callables, each captured under its own guard)
            if self.coalescer is not None:
                self.flight_recorder.add_stats_provider(
                    "coalescer", self.coalescer.stats)
            if self.tenant_gate is not None:
                self.flight_recorder.add_stats_provider(
                    "tenant_gate", self.tenant_gate.stats)
            if self.control_plane is not None:
                # every bundle carries the control plane's knob/ladder
                # picture: a post-mortem must show what the controllers
                # were DOING around the incident, not just what the
                # sensors saw
                self.flight_recorder.add_stats_provider(
                    "controllers", self.control_plane.summary)
        self.explorer = Explorer(
            self.db, self.schema, modules=self.modules,
            query_limit=self.config.query_defaults_limit,
            max_results=self.config.query_maximum_results,
            coalescer=self.coalescer)
        self.traverser = Traverser(
            self.explorer,
            max_concurrent=self.config.maximum_concurrent_get_requests)
        self.aggregator = Aggregator(self.db, self.schema, self.explorer)
        self.graphql = GraphQLExecutor(self.traverser, self.aggregator, self.schema, self.db)
        oidc_validator = None
        if self.config.auth.oidc.enabled:
            from weaviate_tpu_torch.auth.oidc import OIDCValidator

            oidc_validator = OIDCValidator(self.config.auth.oidc)
        self.authenticator = Authenticator(
            self.config.auth, oidc_validator=oidc_validator
        )
        self.authorizer = Authorizer(self.config.authz)
        from weaviate_tpu_torch.usecases.backup import BackupScheduler

        self.backup_scheduler = BackupScheduler(self.db, self.schema, self.modules)
        from weaviate_tpu_torch.usecases.classification import Classifier

        self.classifier = Classifier(self.db, self.schema, self.modules)
        self.cluster = self.cluster_node  # /v1/nodes aggregation source
        # disk-pressure failure detection (storagestate READONLY automation)
        from weaviate_tpu_torch.monitoring.disk import DiskMonitor

        self.disk_monitor = DiskMonitor(
            self.db,
            warning_pct=self.config.disk_use.warning_percentage,
            readonly_pct=self.config.disk_use.readonly_percentage,
        )
        self.disk_monitor.start()

        if self.config.index_missing_text_filterable_at_startup:
            # startup reindexer (inverted_reindexer_missing_text_filterable
            # analog): backfill filterable postings for props indexed before
            # their indexFilterable flag was enabled
            rebuilt = self.db.reindex_missing_filterable()
            if rebuilt:
                import logging

                logging.getLogger(__name__).info(
                    "filterable backfill rebuilt: %s", rebuilt)

    def _config_fingerprint(self) -> dict:
        """The serving-relevant config knobs + a short digest, stamped
        into every incident bundle so a post-mortem knows exactly what
        configuration produced it. Auth/secrets are deliberately absent."""
        import dataclasses
        import hashlib
        import json as _json

        c = self.config
        knobs = {
            "coalescer": dataclasses.asdict(c.coalescer),
            "tracing": dataclasses.asdict(c.tracing),
            "robustness": dataclasses.asdict(c.robustness),
            "tenancy": dataclasses.asdict(c.tenancy),
            "quality": dataclasses.asdict(c.quality),
            "memory": dataclasses.asdict(c.memory),
            "incidents": dataclasses.asdict(c.incidents),
            "controller": dataclasses.asdict(c.controller),
            "store_dtype": c.store_dtype,
            "device_mesh_shards": c.device_mesh_shards,
        }
        digest = hashlib.sha256(
            _json.dumps(knobs, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]
        return {"sha256_16": digest, "knobs": knobs}

    def _store_opts(self) -> dict:
        """LSM tuning from env (PERSISTENCE_MEMTABLES_MAX_SIZE_MB,
        PERSISTENCE_FLUSH_IDLE_MEMTABLES_AFTER — environment.go surface)."""
        p = self.config.persistence
        return {
            "memtable_max_bytes": int(p.memtables_max_size_mb) * 1024 * 1024,
            "flush_idle_seconds": float(p.flush_idle_memtables_after),
        }

    # -- meta ----------------------------------------------------------------

    def meta(self) -> dict:
        """GET /v1/meta payload (handlers_meta)."""
        return {
            "hostname": self.config.origin or "http://[::]:8080",
            "version": VERSION,
            "modules": self.modules.meta() if self.modules is not None else {},
        }

    def shutdown(self) -> None:
        # the control plane goes FIRST: unconfigure stops the tick
        # thread and reverts every actuated knob to its configured
        # default while the objects it steered (coalescer, tracer,
        # auditor) are still alive — a shut-down App leaves no knob
        # residue behind (still-ours discipline like the tracer)
        if self.control_plane is not None:
            from weaviate_tpu_torch.serving import controller as control

            control.unconfigure(self.control_plane)
        # queued coalescer waiters must wake (with a shutdown error
        # that sends their serving threads to the direct path) before the
        # shards they would dispatch to go away
        if self.coalescer is not None:
            self.coalescer.shutdown()
        # the fused-dispatch toggle reverts to the env default, but only
        # if OUR override is still the current one (a newer App's setting
        # survives) — the same still-ours discipline as the tracer below
        from weaviate_tpu_torch.index import gpu as gpu_index

        gpu_index.unset_fused_enabled(getattr(self, "_fused_token", None))
        if self.tracer is not None:
            from weaviate_tpu_torch.monitoring import tracing

            # clear only if still ours: a newer App's tracer survives
            tracing.unconfigure(self.tracer)
        if self.perf_window is not None:
            from weaviate_tpu_torch.monitoring import perf

            perf.unconfigure(self.perf_window)
        if self.quality_auditor is not None:
            from weaviate_tpu_torch.monitoring import quality

            # same still-ours discipline; also stops the audit workers
            # and stashes the final summary for the CI artifact dump
            quality.unconfigure(self.quality_auditor)
        if self.memory_ledger is not None:
            from weaviate_tpu_torch.monitoring import memory as memledger

            # still-ours discipline; stashes the final summary for the
            # debug_memory.json CI artifact
            memledger.unconfigure(self.memory_ledger)
        if self.ops_journal is not None:
            from weaviate_tpu_torch.monitoring import incidents

            # still-ours discipline; stashes the journal's final summary
            # for the debug_incidents.json CI artifact and stops the
            # recorder worker — a cleanly shut-down App then dumps
            # nothing from the atexit/SIGTERM teardown hook
            incidents.unconfigure(journal=self.ops_journal,
                                  engine=self.slo_engine,
                                  recorder=self.flight_recorder)
        # robustness globals: same still-ours discipline as the tracer
        from weaviate_tpu_torch.serving import robustness

        if self.breaker is not None:
            robustness.unconfigure_breaker(self.breaker)
        if self.tenant_gate is not None:
            robustness.unconfigure_tenant_gate(self.tenant_gate)
        robustness.unset_metrics(self.metrics)
        if self.fault_injector is not None:
            from weaviate_tpu_torch.testing import faults

            faults.unconfigure(self.fault_injector)
        if self.serving_pool is not None:
            self.serving_pool.shutdown(wait=False)
        self.disk_monitor.shutdown()
        self.db.shutdown()
