# The port's copy of weaviate_tpu/serving/coalescer.py, its imports pointed at the port.
"""Cross-request query coalescing: continuous micro-batching for kNN.

The shard read path is batch-first (`Shard.object_vector_search` scores a
whole [B, D] query block in one device dispatch), but that only batches the
vectors INSIDE one request: 256 concurrent single-query REST/GraphQL/gRPC
users cost 256 one-wide dispatches. The distance kernel only approaches
roofline at meaningful batch width, so under concurrent single-query load
the device spends its time on dispatch overhead instead of math.

This module closes that gap with an admission queue in front of the shard:
concurrent requests land in a *lane* keyed by everything that must match for
their rows to share one device dispatch — (shard, k, metric,
filter-signature, include_vector) — and a lane flushes as ONE padded
dispatch when either

  (a) its row count fills the configured batch-width bucket (`max_batch`,
      snapped DOWN to the same padding buckets the index's `_bucket_b`
      rounds query widths to, so a full lane hits the same jit cache as
      direct dispatches without exceeding the configured cap), or
  (b) the deadline window (default ~1.5 ms) since the lane's first arrival
      expires — the Orca/vLLM-style continuous-batching tradeoff: bounded
      added latency buys full-width dispatches.

Dispatch rides the existing two-phase path (`object_vector_search_async`):
the flush thread enqueues device work in dispatch order, while finalize +
hydration runs on a small dispatch pool so lanes overlap device compute
with hydration and with each other. FILTERED lanes ride the same two-phase
pipeline (snapshot-isolated indexes dispatch filtered searches, both PQ
tiers, and the small-allowList gather without a lock — index/gpu.py
IndexSnapshot and the multi-chip twin index/mesh.py MeshSnapshot); only
index types without snapshot dispatch (hnsw, noop) still run their whole
blocking search on the pool.
Results scatter back to per-request waiters. k is deliberately part of the
lane key — requests only share a dispatch at IDENTICAL k — because the
bit-identical contract (coalesced == direct, pinned by the tests) would
not survive dispatching at max-k and trimming: approximate k-selection
(lax.approx_min_k on TPU) is not prefix-stable across different k.

Bypass (the caller uses the direct path, counted per reason): requests
wider than `max_request_rows` (they already fill a dispatch on their own),
filters with no stable signature (a per-request allowList can never share a
lane), COLD filter signatures (first sighting within the recency TTL — a
unique per-tenant filter would otherwise pay the full window in a
singleton lane for zero merging; only filters proven hot by a recent
repeat are queued), multi-shard/remote layouts, a shut-down coalescer,
and a DEAD flush thread (`flusher_dead` — liveness: queueing into a lane
nobody will ever flush would strand every admitted request on its wait
bound).

The flush thread only ADMITS and ENQUEUES: each lane's blocking work
(async finalize + hydration, or the sync filtered search) runs on a small
dispatch pool, so one slow lane — an expensive allowList build, a big
hydration — cannot head-of-line-block other lanes' flushes.

Request-lifecycle robustness (serving/robustness.py):

  - ADMISSION CONTROL: the queue is bounded in ROWS (`max_queued_rows` —
    cost-aware: one 16-row request occupies 16 slots), and a request whose
    estimated queue wait (queued rows over the EWMA service rate) already
    exceeds its remaining deadline is shed at admission — both raise
    ``OverloadedError`` (-> 429/RESOURCE_EXHAUSTED + Retry-After) instead
    of silently stalling the whole client population.

Multi-tenant fairness (ROADMAP item 4 — the PR-6 tentpole). The bounds
above are GLOBAL: without tenant accounting one abusive tenant fills
`max_queued_rows` with its own requests and every other tenant starves
while each individual request stays under the row bound. Admission is
therefore tenant-aware end to end:

  - IDENTITY: every request resolves a tenant (`robustness.
    effective_tenant` — the REST/gRPC `X-Tenant-Id` identity when one
    rode in, else the queried class name) and the tenant is part of the
    lane key: a lane belongs to exactly ONE tenant, so fairness decisions
    and accounting operate on whole lanes.
  - BUDGET: no tenant may occupy more than `tenant_rows_fraction` of
    `max_queued_rows` while other tenants have work in the system
    (`tenant_budget` shed). Occupancy counts a tenant's rows from
    ADMISSION until its lane SETTLES (queued + in-flight): a queue-only
    bound refills the instant the flusher pops a lane, so an abusive
    tenant bounded to N queued rows still monopolizes the dispatch
    pipeline one popped lane at a time — the in-flight extension is
    what actually caps its share of dispatch slots. Alone, a tenant may
    still use the whole queue — the cap costs an only-tenant nothing.
  - DEFICIT ROUND-ROBIN: due lanes drain in weighted DRR order
    (configurable `tenant_weights`, default 1): each tenant's deficit
    grows by `weight * max_batch` rows per round and pays for its lanes
    in rotation, so under a saturated pipeline (depth-1 semaphore — the
    drain ORDER is the fairness lever) an abusive tenant cannot
    monopolize dispatch slots.
  - PER-TENANT SHED ESTIMATES: the deadline-unreachable estimate divides
    the TENANT'S OWN queued rows by its own EWMA drain rate — an abusive
    tenant sheds against its backlog while light tenants admit against
    theirs (a shared estimate would shed everyone for one tenant's
    queue).
  - ACCOUNTING: per-tenant shed/deadline/queue-depth metrics with
    BOUNDED label cardinality (metrics.TenantLabeler: top-K by traffic +
    "other"), tenant tags on dispatch trace records and the admission
    annotation on rider traces, and a `serving.coalescer.admit` fault
    point for abusive-tenant storm journeys.
  - DEADLINES: a waiter carries its request's deadline; the flush path
    fails deadline-expired waiters fast (they never occupy dispatch rows),
    and every waiter wait is bounded by min(remaining deadline, the
    `waiter_timeout_s` liveness cap) — a wedged flush thread can cost a
    client a bounded wait, never a hang.
  - NO ORPHANED LANES: every pool submission carries a done-callback
    (`_reap_lane_future`) that wakes the lane's waiters and frees its
    in-flight slot if the task was cancelled at shutdown or died outside
    its own error handling — waiters never depend on the 0.1 s inflight
    poll (that poll remains only as the flusher's shutdown check).

Error handling is all-or-nothing per lane: a dispatch exception (or
shutdown) propagates to EVERY queued waiter — no request may hang on a
dead batch. The flush loop itself is defended: any unexpected error fails
the affected lanes and the loop keeps serving. (A BaseException — the
fault harness's injected thread death — still kills the thread; the
bounded waits plus the `flusher_dead` bypass keep every client live.)
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

# lane keys reuse the shard's filter-content key, so two requests share a
# lane exactly when they would resolve to the same cached allowList; batch
# caps snap to the index's query-padding buckets so coalesced shapes hit
# the same jit cache as direct dispatches. record_device_fallback hoisted
# to module scope (PR 1 pattern): failure paths must not die on an import.
from weaviate_tpu_torch.db.shard import filter_signature
from weaviate_tpu_torch.index.gpu import _B_BUCKETS
from weaviate_tpu_torch.monitoring import incidents, perf, tracing
from weaviate_tpu_torch.monitoring.metrics import record_device_fallback
# the self-tuning control plane (serving/controller.py): admission reads
# its leased knobs — flush window, admission margin, tenant-cap scale,
# Retry-After scale, tenant rate quotas — each a one-comparison no-op
# while the plane is off. controller never imports this module back
# (it receives the coalescer object at App wiring), so no cycle.
from weaviate_tpu_torch.serving import controller, robustness
from weaviate_tpu_torch.testing import faults, sanitizers


class CoalescerShutdownError(RuntimeError):
    """Raised to waiters whose lane was still queued at shutdown."""


class CoalescerTimeoutError(RuntimeError):
    """A waiter's liveness bound expired before its lane resolved (wedged
    or dead flush path). The serving thread retries on the direct path —
    this is NOT a deadline error (the request's own budget may be fine)."""


def _bucket_floor(n: int) -> int:
    """Largest index padding bucket <= n (the DOWN twin of gpu._bucket_b):
    a full lane then lands exactly on a bucket without ever exceeding the
    operator's configured cap. Beyond the largest bucket the index pads in
    multiples of it, so the floor follows the same rule."""
    top = _B_BUCKETS[-1]
    if n >= top:
        return (n // top) * top
    best = _B_BUCKETS[0]
    for s in _B_BUCKETS:
        if s <= n:
            best = s
    return best


class _Waiter:
    """One queued request: its rows plus the rendezvous the serving thread
    blocks on. `trace_span` is the submitter's active span, captured on the
    serving thread at admission — the explicit handoff that carries trace
    context across the flush-thread / dispatch-pool boundary (contextvars
    do not follow the lane). `deadline` is captured the same way: the
    flush path prunes expired waiters, and wait() is bounded by it."""

    __slots__ = ("vectors", "event", "result", "error", "enqueued_at",
                 "trace_span", "deadline", "max_wait_s", "tenant",
                 "tenant_label")

    def __init__(self, vectors: np.ndarray, max_wait_s: float = 30.0,
                 tenant: Optional[str] = None, tenant_label: str = ""):
        self.vectors = vectors
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.monotonic()
        self.trace_span = tracing.current_span()
        self.deadline = robustness.current_deadline()
        self.max_wait_s = max_wait_s
        self.tenant = tenant
        self.tenant_label = tenant_label

    def wait(self):
        """Block until the lane resolves -> per-row result lists. BOUNDED:
        by the request's remaining deadline when one is set (plus a small
        grace for the scatter), and always by `max_wait_s` — a wedged
        flush thread can never hang a client forever. A deadline-bound
        timeout raises DeadlineExceededError (fail fast, no retry); a
        liveness-bound one raises CoalescerTimeoutError (the serving
        thread retries on the direct path)."""
        timeout = self.max_wait_s
        d = self.deadline
        if d is not None:
            timeout = min(timeout, max(d.remaining_s(), 0.0) + 0.05)
        if not self.event.wait(timeout):
            if d is not None and d.expired():
                robustness.count_deadline("coalescer.wait")
                robustness.count_tenant_deadline(self.tenant)
                raise robustness.DeadlineExceededError(
                    "request deadline expired waiting for a coalesced "
                    "dispatch")
            # degraded liveness path: the caller re-runs direct — make the
            # double device work countable, not invisible
            record_device_fallback("serving.coalescer", "waiter_timeout",
                                   note=f"waited {timeout:.1f}s")
            raise CoalescerTimeoutError(
                f"coalesced dispatch did not resolve within {timeout:.1f}s "
                "(wedged or dead flush path); retry direct")
        if self.error is not None:
            raise self.error
        return self.result


class _Lane:
    """Accumulating batch for one (tenant, shard, k, metric, filter-sig,
    inc_vec) key. Never touched outside the coalescer lock until popped
    for flush. `settled`/`released` (guarded by the coalescer lock) make
    waiter wakeup and in-flight-slot release idempotent across the normal
    path and the pool-future reaper. A lane belongs to exactly ONE tenant
    (the tenant is part of the key), so DRR drains whole lanes and the
    per-tenant row accounting is exact; `tenant_label` is the bounded
    metric label captured at lane creation — gauge inc/dec must use the
    SAME label even if the labeler's top-K churns in between."""

    __slots__ = ("key", "shard", "flt", "k", "include_vector", "items",
                 "rows", "deadline", "settled", "released", "dispatch_start",
                 "tenant", "tenant_label")

    def __init__(self, key, shard, flt, k: int, include_vector: bool,
                 deadline: float, tenant: str = "",
                 tenant_label: str = ""):
        self.key = key
        self.shard = shard
        self.flt = flt
        self.k = k
        self.include_vector = include_vector
        self.items: list[_Waiter] = []
        self.rows = 0
        self.deadline = deadline
        self.settled = False     # waiters woken (resolved or failed)
        self.released = False    # in-flight slot given back
        self.dispatch_start: Optional[float] = None
        self.tenant = tenant
        self.tenant_label = tenant_label


class _TenantState:
    """Per-tenant fairness bookkeeping, guarded by the coalescer lock:
    in-system rows (admission -> lane settle, the budget cap's
    numerator), the tenant's own EWMA drain rate (rows/s — feeds ITS
    deadline-unreachable estimate), and shed counts for stats()/bench.
    DRR deficits are deliberately NOT stored here: classic DRR forfeits
    credit when a queue empties, and every _drr_order call drains its
    whole input, so deficits are per-call locals — persistent fields
    would imply cross-flush carryover that does not exist."""

    __slots__ = ("tenant", "weight", "rows", "ewma_rows_per_s",
                 "shed", "last_seen")

    def __init__(self, tenant: str, weight: float = 1.0):
        self.tenant = tenant
        self.weight = max(float(weight), 0.001)
        self.rows = 0
        self.ewma_rows_per_s = 0.0
        self.shed: dict[str, int] = {}
        self.last_seen = time.monotonic()


class QueryCoalescer:
    def __init__(self, window_s: float = 0.0015, max_batch: int = 256,
                 max_request_rows: int = 16, metrics=None,
                 pipeline_depth: int = 1, max_queued_rows: int = 4096,
                 waiter_timeout_s: float = 30.0,
                 tenant_weights: Optional[dict] = None,
                 tenant_rows_fraction: float = 0.5):
        self.window_s = max(float(window_s), 0.0)
        # snap DOWN to the index's padding buckets: a full lane then
        # compiles/hits the exact shape a direct dispatch of that width
        # would, and the configured cap is never exceeded (snapping up
        # would silently inflate the operator's dispatch-size bound 4x)
        self.max_batch = max(_bucket_floor(max(int(max_batch), 2)), 2)
        if self.max_batch != int(max_batch):
            import logging

            # visible, or an operator watching the occupancy histogram top
            # out below their configured cap has nothing to explain it
            logging.getLogger(__name__).info(
                "query coalescer max_batch %d snapped DOWN to padding "
                "bucket %d (buckets: %s)", int(max_batch), self.max_batch,
                _B_BUCKETS)
        # re-clamp AFTER the snap: config validates against the unsnapped
        # cap, and a single admitted request must never overflow a dispatch
        self.max_request_rows = max(
            1, min(int(max_request_rows), self.max_batch))
        # admission bound in ROWS (cost-aware shedding: a 16-row request
        # costs 16 queue slots); overflow sheds with OverloadedError
        self.max_queued_rows = max(int(max_queued_rows), 1)
        self.waiter_timeout_s = max(float(waiter_timeout_s), 0.001)
        self.metrics = metrics
        self._lock = sanitizers.register_lock(
            threading.Lock(), "serving.coalescer")
        self._cv = threading.Condition(self._lock)
        self._lanes: dict[tuple, _Lane] = {}
        self._full: list[_Lane] = []  # popped at submit time, flush ASAP
        self._queued_rows = 0
        self._closed = False
        # filter-signature recency: a filtered request only queues when its
        # signature was seen within the TTL (someone to merge with is
        # plausible); a cold signature bypasses so one-off filters never
        # pay the window for an inevitable singleton lane
        self._sig_ttl = max(1.0, self.window_s * 100.0)
        self._recent_sigs: dict[str, float] = {}
        # cheap python-side counters (bench/tests read these without a
        # prometheus round trip; the histograms carry the same data)
        self._dispatches = 0
        self._dispatched_requests = 0
        self._dispatched_rows = 0
        self._bypass: dict[str, int] = {}
        self._shed: dict[str, int] = {}
        # multi-tenant fairness state (guarded by the coalescer lock):
        # per-tenant queued rows / DRR deficit / own-EWMA, the configured
        # weights, and the per-tenant slice of max_queued_rows no tenant
        # may exceed while others are waiting. The cap never falls below
        # max_request_rows: a budget smaller than one admissible request
        # would deadlock that tenant outright.
        self._tenant_weights = dict(tenant_weights or {})
        self.tenant_rows_fraction = min(max(float(tenant_rows_fraction),
                                            0.01), 1.0)
        self._tenant_row_cap = max(
            int(self.max_queued_rows * self.tenant_rows_fraction),
            self.max_request_rows)
        self._tenants: dict[str, _TenantState] = {}
        # sum of every tenant's in-system rows (admission -> settle);
        # "other tenants have work" is then one subtraction, not a scan
        self._pipeline_rows_total = 0
        self._drr_cursor = 0
        # EWMA of the PER-LANE dispatch service rate (rows/s), fed by
        # resolved lanes: the admission-time queue-wait estimate that
        # sheds requests whose deadline the queue can't meet. 0.0 =
        # unknown (no resolved dispatch yet) — only the hard row cap
        # sheds then. Up to `pipeline_depth` lanes drain CONCURRENTLY, so
        # the aggregate drain rate is ~depth x the per-lane EWMA — the
        # estimate divides by it, or shedding would over-fire by depth x
        # exactly under the load it protects.
        self._depth = max(int(pipeline_depth), 1)
        # pipeline-depth decrements can't forcibly reclaim a busy permit:
        # set_pipeline_depth records a deficit that _release_lane consumes
        # (the next lane completions simply don't give their slots back)
        self._depth_deficit = 0
        self._ewma_rows_per_s = 0.0
        # blocking per-lane work (finalize+hydration, sync filtered search)
        # runs on this pool; the flush thread only admits/enqueues, capped
        # at `pipeline_depth` lanes in flight. While every slot is busy the
        # flusher BLOCKS — that stall is the backpressure that lets the
        # next window's lanes accumulate to full width. Measured on the
        # CPU-JAX acceptance workload (64 clients, n=50k): depth 1 = 4.7x
        # the uncoalesced QPS at ~30 requests/dispatch; depth 2 = 2.7x at
        # ~13 (two in-flight scans contend for the same host cores);
        # unbounded = 1.3x at ~5 (no backpressure, every window flushes
        # thin). Depth 1 is therefore the default; a real TPU backend,
        # where finalize/hydration is host work that overlaps device
        # compute, is the case for raising it to 2.
        self._inflight = threading.Semaphore(max(int(pipeline_depth), 1))
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=max(int(pipeline_depth), 1) + 2,
            thread_name_prefix="coalescer-dispatch")
        # front-door sheds (the tenant concurrency gate) hint with this
        # coalescer's per-tenant drain estimate instead of a constant.
        # The bound method is captured ONCE: `self.retry_hint` mints a
        # new object per access, and shutdown's still-ours clearing
        # compares by identity
        self._retry_hint_fn = self.retry_hint
        robustness.set_retry_hint_provider(self._retry_hint_fn)
        self._thread = threading.Thread(
            target=self._run, name="query-coalescer", daemon=True)
        self._thread.start()

    # -- admission -----------------------------------------------------------

    def submit(self, shard, vectors: np.ndarray, k: int, flt=None,
               include_vector: bool = False, tenant: Optional[str] = None):
        """Queue a request's rows for a coalesced dispatch.

        -> a blocking callable() -> list[list[SearchResult]] (one list per
        row), or None when the request must bypass to the direct path
        (reason counted). Raises DeadlineExceededError for an
        already-expired request (fail fast: it must not occupy queue
        rows), and OverloadedError when admission control sheds it
        (bounded queue full, the tenant's row budget exhausted while
        others wait, or the tenant's estimated queue wait exceeds the
        remaining deadline) — shed requests must NOT fall through to the
        direct path, or shedding would shed nothing.

        `tenant` is the request's accounting identity; None resolves via
        robustness.effective_tenant (explicit X-Tenant-Id, else the
        shard's class name)."""
        robustness.check_deadline("coalescer.admit")
        # fault-injection point: the abusive-tenant storm journeys inject
        # stalls/errors at ADMISSION — before any queue state is touched,
        # so an injected failure can never strand a half-admitted waiter
        faults.fire("serving.coalescer.admit")
        if tenant is None:
            cd = getattr(shard, "class_def", None)
            tenant = robustness.effective_tenant(
                getattr(cd, "name", None) or "default")
        q = np.asarray(vectors, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[0] > self.max_request_rows:
            self.record_bypass("oversize")
            return None
        sig = filter_signature(flt)
        if sig is None:
            self.record_bypass("unique_allow_list")
            return None
        if not self._thread.is_alive():
            # liveness: a dead flush thread (fault-injected or real) must
            # not collect requests into lanes nobody will ever flush. A
            # normally-shut-down coalescer also has no flusher — keep that
            # counted as "shutdown", not as a liveness incident.
            with self._lock:
                closed_now = self._closed
            if not closed_now:
                # a DEAD flusher (not a clean shutdown) is an incident:
                # journal it (burst-coalesced — every admission attempt
                # lands here while it stays dead) and fire the flight
                # recorder so the thread's last state is preserved. Both
                # are one-comparison no-ops when the plane is off and
                # exception-guarded internally (monitoring/incidents.py).
                incidents.emit("flusher_dead", scope="serving.coalescer")
                incidents.trigger(
                    "flusher_dead",
                    reason="coalescer flush thread died; admissions "
                           "bypassing to the direct path")
            self.record_bypass("shutdown" if closed_now else "flusher_dead")
            return None
        # tenant rate quota (serving/controller.py token buckets —
        # TENANT_RATE_QPS x DRR weight): the PR-6 row budget bounds
        # OCCUPANCY, this bounds request RATE. Checked before any queue
        # state is touched; Retry-After = time-to-next-token, scaled up
        # while the brownout ladder is engaged. One comparison when the
        # control plane is off.
        ra_rate = controller.take_rate_token(tenant)
        if ra_rate is not None:
            self._record_shed("tenant_rate", tenant)
            raise robustness.OverloadedError(
                f"tenant {tenant!r} over its request-rate quota "
                "(TENANT_RATE_QPS)",
                retry_after_s=ra_rate * controller.retry_after_scale())
        d = robustness.current_deadline()
        # tenant first in the key: a lane belongs to one tenant (fair
        # drain + exact accounting); dim is part of the key so a
        # wrong-dim request lands in its own lane and fails ALONE, not
        # poisoning the concatenate of its lane-mates
        key = (tenant, id(shard), int(k),
               getattr(shard.vector_index, "metric", ""),
               sig, bool(include_vector), int(q.shape[1]))
        cold = False
        shed_reason: Optional[str] = None
        # cold-start fallback hint (no resolved dispatch yet => no drain
        # EWMA anywhere): a few flush windows is the only drain clock the
        # server has — every warmer path below replaces it with a
        # measured estimate
        retry_after = max(self.window_s * 4.0, 0.05)
        eff_cap = self._tenant_row_cap
        with self._cv:
            closed = self._closed
            if not closed and sig:
                # filtered request: queue only when this signature was seen
                # recently (a lane-mate is plausible); cold signatures go
                # direct — a one-off per-tenant filter must not pay the
                # window for a singleton lane
                now = time.monotonic()
                last = self._recent_sigs.get(sig)
                self._recent_sigs[sig] = now
                if len(self._recent_sigs) > 1024:
                    pruned = {s: t for s, t in self._recent_sigs.items()
                              if now - t <= self._sig_ttl}
                    # all-hot overflow (>1024 live signatures inside the
                    # TTL): pruning can't shrink, and rebuilding O(n) under
                    # the admission lock on EVERY submit would serialize the
                    # fast path — reset instead; hot filters re-warm with
                    # one direct request each, amortized O(1) per overflow
                    self._recent_sigs = (pruned if len(pruned) <= 896
                                         else {sig: now})
                cold = last is None or now - last > self._sig_ttl
            if not closed and not cold:
                st = self._tenant_state(tenant)
                # admission control BEFORE touching any lane: shed with a
                # retry hint instead of silently stalling. Cost-aware: the
                # bound is ROWS. Tenant-aware: the budget counts the
                # tenant's rows from admission to lane SETTLE and fires
                # only while OTHER tenants have work in the system
                # (alone, a tenant may use the whole queue), and the
                # deadline-unreachable estimate divides the tenant's OWN
                # backlog by its OWN drain rate — an abusive tenant sheds
                # against its queue, light tenants admit against theirs.
                rows = int(q.shape[0])
                rate = st.ewma_rows_per_s or self._ewma_rows_per_s
                est_wait = (st.rows / (rate * self._depth)
                            if rate > 0.0 else None)
                global_est = (
                    self._queued_rows / (self._ewma_rows_per_s * self._depth)
                    if self._ewma_rows_per_s > 0.0 else None)
                # control-plane knobs (one comparison each when off): the
                # brownout ladder inflates the wait estimate (shed
                # earlier) and shrinks the per-tenant cap under burn
                eff_cap = self._tenant_row_cap
                cap_scale = controller.tenant_cap_scale()
                if cap_scale != 1.0:
                    # never below one admissible request — a scaled cap
                    # must not deadlock a tenant the configured cap admits
                    eff_cap = max(int(eff_cap * cap_scale),
                                  self.max_request_rows)
                if self._queued_rows + rows > self.max_queued_rows:
                    shed_reason = "queue_full"
                    if global_est is not None:
                        retry_after = global_est
                elif (st.rows + rows > eff_cap
                      and self._pipeline_rows_total > st.rows):
                    shed_reason = "tenant_budget"
                    if est_wait is not None:
                        retry_after = est_wait
                elif (d is not None and est_wait is not None
                      and est_wait * controller.admission_margin()
                      > max(d.remaining_s(), 0.0)):
                    shed_reason = "deadline_unreachable"
                    retry_after = est_wait
            if not closed and not cold and shed_reason is None:
                # wake the flusher only when the picture it sleeps on
                # changes: a new lane (new earliest deadline) or a lane
                # popped to _full (new due work). Appending to an existing
                # lane changes neither — notifying there would wake/rescan
                # the flusher once per REQUEST on the hot path instead of
                # once per window.
                wake = False
                lane = self._lanes.get(key)
                if lane is not None and lane.rows + q.shape[0] > self.max_batch:
                    # this request would overflow the bucket: flush the lane
                    # as-is and start fresh — a dispatch must never exceed
                    # max_batch, or it pads to the NEXT bucket and compiles
                    # a shape the direct path never uses
                    del self._lanes[key]
                    self._full.append(lane)
                    lane = None
                    wake = True
                if lane is None:
                    # flush window: controller-steered (leased knob,
                    # clamped to the configured band; the configured
                    # default while the plane is off/stale). Read at lane
                    # creation so an actuation applies from the NEXT lane
                    # — in-flight lanes keep the deadline they promised.
                    lane = _Lane(key, shard, flt, int(k),
                                 bool(include_vector),
                                 time.monotonic()
                                 + controller.coalescer_window_s(
                                     self.window_s),
                                 tenant=tenant,
                                 tenant_label=self._tenant_label(tenant))
                    self._lanes[key] = lane
                    wake = True
                w = _Waiter(q, max_wait_s=self.waiter_timeout_s,
                            tenant=tenant, tenant_label=lane.tenant_label)
                lane.items.append(w)
                lane.rows += q.shape[0]
                self._queued_rows += q.shape[0]
                st.rows += q.shape[0]
                self._pipeline_rows_total += q.shape[0]
                st.last_seen = time.monotonic()
                if lane.rows >= self.max_batch:
                    # bucket full: pop now so later arrivals start fresh
                    del self._lanes[key]
                    self._full.append(lane)
                    wake = True
                self._set_depth_gauge()
                self._tenant_gauge(lane.tenant_label, q.shape[0])
                if wake:
                    self._cv.notify()
        if closed:
            # outside the lock: record_bypass takes it again
            self.record_bypass("shutdown")
            return None
        if cold:
            self.record_bypass("cold_filter")
            return None
        if shed_reason is not None:
            self._record_shed(shed_reason, tenant)
            if shed_reason == "queue_full":
                detail = (f"{self._queued_rows} rows queued, cap "
                          f"{self.max_queued_rows}")
            else:
                # tenant-scoped reasons cite the TENANT's numbers: a 429
                # naming a near-empty global queue would read as a bug to
                # the operator debugging it
                st_now = self._tenants.get(tenant)
                detail = (f"tenant {tenant!r}: "
                          f"{st_now.rows if st_now is not None else 0} "
                          f"rows in system, tenant cap {eff_cap}")
            # the hint scales up while the brownout ladder is engaged —
            # under burn, backing clients off harder IS the actuation
            raise robustness.OverloadedError(
                f"query admission queue overloaded ({shed_reason}: "
                f"{detail})",
                retry_after_s=retry_after * controller.retry_after_scale())
        # outside the lock: the tenant tag lands on the rider's trace at
        # admission (the slow-query log's join key), and the per-tenant
        # admitted-request counter moves through the bounded labeler
        tracing.annotate_current("tenant", tenant)
        m = self.metrics
        if m is not None:
            try:
                m.tenant_requests.labels(
                    m.tenant_labels.observe(tenant)).inc()
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass
        return w.wait

    def record_bypass(self, reason: str) -> None:
        """Count a request that took the direct path instead of the queue."""
        # always called on the bypassing request's own serving thread, so
        # the reason lands on ITS trace (the direct dispatch that follows
        # records its own spans there too)
        tracing.annotate_current("coalescer_bypass", reason)
        with self._lock:
            self._bypass[reason] = self._bypass.get(reason, 0) + 1
        m = self.metrics
        if m is not None:
            try:
                m.coalescer_bypass.labels(reason).inc()
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def _record_shed(self, reason: str, tenant: Optional[str] = None) -> None:
        tracing.annotate_current("coalescer_shed", reason)
        if tenant:
            tracing.annotate_current("tenant", tenant)
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
            if tenant:
                st = self._tenant_state(tenant)
                st.shed[reason] = st.shed.get(reason, 0) + 1
        robustness.count_shed(reason)
        robustness.count_tenant_shed(tenant, reason)

    # -- per-tenant fairness state (callers hold the coalescer lock unless
    # -- noted) ---------------------------------------------------------------

    def _tenant_state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = _TenantState(tenant, self._tenant_weights.get(tenant, 1.0))
            self._tenants[tenant] = st
            if len(self._tenants) > 1024:
                # a storm of invented tenant ids must not grow this dict
                # without bound: drop idle states (no queued rows), oldest
                # first — their deficit/EWMA re-warm on the next request
                idle = sorted((t for t, s in self._tenants.items()
                               if s.rows <= 0 and t != tenant),
                              key=lambda t: self._tenants[t].last_seen)
                for t in idle[: max(len(self._tenants) - 768, 0)]:
                    del self._tenants[t]
        return st

    def _tenant_label(self, tenant: str) -> str:
        """Bounded metric label for `tenant` (no lock needed — the labeler
        has its own)."""
        m = self.metrics
        if m is None:
            return tenant
        try:
            return m.tenant_labels.label_for(tenant)
        except Exception:  # noqa: BLE001 — metrics must not break serving
            return tenant

    def _tenant_gauge(self, label: str, delta: int) -> None:
        """Move the per-tenant queued-rows gauge by `delta` under the SAME
        label the lane captured at creation (labeler churn between inc
        and dec must not leak gauge value into another label)."""
        m = self.metrics
        if m is not None and label:
            try:
                m.tenant_queued_rows.labels(label).inc(delta)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def _merge_due(self, due: "list[_Lane]") -> "list[_Lane]":
        """Coalesce due lanes that differ ONLY by tenant into one
        dispatch-ready lane (runs after _drr_order, flusher-owned lanes,
        no lock needed). The base key — (shard, k, metric, filter-sig,
        include_vector, dim) — is exactly the pre-tenancy lane key, so a
        merged dispatch is bit-identical to what the tenant-blind
        coalescer would have dispatched. DRR order is preserved: the
        accumulator lane keeps the earliest DRR position, and when a
        merged dispatch would exceed max_batch the overflow starts a new
        one in order — under contention the DRR-favored tenants' rows
        get the batch slots, which IS the weighted-fair drain."""
        groups: dict[tuple, _Lane] = {}
        out: list[_Lane] = []
        for ln in due:
            base = ln.key[1:] if isinstance(ln.key, tuple) else ln.key
            acc = groups.get(base)
            if acc is None or acc.rows + ln.rows > self.max_batch:
                groups[base] = ln
                out.append(ln)
                continue
            acc.items.extend(ln.items)
            acc.rows += ln.rows
            if acc.tenant != ln.tenant:
                # mixed riders: per-waiter accounting handles budgets and
                # gauges; the lane-level tag only labels traces
                acc.tenant = "multi"
                acc.tenant_label = ""
        return out

    def _drr_order(self, due: "list[_Lane]") -> "list[_Lane]":
        """Deficit-round-robin over the due lanes' tenants (caller holds
        the coalescer lock). Per round, each tenant's deficit grows by
        `weight * max_batch` rows and pays for its lanes (FIFO within the
        tenant) while the deficit covers them — a weight-2 tenant drains
        two full dispatches for a weight-1 tenant's one. Classic DRR
        discipline: a tenant whose queue empties forfeits its remaining
        deficit (credit must not accumulate while idle), and the rotation
        start advances every cycle so the same tenant never structurally
        goes first. Single-tenant input returns unchanged (FIFO — the
        anonymous same-class common case pays nothing)."""
        by_t: dict[str, deque] = {}
        for ln in due:
            by_t.setdefault(ln.tenant, deque()).append(ln)
        if len(by_t) <= 1:
            return due
        rotation = list(by_t.keys())
        start = self._drr_cursor % len(rotation)
        rotation = rotation[start:] + rotation[:start]
        self._drr_cursor += 1
        quantum = float(self.max_batch)
        deficits = {t: 0.0 for t in rotation}  # per-call: see _TenantState
        order: list[_Lane] = []
        while by_t:
            for t in rotation:
                q = by_t.get(t)
                if q is None:
                    continue
                deficits[t] += quantum * self._tenant_state(t).weight
                while q and q[0].rows <= deficits[t]:
                    ln = q.popleft()
                    deficits[t] -= ln.rows
                    order.append(ln)
                if not q:
                    del by_t[t]
        return order

    # -- flush loop ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            # fault-injection point: a `die` action here (BaseException)
            # kills the flush thread the way a real thread death would —
            # liveness then rests on bounded waiter waits + the
            # `flusher_dead` bypass, which the journey tests pin
            faults.fire("serving.coalescer.flush")
            due: list[_Lane] = []
            with self._cv:
                while not self._closed:
                    now = time.monotonic()
                    due = self._full
                    self._full = []
                    expired = [k for k, ln in self._lanes.items()
                               if ln.deadline <= now]
                    for k in expired:
                        due.append(self._lanes.pop(k))
                    if due:
                        break
                    timeout = None
                    if self._lanes:
                        timeout = max(
                            min(ln.deadline for ln in self._lanes.values())
                            - now, 0.0)
                    self._cv.wait(timeout)
                if self._closed:
                    due.extend(self._full)
                    due.extend(self._lanes.values())
                    self._full = []
                    self._lanes.clear()
                for ln in due:
                    # global queue bound releases at pop; the PER-TENANT
                    # budget holds until the lane SETTLES (_mark_settled)
                    # — a queue-only budget would refill the instant the
                    # flusher popped, letting one tenant monopolize the
                    # dispatch pipeline one popped lane at a time
                    self._queued_rows -= ln.rows
                if len(due) > 1:
                    # weighted-fair drain: under a saturated pipeline the
                    # in-flight semaphore serializes dispatches, so the
                    # ORDER lanes leave this loop is the fairness lever —
                    # deficit-round-robin across tenants replaces FIFO
                    due = self._drr_order(due)
                self._set_depth_gauge()
                closed = self._closed
            if closed:
                err = CoalescerShutdownError(
                    "query coalescer shut down with requests queued")
                for ln in due:
                    self._fail_lane(ln, err)
                return
            if len(due) > 1:
                # per-tenant lanes are the DRR sub-queues; compatible
                # ones MERGE back into one device dispatch here (the
                # issue's "sub-queues drained by DRR into lanes"):
                # isolation lives in admission budgets and drain order,
                # while the dispatch itself stays shared — an admitted
                # abusive rider widens a light tenant's batch instead of
                # serializing a whole dispatch ahead of it
                due = self._merge_due(due)
            try:
                self._flush(due)
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # anything _flush itself failed to contain: no waiter may
                # hang, and the next window must still be served
                for ln in due:
                    self._fail_lane(ln, e)

    def _settle_discard(self, done) -> None:
        """Settle an orphaned, already-enqueued dispatch (results
        discarded) WITHOUT blocking the flusher: done() is a blocking
        device fetch, and a wedged device must never pin the flush
        thread (shutdown joins it with a bounded timeout). Runs on the
        dispatch pool; if the pool is already torn down the dispatch is
        abandoned — the process is exiting and the index's in-flight
        gauge dies with it."""
        def run() -> None:
            try:
                done()
            except Exception:  # noqa: BLE001 — results already discarded
                pass

        try:
            self._dispatch_pool.submit(run)
        except Exception:  # noqa: BLE001 — pool shut down: abandon
            pass

    def _acquire_slot(self) -> bool:
        """Block until one of the `pipeline_depth` in-flight slots frees,
        or the coalescer closes (-> False). The 0.1 s poll is ONLY the
        flusher's shutdown check: a pool task that dies frees its slot
        via _reap_lane_future."""
        while not self._inflight.acquire(timeout=0.1):
            if self._closed:
                return False
        return True

    def _flush(self, due: list[_Lane]) -> None:
        """Pipelined flush. Async-capable unfiltered lanes ENQUEUE their
        device program on this thread FIRST and only then wait for an
        in-flight slot — so lane i+1's device compute is already queued
        behind lane i's program while lane i's blocking fetch/hydration
        is still in flight (the fused-dispatch host pipelining: the
        existing `pipeline_depth` cap still bounds concurrent finalizes,
        and the flusher's stall on a busy pipeline is still the
        backpressure that lets the next window's lanes fill). Sync and
        filtered lanes take their slot first as before — their whole
        search runs on the dispatch pool."""
        for i, ln in enumerate(due):
            if not self._prune_expired(ln):
                # every rider's deadline passed in the queue: the lane
                # must not occupy a dispatch slot (none acquired yet)
                self._mark_settled(ln)
                continue
            done = rec = None
            slot = False
            try:
                faults.fire("serving.coalescer.dispatch")
                vidx = ln.shard.vector_index
                async_plain = (hasattr(vidx, "search_by_vectors_async")
                               and ln.flt is None)
                if async_plain:
                    # enqueue BEFORE taking a slot: the device work of
                    # this lane overlaps the previous lane's fetch
                    q = (ln.items[0].vectors if len(ln.items) == 1
                         else np.concatenate([w.vectors for w in ln.items]))
                    self._observe_wait(ln)  # queue wait ends at dispatch
                    rec = self._trace_record(ln)
                    done = ln.shard.object_vector_search_async(
                        q, ln.k, include_vector=ln.include_vector)
                if not self._acquire_slot():
                    # shutdown while waiting: nothing may hang — fail
                    # EVERY waiter first (immediate wakeups), and only
                    # then settle the already-enqueued dispatch (results
                    # discarded): done() is a blocking fetch, and a
                    # wedged device must not stand between the remaining
                    # lanes' waiters and their shutdown error
                    err = CoalescerShutdownError(
                        "query coalescer shut down with requests queued")
                    self._fail_lane(ln, err)
                    for rest in due[i + 1:]:
                        self._fail_lane(rest, err)
                    if done is not None:
                        if rec is not None:
                            # a dispatch DID run: close the riders' spans
                            # (attribution spans never leak — the PR-3
                            # contract) even though the results are about
                            # to be discarded
                            try:
                                rec.finish()
                            except Exception:  # noqa: BLE001 — teardown
                                pass
                        self._settle_discard(done)
                    return
                slot = True
                if async_plain:
                    self._submit_lane_task(self._finalize_async, ln, done,
                                           rec)
                elif ln.flt is not None and hasattr(
                        vidx, "search_by_vectors_async"):
                    # filtered lanes: the allowList resolution (an
                    # inverted-index scan on a cache miss) must not
                    # head-of-line block the flusher — resolve, enqueue
                    # AND finalize on the pool. The search itself still
                    # rides the lock-free two-phase snapshot path inside
                    # object_vector_search_async (or the sync fallback
                    # for index types without filtered async).
                    self._submit_lane_task(self._dispatch_filtered, ln)
                else:
                    # indexes without true async dispatch (hnsw,
                    # noop): the whole blocking search runs on the pool —
                    # object_vector_search_async's sync fallback would
                    # otherwise execute it inline in THIS thread and
                    # head-of-line-block every other lane
                    self._submit_lane_task(self._dispatch_sync, ln)
            except Exception as e:  # noqa: BLE001 — propagate to all waiters
                # covers pool.submit after shutdown too: no waiter may hang
                self._fail_lane(ln, e)
                if slot:
                    self._release_lane(ln)
                if done is not None:
                    if rec is not None:
                        # a dispatch WAS enqueued and its finalize task
                        # never ran: close the riders' spans here (an
                        # enqueue that itself raised leaves rec unused —
                        # no dispatch happened, so no span is fabricated)
                        try:
                            rec.finish()
                        except Exception:  # noqa: BLE001 — failed lane
                            pass
                    # settle the enqueued dispatch so the index's
                    # in-flight gauge and any device work don't leak;
                    # results are discarded, and the blocking fetch stays
                    # off the flusher thread
                    self._settle_discard(done)

    def _submit_lane_task(self, fn, lane: _Lane, *args) -> None:
        """Pool submission with a reaper: if the task is cancelled at
        shutdown before running, or dies OUTSIDE its own error handling
        (BaseException, pool teardown), its waiters still wake and its
        in-flight slot still frees — nobody waits on the 0.1 s poll."""
        fut = self._dispatch_pool.submit(fn, lane, *args)
        fut.add_done_callback(functools.partial(self._reap_lane_future, lane))

    def _reap_lane_future(self, lane: _Lane, fut) -> None:
        if fut.cancelled():
            err: BaseException = CoalescerShutdownError(
                "dispatch task cancelled before running")
        else:
            err = fut.exception()
            if err is None:
                return  # the task ran its own settle/release path
            if not isinstance(err, Exception):
                # a BaseException must not propagate into a serving thread
                err = RuntimeError(
                    f"coalescer dispatch task died: {err!r}")
        self._fail_lane(lane, err)
        self._release_lane(lane)

    # -- lane lifecycle (idempotent under the coalescer lock) ----------------

    def _release_rows_locked(self, waiters) -> "list[tuple[str, int]]":
        """Release `waiters`' per-tenant budget rows (caller holds the
        coalescer lock). Accounting is PER WAITER, not per lane — a
        flush-merged dispatch carries several tenants' riders in one
        lane. -> [(gauge label, rows)] for the metric moves the caller
        makes OFF-lock."""
        out = []
        for w in waiters:
            rows = int(w.vectors.shape[0])
            st = self._tenants.get(w.tenant or "")
            if st is not None:
                st.rows = max(st.rows - rows, 0)
            self._pipeline_rows_total = max(
                self._pipeline_rows_total - rows, 0)
            out.append((w.tenant_label, rows))
        return out

    def _mark_settled(self, lane: _Lane) -> bool:
        """First-caller-wins claim on waking the lane's waiters. The
        claim also RELEASES the waiters' per-tenant budget rows
        (admission -> settle is the occupancy the tenant_budget cap
        bounds)."""
        with self._lock:
            if lane.settled:
                return False
            lane.settled = True
            released = self._release_rows_locked(lane.items)
        for label, rows in released:
            self._tenant_gauge(label, -rows)
        return True

    def _release_lane(self, lane: _Lane) -> None:
        """Give the lane's in-flight slot back exactly once. A pending
        pipeline-depth decrement (set_pipeline_depth) consumes the slot
        instead of returning it — depth shrinks as lanes complete, never
        by forcing an in-flight dispatch."""
        with self._lock:
            if lane.released:
                return
            lane.released = True
            if self._depth_deficit > 0:
                self._depth_deficit -= 1
                return
        self._inflight.release()

    def set_pipeline_depth(self, depth: int) -> int:
        """Adjust the in-flight lane cap at runtime (the control plane's
        lane controller; serving/controller.py is the only caller
        outside tests — graftlint JGL014). Increases release permits
        immediately; decreases queue a deficit that completing lanes
        absorb. -> the depth now in effect for the shed estimator."""
        depth = max(int(depth), 1)
        to_release = 0
        with self._lock:
            delta = depth - self._depth
            self._depth = depth
            if delta > 0:
                consumed = min(self._depth_deficit, delta)
                self._depth_deficit -= consumed
                to_release = delta - consumed
            elif delta < 0:
                self._depth_deficit += -delta
        for _ in range(to_release):
            self._inflight.release()
        return depth

    def retry_hint(self, tenant: Optional[str]) -> Optional[float]:
        """Estimated seconds until `tenant` could be served again — the
        Retry-After basis for front-door sheds
        (robustness.drain_retry_hint). Two drain clocks, whichever is
        slower: the tenant's own in-system backlog at ITS drain rate
        (a gate slot frees when one of its own requests finishes), and
        the SHARED queue backlog at the global rate — a gate-capped
        tenant holds almost no rows of its own, so under congestion the
        shared clock is the honest one; hinting from the tenant clock
        alone told a storm's abuser "retry in 50 ms" while every request
        was taking 500, and the refusal churn starved the light tenants.
        None while nothing has resolved yet (the caller keeps its
        cold-start default)."""
        with self._lock:
            st = self._tenants.get(tenant or "")
            t_rate = (st.ewma_rows_per_s
                      if st is not None and st.ewma_rows_per_s > 0.0
                      else self._ewma_rows_per_s)
            rows = st.rows if st is not None else 0
            g_rate = self._ewma_rows_per_s
            queued = self._queued_rows
            depth = self._depth
        if t_rate <= 0.0 and g_rate <= 0.0:
            return None
        own = (max(rows, 1.0) / (t_rate * depth)) if t_rate > 0.0 else 0.0
        shared = (queued / (g_rate * depth)) if g_rate > 0.0 else 0.0
        return max(own, shared, 0.01)

    def _prune_expired(self, lane: _Lane) -> bool:
        """Fail the lane's deadline-expired waiters fast (they must not
        occupy dispatch rows) -> True when live riders remain. Runs on the
        flusher AND again on the pool thread right before the dispatch —
        time passes between the two."""
        live: list[_Waiter] = []
        expired: list[_Waiter] = []
        for w in lane.items:
            (expired if w.deadline is not None and w.deadline.expired()
             else live).append(w)
        if not expired:
            return True
        for w in expired:
            robustness.count_deadline("coalescer.queue")
            robustness.count_tenant_deadline(w.tenant)
            tracing.annotate_span(w.trace_span, "coalescer_deadline",
                                  "expired in admission queue")
            w.error = robustness.DeadlineExceededError(
                "request deadline expired in the coalescer admission queue")
            w.event.set()
        lane.items = live
        lane.rows = sum(w.vectors.shape[0] for w in live)
        # expired waiters leave the lane before settle: release their
        # share of the tenant budget now (settle only releases the
        # waiters still aboard)
        released = []
        with self._lock:
            if not lane.settled:
                released = self._release_rows_locked(expired)
        for label, rows in released:
            self._tenant_gauge(label, -rows)
        return bool(live)

    def _dispatch_filtered(self, lane: _Lane) -> None:
        """Pool-side twin of the flusher's async enqueue for FILTERED
        lanes: allowList build + two-phase enqueue + finalize, all off the
        flusher thread. Enqueue ordering across filtered lanes is pool
        order (exactly the pre-snapshot behavior); the win vs the old
        sync path is that the search holds no index lock."""
        try:
            if not self._prune_expired(lane):
                self._mark_settled(lane)
                self._release_lane(lane)
                return
            q = (lane.items[0].vectors if len(lane.items) == 1
                 else np.concatenate([w.vectors for w in lane.items]))
            self._observe_wait(lane)
            rec = self._trace_record(lane)
            # record pushed around the enqueue too: an index without
            # filtered async runs the WHOLE sync search eagerly inside
            # this call, and its phases must land on the lane's record.
            # The tenant scope rides along explicitly: contextvars do not
            # follow the flush-thread/pool handoff, and the shard's
            # allowList cache attributes entries by the ACTIVE tenant —
            # without this, every coalesced filtered entry would land on
            # the class-name bucket and the per-tenant share bound would
            # bound nothing ("multi" for merged cross-tenant lanes: a
            # shared filter belongs to no single tenant's share).
            tok = tracing.push_dispatch(rec)
            try:
                with robustness.tenant_scope(lane.tenant or None):
                    done = lane.shard.object_vector_search_async(
                        q, lane.k, include_vector=lane.include_vector,
                        flt=lane.flt)
            finally:
                tracing.pop_dispatch(tok)
        except Exception as e:  # noqa: BLE001 — propagate to all waiters
            self._fail_lane(lane, e)
            self._release_lane(lane)
            return
        self._finalize_async(lane, done, rec)

    def _dispatch_sync(self, lane: _Lane) -> None:
        try:
            if not self._prune_expired(lane):
                self._mark_settled(lane)
                return
            q = np.concatenate([w.vectors for w in lane.items]) \
                if len(lane.items) > 1 else lane.items[0].vectors
            self._observe_wait(lane)
            rec = self._trace_record(lane)
            tok = tracing.push_dispatch(rec)
            try:
                # the shard's phase recording lands in `rec` via the
                # dispatch contextvar set for THIS pool thread; the
                # tenant scope is the same explicit handoff as
                # _dispatch_filtered (allowList-cache attribution)
                with robustness.tenant_scope(lane.tenant or None):
                    res = lane.shard.object_vector_search(
                        q, lane.k, lane.flt, None, lane.include_vector)
            finally:
                tracing.pop_dispatch(tok)
            if rec is not None:
                # attribution completes BEFORE waiters wake: a request
                # thread reading its own trace after wait() must see its
                # dispatch span already attached
                rec.finish()
            self._resolve_lane(lane, res)
        except Exception as e:  # noqa: BLE001 — propagate to all waiters
            self._fail_lane(lane, e)
        finally:
            self._release_lane(lane)

    def _finalize_async(self, lane: _Lane, done, rec=None) -> None:
        try:
            tok = tracing.push_dispatch(rec)
            try:
                res = done()
            finally:
                tracing.pop_dispatch(tok)
            if rec is not None:
                rec.finish()  # before waiters wake — see _dispatch_sync
            self._resolve_lane(lane, res)
        except Exception as e:  # noqa: BLE001 — propagate to all waiters
            self._fail_lane(lane, e)
        finally:
            self._release_lane(lane)

    def _trace_record(self, lane: _Lane):
        """DispatchRecord for this lane's traced riders (span + rows +
        queue wait per rider), or None when tracing is off or no rider was
        sampled. Unowned: finish() runs here in the coalescer, after the
        device work and before the waiters wake."""
        if tracing.get_tracer() is None:
            return None
        now = time.monotonic()
        riders = [(w.trace_span, int(w.vectors.shape[0]),
                   (now - w.enqueued_at) * 1000.0)
                  for w in lane.items if w.trace_span is not None]
        if not riders:
            return None
        return tracing.DispatchRecord(
            riders, owned=False, actual_rows=lane.rows, coalesced=True,
            lane_requests=len(lane.items), k=lane.k, tenant=lane.tenant)

    def _observe_wait(self, lane: _Lane) -> None:
        """Admission-queue wait per request, observed AT dispatch start —
        observing at resolution would fold the search+hydration latency in
        and make the histogram useless for tuning the window. Also stamps
        `dispatch_start` for the EWMA service-rate estimate."""
        now = time.monotonic()
        lane.dispatch_start = now
        m = self.metrics
        if m is not None:
            try:
                for w in lane.items:
                    m.coalescer_wait.observe((now - w.enqueued_at) * 1000.0)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass
        pw = perf.get_window()
        if pw is not None:
            # queue_wait feeds the host-overhead ledger window per admitted
            # request — full coverage, independent of trace sampling (the
            # perf window exists only while the tracer is up, so the
            # disabled path is the one comparison above)
            try:
                for w in lane.items:
                    pw.note_phase("queue_wait",
                                  (now - w.enqueued_at) * 1000.0)
            except Exception:  # noqa: BLE001 — must not break serving
                pass

    def _resolve_lane(self, lane: _Lane, res) -> None:
        """Scatter [rows] result lists back to the lane's waiters. No k
        trimming is needed: k is part of the lane key (see submit), so every
        waiter here asked for exactly the k the dispatch ran at. Under the
        fused dispatch the per-row ids/distances inside `res` are views
        into the lane's ONE packed device fetch (index/gpu.py fused
        finalize) — this scatter's row slices are the only per-waiter
        work between the fetch and the reply."""
        if not self._mark_settled(lane):
            return  # reaper/failure path won the race; results discarded
        pw = perf.get_window()
        scatter_t0 = time.perf_counter() if pw is not None else 0.0
        pos = 0
        try:
            for w in lane.items:
                r = w.vectors.shape[0]
                w.result = res[pos: pos + r]
                pos += r
                w.event.set()
        finally:
            # a scatter bug must not leave later waiters hanging
            for w in lane.items:
                if not w.event.is_set():
                    w.error = RuntimeError(
                        "coalescer failed to scatter batch results")
                    w.event.set()
        if pw is not None:
            # the ledger's final stage: result scatter back to the waiters
            try:
                pw.note_phase(
                    "scatter", (time.perf_counter() - scatter_t0) * 1000.0)
            except Exception:  # noqa: BLE001 — must not break serving
                pass
        now = time.monotonic()
        with self._lock:
            self._dispatches += 1
            self._dispatched_requests += len(lane.items)
            self._dispatched_rows += lane.rows
            if lane.dispatch_start is not None and lane.rows > 0:
                dur = max(now - lane.dispatch_start, 1e-4)
                rate = lane.rows / dur
                self._ewma_rows_per_s = (
                    rate if self._ewma_rows_per_s <= 0.0
                    else 0.3 * rate + 0.7 * self._ewma_rows_per_s)
                # each rider tenant's OWN drain-rate estimate: feeds ITS
                # deadline-unreachable shedding, so one tenant's slow
                # lanes never shed another tenant's requests (a merged
                # dispatch drains every rider at the lane's rate)
                for t in {w.tenant for w in lane.items if w.tenant}:
                    st = self._tenants.get(t)
                    if st is not None:
                        st.ewma_rows_per_s = (
                            rate if st.ewma_rows_per_s <= 0.0
                            else 0.3 * rate + 0.7 * st.ewma_rows_per_s)
        m = self.metrics
        if m is not None:
            try:
                m.coalescer_batch_requests.observe(len(lane.items))
                m.coalescer_batch_rows.observe(lane.rows)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def _fail_lane(self, lane: _Lane, err: BaseException) -> None:
        if not self._mark_settled(lane):
            return
        # a failed lane means every waiter silently re-runs on the direct
        # path (coalesce window + dead dispatch + duplicate search): make
        # that degradation COUNTABLE, not invisible — the JGL004 rule
        if not isinstance(err, CoalescerShutdownError):
            record_device_fallback("serving.coalescer", "lane_dispatch_failed",
                                   err)
        key = ("coalescer_shutdown"
               if isinstance(err, CoalescerShutdownError)
               else "coalescer_error")
        for w in lane.items:
            # error/shutdown paths close out the trace side too: the rider
            # trace gets the failure reason (annotation, not an open span —
            # nothing to leak), BEFORE the waiter wakes and possibly
            # re-runs direct
            tracing.annotate_span(w.trace_span, key,
                                  f"{type(err).__name__}: {err}")
            w.error = err
            w.event.set()

    def _set_depth_gauge(self) -> None:
        m = self.metrics
        if m is not None:
            try:
                m.coalescer_queue_depth.set(self._queued_rows)
            except Exception:  # noqa: BLE001
                pass

    # -- introspection / lifecycle -------------------------------------------

    def stats(self) -> dict:
        # the front-door concurrency gate sheds BEFORE admission ever sees
        # the request; its refusals belong in the same operator view as the
        # queue's (the ROADMAP item-4 follow-up) — read through the
        # process-wide global, like the serving paths do
        gate = robustness.get_tenant_gate()
        gate_stats = gate.stats() if gate is not None else None
        with self._lock:
            d = self._dispatches
            return {
                "tenant_gate": gate_stats,
                "dispatches": d,
                "requests": self._dispatched_requests,
                "rows": self._dispatched_rows,
                "mean_requests_per_dispatch":
                    (self._dispatched_requests / d) if d else 0.0,
                "mean_rows_per_dispatch":
                    (self._dispatched_rows / d) if d else 0.0,
                "bypass": dict(self._bypass),
                "shed": dict(self._shed),
                "ewma_rows_per_s": self._ewma_rows_per_s,
                "tenant_row_cap": self._tenant_row_cap,
                "pipeline_depth": self._depth,
                "pipeline_depth_deficit": self._depth_deficit,
                "tenants": {
                    t: {"rows_in_system": s.rows, "weight": s.weight,
                        "shed": dict(s.shed),
                        "ewma_rows_per_s": s.ewma_rows_per_s}
                    for t, s in self._tenants.items()
                },
            }

    def shutdown(self) -> None:
        robustness.clear_retry_hint_provider(self._retry_hint_fn)
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        # in-flight dispatch tasks run to completion (each wakes its own
        # waiters, success or failure); nothing new can be submitted —
        # tasks cancelled before running are reaped by _reap_lane_future
        self._dispatch_pool.shutdown(wait=False)
