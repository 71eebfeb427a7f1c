# The port's copy of weaviate_tpu/monitoring/quality.py, its imports pointed at the port.
"""Online quality observability: the shadow recall auditor.

ROADMAP items 1-3 (fused multi-stage search, mesh serving, IVF pruning)
all trade recall for speed via tunable candidate budgets, yet recall is
only measured at bench time against a static fixture — live traffic has
zero quality signal, so a PQ-tier regression, tombstone accumulation
after deletes, or a too-aggressive budget would ship silently. This
module is the quality twin of the /debug/perf roofline ledger
(monitoring/perf.py): a continuous, production-path recall meter.

How it works:

- the shard captures a sampled fraction of completed live searches at
  finalize (``RECALL_AUDIT_SAMPLE_RATE``; default 0 = off) — the query
  rows, requested k, allowList, and the returned (ids, dists);
- the index pins the exact ``IndexSnapshot`` the dispatch read (the
  ``pop_read_lock_wait`` TLS idiom, gated on ``get_auditor()`` so the
  disabled path stores nothing), so the audit compares against the SAME
  index state the live answer saw — deletes/compression between capture
  and audit cannot fabricate a recall drop;
- a bounded background worker re-executes each sampled query against the
  exact host plane (``search_by_vectors_host_pinned`` — the breaker's
  brute-force fallback, which is exact by construction, filters and both
  PQ tiers included) and scores the live answer: recall@k, rank-biased
  overlap, and relative distance error, folded into a rolling
  ``QualityWindow`` (the ``PerfWindow`` idiom);
- per-tier EWMA degradation detection fires a rate-limited log plus
  ``weaviate_quality_degraded_total`` when the recall estimate drops
  below ``RECALL_ALERT_THRESHOLD``.

Subordination guarantees — audits must never compete with live traffic:

- hard concurrency budget (``RECALL_AUDIT_CONCURRENCY`` worker threads)
  with a tiny drop-not-queue backlog: when the queue is full the sample
  is DROPPED and counted (``weaviate_quality_audits_total{outcome=
  "shed"}``), never queued unboundedly;
- per-audit row budget (``RECALL_AUDIT_MAX_ROWS``): a wide coalesced
  dispatch audits a uniform row subset, not the whole batch;
- deadline-bounded host scans (``RECALL_AUDIT_DEADLINE_MS``): the host
  brute force streams row chunks and abandons the audit when over
  budget (counted as ``outcome="deadline"``);
- zero interaction with the coalescer, breaker, or tenant budgets: the
  audit calls the index's host plane directly, off every serving gate.

Lifecycle mirrors the tracer/perf window: a process-wide module global
installed by App when the sample rate is positive, None otherwise —
every serving-path entry point is then a one-comparison no-op and
constructs nothing (spy-pinned in tests/test_quality_auditor.py).

Exposure: ``GET /debug/quality`` (same authorizer as pprof/perf),
bounded-label gauges ``weaviate_recall_at_k{tier}`` /
``weaviate_distance_relerr{tier}``, audit outcome/lag counters, and the
``online_recall`` field on bench.py serving rows (cross-checked against
the bench's own recall computation). See docs/quality.md.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from weaviate_tpu_torch.testing import sanitizers

_LOG = logging.getLogger(__name__)

# RBO persistence: weight of deeper ranks (0.9 = the literature's default
# "top-heavy but not myopic" setting); truncated at k and normalized so
# identical rankings score exactly 1.0
RBO_P = 0.9

# seconds between degradation log lines per tier (the counter always
# increments on a transition; the log is what gets rate-limited)
DEGRADED_LOG_INTERVAL_S = 60.0


class AuditDeadlineExceeded(Exception):
    """A deadline-bounded host scan ran over its audit budget."""


# -- result scoring -----------------------------------------------------------


def recall_at_k(live_ids, host_ids, k: int) -> float:
    """|live top-k ∩ exact top-k| / |exact top-k| for ONE query row.
    host_ids is the ground truth; an empty ground truth scores 1.0 (there
    was nothing to miss)."""
    want = set(int(x) for x in host_ids[:k])
    if not want:
        return 1.0
    got = set(int(x) for x in live_ids[:k])
    return len(want & got) / len(want)


def rank_biased_overlap(live_ids, host_ids, k: int, p: float = RBO_P) -> float:
    """Truncated rank-biased overlap at depth k, normalized so identical
    rankings score 1.0: RBO@k = (1-p)/(1-p^k) · Σ_{d=1..k} p^{d-1}·A_d
    with A_d the overlap fraction of the two depth-d prefixes. Unlike
    recall it penalizes ORDER swaps, so a tier that returns the right set
    in the wrong order is still visible."""
    a = [int(x) for x in live_ids[:k]]
    b = [int(x) for x in host_ids[:k]]
    depth = max(len(a), len(b))
    if depth == 0:
        return 1.0
    sa: set = set()
    sb: set = set()
    acc = 0.0
    weight = 1.0  # p^(d-1)
    norm = 0.0
    for d in range(1, depth + 1):
        if d <= len(a):
            sa.add(a[d - 1])
        if d <= len(b):
            sb.add(b[d - 1])
        acc += weight * (len(sa & sb) / d)
        norm += weight
        weight *= p
    return acc / norm if norm > 0.0 else 1.0


def relative_distance_error(live_d, host_d) -> float:
    """Mean rank-aligned |d_live - d_exact| / max(|d_exact|, eps) over the
    ranks both lists filled — the tier's distance-approximation error,
    independent of whether the ids matched (a PQ tier can return the right
    ids with drifted distances, or vice versa)."""
    n = min(len(live_d), len(host_d))
    if n == 0:
        return 0.0
    lv = np.asarray(live_d[:n], dtype=np.float64)
    hv = np.asarray(host_d[:n], dtype=np.float64)
    ok = np.isfinite(lv) & np.isfinite(hv)
    if not ok.any():
        return 0.0
    denom = np.maximum(np.abs(hv[ok]), 1e-9)
    return float(np.mean(np.abs(lv[ok] - hv[ok]) / denom))


def score_batch(live_ids, live_dists, host_ids, host_dists, k: int):
    """Score one audited batch row-by-row -> (recall, rbo, relerr) means.
    Rows are trimmed to their valid (non-inf-distance) prefixes on both
    sides before scoring."""
    recalls, rbos, relerrs = [], [], []
    b = len(live_ids)
    for i in range(b):
        lv = np.asarray(live_dists[i])
        hv = np.asarray(host_dists[i])
        lids = np.asarray(live_ids[i])[~np.isinf(lv)]
        hids = np.asarray(host_ids[i])[~np.isinf(hv)]
        recalls.append(recall_at_k(lids, hids, k))
        rbos.append(rank_biased_overlap(lids, hids, k))
        relerrs.append(relative_distance_error(
            lv[~np.isinf(lv)], hv[~np.isinf(hv)]))
    n = max(len(recalls), 1)
    return (sum(recalls) / n, sum(rbos) / n, sum(relerrs) / n)


# -- the rolling window -------------------------------------------------------


class QualityWindow:
    """Rolling-window aggregate of audit scores (the PerfWindow idiom):
    per-tier sample deques evicted by time horizon, lifetime outcome
    counters, and per-tier EWMA recall for degradation detection.
    ``record``/``count`` are the worker-side entries (one small lock);
    ``summary()`` is the on-demand /debug/quality body."""

    def __init__(self, window_s: float = 300.0):
        self.window_s = max(float(window_s), 1e-3)
        self._lock = threading.Lock()
        # tier -> deque[(t_mono, recall, rbo, relerr, rows)]
        self._samples: dict[str, deque] = {}
        # tier -> EWMA recall (None until the first audit of that tier)
        self._ewma: dict[str, float] = {}
        self._ewma_n: dict[str, int] = {}
        self._degraded: dict[str, bool] = {}
        self._lag: deque = deque(maxlen=4096)  # (t_mono, lag_ms)
        # lifetime outcome counters (never evicted)
        self._counts = {"ok": 0, "shed": 0, "error": 0, "deadline": 0}
        self._captured = 0  # dispatches offered to the sampler
        self._sampled = 0   # dispatches the sampler picked

    # -- worker-side entries -------------------------------------------------

    def note_offered(self, sampled: bool) -> None:
        with self._lock:
            self._captured += 1
            if sampled:
                self._sampled += 1

    def count(self, outcome: str) -> None:
        with self._lock:
            self._counts[outcome] = self._counts.get(outcome, 0) + 1

    def record(self, tier: str, recall: float, rbo: float, relerr: float,
               rows: int, lag_ms: float,
               ewma_alpha: float = 0.2) -> tuple[float, int]:
        """Fold one completed audit in -> (tier EWMA recall, tier EWMA
        sample count) for the caller's degradation check."""
        now = time.monotonic()
        with self._lock:
            self._counts["ok"] += 1
            d = self._samples.get(tier)
            if d is None:
                d = self._samples[tier] = deque()
            d.append((now, recall, rbo, relerr, rows))
            self._lag.append((now, lag_ms))
            self._evict(now)
            prev = self._ewma.get(tier)
            ew = recall if prev is None else (
                ewma_alpha * recall + (1.0 - ewma_alpha) * prev)
            self._ewma[tier] = ew
            n = self._ewma_n.get(tier, 0) + 1
            self._ewma_n[tier] = n
            return ew, n

    def tier_ewmas(self) -> dict:
        """{tier: (recall EWMA, samples folded)} — the control plane's
        recall sensor (serving/controller.py steers the PQ candidate
        budget against it)."""
        with self._lock:
            return {t: (ew, self._ewma_n.get(t, 0))
                    for t, ew in self._ewma.items()}

    def set_degraded(self, tier: str, degraded: bool) -> bool:
        """-> True when this call TRANSITIONED the tier's state."""
        with self._lock:
            was = self._degraded.get(tier, False)
            self._degraded[tier] = degraded
            return was != degraded

    def _evict(self, now: float) -> None:
        horizon = now - self.window_s
        for d in self._samples.values():
            while d and d[0][0] < horizon:
                d.popleft()
        while self._lag and self._lag[0][0] < horizon:
            self._lag.popleft()

    # -- introspection -------------------------------------------------------

    def clear(self) -> None:
        """Reset the window and the EWMA state (bench measurement slices);
        lifetime counters survive, like PerfWindow's dispatch counter."""
        with self._lock:
            self._samples.clear()
            self._lag.clear()
            self._ewma.clear()
            self._ewma_n.clear()
            self._degraded.clear()

    def overall_recall(self) -> Optional[float]:
        """Row-weighted mean recall across every tier in the window (the
        bench row's ``online_recall`` field)."""
        now = time.monotonic()
        with self._lock:
            self._evict(now)
            num = den = 0.0
            for d in self._samples.values():
                for _, rec, _, _, rows in d:
                    num += rec * rows
                    den += rows
            return round(num / den, 4) if den > 0.0 else None

    def summary(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._evict(now)
            tiers: dict[str, dict] = {}
            for tier, d in self._samples.items():
                if not d:
                    continue
                recs = [r for _, r, _, _, _ in d]
                rbos = [r for _, _, r, _, _ in d]
                errs = [r for _, _, _, r, _ in d]
                tiers[tier] = {
                    "audits": len(d),
                    "rows": sum(r for _, _, _, _, r in d),
                    "recall_mean": round(sum(recs) / len(recs), 4),
                    "recall_min": round(min(recs), 4),
                    "rbo_mean": round(sum(rbos) / len(rbos), 4),
                    "distance_relerr_mean": round(
                        sum(errs) / len(errs), 6),
                    "recall_ewma": round(self._ewma[tier], 4)
                    if tier in self._ewma else None,
                    "degraded": self._degraded.get(tier, False),
                }
            lags = sorted(ms for _, ms in self._lag)
            counts = dict(self._counts)
            captured, sampled = self._captured, self._sampled
        out = {
            "window_s": self.window_s,
            "captured_dispatches": captured,
            "sampled_dispatches": sampled,
            "audits": counts,
            "tiers": tiers,
        }
        overall = self.overall_recall()
        if overall is not None:
            out["online_recall"] = overall
        if lags:
            out["audit_lag_ms"] = {
                "p50": round(_pct(lags, 50.0), 2),
                "p99": round(_pct(lags, 99.0), 2),
            }
        return out


def _pct(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(len(sorted_vals) * q / 100.0), len(sorted_vals) - 1)
    return float(sorted_vals[i])


# -- the auditor --------------------------------------------------------------


class _AuditTask:
    """One captured sample: everything the worker needs, copied or pinned
    at capture time so later index mutation cannot tear it. Constructed
    ONLY for sampled dispatches (the zero-cost contract's second half —
    tests spy-pin that the disabled path constructs none)."""

    __slots__ = ("vidx", "snap", "q", "k", "allow", "live_ids", "live_dists",
                 "t_captured", "class_name", "shard")

    def __init__(self, vidx, snap, q, k, allow, live_ids, live_dists,
                 class_name: str = "", shard: str = ""):
        self.vidx = vidx
        self.snap = snap  # the pinned IndexSnapshot the dispatch read
        self.q = q
        self.k = int(k)
        self.allow = allow
        self.live_ids = live_ids
        self.live_dists = live_dists
        self.t_captured = time.monotonic()
        self.class_name = class_name
        self.shard = shard


class QualityAuditor:
    """The process-wide shadow recall auditor. ``maybe_capture`` is the
    serving-path entry (sampling + drop-not-queue admission, a few array
    slices when sampled); audits execute on a tiny dedicated worker pool,
    strictly subordinate to live traffic."""

    def __init__(self, sample_rate: float, concurrency: int = 1,
                 max_rows: int = 64, deadline_ms: float = 1000.0,
                 window_s: float = 300.0, alert_threshold: float = 0.95,
                 alert_min_samples: int = 20, metrics=None,
                 start_workers: bool = True):
        self.sample_rate = min(max(float(sample_rate), 0.0), 1.0)
        self.concurrency = max(int(concurrency), 1)
        self.max_rows = max(int(max_rows), 1)
        self.deadline_ms = float(deadline_ms)
        self.alert_threshold = float(alert_threshold)
        self.alert_min_samples = max(int(alert_min_samples), 1)
        self.metrics = metrics
        self.window = QualityWindow(window_s)
        # drop-not-queue: a backlog of at most one pending task per worker
        # beyond the ones in flight; put_nowait on a full queue SHEDS the
        # sample (counted) instead of building a backlog behind live load
        self._queue: queue.Queue = queue.Queue(maxsize=self.concurrency)
        self._stop = threading.Event()
        # audits admitted (submit) but not yet scored — counted at
        # ADMISSION, not at worker pickup, so drain() can never report
        # idle while a popped-but-unscored task is still running
        self._inflight = 0
        self._lock = sanitizers.register_lock(
            threading.Lock(), "monitoring.quality")
        # id(index) -> (pinned snapshot, rows, sq_norms): consecutive
        # audits of one generation share the host materialization. ONE
        # entry per index — a new generation REPLACES the old, so the
        # cache can never pin several full-precision store copies of dead
        # generations — bounded to a few indexes, and auditor-owned so
        # audits never touch the breaker's fallback cache
        self._rows_cache: dict = {}
        self._degraded_last_log: dict[str, float] = {}
        # host-memory provider (monitoring/memory.py): the audit rows
        # cache — full-precision store copies — becomes a /debug/memory
        # host component, sized by the same helper /debug/index uses
        from weaviate_tpu_torch.monitoring import memory

        memory.register_host_provider(self, memory.auditor_host_components)
        self._threads: list[threading.Thread] = []
        if start_workers:
            for i in range(self.concurrency):
                t = threading.Thread(target=self._worker, daemon=True,
                                     name=f"quality-audit-{i}")
                t.start()
                self._threads.append(t)

    # -- serving-path capture ------------------------------------------------

    def maybe_capture(self, vidx, snap, q, k: int, allow, live_ids,
                      live_dists, class_name: str = "",
                      shard: str = "") -> bool:
        """Sample one completed live search. Called by db/shard.py at
        finalize with the snapshot the dispatch read (already popped from
        the index TLS pin). -> True when a task was admitted."""
        sampled = random.random() < self.sample_rate
        self.window.note_offered(sampled)
        if not sampled:
            return False
        q = np.asarray(q)
        live_ids = np.asarray(live_ids)
        live_dists = np.asarray(live_dists)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        if live_ids.ndim != 2 or live_ids.shape[0] != b or b == 0:
            # foreign result shape: nothing to score — counted, so
            # sampled_dispatches can never silently outrun the outcome
            # counters (the "auditor not auditing" state must be visible)
            self.window.count("skipped")
            self._count_metric("skipped")
            return False
        if b > self.max_rows:
            # row budget: audit a uniform subset of the batch's rows
            sel = np.sort(np.random.default_rng().choice(
                b, self.max_rows, replace=False))
            q, live_ids, live_dists = q[sel], live_ids[sel], live_dists[sel]
        task = _AuditTask(vidx, snap, np.array(q, copy=True), k, allow,
                          np.array(live_ids, copy=True),
                          np.array(live_dists, copy=True),
                          class_name=class_name, shard=shard)
        return self.submit(task)

    def submit(self, task: _AuditTask) -> bool:
        """Admit a task under the drop-not-queue bound; -> False = shed.
        The inflight count moves BEFORE the enqueue (rolled back on a
        full queue) so it can never under-report a task a worker already
        popped but has not finished scoring."""
        with self._lock:
            self._inflight += 1
        try:
            self._queue.put_nowait(task)
            return True
        except queue.Full:
            with self._lock:
                self._inflight -= 1
            self.window.count("shed")
            self._count_metric("shed")
            return False

    # -- the background worker (exception-guarded run loop: a silently
    # dead audit thread would read as recall=perfect — graftlint JGL011) --

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                task = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if task is None:
                continue  # shutdown wake-up sentinel (never counted)
            try:
                self._run_audit(task)
            except AuditDeadlineExceeded:
                self.window.count("deadline")
                self._count_metric("deadline")
            except Exception:  # noqa: BLE001 — the audit loop must survive
                self.window.count("error")
                self._count_metric("error")
                _LOG.warning("quality audit failed", exc_info=True)
            finally:
                with self._lock:
                    self._inflight -= 1

    def _host_rows(self, vidx, snap):
        """Per-index cached host materialization: one (snapshot, rows,
        norms) entry per index, replaced whenever an audit pins a newer
        snapshot — so the cache never accumulates full-precision store
        copies of dead generations. Snapshot IDENTITY (not gen) keys the
        hit, so a recycled id(vidx) after GC can never serve another
        index's rows. Auditor-owned: the breaker's fallback cache
        (released on recovery) is never touched."""
        key = id(vidx)
        with self._lock:
            hit = self._rows_cache.get(key)
            if hit is not None and hit[0] is snap:
                # LRU move-to-end on hit: a plain re-assign keeps the
                # dict position, and FIFO would evict the HOTTEST index
                self._rows_cache.pop(key)
                self._rows_cache[key] = hit
                return hit[1], hit[2]
        rows, sq = vidx.host_rows(snap)
        with self._lock:
            self._rows_cache.pop(key, None)  # move-to-end on update too
            self._rows_cache[key] = (snap, rows, sq)
            while len(self._rows_cache) > 4:  # a few indexes at most
                self._rows_cache.pop(next(iter(self._rows_cache)))
        return rows, sq

    def _run_audit(self, task: _AuditTask) -> None:
        lag_ms = (time.monotonic() - task.t_captured) * 1000.0
        deadline = (time.monotonic() + self.deadline_ms / 1000.0
                    if self.deadline_ms > 0 else None)
        vidx, snap = task.vidx, task.snap
        tier = vidx.dispatch_tier(snap, task.allow)
        rows, sq = self._host_rows(vidx, snap)
        host_ids, host_d = vidx.search_by_vectors_host_pinned(
            snap, task.q, task.k, task.allow, rows=rows, sq_norms=sq,
            deadline=deadline)
        recall, rbo, relerr = score_batch(
            task.live_ids, task.live_dists, host_ids, host_d, task.k)
        self._observe(tier, recall, rbo, relerr, task.q.shape[0], lag_ms)

    def _observe(self, tier: str, recall: float, rbo: float, relerr: float,
                 rows: int, lag_ms: float) -> None:
        """Fold one audit's scores in: window, gauges, degradation check.
        Split out so tests can drive the detector deterministically."""
        ewma, n = self.window.record(tier, recall, rbo, relerr, rows, lag_ms)
        m = self.metrics
        if m is not None:
            try:
                m.recall_at_k.labels(tier).set(round(ewma, 4))
                m.distance_relerr.labels(tier).set(round(relerr, 6))
                m.quality_audits.labels("ok").inc()
                m.quality_audit_lag.observe(lag_ms)
            except Exception:  # noqa: BLE001 — metrics must not kill audits
                pass
        if n < self.alert_min_samples:
            return
        degraded = ewma < self.alert_threshold
        transitioned = self.window.set_degraded(tier, degraded)
        if degraded:
            if transitioned and m is not None:
                try:
                    m.quality_degraded.labels(tier).inc()
                except Exception:  # noqa: BLE001
                    pass
            if transitioned:
                # the degradation transition is an ops-journal event AND an
                # incident trigger (monitoring/incidents.py): the bundle
                # preserves the quality window + journal around the drop.
                # One-comparison no-ops when the plane is off; lazy import
                # (incidents is deliberately off this module's import path).
                try:
                    from weaviate_tpu_torch.monitoring import incidents

                    incidents.emit("quality_degraded", scope=tier,
                                   ewma_recall=round(ewma, 4),
                                   threshold=self.alert_threshold)
                    incidents.trigger(
                        "quality_degraded",
                        reason=f"online recall degraded: tier={tier} "
                               f"ewma={ewma:.4f} < {self.alert_threshold}",
                        detail={"tier": tier, "ewma_recall": ewma})
                except Exception:  # noqa: BLE001 — must not break the audit loop
                    pass
            now = time.monotonic()
            last = self._degraded_last_log.get(tier)
            if last is None or now - last >= DEGRADED_LOG_INTERVAL_S:
                self._degraded_last_log[tier] = now
                _LOG.warning(
                    "online recall degraded: tier=%s ewma_recall=%.4f "
                    "threshold=%.4f (over >= %d audited dispatches) — "
                    "counted in weaviate_quality_degraded_total; further "
                    "lines rate-limited to one per %.0fs",
                    tier, ewma, self.alert_threshold,
                    self.alert_min_samples, DEGRADED_LOG_INTERVAL_S)
        elif transitioned:
            _LOG.info("online recall recovered: tier=%s ewma_recall=%.4f",
                      tier, ewma)
            try:
                from weaviate_tpu_torch.monitoring import incidents

                incidents.emit("quality_recovered", scope=tier,
                               ewma_recall=round(ewma, 4))
            except Exception:  # noqa: BLE001 — must not break the audit loop
                pass

    def _count_metric(self, outcome: str) -> None:
        m = self.metrics
        if m is not None:
            try:
                m.quality_audits.labels(outcome).inc()
            except Exception:  # noqa: BLE001
                pass

    # -- introspection / lifecycle -------------------------------------------

    def set_sample_rate(self, rate: float) -> None:
        """Adjust the capture sampling gate (clamped to [0, 1]). The
        control plane's brownout stage 3 pauses auditing with 0 and
        restores the configured rate on recovery/revert — workers stay
        up, the gate is what moves (serving/controller.py is the ONLY
        caller outside tests; graftlint JGL014 pins that)."""
        self.sample_rate = min(max(float(rate), 0.0), 1.0)

    def tier_ewmas(self) -> dict:
        """{tier: (recall EWMA, samples)} — see QualityWindow.tier_ewmas."""
        return self.window.tier_ewmas()

    def summary(self) -> dict:
        out = self.window.summary()
        out["sample_rate"] = self.sample_rate
        out["concurrency"] = self.concurrency
        out["max_rows"] = self.max_rows
        out["deadline_ms"] = self.deadline_ms
        out["alert_threshold"] = self.alert_threshold
        return out

    def clear(self) -> None:
        self.window.clear()

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every admitted audit completed (bench/test sync
        point; never used on the serving path). Inflight counts from
        ADMISSION to scored, so a task a worker has popped but not
        finished still holds the count. -> False on timeout."""
        end = time.monotonic() + timeout_s
        while time.monotonic() < end:
            with self._lock:
                idle = self._inflight == 0
            if idle:
                return True
            time.sleep(0.01)
        return False

    def shutdown(self) -> None:
        self._stop.set()
        for _ in self._threads:
            try:
                self._queue.put_nowait(None)  # wake blocked workers
            except queue.Full:
                break
        for t in self._threads:
            t.join(timeout=2)


# -- module state + zero-hop accessors ----------------------------------------

_auditor: Optional[QualityAuditor] = None

# final summaries of recently-unconfigured auditors (CI failure artifact:
# tests/conftest.py dumps these alongside the perf summaries). Guarded by
# its own lock — concurrent App teardowns share it (the perf.py pattern).
_final_summaries: deque = deque(maxlen=8)
_summaries_lock = threading.Lock()


def configure(auditor: Optional[QualityAuditor]) -> Optional[QualityAuditor]:
    """Install (or clear, with None) the process-wide auditor."""
    global _auditor
    _auditor = auditor
    return auditor


def unconfigure(auditor: QualityAuditor) -> None:
    """Clear the global only if it is still `auditor` (App shutdown must
    not tear down a newer App's auditor); stash its final summary for the
    CI artifact dump when it scored anything; stop its workers."""
    global _auditor
    try:
        doc = auditor.summary()
        if doc.get("audits", {}).get("ok") or doc.get("sampled_dispatches"):
            with _summaries_lock:
                _final_summaries.append(doc)
    except Exception:  # noqa: BLE001 — teardown must never fail shutdown
        pass
    if _auditor is auditor:
        _auditor = None
    auditor.shutdown()


def get_auditor() -> Optional[QualityAuditor]:
    return _auditor


def recent_summaries() -> list:
    """Final summaries of auditors torn down this process (newest last),
    plus the live auditor's current summary when one is installed."""
    with _summaries_lock:
        out = list(_final_summaries)
    a = _auditor
    if a is not None:
        try:
            out.append(a.summary())
        except Exception:  # noqa: BLE001
            pass
    return out
