# The port's copy of weaviate_tpu/monitoring/perf.py, its imports pointed at the port.
"""Continuous device-performance attribution: the rolling perf window.

The r05 chip session measured 13.7k QPS at 1.78% MFU on ONE manual
profile; the hypothesis — host-side gather/rescore and per-dispatch
orchestration dominate — needs a *continuous* measurement so the fused
multi-stage search (ROADMAP items 1-3) gets a real before/after. This
module aggregates what the dispatch plane records:

- every device dispatch's analytic cost (costmodel.DispatchShape: flops,
  bytes, tier) and host-overhead ledger (enqueue / device fetch /
  gather hop / hydrate), fed by db/shard.py for EVERY dispatch while the
  tracer is up — full coverage, independent of trace sampling;
- per-request queue waits and per-dispatch scatter times from the
  coalescer (``note_phase``);
- the **device duty cycle**: the fraction of wall-clock with an in-flight
  device dispatch, integrated from [enqueue-start, fetch-end] intervals.
  kernel-level MFU high + duty cycle low = the orchestration gap; both
  high = the kernel itself is the limit. This is the number that directly
  tests the orchestration-gap hypothesis.

Exposure: rolling-window Prometheus gauges (``weaviate_device_mfu_pct``,
``weaviate_device_hbm_bw_pct``, ``weaviate_device_duty_cycle``), a
per-dispatch phase-share histogram (``weaviate_perf_phase_share``), the
``GET /debug/perf`` window summary (server/rest.py, same authorizer as
pprof), and the ``roofline``/``duty_cycle``/``phase_share`` fields on
bench.py serving rows.

Lifecycle mirrors the tracer (monitoring/tracing.py): a process-wide
module global installed by App when TRACING_ENABLED is set, None
otherwise — every serving-path entry point is then a one-comparison
no-op and constructs nothing (spy-pinned in tests/test_perf.py).

The QUALITY twin of this window lives in monitoring/quality.py: the
shadow recall auditor measures what the serving path ANSWERS (recall,
rank overlap, distance error at ``GET /debug/quality``) the way this
window measures what it COSTS — same rolling-window idiom, same
zero-cost-disabled lifecycle, same authorizer.

The CAPSTONE consumer is the incident plane (monitoring/incidents.py):
``summary()`` is captured verbatim into every flight-recorder bundle, so
a breaker trip or SLO burn preserves the window's duty-cycle/roofline/
ledger picture at the moment of the incident — and
``recent_summaries()`` keeps the last windows reachable even after the
owning App is torn down (the bench's rc=3 emergency dump reads it).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from weaviate_tpu_torch.monitoring import costmodel

# ledger stages in display order (the /debug/perf breakdown; scatter is
# fed by the coalescer, queue_wait per admitted request)
PHASES = ("queue_wait", "filter", "enqueue", "device", "gather_hop",
          "hydrate", "scatter")

# per-phase sample cap (deque maxlen): queue_wait gets one sample per
# ADMITTED REQUEST, so a 60 s window at r05-scale QPS (~13.7k/s) would
# otherwise retain ~800k tuples and every summary() would copy+sort them
# under the window lock. Percentiles are over the most recent samples
# within the window — plenty for p50/p99 at any realistic horizon.
_PHASE_SAMPLES_MAX = 16384


class DutyCycle:
    """Busy-time integrator over [start, end) intervals within a rolling
    window. Incremental: each recorded interval contributes only the part
    not already covered by earlier intervals (``busy_until`` carries the
    merge frontier), so overlapping concurrent dispatches never double
    count. Exact for intervals arriving in nondecreasing START order; a
    deep pipeline that completes out of order can under-count the overlap
    by at most the reorder window (documented in docs/performance.md)."""

    __slots__ = ("window_s", "_deltas", "_busy_until", "_busy_total",
                 "_first_t")

    def __init__(self, window_s: float):
        self.window_s = max(float(window_s), 1e-3)
        # (t_end, busy_delta): busy time attributed at interval end, plus
        # a running total — value() must be O(evictions), not O(window),
        # because record_dispatch calls it per dispatch under the window
        # lock on the serving path
        self._deltas: deque = deque()
        self._busy_total = 0.0
        self._busy_until = 0.0
        self._first_t: Optional[float] = None

    def record(self, start: float, end: float) -> None:
        if end <= start:
            return
        if self._first_t is None:
            self._first_t = start
        covered_from = max(start, self._busy_until)
        delta = max(end - covered_from, 0.0)
        self._busy_until = max(self._busy_until, end)
        if delta > 0.0:
            self._deltas.append((end, delta))
            self._busy_total += delta

    def _trim(self, now: float) -> None:
        horizon = now - self.window_s
        while self._deltas and self._deltas[0][0] < horizon:
            _, d = self._deltas.popleft()
            self._busy_total -= d
        if not self._deltas:
            self._busy_total = 0.0  # no float-drift residue on empty

    def busy_s(self, now: Optional[float] = None) -> float:
        """Merged busy seconds within the trailing window. The PerfWindow
        divides this by ITS observed span so duty and the window roofline
        share one denominator."""
        now = time.monotonic() if now is None else now
        self._trim(now)
        return max(self._busy_total, 0.0)

    def value(self, now: Optional[float] = None) -> float:
        """Busy fraction of the trailing window (0..1). The denominator is
        the OBSERVED span — min(window_s, now - first interval) — so a
        window that just started reports its live fraction instead of
        diluting against unobserved time."""
        now = time.monotonic() if now is None else now
        busy = self.busy_s(now)
        if self._first_t is None:
            return 0.0
        span = min(self.window_s, max(now - self._first_t, 1e-9))
        return min(busy / span, 1.0)


class PerfWindow:
    """Rolling-window aggregate of dispatch cost + host-overhead ledgers.

    ``record_dispatch`` is the per-dispatch hot-path entry: one lock, O(1)
    amortized (eviction pops), gauge sets guarded so a broken metrics
    stack can never take down serving. ``summary()`` is the on-demand
    /debug/perf body."""

    def __init__(self, window_s: float = 60.0, metrics=None,
                 backend: Optional[str] = None,
                 sample_hint: float = 1.0):
        self.window_s = max(float(window_s), 1e-3)
        self.metrics = metrics
        self.backend = backend or costmodel.detect_backend()
        # trace sample rate, surfaced in the summary: dispatch coverage
        # here is FULL (shard feeds every dispatch while the tracer is
        # up), but readers correlating with /debug/traces need the rate
        self.sample_hint = float(sample_hint)
        self._lock = threading.Lock()
        # (t_end_mono, flops, bytes, device_s, wall_s, tier, regime, rows)
        self._entries: deque = deque()
        # phase name -> deque[(t_mono, ms)], count-capped (see
        # _PHASE_SAMPLES_MAX) on top of the time-horizon eviction
        self._phase: dict[str, deque] = {
            p: deque(maxlen=_PHASE_SAMPLES_MAX) for p in PHASES}
        self._duty = DutyCycle(self.window_s)
        # running sums over the live window (evicted incrementally)
        self._flops = 0
        self._bytes = 0
        self._device_s = 0.0
        self._rows = 0
        self._started = time.monotonic()
        self._first_entry: Optional[float] = None
        self._total_dispatches = 0  # lifetime, never evicted

    # -- hot path ------------------------------------------------------------

    def record_dispatch(self, shape, rows: int = 0) -> None:
        """Fold one finished device dispatch (a costmodel.DispatchShape
        with its ledger stamped) into the window. Called by db/shard.py
        for every dispatch while the perf plane is up."""
        now = time.monotonic()
        ledger = shape.ledger()
        device_s = max(shape.device_ms, 0.0) / 1000.0
        flops = shape.flops()
        byts = shape.bytes()
        # mesh dispatches (shape.ndev > 1) count GLOBAL work in n — the
        # whole sharded program's rows. The roofline compares achieved
        # rates against ONE chip's peak, so normalize to per-chip work;
        # arithmetic intensity (flops/bytes) is unchanged by the division,
        # so the regime classification stays identical
        nd = max(int(getattr(shape, "ndev", 1)), 1)
        if nd > 1:
            flops //= nd
            byts //= nd
        regime = (costmodel.regime(flops, byts, self.backend)
                  if device_s > 0.0 else None)
        # the shape's wall endpoints are perf_counter stamps; the window
        # runs on time.monotonic. Only DURATIONS are trusted
        # (clock-agnostic deltas); the in-flight interval — enqueue start
        # to FETCH end, the device-busy span — is anchored at the
        # monotonic fetch stamp `_fetch_packed` took (NOT at this record
        # call: hydration runs in between, and re-anchoring here would
        # shift concurrent dispatches' intervals by their differing
        # hydrate times and corrupt the overlap merge)
        wall_s = max(shape.t_end - shape.t_start, 0.0)
        # no fetch stamp = no device call ran (an empty gather-tier early
        # return): it must contribute NO duty interval — counting its
        # host-only wall as "device in flight" would read near-1.0 duty on
        # a workload whose device is idle, inverting the signal
        inflight_s = (max(shape.t_fetch - shape.t_start, 0.0)
                      if shape.t_fetch > 0.0 else 0.0)
        fetch_end = (shape.t_fetch_mono
                     if 0.0 < shape.t_fetch_mono <= now else now)
        fused = bool(shape.fused)
        # the fused-dispatch invariant (one blocking fetch, zero host
        # translation): violations are counted per window — a fused
        # dispatch quietly re-growing host translation work must be
        # dashboard-visible, not just test-pinned
        viol = not costmodel.fused_invariant_ok(shape)
        with self._lock:
            self._evict(now)
            self._entries.append(
                (now, flops, byts, device_s, shape.tier, regime,
                 int(rows) or shape.batch, fused, viol))
            self._flops += flops
            self._bytes += byts
            self._device_s += device_s
            self._rows += int(rows) or shape.batch
            self._total_dispatches += 1
            if self._first_entry is None:
                # anchor the observed span at this dispatch's START so
                # the first entry's window roofline divides by its own
                # wall, not by an epsilon
                self._first_entry = now - wall_s
            for name, ms in ledger.items():
                self._phase[name].append((now, ms))
            if inflight_s > 0.0:
                self._duty.record(fetch_end - inflight_s, fetch_end)
            duty = self._duty_locked(now)
            mfu, bw = self._window_roofline_locked(now)
        m = self.metrics
        if m is not None:
            try:
                m.device_duty_cycle.set(duty)
                if mfu is not None:
                    m.device_mfu.set(mfu)
                    m.device_hbm_bw.set(bw)
                total = sum(ledger.values())
                if total > 0.0:
                    for name, ms in ledger.items():
                        m.perf_phase_share.labels(name).observe(ms / total)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                pass

    def note_phase(self, name: str, ms: float) -> None:
        """Record one sample of a ledger stage measured outside the shard
        dispatch (coalescer queue_wait per request, scatter per lane)."""
        now = time.monotonic()
        with self._lock:
            d = self._phase.get(name)
            if d is None:
                d = self._phase[name] = deque(maxlen=_PHASE_SAMPLES_MAX)
            d.append((now, float(ms)))
            # bound growth between dispatch-driven evictions (the maxlen
            # cap bounds the worst case regardless)
            horizon = now - self.window_s
            while d and d[0][0] < horizon:
                d.popleft()

    def _evict(self, now: float) -> None:
        horizon = now - self.window_s
        while self._entries and self._entries[0][0] < horizon:
            _, f, b, ds, _, _, r, _, _ = self._entries.popleft()
            self._flops -= f
            self._bytes -= b
            self._device_s -= ds
            self._rows -= r
        for d in self._phase.values():
            while d and d[0][0] < horizon:
                d.popleft()

    def _observed_span(self, now: float) -> float:
        if self._first_entry is None:
            return 0.0
        return min(self.window_s, max(now - self._first_entry, 1e-9))

    def _duty_locked(self, now: float) -> float:
        """Duty over the window's OWN observed span — one denominator for
        duty, busy seconds, and the wall roofline (a fetch-anchored
        interval may predate the first record; clamping keeps the three
        mutually consistent)."""
        span = self._observed_span(now)
        if span <= 0.0:
            return 0.0
        return min(self._duty.busy_s(now) / span, 1.0)

    def _window_roofline_locked(self, now: float) -> tuple:
        """(wall mfu_pct, wall bw_pct) over the observed window span —
        the serving-level numbers comparable to the bench/r05 rows."""
        span = self._observed_span(now)
        if self.backend is None:
            return None, None  # a card with no datasheet peaks
        if span <= 0.0:
            return 0.0, 0.0
        peak = costmodel.PEAKS.get(self.backend, costmodel.PEAKS["cpu"])
        mfu = 100.0 * (self._flops / span / 1e12) / peak["tflops"]
        bw = 100.0 * (self._bytes / span / 1e9) / peak["hbm_gbs"]
        return round(mfu, 3), round(bw, 3)

    # -- introspection -------------------------------------------------------

    def control_signals(self) -> dict:
        """The cheap per-tick sensor read for the control plane's lane
        controller (serving/controller.py): duty cycle, mean queue wait,
        and the dispatch count over the window — means only, no
        percentile sorts, so a 1 Hz tick costs O(window samples) adds
        under the lock and nothing else."""
        now = time.monotonic()
        with self._lock:
            self._evict(now)
            qw = self._phase.get("queue_wait")
            qw_mean = (sum(ms for _, ms in qw) / len(qw)) if qw else 0.0
            return {
                "duty_cycle": round(self._duty_locked(now), 4),
                "queue_wait_mean_ms": round(qw_mean, 3),
                "dispatches": len(self._entries),
            }

    def clear(self) -> None:
        """Reset the window (bench measurement slices)."""
        with self._lock:
            self._entries.clear()
            for d in self._phase.values():
                d.clear()
            self._duty = DutyCycle(self.window_s)
            self._flops = self._bytes = 0
            self._device_s = 0.0
            self._rows = 0
            self._first_entry = None
            self._started = time.monotonic()

    def summary(self) -> dict:
        """The /debug/perf body: window roofline (wall-clock AND
        device-busy forms), duty cycle, per-phase p50/p99 + share of the
        accounted dispatch wall, tier/regime tallies."""
        now = time.monotonic()
        with self._lock:
            self._evict(now)
            span = self._observed_span(now)
            duty = self._duty_locked(now)
            n = len(self._entries)
            flops, byts = self._flops, self._bytes
            device_s, rows = self._device_s, self._rows
            phase_ms = {p: [ms for _, ms in d]
                        for p, d in self._phase.items() if d}
            tiers: dict[str, int] = {}
            regimes: dict[str, int] = {}
            fused_n = fused_viol = 0
            for _, _, _, _, tier, regime, _, fused, viol in self._entries:
                tiers[tier] = tiers.get(tier, 0) + 1
                if fused:
                    fused_n += 1
                if viol:
                    fused_viol += 1
                if regime:
                    regimes[regime] = regimes.get(regime, 0) + 1
            total_dispatches = self._total_dispatches
        busy_s = duty * span
        out: dict = {
            "window_s": self.window_s,
            "observed_s": round(span, 3),
            "backend": self.backend,
            "trace_sample_rate": self.sample_hint,
            "dispatches": n,
            "dispatches_lifetime": total_dispatches,
            "rows": rows,
            "duty_cycle": round(duty, 4),
            # union of in-flight (enqueue->fetch) intervals — the
            # device-busy roofline's denominator
            "device_busy_s": round(busy_s, 4),
            # sum of blocked-fetch times: a LOWER bound on device time
            # (a result landing during host overlap fetches in ~0 ms), so
            # it is reported but never used as a roofline denominator
            "device_fetch_s": round(device_s, 4),
        }
        # wall roofline: achieved over the observed window span — the
        # serving-level MFU (what r05's 1.78% measured). device-busy
        # roofline: the same work over only the in-flight seconds —
        # utilization while the device had a dispatch in flight
        # (wall mfu = duty_cycle x this). The gap between the two IS the
        # orchestration overhead the duty cycle measures.
        if span > 0.0 and flops > 0 and self.backend is not None:
            out["roofline"] = costmodel.roofline(
                flops / span, byts / span, 1.0, self.backend)
            if busy_s > 0.0:
                out["roofline_device_busy"] = costmodel.roofline(
                    flops, byts, busy_s, self.backend)
        phases: dict = {}
        total_accounted = sum(sum(v) for v in phase_ms.values())
        for p in PHASES:
            vals = phase_ms.get(p)
            if not vals:
                continue
            svals = sorted(vals)
            phases[p] = {
                "samples": len(svals),
                "p50_ms": round(_pct(svals, 50.0), 3),
                "p99_ms": round(_pct(svals, 99.0), 3),
                "mean_ms": round(sum(svals) / len(svals), 3),
                "share_of_wall": round(sum(svals) / total_accounted, 4)
                if total_accounted > 0.0 else None,
            }
        out["phases"] = phases
        out["tiers"] = dict(sorted(tiers.items(), key=lambda kv: -kv[1]))
        out["regimes"] = dict(sorted(regimes.items(), key=lambda kv: -kv[1]))
        # fused-dispatch coverage + invariant violations over the window
        # (costmodel.fused_invariant_ok): share near 1.0 with violations 0
        # is the steady state; violations > 0 means host post-processing
        # crept back into a dispatch that claims device-side translation
        out["fused"] = {"dispatches": fused_n, "violations": fused_viol}
        return out


def _pct(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    i = min(int(len(sorted_vals) * q / 100.0), len(sorted_vals) - 1)
    return float(sorted_vals[i])


# -- module state + zero-hop accessors ----------------------------------------

_window: Optional[PerfWindow] = None

# final summaries of recently-unconfigured windows (CI failure artifact:
# tests/conftest.py dumps these so a red run's bundle carries the perf
# picture of the Apps the suite ran — bounded, newest last). Guarded by
# its own lock: concurrent App teardowns (test suites) share it.
_final_summaries: deque = deque(maxlen=8)
_summaries_lock = threading.Lock()


def configure(window: Optional[PerfWindow]) -> Optional[PerfWindow]:
    """Install (or clear, with None) the process-wide perf window."""
    global _window
    _window = window
    return window


def unconfigure(window: PerfWindow) -> None:
    """Clear the global only if it is still `window` (App shutdown must
    not tear down a newer App's window); stash its final summary for the
    CI artifact dump when it saw any dispatches."""
    global _window
    try:
        if window._total_dispatches > 0:
            doc = window.summary()
            with _summaries_lock:
                _final_summaries.append(doc)
    except Exception:  # noqa: BLE001 — teardown must never fail shutdown
        pass
    if _window is window:
        _window = None


def get_window() -> Optional[PerfWindow]:
    return _window


def recent_summaries() -> list:
    """Final summaries of windows torn down this process (newest last),
    plus the live window's current summary when one is installed."""
    with _summaries_lock:
        out = list(_final_summaries)
    w = _window
    if w is not None:
        try:
            out.append(w.summary())
        except Exception:  # noqa: BLE001
            pass
    return out
