# The port's copy of weaviate_tpu/serving/controller.py, its imports pointed at the port.
"""Self-tuning degradation control plane: the observability loop, closed.

PRs 7-10 built six observability layers that measure every dispatch —
tracing/perf attribution, the shadow recall auditor, the memory ledger,
SLO burn rates, the incident journal — but nothing *acts* on them: the
serving plane degrades on static knobs while the sensors watch (ROADMAP
item 4). This module hosts the four controllers that turn those sensors
into actuators, each a clamped sense -> decide -> actuate -> journal
loop on one supervised tick thread:

**Brownout** (``SloEngine`` fast/slow burn -> a staged degradation
ladder): instead of alerting and cliff-edge shedding, rising burn walks
serving DOWN a ladder — stage 1 tightens admission margins (the
deadline-unreachable estimate is multiplied, shedding earlier), stage 2
shrinks per-tenant budgets, scales Retry-After hints up, and halves
tenant rate quotas, stage 3 pauses optional work (shadow-audit and
trace sampling). Recovery walks back DOWN one stage at a time only
after ``hold_ticks`` consecutive clean ticks — hysteresis, so a burn
oscillating around the threshold cannot flap the ladder.

**Recall-guarded candidate budget** (the PR-8 recall EWMA -> the PQ
fast-scan ``rescore_r`` cap in index/gpu.py): while every audited
tier's recall EWMA holds ``recall_slack`` above the configured floor,
the cap steps DOWN one jit bucket (speed bought with *measured* slack —
AQR-HNSW parameterizes this budget statically; here it is a measured
quantity); the moment the EWMA nears the floor it steps back UP
immediately (safety is asymmetric: cuts are held, restores are not).
Cap values come only from ``R_BUCKETS`` so jit shapes stay cached, and
the knob is inert without a live auditor — no signal, no actuation.

**Coalescer lanes** (the PR-7 duty-cycle / queue-wait split -> the
flush window and pipeline depth): queue-dominated (requests wait while
the device is busy) widens the window so dispatches fill; a starved
device with waiting work deepens the pipeline; a quiet system walks
both back to their configured defaults.

**Tenant rate quotas** (``TENANT_RATE_QPS`` x DRR weights -> token
buckets): the open PR-6 fairness follow-up — the row budget bounds
occupancy, this bounds request RATE. Enforcement rides coalescer
admission (``take_rate_token``), shedding ``tenant_rate`` with
Retry-After = time-to-next-token; brownout stage 2 scales the refill.

Fail-static safety — the control plane may never degrade serving:

- every knob is CLAMPED in ``_set_knob`` (the one actuate helper;
  graftlint JGL014 statically pins that nothing outside this module
  writes a controller-owned knob) and journaled as a
  ``controller_actuation`` ops event;
- knob values carry a LEASE: readers (coalescer admission, the index's
  ``_rescore_r``) fall back to the configured default once a value goes
  ``lease_s`` stale, so a STALLED tick thread reverts the module-read
  knobs in bounded time without any watchdog;
- a DYING tick thread (``serving.controller.tick`` fault point, action
  ``die``) reverts every knob — including the object-state ones
  (pipeline depth, paused sampling) — in its ``finally`` and journals a
  ``controller_revert`` before the thread exits;
- per-controller config gates plus ``CONTROL_PLANE_ENABLED`` kill the
  whole plane: disabled, the module global stays None and every reader
  on the serving path is a one-comparison no-op that constructs nothing
  (spy-pinned in tests/test_controller.py).

Exposure: ``GET /debug/controllers`` (same authorizer as the other
debug planes), ``weaviate_controller_*`` gauges/counters, a
``controllers`` section in every flight-recorder bundle, and the
``--controllers on|off|both`` bench rows. See docs/control.md.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Optional

from weaviate_tpu_torch.config import ControllerConfig
from weaviate_tpu_torch.config.config import (IVF_TOP_P_BUCKETS,
                                        PQ4_FUNNEL_C_BUCKETS,
                                        PQ4_FUNNEL_RESCORE_BUCKETS,
                                        RESCORE_R_BUCKETS)
from weaviate_tpu_torch.monitoring import incidents
from weaviate_tpu_torch.testing import faults, sanitizers

_LOG = logging.getLogger(__name__)

# the PQ fast-scan candidate-budget cap may take ONLY these values:
# rescore_r is a jit static argument, so an unconstrained cap would mint
# one compiled kernel per distinct value — bucketed, the cache stays as
# bounded as the index's own query-padding buckets. The top bucket (128)
# is index/gpu.py's built-in maximum, i.e. "controller inactive".
# The table itself lives in config (ONE source of truth): index/gpu.py's
# static-arg snapping imports the same tuple, so a controller cut can
# never mint a jit shape the index wouldn't also compile.
R_BUCKETS = RESCORE_R_BUCKETS

# the IVF probe-count cap's bucket ladder (config.IVF_TOP_P_BUCKETS —
# the same one-source-of-truth discipline as R_BUCKETS: index/gpu.py
# snaps every effective top_p to this table, so a controller cut can
# never mint a jit shape the static path wouldn't also compile). The
# top bucket means "controller inactive": the index's own configured
# probe count applies unchanged.
P_BUCKETS = IVF_TOP_P_BUCKETS

# the 4-bit funnel's two stage budgets (config.PQ4_FUNNEL_*_BUCKETS —
# the same one-source-of-truth discipline again: index/gpu.py
# _funnel_budgets snaps both jit statics to these tables). Top bucket =
# "controller inactive": the funnel's built-in maxima apply.
FC_BUCKETS = PQ4_FUNNEL_C_BUCKETS
FR_BUCKETS = PQ4_FUNNEL_RESCORE_BUCKETS

# brownout ladder stages (stage 0 = normal serving)
STAGE_NORMAL = 0
STAGE_MARGIN = 1      # tighten admission margins (shed earlier)
STAGE_BUDGET = 2      # shrink tenant budgets, scale Retry-After + rates
STAGE_SHED_OPTIONAL = 3  # pause audit/trace sampling

# knob names: a FIXED set — these are also the bounded label values of
# weaviate_controller_knob{knob}. Values live in the plane's leased
# store; object-state actuations (pipeline depth, paused sampling) are
# reverted by the run loop's finally instead of a lease.
KNOB_WINDOW_S = "coalescer_window_s"
KNOB_MARGIN = "admission_margin"
KNOB_CAP_SCALE = "tenant_cap_scale"
KNOB_RETRY_SCALE = "retry_after_scale"
KNOB_RESCORE_CAP = "rescore_r_cap"
KNOB_RATE_SCALE = "rate_scale"
KNOB_IVF_TOP_P = "ivf_top_p"
KNOB_FUNNEL_C = "funnel_c_cap"
KNOB_FUNNEL_RESCORE = "funnel_rescore_cap"
KNOB_NAMES = (KNOB_WINDOW_S, KNOB_MARGIN, KNOB_CAP_SCALE,
              KNOB_RETRY_SCALE, KNOB_RESCORE_CAP, KNOB_RATE_SCALE,
              KNOB_IVF_TOP_P, KNOB_FUNNEL_C, KNOB_FUNNEL_RESCORE)


def _snap_bucket(value: float, buckets=R_BUCKETS) -> int:
    """Largest bucket <= value (floor snap; below the smallest bucket ->
    the smallest — the clamp floor)."""
    best = buckets[0]
    for b in buckets:
        if b <= value:
            best = b
    return int(best)


class _TokenBuckets:
    """Per-tenant token buckets metering request RATE at coalescer
    admission. Refill = TENANT_RATE_QPS x the tenant's DRR weight x the
    brownout ``rate_scale``; burst = rate x burst_s (>= 1 token, so a
    quota can never deadlock a tenant outright). ``take`` -> None when a
    token was spent, else seconds until the next token accrues — the
    Retry-After hint, proportional to how far over rate the tenant is."""

    _MAX_TENANTS = 1024

    def __init__(self, rate_qps: float, burst_s: float,
                 weights: Optional[dict] = None):
        self.rate_qps = max(float(rate_qps), 0.0)
        self.burst_s = max(float(burst_s), 0.001)
        self.weights = dict(weights or {})
        self._lock = threading.Lock()
        # tenant -> [tokens, last_refill_monotonic]
        self._buckets: dict[str, list] = {}
        self.shed = 0
        self.taken = 0

    def _rate_for(self, tenant: str, scale: float) -> float:
        w = self.weights.get(tenant, 1.0)
        return self.rate_qps * max(float(w), 0.001) * scale

    def take(self, tenant: str, scale: float = 1.0) -> Optional[float]:
        rate = self._rate_for(tenant, scale)
        if rate <= 0.0:
            return None  # quota off (or scaled to nothing — never block)
        now = time.monotonic()
        burst = max(rate * self.burst_s, 1.0)
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = [burst, now]
                if len(self._buckets) > self._MAX_TENANTS:
                    # a storm of invented tenant ids must not grow this
                    # dict without bound: drop the stalest entries (their
                    # buckets re-warm FULL on the next request — erring
                    # toward admission, never toward a phantom quota)
                    stale = sorted(self._buckets, key=lambda t:
                                   self._buckets[t][1])
                    for t in stale[: self._MAX_TENANTS // 4]:
                        if t != tenant:
                            del self._buckets[t]
            tokens = min(b[0] + (now - b[1]) * rate, burst)
            b[1] = now
            if tokens >= 1.0:
                b[0] = tokens - 1.0
                self.taken += 1
                return None
            b[0] = tokens
            self.shed += 1
            return max((1.0 - tokens) / rate, 0.001)

    def prune(self, idle_s: float = 60.0) -> None:
        now = time.monotonic()
        with self._lock:
            dead = [t for t, b in self._buckets.items()
                    if now - b[1] > idle_s]
            for t in dead:
                del self._buckets[t]

    def stats(self) -> dict:
        with self._lock:
            return {"rate_qps": self.rate_qps, "burst_s": self.burst_s,
                    "tenants": len(self._buckets),
                    "taken": self.taken, "shed": self.shed}


class ControlPlane:
    """The supervised control plane: four clamped controllers on one
    exception-guarded tick thread. Constructed ONLY when
    CONTROL_PLANE_ENABLED is set (App wiring) — the disabled serving
    path reads module globals that stay None."""

    def __init__(self, config=None, coalescer=None, metrics=None,
                 tenant_weights: Optional[dict] = None, start: bool = True,
                 **overrides):
        cfg = _ControllerSettings(config, overrides)
        self.cfg = cfg
        self.coalescer = coalescer
        self.metrics = metrics
        self.tick_s = cfg.tick_s
        # module-read knobs go stale (revert to defaults at the reader)
        # after this long without a tick refresh: a stalled thread
        # fail-statics in bounded time without any watchdog thread
        self.lease_s = max(self.tick_s * 8.0, 2.0)
        self._lock = sanitizers.register_lock(
            threading.Lock(), "serving.controller")
        # knob name -> (value, stamp). Read lock-free on the serving path
        # (tuple replacement is atomic; a torn read is impossible);
        # written only by _set_knob / the lease refresh under _lock.
        self._knobs: dict[str, tuple] = {}
        # configured defaults, captured once: what revert restores
        self._defaults = {
            KNOB_WINDOW_S: (coalescer.window_s if coalescer is not None
                            else 0.0015),
            KNOB_MARGIN: 1.0,
            KNOB_CAP_SCALE: 1.0,
            KNOB_RETRY_SCALE: 1.0,
            KNOB_RESCORE_CAP: float(R_BUCKETS[-1]),
            KNOB_RATE_SCALE: 1.0,
            KNOB_IVF_TOP_P: float(P_BUCKETS[-1]),
            KNOB_FUNNEL_C: float(FC_BUCKETS[-1]),
            KNOB_FUNNEL_RESCORE: float(FR_BUCKETS[-1]),
        }
        self._depth_default = (coalescer._depth if coalescer is not None
                               else 1)
        # clamp ranges — the actuate helper enforces these on EVERY write
        w_def = self._defaults[KNOB_WINDOW_S]
        self._clamps = {
            KNOB_WINDOW_S: (min(cfg.window_min_ms / 1000.0, w_def),
                            max(cfg.window_max_ms / 1000.0, w_def)),
            KNOB_MARGIN: (1.0, 4.0),
            KNOB_CAP_SCALE: (0.25, 1.0),
            KNOB_RETRY_SCALE: (1.0, 8.0),
            KNOB_RESCORE_CAP: (float(R_BUCKETS[0]), float(R_BUCKETS[-1])),
            KNOB_RATE_SCALE: (0.25, 1.0),
            KNOB_IVF_TOP_P: (float(P_BUCKETS[0]), float(P_BUCKETS[-1])),
            KNOB_FUNNEL_C: (float(FC_BUCKETS[0]), float(FC_BUCKETS[-1])),
            KNOB_FUNNEL_RESCORE: (float(FR_BUCKETS[0]),
                                  float(FR_BUCKETS[-1])),
        }
        # token buckets (controller 4); rate 0 = quota off
        self.rate_buckets = _TokenBuckets(
            cfg.tenant_rate_qps, cfg.tenant_rate_burst_s, tenant_weights)
        # brownout ladder state
        self.brownout_stage = STAGE_NORMAL
        self._stage_clean_ticks = 0
        self._sampling_paused = False
        self._saved_audit = None   # (auditor, rate) while paused
        self._saved_trace = None   # (tracer, rate) while paused
        # recall-budget state: index into R_BUCKETS (top = inactive)
        self._r_idx = len(R_BUCKETS) - 1
        self._r_hold = 0
        # the second recall-guarded budget (ROADMAP item-4 follow-up,
        # landed with the IVF plane): index into P_BUCKETS for the IVF
        # probe-count cap (top = inactive)
        self._p_idx = len(P_BUCKETS) - 1
        self._p_hold = 0
        # the third and fourth recall-guarded budgets (the 4-bit funnel's
        # stage-C and stage-c depths, index/gpu.py _funnel_budgets):
        # indices into FC_/FR_BUCKETS (top = inactive)
        self._fc_idx = len(FC_BUCKETS) - 1
        self._fc_hold = 0
        self._fr_idx = len(FR_BUCKETS) - 1
        self._fr_hold = 0
        # lane-controller state: hysteresis counts CONSECUTIVE qualifying
        # ticks in ONE direction — the paired _dir resets the counter when
        # the qualifying branch flips, so mixed evidence never actuates
        self._win_hold = 0
        self._win_dir = 0
        self._depth_hold = 0
        self._depth_dir = 0
        self._depth = self._depth_default
        # bookkeeping
        self._ticks = 0
        self._actuations: dict[str, int] = {}
        self._recent: deque = deque(maxlen=32)  # last actuations, for /debug
        self._reverted = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._run, name="serving-controller", daemon=True)
            self._thread.start()

    # -- the leased knob store (serving-path reads are lock-free) -------------

    def _read(self, name: str, default):
        entry = self._knobs.get(name)
        if entry is None:
            return default
        value, stamp = entry
        if time.monotonic() - stamp > self.lease_s:
            # stale lease: the tick thread stalled or died without its
            # finally running — fail static at the reader
            return default
        return value

    def _set_knob(self, name: str, value: float, controller: str,
                  reason: str = "") -> float:
        """THE clamped actuate helper (graftlint JGL014 pins that knob
        writes happen nowhere else): clamp to the knob's configured
        range (bucket-snapped for the jit-static rescore cap), store
        under a fresh lease, journal the change, count it. -> the value
        actually applied."""
        lo, hi = self._clamps[name]
        v = min(max(float(value), lo), hi)
        if name == KNOB_RESCORE_CAP:
            v = float(_snap_bucket(v))
        elif name == KNOB_IVF_TOP_P:
            v = float(_snap_bucket(v, P_BUCKETS))
        elif name == KNOB_FUNNEL_C:
            v = float(_snap_bucket(v, FC_BUCKETS))
        elif name == KNOB_FUNNEL_RESCORE:
            v = float(_snap_bucket(v, FR_BUCKETS))
        prev = self._read(name, self._defaults[name])
        now = time.monotonic()
        with self._lock:
            if v == self._defaults[name]:
                self._knobs.pop(name, None)  # default = absent = fast read
            else:
                self._knobs[name] = (v, now)
        if v != prev:
            self._journal_actuation(name, prev, v, controller, reason)
        return v

    def _journal_actuation(self, knob: str, prev, value, controller: str,
                           reason: str) -> None:
        """One actuation record, everywhere it surfaces: the /debug deque,
        the ops journal, the per-controller counter + metric. Both actuate
        paths (_set_knob and the object-state _actuate_depth) feed this,
        so the record shape cannot drift between them. The deque/counter
        writes take the lock: summary() snapshots them from debug/bundle
        threads while the tick thread actuates."""
        with self._lock:
            self._reverted = False  # an actuation re-arms revert_all
            self._actuations[controller] = \
                self._actuations.get(controller, 0) + 1
            self._recent.append({"ts": round(time.time(), 3), "knob": knob,
                                 "from": prev, "to": value,
                                 "controller": controller, "reason": reason})
        incidents.emit("controller_actuation", scope=knob,
                       controller=controller, prev=prev, value=value,
                       reason=reason)
        m = self.metrics
        if m is not None:
            try:
                m.controller_actuations.labels(controller).inc()
            except Exception:  # noqa: BLE001 — metrics must not break the tick
                pass

    def _refresh_leases(self) -> None:
        """Re-stamp every live knob (called each tick): an ACTIVE thread
        keeps its actuations fresh; a stalled/dead one lets them lapse."""
        now = time.monotonic()
        with self._lock:
            for name, (v, _) in list(self._knobs.items()):
                self._knobs[name] = (v, now)

    # -- the supervised tick thread -------------------------------------------

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.tick_s):
                # fault point: `die` (a BaseException) escapes the tick
                # guard below and kills this thread the way a real thread
                # death would — the finally then proves fail-static
                faults.fire("serving.controller.tick")
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the control loop must survive
                    _LOG.warning("controller tick failed", exc_info=True)
        finally:
            # dying WITHOUT a clean shutdown: revert every actuated knob
            # so a dead controller can never leave serving degraded. On a
            # clean stop this performs the shutdown revert (idempotent —
            # shutdown()'s own call then no-ops), and a STRAGGLING tick
            # that re-actuated after a timed-out join re-armed the flag,
            # so its exit path reverts what it re-applied.
            self.revert_all("controller thread died"
                            if not self._stop.is_set()
                            else "control plane shutdown")

    def tick(self) -> None:
        """One sense -> decide -> actuate -> journal pass (public so
        tests drive it deterministically with start=False)."""
        self._ticks += 1
        self._refresh_leases()
        if self.cfg.brownout_enabled:
            self._tick_brownout()
        if self.cfg.budget_enabled:
            self._tick_budget()
        if self.cfg.lanes_enabled:
            self._tick_lanes()
        self.rate_buckets.prune()
        self._publish_gauges()

    # -- controller 1: burn-rate brownout -------------------------------------

    def _sense_burn(self) -> tuple:
        """(max fast burn, max slow burn) across availability SLOs, or
        (None, None) when the SLO engine is off/cold."""
        eng = incidents.get_engine()
        if eng is None:
            return None, None
        try:
            return eng.burn_rates()
        except Exception:  # noqa: BLE001 — a broken sensor reads as "no signal"
            return None, None

    def _tick_brownout(self) -> None:
        fast, slow = self._sense_burn()
        cfg = self.cfg
        burning_fast = fast is not None and fast >= cfg.fast_burn_threshold
        burning_slow = slow is not None and slow >= cfg.slow_burn_threshold
        if burning_fast:
            self._stage_clean_ticks = 0
            if self.brownout_stage < STAGE_SHED_OPTIONAL:
                self._enter_stage(self.brownout_stage + 1, fast, slow)
        elif burning_slow:
            # a smolder justifies stage 1 — no more: it lights stage 1
            # from normal serving, and it lets the AGGRESSIVE stages a
            # past cliff ratcheted up decay back to 1 on the same
            # hysteresis clock. Without the decay, a 5-minute storm's
            # residue in the 1 h window would pin stage 3 (sampling
            # paused, caps halved, budget frozen) for the better part of
            # an hour after the fast burn cleared.
            if self.brownout_stage == STAGE_NORMAL:
                self._stage_clean_ticks = 0
                self._enter_stage(STAGE_MARGIN, fast, slow)
            elif self.brownout_stage > STAGE_MARGIN:
                self._stage_clean_ticks += 1
                if self._stage_clean_ticks >= cfg.hold_ticks:
                    self._stage_clean_ticks = 0
                    self._enter_stage(self.brownout_stage - 1, fast, slow)
            else:
                self._stage_clean_ticks = 0  # at stage 1: hold
        else:
            self._stage_clean_ticks += 1
            if self.brownout_stage > STAGE_NORMAL \
                    and self._stage_clean_ticks >= cfg.hold_ticks:
                # hysteresis: one stage down per hold_ticks clean ticks —
                # a square-wave burn cannot flap the ladder
                self._stage_clean_ticks = 0
                self._enter_stage(self.brownout_stage - 1, fast, slow)

    def _enter_stage(self, stage: int, fast, slow) -> None:
        prev, self.brownout_stage = self.brownout_stage, stage
        cfg = self.cfg
        self._set_knob(KNOB_MARGIN,
                       cfg.brownout_margin if stage >= STAGE_MARGIN else 1.0,
                       "brownout", reason=f"stage {stage}")
        deep = stage >= STAGE_BUDGET
        self._set_knob(KNOB_CAP_SCALE,
                       cfg.brownout_cap_scale if deep else 1.0,
                       "brownout", reason=f"stage {stage}")
        self._set_knob(KNOB_RETRY_SCALE,
                       cfg.brownout_retry_scale if deep else 1.0,
                       "brownout", reason=f"stage {stage}")
        self._set_knob(KNOB_RATE_SCALE,
                       cfg.brownout_rate_scale if deep else 1.0,
                       "brownout", reason=f"stage {stage}")
        if stage >= STAGE_SHED_OPTIONAL:
            self._pause_sampling()
        else:
            self._resume_sampling()
        incidents.emit("controller_brownout", scope="serving",
                       stage=stage, prev=prev,
                       fast_burn=round(fast, 2) if fast is not None else None,
                       slow_burn=round(slow, 2) if slow is not None else None)
        _LOG.warning(
            "brownout ladder %s: stage %d -> %d (fast burn %s, slow burn "
            "%s) — admission margin x%.2g, tenant cap x%.2g, Retry-After "
            "x%.2g, sampling %s",
            "escalated" if stage > prev else "recovered",
            prev, stage,
            f"{fast:.2f}" if fast is not None else "n/a",
            f"{slow:.2f}" if slow is not None else "n/a",
            self._read(KNOB_MARGIN, 1.0), self._read(KNOB_CAP_SCALE, 1.0),
            self._read(KNOB_RETRY_SCALE, 1.0),
            "paused" if stage >= STAGE_SHED_OPTIONAL else "on")
        m = self.metrics
        if m is not None:
            try:
                m.controller_brownout_stage.set(stage)
            except Exception:  # noqa: BLE001 — metrics must not break the tick
                pass

    def _pause_sampling(self) -> None:
        """Stage 3: optional work yields to serving — shadow audits and
        trace sampling pause (their workers stay up; the sample gates go
        to zero). The pre-pause rates are saved for the resume/revert."""
        if self._sampling_paused:
            return
        from weaviate_tpu_torch.monitoring import quality, tracing

        a = quality.get_auditor()
        if a is not None:
            self._saved_audit = (a, a.sample_rate)
            a.set_sample_rate(0.0)
        t = tracing.get_tracer()
        if t is not None:
            self._saved_trace = (t, t.sample_rate)
            t.set_sample_rate(0.0)
        self._sampling_paused = True

    def _resume_sampling(self) -> None:
        if not self._sampling_paused:
            return
        if self._saved_audit is not None:
            a, rate = self._saved_audit
            try:
                a.set_sample_rate(rate)
            except Exception:  # noqa: BLE001 — a torn-down auditor is fine
                pass
            self._saved_audit = None
        if self._saved_trace is not None:
            t, rate = self._saved_trace
            try:
                t.set_sample_rate(rate)
            except Exception:  # noqa: BLE001 — a torn-down tracer is fine
                pass
            self._saved_trace = None
        self._sampling_paused = False

    # -- controller 2: recall-guarded candidate budget ------------------------

    def _sense_recall(self) -> Optional[float]:
        """Min recall EWMA across audited tiers with enough samples, or
        None when the auditor is off/cold — no signal, no actuation."""
        from weaviate_tpu_torch.monitoring import quality

        a = quality.get_auditor()
        if a is None:
            return None
        # a zeroed sample gate (brownout stage 3 paused it, or the operator
        # configured it off) means the EWMA is FROZEN, not fresh: the
        # QualityWindow never decays, so tier_ewmas() would keep vouching
        # with pre-pause numbers while actual recall is unmeasured
        if getattr(a, "sample_rate", 0.0) <= 0.0:
            return None
        try:
            ewmas = a.tier_ewmas()
        except Exception:  # noqa: BLE001 — a broken sensor reads as "no signal"
            return None
        vals = [ew for ew, n in ewmas.values()
                if n >= self.cfg.recall_min_samples]
        return min(vals) if vals else None

    def _ladder_step(self, knob: str, buckets, idx: int, hold: int,
                     ewma) -> tuple[int, int]:
        """The ONE recall-guarded cut/backoff/dead-band state machine,
        shared by both budgets (the rescore cap and the IVF probe cap —
        their only legitimate divergence is what a paused sample gate
        means, which the CALLERS decide by what they pass as `ewma`).
        -> (new bucket index, new hold count)."""
        cfg = self.cfg
        top = len(buckets) - 1
        if ewma is None:
            # signal gone: fail static — a budget may only stay cut
            # while the recall meter actively vouches for it
            if idx != top:
                self._set_knob(knob, buckets[top], "budget",
                               reason="no recall signal")
            return top, 0
        if ewma < cfg.recall_floor + cfg.recall_backoff_margin:
            # near (or under) the floor: back off IMMEDIATELY — restores
            # are never held behind hysteresis, only cuts are
            if idx < top:
                idx = min(idx + 1, top)
                self._set_knob(knob, buckets[idx], "budget",
                               reason=f"ewma {ewma:.4f} near floor "
                                      f"{cfg.recall_floor}")
            return idx, 0
        if ewma >= cfg.recall_floor + cfg.recall_slack:
            hold += 1
            if hold >= cfg.hold_ticks and idx > 0:
                idx -= 1
                self._set_knob(knob, buckets[idx], "budget",
                               reason=f"ewma {ewma:.4f} holds slack over "
                                      f"floor {cfg.recall_floor}")
                return idx, 0
            return idx, hold
        return idx, 0  # dead band: hold position

    def _tick_budget(self) -> None:
        self._tick_ivf_budget()
        if self._sampling_paused:
            # brownout stage 3 silenced the meter ITSELF: hold the cap at
            # its last vouched-for value — restoring to the 128 maximum
            # would 4x per-query device work exactly while the SLO burns,
            # and cutting further would act on a frozen EWMA. The lease
            # keeps the held value alive only while this thread ticks, so
            # a stalled/dead plane still fail-statics at the readers.
            self._r_hold = 0
            self._fc_hold = 0
            self._fr_hold = 0
            return
        ewma = self._sense_recall()
        self._r_idx, self._r_hold = self._ladder_step(
            KNOB_RESCORE_CAP, R_BUCKETS, self._r_idx, self._r_hold, ewma)
        # The funnel's two stage budgets ride the same ladder with the
        # same paused-gate semantics as the rescore cap: both caps only
        # ever CUT device work (index/gpu.py floors them against k and
        # falls back to the built-in maxima when a cut would starve
        # top-k), so restoring to maximum mid-brownout would multiply
        # stage-2/3 re-rank work exactly while the SLO burns.
        self._fc_idx, self._fc_hold = self._ladder_step(
            KNOB_FUNNEL_C, FC_BUCKETS, self._fc_idx, self._fc_hold, ewma)
        self._fr_idx, self._fr_hold = self._ladder_step(
            KNOB_FUNNEL_RESCORE, FR_BUCKETS, self._fr_idx, self._fr_hold,
            ewma)

    def _tick_ivf_budget(self) -> None:
        """The SECOND recall-guarded budget (ROADMAP item 3/4): the IVF
        probe-count cap on the same shared ladder. The one divergence
        from the rescore cap is what a brownout-paused sample gate
        means: here it reads as NO SIGNAL -> revert — unlike the
        rescore cap (where restoring to maximum 4x's per-query work
        mid-burn and the last vouched-for value is held), restoring
        top_p to the configured probe count is the recall-safe
        direction and the index's own configured value bounds its cost,
        so a silenced meter may not keep vouching for probe cuts."""
        ewma = None if self._sampling_paused else self._sense_recall()
        self._p_idx, self._p_hold = self._ladder_step(
            KNOB_IVF_TOP_P, P_BUCKETS, self._p_idx, self._p_hold, ewma)

    # -- controller 3: coalescer window / pipeline depth ----------------------

    def _sense_lanes(self) -> Optional[dict]:
        from weaviate_tpu_torch.monitoring import perf

        pw = perf.get_window()
        if pw is None:
            return None
        try:
            return pw.control_signals()
        except Exception:  # noqa: BLE001 — a broken sensor reads as "no signal"
            return None

    def _tick_lanes(self) -> None:
        if self.coalescer is None:
            return
        sig = self._sense_lanes()
        if sig is None or sig.get("dispatches", 0) < 4:
            return  # too little traffic to steer on
        cfg = self.cfg
        duty = sig["duty_cycle"]
        qw_ms = sig["queue_wait_mean_ms"]
        win = self._read(KNOB_WINDOW_S, self._defaults[KNOB_WINDOW_S])
        win_ms = win * 1000.0
        # window: queue-dominated (waits dwarf the window while the
        # device stays busy) -> widen so dispatches fill and per-dispatch
        # overhead amortizes; a starved device with short waits -> walk
        # back toward the configured default for latency
        if qw_ms > 2.0 * win_ms and duty >= cfg.duty_hi:
            self._win_hold = self._win_hold + 1 if self._win_dir == 1 else 1
            self._win_dir = 1
            if self._win_hold >= cfg.hold_ticks:
                self._win_hold = 0
                self._set_knob(KNOB_WINDOW_S, win * 1.5, "lanes",
                               reason=f"queue-dominated (wait {qw_ms:.2f}ms"
                                      f", duty {duty:.2f})")
        elif duty <= cfg.duty_lo and qw_ms < 0.5 * win_ms:
            self._win_hold = self._win_hold + 1 if self._win_dir == -1 else 1
            self._win_dir = -1
            if self._win_hold >= cfg.hold_ticks:
                self._win_hold = 0
                target = max(win / 1.5, self._defaults[KNOB_WINDOW_S])
                self._set_knob(KNOB_WINDOW_S, target, "lanes",
                               reason=f"device-starved (duty {duty:.2f})")
        else:
            self._win_hold = self._win_dir = 0
        # pipeline depth: a starved device WITH waiting work is a
        # pipeline bubble (enqueue and finalize serialize) -> deepen;
        # a saturated device gains nothing from extra in-flight lanes ->
        # walk back to the configured default
        if duty <= cfg.duty_lo and qw_ms > win_ms \
                and self._depth < cfg.depth_max:
            self._depth_hold = \
                self._depth_hold + 1 if self._depth_dir == 1 else 1
            self._depth_dir = 1
            if self._depth_hold >= cfg.hold_ticks:
                self._depth_hold = 0
                self._actuate_depth(self._depth + 1,
                                    f"pipeline bubble (duty {duty:.2f}, "
                                    f"wait {qw_ms:.2f}ms)")
        elif duty >= cfg.duty_hi and self._depth > self._depth_default:
            self._depth_hold = \
                self._depth_hold + 1 if self._depth_dir == -1 else 1
            self._depth_dir = -1
            if self._depth_hold >= cfg.hold_ticks:
                self._depth_hold = 0
                self._actuate_depth(self._depth - 1,
                                    f"device saturated (duty {duty:.2f})")
        else:
            self._depth_hold = self._depth_dir = 0

    def _actuate_depth(self, depth: int, reason: str) -> None:
        depth = min(max(int(depth), 1), max(self.cfg.depth_max,
                                            self._depth_default))
        if depth == self._depth or self.coalescer is None:
            return
        prev = self._depth
        applied = self.coalescer.set_pipeline_depth(depth)
        self._depth = applied
        self._journal_actuation("pipeline_depth", prev, applied, "lanes",
                                reason)

    # -- controller 4: tenant rate quotas (enforcement entry) -----------------

    def take_rate_token(self, tenant: Optional[str]) -> Optional[float]:
        """Spend one token of `tenant`'s rate quota. -> None (admitted)
        or the Retry-After hint in seconds (time to the next token)."""
        if not tenant or self.rate_buckets.rate_qps <= 0.0:
            return None
        return self.rate_buckets.take(
            tenant, self._read(KNOB_RATE_SCALE, 1.0))

    # -- revert / lifecycle ----------------------------------------------------

    def revert_all(self, reason: str) -> None:
        """Restore EVERY actuated knob to its configured default: the
        leased store empties, pipeline depth and paused sampling restore,
        the ladder resets. Called by unconfigure (clean shutdown) and by
        the run loop's finally (thread death) — fail static, journaled.
        IDEMPOTENT until the next actuation: _journal_actuation clears
        the reverted flag, so a straggling tick that completes AFTER a
        timed-out shutdown join re-arms the revert its own finally then
        performs — shutdown() and the thread can both call this without
        double-journaling, and neither ordering leaks an actuation."""
        with self._lock:
            if self._reverted:
                return
            self._reverted = True
            had = {n: v for n, (v, _) in self._knobs.items()}
            self._knobs.clear()
        self._resume_sampling()
        if self.coalescer is not None and self._depth != self._depth_default:
            try:
                self.coalescer.set_pipeline_depth(self._depth_default)
            except Exception:  # noqa: BLE001 — revert must never raise
                pass
        self._depth = self._depth_default
        self.brownout_stage = STAGE_NORMAL
        self._stage_clean_ticks = 0
        self._r_idx = len(R_BUCKETS) - 1
        self._p_idx = len(P_BUCKETS) - 1
        self._fc_idx = len(FC_BUCKETS) - 1
        self._fr_idx = len(FR_BUCKETS) - 1
        self._r_hold = self._p_hold = self._win_hold = self._depth_hold = 0
        self._fc_hold = self._fr_hold = 0
        self._win_dir = self._depth_dir = 0
        incidents.emit("controller_revert", scope="serving",
                       reason=reason, knobs=sorted(had))
        if had:
            _LOG.warning(
                "control plane reverted %d knob(s) to configured defaults "
                "(%s): %s", len(had), reason, sorted(had))
        m = self.metrics
        if m is not None:
            try:
                m.controller_brownout_stage.set(0)
                for name in KNOB_NAMES:
                    m.controller_knob.labels(name).set(self._defaults[name])
            except Exception:  # noqa: BLE001 — revert must never raise
                pass

    def _publish_gauges(self) -> None:
        m = self.metrics
        if m is None:
            return
        try:
            m.controller_brownout_stage.set(self.brownout_stage)
            for name in KNOB_NAMES:
                m.controller_knob.labels(name).set(
                    self._read(name, self._defaults[name]))
        except Exception:  # noqa: BLE001 — metrics must not break the tick
            pass

    def summary(self) -> dict:
        """The /debug/controllers body (and the flight-recorder bundle
        section)."""
        knobs = {}
        for name in KNOB_NAMES:
            default = self._defaults[name]
            value = self._read(name, default)
            knobs[name] = {"value": value, "default": default,
                           "actuated": value != default}
        knobs["pipeline_depth"] = {
            "value": self._depth, "default": self._depth_default,
            "actuated": self._depth != self._depth_default}
        fast, slow = self._sense_burn()
        return {
            "tick_s": self.tick_s,
            "lease_s": round(self.lease_s, 3),
            "ticks": self._ticks,
            "thread_alive": (self._thread.is_alive()
                            if self._thread is not None else False),
            "controllers": {
                "brownout": {"enabled": self.cfg.brownout_enabled,
                             "stage": self.brownout_stage,
                             "clean_ticks": self._stage_clean_ticks,
                             "fast_burn": fast, "slow_burn": slow,
                             "sampling_paused": self._sampling_paused},
                "budget": {"enabled": self.cfg.budget_enabled,
                           "rescore_r_cap": R_BUCKETS[self._r_idx],
                           "ivf_top_p_cap": P_BUCKETS[self._p_idx],
                           "funnel_c_cap": FC_BUCKETS[self._fc_idx],
                           "funnel_rescore_cap": FR_BUCKETS[self._fr_idx],
                           "recall_floor": self.cfg.recall_floor,
                           "recall_ewma_min": self._sense_recall()},
                "lanes": {"enabled": self.cfg.lanes_enabled,
                          "pipeline_depth": self._depth,
                          "signals": self._sense_lanes()},
                "rate": {"enabled": self.rate_buckets.rate_qps > 0.0,
                         **self.rate_buckets.stats()},
            },
            "knobs": knobs,
            **self._actuation_snapshot(),
            "reverted": self._reverted,
        }

    def _actuation_snapshot(self) -> dict:
        # under the lock: the tick thread appends/inserts concurrently,
        # and copying a mutating deque/dict raises RuntimeError
        with self._lock:
            return {"actuations": dict(self._actuations),
                    "recent_actuations": list(self._recent)}

    def shutdown(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(self.tick_s * 4, 2.0))
        self.revert_all("control plane shutdown")


class _ControllerSettings:
    """Resolved controller settings: a ControllerConfig dataclass (config/
    config.py), overridden by explicit kwargs (tests). The field set and
    defaults are DERIVED from the dataclass (config imports nothing from
    serving/, so no cycle) — one source of truth, no drift between a
    test-constructed plane and a config-built one."""

    _FIELDS = {
        f.name: f.default
        for f in dataclasses.fields(ControllerConfig)
        if f.name != "enabled"  # App wiring's gate, not a plane setting
    }

    def __init__(self, config=None, overrides: Optional[dict] = None):
        overrides = overrides or {}
        for name, default in self._FIELDS.items():
            if name in overrides:
                value = overrides[name]
            elif config is not None and hasattr(config, name):
                value = getattr(config, name)
            else:
                value = default
            setattr(self, name, value)
        unknown = set(overrides) - set(self._FIELDS)
        if unknown:
            raise TypeError(f"unknown controller settings: {sorted(unknown)}")
        self.tick_s = max(float(self.tick_s), 0.01)
        self.hold_ticks = max(int(self.hold_ticks), 1)


# -- module state + zero-hop accessors ----------------------------------------

_plane: Optional[ControlPlane] = None

# final summaries of recently-unconfigured planes (CI failure artifact:
# tests/conftest.py dumps these to debug_control.json beside the other
# plane stashes). Guarded by its own lock — concurrent App teardowns
# share it (the perf.py pattern).
_final_summaries: deque = deque(maxlen=8)
_summaries_lock = threading.Lock()


def configure(plane: Optional[ControlPlane]) -> Optional[ControlPlane]:
    """Install (or clear, with None) the process-wide control plane."""
    global _plane
    _plane = plane
    return plane


def unconfigure(plane: ControlPlane) -> None:
    """Clear the global only if it is still `plane` (App shutdown must
    not tear down a newer App's plane); stop the tick thread and revert
    every knob to its configured default; stash the final summary for
    the CI artifact dump when it ever ticked."""
    global _plane
    if _plane is plane:
        _plane = None
    try:
        if plane._ticks or plane._actuations:
            doc = plane.summary()
            with _summaries_lock:
                _final_summaries.append(doc)
    except Exception:  # noqa: BLE001 — teardown must never fail shutdown
        pass
    plane.shutdown()


def get_plane() -> Optional[ControlPlane]:
    return _plane


def recent_summaries() -> list:
    """Final summaries of planes torn down this process (newest last),
    plus the live plane's current summary when one is installed."""
    with _summaries_lock:
        out = list(_final_summaries)
    p = _plane
    if p is not None:
        try:
            out.append(p.summary())
        except Exception:  # noqa: BLE001
            pass
    return out


# -- serving-path knob readers (disabled => one comparison, no work) ----------


def coalescer_window_s(default: float) -> float:
    """The coalescer's flush window (seconds), controller-steered."""
    p = _plane
    if p is None:
        return default
    return p._read(KNOB_WINDOW_S, default)


def admission_margin() -> float:
    """Multiplier on the deadline-unreachable queue-wait estimate —
    brownout tightens admission by inflating it (shed earlier)."""
    p = _plane
    if p is None:
        return 1.0
    return p._read(KNOB_MARGIN, 1.0)


def tenant_cap_scale() -> float:
    """Scale on the per-tenant in-system row cap (brownout shrinks it)."""
    p = _plane
    if p is None:
        return 1.0
    return p._read(KNOB_CAP_SCALE, 1.0)


def retry_after_scale() -> float:
    """Scale on shed Retry-After hints (brownout backs clients off
    harder while the ladder is engaged)."""
    p = _plane
    if p is None:
        return 1.0
    return p._read(KNOB_RETRY_SCALE, 1.0)


def rescore_r_cap(default: int) -> int:
    """Cap on the PQ fast-scan candidate budget (index/gpu.py
    ``_rescore_r``); the recall-guarded budget controller steps it down
    bucket-by-bucket while measured recall slack exists. Never exceeds
    `default` (the index's own maximum)."""
    p = _plane
    if p is None:
        return default
    return min(int(p._read(KNOB_RESCORE_CAP, default)), int(default))


def ivf_top_p_cap(default: int) -> int:
    """Cap on the IVF probe count (index/gpu.py ``_ivf_plan``) — the
    second recall-guarded budget: while the shadow auditor's recall
    EWMA holds measured slack over the floor, probes step down the
    P_BUCKETS ladder; signal loss (including a brownout-paused sample
    gate) reverts to `default` (the index's own configured probe
    count). Never exceeds `default` — the budget may only cut."""
    p = _plane
    if p is None:
        return default
    return min(int(p._read(KNOB_IVF_TOP_P, default)), int(default))


def funnel_c_cap(default: int) -> int:
    """Cap on the 4-bit funnel's stage-1 survivor count C (index/gpu.py
    ``_funnel_budgets``) — the third recall-guarded budget, stepping the
    FC_BUCKETS ladder with the rescore cap's pause semantics (a silenced
    meter holds the last vouched-for value; every cut is journaled via
    ``_set_knob``). Never exceeds `default` — the budget may only cut,
    and the index floors the result against k so a cut can narrow the
    funnel but never starve top-k."""
    p = _plane
    if p is None:
        return default
    return min(int(p._read(KNOB_FUNNEL_C, default)), int(default))


def funnel_rescore_cap(default: int) -> int:
    """Cap on the 4-bit funnel's stage-3 exact-rescore depth c
    (index/gpu.py ``_funnel_budgets``) — the fourth recall-guarded
    budget, same FR_BUCKETS ladder discipline as ``funnel_c_cap``.
    Never exceeds `default`."""
    p = _plane
    if p is None:
        return default
    return min(int(p._read(KNOB_FUNNEL_RESCORE, default)), int(default))


def take_rate_token(tenant: Optional[str]) -> Optional[float]:
    """Tenant rate-quota gate (coalescer admission). -> None when
    admitted (or the quota is off), else the Retry-After hint in
    seconds: the time until the tenant's next token accrues."""
    p = _plane
    if p is None:
        return None
    return p.take_rate_token(tenant)
