# The port's copy of weaviate_tpu/monitoring/memory.py, its imports pointed at the port.
"""Memory & capacity observability: the device/host/disk byte ledger.

Every ROADMAP scale item (the mesh promotion, the clustered 10M-100M
layouts, multi-tier quantization) is gated by one resource the
observability plane could not see: **bytes**. An HBM OOM on a chip
session surfaces as an opaque rc=3, and the host side holds several
unaccounted caches (the breaker's fallback rows, the auditor's rows
cache, the shard allowList cache, COW transients). This module is the
capacity twin of the perf window (monitoring/perf.py) and the quality
auditor (monitoring/quality.py): a continuous, always-on accounting of
what the process holds, how fast that grows under ingest, and when it
runs out.

How it works:

- **device ledger**: every index mutation that lands device buffers
  stamps its component byte sizes ANALYTICALLY (shapes x dtypes — zero
  device syncs; the stamped values equal the buffers' ``nbytes``
  exactly) at ``IndexSnapshot`` publish (index/gpu.py) and at every mesh
  slab mutation (index/mesh.py, per-device via ``ndev``). Search
  dispatches never touch the ledger — the hot path is untouched
  (spy-pinned in tests/test_memory_ledger.py);
- **host ledger**: host consumers register pull providers (the breaker's
  ``_host_rows_cache``, the auditor rows cache, ``Shard._allow_cache``,
  the slot_to_doc/host-tombstone mirrors, staged pending rows) that are
  polled on write-path stamps (throttled) and on demand — the SAME
  sizing helpers back ``/debug/index``, so the two surfaces can never
  disagree;
- **write-path lifecycle**: flush/device-write/tombstone/compress/
  compact phase timings with rows and bytes moved, COW copy bytes and
  per-flush transient peaks, staged-generation publish lag, and
  write-shape ``jit_first_seen`` facts;
- **forecast**: an ingest-rate EWMA per scope (device/host/disk) yields
  a time-to-exhaustion estimate against the scope's byte budget
  (the card's total from ``torch.cuda.mem_get_info`` where there is a
  card, /proc/meminfo for the host, the data volume for disk), with
  quality-style fire-once degradation alerts at a configurable headroom
  threshold;
- **drift**: on the card, the ledger's analytic total is cross-checked
  against the caching allocator's ``allocated_bytes.all.current``
  (``torch.cuda.memory_stats``; its peak is reported beside it) — a
  drift gauge, never trusted
  as primary, and only read at summary time (off every hot path).

Exposure: ``GET /debug/memory`` (same authorizer as pprof/perf/quality),
bounded-cardinality gauges (``weaviate_device_bytes{component}``,
``weaviate_host_bytes{component}``, ``weaviate_disk_bytes{component}``,
``weaviate_memory_headroom_pct{scope}``, ``weaviate_write_flush_ms``,
``weaviate_cow_copy_bytes_total``), and the ``memory`` blocks on
bench.py serving/e2e rows. See docs/memory.md.

Lifecycle mirrors the tracer/perf/quality planes: a process-wide module
global installed by App (``MEMORY_LEDGER_ENABLED``, default on) and
cleared on shutdown; unconfigured (bare-index tests, embedded use) every
stamping entry point is a one-comparison no-op.
"""

from __future__ import annotations

import logging
import shutil
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional

# one nearest-rank percentile across the monitoring plane: perf/quality/
# memory surfaces must report identical p50/p99 semantics
from weaviate_tpu_torch.monitoring.perf import _pct

_LOG = logging.getLogger(__name__)

# bounded component taxonomies — these tuples ARE the gauge label sets
# (the JGL010 discipline: a foreign component name folds into "other",
# never mints a new series)
DEVICE_COMPONENTS = ("store", "sq_norms", "tombs", "slot_to_doc",
                     "pq_codes", "recon_norms", "rescore_store",
                     "rescore_sq_norms", "allow_words",
                     # the IVF scan plane's slabs (index/tpu.py +
                     # ops/ivf.py): k-means centroids, padded partition
                     # buckets, PCA projection + per-slot low-dim rows
                     "ivf_centroids", "ivf_buckets", "ivf_pca_proj",
                     "ivf_pca_rows",
                     # the 4-bit Quick-ADC ladder (index/tpu.py +
                     # ops/pq4.py): packed two-codes-per-byte slab, its
                     # reconstruction norms, and the shared OPQ rotation
                     "pq4_codes", "pq4_norms", "opq_rot")
HOST_COMPONENTS = ("slot_to_doc", "host_tombs", "host_vecs",
                   "pending_rows", "breaker_rows", "auditor_rows",
                   "allow_cache", "stage_buffers",
                   # the IVF plane's host twins: centroid matrix + PCA
                   # basis (write-path assignment) + per-slot partition
                   # assignment mirror
                   "ivf_host")
DISK_COMPONENTS = ("used", "free", "incident_bundles")
OTHER = "other"
SCOPES = ("device", "host", "disk")

# write-path lifecycle phases (display order in /debug/memory)
WRITE_PHASES = ("flush", "device_write", "apply_tombstones", "compress",
                "compact")

# seconds between degradation log lines per scope (the counter always
# increments once per transition; the log is what gets rate-limited)
ALERT_LOG_INTERVAL_S = 60.0

# min seconds between host-provider / disk refreshes driven by write-path
# stamps (summary() always refreshes)
_REFRESH_MIN_S = 0.5

# per-phase sample cap on top of the time-horizon eviction (perf.py idiom)
_WRITE_SAMPLES_MAX = 8192
# distinct write shapes tracked for jit_first_seen (a runaway shape
# generator must not grow the dict unboundedly)
_SHAPES_MAX = 128


def _card():
    """The card the port's allocator stats are read from: the port's
    default device when it is a CUDA device torch can see, else None (the
    CPU has no allocator stats: the "no stats" answer)."""
    import torch

    from weaviate_tpu_torch.device import DEFAULT_DEVICE

    dev = torch.device(DEFAULT_DEVICE)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def array_bytes(arr) -> int:
    """Analytic byte size of a (device or host) array: shape x itemsize.
    Never touches device data — the zero-sync contract — and equals the
    array's ``nbytes`` exactly (both are metadata products)."""
    if arr is None:
        return 0
    n = 1
    for s in arr.shape:
        n *= int(s)
    return n * arr.dtype.itemsize


# -- sizing helpers shared with /debug/index ----------------------------------
# These functions are the ONE place cache byte sizes are computed: the
# ledger's host providers call them AND Shard.debug_health()/
# TpuVectorIndex.health() call them, so /debug/memory and /debug/index can
# never disagree on what a cache weighs.


def bitmap_bytes(bm) -> int:
    """HOST byte size of one allowList Bitmap (its sorted-ids array).
    The packed device filter words a hot bitmap may also cache
    (``_words_cache``) are DEVICE bytes and accounted separately —
    see allow_words_device_bytes()."""
    ids = getattr(bm, "_ids", None)
    return int(ids.nbytes) if ids is not None else 0


def allow_words_device_bytes(shard) -> int:
    """DEVICE bytes pinned by the packed filter words cached on the
    bitmaps a shard's allowList cache holds (index _allow_words caches
    one [capacity/32] u32 device array per hot filter). Analytic —
    shape metadata only, zero syncs."""
    try:
        entries = list(getattr(shard, "_allow_cache", {}).values())
    except RuntimeError:
        return 0
    total = 0
    for entry in entries:
        try:
            wc = getattr(entry[1], "_words_cache", None)
            if wc is not None:
                total += array_bytes(wc[1])
        except (TypeError, IndexError, AttributeError):
            pass
    return total


def shard_device_components(shard) -> dict:
    b = allow_words_device_bytes(shard)
    return {"allow_words": b} if b else {}


def allow_cache_bytes(shard) -> int:
    """Total bytes held by a shard's allowList cache (racy snapshot —
    introspection, not an invariant)."""
    try:
        entries = list(getattr(shard, "_allow_cache", {}).values())
    except RuntimeError:  # resized mid-iteration by a concurrent reader
        return 0
    total = 0
    for entry in entries:
        try:
            total += bitmap_bytes(entry[1])
        except (TypeError, IndexError):
            pass
    return total


def host_rows_cache_bytes(vidx) -> int:
    """Bytes pinned by the breaker's host-fallback rows cache (0 when not
    resident). Under PQ the rows tuple may hold a VIEW of host_vecs — the
    view's nbytes still reports what the degraded plane reads; host_vecs
    itself is accounted as its own component."""
    cache = getattr(vidx, "_host_rows_cache", None)
    if cache is None:
        return 0
    try:
        return int(cache[1].nbytes) + int(cache[2].nbytes)
    except (TypeError, IndexError, AttributeError):
        return 0


def auditor_rows_bytes(auditor, vidx=None) -> int:
    """Bytes held by the quality auditor's per-index host-rows cache;
    restricted to one index when ``vidx`` is given (the /debug/index
    per-shard view). Racy snapshot, never takes the auditor's lock."""
    if auditor is None:
        return 0
    try:
        items = list(getattr(auditor, "_rows_cache", {}).items())
    except RuntimeError:
        return 0
    total = 0
    for key, entry in items:
        if vidx is not None and key != id(vidx):
            continue
        try:
            total += int(entry[1].nbytes) + int(entry[2].nbytes)
        except (TypeError, IndexError, AttributeError):
            pass
    return total


def index_host_components(vidx) -> dict:
    """Host-side components of one vector index (single-chip or mesh):
    the slot->doc / tombstone mirrors, the PQ host rows, staged pending
    rows, and the breaker's fallback cache."""
    out: dict = {}
    for name, attr in (("slot_to_doc", "_slot_to_doc"),
                       ("host_tombs", "_host_tombs"),
                       ("host_vecs", "_host_vecs")):
        arr = getattr(vidx, attr, None)
        if arr is not None:
            b = int(arr.nbytes)
            if b:
                out[name] = b
    pending = getattr(vidx, "_pending", None)
    dim = getattr(vidx, "dim", None)
    if pending and dim:
        out["pending_rows"] = len(pending) * int(dim) * 4
    hr = host_rows_cache_bytes(vidx)
    if hr:
        out["breaker_rows"] = hr
    # IVF host twins (index/tpu.py): the centroid matrix + PCA basis the
    # write path assigns against, and the per-slot assignment mirror —
    # tens of MB at scale, and the ledger must see them like every
    # other host mirror
    ivf = 0
    for attr in ("_ivf_centroids_host", "_ivf_pca_host", "_ivf_assign"):
        arr = getattr(vidx, attr, None)
        if arr is not None:
            ivf += int(arr.nbytes)
    if ivf:
        out["ivf_host"] = ivf
    # parked query-staging buffers (the fused-dispatch enqueue pool):
    # racy len-free iteration over a dict-of-lists snapshot — sizes only
    stage = getattr(vidx, "_stage_free", None)
    if stage:
        b = 0
        for bufs in list(stage.values()):
            b += sum(int(x.nbytes) for x in list(bufs))
        if b:
            out["stage_buffers"] = b
    return out


def shard_host_components(shard) -> dict:
    b = allow_cache_bytes(shard)
    return {"allow_cache": b} if b else {}


def auditor_host_components(auditor) -> dict:
    b = auditor_rows_bytes(auditor)
    return {"auditor_rows": b} if b else {}


# -- the provider registries (module-level, ledger-independent) ---------------
# Registration happens at object construction (index/shard/auditor), which
# may precede the ledger's configure (or outlive it across App restarts) —
# so the registries live at module scope and the live ledger reads them.
# Host providers cover host-RAM consumers; device providers cover the few
# DEVICE allocations that live outside snapshot stamping (the packed
# filter words cached on hot allowList bitmaps).

_providers_lock = threading.Lock()
_host_providers: dict = {}    # id(owner) -> (weakref.ref(owner), fn)
_device_providers: dict = {}  # id(owner) -> (weakref.ref(owner), fn)
_disk_providers: dict = {}    # id(owner) -> (weakref.ref(owner), fn)


def _register(registry: dict, owner, fn: Callable) -> None:
    ref = weakref.ref(owner)
    with _providers_lock:
        dead = [k for k, (r, _) in registry.items() if r() is None]
        for k in dead:
            registry.pop(k, None)
        registry[id(owner)] = (ref, fn)


def _poll(registry: dict) -> dict:
    """Poll every live provider -> summed {component: bytes}. Provider
    errors are swallowed (introspection must never break serving)."""
    with _providers_lock:
        items = list(registry.items())
    out: dict = {}
    dead = []
    for key, (ref, fn) in items:
        owner = ref()
        if owner is None:
            dead.append(key)
            continue
        try:
            comps = fn(owner)
        except Exception:  # noqa: BLE001 — a broken provider must not 500
            continue
        for name, b in comps.items():
            if b:
                out[name] = out.get(name, 0) + int(b)
    if dead:
        with _providers_lock:
            for k in dead:
                # re-check under the lock: a recycled id(owner) may have
                # been re-registered by a new live object since we
                # observed the dead weakref (TOCTOU) — never unregister
                # a live provider
                entry = registry.get(k)
                if entry is not None and entry[0]() is None:
                    registry.pop(k, None)
    return out


def register_host_provider(owner, fn: Callable) -> None:
    """Register ``fn(owner) -> {component: bytes}`` as a host-memory
    consumer. The owner is held by weakref only; dead entries prune on
    the next registration or poll."""
    _register(_host_providers, owner, fn)


def register_device_provider(owner, fn: Callable) -> None:
    """Register a DEVICE-memory provider for allocations that live
    outside the snapshot stamping flow (e.g. per-bitmap filter words)."""
    _register(_device_providers, owner, fn)


def register_disk_provider(owner, fn: Callable) -> None:
    """Register a DISK consumer whose bytes should appear as their own
    component beside used/free (the incident flight recorder's bundle
    directory — monitoring/incidents.py). Components are informational
    sub-accounts of ``used``; the scope's budget stays the volume total."""
    _register(_disk_providers, owner, fn)


def host_components() -> dict:
    return _poll(_host_providers)


def device_provider_components() -> dict:
    return _poll(_device_providers)


# -- ingest-rate EWMA ---------------------------------------------------------


class _Rate:
    """EWMA growth rate (bytes/s) of one scope's accounted total. Fed on
    every refresh; negative deltas (compaction, cache release) pull the
    estimate down the same way growth pulls it up."""

    __slots__ = ("alpha", "bps", "_last_total", "_last_t")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.bps: Optional[float] = None
        self._last_total: Optional[int] = None
        self._last_t = 0.0

    def update(self, total: int, now: float) -> None:
        if self._last_total is None:
            self._last_total, self._last_t = total, now
            return
        dt = now - self._last_t
        if dt <= 1e-6:
            # same instant: keep the OLD anchor so this growth folds into
            # the next measurable delta instead of being dropped
            return
        inst = (total - self._last_total) / dt
        self.bps = inst if self.bps is None else (
            self.alpha * inst + (1.0 - self.alpha) * self.bps)
        self._last_total, self._last_t = total, now


# -- the ledger ---------------------------------------------------------------


class MemoryLedger:
    """The process-wide byte ledger. ``stamp_device`` is the write-path
    entry (one lock, a small dict — analytic, zero syncs); ``summary()``
    is the on-demand /debug/memory body; host/disk totals refresh pulled
    and throttled. Alerts are per-scope fire-once transitions (the
    quality-auditor idiom)."""

    def __init__(self, metrics=None, window_s: float = 300.0,
                 headroom_alert_pct: float = 10.0,
                 device_budget_bytes: int = 0,
                 host_budget_bytes: int = 0):
        self.metrics = metrics
        self.window_s = max(float(window_s), 1e-3)
        self.headroom_alert_pct = float(headroom_alert_pct)
        self.device_budget_bytes = int(device_budget_bytes)
        self.host_budget_bytes = int(host_budget_bytes)
        self._lock = threading.Lock()
        # id(owner) -> (weakref, {component: bytes}, ndev)
        self._device: dict = {}
        self._rates = {s: _Rate() for s in SCOPES}
        self._alert_state = {s: False for s in SCOPES}
        self._alert_last_log: dict = {}
        self._alerts_fired = {s: 0 for s in SCOPES}
        # write-path lifecycle window: phase -> deque[(t, ms, rows, bytes)]
        self._write: dict = {p: deque(maxlen=_WRITE_SAMPLES_MAX)
                             for p in WRITE_PHASES}
        self._publish_lag: deque = deque(maxlen=_WRITE_SAMPLES_MAX)
        self._shapes: dict = {}  # shape key -> first-seen monotonic
        # lifetime counters (never evicted; clear() keeps them, perf idiom)
        self._rows_written = 0
        self._bytes_written = 0
        self._cow_copy_bytes = 0
        self._cow_peak: deque = deque(maxlen=1024)  # (t, transient bytes)
        self._publishes = 0
        self._stamps = 0
        # cached/refreshed host+disk views (throttled on the stamp path)
        self._host_cache: dict = {}
        self._disk_cache: dict = {}
        self._last_host_refresh = 0.0
        self._last_disk_refresh = 0.0
        self._disk_total = 0
        self._disk_path: Optional[str] = None
        self._auto_device_budget: Optional[int] = None
        self._auto_host_budget: Optional[int] = None

    # -- wiring --------------------------------------------------------------

    def set_disk_path(self, path: str) -> None:
        """The data volume whose usage backs the disk scope."""
        self._disk_path = path

    # -- device stamping (the write-path entry; zero device syncs) -----------

    def stamp_device(self, owner, components: dict, ndev: int = 1) -> None:
        """Replace ``owner``'s device components atomically. Called at
        every IndexSnapshot publish / mesh slab mutation with analytic
        shape x dtype sizes; an empty dict (drop) zeroes the owner out.
        Never called on the search path (spy-pinned)."""
        now = time.monotonic()
        pulled = device_provider_components()
        with self._lock:
            self._prune_device_locked()
            self._device[id(owner)] = (
                weakref.ref(owner), dict(components), max(int(ndev), 1))
            totals, per_dev = self._device_totals_locked(pulled)
            self._rates["device"].update(per_dev, now)
            self._stamps += 1
        self._set_component_gauges("device", totals, DEVICE_COMPONENTS)
        self._eval_scope("device", per_dev, self._device_budget())
        self._maybe_refresh(now)

    def _prune_device_locked(self) -> None:
        dead = [k for k, (r, _, _) in self._device.items() if r() is None]
        for k in dead:
            self._device.pop(k, None)

    def _device_totals_locked(self, pulled: Optional[dict] = None) -> tuple:
        """-> ({component: bytes} with foreign names folded into "other",
        per-device bytes). Per-device assumes mesh slabs spread evenly
        over their ndev chips (they do — _assign_balanced level-fills).
        ``pulled`` merges device-provider components (filter-words
        caches; small, counted at ndev=1)."""
        totals: dict = {}
        per_dev = 0.0
        for _, comps, ndev in self._device.values():
            for name, b in comps.items():
                label = name if name in DEVICE_COMPONENTS else OTHER
                totals[label] = totals.get(label, 0) + int(b)
            per_dev += sum(int(b) for b in comps.values()) / ndev
        for name, b in (pulled or {}).items():
            label = name if name in DEVICE_COMPONENTS else OTHER
            totals[label] = totals.get(label, 0) + int(b)
            per_dev += int(b)
        return totals, int(per_dev)

    def device_components(self) -> dict:
        pulled = device_provider_components()
        with self._lock:
            self._prune_device_locked()
            totals, _ = self._device_totals_locked(pulled)
        return totals

    def device_bytes_total(self) -> int:
        return sum(self.device_components().values())

    # -- host / disk refresh --------------------------------------------------

    def _maybe_refresh(self, now: float) -> None:
        if now - self._last_host_refresh >= _REFRESH_MIN_S:
            self.refresh_host(now)
        if self._disk_path and now - self._last_disk_refresh >= _REFRESH_MIN_S:
            self.refresh_disk(now)

    def refresh_host(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        comps = host_components()
        total = sum(comps.values())
        with self._lock:
            self._host_cache = comps
            self._last_host_refresh = now
            self._rates["host"].update(total, now)
        self._set_component_gauges("host", comps, HOST_COMPONENTS)
        self._eval_scope("host", total, self._host_budget())
        return comps

    def refresh_disk(self, now: Optional[float] = None) -> dict:
        now = time.monotonic() if now is None else now
        path = self._disk_path
        if not path:
            return {}
        try:
            u = shutil.disk_usage(path)
        except OSError:
            return {}
        comps = {"used": int(u.used), "free": int(u.free)}
        # registered disk consumers (the incident-bundle directory): their
        # bytes are a sub-account of `used`, shown as their own component
        comps.update(_poll(_disk_providers))
        with self._lock:
            self._disk_cache = comps
            # one budget basis everywhere: the volume's total as reported
            # here backs BOTH the alert evaluation and summary()'s
            # forecast (used+free can undercount reserved blocks)
            self._disk_total = int(u.total)
            self._last_disk_refresh = now
            self._rates["disk"].update(int(u.used), now)
        self._set_component_gauges("disk", comps, DISK_COMPONENTS)
        self._eval_scope("disk", int(u.used), int(u.total))
        return comps

    def host_totals(self, refresh: bool = True) -> dict:
        if refresh:
            return self.refresh_host()
        with self._lock:
            return dict(self._host_cache)

    # -- budgets --------------------------------------------------------------

    def _device_budget(self) -> int:
        """Per-device HBM budget: the config override, else the backend's
        total memory (``torch.cuda.mem_get_info``), else 0 =
        unknown (no headroom/forecast for the scope). Detected once,
        lazily — never on a dispatch path."""
        if self.device_budget_bytes:
            return self.device_budget_bytes
        if self._auto_device_budget is None:
            budget = 0
            try:
                dev = _card()
                if dev is not None:
                    import torch

                    budget = int(torch.cuda.mem_get_info(dev)[1])
            except Exception:  # noqa: BLE001 — absent backend support
                budget = 0
            self._auto_device_budget = budget
        return self._auto_device_budget

    def _host_budget(self) -> int:
        if self.host_budget_bytes:
            return self.host_budget_bytes
        if self._auto_host_budget is None:
            budget = 0
            try:
                with open("/proc/meminfo") as f:
                    for line in f:
                        if line.startswith("MemTotal:"):
                            budget = int(line.split()[1]) * 1024
                            break
            except OSError:
                budget = 0
            self._auto_host_budget = budget
        return self._auto_host_budget

    # -- headroom + fire-once alerts ------------------------------------------

    def _eval_scope(self, scope: str, used: int, budget: int) -> None:
        if budget <= 0:
            return
        headroom_pct = max(100.0 * (budget - used) / budget, 0.0)
        m = self.metrics
        if m is not None:
            try:
                m.memory_headroom.labels(scope).set(round(headroom_pct, 2))
            except Exception:  # noqa: BLE001 — metrics must not break writes
                pass
        degraded = headroom_pct < self.headroom_alert_pct
        with self._lock:
            transitioned = self._alert_state[scope] != degraded
            self._alert_state[scope] = degraded
            if degraded and transitioned:
                self._alerts_fired[scope] += 1
        if degraded:
            if transitioned and m is not None:
                try:
                    m.memory_alerts.labels(scope).inc()
                except Exception:  # noqa: BLE001
                    pass
            if transitioned:
                # the exhaustion transition is an ops-journal event AND an
                # incident trigger (monitoring/incidents.py): the bundle
                # preserves the byte ledger + forecast around the alert —
                # the post-mortem an HBM-OOM rc=3 never left behind. Lazy
                # import; one-comparison no-ops when the plane is off.
                try:
                    from weaviate_tpu_torch.monitoring import incidents

                    incidents.emit("memory_alert", scope=scope,
                                   used_bytes=int(used),
                                   budget_bytes=int(budget),
                                   headroom_pct=round(headroom_pct, 2))
                    incidents.trigger(
                        "memory_exhaustion",
                        reason=f"memory headroom degraded: scope={scope} "
                               f"headroom={headroom_pct:.1f}% < "
                               f"{self.headroom_alert_pct:.1f}%",
                        detail={"scope": scope, "used_bytes": int(used),
                                "budget_bytes": int(budget)})
                except Exception:  # noqa: BLE001 — must not break the write path
                    pass
            now = time.monotonic()
            last = self._alert_last_log.get(scope)
            if transitioned or last is None \
                    or now - last >= ALERT_LOG_INTERVAL_S:
                self._alert_last_log[scope] = now
                fc = self.forecast_scope(scope, used, budget)
                tte = fc.get("tte_s")
                _LOG.warning(
                    "memory headroom degraded: scope=%s used=%d budget=%d "
                    "headroom=%.1f%% (< %.1f%%)%s — counted in "
                    "weaviate_memory_exhaustion_alerts_total; further "
                    "lines rate-limited to one per %.0fs",
                    scope, used, budget, headroom_pct,
                    self.headroom_alert_pct,
                    f", est. exhaustion in {tte:.0f}s" if tte else "",
                    ALERT_LOG_INTERVAL_S)
        elif transitioned:
            _LOG.info("memory headroom recovered: scope=%s headroom=%.1f%%",
                      scope, headroom_pct)
            try:
                from weaviate_tpu_torch.monitoring import incidents

                incidents.emit("memory_recovered", scope=scope,
                               headroom_pct=round(headroom_pct, 2))
            except Exception:  # noqa: BLE001 — must not break the write path
                pass

    def forecast_scope(self, scope: str, used: int, budget: int) -> dict:
        """One scope's forecast: headroom, ingest-rate EWMA, and the
        time-to-exhaustion estimate (None when not growing or unbudgeted)."""
        with self._lock:
            rate = self._rates[scope].bps
            alert = self._alert_state[scope]
            fired = self._alerts_fired[scope]
        out: dict = {
            "used_bytes": int(used),
            "budget_bytes": int(budget),
            "headroom_pct": round(max(100.0 * (budget - used) / budget, 0.0), 2)
            if budget > 0 else None,
            "ingest_bps": round(rate, 1) if rate is not None else None,
            "tte_s": None,
            "alert": alert,
            "alerts_fired": fired,
        }
        if budget > used and rate is not None and rate > 1e-9:
            out["tte_s"] = round((budget - used) / rate, 1)
        return out

    # -- write-path lifecycle -------------------------------------------------

    def note_write(self, op: str, phase: str, ms: float, rows: int = 0,
                   bytes_moved: int = 0) -> None:
        """One write-path phase completion (flush, device_write,
        apply_tombstones, compress, compact) with its rows/bytes moved."""
        now = time.monotonic()
        with self._lock:
            d = self._write.get(phase)
            if d is None:
                d = self._write[phase] = deque(maxlen=_WRITE_SAMPLES_MAX)
            d.append((now, float(ms), int(rows), int(bytes_moved)))
            self._rows_written += int(rows)
            self._bytes_written += int(bytes_moved)
        m = self.metrics
        if m is not None and phase in ("flush", "device_write"):
            try:
                m.write_flush.observe(float(ms))
            except Exception:  # noqa: BLE001
                pass

    def note_cow(self, copied_bytes: int, transient_peak: int = 0) -> None:
        """COW accounting: ``copied_bytes`` counts host arrays duplicated
        for a pinned snapshot; ``transient_peak`` records the device-side
        extra bytes a non-donating write holds while old and new buffer
        generations are both alive."""
        now = time.monotonic()
        with self._lock:
            if copied_bytes:
                self._cow_copy_bytes += int(copied_bytes)
            if transient_peak:
                self._cow_peak.append((now, int(transient_peak)))
        m = self.metrics
        if m is not None and copied_bytes:
            try:
                m.cow_copy_bytes.inc(int(copied_bytes))
            except Exception:  # noqa: BLE001
                pass

    def note_publish(self, staged_lag_ms: float) -> None:
        """Snapshot publication: how long the oldest staged (unpublished)
        mutation waited — the read-your-writes flush debt."""
        now = time.monotonic()
        with self._lock:
            self._publish_lag.append((now, float(staged_lag_ms)))
            self._publishes += 1

    def note_write_shape(self, key: tuple) -> None:
        """First sighting of a write-kernel shape (a compile proxy — the
        write-path twin of the trace plane's jit_shape_first_seen)."""
        with self._lock:
            if key in self._shapes or len(self._shapes) >= _SHAPES_MAX:
                return
            self._shapes[key] = time.monotonic()

    # -- gauges ---------------------------------------------------------------

    def _set_component_gauges(self, scope: str, totals: dict,
                              taxonomy: tuple) -> None:
        m = self.metrics
        if m is None:
            return
        vec = {"device": getattr(m, "device_bytes", None),
               "host": getattr(m, "host_bytes", None),
               "disk": getattr(m, "disk_bytes", None)}.get(scope)
        if vec is None:
            return
        try:
            # the full taxonomy is always written so a component that
            # vanished (compress dropped the float store) reads 0, never
            # its stale last value
            for name in taxonomy + (OTHER,):
                vec.labels(name).set(totals.get(name, 0))
        except Exception:  # noqa: BLE001 — metrics must not break writes
            pass

    # -- introspection --------------------------------------------------------

    def _write_window_locked(self, now: float) -> dict:
        horizon = now - self.window_s
        phases: dict = {}
        for name in WRITE_PHASES:
            d = self._write.get(name)
            if not d:
                continue
            vals = [(ms, rows, b) for t, ms, rows, b in d if t >= horizon]
            if not vals:
                continue
            svals = sorted(v[0] for v in vals)
            phases[name] = {
                "samples": len(svals),
                "p50_ms": round(_pct(svals, 50.0), 3),
                "p99_ms": round(_pct(svals, 99.0), 3),
                "rows": sum(v[1] for v in vals),
                "bytes": sum(v[2] for v in vals),
            }
        lags = sorted(ms for t, ms in self._publish_lag if t >= horizon)
        peaks = [b for t, b in self._cow_peak if t >= horizon]
        out = {
            "phases": phases,
            "rows_written_total": self._rows_written,
            "bytes_written_total": self._bytes_written,
            "cow_copy_bytes_total": self._cow_copy_bytes,
            "cow_transient_peak_bytes": max(peaks) if peaks else 0,
            "publishes_total": self._publishes,
        }
        if lags:
            out["staged_publish_lag_ms"] = {
                "p50": round(_pct(lags, 50.0), 3),
                "p99": round(_pct(lags, 99.0), 3),
            }
        return out

    def _device_stats_drift(self) -> Optional[dict]:
        """Allocator cross-check where the backend provides it: the drift
        between what the ledger accounts and what the device allocator
        reports in use (includes the allocator's workspace and scratch the
        analytic ledger deliberately does not model — a gauge to watch,
        never the primary). Summary-time only."""
        try:
            dev = _card()
            if dev is None:
                return None
            import torch

            stats = torch.cuda.memory_stats(dev)
        except Exception:  # noqa: BLE001 — absent backend support
            return None
        if not stats or "allocated_bytes.all.current" not in stats:
            return None
        in_use = int(stats["allocated_bytes.all.current"])
        peak = int(stats.get("allocated_bytes.all.peak", in_use))
        pulled = device_provider_components()
        with self._lock:
            _, per_dev = self._device_totals_locked(pulled)
        drift = in_use - per_dev
        m = self.metrics
        if m is not None:
            try:
                m.memory_drift.labels("device").set(drift)
            except Exception:  # noqa: BLE001
                pass
        return {"allocator_bytes_in_use": in_use,
                "allocator_bytes_peak": peak,
                "ledger_per_device_bytes": per_dev,
                "drift_bytes": drift}

    def summary(self) -> dict:
        """The /debug/memory body: device/host/disk component tables +
        budgets + headroom, the write-lifecycle window, the per-scope
        exhaustion forecast, write-shape first-seen facts, and the
        allocator drift cross-check."""
        now = time.monotonic()
        host = self.refresh_host(now)
        disk = self.refresh_disk(now)
        pulled = device_provider_components()
        with self._lock:
            self._prune_device_locked()
            dev_totals, per_dev = self._device_totals_locked(pulled)
            write = self._write_window_locked(now)
            shapes = sorted(
                ((now - t, key) for key, t in self._shapes.items()))
            stamps = self._stamps
        dev_budget = self._device_budget()
        host_budget = self._host_budget()
        disk_total = self._disk_total  # same basis the alert evaluated
        out: dict = {
            "window_s": self.window_s,
            "headroom_alert_pct": self.headroom_alert_pct,
            "stamps": stamps,
            "device": {
                "components": dict(sorted(dev_totals.items(),
                                          key=lambda kv: -kv[1])),
                "total_bytes": sum(dev_totals.values()),
                "per_device_bytes": per_dev,
                "budget_bytes": dev_budget or None,
            },
            "host": {
                "components": dict(sorted(host.items(),
                                          key=lambda kv: -kv[1])),
                "total_bytes": sum(host.values()),
                "budget_bytes": host_budget or None,
            },
            "disk": {
                "components": disk,
                "path": self._disk_path,
                "total_bytes": disk_total or None,
            },
            "write": write,
            "forecast": {
                "device": self.forecast_scope("device", per_dev, dev_budget),
                "host": self.forecast_scope("host", sum(host.values()),
                                            host_budget),
                "disk": self.forecast_scope("disk", disk.get("used", 0),
                                            disk_total),
            },
            "jit_first_seen": [
                {"shape": list(key), "age_s": round(age, 1)}
                for age, key in shapes[:32]],
        }
        drift = self._device_stats_drift()
        if drift is not None:
            out["device"]["allocator"] = drift
        return out

    def bench_block(self) -> dict:
        """The compact ``memory`` block bench rows carry."""
        doc = self.summary()
        fc = doc["forecast"]
        return {
            "device_bytes": doc["device"]["total_bytes"],
            "device_components": doc["device"]["components"],
            "host_bytes": doc["host"]["total_bytes"],
            "headroom_pct": {s: fc[s].get("headroom_pct") for s in SCOPES},
            "ingest_bps": {s: fc[s].get("ingest_bps") for s in SCOPES},
            "tte_s": {s: fc[s].get("tte_s") for s in SCOPES},
            "cow_copy_bytes": doc["write"]["cow_copy_bytes_total"],
            "rows_written": doc["write"]["rows_written_total"],
        }

    def clear(self) -> None:
        """Reset the rolling write window, rates, and alert states (bench
        measurement slices). Current device/host component state is live
        state, not window state — it survives, as do lifetime counters."""
        with self._lock:
            for d in self._write.values():
                d.clear()
            self._publish_lag.clear()
            self._cow_peak.clear()
            self._shapes.clear()
            self._rates = {s: _Rate() for s in SCOPES}
            self._alert_state = {s: False for s in SCOPES}
            self._alert_last_log.clear()


# -- module state + zero-hop accessors ----------------------------------------

_ledger: Optional[MemoryLedger] = None

# final summaries of recently-unconfigured ledgers (CI failure artifact:
# tests/conftest.py dumps these to debug_memory.json beside the perf and
# quality stashes). Guarded by its own lock — concurrent App teardowns
# share it (the perf.py pattern).
_final_summaries: deque = deque(maxlen=8)
_summaries_lock = threading.Lock()


def configure(ledger: Optional[MemoryLedger]) -> Optional[MemoryLedger]:
    """Install (or clear, with None) the process-wide memory ledger."""
    global _ledger
    _ledger = ledger
    return ledger


def unconfigure(ledger: MemoryLedger) -> None:
    """Clear the global only if it is still `ledger` (App shutdown must
    not tear down a newer App's ledger); stash its final summary for the
    CI artifact dump when it saw any activity."""
    global _ledger
    try:
        if ledger._stamps > 0 or ledger._rows_written > 0:
            doc = ledger.summary()
            with _summaries_lock:
                _final_summaries.append(doc)
    except Exception:  # noqa: BLE001 — teardown must never fail shutdown
        pass
    if _ledger is ledger:
        _ledger = None


def get_ledger() -> Optional[MemoryLedger]:
    return _ledger


def recent_summaries() -> list:
    """Final summaries of ledgers torn down this process (newest last),
    plus the live ledger's current summary when one is installed."""
    with _summaries_lock:
        out = list(_final_summaries)
    led = _ledger
    if led is not None:
        try:
            out.append(led.summary())
        except Exception:  # noqa: BLE001
            pass
    return out
