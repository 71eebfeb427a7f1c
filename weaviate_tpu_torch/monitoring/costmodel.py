# The port's copy of weaviate_tpu/monitoring/costmodel.py, its imports pointed at the port.
"""Analytic device cost model: FLOPs/bytes per dispatch vs platform peaks.

One roofline model shared by every consumer — bench.py's offline matrix
rows, the serving path's per-dispatch attribution (monitoring/tracing.py
DispatchRecord facts), the rolling perf window behind ``/debug/perf``
(monitoring/perf.py), and the BM25 device engine's batch-shape recording
(inverted/bm25_device.py). Before this module the model lived only in
bench.py (``PEAKS``/``_roofline``) plus an ad-hoc stats dict in the BM25
engine, so the serving path could not say where a dispatch sat against the
hardware; now bench and serving compute the same numbers from the same
formulas.

Conventions (inherited from the bench model, kept deliberately):

- FLOPs are the *useful* distance math — ``2 · B · N · D`` per scan batch
  (the matmul at the heart of every tier) — not implementation FLOPs, so
  MFU is comparable across tiers (PQ's reconstruction-as-matmul does more
  hardware FLOPs to serve the same distance work).
- Bytes are the store bytes actually read from HBM per batch (queries,
  LUTs, and top-k buffers are noise at these shapes): ``N · bytes_per_row``
  with bytes_per_row = 4·D for the f32 store, 2·D for the bf16 rescore
  copy, M (segments) for codes-only PQ.
- Arithmetic intensity is therefore ``2·B / bytes_per_elem``: the batch
  width decides the regime, which is why batch-first serving (the
  coalescer) is the design lever.

Peaks are the public H100 SXM5 datasheet figures; the CPU entry is a *nominal*
single-socket estimate so cpu-backend rows carry the same fields — cpu
mfu_pct is a proxy, not a claim. The module imports only the stdlib
(device detection imports torch lazily and caches), so index/db/serving
layers can import it without cycles or backend init.
"""

from __future__ import annotations

import os
from typing import Optional

# -- platform peaks -----------------------------------------------------------

PEAKS = {
    # NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 1,979 bf16
    # TFLOP/s is the figure WITH sparsity, so the dense peak is half of
    # it; 3.35 TB/s of HBM3
    "h100": {"tflops": 989.0, "hbm_gbs": 3350.0,
             "note": ("H100 SXM5 datasheet peaks: 989 bf16 TFLOP/s dense "
                      "(1,979 with sparsity), 3.35 TB/s HBM3")},
    "cpu": {"tflops": 0.096 * (os.cpu_count() or 1), "hbm_gbs": 25.0,
            "note": (f"nominal CPU peaks ({os.cpu_count() or 1} core(s) x "
                     "96 GFLOP/s AVX2+FMA, 25 GB/s DRAM) — proxy only")},
}

# device -> PEAKS key (None: a card with no datasheet entry), detected
# once per device
_detected_backend: dict[str, Optional[str]] = {}

# the datasheet part PEAKS["h100"] quotes: the SXM5 card, whose device
# name is "NVIDIA H100 80GB HBM3" (the PCIe and NVL cards have lower peaks)
_H100_SXM5_NAME = "H100 80GB HBM3"


def backend_for_device_name(name: str) -> Optional[str]:
    """torch.cuda.get_device_name() -> PEAKS key, None for a card with no
    datasheet entry: the roofline must not quote another card's peaks."""
    return "h100" if _H100_SXM5_NAME in name else None


def detect_backend(device=None) -> Optional[str]:
    """PEAKS key for the device the caller runs on (None: the port's
    default device, the card), cached per device. "cpu" only when that
    device is the CPU; a card is named by torch.cuda.get_device_name(),
    and one without a datasheet entry gets None (no roofline is
    computed for it)."""
    import torch  # noqa: PLC0415 — lazy: stdlib-only module import

    from weaviate_tpu_torch.device import DEFAULT_DEVICE  # noqa: PLC0415

    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    key = str(dev)
    if key not in _detected_backend:
        _detected_backend[key] = ("cpu" if dev.type == "cpu"
                                  else backend_for_device_name(torch.cuda.get_device_name(dev)))
    return _detected_backend[key]


# -- dispatch tiers -----------------------------------------------------------

# the serving read tiers of index/gpu.py _dispatch_search, plus the BM25
# device engine's batched matmul — the `tier` fact on dispatch traces and
# the top-tier tally in /debug/perf
TIER_EXACT = "exact_scan"            # full f32 (or bf16-store) scan
TIER_PQ_RESCORE = "pq_rescore_bf16"  # PQ with rescore: scans the bf16 copy
TIER_PQ_CODES = "pq_codes"           # codes-only ADC (gmin / recon / LUT)
TIER_PQ_ADC4 = "pq_adc4"             # 4-bit funnel: nibble scan + re-rank
TIER_GATHER = "gather"               # small-allowList gathered row scoring
TIER_BM25_MATMUL = "bm25_matmul"     # dense-row keyword batch matmul


class DispatchShape:
    """The analytic shape of ONE device dispatch, plus the host-overhead
    ledger timings the index stamps while executing it.

    Built on the serving path ONLY while the tracer is up (index/gpu.py
    gates construction on ``tracing.get_tracer()``), so the disabled
    serving path constructs zero of these — the same contract as spans.

    Analytic fields (set at construction):
      tier           one of the TIER_* constants
      n              rows the dispatch scans (live rows; the allowList size
                     on the gather tier; n_pad on the BM25 matmul; on an
                     IVF partition-pruned dispatch the PROBED rows —
                     top_p x bucket capacity, plus the nlist centroid
                     rows — so flops()/bytes() are probed-aware and the
                     roofline never reports the phantom work of the rows
                     the probe skipped; ``extra`` then carries
                     {"ivf": True, "probed_fraction": probed/N})
      dim            vector dims (effective units for BM25)
      batch          ACTUAL query rows (useful work — padding is reported
                     separately, never smeared; the PR-3 convention)
      batch_padded   device dispatch width after bucket padding
      bytes_per_row  HBM bytes read per scanned row
      k              selection depth

    Ledger fields (stamped by the index/shard while the dispatch runs;
    ms, -1 = not measured):
      enqueue_ms     host time building + enqueueing the device work
                     (query prep, allowList pack, host gather)
      device_ms      the ONE blocking device->host fetch (finalize)
      finalize_ms    whole finalize() wall — device_ms + the host hop
      filter_ms      allowList build (shard, filtered dispatches)
      hydrate_ms     LSM result hydration (shard)
    and the monotonic interval [t_start, t_end] from enqueue start to
    fetch end — the in-flight-device interval the duty cycle integrates.
    """

    __slots__ = ("tier", "n", "dim", "batch", "batch_padded",
                 "bytes_per_row", "k", "extra", "ndev",
                 "enqueue_ms", "device_ms", "finalize_ms",
                 "filter_ms", "hydrate_ms", "t_start", "t_end",
                 "t_fetch", "t_fetch_mono", "fused", "fetches",
                 "translate_ms", "backend")

    def __init__(self, tier: str, n: int, dim: float, batch: int,
                 bytes_per_row: float, k: int = 0,
                 batch_padded: int = 0, extra: Optional[dict] = None,
                 ndev: int = 1):
        self.tier = tier
        self.n = int(n)
        self.dim = dim
        self.batch = int(batch)
        self.batch_padded = int(batch_padded) or int(batch)
        self.bytes_per_row = bytes_per_row
        self.k = int(k)
        self.extra = extra
        # devices the SPMD program spans (mesh dispatches): `n` stays the
        # GLOBAL row count so flops()/bytes() keep reporting whole-dispatch
        # work; per-chip attribution divides by ndev (monitoring/perf.py)
        self.ndev = max(int(ndev), 1)
        self.enqueue_ms = -1.0
        self.device_ms = -1.0
        self.finalize_ms = -1.0
        self.filter_ms = -1.0
        self.hydrate_ms = -1.0
        self.t_start = 0.0
        self.t_end = 0.0
        # fetch-end stamps (index _fetch_packed): perf_counter for the
        # in-flight duration, monotonic for the duty-cycle anchor (the
        # perf window runs on time.monotonic — hydration happens between
        # fetch end and the window's record call, so the record time is
        # NOT a usable anchor)
        self.t_fetch = 0.0
        self.t_fetch_mono = 0.0
        # fused-dispatch ledger (index/gpu.py): `fused` marks a dispatch
        # whose program emitted final doc ids (slot->doc translation on
        # device), `fetches` counts blocking device->host fetches
        # (_fetch_packed), and `translate_ms` is the measured host-side
        # slot->doc translation — stamped 0.0 at dispatch on the fused
        # path (nothing to measure, by construction), measured on the
        # legacy path, -1 = not measured. The invariant a fused dispatch
        # must keep: exactly ONE fetch and ZERO translation
        # (fused_invariant_ok; violations counted by the perf window).
        self.fused = False
        self.fetches = 0
        self.translate_ms = -1.0
        # the PEAKS key of the device the dispatch runs on (the index sets
        # it; None: detect_backend's default device)
        self.backend: Optional[str] = None

    # -- analytic totals -----------------------------------------------------

    def flops(self) -> int:
        """Useful distance FLOPs for the whole dispatch (actual rows)."""
        return int(round(2.0 * self.batch * self.n * self.dim))

    def bytes(self) -> int:
        """Store bytes read from HBM for the whole dispatch. On the
        pq_adc4 tier `bytes_per_row` covers only the stage-1 nibble scan
        (M/2 per scanned row); the re-rank stages gather per QUERY, not
        per row, so their traffic rides ``extra`` — funnel_c x the 8-bit
        code row for stage 2, funnel_rescore x the bf16 row for stage 3
        — and is added here per batch row."""
        total = self.n * self.bytes_per_row
        if self.extra and self.tier == TIER_PQ_ADC4:
            total += self.batch * (
                self.extra.get("funnel_c", 0)
                * self.extra.get("funnel_stage2_bytes_per_row", 0)
                + self.extra.get("funnel_rescore", 0)
                * self.extra.get("funnel_stage3_bytes_per_row", 0))
        return int(round(total))

    def hop_ms(self) -> float:
        """The host hop between the device fetch and hydration — finalize
        wall minus the blocking fetch. REDEFINED by the fused dispatch:
        on the legacy path this is unpack + the host slot->doc gather
        (the gather/rescore hop the r05 profile flagged); on a fused
        dispatch the translation runs ON DEVICE inside the same program,
        so the hop is dtype views + two word copies and its share of
        accounted wall collapses toward zero (docs/performance.md
        "anatomy of a fused dispatch"). -1 when the split was not
        measured."""
        if self.finalize_ms < 0.0 or self.device_ms < 0.0:
            return -1.0
        return max(self.finalize_ms - self.device_ms, 0.0)

    def ledger(self) -> dict:
        """{phase: ms} of every measured host-overhead ledger stage."""
        out = {}
        if self.filter_ms >= 0.0:
            out["filter"] = self.filter_ms
        if self.enqueue_ms >= 0.0:
            out["enqueue"] = self.enqueue_ms
        if self.device_ms >= 0.0:
            out["device"] = self.device_ms
        hop = self.hop_ms()
        if hop >= 0.0:
            out["gather_hop"] = hop
        if self.hydrate_ms >= 0.0:
            out["hydrate"] = self.hydrate_ms
        return out

    def describe(self) -> dict:
        """Flat dict of the analytic shape (bench rows, trace facts)."""
        d = {"tier": self.tier, "n": self.n, "dim": round(self.dim, 2),
             "batch": self.batch, "batch_padded": self.batch_padded,
             "k": self.k, "flops": self.flops(), "bytes": self.bytes(),
             "fused": self.fused}
        if self.ndev != 1:
            d["ndev"] = self.ndev
        if self.extra:
            d.update(self.extra)
        return d

    def roofline_at_qps(self, qps: float, backend: str = "h100") -> dict:
        """Offline-style roofline for this shape at a measured QPS (bench
        rows: QPS is per query row, batches/s = qps/batch)."""
        return roofline_from_qps(qps, self.n, self.dim, self.batch,
                                 self.bytes_per_row, backend)

    def roofline(self, seconds: float, backend: Optional[str] = None) -> dict:
        """Per-dispatch roofline: this shape's work over `seconds` of
        device time."""
        return roofline(self.flops(), self.bytes(), seconds, backend)


def fused_invariant_ok(shape: "DispatchShape") -> bool:
    """The fused-dispatch ledger invariant: a dispatch that claims device-
    side translation must have made exactly ONE blocking fetch and spent
    ZERO measured host-translation time. Non-fused dispatches trivially
    pass (they make no claim). The perf window counts violations per
    window (monitoring/perf.py), and tests/test_fused_dispatch.py pins
    the contract per tier."""
    if not shape.fused:
        return True
    if shape.translate_ms != 0.0:
        return False
    if shape.n <= 0:
        # empty-gather early return: no device work ran, no fetch owed
        return shape.fetches <= 1
    return shape.fetches == 1


# -- roofline math ------------------------------------------------------------

def _peak(backend: Optional[str]) -> Optional[dict]:
    """PEAKS entry of `backend` (None: the live platform's); None when the
    device has no datasheet entry."""
    key = backend or detect_backend()
    return PEAKS.get(key, PEAKS["cpu"]) if key is not None else None


def ridge(backend: Optional[str] = None) -> Optional[float]:
    """The roofline ridge point (flops/byte) of a backend's peaks — the
    ONE place the compute-vs-bandwidth-bound threshold is computed. None
    for a device with no datasheet peaks."""
    peak = _peak(backend)
    if peak is None:
        return None
    return peak["tflops"] * 1e12 / (peak["hbm_gbs"] * 1e9)


def regime(flops: float, bytes_: float,
           backend: Optional[str] = None) -> Optional[str]:
    """Which peak the work's arithmetic intensity pins (None: no peaks)."""
    r = ridge(backend)
    if r is None:
        return None
    ai = flops / max(bytes_, 1.0)
    return "compute-bound" if ai >= r else "hbm-bandwidth-bound"


def roofline(flops: float, bytes_: float, seconds: float,
             backend: Optional[str] = None) -> Optional[dict]:
    """Achieved-vs-peak roofline for `flops`/`bytes_` of work done in
    `seconds`: the per-dispatch / per-window form (bench's QPS form wraps
    this). backend=None detects the live platform; None for a device with
    no datasheet peaks."""
    peak = _peak(backend)
    if peak is None:
        return None
    secs = max(float(seconds), 1e-9)
    tflops = flops / secs / 1e12
    gbs = bytes_ / secs / 1e9
    ai = flops / max(bytes_, 1.0)
    return {
        "tflops": round(tflops, 3),
        "hbm_gbs": round(gbs, 2),
        "mfu_pct": round(100.0 * tflops / peak["tflops"], 2),
        "bw_pct": round(100.0 * gbs / peak["hbm_gbs"], 2),
        "arith_intensity_flops_per_byte": round(ai, 1),
        "ridge_flops_per_byte": round(ridge(backend), 1),
        "regime": regime(flops, bytes_, backend),
        "peaks": peak["note"],
    }


def roofline_from_qps(qps, n, dim, batch, bytes_per_row,
                      backend="h100") -> dict:
    """Achieved-vs-peak roofline fields for one flat-scan row at a
    measured QPS (the bench.py form — field-for-field what bench's old
    ``_roofline`` emitted; tests/test_bench_roofline.py pins the math).

    FLOPs are the *useful* distance math (2·B·N·D per batch), bytes the
    store bytes read per batch; arithmetic intensity 2·B/bytes_per_elem —
    batch size decides the regime (the lever batch-first serving
    exploits)."""
    flops_per_batch = 2.0 * batch * n * dim
    bytes_per_batch = float(n) * bytes_per_row
    batches_per_s = qps / batch
    return roofline(flops_per_batch * batches_per_s,
                    bytes_per_batch * batches_per_s, 1.0, backend)


# -- exact attribution split --------------------------------------------------

def split_exact(total: int, rows: list, rows_total: int) -> list:
    """Split an integer `total` (flops/bytes) across riders proportionally
    to their `rows`, such that the parts SUM BIT-EXACTLY to the covered
    fraction: part_i = round(T·c_i/R) - round(T·c_{i-1}/R) over cumulative
    rows c — a telescoping sum, so when the riders cover all rows_total
    rows, sum(parts) == total with no float residue (the flops/bytes twin
    of the PR-3 device-time identity)."""
    total = int(total)
    rt = max(int(rows_total), 1)
    out = []
    cum = 0
    prev = 0
    for r in rows:
        cum += int(r)
        edge = (total * cum + rt // 2) // rt  # integer round-half-up
        out.append(edge - prev)
        prev = edge
    return out
