#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (weaviate_tpu_torch) on one NVIDIA card at
the headline scale and at the PQ configuration's, run its stage profiler
at full width, drive its Shard and its App (REST, GraphQL, gRPC, the
coalescer) at 1M objects, and check them.

    python3 chip_smoke.py [--seed 7]

Two workloads through the `VectorIndex` seam a shard calls
(`new_vector_index` -> `add_batch` -> `search_by_vectors` /
`search_by_vectors_async`), k=10, 16384-query batches:

A. the headline: 1M x 128 f32 SIFT-shaped clustered vectors, l2,
   uncompressed (kernel K1 over the f32 store);
B. BASELINE.json config 4, PQ-compressed HNSW on Sphere-1M's shape:
   1M x 768 f32 clustered vectors (seeded synthetic, the headline's
   generator at D=768), dot, pq.segments 96, centroids 256, in three
   indexes built one after another, each shut down before the next:
     B1. bits 8, rescore (K1 over the bf16 copy): ingest, then
         `update_user_config` with pq.enabled; sync and async batches,
         recall@10 >= 0.95 against exact f32 ground truth, a large
         (masked) and a small (gather-tier) allowList, 1000 deletes, and a
         restart that re-enters compressed mode from pq.npz;
     B2. bits 8, codes only (K2): recall@10 >= 0.95 against ADC ground
         truth (the top-10 by ADC distance over the decoded codes; a
         returned id whose ADC distance ties the 10th counts);
     B3. bits 4, rescore: the funnel (K3), every returned distance the
         exact f32 distance to its row in the rescore copy.
   For B2 and B3, 256 queries also run the same op on CPU copies of the
   snapshot's tensors (each wrapper then takes its plain version): the
   ids must overlap the card's at >= 0.99, distances agree to rtol 1e-4.
On A, B1, B2 and B3 the sync batches run again with the fused-dispatch
toggle off (the staged dispatch: slot indices fetched, translated on the
host); their ids and distances must equal the fused ones bit for bit.
Queries go up through the index's pinned staging pool in every phase;
A's and B1's profiled batches print their device-busy share.

A-bf16. A's data in an index with `storeDtype: bfloat16`: K1's bf16
   filler scans the store itself. K1-bf16 against its plain version on
   that store, one profiled sync batch, recall@10 against exact f32
   (printed, no bar), and a 256-query slice against the CPU plain path.

C. the stage profiler (`weaviate_tpu_torch.tools.profile_gmin`) at its
   default shape, N = 2^20 x 128 f32 gaussian, B = 16384: its component,
   gather and loop (ITERS 8) modes in-process, after K4 (`nt_scores`) and
   K5 (`c4_scores`, gc 2 and 4) are held against their plain versions and
   against K1 on the same data (dead slots and 100 whole dead groups); all
   three run K1's resident-tile scan with a depth-major filler, so they are
   timed beside K1 on the untransposed store at the same shape.

D. the Shard (`weaviate_tpu_torch.db.shard.Shard`) at full width: one
   class of 1,048,576 objects with SIFT-shaped clustered vectors (the
   headline generator, D 128, seed + 3), l2, k=10, two properties (`tag`,
   text with 32 values, 32768 rows each: the gather tier; `bucket`, int
   0-999, `bucket < 500` ~524k rows: the masked K1 scan), imported through
   `Shard.put_batch` in batches of 10,000 and flushed to LSM segments.
   Its main path (K1's count set to 0 just before, read just after):
   `object_vector_search` at B 256, hydrated, 7 runs (p50, recall@10
   against exact f32); the raw lane `search_raw_packed` at B 16384 (the
   port's lsm_native build), 5 runs, and one batch of each lane under
   torch.profiler; the two filters (gather >= 0.99, masked >= 0.95); a
   delete check through `delete_object`. Then: the host plane
   (`search_by_vectors_host`, B 64) against the card's exact tier; the
   breaker tripped by device errors injected at `index.gpu.dispatch` (the
   dispatch under `db.shard.search`), served by the host plane while
   open, closed after recovery with its host rows released; `compact()`
   after deleting 10% of the objects (the exact tier answers the same
   before and after); restart (LSM reopen and vector.log replay) answers
   the same. Before the main path, K1 is held against its plain version
   on the Shard index's own store at D's shapes (its own tile plan, B 256
   and B 16384).

E. the App (`weaviate_tpu_torch.server.App` on the card, its default
   config: the reference App's LSM settings) at D's size: D's class
   created through REST `POST /v1/schema`, 1,048,576 objects with D's
   generator (seed + 5) imported through `app.batch` (the use case under
   `/v1/batch/objects`) in batches of 10,000 and one real REST `POST
   /v1/batch/objects` of 1,000 JSON objects, flushed to segments; K1 held
   against its plain version on the App's store at B 16 and 64 (the
   coalescer's lanes), 256 and 16384. Its main path (K1's
   count set to 0 just before, read just after): GraphQL `Get`
   nearVector k=10 over REST, one query a request (p50, p99),
   `/v1/graphql/batch` of 256 (p50), a `where` on `tag` (the gather tier,
   recall >= 0.99); gRPC `BatchSearch` at 256 and at 16384 queries (the
   raw lane, with the native marshaller and point-gets asserted, and
   the servicer's count of the requests the raw lane answered); one
   request of each lane under torch.profiler (the busy share). Then the
   App is shut down and reopened on the same directory with the
   coalescer on (the restart timed): 256 queries from 64 threads equal
   the direct batch's answers, 64 client threads of single-query GraphQL
   for 10 s (QPS, p50, p99, the mean lane fill), and a device trace
   through `GET /debug/pprof/trace?seconds=1` during that load must name
   K1's kernel. Whether the machine has grpc and protobuf is probed with
   importlib.util.find_spec and printed; without them phase E fails.

    python3 chip_smoke.py --busy-share CHECKOUT

runs only A's and B1's sync p50 and device-busy share, with the package
imported from CHECKOUT (`.`, or the parent commit unpacked with `git
archive`), to compare the index's host path of two versions on one card
in turns (parent, change, change, parent). It prints one JSON object with
the numbers as its last line and no result line.

Phases, in order; any failure raises and the script exits non-zero:
1. card: name and power limit (nvidia-smi), compute capability 9.0;
2. build: every CUDA source, one nvcc each, started together;
3. workload A, then B1, B2, B3: each kernel of the tier against its plain
   version at the main-path shapes (l2 and dot, dead slots and whole dead
   groups, on a 1024-query slice and the whole 16384-query batch), the
   main path with its launch counts (every count set to 0 just before the
   tier's main path and read just after), the staged batches, a
   torch.profiler breakdown of one sync batch;
4. timings on the card, after the indexes are freed: each kernel, its
   plain version, a library yardstick and the bound, at 64 queries, the
   1024-query slice and the 16384-query main shape, beside its resident-tile
   plan (ops/gmin_scan.resident_plan); K1 also at 8 live slices of the same
   store (the live-slice bound), and with the plan's tile of N 256 rows in
   turns with one of N 128 (SCG 8) at D=128, launched through the
   library's entry point since the wrapper takes only the plan;
5. C, after the B indexes are freed: the layout kernels' checks, the three
   profiler modes with their launch counts (each count set to 0 just
   before the modes run and read just after), K1's time on the same store
   and shape, then the layout kernels' timings and their ratio to it;
6. A-bf16, then D, then E (each names itself on stderr);
7. the card line, one JSON line of per-kernel numbers (K1's launches and
   max abs error include D's and E's, K1-bf16's the A-bf16 run's), the
   result line.

Each phase also names itself on stderr as it starts. A watchdog stops the
run at WATCHDOG_S seconds: it prints every thread's Python stack to stderr
and exits non-zero, so a run that hangs says where.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid as uuidlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, K, BATCH, N_CLUSTERS = 1_000_000, 10, 16384, 1024
DIM = 128                 # workload A
PQ_DIM, PQ_M, PQ_C = 768, 96, 256  # workload B (BASELINE.json config 4)
N_GT = 1024              # queries with exact ground truth
SLICE = 1024             # query rows of the kernel-vs-plain check
N_CPU = 256              # queries of the card-vs-CPU check (B2, B3)
RECALL_BAR = 0.95        # BASELINE.json
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# kernel vs plain version: the same bf16 operands, summed in f32 in
# another order (tests/test_torch_kernels_cuda.py states the same tolerance)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-3
KERNELS = ("gmin_scan", "pq_gmin", "gmin_layouts")  # the CUDA sources
PROF_N, PROF_ITERS = 1 << 20, 8  # workload C: the profiler's default shape
D_N = 1 << 20             # workload D: objects in the shard
D_IMPORT = 10_000         # objects per Shard.put_batch
D_TAGS, D_BUCKETS = 32, 1000  # tag values (32768 rows each), bucket range
D_B, D_REPS = 256, 7      # hydrated batch (bench.py's _grpc_e2e shape), timed runs
D_RAW_REPS = 5            # timed raw-lane batches of BATCH queries
D_HOST_B, D_EXACT_B = 64, 4  # host-plane batch; rows per exact-tier device call (B < 8)
# the LSM settings the reference App gives every shard by default
# (PERSISTENCE_MEMTABLES_MAX_SIZE_MB 200, PERSISTENCE_FLUSH_IDLE_MEMTABLES_AFTER 60)
D_STORE_OPTS = {"memtable_max_bytes": 200 << 20, "flush_idle_seconds": 60.0}
# host plane vs device: the host scores ||q||^2 - 2 q.x + ||x||^2 in f32,
# the device's exact tier rescores sum((x - q)^2): at ||q||^2 ~ 500 the
# expanded form's rounding is ~1e-4 absolute, so two neighbours closer
# than that may swap places (or trade the 10th place) between the two
HOST_RTOL, HOST_ATOL = 1e-5, 1e-3
E_CLASS = "SiftDoc"       # workload E: the App at D's size (D_N objects, D's properties)
E_REST_IMPORT = 1000      # objects through one REST POST /v1/batch/objects (the rest: app.batch)
E_REST_REQS = 64          # single-query GraphQL requests (p50, p99)
E_FILTER_REQS = 32        # single-query GraphQL requests with the tag filter (gather tier)
E_REPS, E_RAW_REPS = 5, 3  # timed /v1/graphql/batch and BatchSearch 256; BatchSearch 16384
E_THREADS, E_LOAD_S = 64, 10.0  # coalesced load: client threads, seconds
BUSY_REPS = 3             # profiled batches per workload of --busy-share
WATCHDOG_S = 1140  # seconds: a run past this has stalled (a whole run takes ~680 s)
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    """Name the phase that starts now on stderr (where a hang shows)."""
    print(f"chip_smoke: {name} at {time.perf_counter() - T_START:.1f} s", file=sys.stderr,
          flush=True)


def make_data(n, dim, rng):
    """SIFT-like clustered distribution: a mixture of gaussians (the
    headline benchmark's generator)."""
    centers = rng.standard_normal((N_CLUSTERS, dim), dtype=np.float32) * 2.0
    assign = rng.integers(0, N_CLUSTERS, n)
    return centers[assign] + 0.35 * rng.standard_normal((n, dim), dtype=np.float32)


def queries(vecs, rng, nb=2):
    return [rng.standard_normal((BATCH, vecs.shape[1]), dtype=np.float32) * 0.1
            + vecs[rng.integers(0, len(vecs), BATCH)] for _ in range(nb)]


def exact_dists(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """[B, n] exact f32 distances on the card (TF32 off)."""
    if metric == "dot":
        return -(q @ x.T)
    return (q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]


def exact_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric: str = "l2") -> np.ndarray:
    return torch.topk(exact_dists(q, x, metric), k, dim=1, largest=False).indices.cpu().numpy()


def recall_at_k(ids: np.ndarray, gt: np.ndarray, k: int = K) -> float:
    hits = sum(len(set(ids[i, :k].tolist()) & set(gt[i, :k].tolist())) for i in range(len(gt)))
    return hits / (len(gt) * k)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps launches, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(b: int, ag: int, ncols: int, d: int, row_bytes: float,
          extra_bytes: float = 0.0) -> tuple[float, str]:
    """Least time for a group-min scan on these shapes: the larger of the
    operations at the bf16 peak and the bytes (q, the live store or code
    slices at row_bytes a row, bias, output, each once, plus extra_bytes)
    at the memory rate."""
    ops = 2.0 * b * ag * ncols * d
    nbytes = 4.0 * b * d + row_bytes * ag * ncols + 4.0 * ag * ncols + 4.0 * b * ncols
    nbytes += extra_bytes
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_batch(search) -> tuple[float, list[tuple[str, float, int]]]:
    """One sync batch (search()) under torch.profiler -> (wall ms, [(kernel
    name, device ms, launches)] sorted by device ms). The batch runs twice
    in one session and only the second counts: the kernels that start
    inside its marked range. (A session started again in the same process
    saw the card's events only after a delay and dropped a batch's first
    kernels; the first run absorbs that.)"""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    mark = "chip_smoke.measured_batch"
    with torch.profiler.profile(activities=acts) as prof:
        search()
        torch.cuda.synchronize()
        with torch.profiler.record_function(mark):
            t0 = time.perf_counter()
            search()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == mark)
    per_key: dict[str, list] = {}
    for e in events:
        # the marker itself shows up on the device too, spanning the batch
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.name != mark
                and e.time_range.start >= start and e.time_range.elapsed_us() > 0):
            row = per_key.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    kernels = sorted(((key, ms, count) for key, (ms, count) in per_key.items()),
                     key=lambda r: -r[1])
    return wall_ms, kernels


def profile_sync_batch(search, q: np.ndarray, card: str,
                       label: str) -> Optional[tuple[float, float]]:
    """Where one sync batch's device time goes: torch.profiler's kernel
    times (the device busy share is their sum over the batch's wall
    time), measured by `profile_batch` (the batch runs twice, the second
    counts). search(q) runs the batch: an index's or a shard's entry
    point. -> (the busy share, the device ms), None when the profiler saw
    no device time."""
    wall_ms, kernels = profile_batch(lambda: search(q))
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log(f"[{card}] {label} profile: the profiler saw no device time (not measured)")
        return None
    log(f"[{card}] {label} profile of one {len(q)}-query sync batch: wall {wall_ms:.1f} ms, "
        f"device kernels {busy:.1f} ms ({busy / wall_ms:.1%} busy, "
        f"{1 - busy / wall_ms:.1%} idle)")
    for key, ms, count in kernels[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:100]}")
    return busy / wall_ms, busy


def dead_mask(capacity, ncols, n, rng, dev, tombs=None):
    """Dead slots for the kernel checks: past n, the index's tombstones,
    4000 more, and every member of 100 groups (their minima must stay
    +inf)."""
    from weaviate_tpu_torch.ops.gmin_scan import G
    dead = torch.arange(capacity, device=dev) >= n
    if tombs is not None:
        dead |= tombs
    dead[torch.from_numpy(rng.choice(n, 4000, replace=False)).to(dev)] = True
    dead.view(G, ncols)[:, torch.from_numpy(rng.choice(ncols, 100, replace=False)).to(dev)] = True
    return dead


def check_kernel(name, kernel, plain, q_all, biases, ncols, ag, sizes=(SLICE, BATCH)) -> float:
    """The kernel against its plain version at the main-path shapes, for
    each (metric, alpha, bias2) at each batch size of `sizes` (by default
    the 1024-query slice, then the whole 16384-query batch). -> max abs
    error over finite scores."""
    max_err = 0.0
    for b in sizes:
        q_b = q_all[:b]
        for metric, alpha, bias2 in biases:
            got = kernel(q_b, bias2, alpha, ag)
            want = plain(q_b, bias2, alpha, ag)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            if not torch.equal(torch.isinf(got), ~fin):
                raise AssertionError(f"{name} {metric} B={b}: the kernel's dead groups differ "
                                     "from the plain version's")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
            err = float(torch.where(fin, got - want, 0.0).abs().max())
            max_err = max(max_err, err)
            log(f"{name} vs plain [{b} x {ncols}, ag {ag}] {metric}: max abs err {err:.3e} "
                f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); "
                f"+inf groups per query {int((~fin[0]).sum())}")
            del got, want, fin
            torch.cuda.empty_cache()
    return max_err


def time_kernel(name, card, kernel, plain, library, q_all, bias2, ncols, ag, d, row_bytes,
                extra_bytes, library_note, sizes=(SLICE, BATCH), detail="") -> dict:
    """Kernel, plain version and library yardstick at each batch size of
    `sizes` (the last the main shape), beside the bound; -> the main
    shape's numbers."""
    rows = {}
    for b in sizes:
        q_b = q_all[:b]
        ms = cuda_ms(lambda: kernel(q_b, bias2, -2.0, ag), 3)
        plain_ms = cuda_ms(lambda: plain(q_b, bias2, -2.0, ag), 1)
        lib_ms = cuda_ms(lambda: library(q_b), 2)
        torch.cuda.empty_cache()
        bound_ms, bound_by = bound(b, ag, ncols, d, row_bytes, extra_bytes)
        rows[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[{card}] {name} B={b} ncols={ncols} ag={ag} D={d}{detail}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, library {library_note} {lib_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    return rows[sizes[-1]]


def time_k1_widths(card, q, store3, bias2, ag, scgs) -> None:
    """K1 f32 with scg group columns per block for each of scgs, in turns
    (a, b, b, a), each held against the wrapper's answer. The wrapper always
    launches resident_plan's tile, so a narrower one is launched here
    through the library's C entry point (no launch is counted)."""
    from weaviate_tpu_torch.ops import gmin_scan
    lib = gmin_scan._gmin_lib()
    (b, d), ncols = q.shape, store3.shape[1]
    plan = gmin_scan.resident_plan(d, ag)
    scratch = gmin_scan.query_scratch(q, plan)
    out = torch.empty((b, ncols), dtype=torch.float32, device=q.device)
    vec = int(d % 4 == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def run(scg):
        rc = lib.gmin_scan_launch(q.data_ptr(), store3.data_ptr(), bias2.data_ptr(),
                                  scratch.data_ptr(), out.data_ptr(), b, ncols, d, ag, -2.0,
                                  scg, vec, vec, stream)
        if rc != 0:
            raise RuntimeError(f"gmin_scan scg {scg}: " + lib.gmin_scan_error_string(rc).decode())

    want = gmin_scan.group_min_scores(q, store3, bias2, -2.0, active_g=ag)
    for scg in scgs + scgs[::-1]:
        ms = cuda_ms(lambda: run(scg), 3)
        torch.testing.assert_close(out, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        log(f"[{card}] gmin_scan f32 B={b} ag={ag} D={d} N {plan.slices * scg} (SCG {scg}"
            f"{', the plan' if scg == plan.scg else ''}): {ms:.3f} ms")


def plan_note(plan) -> str:
    """The resident-tile plan as the timing lines print it."""
    from weaviate_tpu_torch.ops.gmin_scan import RING_BYTES, RING_STAGES
    return (f", S {plan.slices}, SCG {plan.scg} (N {plan.width}), resident tile "
            f"{plan.width * plan.dp * 2} bytes, query ring {RING_STAGES} x "
            f"{RING_BYTES // RING_STAGES} bytes, {plan.smem} bytes of shared memory")


def build_kernels() -> None:
    """Every CUDA source, one nvcc each, all started together; then load."""
    from weaviate_tpu_torch.ops import _kernels, gmin_scan, pq_gmin
    from weaviate_tpu_torch.tools import profile_gmin
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(_kernels.build, KERNELS))
    gmin_scan._gmin_lib()
    pq_gmin.codes_lib()
    profile_gmin._layouts_lib()
    log(f"build {', '.join(KERNELS)}: {time.perf_counter() - t0:.2f} s in parallel")
    for name in KERNELS:
        secs, out = _kernels.build_info.get(name, (0.0, "(already built)"))
        log(f"  {name}: nvcc {secs:.2f} s")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "C75")):
                log(f"    ptxas: {line.strip()}")


# -- workload A: the headline, uncompressed ----------------------------------------

def headline(dev, card, seed) -> dict:
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.storage.bitmap import Bitmap

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    vecs = make_data(N, DIM, rng)
    batches = queries(vecs, rng)
    log(f"A data: {N} x {DIM} vectors, 2 x {BATCH} queries in {time.perf_counter() - t0:.1f} s")

    # the kernel against its plain version at the main-path store
    capacity = 1 << 20
    ncols = capacity // gmin_scan.G
    ag = -(-N // ncols)
    store = torch.zeros((capacity, DIM), dtype=torch.float32, device=dev)
    store[:N] = torch.from_numpy(vecs).to(dev)
    sq = (store.double() ** 2).sum(1).float()
    dead = dead_mask(capacity, ncols, N, rng, dev)
    store3 = store.view(gmin_scan.G, ncols, DIM)
    q_all = torch.from_numpy(batches[0]).to(dev)
    biases = [(m, a, torch.where(dead, float("inf"), base).view(gmin_scan.G, ncols))
              for m, a, base in (("l2", -2.0, sq), ("dot", -1.0, torch.zeros_like(sq)))]
    k1 = lambda q, b2, a, g: gmin_scan.group_min_scores(q, store3, b2, a, active_g=g)  # noqa: E731
    k1_plain = lambda q, b2, a, g: gmin_scan.group_min_scores_reference(q, store3, b2, a, g)  # noqa: E731
    max_err = check_kernel("gmin_scan f32", k1, k1_plain, q_all, biases, ncols, ag)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_a_")
    try:
        cfg = parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
        idx = new_vector_index(cfg, tmp)
        t0 = time.perf_counter()
        idx.add_batch(np.arange(N), vecs)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        log(f"A ingest: {N} rows in {ingest_s:.2f} s ({N / ingest_s:.0f} rows/s), "
            f"capacity {idx.capacity}")
        x_dev = torch.from_numpy(vecs).to(dev)
        gt_rows = np.arange(0, BATCH, BATCH // N_GT)
        f_rows = np.arange(0, BATCH, BATCH // 256)
        gt = exact_topk(torch.from_numpy(batches[0][gt_rows]).to(dev), x_dev, K)

        gmin_scan.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, batches[0], 4)
        recall = recall_at_k(ids0[gt_rows].astype(np.int64), gt)
        sync_launches = gmin_scan.launches
        log(f"A sync: {BATCH}-query batches {['%.1f ms' % (t * 1e3) for t in lat]}; "
            f"recall@10 {recall:.4f} on {N_GT} queries; kernel launches {sync_launches}")
        if ids0.shape != (BATCH, K) or not np.isfinite(d0).all():
            raise AssertionError(f"sync result shape {ids0.shape} or non-finite distances")
        if recall < RECALL_BAR or sync_launches < 1:
            raise AssertionError(f"recall@10 {recall:.4f} < {RECALL_BAR} or no kernel launch")

        gmin_scan.launches = 0
        qps, results = async_batches(idx, batches, 8)
        async_launches = gmin_scan.launches
        log(f"A async (depth-2 pipeline): 8 x {BATCH} queries = {qps:.0f} QPS; "
            f"kernel launches {async_launches}")
        if async_launches < 8:
            raise AssertionError(f"{async_launches} kernel launches for 8 async batches")
        if not (np.array_equal(results[0][0], ids0) and np.array_equal(results[0][1], d0)):
            raise AssertionError("the async result differs from the sync result")
        staged_p50 = staged_batches(idx, batches[0], 4, ids0, d0, "A")

        gmin_scan.launches = 0
        r_f, r_s = filtered_checks(idx, batches[0], x_dev, f_rows, rng, dev, "l2", Bitmap)
        masked_launches = gmin_scan.launches
        if masked_launches < 1:
            raise AssertionError("the masked allowList launched no kernel")
        log(f"A allowList {N // 3 + 1} docs (masked scan, {masked_launches} kernel launch): "
            f"recall@10 {r_f:.4f}; allowList 1000 docs (gather tier): recall@10 {r_s:.4f}")

        ids_d, d_d = delete_check(idx, ids0, batches[0], N, "A")
        idx.shutdown()
        del idx
        t0 = time.perf_counter()
        idx = new_vector_index(cfg, tmp)
        ids_r, d_r = idx.search_by_vectors(batches[0], K)
        restart_s = time.perf_counter() - t0
        if not np.array_equal(ids_r, ids_d):
            raise AssertionError("answers after the restart differ from before it")
        np.testing.assert_allclose(d_r, d_d, rtol=1e-6)
        log(f"A restart: replayed vector.log and answered the same in {restart_s:.2f} s")
        phase("A profile")
        busy = profile_sync_batch(lambda q: idx.search_by_vectors(q, K), batches[0], card, "A")
        log(f"[{card}] A device-busy share with the pinned staging pool: "
            f"{'not measured' if busy is None else f'{busy[0]:.1%}'} (PR 6, fresh buffers: "
            "81-85%)")
        phase("A shutdown")
        idx.shutdown()
        del idx, x_dev
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    phase("A timings")
    store_bf = store.bfloat16()
    plan = gmin_scan.resident_plan(DIM, ag)
    row = time_kernel("gmin_scan f32", card, k1, k1_plain,
                      lambda q: torch.matmul(q.bfloat16(), store_bf.T), q_all, biases[0][2],
                      ncols, ag, DIM, 4.0 * DIM, 0.0, f"bf16 matmul [Bx{DIM}]x[{DIM}x{capacity}]",
                      sizes=(64, SLICE, BATCH), detail=plan_note(plan))
    del store_bf
    torch.cuda.empty_cache()
    # the live-slice bound: the same store scanned over its first 8 slices
    # (slice g holds rows g * ncols ..: the first half of the store)
    store_bf = store[: capacity // 2].bfloat16()
    half = time_kernel("gmin_scan f32", card, k1, k1_plain,
                       lambda q: torch.matmul(q.bfloat16(), store_bf.T), q_all, biases[0][2],
                       ncols, 8, DIM, 4.0 * DIM, 0.0,
                       f"bf16 matmul [Bx{DIM}]x[{DIM}x{capacity // 2}]", sizes=(BATCH,),
                       detail=plan_note(gmin_scan.resident_plan(DIM, 8)))
    del store_bf
    log(f"[{card}] gmin_scan f32 live-slice bound: ag 8 {half['ms']:.3f} ms = "
        f"{half['ms'] / row['ms']:.1%} of ag {ag} {row['ms']:.3f} ms")
    time_k1_widths(card, q_all[:BATCH], store3, biases[0][2], ag, (plan.scg, plan.scg // 2))
    log(f"[{card}] A end to end, {BATCH}-query batches, k={K}, n={N}: sync p50 "
        f"{p50 * 1e3:.1f} ms (staged {staged_p50 * 1e3:.1f} ms), pipelined {qps:.0f} QPS, "
        f"ingest {N / ingest_s:.0f} rows/s, restart {restart_s:.2f} s")
    return {"name": "gmin_scan", "route": "cuda",
            "source": "weaviate_tpu_torch/csrc/gmin_scan.cu",
            "replaces": "weaviate_tpu/ops/gmin_scan.py:159",
            "launches": sync_launches + async_launches + masked_launches,
            "max_abs_err": max_err, **row}


def sync_batches(idx, q, reps):
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ids, d = idx.search_by_vectors(q, K)
        lat.append(time.perf_counter() - t0)
    return lat, float(np.median(lat[1:])), ids, d


def staged_batches(idx, q, reps, ids0, d0, label) -> float:
    """The sync batches again with the fused-dispatch toggle off (the
    staged dispatch); their answer must equal the fused one (ids0, d0) bit
    for bit. -> the staged p50 in seconds."""
    from weaviate_tpu_torch.index import gpu
    token = gpu.set_fused_enabled(False)
    try:
        lat, p50, ids, d = sync_batches(idx, q, reps)
    finally:
        gpu.unset_fused_enabled(token)
    if ids.dtype != ids0.dtype or not (np.array_equal(ids, ids0)
                                       and np.array_equal(d.view(np.int32), d0.view(np.int32))):
        raise AssertionError(f"{label}: the staged answer differs from the fused one")
    log(f"{label} staged (fused dispatch off): {['%.1f ms' % (t * 1e3) for t in lat]}, "
        f"ids and distances bit-identical to the fused batch")
    return p50


def async_batches(idx, batches, n_pipe):
    t0 = time.perf_counter()
    pending, results = [], []
    for i in range(n_pipe):
        pending.append(idx.search_by_vectors_async(batches[i % 2], K))
        if len(pending) == 2:
            results.append(pending.pop(0)())
    results.extend(f() for f in pending)
    return n_pipe * BATCH / (time.perf_counter() - t0), results


def filtered_checks(idx, q_host, x_dev, f_rows, rng, dev, metric, Bitmap):
    """A large allowList (every third doc: the masked scan) and a small one
    (1000 docs: the gather tier) -> their recall@10 on 256 queries."""
    allowed = np.arange(0, N, 3)
    ids_f, _ = idx.search_by_vectors(q_host, K, allow_list=Bitmap(allowed))
    if (ids_f.astype(np.int64) % 3 != 0).any():
        raise AssertionError("large allowList: a filtered-out id came back")
    q_f = torch.from_numpy(q_host[f_rows]).to(dev)
    gt_f = exact_topk(q_f, x_dev[::3], K, metric) * 3
    r_f = recall_at_k(ids_f[f_rows].astype(np.int64), gt_f)
    small = np.sort(rng.choice(N, 1000, replace=False))
    ids_s, _ = idx.search_by_vectors(q_host, K, allow_list=Bitmap(small))
    gt_s = small[exact_topk(q_f, x_dev[torch.from_numpy(small).to(dev)], K, metric)]
    r_s = recall_at_k(ids_s[f_rows].astype(np.int64), gt_s)
    if not np.isin(ids_s.astype(np.int64), small).all():
        raise AssertionError("small allowList: a filtered-out id came back")
    if r_f < RECALL_BAR or r_s < 0.99:
        raise AssertionError(f"filtered recall {r_f:.4f} / {r_s:.4f} below its bar")
    return r_f, r_s


def delete_check(idx, ids0, q, n, label):
    gone = np.unique(ids0[:, 0].astype(np.int64))[:1000]
    idx.delete(*gone.tolist())
    ids_d, d_d = idx.search_by_vectors(q, K)
    if np.isin(ids_d.astype(np.int64), gone).any() or len(idx) != n - len(gone):
        raise AssertionError("a deleted id came back, or the live count is off")
    log(f"{label} deleted {len(gone)} docs: none returned; live {len(idx)}")
    return ids_d, d_d


# -- workload B: PQ-compressed, three tiers ----------------------------------------

def pq_conf(**pq):
    return {"distance": "dot",
            "pq": {"enabled": True, "segments": PQ_M, "centroids": PQ_C, **pq}}


def tie_aware_hits(ids, dists, ref_ids, ref_dists) -> float:
    """Share of returned ids that are in the reference top-k, or whose
    distance is within the reference's 10th (ties of equal codes have equal
    ADC distances, and either member is a right answer)."""
    kth = ref_dists[:, K - 1:K]
    tol = 1e-5 * np.abs(kth) + 1e-5
    inset = np.array([[i in set(r.tolist()) for i in row] for row, r in zip(ids, ref_ids)])
    return float(np.mean(inset | (dists <= kth + tol)))


def cpu_twin_check(label, card_ids, card_d, cpu_fn):
    """The same op on CPU copies of the snapshot's tensors (each wrapper
    takes its plain version) against the card's answer for the same
    queries: ids overlap >= 0.99 (tie-aware), distances rtol 1e-4."""
    from weaviate_tpu_torch.ops.topk import unpack_fused
    t0 = time.perf_counter()
    ids, d = unpack_fused(cpu_fn().numpy())
    secs = time.perf_counter() - t0
    raw = recall_at_k(card_ids.astype(np.int64), ids.astype(np.int64))
    overlap = tie_aware_hits(card_ids, card_d, ids, d)
    log(f"{label} card vs CPU plain path on {len(ids)} queries ({secs:.1f} s on the CPU): "
        f"id overlap {raw:.4f} (tie-aware {overlap:.4f})")
    if overlap < 0.99:
        raise AssertionError(f"{label}: card and CPU plain path overlap {overlap:.4f} < 0.99")
    for row in range(len(ids)):  # the distances of the ids both return
        _, ci, pi = np.intersect1d(card_ids[row], ids[row], return_indices=True)
        np.testing.assert_allclose(card_d[row, ci], d[row, pi], rtol=1e-4, atol=1e-4)


def pq_index(label, conf, tmp, vecs, declared=True):
    """Build one PQ index through the entry points -> (index, ingest s,
    compress s). `declared` puts the pq block in the creation config (the
    index compresses at the end of the import); otherwise the config update
    turns it on after the import."""
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index
    plain = {"distance": conf["distance"]}
    idx = new_vector_index(parse_and_validate_config("hnsw_tpu", conf if declared else plain), tmp)
    t0 = time.perf_counter()
    idx.add_batch(np.arange(N), vecs)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    compress_s = 0.0
    if not declared:
        t0 = time.perf_counter()
        idx.update_user_config(parse_and_validate_config("hnsw_tpu", conf))
        torch.cuda.synchronize()
        compress_s = time.perf_counter() - t0
    if not idx.compressed:
        raise AssertionError(f"{label}: the index did not compress")
    what = ("import incl. fit + encode" if declared else "import") + f" {ingest_s:.2f} s"
    log(f"{label} {what} ({N / ingest_s:.0f} rows/s)"
        + (f"; compress (fit + encode of {N} rows) {compress_s:.2f} s" if not declared else "")
        + f"; capacity {idx.capacity}")
    return idx, ingest_s, compress_s


def pq_workload(dev, card, seed):
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index
    from weaviate_tpu_torch.ops import gmin_scan, pq4, pq_gmin
    from weaviate_tpu_torch.ops.pq_gmin import build_codes_blocks, reconstruct
    from weaviate_tpu_torch.storage.bitmap import Bitmap

    G = gmin_scan.G
    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    vecs = make_data(N, PQ_DIM, rng)
    batches = queries(vecs, rng)
    log(f"B data: {N} x {PQ_DIM} vectors, 2 x {BATCH} queries in {time.perf_counter() - t0:.1f} s")
    x_dev = torch.from_numpy(vecs).to(dev)
    gt_rows = np.arange(0, BATCH, BATCH // N_GT)
    f_rows = np.arange(0, BATCH, BATCH // 256)
    q_gt = torch.from_numpy(batches[0][gt_rows]).to(dev)
    gt = exact_topk(q_gt, x_dev, K, "dot")
    q_all = torch.from_numpy(batches[0]).to(dev)
    cpu_rows = np.arange(0, BATCH, BATCH // N_CPU)
    out, keep = {}, {}

    # B1: bits 8, rescore (K1 over the bf16 copy)
    phase("B1")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_b1_")
    try:
        conf = pq_conf()
        idx, ingest_s, compress_s = pq_index("B1", conf, tmp, vecs, declared=False)
        snap = idx._read_snapshot()
        ncols, ag = snap.capacity // G, -(-snap.n // (snap.capacity // G))
        store3 = snap.rescore_dev.view(G, ncols, PQ_DIM)
        dead = dead_mask(snap.capacity, ncols, snap.n, rng, dev, snap.tombs)
        sq = (snap.rescore_dev.float() ** 2).sum(1)
        biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
                  for m, a, base in (("l2", -2.0, sq), ("dot", -1.0, torch.zeros_like(sq)))]
        del sq
        k1 = lambda q, b2, a, g: gmin_scan.group_min_scores(q, store3, b2, a, active_g=g)  # noqa: E731
        k1_plain = lambda q, b2, a, g: gmin_scan.group_min_scores_reference(q, store3, b2, a, g)  # noqa: E731
        err = check_kernel("gmin_scan bf16", k1, k1_plain, q_all, biases, ncols, ag)

        gmin_scan.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, batches[0], 4)
        recall = recall_at_k(ids0[gt_rows].astype(np.int64), gt)
        qps, results = async_batches(idx, batches, 8)
        r_f, r_s = filtered_checks(idx, batches[0], x_dev, f_rows, rng, dev, "dot", Bitmap)
        launches = gmin_scan.launches
        log(f"B1 sync: {['%.1f ms' % (t * 1e3) for t in lat]}, recall@10 {recall:.4f} vs exact "
            f"f32 on {N_GT} queries; async {qps:.0f} QPS; filtered recall {r_f:.4f} (masked) / "
            f"{r_s:.4f} (gather); K1-bf16 launches {launches}")
        if recall < RECALL_BAR or launches < 13:
            raise AssertionError(f"B1 recall@10 {recall:.4f} < {RECALL_BAR} or launches {launches}")
        if not (np.array_equal(results[0][0], ids0) and np.array_equal(results[0][1], d0)):
            raise AssertionError("B1: the async result differs from the sync result")
        staged_p50 = staged_batches(idx, batches[0], 4, ids0, d0, "B1")
        ids_d, d_d = delete_check(idx, ids0, batches[0], N, "B1")
        idx.shutdown()
        del idx, snap
        t0 = time.perf_counter()
        idx = new_vector_index(parse_and_validate_config("hnsw_tpu", conf), tmp)
        ids_r, d_r = idx.search_by_vectors(batches[0], K)
        restart_s = time.perf_counter() - t0
        if not idx.compressed or not np.array_equal(ids_r, ids_d):
            raise AssertionError("B1: answers after the restart differ from before it")
        np.testing.assert_allclose(d_r, d_d, rtol=1e-6)
        log(f"B1 restart: replayed vector.log, re-entered compressed mode from pq.npz and "
            f"answered the same in {restart_s:.2f} s")
        busy = profile_sync_batch(lambda q: idx.search_by_vectors(q, K), batches[0], card, "B1")
        log(f"[{card}] B1 device-busy share with the pinned staging pool: "
            f"{'not measured' if busy is None else f'{busy[0]:.1%}'} (PR 6, fresh buffers: 75%)")
        log(f"[{card}] B1 end to end: recall@10 {recall:.4f}, sync p50 {p50 * 1e3:.1f} ms "
            f"(staged {staged_p50 * 1e3:.1f} ms), "
            f"pipelined {qps:.0f} QPS, import {N / ingest_s:.0f} rows/s, compress "
            f"{compress_s:.2f} s, restart {restart_s:.2f} s")
        keep["k1"] = (store3.clone(), biases[0][2], ncols, ag)
        out["k1"] = dict(launches=launches, max_abs_err=err)
        idx.shutdown()
        del idx, store3, biases
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # B2: bits 8, codes only (K2)
    phase("B2")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_b2_")
    try:
        conf = pq_conf(rescore=False)
        idx, ingest_s, _ = pq_index("B2", conf, tmp, vecs)
        snap = idx._read_snapshot()
        pq8 = snap.pq
        ncols, ag = snap.capacity // G, -(-snap.n // (snap.capacity // G))
        codes3 = snap.codes.view(G, ncols, PQ_M)
        cb = pq8.codebook_bf16()
        dead = dead_mask(snap.capacity, ncols, snap.n, rng, dev, snap.tombs)
        biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
                  for m, a, base in (("l2", -2.0, snap.recon_norms),
                                     ("dot", -1.0, torch.zeros_like(snap.recon_norms)))]
        k2 = lambda q, b2, a, g: pq_gmin.pq_group_min_scores(q, codes3, b2, cb, a, active_g=g)  # noqa: E731
        k2_plain = lambda q, b2, a, g: pq_gmin.pq_group_min_scores_reference(  # noqa: E731
            q, codes3, b2, cb, a, g)
        err = check_kernel("pq_gmin", k2, k2_plain, q_all, biases, ncols, ag)

        # ADC ground truth: exact top-k by ADC distance over the decoded codes
        recon = pq8.decode(snap.codes[: snap.n])
        adc = exact_dists(q_gt, recon, "dot")
        adc_d, adc_i = torch.topk(adc, K, dim=1, largest=False)
        adc_d, adc_i = adc_d.cpu().numpy(), adc_i.cpu().numpy()
        del recon, adc

        pq_gmin.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, batches[0], 3)
        qps, _ = async_batches(idx, batches, 4)
        launches = pq_gmin.launches
        ids_gt, d_gt = ids0[gt_rows].astype(np.int64), d0[gt_rows]
        r_adc = tie_aware_hits(ids_gt, d_gt, adc_i, adc_d)
        r_exact = recall_at_k(ids_gt, gt)
        log(f"B2 sync: {['%.1f ms' % (t * 1e3) for t in lat]}; recall@10 {r_adc:.4f} vs ADC "
            f"ground truth (raw id overlap {recall_at_k(ids_gt, adc_i):.4f}), {r_exact:.4f} vs "
            f"exact f32; async {qps:.0f} QPS; K2 launches {launches}")
        if r_adc < RECALL_BAR or launches < 7:
            raise AssertionError(f"B2 ADC recall {r_adc:.4f} < {RECALL_BAR} or launches {launches}")
        staged_p50 = staged_batches(idx, batches[0], 3, ids0, d0, "B2")

        q_cpu = batches[0][cpu_rows]
        card_ids, card_d = idx.search_by_vectors(q_cpu, K)
        rg = pq_gmin.eligible_rg(False, "dot", pq8, len(q_cpu), ncols, K, PQ_DIM)
        codes_c = snap.codes.cpu()
        cb_c = pq8.codebook_dev().cpu()
        cpu_twin_check("B2", card_ids, card_d, lambda: pq_gmin.search_pq_gmin_fused(
            codes_c, snap.recon_norms.cpu(), snap.tombs.cpu(), snap.n,
            torch.from_numpy(q_cpu), cb_c.to(torch.bfloat16), cb_c.reshape(-1, pq8.ds), None,
            snap.slot_to_doc_dev.cpu(), False, K, "dot", rg, ag, None,
            build_codes_blocks(codes_c)))
        profile_sync_batch(lambda q: idx.search_by_vectors(q, K), batches[0], card, "B2")
        log(f"[{card}] B2 end to end: ADC recall@10 {r_adc:.4f}, exact recall@10 {r_exact:.4f}, "
            f"sync p50 {p50 * 1e3:.1f} ms (staged {staged_p50 * 1e3:.1f} ms), pipelined "
            f"{qps:.0f} QPS, import incl. compress {N / ingest_s:.0f} rows/s")
        keep["k2"] = (codes3.clone(), cb.clone(), biases[0][2], ncols, ag)
        out["k2"] = dict(launches=launches, max_abs_err=err)
        idx.shutdown()
        del idx, snap, codes3, biases
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # B3: bits 4, rescore (the funnel, K3)
    phase("B3")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_b3_")
    try:
        conf = pq_conf(bits=4)
        idx, ingest_s, _ = pq_index("B3", conf, tmp, vecs)
        snap = idx._read_snapshot()
        pq8, p4 = snap.pq, snap.pq4
        ncols, ag = snap.capacity // G, -(-snap.n // (snap.capacity // G))
        codes3p = snap.codes4.view(G, ncols, PQ_M // 2)
        cb4 = p4.codebook_bf16()
        dead = dead_mask(snap.capacity, ncols, snap.n, rng, dev, snap.tombs)
        biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
                  for m, a, base in (("l2", -2.0, snap.recon_norms4),
                                     ("dot", -1.0, torch.zeros_like(snap.recon_norms4)))]
        k3 = lambda q, b2, a, g: pq4.pq4_group_min_scores(q, codes3p, b2, cb4, a, active_g=g)  # noqa: E731
        k3_plain = lambda q, b2, a, g: pq4.pq4_group_min_scores_reference(  # noqa: E731
            q, codes3p, b2, cb4, a, g)
        err = check_kernel("pq4_gmin", k3, k3_plain, q_all, biases, ncols, ag)

        pq4.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, batches[0], 3)
        qps, _ = async_batches(idx, batches, 4)
        launches = pq4.launches
        r_exact = recall_at_k(ids0[gt_rows].astype(np.int64), gt)
        # every reported distance is the exact f32 distance to its row in
        # the bf16 rescore copy (what the funnel's stage 3 scores)
        rows = snap.rescore_dev[torch.from_numpy(ids0[gt_rows].astype(np.int64)).to(dev)]
        want = -(rows.float() * q_gt[:, None, :]).sum(-1).cpu().numpy()
        np.testing.assert_allclose(d0[gt_rows], want, rtol=1e-5, atol=1e-3)
        f32_rows = x_dev[torch.from_numpy(ids0[gt_rows].astype(np.int64)).to(dev)]
        f32_want = -(f32_rows * q_gt[:, None, :]).sum(-1).cpu().numpy()
        log(f"B3 sync: {['%.1f ms' % (t * 1e3) for t in lat]}; recall@10 {r_exact:.4f} vs exact "
            f"f32; async {qps:.0f} QPS; K3 launches {launches}; distances equal the exact "
            f"distance to the bf16 rows (rtol 1e-5); max rel gap to the f32 rows' "
            f"{float(np.max(np.abs(d0[gt_rows] - f32_want) / np.abs(f32_want))):.2e}")
        if launches < 7:
            raise AssertionError(f"B3: {launches} K3 launches for 7 batches")
        staged_p50 = staged_batches(idx, batches[0], 3, ids0, d0, "B3")

        q_cpu = batches[0][cpu_rows]
        card_ids, card_d = idx.search_by_vectors(q_cpu, K)
        rg4, rc = idx._funnel_budgets(K, snap.capacity)
        codes8_c = snap.codes.cpu()
        cb4_c = p4.codebook_dev().cpu()
        cpu_twin_check("B3", card_ids, card_d, lambda: pq4.search_pq4_funnel_fused(
            snap.codes4.cpu(), codes8_c, snap.recon_norms4.cpu(), snap.recon_norms.cpu(),
            snap.tombs.cpu(), snap.n, torch.from_numpy(q_cpu), cb4_c.to(torch.bfloat16), cb4_c,
            pq8.codebook_dev().cpu().reshape(-1, pq8.ds), snap.rescore_dev.cpu(), None,
            snap.slot_to_doc_dev.cpu(), False, K, "dot", rg4, rc, ag, True, None,
            build_codes_blocks(codes8_c)))
        profile_sync_batch(lambda q: idx.search_by_vectors(q, K), batches[0], card, "B3")
        log(f"[{card}] B3 end to end: exact recall@10 {r_exact:.4f}, sync p50 {p50 * 1e3:.1f} ms "
            f"(staged {staged_p50 * 1e3:.1f} ms), pipelined {qps:.0f} QPS, import incl. compress "
            f"{N / ingest_s:.0f} rows/s")
        keep["k3"] = (codes3p.clone(), cb4.clone(), biases[0][2], ncols, ag)
        out["k3"] = dict(launches=launches, max_abs_err=err)
        idx.shutdown()
        del idx, snap, codes3p, biases
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del x_dev
    torch.cuda.empty_cache()

    # timings, with the indexes freed (the yardsticks write [B, 1M] bf16)
    phase("B timings")
    store3, bias2, ncols, ag = keep.pop("k1")
    store_bf = store3.view(-1, PQ_DIM)
    out["k1"].update(time_kernel(
        "gmin_scan bf16", card,
        lambda q, b2, a, g: gmin_scan.group_min_scores(q, store3, b2, a, active_g=g),
        lambda q, b2, a, g: gmin_scan.group_min_scores_reference(q, store3, b2, a, g),
        lambda q: torch.matmul(q.bfloat16(), store_bf.T), q_all, bias2, ncols, ag, PQ_DIM,
        2.0 * PQ_DIM, 0.0, f"bf16 matmul [Bx{PQ_DIM}]x[{PQ_DIM}x{store_bf.shape[0]}]",
        sizes=(64, SLICE, BATCH), detail=plan_note(gmin_scan.resident_plan(PQ_DIM, ag))))
    del store3, store_bf, bias2
    torch.cuda.empty_cache()
    for key, name, fn, plain_fn, mb in (
            ("k2", "pq_gmin", pq_gmin.pq_group_min_scores, pq_gmin.pq_group_min_scores_reference,
             PQ_M),
            ("k3", "pq4_gmin", pq4.pq4_group_min_scores, pq4.pq4_group_min_scores_reference,
             PQ_M // 2)):
        codes3, cb, bias2, ncols, ag = keep.pop(key)
        unpack = None if key == "k2" else (lambda p: torch.cat([p & 15, p >> 4], dim=-1))
        codes = codes3.view(-1, mb)
        recon = reconstruct(codes if unpack is None else unpack(codes), cb)  # not timed
        out[key].update(time_kernel(
            name, card,
            lambda q, b2, a, g: fn(q, codes3, b2, cb, a, active_g=g),
            lambda q, b2, a, g: plain_fn(q, codes3, b2, cb, a, g),
            lambda q: torch.matmul(q.bfloat16(), recon.T), q_all, bias2, ncols, ag, PQ_DIM,
            float(mb), 2.0 * cb.numel(),
            f"bf16 matmul [Bx{PQ_DIM}]x[{PQ_DIM}x{recon.shape[0]}] over the reconstruction",
            sizes=(64, SLICE, BATCH), detail=plan_note(pq_gmin.codes_plan(PQ_DIM, ag))))
        del codes3, cb, bias2, recon, codes
        torch.cuda.empty_cache()
    return [
        {"name": "gmin_scan_bf16", "route": "cuda",
         "source": "weaviate_tpu_torch/csrc/gmin_scan.cu",
         "replaces": "weaviate_tpu/ops/gmin_scan.py:159", **out["k1"]},
        {"name": "pq_gmin", "route": "cuda", "source": "weaviate_tpu_torch/csrc/pq_gmin.cu",
         "replaces": "weaviate_tpu/ops/pq_gmin.py:148", **out["k2"]},
        {"name": "pq4_gmin", "route": "cuda", "source": "weaviate_tpu_torch/csrc/pq_gmin.cu",
         "replaces": "weaviate_tpu/ops/pq4.py:151", **out["k3"]},
    ]


# -- workload A with a bf16 store ---------------------------------------------------

def headline_bf16(dev, card, seed) -> dict:
    """A's data (the same seed) in an index with `storeDtype: bfloat16`: K1
    runs its bf16 filler on the store itself. One profiled sync batch,
    recall@10 against exact f32 (printed, no bar: a first measurement),
    K1-bf16 on that store against its plain version, and the whole search
    on a slice against CPU copies of the snapshot (cpu_twin_check). ->
    K1-bf16's launches on this path and its max abs error."""
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index
    from weaviate_tpu_torch.ops import gmin_scan

    G = gmin_scan.G
    rng = np.random.default_rng(seed)
    vecs = make_data(N, DIM, rng)
    batches = queries(vecs, rng)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_a16_")
    try:
        cfg = parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared",
                                                     "storeDtype": "bfloat16"})
        idx = new_vector_index(cfg, tmp)
        t0 = time.perf_counter()
        idx.add_batch(np.arange(N), vecs)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        snap = idx._read_snapshot()
        if snap.store.dtype != torch.bfloat16:
            raise AssertionError(f"A-bf16: the store is {snap.store.dtype}")
        log(f"A-bf16 ingest: {N} rows into a bf16 store in {ingest_s:.2f} s "
            f"({N / ingest_s:.0f} rows/s), capacity {idx.capacity}")
        ncols, ag = snap.capacity // G, -(-snap.n // (snap.capacity // G))
        store3 = snap.store.view(G, ncols, DIM)
        dead = dead_mask(snap.capacity, ncols, snap.n, rng, dev, snap.tombs)
        biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
                  for m, a, base in (("l2", -2.0, snap.sq_norms),
                                     ("dot", -1.0, torch.zeros_like(snap.sq_norms)))]
        q_all = torch.from_numpy(batches[0]).to(dev)
        k1 = lambda q, b2, a, g: gmin_scan.group_min_scores(q, store3, b2, a, active_g=g)  # noqa: E731
        k1_plain = lambda q, b2, a, g: gmin_scan.group_min_scores_reference(q, store3, b2, a, g)  # noqa: E731
        err = check_kernel("gmin_scan bf16 (bf16 store)", k1, k1_plain, q_all, biases, ncols, ag)
        # K1-bf16 at D 128 on the store itself, beside K1-f32 on A's store
        store_bf = snap.store[: ncols * ag]
        time_kernel("gmin_scan bf16 (bf16 store)", card, k1, k1_plain,
                    lambda q: torch.matmul(q.bfloat16(), store_bf.T), q_all, biases[0][2], ncols,
                    ag, DIM, 2.0 * DIM, 0.0, f"bf16 matmul [Bx{DIM}]x[{DIM}x{store_bf.shape[0]}]",
                    sizes=(BATCH,), detail=plan_note(gmin_scan.resident_plan(DIM, ag)))
        del biases, dead, q_all, store_bf
        torch.cuda.empty_cache()

        x_dev = torch.from_numpy(vecs).to(dev)
        gt_rows = np.arange(0, BATCH, BATCH // N_GT)
        gt = exact_topk(torch.from_numpy(batches[0][gt_rows]).to(dev), x_dev, K)
        del x_dev
        gmin_scan.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, batches[0], 4)
        busy = profile_sync_batch(lambda q: idx.search_by_vectors(q, K), batches[0], card,
                                  "A-bf16")
        launches = gmin_scan.launches
        recall = recall_at_k(ids0[gt_rows].astype(np.int64), gt)
        if ids0.shape != (BATCH, K) or not np.isfinite(d0).all() or launches < 5:
            raise AssertionError(f"A-bf16: result {ids0.shape}, launches {launches}")
        log(f"A-bf16 sync: {['%.1f ms' % (t * 1e3) for t in lat]}; recall@10 {recall:.4f} vs "
            f"exact f32 on {N_GT} queries (printed, no bar); K1-bf16 launches {launches}; "
            f"busy {'not measured' if busy is None else f'{busy[0]:.1%}'}")
        cpu_rows = np.arange(0, BATCH, BATCH // N_CPU)
        q_cpu = batches[0][cpu_rows]
        card_ids, card_d = idx.search_by_vectors(q_cpu, K)
        store_c = snap.store.cpu()
        cpu_twin_check("A-bf16", card_ids, card_d, lambda: gmin_scan.search_gmin_fused(
            store_c, snap.sq_norms.cpu(), snap.tombs.cpu(), snap.n, torch.from_numpy(q_cpu),
            None, snap.slot_to_doc_dev.cpu(), False, K, "l2-squared",
            idx._gmin_rg(K, snap.capacity), ag, gmin_scan.build_rescore_blocks(store_c)))
        log(f"[{card}] A-bf16 end to end: recall@10 {recall:.4f}, sync p50 {p50 * 1e3:.1f} ms, "
            f"ingest {N / ingest_s:.0f} rows/s, store {snap.store.numel() * 2 / 2**20:.0f} MiB")
        idx.shutdown()
        del idx, snap, store3, store_c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err}


# -- workload D: the Shard at full width ---------------------------------------------

def shard_doc_ids(results) -> np.ndarray:
    """Hydrated SearchResults -> [B, K] doc ids (-1 where a row is short)."""
    from weaviate_tpu_torch.entities.storobj import StorObj
    out = np.full((len(results), K), -1, dtype=np.int64)
    for i, row in enumerate(results):
        for j, r in enumerate(row[:K]):
            out[i, j] = StorObj.doc_id_from_binary(r.raw_pristine())
    return out


def shard_dists(results) -> np.ndarray:
    out = np.full((len(results), K), np.inf, dtype=np.float32)
    for i, row in enumerate(results):
        out[i, : len(row[:K])] = [r.distance for r in row[:K]]
    return out


def raw_doc_ids(packed, rows) -> np.ndarray:
    """The raw lane's packed images -> [len(rows), K] doc ids of those
    query rows."""
    from weaviate_tpu_torch.entities.storobj import StorObj
    vbuf, voffs, _, _, counts = packed
    starts = np.concatenate([[0], np.cumsum(counts)])
    out = np.full((len(rows), K), -1, dtype=np.int64)
    for i, r in enumerate(rows):
        for j in range(int(counts[r])):
            v = int(starts[r]) + j
            out[i, j] = StorObj.doc_id_from_binary(bytes(vbuf[voffs[v]:voffs[v + 1]]))
    return out


def same_neighbours(label, ids, d, want_ids, want_d) -> int:
    """Two exact answers agree: per query the same ids with distances
    within HOST_RTOL / HOST_ATOL, in any order, except that an id held by
    only one side must lie within 2 * HOST_ATOL of the 10th distance (two
    neighbours that close may trade the 10th place under the two
    formulas' rounding). -> rows that differ in order or in the 10th
    place."""
    moved = 0
    for i in range(len(want_ids)):
        _, ia, ib = np.intersect1d(ids[i], want_ids[i], return_indices=True)
        np.testing.assert_allclose(d[i, ia], want_d[i, ib], rtol=HOST_RTOL, atol=HOST_ATOL)
        if np.array_equal(ids[i], want_ids[i]):
            continue
        moved += 1
        kth = min(float(d[i, -1]), float(want_d[i, -1]))
        alone = np.concatenate([np.delete(d[i], ia), np.delete(want_d[i], ib)])
        if (alone < kth - 2 * HOST_ATOL).any():
            raise AssertionError(f"{label}: query {i} differs beyond a boundary tie: "
                                 f"{ids[i]} / {want_ids[i]}")
    return moved


def exact_tier(shard, q) -> tuple[np.ndarray, np.ndarray]:
    """The index's exact tier on the card (the chunked scan with its f32
    rescore: batches under 8 rows take it) for q, D_EXACT_B rows a call."""
    parts = [shard.vector_index.search_by_vectors(q[i:i + D_EXACT_B], K)
             for i in range(0, len(q), D_EXACT_B)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def check_k1_on_shard(label, what, shard, q_raw, dev, seed, sizes) -> float:
    """K1 against its plain version on a Shard index's own store, at its
    own tile plan (the capacity's columns, the live slices), dead slots
    and whole dead groups, l2 and dot, at the batch sizes `sizes`. -> max
    abs error."""
    from weaviate_tpu_torch.ops import gmin_scan
    snap = shard.vector_index._read_snapshot()
    G = gmin_scan.G
    ncols, ag = snap.capacity // G, -(-snap.n // (snap.capacity // G))
    store3 = snap.store.view(G, ncols, snap.dim)
    dead = dead_mask(snap.capacity, ncols, snap.n, np.random.default_rng(seed), dev,
                     snap.tombs)
    biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
              for m, a, base in (("l2", -2.0, snap.sq_norms),
                                 ("dot", -1.0, torch.zeros_like(snap.sq_norms)))]
    k1 = lambda q, b2, a, g: gmin_scan.group_min_scores(q, store3, b2, a, active_g=g)  # noqa: E731
    k1_plain = lambda q, b2, a, g: gmin_scan.group_min_scores_reference(q, store3, b2, a, g)  # noqa: E731
    log(f"{label} K1 on {what}'s store: ncols {ncols}, ag {ag}"
        f"{plan_note(gmin_scan.resident_plan(snap.dim, ag))}")
    max_err = check_kernel(f"gmin_scan f32 ({what} store)", k1, k1_plain,
                           torch.from_numpy(q_raw).to(dev), biases, ncols, ag, sizes=sizes)
    del snap, store3, dead, biases
    torch.cuda.empty_cache()
    return max_err


def shard_workload(dev, card, seed) -> dict:
    """The Shard over the port's index at 1M objects: import, the
    hydrated and raw read lanes, filters, deletes, the host plane, the
    breaker, compaction and restart. -> K1's launches on the main path."""
    from weaviate_tpu_torch.db.shard import Shard
    from weaviate_tpu_torch.entities.filters import LocalFilter
    from weaviate_tpu_torch.entities.schema import ClassDef, Property
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.serving import robustness
    from weaviate_tpu_torch.testing import faults

    rng = np.random.default_rng(seed + 3)
    t0 = time.perf_counter()
    vecs = make_data(D_N, DIM, rng)
    bucket = rng.integers(0, D_BUCKETS, D_N)
    q_raw = queries(vecs, rng, 1)[0]
    q_hyd = q_raw[:D_B]
    log(f"D data: {D_N} x {DIM} vectors, tag (text, {D_TAGS} values), bucket (int, "
        f"0-{D_BUCKETS - 1}), {BATCH} queries in {time.perf_counter() - t0:.1f} s")
    cd = ClassDef(name="SiftDoc", properties=[Property(name="tag", data_type=["text"]),
                                              Property(name="bucket", data_type=["int"])],
                  vector_index_type="hnsw_tpu")
    cfg = parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_d_")
    shard = None
    try:
        shard = Shard("shard0", tmp, cd, cfg, store_opts=D_STORE_OPTS)
        t0 = time.perf_counter()
        for s in range(0, D_N, D_IMPORT):
            objs = [StorObj(class_name="SiftDoc", uuid=str(uuidlib.UUID(int=i + 1)),
                            properties={"tag": f"tag{i % D_TAGS}", "bucket": int(bucket[i])},
                            vector=vecs[i]) for i in range(s, min(s + D_IMPORT, D_N))]
            errs = shard.put_batch(objs)
            if any(e is not None for e in errs):
                raise AssertionError(f"D import: {next(e for e in errs if e is not None)!r}")
        put_s = time.perf_counter() - t0
        shard.flush()
        shard.store.flush_memtables()
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        if shard.object_count() != D_N or len(shard.vector_index) != D_N:
            raise AssertionError(f"D import: {shard.object_count()} objects, "
                                 f"{len(shard.vector_index)} vectors")
        log(f"D import: {D_N} objects through Shard.put_batch in batches of {D_IMPORT}: "
            f"{put_s:.1f} s, then flush and memtables to segments: {import_s:.1f} s in all, "
            f"{D_N / import_s:.0f} objects/s; capacity {shard.vector_index.capacity}")

        # K1 against its plain version on the Shard index's own store, at
        # the shapes D's main path gives it (its own tile plan: more
        # columns and fewer live slices than A's) and at D's batch sizes
        max_err = check_k1_on_shard("D", "the Shard", shard, q_raw, dev, seed + 4, (D_B, BATCH))

        x_dev = torch.from_numpy(vecs).to(dev)
        gt_h = exact_topk(torch.from_numpy(q_hyd).to(dev), x_dev, K)
        gt_rows = np.arange(0, BATCH, BATCH // N_GT)
        gt_raw = exact_topk(torch.from_numpy(q_raw[gt_rows]).to(dev), x_dev, K)

        # the main path, through the Shard's entry points
        phase("D main path")
        gmin_scan.launches = 0
        lat = []
        for _ in range(D_REPS):
            t0 = time.perf_counter()
            res = shard.object_vector_search(q_hyd, K)
            lat.append(time.perf_counter() - t0)
        ids_h = shard_doc_ids(res)
        r_h = recall_at_k(ids_h, gt_h)
        p50_h = float(np.median(lat))
        log(f"D object_vector_search B={D_B} hydrated: {['%.1f ms' % (t * 1e3) for t in lat]}, "
            f"p50 {p50_h * 1e3:.2f} ms; recall@10 {r_h:.4f} vs exact f32")
        if r_h < RECALL_BAR or (ids_h < 0).any():
            raise AssertionError(f"D hydrated recall@10 {r_h:.4f} < {RECALL_BAR}, or short rows")
        if not shard.raw_plane_ready():
            raise AssertionError("D: the raw lane is not ready (lsm_native did not build, or "
                                 "a memtable holds writes)")
        lat = []
        for _ in range(D_RAW_REPS):
            t0 = time.perf_counter()
            packed = shard.search_raw_packed(q_raw, K)
            lat.append(time.perf_counter() - t0)
            if packed is None:
                raise AssertionError("D: search_raw_packed fell back (returned None)")
        r_raw = recall_at_k(raw_doc_ids(packed, gt_rows), gt_raw)
        p50_raw = float(np.median(lat))
        log(f"D search_raw_packed B={BATCH}: {['%.1f ms' % (t * 1e3) for t in lat]}, "
            f"p50 {p50_raw * 1e3:.2f} ms ({BATCH / p50_raw:.0f} QPS); recall@10 {r_raw:.4f} "
            f"on {N_GT} queries; {int(packed[4].sum())} images, {len(packed[0])} bytes of arena")
        if r_raw < RECALL_BAR:
            raise AssertionError(f"D raw-lane recall@10 {r_raw:.4f} < {RECALL_BAR}")
        # the profiler's own host tracing slows the host half of a lane (the
        # hydration makes many small calls), so each lane's busy share is
        # also read against its unprofiled p50
        prof = profile_sync_batch(lambda q: shard.search_raw_packed(q, K), q_raw, card,
                                  "D raw lane (Shard.search_raw_packed)")
        busy = None if prof is None else prof[1] / (p50_raw * 1e3)
        prof_h = profile_sync_batch(lambda q: shard.object_vector_search(q, K), q_hyd, card,
                                    "D hydrated (Shard.object_vector_search)")
        busy_h = None if prof_h is None else prof_h[1] / (p50_h * 1e3)
        raw_note = "not measured" if busy is None else f"{prof[1]:.2f} ms, {busy:.1%} busy"
        hyd_note = "not measured" if busy_h is None else f"{prof_h[1]:.2f} ms, {busy_h:.1%} busy"
        log(f"[{card}] D device ms over the unprofiled p50: raw lane {raw_note}; "
            f"hydrated {hyd_note}")
        # filters: one tag value (32768 rows < flatSearchCutoff 40000: the
        # gather tier) and bucket < 500 (~524k rows: the masked scan)
        q_f = torch.from_numpy(q_hyd).to(dev)
        recalls = {}
        for label, flt, allowed, tier, bar in (
                ("tag = tag5", {"operator": "Equal", "path": ["tag"], "valueText": "tag5"},
                 np.arange(5, D_N, D_TAGS), "gather", 0.99),
                ("bucket < 500", {"operator": "LessThan", "path": ["bucket"], "valueInt": 500},
                 np.flatnonzero(bucket < 500), "exact_scan", RECALL_BAR)):
            f = LocalFilter.from_dict(flt)
            got_tier = shard.vector_index.dispatch_tier(shard.vector_index._read_snapshot(),
                                                         shard.build_allow_list(f))
            res = shard.object_vector_search(q_hyd, K, f)
            ids_f = shard_doc_ids(res)
            gt_f = allowed[exact_topk(q_f, x_dev[torch.from_numpy(allowed).to(dev)], K)]
            r_f = recall_at_k(ids_f, gt_f)
            recalls[label] = r_f
            log(f"D filter {label}: {len(allowed)} allowed, tier {got_tier}; recall@10 "
                f"{r_f:.4f} (bar {bar})")
            if got_tier != tier or r_f < bar or not np.isin(ids_f[ids_f >= 0], allowed).all():
                raise AssertionError(f"D filter {label}: tier {got_tier}, recall {r_f:.4f}, or "
                                     "an id outside the allowList")
        gone = np.unique(ids_h[:, 0])
        for d in gone.tolist():
            if not shard.delete_object(str(uuidlib.UUID(int=d + 1))):
                raise AssertionError(f"D: delete_object of doc {d} found nothing")
        ids_d = shard_doc_ids(shard.object_vector_search(q_hyd, K))
        if np.isin(ids_d, gone).any() or shard.object_count() != D_N - len(gone):
            raise AssertionError("D: a deleted object came back, or the count is off")
        launches = gmin_scan.launches
        log(f"D deleted {len(gone)} objects through delete_object: none returned; "
            f"K1 launches on the main path {launches}")
        if launches < D_REPS + D_RAW_REPS:
            raise AssertionError(f"D: {launches} K1 launches on the main path")

        # the host plane against the card's exact tier
        phase("D host plane")
        q64 = q_hyd[:D_HOST_B]
        t0 = time.perf_counter()
        ids_host, d_host = shard.vector_index.search_by_vectors_host(q64, K)
        host_s = time.perf_counter() - t0
        ids_ex, d_ex = exact_tier(shard, q64)
        ids_g, _ = shard.vector_index.search_by_vectors(q64, K)
        moved = same_neighbours("D host plane", ids_host, d_host, ids_ex, d_ex)
        log(f"D search_by_vectors_host B={D_HOST_B}: {host_s:.2f} s (the host copy of the "
            f"store included); the same ids as the card's exact tier with distances within "
            f"rtol {HOST_RTOL}, atol {HOST_ATOL} ({moved} of {D_HOST_B} rows ordered "
            f"differently within that rounding); id overlap with the B={D_HOST_B} fast scan "
            f"{recall_at_k(ids_g.astype(np.int64), ids_host.astype(np.int64)):.4f}")
        shard.vector_index.release_host_fallback_cache()

        # the breaker: device faults at the dispatch under db.shard.search
        phase("D breaker")
        q4 = q_hyd[:D_EXACT_B]
        want = shard.object_vector_search(q4, K)
        want_ids, want_d = shard_doc_ids(want), shard_dists(want)

        def check_host(res, what):
            same_neighbours(f"D breaker ({what})", shard_doc_ids(res), shard_dists(res),
                            want_ids, want_d)

        br = robustness.configure_breaker(robustness.CircuitBreaker(
            failure_threshold=3, reset_timeout_s=0.2))
        inj = faults.configure(faults.FaultInjector())
        try:
            inj.plan("index.gpu.dispatch", "device_error", times=None)
            trips = 0
            while br.state() != robustness.STATE_OPEN and trips < 6:
                check_host(shard.object_vector_search(q4, K), "device error")
                trips += 1
            if br.state() != robustness.STATE_OPEN:
                raise AssertionError("D breaker: injected device errors did not trip it")
            check_host(shard.object_vector_search(q4, K), "open")
            if shard.vector_index._host_rows_cache is None:
                raise AssertionError("D breaker: the open breaker's host plane held no host rows")
            inj.clear()
            time.sleep(0.3)
            probe = shard_doc_ids(shard.object_vector_search(q4, K))
            if (not np.array_equal(probe, want_ids) or br.state() != robustness.STATE_CLOSED
                    or shard.vector_index._host_rows_cache is not None):
                raise AssertionError("D breaker: it did not close after recovery, or the host "
                                     "rows cache was kept")
        finally:
            faults.unconfigure(inj)
            robustness.unconfigure_breaker(br)
        log(f"D breaker: {trips} device errors injected at index.gpu.dispatch (under "
            f"db.shard.search) opened it, each answered by the host plane; open, the host plane "
            f"served; after recovery a probe closed it and released the host rows cache")

        # compaction after deleting 10% of the objects
        phase("D compact")
        victims = rng.choice(np.setdiff1d(np.arange(D_N), gone), D_N // 10, replace=False)
        t0 = time.perf_counter()
        for d in victims.tolist():
            shard.delete_object(str(uuidlib.UUID(int=d + 1)))
        del_s = time.perf_counter() - t0
        before_ex = exact_tier(shard, q64)
        before_h = shard.object_vector_search(q_hyd, K)
        t0 = time.perf_counter()
        shard.vector_index.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        after_ex = exact_tier(shard, q64)
        after_h = shard.object_vector_search(q_hyd, K)
        if not np.array_equal(after_ex[0], before_ex[0]):
            raise AssertionError("D compact: the surviving docs' answers changed")
        np.testing.assert_allclose(after_ex[1], before_ex[1], rtol=1e-6)
        overlap = recall_at_k(shard_doc_ids(after_h), shard_doc_ids(before_h))
        health = shard.debug_health()["vector_index"]
        log(f"D compact: {len(victims)} delete_object calls {del_s:.1f} s; compact "
            f"{compact_s:.2f} s "
            f"({health['slots']} slots, {health['live']} live, {health['tombstones']} tombstones "
            f"after); exact-tier answers for {D_HOST_B} queries equal before and after; B={D_B} "
            f"fast-scan overlap {overlap:.4f}")
        if health["tombstones"] != 0 or overlap < 0.99:
            raise AssertionError(f"D compact: {health['tombstones']} tombstones, overlap "
                                 f"{overlap:.4f}")

        # restart: a new Shard on the same path
        phase("D restart")
        want_ids, want_d = shard_doc_ids(after_h), shard_dists(after_h)
        shard.shutdown()
        shard = None
        t0 = time.perf_counter()
        shard = Shard("shard0", tmp, cd, cfg, store_opts=D_STORE_OPTS)
        res = shard.object_vector_search(q_hyd, K)
        restart_s = time.perf_counter() - t0
        if not np.array_equal(shard_doc_ids(res), want_ids):
            raise AssertionError("D restart: answers differ from before the restart")
        np.testing.assert_allclose(shard_dists(res), want_d, rtol=1e-6)
        log(f"D restart: LSM reopen and vector.log replay of {len(shard.vector_index)} vectors, "
            f"then the B={D_B} search answered the same, in {restart_s:.2f} s")
        log(f"[{card}] D end to end ({D_N} objects, k={K}): import {D_N / import_s:.0f} "
            f"objects/s; hydrated B={D_B} p50 {p50_h * 1e3:.2f} ms recall@10 {r_h:.4f}; raw "
            f"lane B={BATCH} p50 {p50_raw * 1e3:.2f} ms recall@10 {r_raw:.4f}; busy raw "
            f"{'not measured' if busy is None else f'{busy:.1%}'}, hydrated "
            f"{'not measured' if busy_h is None else f'{busy_h:.1%}'}; filtered "
            f"{recalls['tag = tag5']:.4f} (gather) / {recalls['bucket < 500']:.4f} (masked); "
            f"compact {compact_s:.2f} s; restart {restart_s:.2f} s")
        del x_dev
    finally:
        if shard is not None:
            shard.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err}


# -- workload E: the App above the Shard ------------------------------------------------

def http(port, method, path, body=None, timeout=300):
    """One REST request to 127.0.0.1:port -> (status, parsed JSON or text)."""
    import urllib.request
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
        if r.headers.get("Content-Type", "").startswith("application/json"):
            return r.status, json.loads(raw) if raw else None
        return r.status, raw.decode()


def gql_near(q, where: str = "") -> str:
    """A GraphQL Get nearVector k=K over E's class, ids and distances."""
    return ("{ Get { %s(nearVector: {vector: %s}, limit: %d%s) { _additional { id distance } } } }"
            % (E_CLASS, json.dumps([round(float(v), 7) for v in q]), K, where))


def gql_rows(reply) -> tuple[list[int], list[float]]:
    """A GraphQL Get reply -> (doc ids, distances); an error raises."""
    if reply.get("errors"):
        raise AssertionError(f"E GraphQL: {reply['errors']}")
    rows = reply["data"]["Get"][E_CLASS]
    return ([uuidlib.UUID(r["_additional"]["id"]).int - 1 for r in rows],
            [float(r["_additional"]["distance"]) for r in rows])


def ids_matrix(rows) -> np.ndarray:
    out = np.full((len(rows), K), -1, dtype=np.int64)
    for i, (ids, _) in enumerate(rows):
        out[i, : len(ids)] = ids[:K]
    return out


def grpc_batch_ids(reply) -> np.ndarray:
    out = np.full((len(reply.replies), K), -1, dtype=np.int64)
    for i, one in enumerate(reply.replies):
        if one.error_message:
            raise AssertionError(f"E BatchSearch slot {i}: {one.error_message}")
        for j, r in enumerate(one.results[:K]):
            out[i, j] = uuidlib.UUID(r.id).int - 1
    return out


def app_workload(dev, card, seed) -> dict:
    """The port's App (REST, GraphQL, gRPC, the coalescer) at workload
    D's size. -> K1's launches on the main path and its max abs error on
    the App's store."""
    import importlib.util
    import threading

    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.server import App, RestServer, reply_native
    from weaviate_tpu_torch.storage import lsm_native

    has_grpc = {m: importlib.util.find_spec(m) is not None for m in ("grpc", "google.protobuf")}
    log(f"E probe: importlib.util.find_spec: {has_grpc}")
    if not all(has_grpc.values()):
        raise AssertionError(f"E: gRPC cannot be served on this machine: {has_grpc}")
    rng = np.random.default_rng(seed + 5)
    t0 = time.perf_counter()
    vecs = make_data(D_N, DIM, rng)
    bucket = rng.integers(0, D_BUCKETS, D_N)
    q_all = queries(vecs, rng, 1)[0]
    log(f"E data: {D_N} x {DIM} vectors (seed + 5), tag and bucket as D, {BATCH} queries in "
        f"{time.perf_counter() - t0:.1f} s")

    def payload(i, as_list=False):
        return {"class": E_CLASS, "id": str(uuidlib.UUID(int=i + 1)),
                "properties": {"tag": f"tag{i % D_TAGS}", "bucket": int(bucket[i])},
                "vector": vecs[i].tolist() if as_list else vecs[i]}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_e_")
    app = srv = gsrv = client = None
    try:
        app = App(data_path=tmp, device=dev)
        srv = RestServer(app, host="127.0.0.1", port=0)
        srv.start()
        port = srv.port
        st, _ = http(port, "POST", "/v1/schema", {
            "class": E_CLASS, "vectorIndexType": "hnsw_tpu",
            "vectorIndexConfig": {"distance": "l2-squared"},
            "properties": [{"name": "tag", "dataType": ["text"]},
                           {"name": "bucket", "dataType": ["int"]}]})
        if st != 200:
            raise AssertionError(f"E POST /v1/schema: {st}")
        t0 = time.perf_counter()
        n_use = D_N - E_REST_IMPORT
        for s in range(0, n_use, D_IMPORT):
            res = app.batch.add_objects([payload(i) for i in range(s, min(s + D_IMPORT, n_use))])
            bad = [r.err for r in res if r.err is not None]
            if bad:
                raise AssertionError(f"E import: {bad[0]}")
        batch_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        st, res = http(port, "POST", "/v1/batch/objects",
                       {"objects": [payload(i, True) for i in range(n_use, D_N)]})
        rest_s = time.perf_counter() - t1
        if st != 200 or any("errors" in r["result"] for r in res):
            raise AssertionError(f"E POST /v1/batch/objects: {st}")
        idx = app.db.get_index(E_CLASS)
        shard = idx.single_local_shard()
        shard.flush()
        shard.store.flush_memtables()
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        if shard.object_count() != D_N:
            raise AssertionError(f"E import: {shard.object_count()} objects")
        log(f"E import: {n_use} objects through app.batch (the use case under "
            f"/v1/batch/objects) in batches of {D_IMPORT}: {batch_s:.1f} s; {E_REST_IMPORT} "
            f"through REST POST /v1/batch/objects: {rest_s:.2f} s; then flush and memtables "
            f"to segments: {import_s:.1f} s in all, {D_N / import_s:.0f} objects/s; capacity "
            f"{shard.vector_index.capacity}")

        # 16 and 64: the coalescer's lanes (max_request_rows 16, padded to
        # the index's B buckets), a partial tile of K1's query rows
        max_err = check_k1_on_shard("E", "the App", shard, q_all, dev, seed + 6,
                                    (16, 64, D_B, BATCH))
        x_dev = torch.from_numpy(vecs).to(dev)
        q_rest, q_b = q_all[:E_REST_REQS], q_all[:D_B]
        gt_b = exact_topk(torch.from_numpy(q_b).to(dev), x_dev, K)
        gt_rows = np.arange(0, BATCH, BATCH // N_GT)
        gt_raw = exact_topk(torch.from_numpy(q_all[gt_rows]).to(dev), x_dev, K)
        # the coalescer's answers are held against these (outside the count)
        direct = shard.object_vector_search(q_b, K)
        want_ids, want_d = shard_doc_ids(direct), shard_dists(direct)

        # the main path, through the App's entry points
        phase("E main path")
        gmin_scan.launches = 0
        lat, rows = [], []
        for q in q_rest:
            t1 = time.perf_counter()
            st, rep = http(port, "POST", "/v1/graphql", {"query": gql_near(q)})
            lat.append(time.perf_counter() - t1)
            rows.append(gql_rows(rep))
        r_rest = recall_at_k(ids_matrix(rows), gt_b[:E_REST_REQS])
        p50_rest, p99_rest = (float(np.percentile(lat, p)) for p in (50, 99))
        log(f"E REST GraphQL Get nearVector, one query a request, {E_REST_REQS} requests: p50 "
            f"{p50_rest * 1e3:.2f} ms, p99 {p99_rest * 1e3:.2f} ms; recall@10 {r_rest:.4f}")
        body = [{"query": gql_near(q)} for q in q_b]
        lat = []
        for _ in range(E_REPS):
            t1 = time.perf_counter()
            st, rep = http(port, "POST", "/v1/graphql/batch", body)
            lat.append(time.perf_counter() - t1)
        ids_batch = ids_matrix([gql_rows(r) for r in rep])
        r_batch = recall_at_k(ids_batch, gt_b)
        p50_batch = float(np.median(lat))
        log(f"E REST /v1/graphql/batch of {D_B} queries (without the coalescer its slots run "
            f"one after another): {['%.1f ms' % (t * 1e3) for t in lat]}, "
            f"p50 {p50_batch * 1e3:.2f} ms; recall@10 {r_batch:.4f}")
        allowed = np.arange(5, D_N, D_TAGS)
        where = ', where: {operator: Equal, path: ["tag"], valueText: "tag5"}'
        from weaviate_tpu_torch.entities.filters import LocalFilter
        tier = shard.vector_index.dispatch_tier(
            shard.vector_index._read_snapshot(), shard.build_allow_list(LocalFilter.from_dict(
                {"operator": "Equal", "path": ["tag"], "valueText": "tag5"})))
        rows_f = [gql_rows(http(port, "POST", "/v1/graphql", {"query": gql_near(q, where)})[1])
                  for q in q_all[:E_FILTER_REQS]]
        ids_f = ids_matrix(rows_f)
        gt_f = allowed[exact_topk(torch.from_numpy(q_all[:E_FILTER_REQS]).to(dev),
                                  x_dev[torch.from_numpy(allowed).to(dev)], K)]
        r_filter = recall_at_k(ids_f, gt_f)
        log(f"E REST GraphQL where tag = tag5 ({len(allowed)} allowed, tier {tier}), "
            f"{E_FILTER_REQS} requests: recall@10 {r_filter:.4f} (bar 0.99)")
        if (min(r_rest, r_batch) < RECALL_BAR or r_filter < 0.99 or tier != "gather"
                or not np.isin(ids_f[ids_f >= 0], allowed).all()):
            raise AssertionError(f"E REST: recall {r_rest:.4f} / {r_batch:.4f} / filter "
                                 f"{r_filter:.4f}, tier {tier}, or an id outside the allowList")

        if not (reply_native.available() and lsm_native.available()):
            raise AssertionError("E: the native reply marshaller or the LSM point-get plane "
                                 "did not build")
        from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
        from weaviate_tpu_torch.server.grpc_server import GrpcServer, SearchClient
        gsrv = GrpcServer(app, host="127.0.0.1", port=0)
        gsrv.start()
        client = SearchClient(f"127.0.0.1:{gsrv.port}")

        def breq(qs):
            return pb.BatchSearchRequest(requests=[
                pb.SearchRequest(class_name=E_CLASS, limit=K,
                                 near_vector=pb.NearVectorParams(vector=q.tolist()))
                for q in qs])

        grpc_out = {}
        for width, reps in ((D_B, E_REPS), (BATCH, E_RAW_REPS)):
            req = breq(q_all[:width])
            hits0 = gsrv.servicer.raw_lane_batches
            lat = []
            for _ in range(reps):
                t1 = time.perf_counter()
                reply = client.batch_search(req, timeout=600)
                lat.append(time.perf_counter() - t1)
            raw = gsrv.servicer.raw_lane_batches - hits0
            ids_g = grpc_batch_ids(reply)
            r_g = recall_at_k(ids_g[:D_B], gt_b) if width == D_B else \
                recall_at_k(ids_g[gt_rows], gt_raw)
            grpc_out[width] = (float(np.median(lat)), r_g)
            log(f"E gRPC BatchSearch {width} queries (raw lane served {raw} of {reps}, native "
                f"marshaller {reply_native.available()}): {['%.1f ms' % (t * 1e3) for t in lat]}, "
                f"p50 {grpc_out[width][0] * 1e3:.2f} ms; recall@10 {r_g:.4f}")
            if r_g < RECALL_BAR or (width == BATCH and raw != reps):
                raise AssertionError(f"E gRPC {width}: recall {r_g:.4f}, raw lane served {raw} "
                                     f"of {reps}")
        raw_search = lambda: client.batch_search(breq(q_all), timeout=600)  # noqa: E731
        # where one request's device time goes (chip_smoke's own profiler
        # session; the App's device trace below runs after it, never beside)
        busy = {}
        for label, fn in ((f"graphql/batch {D_B}", lambda: http(port, "POST",
                                                                 "/v1/graphql/batch", body)),
                          (f"raw-lane BatchSearch {BATCH}", raw_search)):
            wall_ms, kernels = profile_batch(fn)
            dev_ms = sum(ms for _, ms, _ in kernels)
            busy[label] = (wall_ms, dev_ms)
            log(f"[{card}] E {label} profile: wall {wall_ms:.1f} ms, device kernels "
                f"{dev_ms:.2f} ms ({dev_ms / wall_ms:.1%} busy)")
            for key, ms, count in kernels[:6]:
                log(f"  {ms:8.3f} ms  x{count:<4d} {key[:100]}")
        client.close()
        gsrv.stop()
        client = gsrv = None
        srv.stop()
        srv = None
        app.shutdown()
        app = shard = None

        # the coalescer: the App reopened on the same directory
        phase("E coalescer")
        cfg = load_config({**os.environ, "QUERY_COALESCER_ENABLED": "true"})
        t0 = time.perf_counter()
        app = App(config=cfg, data_path=tmp, device=dev)
        srv = RestServer(app, host="127.0.0.1", port=0)
        srv.start()
        port = srv.port
        first = gql_rows(http(port, "POST", "/v1/graphql", {"query": gql_near(q_b[0])})[1])
        restart_s = time.perf_counter() - t0
        if first[0] != want_ids[0].tolist():
            raise AssertionError("E restart: the first answer differs from before")
        log(f"E App restart with the coalescer on: {D_N} objects, schema, LSM reopen and "
            f"vector.log replay, REST up and the first query answered in {restart_s:.2f} s")
        got = [None] * D_B

        def coalesced(t):
            for i in range(t, D_B, E_THREADS):
                got[i] = gql_rows(http(port, "POST", "/v1/graphql", {"query": gql_near(q_b[i])})[1])

        threads = [threading.Thread(target=coalesced, args=(t,)) for t in range(E_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (ids, d) in enumerate(got):
            if ids != want_ids[i].tolist():
                raise AssertionError(f"E coalesced query {i}: {ids} / direct {want_ids[i]}")
            np.testing.assert_allclose(d, want_d[i], rtol=1e-5)
        log(f"E coalesced == direct on {D_B} queries from {E_THREADS} threads: ids equal, "
            f"distances within rtol 1e-5")
        lat = []
        for _ in range(E_REPS):
            t1 = time.perf_counter()
            st, rep = http(port, "POST", "/v1/graphql/batch", body)
            lat.append(time.perf_counter() - t1)
        if ids_matrix([gql_rows(r) for r in rep]).tolist() != want_ids.tolist():
            raise AssertionError("E coalesced /v1/graphql/batch: answers differ from direct")
        p50_batch_c = float(np.median(lat))
        log(f"E REST /v1/graphql/batch of {D_B} queries with the coalescer (its slots run "
            f"concurrently into shared lanes): {['%.1f ms' % (t * 1e3) for t in lat]}, p50 "
            f"{p50_batch_c * 1e3:.2f} ms")

        st0 = app.coalescer.stats()
        lat_load: list[float] = []
        lock = threading.Lock()
        stop_at = time.perf_counter() + E_LOAD_S

        def load(t):
            i, mine = t, []
            while time.perf_counter() < stop_at:
                t1 = time.perf_counter()
                gql_rows(http(port, "POST", "/v1/graphql",
                              {"query": gql_near(q_all[i % BATCH])})[1])
                mine.append(time.perf_counter() - t1)
                i += E_THREADS
            with lock:
                lat_load.extend(mine)

        threads = [threading.Thread(target=load, args=(t,)) for t in range(E_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(E_LOAD_S / 3)
        st, text = http(port, "GET", "/debug/pprof/trace?seconds=1")
        for t in threads:
            t.join()
        load_s = time.perf_counter() - t0
        st1 = app.coalescer.stats()
        d_disp = st1["dispatches"] - st0["dispatches"]
        fill = (st1["rows"] - st0["rows"]) / max(d_disp, 1)
        qps = len(lat_load) / load_s
        p50_c, p99_c = (float(np.percentile(lat_load, p)) for p in (50, 99))
        log(f"E coalesced load: {E_THREADS} threads of single-query GraphQL nearVector for "
            f"{load_s:.1f} s: {len(lat_load)} requests, {qps:.0f} QPS, p50 {p50_c * 1e3:.2f} ms, "
            f"p99 {p99_c * 1e3:.2f} ms; {d_disp} dispatches, mean lane fill {fill:.1f} rows")
        trace_dir = text.splitlines()[0].split(" to ", 1)[1].strip()
        trace_file = os.path.join(trace_dir, "trace.json")
        with open(trace_file) as f:
            k1_events = f.read().count("F32Tile")
        log(f"E device trace through /debug/pprof/trace?seconds=1 during the load: {trace_file}, "
            f"{os.path.getsize(trace_file)} bytes, {k1_events} mentions of K1's kernel "
            f"(resident_kernel<F32Tile>)")
        if st != 200 or k1_events == 0:
            raise AssertionError("E device trace: no K1 launch in the trace")
        launches = gmin_scan.launches
        log(f"E K1 launches on the main path {launches}")
        if launches < E_REPS + 1:
            raise AssertionError(f"E: {launches} K1 launches on the main path")
        log(f"[{card}] E end to end ({D_N} objects, k={K}): import {D_N / import_s:.0f} "
            f"objects/s; REST GraphQL p50 {p50_rest * 1e3:.2f} ms p99 {p99_rest * 1e3:.2f} ms; "
            f"graphql/batch {D_B} p50 {p50_batch * 1e3:.2f} ms (coalesced "
            f"{p50_batch_c * 1e3:.2f} ms); gRPC BatchSearch {D_B} p50 "
            f"{grpc_out[D_B][0] * 1e3:.2f} ms, {BATCH} p50 {grpc_out[BATCH][0] * 1e3:.2f} ms "
            f"(raw lane); recall@10 REST {r_rest:.4f}, "
            f"batch {r_batch:.4f}, filter {r_filter:.4f}, gRPC "
            f"{'/'.join('%.4f' % v[1] for v in grpc_out.values())}; coalesced {qps:.0f} QPS p50 "
            f"{p50_c * 1e3:.2f} ms p99 {p99_c * 1e3:.2f} ms lane fill {fill:.1f}; restart "
            f"{restart_s:.2f} s; busy "
            + ", ".join(f"{k} {v[1] / v[0]:.1%}" for k, v in busy.items()))
        del x_dev
    finally:
        if client is not None:
            client.close()
        if gsrv is not None:
            gsrv.stop()
        if srv is not None:
            srv.stop()
        if app is not None:
            app.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err}


# -- the busy-share comparison -------------------------------------------------------

def busy_share(card, seed) -> dict:
    """A's and B1's sync p50 and device-busy share alone (`--busy-share`):
    the same data and configurations as workloads A and B1, through only
    the entry points every version of the port has (`new_vector_index`,
    `add_batch`, `update_user_config`, `search_by_vectors`), so that the
    index's host path of two checkouts compares on one card in turns. Per
    workload: the sync p50 of 5 batches after one warm-up, then BUSY_REPS
    profiled batches. -> {label: numbers}"""
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index

    out = {}
    for label, s, dim, conf in (("A", seed, DIM, {"distance": "l2-squared"}),
                                ("B1", seed + 1, PQ_DIM, pq_conf())):
        rng = np.random.default_rng(s)
        vecs = make_data(N, dim, rng)
        q = queries(vecs, rng, 1)[0]
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_busy_{label}_")
        try:
            if "pq" in conf:
                idx = pq_index(label, conf, tmp, vecs, declared=False)[0]
            else:
                idx = new_vector_index(parse_and_validate_config("hnsw_tpu", conf), tmp)
                idx.add_batch(np.arange(N), vecs)
            _, p50, _, _ = sync_batches(idx, q, 6)
            prof = [profile_sync_batch(lambda b: idx.search_by_vectors(b, K), q, card, label)
                    for _ in range(BUSY_REPS)]
            if any(p is None for p in prof):
                raise AssertionError(f"busy share {label}: the profiler saw no device time")
            out[label] = {"sync_p50_ms": p50 * 1e3, "busy": [p[0] for p in prof],
                          "device_ms": [p[1] for p in prof]}
            log(f"[{card}] {label} busy share: sync p50 {p50 * 1e3:.2f} ms; profiled batches "
                f"device {['%.2f ms' % p[1] for p in prof]}, busy "
                f"{['%.1f%%' % (100 * p[0]) for p in prof]}")
            idx.drop()
            del idx
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del vecs
        torch.cuda.empty_cache()
    return out


# -- workload C: the stage profiler at full width --------------------------------

def profiler_phase(dev, card, seed) -> list[dict]:
    """K4 and K5 against their plain versions and K1 at the profiler's
    default shape, the profiler's three modes with their launch counts, and
    the layout kernels' timings -> their rows of the kernels line."""
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.tools import profile_gmin as pg

    G = gmin_scan.G
    t0 = time.perf_counter()
    d = pg.make_data(PROF_N, BATCH, dev, torch.Generator(device=dev).manual_seed(seed + 2))
    torch.cuda.synchronize()
    log(f"C data: {PROF_N} x {pg.D} gaussian store, {BATCH} queries on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    ncols = d.ncols
    store3t = pg.transpose_store(d.store3)
    dead = dead_mask(PROF_N, ncols, PROF_N, np.random.default_rng(seed + 2), dev)
    biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
              for m, a, base in (("l2", -2.0, d.norms), ("dot", -1.0, torch.zeros_like(d.norms)))]
    del dead
    # kernel name -> (wrapper, plain version, layout of (store3t, bias2))
    kernels = {"nt_scores": (pg.nt_scores, pg.nt_scores_reference,
                             lambda b2: (store3t, b2))}
    iw = pg.INTERLEAVE_WIDTH
    for gc in (2, 4):
        kernels[f"c4_scores_gc{gc}"] = (
            lambda q, s4, b4, a, gc=gc: pg.c4_scores(q, s4, b4, a, iw, gc),
            lambda q, s4, b4, a, gc=gc: pg.c4_scores_reference(q, s4, b4, a, iw, gc),
            lambda b2, gc=gc: pg.interleave(store3t, b2, gc, iw))
    max_err = dict.fromkeys(kernels, 0.0)
    for b in (SLICE, BATCH):
        q_b = d.q[:b]
        for metric, alpha, bias2 in biases:
            k1 = gmin_scan.group_min_scores(q_b, d.store3, bias2, alpha)
            fin = torch.isfinite(k1)
            for name, (kernel, plain, layout) in kernels.items():
                x, bias = layout(bias2)
                got = kernel(q_b, x, bias, alpha)
                want = plain(q_b, x, bias, alpha)
                torch.cuda.synchronize()
                for ref_name, ref in (("plain", want), ("K1", k1)):
                    if not torch.equal(torch.isinf(got), torch.isinf(ref)):
                        raise AssertionError(f"{name} {metric} B={b}: the dead groups differ "
                                             f"from {ref_name}'s")
                    torch.testing.assert_close(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                err = float(torch.where(fin, got - want, 0.0).abs().max())
                err_k1 = float(torch.where(fin, got - k1, 0.0).abs().max())
                max_err[name] = max(max_err[name], err)
                log(f"{name} vs plain [{b} x {ncols}, 16 groups] {metric}: max abs err "
                    f"{err:.3e}, vs K1 {err_k1:.3e} (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); "
                    f"+inf groups per query {int((~fin[0]).sum())}")
                del got, want, x, bias
                torch.cuda.empty_cache()
            del k1, fin
    del biases
    torch.cuda.empty_cache()

    # the profiler's three modes, each count set to 0 just before them
    gmin_scan.launches = 0
    pg.nt_launches = 0
    pg.c4_launches.clear()
    t0 = time.perf_counter()
    stages = {}
    for mode in ("component", "gather", "loop"):
        log(f"C profile_gmin --mode {mode} N={PROF_N} B={BATCH} ITERS={PROF_ITERS}")
        stages[mode] = pg.profile(mode, d, PROF_ITERS)
        torch.cuda.empty_cache()
    launches = {"nt_scores": pg.nt_launches, "c4_scores_gc2": pg.c4_launches.get(2, 0),
                "c4_scores_gc4": pg.c4_launches.get(4, 0)}
    log(json.dumps({"profile_gmin_ms": stages, "card": card}))
    log(f"C profiler modes: {time.perf_counter() - t0:.1f} s; launches {launches}, "
        f"K1 {gmin_scan.launches}")
    for name, n in launches.items():
        if n != 1 + pg.REPS:
            raise AssertionError(f"{name}: {n} launches in the profiler's modes, want "
                                 f"{1 + pg.REPS} (warm-up + REPS)")

    # timings, l2, beside K1 on the same store and shape (K4 and K5 run
    # K1's tile and products, only their fill reads another layout), K1's
    # library yardstick and the bound
    bias2 = d.bias2
    k1_ms = cuda_ms(lambda: gmin_scan.group_min_scores(d.q, d.store3, bias2, -2.0), 3)
    log(f"[{card}] C K1 gmin_scan f32 on store3 B={BATCH} ncols={ncols} ag={G} D={pg.D}"
        f"{plan_note(pg.layout_plan(pg.D, G))}: {k1_ms:.3f} ms")
    store_bf = d.store.bfloat16()
    rows = []
    for name, (kernel, plain, layout) in kernels.items():
        x, bias = layout(bias2)
        row = time_kernel(
            name, card, lambda q, b, a, g: kernel(q, x, b, a),
            lambda q, b, a, g: plain(q, x, b, a),
            lambda q: torch.matmul(q.bfloat16(), store_bf.T), d.q, bias, ncols, G, pg.D,
            4.0 * pg.D, 0.0, f"bf16 matmul [Bx{pg.D}]x[{pg.D}x{PROF_N}]",
            detail=plan_note(pg.layout_plan(pg.D, G)))
        log(f"[{card}] {name} / K1 on the same store: {row['ms'] / k1_ms:.3f}")
        del x, bias
        torch.cuda.empty_cache()
        line = 118 if name == "nt_scores" else 147
        rows.append({"name": name, "route": "cuda",
                     "source": "weaviate_tpu_torch/csrc/gmin_layouts.cu",
                     "replaces": f"tools/profile_gmin.py:{line}",
                     "launches": launches[name], "max_abs_err": max_err[name], **row})
    del store_bf, store3t, d
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--busy-share", metavar="CHECKOUT",
                    help="run only A's and B1's sync p50 and busy share (BUSY_REPS "
                         "profiled batches each), with weaviate_tpu_torch imported from CHECKOUT, a "
                         "checkout of the repository (`.` for this one; another, such as a "
                         "parent commit unpacked with `git archive`, builds its kernels "
                         "into its own build/)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.busy_share:
        checkout = os.path.abspath(args.busy_share)
        sys.path.insert(0, checkout)
    import weaviate_tpu_torch  # fails here without the package beside the script
    if args.busy_share and not weaviate_tpu_torch.__file__.startswith(checkout + os.sep):
        raise RuntimeError(f"imported {weaviate_tpu_torch.__file__}, not from {checkout}")

    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # ground truth in full f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. card
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(card)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device {name}, capability {cap}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels target sm_90a; this card is sm_{cap[0]}{cap[1]}")

    # 2. build
    phase("build")
    build_kernels()

    if args.busy_share:
        phase(f"busy share of {checkout}")
        out = busy_share(card, args.seed)
        faulthandler.cancel_dump_traceback_later()
        print(json.dumps({"checkout": checkout, "card": card, "reps": BUSY_REPS, **out}),
              flush=True)
        return 0

    # 3-5. the workloads
    t0 = time.perf_counter()
    phase("workload A")
    k1_f32 = headline(dev, card, args.seed)
    log(f"workload A: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase("workload B")
    pq_rows = pq_workload(dev, card, args.seed)
    log(f"workload B: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase("workload A-bf16")
    a16 = headline_bf16(dev, card, args.seed)
    log(f"workload A-bf16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase("workload C")
    layout_rows = profiler_phase(dev, card, args.seed)
    log(f"workload C: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase("workload D")
    d_row = shard_workload(dev, card, args.seed)
    log(f"workload D: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase("workload E")
    e_row = app_workload(dev, card, args.seed)
    log(f"workload E: {time.perf_counter() - t0:.1f} s; "
        f"total {time.perf_counter() - t_start:.1f} s")

    # 6. result lines: K1's launches include D's and E's (the Shard's and
    # the App's main paths), K1-bf16's the bf16-store run's
    for row in (d_row, e_row):
        k1_f32["launches"] += row["launches"]
        k1_f32["max_abs_err"] = max(k1_f32["max_abs_err"], row["max_abs_err"])
    k1_bf16 = pq_rows[0]
    k1_bf16["launches"] += a16["launches"]
    k1_bf16["max_abs_err"] = max(k1_bf16["max_abs_err"], a16["max_abs_err"])
    faulthandler.cancel_dump_traceback_later()
    log(card)
    print(json.dumps({"kernels": [k1_f32, *pq_rows, *layout_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
