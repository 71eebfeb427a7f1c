#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (weaviate_tpu_torch) on one NVIDIA card at
the headline scale and at the PQ configuration's, run its stage profiler
at full width, and check them.

    python3 chip_smoke.py [--seed 7]

Two workloads, each through the `VectorIndex` seam a shard calls
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

C. the stage profiler (`weaviate_tpu_torch.tools.profile_gmin`) at its
   default shape, N = 2^20 x 128 f32 gaussian, B = 16384: its component,
   gather and loop (ITERS 8) modes in-process, after K4 (`nt_scores`) and
   K5 (`c4_scores`, gc 2 and 4) are held against their plain versions and
   against K1 on the same data (dead slots and 100 whole dead groups); all
   three run K1's resident-tile scan with a depth-major filler, so they are
   timed beside K1 on the untransposed store at the same shape.

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
6. the card line, one JSON line of per-kernel numbers, the result line.

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
from concurrent.futures import ThreadPoolExecutor

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
WATCHDOG_S = 1140  # seconds: a run past this has stalled (a whole run takes ~200 s)
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


def profile_sync_batch(idx, q: np.ndarray, card: str, label: str) -> None:
    """Where one sync batch's device time goes: torch.profiler's kernel
    times (the device busy share is their sum over the batch's wall
    time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        idx.search_by_vectors(q, K)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log(f"[{card}] {label} profile: the profiler saw no device time (not measured)")
        return
    log(f"[{card}] {label} profile of one {len(q)}-query sync batch: wall {wall_ms:.1f} ms, "
        f"device kernels {busy:.1f} ms ({busy / wall_ms:.0%} busy, "
        f"{1 - busy / wall_ms:.0%} idle)")
    for key, ms, count in kernels[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:100]}")


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


def check_kernel(name, kernel, plain, q_all, biases, ncols, ag) -> float:
    """The kernel against its plain version at the main-path shapes, for
    each (metric, alpha, bias2): the 1024-query slice, then the whole
    16384-query batch. -> max abs error over finite scores."""
    max_err = 0.0
    for b in (SLICE, BATCH):
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
        profile_sync_batch(idx, batches[0], card, "A")
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
        profile_sync_batch(idx, batches[0], card, "B1")
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
        profile_sync_batch(idx, batches[0], card, "B2")
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
        profile_sync_batch(idx, batches[0], card, "B3")
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import weaviate_tpu_torch  # noqa: F401 — fails here without the package beside the script

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
    phase("workload C")
    layout_rows = profiler_phase(dev, card, args.seed)
    log(f"workload C: {time.perf_counter() - t0:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # 6. result lines
    faulthandler.cancel_dump_traceback_later()
    log(card)
    print(json.dumps({"kernels": [k1_f32, *pq_rows, *layout_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
