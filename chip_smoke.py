#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (weaviate_tpu_torch) on one NVIDIA card at
the headline scale, and check it.

    python3 chip_smoke.py [--seed 7]

The workload is the headline's: 1M x 128 f32 SIFT-shaped clustered
vectors, l2, k=10, 16384-query batches, through the `VectorIndex` seam a
shard calls (`new_vector_index` -> `add_batch` -> `search_by_vectors` /
`search_by_vectors_async`). Phases, in order; any failure raises and the
script exits non-zero:

1. card: name and power limit (nvidia-smi), compute capability 9.0;
2. build: the CUDA kernels, from the sources in this checkout;
3. kernel against its plain version at the main-path store, l2 and dot,
   with dead slots (tombstoned, past n, filtered out), on a 1024-query
   slice and on the whole 16384-query batch the main path launches;
4. main path: ingest, sync and pipelined async search with recall@10
   against exact f32 ground truth on queries spread over the whole
   batch, kernel launch counts, a large
   (masked-scan) and a small (gather-tier) allowList, 1000 deletes, and a
   restart that replays vector.log;
5. timings on the card: the kernel, its plain version, a library
   yardstick and the bound, at the 1024-query slice and the 16384-query
   main shape; end-to-end QPS and p50 batch latency;
6. one JSON line of per-kernel numbers, then the result line.

Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N, DIM, K, BATCH, N_CLUSTERS = 1_000_000, 128, 10, 16384, 1024
N_GT = 1024              # queries with exact ground truth
SLICE = 1024             # query rows of the kernel-vs-plain check
RECALL_BAR = 0.95        # BASELINE.json
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# kernel vs plain version: the same bf16 operands, summed in f32 in
# another order (tests/test_torch_ops.py states the same tolerance)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def make_data(n, dim, rng):
    """SIFT-like clustered distribution: a mixture of gaussians (the
    headline benchmark's generator)."""
    centers = rng.standard_normal((N_CLUSTERS, dim), dtype=np.float32) * 2.0
    assign = rng.integers(0, N_CLUSTERS, n)
    return centers[assign] + 0.35 * rng.standard_normal((n, dim), dtype=np.float32)


def exact_topk(q: torch.Tensor, x: torch.Tensor, k: int) -> np.ndarray:
    """Exact l2 top-k row indices in f32 on the card (TF32 off)."""
    d = (q * q).sum(1, keepdim=True) - 2.0 * (q @ x.T) + (x * x).sum(1)[None, :]
    return torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy()


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


def bound(b: int, ag: int, ncols: int, d: int) -> tuple[float, str]:
    """Least time for the group-min scan on these shapes: the larger of the
    operations at the bf16 peak and the bytes (q, live store slices, bias,
    output, each once) at the memory rate."""
    ops = 2.0 * b * ag * ncols * d
    nbytes = 4.0 * (b * d + ag * ncols * d + ag * ncols + b * ncols)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profile_sync_batch(idx, queries: np.ndarray, card: str) -> None:
    """Where one sync batch's device time goes: torch.profiler's kernel
    times (the device busy share is their sum over the batch's wall
    time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        idx.search_by_vectors(queries, K)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    if not kernels:
        log(f"[{card}] profile of one sync batch: the profiler saw no device time (not measured)")
        return
    log(f"[{card}] profile of one {len(queries)}-query sync batch: wall {wall_ms:.1f} ms, "
        f"device kernels {busy:.1f} ms ({busy / wall_ms:.0%} busy, "
        f"{1 - busy / wall_ms:.0%} idle)")
    for key, ms, count in kernels[:10]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:100]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index
    from weaviate_tpu_torch.ops import _kernels, gmin_scan
    from weaviate_tpu_torch.storage.bitmap import Bitmap

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # ground truth in full f32
    torch.backends.cudnn.allow_tf32 = False

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
    t0 = time.perf_counter()
    gmin_scan._gmin_lib()
    secs, out = _kernels.build_info.get("gmin_scan", (0.0, "(already built)"))
    log(f"build gmin_scan: {time.perf_counter() - t0:.2f} s (nvcc {secs:.2f} s)")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    vecs = make_data(N, DIM, rng)
    batches = [rng.standard_normal((BATCH, DIM), dtype=np.float32) * 0.1
               + vecs[rng.integers(0, N, BATCH)] for _ in range(2)]
    log(f"data: {N} x {DIM} vectors, 2 x {BATCH} queries in {time.perf_counter() - t0:.1f} s")

    # 3. kernel against its plain version at the main-path store
    capacity = 1 << 20
    ncols = capacity // gmin_scan.G
    ag = -(-N // ncols)
    store = torch.zeros((capacity, DIM), dtype=torch.float32, device=dev)
    store[:N] = torch.from_numpy(vecs).to(dev)
    sq = (store.double() ** 2).sum(1).float()
    dead = torch.arange(capacity, device=dev) >= N                      # past n
    dead[torch.from_numpy(rng.choice(N, 4000, replace=False)).to(dev)] = True  # tombstoned + filtered out
    # every member of 100 groups filtered out: their minima must stay +inf
    dead.view(gmin_scan.G, ncols)[:, torch.from_numpy(rng.choice(ncols, 100, replace=False)).to(dev)] = True
    store3 = store.view(gmin_scan.G, ncols, DIM)
    max_err = 0.0
    # the 1024-query slice, then the whole 16384-query batch the main path
    # launches (every query block of the kernel's grid)
    for b in (SLICE, BATCH):
        q_b = torch.from_numpy(batches[0][:b]).to(dev)
        for metric, alpha, base in (("l2", -2.0, sq), ("dot", -1.0, torch.zeros_like(sq))):
            bias2 = torch.where(dead, float("inf"), base).view(gmin_scan.G, ncols)
            got = gmin_scan.group_min_scores(q_b, store3, bias2, alpha, active_g=ag)
            want = gmin_scan.group_min_scores_reference(q_b, store3, bias2, alpha, ag)
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            if not torch.equal(torch.isinf(got), ~fin):
                raise AssertionError(f"{metric} B={b}: the kernel's dead groups differ "
                                     "from the plain version's")
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
            err = float(torch.where(fin, got - want, 0.0).abs().max())
            max_err = max(max_err, err)
            log(f"kernel vs plain [{b} x {ncols}, ag {ag}] {metric}: max abs err {err:.3e} "
                f"(rtol {KERNEL_RTOL}, atol {KERNEL_ATOL}); "
                f"+inf groups per query {int((~fin[0]).sum())}")
            del got, want, fin
            torch.cuda.empty_cache()
    l2_bias2 = torch.where(dead, float("inf"), sq).view(gmin_scan.G, ncols)

    # 4. main path
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cfg = parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
        idx = new_vector_index(cfg, tmp)
        t0 = time.perf_counter()
        idx.add_batch(np.arange(N), vecs)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        log(f"ingest: {N} rows in {ingest_s:.2f} s ({N / ingest_s:.0f} rows/s), "
            f"capacity {idx.capacity}")

        x_dev = torch.from_numpy(vecs).to(dev)
        # ground-truth queries spread over the whole batch
        gt_rows = np.arange(0, BATCH, BATCH // N_GT)
        f_rows = np.arange(0, BATCH, BATCH // 256)
        gt = exact_topk(torch.from_numpy(batches[0][gt_rows]).to(dev), x_dev, K)

        gmin_scan.launches = 0
        lat = []
        for _ in range(4):
            t0 = time.perf_counter()
            ids0, d0 = idx.search_by_vectors(batches[0], K)
            lat.append(time.perf_counter() - t0)
        sync_launches = gmin_scan.launches
        p50 = float(np.median(lat[1:]))  # the first call also builds the rescore blocks
        recall = recall_at_k(ids0[gt_rows].astype(np.int64), gt)
        log(f"sync: {BATCH}-query batches {['%.1f ms' % (t * 1e3) for t in lat]}; "
            f"recall@10 {recall:.4f} on {N_GT} queries; kernel launches {sync_launches}")
        if ids0.shape != (BATCH, K) or not np.isfinite(d0).all():
            raise AssertionError(f"sync result shape {ids0.shape} or non-finite distances")
        if recall < RECALL_BAR:
            raise AssertionError(f"recall@10 {recall:.4f} < {RECALL_BAR}")
        if sync_launches < 1:
            raise AssertionError("the sync searches never launched the gmin_scan kernel")

        gmin_scan.launches = 0
        n_pipe = 8
        t0 = time.perf_counter()
        pending, results = [], []
        for i in range(n_pipe):
            pending.append(idx.search_by_vectors_async(batches[i % 2], K))
            if len(pending) == 2:
                results.append(pending.pop(0)())
        results.extend(f() for f in pending)
        pipe_s = time.perf_counter() - t0
        async_launches = gmin_scan.launches
        qps = n_pipe * BATCH / pipe_s
        log(f"async (depth-2 pipeline): {n_pipe} x {BATCH} queries in {pipe_s:.3f} s = "
            f"{qps:.0f} QPS; kernel launches {async_launches}")
        if async_launches < n_pipe:
            raise AssertionError(f"{async_launches} kernel launches for {n_pipe} async batches")
        if not (np.array_equal(results[0][0], ids0) and np.array_equal(results[0][1], d0)):
            raise AssertionError("the async result differs from the sync result")

        gmin_scan.launches = 0
        allowed = np.arange(0, N, 3)
        ids_f, _ = idx.search_by_vectors(batches[0], K, allow_list=Bitmap(allowed))
        masked_launches = gmin_scan.launches
        if (ids_f.astype(np.int64) % 3 != 0).any() or masked_launches < 1:
            raise AssertionError("large allowList: a filtered-out id came back, or no kernel launch")
        q_f = torch.from_numpy(batches[0][f_rows]).to(dev)
        gt_f = exact_topk(q_f, x_dev[::3], K) * 3
        r_f = recall_at_k(ids_f[f_rows].astype(np.int64), gt_f)
        small = np.sort(rng.choice(N, 1000, replace=False))
        ids_s, _ = idx.search_by_vectors(batches[0], K, allow_list=Bitmap(small))
        gt_s = small[exact_topk(q_f, x_dev[torch.from_numpy(small).to(dev)], K)]
        r_s = recall_at_k(ids_s[f_rows].astype(np.int64), gt_s)
        log(f"allowList {len(allowed)} docs (masked scan, {masked_launches} kernel launch): "
            f"recall@10 {r_f:.4f}; allowList {len(small)} docs (gather tier): recall@10 {r_s:.4f}")
        if not np.isin(ids_s.astype(np.int64), small).all():
            raise AssertionError("small allowList: a filtered-out id came back")
        if r_f < RECALL_BAR or r_s < 0.99:
            raise AssertionError(f"filtered recall {r_f:.4f} / {r_s:.4f} below its bar")

        gone = np.unique(ids0[:, 0].astype(np.int64))[:1000]
        idx.delete(*gone.tolist())
        ids_d, d_d = idx.search_by_vectors(batches[0], K)
        if np.isin(ids_d.astype(np.int64), gone).any() or len(idx) != N - len(gone):
            raise AssertionError("a deleted id came back, or the live count is off")
        log(f"deleted {len(gone)} docs: none returned; live {len(idx)}")

        idx.shutdown()
        del idx
        t0 = time.perf_counter()
        idx = new_vector_index(cfg, tmp)
        ids_r, d_r = idx.search_by_vectors(batches[0], K)
        restart_s = time.perf_counter() - t0
        if not np.array_equal(ids_r, ids_d):
            raise AssertionError("answers after the restart differ from before it")
        np.testing.assert_allclose(d_r, d_d, rtol=1e-6)
        log(f"restart: replayed vector.log and answered the same in {restart_s:.2f} s")
        profile_sync_batch(idx, batches[0], card)
        idx.shutdown()
        del idx, x_dev
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # 5. timings
    rows = {}
    for b in (SLICE, BATCH):
        q_b = torch.from_numpy(batches[0][:b]).to(dev)
        ms = cuda_ms(lambda: gmin_scan.group_min_scores(q_b, store3, l2_bias2, -2.0, active_g=ag), 5)
        plain_ms = cuda_ms(lambda: gmin_scan.group_min_scores_reference(
            q_b, store3, l2_bias2, -2.0, ag), 2)
        q_bf, x_bf = q_b.bfloat16(), store.bfloat16()
        lib_ms = cuda_ms(lambda: torch.matmul(q_bf, x_bf.T), 3)
        del x_bf
        torch.cuda.empty_cache()
        bound_ms, bound_by = bound(b, ag, ncols, DIM)
        rows[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[{card}] gmin_scan B={b} ncols={ncols} ag={ag} D={DIM}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, library bf16 matmul [{b}x{DIM}]x[{DIM}x{capacity}] "
            f"{lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
            f"{bound_ms / ms:.1%} of bound")
    log(f"[{card}] end to end, {BATCH}-query batches, k={K}, n={N}: sync p50 {p50 * 1e3:.1f} ms, "
        f"pipelined {qps:.0f} QPS, ingest {N / ingest_s:.0f} rows/s, restart {restart_s:.2f} s")

    # 6. result lines
    main_row = rows[BATCH]
    print(json.dumps({"kernels": [{
        "name": "gmin_scan", "route": "cuda",
        "source": "weaviate_tpu_torch/csrc/gmin_scan.cu",
        "replaces": "weaviate_tpu/ops/gmin_scan.py:159",
        "launches": sync_launches + async_launches + masked_launches, "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
