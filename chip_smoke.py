#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (weaviate_tpu_torch) on one NVIDIA card at
the headline scale and at the PQ configuration's, run its stage profiler
at full width, drive its Shard and its App (REST, GraphQL, gRPC, the
coalescer) at 2^17 objects, its IVF scan plane on the headline's generator,
its device BM25 engine on passage-length documents, its mesh index over
four slabs of the card, its module system (text2vec-local, t-SNE,
backups) behind the App, its native graph engine beside a card class, and
a three-node cluster of Apps on the card, and check them.

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
   After those checks, B2 and B3 switch IVF on (IVF_NLIST 2048,
   IVF_TRAIN_ITERS 2, the rest at their defaults: a cheaper host training
   than F's) and train it through the index's own write path (doc 0
   re-added): `search_ivf_codes` and `search_ivf_pq4` at D 768, B 256 p50
   and recall@10 printed, top_p = nlist on 16 queries against the flat
   tier (B2: the exact-ADC reconstruction scan, equal; B3: the flat
   funnel's overlap is printed, its stage 1 keeps column groups where the
   probed one keeps rows, and the answer is held, overlap >= 0.99, against
   the same funnel over one bucket of every row), and the 256-query
   card-vs-CPU check.
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
   class of 131,072 objects (2^17; 2^20 until F and G joined the run, 2^18
   until J and L did) with
   SIFT-shaped clustered vectors (the headline generator, D 128, seed + 3),
   l2, k=10, two properties (`tag`, text with 32 values, 4096 rows each:
   the gather tier; `bucket`, int 0-999, `bucket < 500` ~65k rows: the
   masked K1 scan), imported through
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
   created through REST `POST /v1/schema`, 131,072 objects with D's
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

F. the IVF scan plane (ops/ivf.py) on A's generator at 524,288 x 128 f32
   (seed 7; 1M until J and L joined the run: three host trainings were
   the run's longest phase), l2, uncompressed, with every IVF knob at its
   default (nlist auto 2048 here, top_p auto 128, no PCA), trained by the import through `add_batch`
   (the host training timed). Its main path: sync batches at B 256 (7
   runs) and B 16384 (3 runs), recall@10 >= 0.95 against exact f32 on 1024
   queries, probed_fraction; the same index's flat tier (K1, IVF off) at
   both sizes beside it, and one torch.profiler batch of each at 16384;
   fused == staged bit for bit; a masked allowList of half the rows
   (recall >= 0.95, every id in the list); 1000 deletes never returned;
   top_p = nlist on 16 queries equal to the exact tier (ids; distances
   rtol 1e-5); a restart whose replay retrains the same layout and
   answers the same; then a second index with IVF_PCA_DIM 32 (the
   prefilter): recall@10 >= 0.90 and its B 256 p50.

G. device BM25: a Shard with `invertedIndexConfig.bm25.device` and one
   text property `body`, 65,536 passage-length documents (50 words each,
   Zipf s = 1 over a 30,000-word vocabulary, seed + 9: the shape of MS
   MARCO passage ranking, cut from its 8.8M passages because the host's
   inverted-index import is slow) through `Shard.put_batch`; 256 queries
   of 2-8 words from the same distribution through `object_search` one
   at a time and through `keyword_search_batch` all at once, and 64 of
   them through the engine with allowLists of ~10% and ~60% of the rows.
   Every device answer agrees with the host MaxScore engine (scores rank
   by rank at rtol 1e-5, every id a genuine scorer at its level); the
   import rate, the p50 of one keyword query on each engine, the batch
   lane's p50 and its busy share are printed.

H. the mesh index (`hnsw_tpu_mesh`, index/mesh.py over
   parallel/mesh_search.py) over 4 slabs of the one card (`make_mesh(devices=
   [cuda:0] * 4)`; a second card also gets a run over all cards, and
   without one the script says that the distinct-card run was not made).
   First K1 launches under its tensor's device with another context
   current (`device_guard_check`). H1, A's data and configuration (seed 7,
   1M x 128, l2): import through `add_batch` (262,144 rows a slab), K1
   against its plain version on slab 0's store (B 256 and 16384), sync B
   16384 and B 256 with recall@10 >= 0.99 and exact f32 distances, 4 K1
   launches a dispatch, async == sync and fused == staged bit for bit, the
   two allowLists (masked scans: the mesh has no gather tier), 1000
   deletes, a profiled batch with one device->host copy, the cross-slab
   merge timed alone, then a restart of the directory onto 2 slabs
   (recall >= 0.99 against ground truth without the deleted docs) held
   against the single-device index on the same data and deletes (p50s
   beside, and A's). H2, the same over a bf16 store (K1-bf16, recall >=
   0.98). H3, B2's configuration (1M x 768, dot, M 96, C 256, codes only)
   restored from B2's vector.log and pq.npz (fitted here when B did not
   run): K2 against its plain version on slab 0, 4 K2 launches a
   dispatch, answers against B2's single-device ones (tie-aware >= 0.99),
   p50s beside B2's, a profiled batch.

I. the module system: an App on the card with ENABLE_MODULES=
   text2vec-local,ref2vec-centroid,backup-filesystem and the coalescer
   on; a `text2vec-local` class (D 256, cosine, one text property) of
   I_N texts of 8-16 words, Zipf(1.1) over a 30,000-word vocabulary
   (seed + 11), imported without vectors through REST `POST
   /v1/batch/objects` in batches of 1024 (the module vectorizes them);
   64 read-back vectors bit-equal to a fresh `LocalTextVectorizer`; K1
   held against its plain version on the App's store; single nearText
   requests (p50); its main path (K1's count set to 0 just before, read
   just after, > 0): 256 nearText queries as one `/v1/graphql/batch`, 5
   runs, recall@10 >= 0.99 against exact cosine over the store; one
   moveTo/moveAwayFrom query against its exact answer; featureProjection
   at limit 100 through GraphQL: its t-SNE ran on the card, the card's
   layout at 20 iterations within 1e-4 x spread of the CPU's and equal
   to a second card run bit for bit; `tsne_project` timed on the card
   and the CPU at n 100 and 1000, 100 and 2000 iterations, and profiled
   (its launches an iteration); a filesystem backup of the class, the
   class deleted and restored, 16 nearText answers equal to before.
J. the native graph engine beside the card: one App on the card with two
   classes over the same 131,072 x 128 rows (A's generator, seed + 13,
   l2), an "hnsw" class at Weaviate's documented defaults
   (maxConnections 64, efConstruction 128, ef -1: dynamic) and an
   "hnsw_tpu" class, imported through `app.batch`; the engine's insert
   rate over its first 16,384 rows (the rows halve while the whole build
   would take over 60 s: the native insert is serial); a batch of 256
   through `ClassIndex.object_vector_search` on each class (p50, the
   OpenMP threads of the graph's batch search), recall@10 against exact
   distances on the card (hnsw >= 0.95, hnsw_tpu >= 0.99); K1 held
   against its plain version on the hnsw_tpu store; its main path (K1's
   count 0 just before the hnsw_tpu batches, read after, > 0); the
   graph's snapshot plus a delta of re-added rows reopened by a fresh
   engine, and the App restarted, each answering as before bit for bit.
L. a three-node cluster of port Apps on the one card (CLUSTER_HOSTNAME,
   CLUSTER_JOIN with static peers, a data directory each, REST on every
   node, gRPC on node-0): L1, an hnsw_tpu class of 131,072 rows (A's
   generator, seed + 17, l2) over 3 shards at factor 1, imported over
   node-0's REST in batches of 1024 (L1 and L2 halve while the import
   would take over 90 s); K1 against its plain version on node-0's
   shard; its main path (K1's count 0 just before, read after, >= 3 a
   batch): a gRPC BatchSearch of 256 to node-0 that fans out to its
   shard and the two remote ones, recall@10 >= 0.99 against exact over
   every row, and the same 256 queries as one /v1/graphql/batch (one
   row per shard a query: the chunked scan); L2, one shard at factor 3,
   32,768 rows imported at QUORUM: GETs at ALL equal on every node;
   node-2 stopped and marked down: writes, a delete and reads at QUORUM
   served, a write at ALL refused (ReplicationError at the coordinator,
   500 over REST as the JAX App answers); node-2 back on its directory:
   reads at ALL repair it, the three replicas' digests equal, the
   deleted object stays deleted; a filesystem backup of L2 across the
   cluster, the class deleted and restored, 16 answers equal; then the
   BatchSearch's p50 beside one node holding the same rows.

    python3 chip_smoke.py --only F,G

runs only the named workloads (a subset of A,B,A16,C,D,E,F,G,H,I,J,L) and prints
no result lines: a quick card check of one part.

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
6. A-bf16, then D, then E, then F, then G, then H, then I, then J, then
   L (each names itself on stderr, and logs its seconds);
7. the card line, one JSON line of per-kernel numbers (K1's launches and
   max abs error include D's, E's, H1's, I's, J's and L's, K1-bf16's the A-bf16
   run's and H2's, K2's H3's), the result line.

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
# workload D: objects in the shard (2^20 until F and G joined the run, 2^18 until J and L)
D_N = 1 << 17
D_IMPORT = 10_000         # objects per Shard.put_batch
D_TAGS, D_BUCKETS = 32, 1000  # tag values (4096 rows each), bucket range
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
F_B, F_REPS, F_BIG_REPS = 256, 7, 3  # workload F: small batch; timed runs at B 256 and 16384
F_PCA_DIM, F_PCA_BAR = 32, 0.90  # F's prefilter index (tests/test_ivf.py:309's bar)
# B2's and B3's IVF layouts: half F's partitions and two k-means passes, so
# that two host trainings at D 768 fit the run's time beside F's three
B_IVF = {"nlist": 2048, "train_iters": 1}  # 2 iterations until J and L joined
F_N = 1 << 19  # workload F's rows (1M, A's, until J and L joined the run)
# workload G: documents (131072 until J and L joined the run), words each, vocabulary
G_N, G_WORDS, G_VOCAB = 65536, 50, 30000
G_Q, G_IMPORT = 256, 8192  # keyword queries (2-8 words); documents per Shard.put_batch
G_ALLOW_Q, G_BATCH_REPS = 64, 5  # queries per allowList; timed runs of the batch lane
H_SLABS = 4               # workload H: slabs of the mesh (one card named H_SLABS times)
H_B, H_REPS = 256, 7      # the small batch of A, B2 and H, and its timed runs
H_RECALL_BAR, H_BF16_BAR = 0.99, 0.98  # tests/test_recall_fixture.py's multi-device bar
# workload I: objects (2^18 until J and L joined the run), per REST batch
I_CLASS, I_N, I_IMPORT = "Passage", 1 << 17, 1024
I_VOCAB, I_ZIPF = 30000, 1.1  # words of the texts' vocabulary, Zipf exponent
I_Q, I_ONE_REQS, I_REPS = 256, 32, 5  # nearText batch, single requests, timed batches
I_READBACK = 64           # vectors read back and held against a fresh vectorizer
I_TSNE = ((100, 100), (100, 2000), (1000, 100), (1000, 1000))  # t-SNE timings: n, iterations
# workload J: the native graph engine ("hnsw", Weaviate's documented defaults:
# entities/vectorindex/hnsw/config.go:33-49) beside an "hnsw_tpu" class
J_GRAPH, J_CARD, J_N, J_IMPORT = "GraphRow", "CardRow", 131072, 8192
J_HNSW = {"distance": "l2-squared", "maxConnections": 64, "efConstruction": 128, "ef": -1}
J_TIMED, J_BUILD_S = 16384, 60.0  # rows timed first; J_N halves while the engine would take longer
J_B, J_REPS, J_DELTA = 256, 5, 1024  # batch, timed runs, rows re-added after the snapshot
J_GRAPH_BAR, J_CARD_BAR = 0.95, 0.99  # recall@10 bars of the hnsw and hnsw_tpu classes
# workload L: three port nodes on one card (Weaviate's replication
# architecture: factor 3, consistency ONE / QUORUM / ALL)
L1, L2, L1_N, L2_N = "ScatterRow", "ReplicaRow", 131072, 32768
L_IMPORT, L_TIMED, L_IMPORT_S = 1024, 16384, 90.0  # REST batch; timed rows; import limit
L_B, L_REPS, L_GQL_REPS = 256, 5, 3  # BatchSearch width, timed batches; /v1/graphql/batch runs
L_RECALL_BAR, L_CHECKS = 0.99, 32  # recall@10 bar; objects checked across replicas
L_ALL_REFUSED = 500  # what the JAX App's REST answers for a ReplicationError
BUSY_REPS = 3             # profiled batches per workload of --busy-share
WATCHDOG_S = 1140  # seconds: a run past this has stalled (a whole run takes ~820 s on an H100 at 700 W)
T_START = time.perf_counter()
WANTED: set = set()  # the workloads this run drives (main sets it)
SHARED: dict = {}    # what a workload hands a later one: A's and B2's p50s, B2's answers and files


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
        _, p50_256, _, _ = sync_batches(idx, batches[0][:H_B], H_REPS)
        SHARED["A"] = {"p50": p50 * 1e3, "p50_256": p50_256 * 1e3}

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
        _, p50_256, _, _ = sync_batches(idx, batches[0][:H_B], H_REPS)
        SHARED["B2"] = {"q": q_cpu, "ids": card_ids, "d": card_d, "p50": p50 * 1e3,
                        "p50_256": p50_256 * 1e3}
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
        phase("B2 IVF")
        ivf_compressed("B2", card, idx, vecs, batches[0][gt_rows], gt, q_cpu, True)
        keep["k2"] = (codes3.clone(), cb.clone(), biases[0][2], ncols, ag)
        out["k2"] = dict(launches=launches, max_abs_err=err)
        idx.shutdown()
        del idx, snap, codes3, biases
        if "H" in WANTED:
            SHARED["B2_dir"] = tmp  # H opens its mesh on this directory's files
    finally:
        if "B2_dir" not in SHARED:
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
        phase("B3 IVF")
        ivf_compressed("B3", card, idx, vecs, batches[0][gt_rows], gt, q_cpu, False)
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
    """The Shard over the port's index at D_N objects: import, the
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
        # filters: one tag value (4096 rows < flatSearchCutoff 40000: the
        # gather tier) and bucket < 500 (~65k rows: the masked scan)
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


def gql_near(q, where: str = "", cls: str = E_CLASS) -> str:
    """A GraphQL Get nearVector k=K over a class (E's by default), ids and
    distances."""
    return ("{ Get { %s(nearVector: {vector: %s}, limit: %d%s) { _additional { id distance } } } }"
            % (cls, json.dumps([round(float(v), 7) for v in q]), K, where))


def gql_rows(reply, cls: str = E_CLASS) -> tuple[list[int], list[float]]:
    """A GraphQL Get reply -> (doc ids, distances); an error raises."""
    if reply.get("errors"):
        raise AssertionError(f"{cls} GraphQL: {reply['errors']}")
    rows = reply["data"]["Get"][cls]
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


# -- workload F: the IVF scan plane on A's data ---------------------------------------

def use_ivf(enabled=True, **kw) -> None:
    """Set the process-wide IVF settings (index/gpu.set_ivf_config): on
    with the given knobs (the rest at their defaults), or off."""
    from weaviate_tpu_torch.config.config import IvfConfig
    from weaviate_tpu_torch.index import gpu
    gpu.set_ivf_config(IvfConfig(enabled=enabled, **kw))


def timed_training(idx) -> list:
    """Wrap the index's training pass to record its seconds (the write path
    that runs it stays the index's own)."""
    secs, train = [], idx._ivf_train_locked

    def timed(s):
        t0 = time.perf_counter()
        train(s)
        secs.append(time.perf_counter() - t0)

    idx._ivf_train_locked = timed
    return secs


def p50_ms(lat) -> float:
    return float(np.median(lat[1:])) * 1e3


def batch_runs(idx, q, reps):
    """reps sync batches of q -> (latencies s, last ids, last dists)."""
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ids, d = idx.search_by_vectors(q, K)
        lat.append(time.perf_counter() - t0)
    return lat, ids, d


def in_blocks(idx, q, rows):
    """q through the index in `rows`-query batches -> (ids, dists)."""
    parts = [idx.search_by_vectors(q[i:i + rows], K) for i in range(0, len(q), rows)]
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])


def same_answers(label, ids, d, want_ids, want_d, atol=0.0) -> None:
    if not np.array_equal(ids, want_ids):
        bad = int((ids != want_ids).any(1).sum())
        raise AssertionError(f"{label}: ids differ in {bad} of {len(ids)} rows")
    np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=atol, err_msg=label)


def ivf_workload(dev, card, seed) -> None:
    """The IVF plane (ops/ivf.py) on A's generator at F_N x 128 f32, l2,
    every IVF knob at its default (nlist auto, top_p auto, no
    PCA), trained by the import through `add_batch`. The main path at B 256
    and B 16384 beside the flat tier of the same index; recall, fused ==
    staged, a masked allowList, deletes, top_p = nlist == the exact tier,
    restart; then a second index with the PCA prefilter (IVF_PCA_DIM 32)."""
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import gpu, new_vector_index
    from weaviate_tpu_torch.storage.bitmap import Bitmap

    rng = np.random.default_rng(seed)  # A's generator
    vecs = make_data(F_N, DIM, rng)
    batches = queries(vecs, rng)
    q_big = batches[0]
    gt_rows = np.arange(0, BATCH, BATCH // N_GT)
    q_gt = q_big[gt_rows]
    q256 = q_gt[:F_B]
    x_dev = torch.from_numpy(vecs).to(dev)
    gt = exact_topk(torch.from_numpy(q_gt).to(dev), x_dev, K)
    cfg = parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_f_")
    use_ivf()
    out = {}
    try:
        idx = new_vector_index(cfg, tmp)
        train_s = timed_training(idx)
        t0 = time.perf_counter()
        idx.add_batch(np.arange(F_N), vecs)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        h = idx.health()["ivf"]
        if not h["trained"] or len(train_s) != 1:
            raise AssertionError(f"F: the import did not train one layout ({h})")
        nlist, cap_p = h["nlist"], h["bucket_capacity"]
        plan = idx._ivf_plan(idx._read_snapshot(), K)
        log(f"F import: {F_N} rows through add_batch with IVF on, {import_s:.2f} s, of which the "
            f"host training (k-means on {min(F_N, 65536)} rows, balanced assignment of {F_N}, "
            f"buckets) {train_s[0]:.2f} s; nlist {nlist}, bucket capacity {cap_p}, top_p "
            f"{plan[0]}, fill {h['buckets']['fill_min']}-{h['buckets']['fill_max']} "
            f"(padding waste {h['buckets']['padding_waste']:.1%})")

        # the main path: B 256 and B 16384 through the IVF plane
        phase("F main path")
        lat256, ids256, d256 = batch_runs(idx, q256, F_REPS)
        lat_big, ids_big, d_big = batch_runs(idx, q_big, F_BIG_REPS)
        st = idx.ivf_stats()
        recall = recall_at_k(ids_big[gt_rows].astype(np.int64), gt)
        if ids_big.shape != (BATCH, K) or not np.isfinite(d_big).all():
            raise AssertionError(f"F: result {ids_big.shape} or non-finite distances")
        if recall < RECALL_BAR or st["dispatches"] != F_REPS + F_BIG_REPS:
            raise AssertionError(f"F: recall@10 {recall:.4f} < {RECALL_BAR} or "
                                 f"{st['dispatches']} IVF dispatches")
        out.update(ivf256=p50_ms(lat256), ivf_big=p50_ms(lat_big), recall=recall,
                   probed=st["probed_fraction"])
        log(f"F IVF sync: B {F_B} {['%.1f ms' % (t * 1e3) for t in lat256]}, B {BATCH} "
            f"{['%.1f ms' % (t * 1e3) for t in lat_big]}; recall@10 {recall:.4f} vs exact f32 "
            f"on {N_GT} queries; probed_fraction {st['probed_fraction']}")
        staged_batches(idx, q256, 3, ids256, d256, "F")
        busy_ivf = profile_sync_batch(lambda q: idx.search_by_vectors(q, K), q_big, card,
                                      f"F IVF B {BATCH}")

        # the same index's flat tier at the same batch sizes, IVF toggled off
        use_ivf(False)
        lat256_f, _, _ = batch_runs(idx, q256, F_REPS)
        lat_big_f, ids_f, _ = batch_runs(idx, q_big, F_BIG_REPS)
        busy_flat = profile_sync_batch(lambda q: idx.search_by_vectors(q, K), q_big, card,
                                       f"F flat B {BATCH}")
        recall_f = recall_at_k(ids_f[gt_rows].astype(np.int64), gt)
        use_ivf()
        out.update(flat256=p50_ms(lat256_f), flat_big=p50_ms(lat_big_f), recall_flat=recall_f)
        log(f"F flat tier (K1) on the same index: B {F_B} "
            f"{['%.1f ms' % (t * 1e3) for t in lat256_f]}, B {BATCH} "
            f"{['%.1f ms' % (t * 1e3) for t in lat_big_f]}; recall@10 {recall_f:.4f}")

        # a masked allowList of half the rows: through the probe's mask
        allowed = np.arange(0, F_N, 2)
        ids_a, _ = idx.search_by_vectors(q_gt, K, allow_list=Bitmap(allowed))
        if (ids_a.astype(np.int64) % 2 != 0).any():
            raise AssertionError("F: a filtered-out id came back")
        gt_a = exact_topk(torch.from_numpy(q_gt).to(dev), x_dev[::2], K) * 2
        r_a = recall_at_k(ids_a.astype(np.int64), gt_a)
        if r_a < RECALL_BAR:
            raise AssertionError(f"F: allowList recall@10 {r_a:.4f} < {RECALL_BAR}")
        log(f"F allowList {len(allowed)} docs (the probe's mask): recall@10 {r_a:.4f}; "
            "every id in the list")

        # top_p = nlist on 16 queries: the exact tier's answer
        q16 = q_gt[:16]
        use_ivf(top_p=nlist)
        if idx._ivf_plan(idx._read_snapshot(), K)[0] != nlist:
            raise AssertionError("F: top_p = nlist did not probe every partition")
        ids_all, d_all = idx.search_by_vectors(q16, K)
        use_ivf(False)
        ids_x, d_x = in_blocks(idx, q16, 4)  # batches under 8 rows: the exact tier
        use_ivf()
        same_answers("F top_p = nlist vs the exact tier", ids_all, d_all, ids_x, d_x)
        log("F top_p = nlist on 16 queries: ids equal the exact tier's, distances within "
            "rtol 1e-5")

        ids_d, d_d = delete_check(idx, ids_big, q_big, F_N, "F")
        buckets = idx._read_snapshot().ivf_buckets.cpu()
        ids_d256, d_d256 = idx.search_by_vectors(q256, K)
        idx.shutdown()
        del idx
        t0 = time.perf_counter()
        idx = new_vector_index(cfg, tmp)
        train_r = timed_training(idx)
        ids_r, d_r = idx.search_by_vectors(q256, K)
        restart_s = time.perf_counter() - t0
        if not torch.equal(idx._read_snapshot().ivf_buckets.cpu(), buckets):
            raise AssertionError("F: the restart retrained another layout")
        same_answers("F restart", ids_r, d_r, ids_d256, d_d256)
        log(f"F restart: replayed vector.log, retrained the same layout ({train_r[0]:.2f} s of "
            f"training) and answered the same, {restart_s:.2f} s in all")
        out.update(train=train_s[0], restart=restart_s)
        idx.shutdown()
        del idx
        shutil.rmtree(tmp, ignore_errors=True)

        # the PCA prefilter: a second index on the same data
        phase("F prefilter")
        use_ivf(pca_dim=F_PCA_DIM)
        idx = new_vector_index(cfg, tmp)
        train_p = timed_training(idx)
        idx.add_batch(np.arange(F_N), vecs)
        snap = idx._read_snapshot()
        top_p, pre_c = idx._ivf_plan(snap, K)
        if snap.ivf_pca_rows is None or not pre_c:
            raise AssertionError("F prefilter: no PCA rows or no prefilter cut")
        lat_p, _, _ = batch_runs(idx, q256, F_REPS)
        ids_p, _ = in_blocks(idx, q_gt, F_B)
        r_p = recall_at_k(ids_p.astype(np.int64), gt)
        if r_p < F_PCA_BAR:
            raise AssertionError(f"F prefilter recall@10 {r_p:.4f} < {F_PCA_BAR}")
        log(f"F prefilter (IVF_PCA_DIM {F_PCA_DIM}): training {train_p[0]:.2f} s, top_p "
            f"{top_p}, {pre_c} survivors of {top_p * snap.ivf_meta[1]} candidates; B {F_B} "
            f"{['%.1f ms' % (t * 1e3) for t in lat_p]}; recall@10 {r_p:.4f} on {N_GT} queries")
        out.update(pca256=p50_ms(lat_p), recall_pca=r_p)
        idx.shutdown()
        del idx, snap
        log(f"[{card}] F end to end, k={K}, n={F_N}: IVF sync p50 B {F_B} {out['ivf256']:.1f} ms "
            f"vs flat {out['flat256']:.1f} ms, B {BATCH} {out['ivf_big']:.1f} ms vs flat "
            f"{out['flat_big']:.1f} ms; recall@10 {out['recall']:.4f} (flat "
            f"{out['recall_flat']:.4f}); probed_fraction {out['probed']}; busy IVF "
            f"{'not measured' if busy_ivf is None else f'{busy_ivf[0]:.1%}'}, flat "
            f"{'not measured' if busy_flat is None else f'{busy_flat[0]:.1%}'}; training "
            f"{out['train']:.2f} s; restart {out['restart']:.2f} s; prefilter B {F_B} "
            f"{out['pca256']:.1f} ms at recall@10 {out['recall_pca']:.4f}")
    finally:
        gpu.set_ivf_config(None)
        shutil.rmtree(tmp, ignore_errors=True)
    del x_dev
    torch.cuda.empty_cache()


def ivf_compressed(label, card, idx, vecs, q_gt, gt, q_cpu, exact_ref) -> None:
    """IVF over a compressed index of workload B (B_IVF's knobs), trained
    through the index's own write path (a write after the settings turn
    on: doc 0 re-added with its own vector), at D 768: B 256 p50 and recall, top_p =
    nlist on 16 queries against the flat tier, and 256 queries against
    the same op on CPU copies of the snapshot. exact_ref says how the top_p
    = nlist answer is held: True for the codes tier (equal to the flat
    reconstruction scan's exact-ADC answer, batches under 8 rows), False
    for the funnel (its flat stage 1 keeps whole column groups and the
    probed one single rows, so the two differ by design at this scale:
    the flat overlap is printed, and the answer is held against the same
    funnel over one bucket of every row, overlap >= 0.99: its stage-2
    products may sum in another order)."""
    from weaviate_tpu_torch.index import gpu
    from weaviate_tpu_torch.ops import ivf as ivf_ops
    from weaviate_tpu_torch.ops import pq4

    use_ivf(**B_IVF)
    try:
        train_s = timed_training(idx)
        idx.add(0, vecs[0])  # the write that trains, the same doc and vector
        idx.flush()
        snap = idx._read_snapshot()
        if snap.ivf_buckets is None or len(train_s) != 1:
            raise AssertionError(f"{label} IVF: the write did not train a layout")
        nlist, cap_p, _ = snap.ivf_meta
        top_p, pre_c = idx._ivf_plan(snap, K)
        before = idx.ivf_stats()["dispatches"]
        lat, _, _ = batch_runs(idx, q_gt[:F_B], F_REPS)
        ids, d = in_blocks(idx, q_gt, F_B)
        recall = recall_at_k(ids.astype(np.int64), gt)
        if idx.ivf_stats()["dispatches"] - before != F_REPS + len(q_gt) // F_B:
            raise AssertionError(f"{label} IVF: the batches did not take the IVF plane")
        log(f"{label} IVF: trained through the write path in {train_s[0]:.2f} s (nlist {nlist}, "
            f"bucket capacity {cap_p}, top_p {top_p}); B {F_B} "
            f"{['%.1f ms' % (t * 1e3) for t in lat]}; recall@10 {recall:.4f} vs exact f32 on "
            f"{len(q_gt)} queries (printed); probed_fraction "
            f"{idx.ivf_stats()['probed_fraction']}")

        q16 = q_gt[:16]
        use_ivf(top_p=nlist, **B_IVF)
        ids_all, d_all = idx.search_by_vectors(q16, K)
        use_ivf(False)
        if exact_ref:
            ids_x, d_x = in_blocks(idx, q16, 4)
            what = "the flat tier's answer (the exact-ADC reconstruction scan)"
        else:
            flat_ids, flat_d = idx.search_by_vectors(q16, K)
            log(f"{label} IVF top_p = nlist on 16 queries: "
                f"{tie_aware_hits(ids_all, d_all, flat_ids, flat_d):.4f} of the flat funnel's "
                f"answer (no bar: its stage 1 keeps {idx._funnel_budgets(K, snap.capacity)[0]} "
                "column groups, the probed one single rows)")
            ids_x, d_x = one_bucket_funnel(idx, snap, q16, nlist * cap_p)
            what = "the answer of the same funnel over one bucket of every row"
        use_ivf(**B_IVF)
        hits = tie_aware_hits(ids_all, d_all, ids_x, d_x)
        for row in range(len(q16)):  # the distances of the ids both return
            _, ci, pi = np.intersect1d(ids_all[row], ids_x[row], return_indices=True)
            np.testing.assert_allclose(d_all[row, ci], d_x[row, pi], rtol=1e-5, atol=1e-4)
        if hits < (1.0 if exact_ref else 0.99):
            raise AssertionError(f"{label} IVF top_p = nlist: {hits:.4f} of {what}")
        log(f"{label} IVF top_p = nlist on 16 queries: {hits:.4f} of {what} "
            "(tie-aware), shared ids' distances within rtol 1e-5")

        card_ids, card_d = idx.search_by_vectors(q_cpu, K)
        qb, gp, steps2 = ivf_ops.plan_steps(len(q_cpu), cap_p, snap.dim, top_p, second=pre_c)
        cpu = {name: getattr(snap, name).cpu() for name in (
            "codes", "recon_norms", "tombs", "slot_to_doc_dev", "ivf_centroids", "ivf_buckets")}
        q_c = torch.from_numpy(q_cpu)
        pq8 = snap.pq
        if snap.codes4 is None:
            cpu_fn = lambda: ivf_ops.search_ivf_codes_fused(  # noqa: E731
                cpu["codes"], cpu["recon_norms"], cpu["tombs"], snap.n, q_c, None,
                pq8.codebook_dev().cpu(), cpu["ivf_centroids"], cpu["ivf_buckets"], None, None,
                None if pq8.rotation_dev() is None else pq8.rotation_dev().cpu(),
                cpu["slot_to_doc_dev"], K, "dot", False, top_p, pre_c, gp, steps2, qb=qb)
        else:
            rg4, rc = idx._funnel_budgets(K, top_p * cap_p)
            c1 = min(rg4 * 16, top_p * cap_p)
            qb, gp, steps2 = ivf_ops.plan_steps(len(q_cpu), cap_p, snap.dim, top_p, second=c1)
            rot = snap.pq4.rotation_dev()
            cpu_fn = lambda: pq4.search_ivf_pq4_fused(  # noqa: E731
                snap.codes4.cpu(), cpu["codes"], snap.recon_norms4.cpu(), cpu["recon_norms"],
                cpu["tombs"], snap.n, q_c, None, snap.pq4.codebook_dev().cpu(),
                pq8.codebook_dev().cpu(), cpu["ivf_centroids"], cpu["ivf_buckets"],
                None if rot is None else rot.cpu(), snap.rescore_dev.cpu(),
                cpu["slot_to_doc_dev"], K, "dot", False, top_p, c1, rc, gp, steps2, qb=qb)
        cpu_twin_check(f"{label} IVF", card_ids, card_d, cpu_fn)
        log(f"[{card}] {label} IVF end to end, D {snap.dim}: B {F_B} sync p50 "
            f"{p50_ms(lat):.1f} ms, recall@10 {recall:.4f}, training {train_s[0]:.2f} s")
        del snap, cpu
    finally:
        gpu.set_ivf_config(None)


def one_bucket_funnel(idx, snap, q, r_cand):
    """The probed 4-bit funnel (ops/pq4.search_ivf_pq4) over one bucket that
    holds every slot below n, with the stage budgets the index gives a
    probe of r_cand candidates: what top_p = nlist must answer, since the
    buckets partition those slots and every selection is exact. ->
    (ids, dists) of the q rows."""
    from weaviate_tpu_torch.ops import ivf as ivf_ops
    from weaviate_tpu_torch.ops import pq4
    from weaviate_tpu_torch.ops.topk import unpack_fused

    dev = snap.codes4.device
    rg4, rc = idx._funnel_budgets(K, r_cand)
    c1 = min(rg4 * 16, r_cand)
    bucket = torch.arange(snap.n, dtype=torch.int32, device=dev)[None, :]
    centroid = torch.zeros((1, snap.dim), dtype=torch.float32, device=dev)
    qb, gp, steps2 = ivf_ops.plan_steps(len(q), snap.n, snap.dim, 1, second=c1)
    packed = pq4.search_ivf_pq4_fused(
        snap.codes4, snap.codes, snap.recon_norms4, snap.recon_norms, snap.tombs, snap.n,
        torch.from_numpy(np.ascontiguousarray(q)).to(dev), None, snap.pq4.codebook_dev(),
        snap.pq.codebook_dev(), centroid, bucket, snap.pq4.rotation_dev(), snap.rescore_dev,
        snap.slot_to_doc_dev, K, "dot", False, 1, c1, rc, gp, steps2, qb=qb)
    ids, dists = unpack_fused(packed.cpu().numpy())
    return ids, dists


# -- workload G: device BM25 on passage-length documents --------------------------------

def zipf_words(rng, count):
    """count word ids, Zipf (s = 1) over the G_VOCAB-word vocabulary."""
    ranks = np.arange(1, G_VOCAB + 1, dtype=np.float64)
    return rng.choice(G_VOCAB, size=count, p=(1.0 / ranks) / (1.0 / ranks).sum())


def bm25_agree(label, got, want_scores, truth) -> None:
    """The tie-aware rule: device scores equal the host engine's rank by
    rank (rtol 1e-5), and every device id is a genuine scorer at its level
    (its host score equals the device score)."""
    if len(got) != len(want_scores):
        raise AssertionError(f"{label}: {len(got)} hits, the host engine {len(want_scores)}")
    np.testing.assert_allclose([s for _, s, _ in got], want_scores, rtol=1e-5, err_msg=label)
    np.testing.assert_allclose([truth[d] for d, _, _ in got], [s for _, s, _ in got],
                               rtol=1e-5, err_msg=label)


def bm25_workload(dev, card, seed) -> None:
    """The Shard with `invertedIndexConfig.bm25.device`: G_N passage-length
    documents (G_WORDS words, Zipf over G_VOCAB) imported through
    `Shard.put_batch`; 256 queries of 2-8 words through `object_search`
    (one at a time) and `keyword_search_batch` (all 256), and through the
    engine with allowLists of ~10% and ~60% of the rows; every device
    answer held against the host MaxScore engine (tie-aware)."""
    from weaviate_tpu_torch.db.shard import Shard
    from weaviate_tpu_torch.entities.schema import ClassDef, Property
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.inverted.bm25_device import DeviceBM25
    from weaviate_tpu_torch.storage.bitmap import Bitmap

    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    vocab = np.array([f"w{i}" for i in range(G_VOCAB)])
    words = vocab[zipf_words(rng, G_N * G_WORDS)].reshape(G_N, G_WORDS)
    bodies = [" ".join(row) for row in words]
    lens = rng.integers(2, 9, G_Q)
    qwords = vocab[zipf_words(rng, int(lens.sum()))]
    cuts = np.cumsum(lens)[:-1]
    qtexts = [" ".join(p) for p in np.split(qwords, cuts)]
    del words
    log(f"G data: {G_N} documents of {G_WORDS} words (Zipf s = 1 over {G_VOCAB}), {G_Q} "
        f"queries of 2-8 words in {time.perf_counter() - t0:.1f} s")
    cd = ClassDef(name="Passage", properties=[Property(name="body", data_type=["text"])],
                  vector_index_type="noop")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_g_")
    shard = None
    try:
        shard = Shard("shard0", tmp, cd, parse_and_validate_config("noop", {}),
                      invert_cfg={"bm25": {"device": True}}, store_opts=D_STORE_OPTS,
                      device=dev)
        engine = shard.bm25_device
        if not isinstance(engine, DeviceBM25) or engine.device != dev:
            raise AssertionError(f"G: the Shard's engine is {engine!r}")
        t0 = time.perf_counter()
        for s in range(0, G_N, G_IMPORT):
            objs = [StorObj(class_name="Passage", uuid=str(uuidlib.UUID(int=i + 1)),
                            properties={"body": bodies[i]}) for i in range(s, min(s + G_IMPORT,
                                                                                  G_N))]
            errs = shard.put_batch(objs)
            if any(e is not None for e in errs):
                raise AssertionError(f"G import: {next(e for e in errs if e is not None)!r}")
        shard.flush()
        shard.store.flush_memtables()
        import_s = time.perf_counter() - t0
        log(f"G import: {G_N} documents through Shard.put_batch in batches of {G_IMPORT}, "
            f"flushed: {import_s:.1f} s, {G_N / import_s:.0f} documents/s")

        # the main path: one keyword object_search at a time, then the batch lane
        phase("G main path")
        host = shard.bm25
        n_docs = max(host._doc_count(), 1)
        props = host._searchable_props(None)

        def truth(q, allow=None):
            units = host._build_units(q, props, n_docs)
            ids, scores = host._rank(units, 1 << 30, allow, prune=False)
            return {int(d): float(v) for d, v in zip(ids, scores)}

        t_dev, dev_hits = [], []
        for q in qtexts:
            t1 = time.perf_counter()
            res = shard.object_search(K, keyword_ranking={"query": q})
            t_dev.append(time.perf_counter() - t1)
            dev_hits.append([(int(r.obj.doc_id), float(r.score), None) for r in res])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch = shard.keyword_search_batch(qtexts, K)
        t_batch = [time.perf_counter() - t1]
        for _ in range(G_BATCH_REPS - 1):
            t1 = time.perf_counter()
            shard.keyword_search_batch(qtexts, K)
            t_batch.append(time.perf_counter() - t1)
        shard.bm25_device = None  # the host MaxScore engine on the same shard
        t_host, host_hits = [], []
        for q in qtexts:
            t1 = time.perf_counter()
            res = shard.object_search(K, keyword_ranking={"query": q})
            t_host.append(time.perf_counter() - t1)
            host_hits.append([float(r.score) for r in res])
        shard.bm25_device = engine
        for i, q in enumerate(qtexts):
            tr = truth(q)
            bm25_agree(f"G query {i}", dev_hits[i], host_hits[i], tr)
            bm25_agree(f"G batch query {i}", [(int(r.obj.doc_id), float(r.score), None)
                                              for r in batch[i]], host_hits[i], tr)
        log(f"G {G_Q} keyword queries (k={K}): the device engine's object_search, its batch lane "
            f"and the host engine agree (tie-aware, rtol 1e-5); non-empty answers "
            f"{sum(1 for h in dev_hits if h)} of {G_Q}")

        # allowLists of ~10% and ~60% of the rows, through the engine
        for share in (0.1, 0.6):
            allow = Bitmap(np.flatnonzero(rng.random(G_N) < share).astype(np.uint64))
            for i, q in enumerate(qtexts[:G_ALLOW_Q]):
                got = engine.search(q, K, allow_list=allow)
                want = [s for _, s, _ in host.search(q, K, allow_list=allow)]
                bm25_agree(f"G allowList {share:.0%} query {i}", got, want, truth(q, allow))
                if any(not allow.contains(d) for d, _, _ in got):
                    raise AssertionError(f"G allowList {share:.0%}: a filtered-out id came back")
            log(f"G allowList of {len(allow)} docs ({share:.0%}): {G_ALLOW_Q} queries agree "
                "with the host engine; every id in the list")
        busy = profile_sync_batch(lambda qs: shard.keyword_search_batch(qs, K), qtexts, card,
                                  f"G batch lane ({G_Q} queries)")
        st = engine.last_batch_stats
        log(f"[{card}] G end to end, {G_N} documents: import {G_N / import_s:.0f} documents/s; "
            f"one keyword object_search p50 {p50_ms(t_dev):.2f} ms on the device engine, "
            f"{p50_ms(t_host):.2f} ms on the host engine; batch lane of {G_Q} p50 "
            f"{p50_ms(t_batch):.1f} ms ({st['u']} units, {st['slices']} slices, n_pad "
            f"{st['n_pad']}); busy {'not measured' if busy is None else f'{busy[0]:.1%}'}")
    finally:
        if shard is not None:
            shard.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


# -- the busy-share comparison -------------------------------------------------------

# -- workload H: the multi-device mesh index ------------------------------------------

def device_guard_check(dev, card) -> None:
    """K1 launches under its tensor's device, not the thread's current one:
    with a second card the tensors sit on cuda:1 while cuda:0 is current;
    with one card the launch runs inside a torch.cuda.device context of
    the same card. The library is wrapped to read the current device at
    the launch (not counted); the answer is held against the plain
    version."""
    from weaviate_tpu_torch.ops import gmin_scan
    n = torch.cuda.device_count()
    where = torch.device("cuda", 1) if n > 1 else dev
    real = gmin_scan._gmin_lib()
    seen = []

    class Spy:
        def __getattr__(self, name):
            fn = getattr(real, name)
            if not name.endswith("_launch"):
                return fn
            return lambda *a: seen.append(torch.cuda.current_device()) or fn(*a)

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((256, DIM), dtype=np.float32)).to(where)
    store3 = torch.from_numpy(rng.standard_normal((16, 4096, DIM), dtype=np.float32)).to(where)
    bias = torch.zeros((16, 4096), device=where)
    gmin_scan._gmin_lib = lambda: Spy()
    launches = gmin_scan.launches
    try:
        with torch.cuda.device(dev):
            got = gmin_scan.group_min_scores(q, store3, bias, -2.0)
    finally:
        gmin_scan._gmin_lib = lambda: real
        gmin_scan.launches = launches
    torch.testing.assert_close(got, gmin_scan.group_min_scores_reference(q, store3, bias, -2.0),
                               rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if seen != [where.index]:
        raise AssertionError(f"K1 launched on device {seen}, its tensors on {where}")
    log(f"H device guard: K1 on {where} launched with {where} current"
        + (" while cuda:0 was the thread's device" if n > 1 else
           " (one card: the guard on the same card; a distinct current card not tested)"))


def slab_k1_check(label, idx, dev, seed) -> float:
    """K1 (f32 or bf16 by the store) against its plain version on slab 0's
    own store, at the slab's tile plan: B 256 and 16384, l2 and dot, dead
    slots and 100 whole dead groups. -> max abs error."""
    from weaviate_tpu_torch.ops import gmin_scan
    snap = idx._read_snapshot()
    G = gmin_scan.G
    n_loc, n0 = snap.n_loc, int(snap.counts[0])
    ncols, ag = n_loc // G, -(-n0 // (n_loc // G))
    store3 = snap.store[0].view(G, ncols, snap.dim)
    rng = np.random.default_rng(seed)
    dead = dead_mask(n_loc, ncols, n0, rng, dev, snap.tombs[0])
    biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
              for m, a, base in (("l2", -2.0, snap.sq_norms[0]),
                                 ("dot", -1.0, torch.zeros_like(snap.sq_norms[0])))]
    q = torch.from_numpy(make_data(BATCH, snap.dim, rng)).to(dev)
    k1 = lambda q_, b2, a, g: gmin_scan.group_min_scores(q_, store3, b2, a, active_g=g)  # noqa: E731
    k1_plain = lambda q_, b2, a, g: gmin_scan.group_min_scores_reference(q_, store3, b2, a, g)  # noqa: E731
    log(f"{label} K1 on slab 0's {snap.store[0].dtype} store: n_loc {n_loc}, ncols {ncols}, "
        f"ag {ag}{plan_note(gmin_scan.resident_plan(snap.dim, ag))}")
    launches = gmin_scan.launches
    err = check_kernel(f"gmin_scan {str(snap.store[0].dtype)[6:]} ({label} slab 0)", k1,
                       k1_plain, q, biases, ncols, ag, sizes=(H_B, BATCH))
    gmin_scan.launches = launches  # the check's launches are not the main path's
    del snap, store3, dead, biases
    torch.cuda.empty_cache()
    return err


def mesh_profile(label, idx, q, card) -> Optional[tuple]:
    """One profiled sync batch of the mesh: busy share, device ms, and the
    device->host copies in it (one: the packed result)."""
    wall_ms, kernels = profile_batch(lambda: idx.search_by_vectors(q, K))
    busy = sum(ms for _, ms, _ in kernels)
    d2h = sum(n for key, _, n in kernels if "DtoH" in key)
    if not kernels:
        log(f"[{card}] {label} profile: the profiler saw no device time (not measured)")
        return None
    log(f"[{card}] {label} profile of one {len(q)}-query sync batch: wall {wall_ms:.1f} ms, "
        f"device {busy:.1f} ms ({busy / wall_ms:.1%} busy); device->host copies {d2h}")
    for key, ms, count in kernels[:12]:
        log(f"  {ms:8.3f} ms  x{count:<4d} {key[:100]}")
    if d2h != 1:
        raise AssertionError(f"{label}: {d2h} device->host copies in one dispatch (want 1)")
    return busy / wall_ms, busy


def merge_ms(dev, b, n_slabs, card, label) -> float:
    """Device ms of the cross-slab merge alone (parallel/mesh_search._merge,
    fused) on n_slabs blocks of [b, 3k] at the dispatch's shapes."""
    from weaviate_tpu_torch.parallel import mesh_search
    g = torch.Generator(device=dev).manual_seed(1)
    s2d = torch.arange(1 << 20, device=dev)
    blocks = [mesh_search._epilogue(
        torch.sort(torch.rand((b, K), device=dev, generator=g), dim=1).values,
        torch.randint(0, 1 << 20, (b, K), device=dev, generator=g), s2d, 0, True)
        for _ in range(n_slabs)]
    ms = cuda_ms(lambda: mesh_search._merge(blocks, K, True), 5)
    log(f"[{card}] {label} cross-slab merge alone ({n_slabs} x [{b}, {3 * K}] int32 on the lead "
        f"device): {ms:.3f} ms")
    return ms


def tie_free(d) -> np.ndarray:
    """Rows whose k distances are all distinct."""
    return (np.diff(d, axis=1) != 0).all(1)


def exact_topk_live(q, x, k, gone) -> np.ndarray:
    """exact_topk with the rows `gone` (deleted) left out."""
    d = exact_dists(q, x, "l2")
    d[:, torch.from_numpy(gone).to(q.device)] = float("inf")
    return torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy()


def mesh_workload(dev, card, seed) -> dict:
    """Workload H: the mesh index (`hnsw_tpu_mesh`) over H_SLABS slabs of
    one card. H1 A's data and configuration, H2 over a bf16 store, H3 B2's
    codes-only shape on B2's files. -> each kernel's launches on H's main
    paths and its max abs error."""
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index import new_vector_index
    from weaviate_tpu_torch.index.mesh import MeshVectorIndex
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.parallel.mesh_search import make_mesh
    from weaviate_tpu_torch.storage.bitmap import Bitmap

    out = {}
    device_guard_check(dev, card)
    mesh = make_mesh(devices=[dev] * H_SLABS)
    rng = np.random.default_rng(seed)
    vecs = make_data(N, DIM, rng)
    batches = queries(vecs, rng)
    q_small = batches[0][:H_B]
    x_dev = torch.from_numpy(vecs).to(dev)
    gt_rows = np.arange(0, BATCH, BATCH // N_GT)
    gt = exact_topk(torch.from_numpy(batches[0][gt_rows]).to(dev), x_dev, K)

    # H1: A's data and configuration over H_SLABS slabs
    phase("H1")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h1_")
    try:
        cfg = parse_and_validate_config("hnsw_tpu_mesh", {"distance": "l2-squared"})
        idx = MeshVectorIndex(cfg, tmp, mesh=mesh)
        t0 = time.perf_counter()
        idx.add_batch(np.arange(N), vecs)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        log(f"H1 ingest: {N} rows over {idx.n_dev} slabs on {dev} in {ingest_s:.2f} s; n_loc "
            f"{idx.n_loc}, counts {idx._counts.tolist()}, stores "
            f"{sum(t.numel() * 4 for t in idx._store) / 2**20:.0f} MiB")
        err = slab_k1_check("H1", idx, dev, seed + 20)

        gmin_scan.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, batches[0], 4)
        per_dispatch = gmin_scan.launches / 4
        lat_s, p50_s, ids_s, d_s = sync_batches(idx, q_small, H_REPS)
        recall = recall_at_k(ids0[gt_rows].astype(np.int64), gt)
        recall_s = recall_at_k(ids_s.astype(np.int64),
                               exact_topk(torch.from_numpy(q_small).to(dev), x_dev, K))
        log(f"H1 sync: {BATCH}-query batches {['%.1f ms' % (t * 1e3) for t in lat]}, recall@10 "
            f"{recall:.4f}; {H_B}-query p50 {p50_s * 1e3:.2f} ms, recall@10 {recall_s:.4f}; "
            f"K1 launches per dispatch {per_dispatch:g}")
        if per_dispatch != H_SLABS or min(recall, recall_s) < H_RECALL_BAR:
            raise AssertionError(f"H1: {per_dispatch} K1 launches a dispatch, recall "
                                 f"{recall:.4f} / {recall_s:.4f}")
        rows = torch.from_numpy(ids0[gt_rows].astype(np.int64)).to(dev)
        q_gt = torch.from_numpy(batches[0][gt_rows]).to(dev)
        want = ((x_dev[rows] - q_gt[:, None, :]) ** 2).sum(-1).cpu().numpy()
        np.testing.assert_allclose(d0[gt_rows], want, rtol=1e-5, atol=1e-4)
        qps, results = async_batches(idx, batches, 8)
        if not (np.array_equal(results[0][0], ids0) and np.array_equal(results[0][1], d0)):
            raise AssertionError("H1: the async result differs from the sync result")
        staged_p50 = staged_batches(idx, batches[0], 3, ids0, d0, "H1")
        r_f, r_s = filtered_checks(idx, batches[0], x_dev, np.arange(0, BATCH, BATCH // 256),
                                   rng, dev, "l2", Bitmap)
        launches = gmin_scan.launches
        log(f"H1 async {qps:.0f} QPS (bit-identical to sync); filtered recall {r_f:.4f} "
            f"(every third doc) / {r_s:.4f} (1000 docs, the masked scan: the mesh has no "
            f"gather tier); distances exact f32 (rtol 1e-5); K1 launches {launches}")
        ids_d, d_d = delete_check(idx, ids0, batches[0], N, "H1")
        gone = np.unique(ids0[:, 0].astype(np.int64))[:1000]
        busy = mesh_profile("H1", idx, batches[0], card)
        m_ms = merge_ms(dev, BATCH, H_SLABS, card, "H1")
        idx.shutdown()
        del idx

        # restart onto 2 slabs: the replay re-balances
        phase("H1 restart")
        t0 = time.perf_counter()
        idx = MeshVectorIndex(cfg, tmp, mesh=make_mesh(devices=[dev] * 2))
        gmin_scan.launches = 0
        ids_r, d_r = idx.search_by_vectors(batches[0], K)
        restart_s = time.perf_counter() - t0
        launches += gmin_scan.launches
        gt_live = exact_topk_live(q_gt, x_dev, K, gone)
        recall_r = recall_at_k(ids_r[gt_rows].astype(np.int64), gt_live)
        log(f"H1 restart onto {idx.n_dev} slabs in {restart_s:.2f} s: counts "
            f"{idx._counts.tolist()}, live {len(idx)}, recall@10 {recall_r:.4f} against exact "
            f"ground truth without the deleted docs; K1 launches {gmin_scan.launches}")
        if idx.n_dev != 2 or len(idx) != N - len(gone) or recall_r < H_RECALL_BAR \
                or gmin_scan.launches != 2:
            raise AssertionError("H1: the restart onto 2 slabs is off")
        idx.shutdown()
        del idx
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the single-device index on the same data, the same deletes: answers
    # and p50s beside the mesh's
    phase("H1 single device")
    one = new_vector_index(parse_and_validate_config("hnsw_tpu", {"distance": "l2-squared"}),
                           "", persist=False)
    one.add_batch(np.arange(N), vecs)
    _, p50_1, _, _ = sync_batches(one, batches[0], 4)
    _, p50_1s, _, _ = sync_batches(one, q_small, H_REPS)
    one.delete(*gone.tolist())
    ids_1, d_1 = one.search_by_vectors(batches[0], K)
    one.shutdown()
    del one
    # both tiers keep candidate groups by bf16 scores, the single device 32
    # groups of 65536 columns, the 2-slab mesh 2 x 32 of 32768: where the
    # answers differ, one of them kept a closer row the other did not
    both = tie_free(d_1) & tie_free(d_r)
    differ = both & (ids_1 != ids_r).any(1)
    worse = differ & (d_r.sum(1) > d_1.sum(1))
    log(f"H1 restart vs the single-device index: {int(both.sum())} of {BATCH} rows tie-free "
        f"on both sides, ids equal on {int((both & ~differ).sum())}; {int(differ.sum())} "
        f"differ: the mesh's answer closer on {int((differ & ~worse).sum())}, farther on "
        f"{int(worse.sum())}")
    if int(worse.sum()) > BATCH // 1000:
        raise AssertionError(f"H1: the mesh's answer is farther than the single-device index's "
                             f"on {int(worse.sum())} tie-free rows (at most {BATCH // 1000})")
    a = SHARED.get("A")
    log(f"[{card}] H1 end to end, k={K}, n={N}, {H_SLABS} slabs on one card: sync p50 "
        f"{BATCH} {p50 * 1e3:.1f} ms (staged {staged_p50 * 1e3:.1f}), {H_B} "
        f"{p50_s * 1e3:.2f} ms; single device on the same data {p50_1 * 1e3:.1f} / "
        f"{p50_1s * 1e3:.2f} ms"
        + (f"; workload A {a['p50']:.1f} / {a['p50_256']:.2f} ms" if a else "")
        + f"; busy {'not measured' if busy is None else f'{busy[0]:.1%}'}, device "
        f"{'not measured' if busy is None else f'{busy[1]:.1f} ms'}, merge {m_ms:.3f} ms; "
        f"pipelined {qps:.0f} QPS; ingest {N / ingest_s:.0f} rows/s; restart onto 2 slabs "
        f"{restart_s:.2f} s")
    out["k1"] = {"launches": launches, "max_abs_err": err}

    if torch.cuda.device_count() > 1:
        phase("H1 distinct cards")
        cards = make_mesh(device=dev)
        idx = MeshVectorIndex(cfg, "", persist=False, mesh=cards)
        idx.add_batch(np.arange(N), vecs)
        ids_c, _ = idx.search_by_vectors(batches[0], K)
        r_c = recall_at_k(ids_c[gt_rows].astype(np.int64), gt)
        log(f"H1 over {len(cards)} distinct cards {[str(c) for c in cards]}: recall@10 {r_c:.4f}")
        if r_c < H_RECALL_BAR:
            raise AssertionError(f"H1 distinct cards: recall {r_c:.4f}")
        idx.drop()
        del idx
    else:
        log(f"H1 over distinct cards: not run, torch sees {torch.cuda.device_count()} card "
            "(copies between cards and the device guards across cards are not verified here)")

    # H2: the same over a bf16 store (K1-bf16 per slab)
    phase("H2")
    cfg16 = parse_and_validate_config("hnsw_tpu_mesh", {"distance": "l2-squared",
                                                        "storeDtype": "bfloat16"})
    idx = MeshVectorIndex(cfg16, "", persist=False, mesh=mesh)
    idx.add_batch(np.arange(N), vecs)
    if idx._store[0].dtype != torch.bfloat16:
        raise AssertionError("H2: the store is not bf16")
    err16 = slab_k1_check("H2", idx, dev, seed + 21)
    gmin_scan.launches = 0
    lat16, p50_16, ids16, _ = sync_batches(idx, batches[0], 4)
    _, p50_16s, _, _ = sync_batches(idx, q_small, 3)
    launches16 = gmin_scan.launches
    recall16 = recall_at_k(ids16[gt_rows].astype(np.int64), gt)
    log(f"[{card}] H2 bf16 store over {H_SLABS} slabs: sync {BATCH} "
        f"{['%.1f ms' % (t * 1e3) for t in lat16]} (p50 {p50_16 * 1e3:.1f}), {H_B} p50 "
        f"{p50_16s * 1e3:.2f} ms; recall@10 {recall16:.4f}; K1-bf16 launches {launches16}")
    if recall16 < H_BF16_BAR or launches16 != H_SLABS * 7:
        raise AssertionError(f"H2: recall {recall16:.4f}, launches {launches16}")
    idx.drop()
    del idx, x_dev
    torch.cuda.empty_cache()
    out["k1_bf16"] = {"launches": launches16, "max_abs_err": err16}

    # H3: codes only at B2's shape (K2 per slab) on B2's files
    phase("H3")
    out["k2"] = mesh_codes(dev, card, seed, mesh)
    return out


def mesh_codes(dev, card, seed, mesh) -> dict:
    """H3: B2's configuration (1M x 768, dot, M 96, C 256, rescore false)
    over H_SLABS slabs. On a copy of B2's shard directory (vector.log,
    pq.npz: shared formats, placement-free) when B ran, else fitted here
    at B2's settings. -> K2's launches and max abs error."""
    from weaviate_tpu_torch.entities.vectorindex import parse_and_validate_config
    from weaviate_tpu_torch.index.mesh import MeshVectorIndex
    from weaviate_tpu_torch.ops import gmin_scan, pq_gmin

    G = gmin_scan.G
    conf = pq_conf(rescore=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h3_")
    src = SHARED.pop("B2_dir", None)
    try:
        t0 = time.perf_counter()
        if src is not None:
            for name in ("vector.log", "pq.npz"):
                os.link(os.path.join(src, name), os.path.join(tmp, name))
            idx = MeshVectorIndex(parse_and_validate_config("hnsw_tpu_mesh", conf), tmp,
                                  mesh=mesh)
            how = "restored from B2's vector.log and pq.npz"
        else:
            rng = np.random.default_rng(seed + 1)
            idx = MeshVectorIndex(parse_and_validate_config("hnsw_tpu_mesh", conf), tmp,
                                  mesh=mesh)
            idx.add_batch(np.arange(N), make_data(N, PQ_DIM, rng))
            idx.flush()  # the declared pq block compresses here
            how = "fitted at B2's settings (B did not run)"
        torch.cuda.synchronize()
        open_s = time.perf_counter() - t0
        snap = idx._read_snapshot()
        if not snap.compressed or snap.pq.segments != PQ_M:
            raise AssertionError("H3: the mesh is not compressed at B2's settings")
        log(f"H3 {how} over {idx.n_dev} slabs in {open_s:.2f} s: n_loc {snap.n_loc}, counts "
            f"{snap.counts.tolist()}")
        ncols, n0 = snap.n_loc // G, int(snap.counts[0])
        ag = -(-n0 // ncols)
        codes3 = snap.codes[0].view(G, ncols, PQ_M)
        cb = snap.pq.codebook_bf16()
        rng = np.random.default_rng(seed + 22)
        dead = dead_mask(snap.n_loc, ncols, n0, rng, dev, snap.tombs[0])
        biases = [(m, a, torch.where(dead, float("inf"), base).view(G, ncols))
                  for m, a, base in (("l2", -2.0, snap.recon_norms[0]),
                                     ("dot", -1.0, torch.zeros_like(snap.recon_norms[0])))]
        q_all = torch.from_numpy(make_data(BATCH, PQ_DIM, rng)).to(dev)
        launches0 = pq_gmin.launches
        err = check_kernel("pq_gmin (H3 slab 0)",
                           lambda q, b2, a, g: pq_gmin.pq_group_min_scores(q, codes3, b2, cb, a,
                                                                           active_g=g),
                           lambda q, b2, a, g: pq_gmin.pq_group_min_scores_reference(
                               q, codes3, b2, cb, a, g), q_all, biases, ncols, ag,
                           sizes=(H_B, BATCH))
        pq_gmin.launches = launches0
        del codes3, biases, dead
        torch.cuda.empty_cache()
        b2 = SHARED.get("B2")
        q_big = q_all.cpu().numpy()
        pq_gmin.launches = 0
        lat, p50, ids0, d0 = sync_batches(idx, q_big, 3)
        per_dispatch = pq_gmin.launches / 3
        _, p50_s, _, _ = sync_batches(idx, q_big[:H_B], H_REPS)
        if b2 is not None:
            ids_b, d_b = idx.search_by_vectors(b2["q"], K)
            hits = tie_aware_hits(ids_b, d_b, b2["ids"], b2["d"])
            what = f"B2's single-device answers on its {len(b2['q'])} queries"
        else:
            recon = snap.pq.decode(torch.cat([c[: int(n)] for c, n in zip(snap.codes,
                                                                          snap.counts)]))
            adc = exact_dists(q_all[:N_CPU], recon, "dot")
            adc_d, adc_i = torch.topk(adc, K, dim=1, largest=False)
            rows_of = np.concatenate([s * snap.n_loc + np.arange(int(n))
                                      for s, n in enumerate(snap.counts)])
            ref_ids = snap.slot_to_doc[rows_of[adc_i.cpu().numpy()]]
            hits = tie_aware_hits(ids0[:N_CPU].astype(np.int64), d0[:N_CPU], ref_ids,
                                  adc_d.cpu().numpy())
            what = f"exact ADC ground truth on {N_CPU} queries"
            del recon, adc
        launches = pq_gmin.launches
        log(f"[{card}] H3 codes only over {H_SLABS} slabs: sync {BATCH} "
            f"{['%.1f ms' % (t * 1e3) for t in lat]} (p50 {p50 * 1e3:.1f}), {H_B} p50 "
            f"{p50_s * 1e3:.2f} ms"
            + (f"; B2 single device {b2['p50']:.1f} / {b2['p50_256']:.2f} ms" if b2 else "")
            + f"; agreement with {what} {hits:.4f} (tie-aware); K2 launches per dispatch "
            f"{per_dispatch:g}, in all {launches}")
        if per_dispatch != H_SLABS or hits < 0.99:
            raise AssertionError(f"H3: {per_dispatch} K2 launches a dispatch, agreement "
                                 f"{hits:.4f}")
        mesh_profile("H3", idx, q_big, card)
        merge_ms(dev, BATCH, H_SLABS, card, "H3")
        idx.drop()
        del idx, snap
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if src is not None:
            shutil.rmtree(src, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err}


# -- workload I: the module system on the card --------------------------------------

def zipf_texts(rng, count, lo, hi):
    """count texts of lo..hi words drawn Zipf (s = I_ZIPF) from the
    I_VOCAB-word vocabulary w0, w1, ..."""
    vocab = np.array([f"w{i}" for i in range(I_VOCAB)])
    ranks = np.arange(1, I_VOCAB + 1, dtype=np.float64) ** -I_ZIPF
    lens = rng.integers(lo, hi + 1, count)
    drawn = vocab[rng.choice(I_VOCAB, size=int(lens.sum()), p=ranks / ranks.sum())]
    cuts = np.concatenate([[0], np.cumsum(lens)])
    return [" ".join(drawn[cuts[i]:cuts[i + 1]]) for i in range(count)]


def gql_near_text(concepts, limit=K, extra="", additional="id distance") -> str:
    return ("{ Get { %s(nearText: {concepts: %s%s}, limit: %d) { _additional { %s } } } }"
            % (I_CLASS, json.dumps(concepts), extra, limit, additional))


def near_text_rows(reply) -> tuple[list[int], list[float]]:
    """A nearText Get reply -> (import indexes, distances); an error raises."""
    if reply.get("errors"):
        raise AssertionError(f"I GraphQL: {reply['errors']}")
    rows = reply["data"]["Get"][I_CLASS]
    return ([uuidlib.UUID(r["_additional"]["id"]).int - 1 for r in rows],
            [float(r["_additional"]["distance"]) for r in rows])


def module_workload(dev, card, seed) -> dict:
    """The module system on the card: an App with text2vec-local,
    ref2vec-centroid and backup-filesystem and the coalescer on; I_N texts
    vectorized at import over REST; nearText through /v1/graphql/batch
    (K1), featureProjection's t-SNE on the card, a filesystem backup and
    restore. -> K1's launches on the main path and its max abs error on
    the App's store."""
    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.modules import Provider
    from weaviate_tpu_torch.modules.text2vec_local import LocalTextVectorizer
    from weaviate_tpu_torch.ops import gmin_scan, tsne
    from weaviate_tpu_torch.server import App, RestServer

    rng = np.random.default_rng(seed + 11)
    t0 = time.perf_counter()
    texts = zipf_texts(rng, I_N, 8, 16)
    q_texts = zipf_texts(rng, I_Q, 2, 6)
    log(f"I data: {I_N} texts of 8-16 words, {I_Q} queries of 2-6, Zipf({I_ZIPF}) over "
        f"{I_VOCAB} words (seed + 11), in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_i_")
    app = srv = None
    try:
        cfg = load_config({**os.environ, "QUERY_COALESCER_ENABLED": "true",
                           "ENABLE_MODULES": "text2vec-local,ref2vec-centroid,backup-filesystem",
                           "BACKUP_FILESYSTEM_PATH": os.path.join(tmp, "backups")})
        app = App(config=cfg, data_path=os.path.join(tmp, "data"), device=dev)
        if app.modules.get("text2vec-local").device != dev:
            raise AssertionError(f"I: the vectorizer's device is "
                                 f"{app.modules.get('text2vec-local').device}, not {dev}")
        srv = RestServer(app, host="127.0.0.1", port=0)
        srv.start()
        port = srv.port
        st, _ = http(port, "POST", "/v1/schema", {
            "class": I_CLASS, "vectorizer": "text2vec-local", "vectorIndexType": "hnsw_tpu",
            "vectorIndexConfig": {"distance": "cosine"},
            "properties": [{"name": "body", "dataType": ["text"]}]})
        if st != 200:
            raise AssertionError(f"I POST /v1/schema: {st}")
        t0 = time.perf_counter()
        for s in range(0, I_N, I_IMPORT):
            st, res = http(port, "POST", "/v1/batch/objects", {"objects": [
                {"class": I_CLASS, "id": str(uuidlib.UUID(int=i + 1)),
                 "properties": {"body": texts[i]}} for i in range(s, min(s + I_IMPORT, I_N))]})
            if st != 200 or any("errors" in r["result"] for r in res):
                raise AssertionError(f"I POST /v1/batch/objects at {s}: {st}")
        rest_s = time.perf_counter() - t0
        shard = app.db.get_index(I_CLASS).single_local_shard()
        shard.flush()
        shard.store.flush_memtables()
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        if shard.object_count() != I_N:
            raise AssertionError(f"I import: {shard.object_count()} objects")
        log(f"[{card}] I import: {I_N} objects through REST POST /v1/batch/objects in batches "
            f"of {I_IMPORT}, vectorized at import: {rest_s:.1f} s; with the flush to segments "
            f"{import_s:.1f} s, {I_N / import_s:.0f} objects/s; capacity "
            f"{shard.vector_index.capacity}")

        # 64 read-back vectors against a fresh vectorizer, bit for bit
        fresh = LocalTextVectorizer(device=dev)
        cd = app.schema.get_class(I_CLASS)
        for i in rng.choice(I_N, I_READBACK, replace=False):
            st, got = http(port, "GET", f"/v1/objects/{I_CLASS}/{uuidlib.UUID(int=int(i) + 1)}"
                                        "?include=vector")
            want = fresh.vectorize_object(cd, StorObj(class_name=I_CLASS, uuid="",
                                                      properties={"body": texts[i]}), {})
            if st != 200 or not np.array_equal(np.asarray(got["vector"], np.float32), want):
                raise AssertionError(f"I read-back of object {i}: not the fresh vectorizer's")
        log(f"I read-back: {I_READBACK} vectors bit-equal to a fresh LocalTextVectorizer")

        # exact cosine ground truth over the index's own store (rows are
        # normalized at insert; the import filled slots in doc-id order)
        snap = shard.vector_index._read_snapshot()
        if not np.array_equal(snap.slot_to_doc[:I_N], np.arange(I_N)):
            raise AssertionError("I: the store's slots are not in import order")
        store = snap.store[:I_N]
        q_vecs = fresh.vectorize_text(q_texts)
        gt = exact_topk(torch.from_numpy(q_vecs).to(dev), store, K, "dot")
        max_err = check_k1_on_shard("I", "the module App", shard, q_vecs, dev, seed + 12,
                                    (16, 64, I_Q))

        # one query a request (the coalescer's lanes of one row take the
        # chunked scan), then the batch: the main path
        lat = []
        for t in q_texts[:I_ONE_REQS]:
            t1 = time.perf_counter()
            near_text_rows(http(port, "POST", "/v1/graphql", {"query": gql_near_text([t])})[1])
            lat.append(time.perf_counter() - t1)
        p50_one = float(np.median(lat))
        body = [{"query": gql_near_text([t])} for t in q_texts]
        st0 = app.coalescer.stats()
        phase("I main path")
        gmin_scan.launches = 0
        lat = []
        for _ in range(I_REPS):
            t1 = time.perf_counter()
            st, rep = http(port, "POST", "/v1/graphql/batch", body)
            lat.append(time.perf_counter() - t1)
        launches = gmin_scan.launches
        rows = [near_text_rows(r) for r in rep]
        r_batch = recall_at_k(ids_matrix(rows), gt)
        p50_batch = float(np.median(lat))
        st1 = app.coalescer.stats()
        d_disp = st1["dispatches"] - st0["dispatches"]
        log(f"[{card}] I nearText: one query a request p50 {p50_one * 1e3:.2f} ms "
            f"({I_ONE_REQS} requests); /v1/graphql/batch of {I_Q} with the coalescer "
            f"{['%.1f ms' % (t * 1e3) for t in lat]}, p50 {p50_batch * 1e3:.2f} ms; recall@10 "
            f"{r_batch:.4f} against exact cosine over the store; {d_disp} lanes, mean fill "
            f"{(st1['rows'] - st0['rows']) / max(d_disp, 1):.1f} rows; K1 launches {launches}")
        if r_batch < 0.99 or launches == 0:
            raise AssertionError(f"I nearText batch: recall {r_batch:.4f}, K1 launches {launches}")

        # moveTo / moveAwayFrom against its exact answer
        steer = {"concepts": [q_texts[0]], "moveTo": {"concepts": [q_texts[1]], "force": 0.5},
                 "moveAwayFrom": {"concepts": [q_texts[2]], "force": 0.3}}
        extra = (', moveTo: {concepts: %s, force: 0.5}, moveAwayFrom: {concepts: %s, '
                 'force: 0.3}' % (json.dumps([q_texts[1]]), json.dumps([q_texts[2]])))
        ids_m, d_m = near_text_rows(http(port, "POST", "/v1/graphql", {
            "query": gql_near_text([q_texts[0]], extra=extra)})[1])
        prov = Provider(device=dev)
        prov.register(fresh)
        sv = torch.from_numpy(prov.vectorize_query(cd, steer)).to(dev)
        sv = sv / sv.norm()
        exact_d = 1.0 - store @ sv
        kth = float(torch.topk(exact_d, K, largest=False).values[-1])
        got_d = exact_d[torch.tensor(ids_m, device=dev)].cpu().numpy()
        np.testing.assert_allclose(d_m, got_d, rtol=1e-5, atol=1e-5)
        if len(ids_m) != K or float(max(got_d)) > kth + 1e-5:
            raise AssertionError(f"I moveTo/moveAwayFrom: {ids_m} past the exact 10th {kth}")
        log(f"I moveTo/moveAwayFrom: the {K} answers are the exact top-{K} (10th distance "
            f"{kth:.6f}), their distances the exact ones within rtol 1e-5")

        # featureProjection at limit 100: t-SNE on the card
        seen = []
        descend = tsne._descend

        def spy(p_, y0, iterations, lr):
            seen.append((p_.device.type, int(iterations), int(p_.shape[0])))
            return descend(p_, y0, iterations, lr)

        tsne._descend = spy
        try:
            q_fp = gql_near_text([q_texts[3]], limit=100, additional=(
                "id vector featureProjection(dimensions: 2, iterations: 20) { vector }"))
            rows_fp = http(port, "POST", "/v1/graphql", {"query": q_fp})[1]["data"]["Get"][I_CLASS]
            lat = []
            q_def = gql_near_text([q_texts[3]], limit=100,
                                  additional="featureProjection { vector }")
            for _ in range(3):
                t1 = time.perf_counter()
                rep = http(port, "POST", "/v1/graphql", {"query": q_def})[1]
                lat.append(time.perf_counter() - t1)
                if rep.get("errors"):
                    raise AssertionError(f"I featureProjection: {rep['errors']}")
        finally:
            tsne._descend = descend
        if seen != [(dev.type, it, 100) for it in (20, 100, 100, 100)]:
            raise AssertionError(f"I featureProjection ran as {seen}, not on {dev.type}")
        fp_vecs = np.array([r["_additional"]["vector"] for r in rows_fp], np.float32)
        fp_card = np.array([r["_additional"]["featureProjection"]["vector"] for r in rows_fp],
                           np.float32)
        again = tsne.tsne_project(fp_vecs, iterations=20, device=dev)
        on_cpu = tsne.tsne_project(fp_vecs, iterations=20, device="cpu")
        spread = float(np.abs(on_cpu).max())
        gap = float(np.abs(again - on_cpu).max())
        log(f"I featureProjection at limit 100 through GraphQL: ran on {seen[0][0]} "
            f"({len(seen)} projections of 100 rows); 20 iterations: two card runs bit-equal "
            f"{np.array_equal(again, fp_card)}, card vs CPU max abs {gap:.3e} = "
            f"{gap / spread:.2e} x spread (bar 1e-4); default 100 iterations, one request "
            f"p50 {float(np.median(lat)) * 1e3:.1f} ms")
        if not np.array_equal(again, fp_card) or gap > 1e-4 * spread:
            raise AssertionError(f"I t-SNE: card runs differ or card vs CPU {gap / spread:.2e}")

        # t-SNE's times on the card and the CPU, and its launches
        sample = store[torch.from_numpy(rng.choice(I_N, 1000, replace=False)).to(dev)]
        sample = sample.cpu().numpy()
        for n, iters in I_TSNE:
            x = sample[:n]
            t1 = time.perf_counter()
            tsne._affinities(x, float(min(5.0, max(1.0, (n - 1) / 3.0))))
            aff_ms = (time.perf_counter() - t1) * 1e3
            card_ms = []
            for _ in range(3):
                t1 = time.perf_counter()
                tsne.tsne_project(x, iterations=iters, device=dev)
                card_ms.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            tsne.tsne_project(x, iterations=iters, device="cpu")
            cpu_ms = (time.perf_counter() - t1) * 1e3
            log(f"[{card}] I tsne_project n {n}, {iters} iterations: card "
                f"{['%.1f' % t for t in card_ms]} ms (p50 {float(np.median(card_ms)):.1f}), "
                f"CPU ({torch.get_num_threads()} threads) {cpu_ms:.1f} ms; of each, the host "
                f"affinities {aff_ms:.1f} ms")
        for n in (100, 1000):
            wall_ms, kernels = profile_batch(
                lambda: tsne.tsne_project(sample[:n], iterations=100, device=dev))
            dev_ms = sum(ms for _, ms, _ in kernels)
            count = sum(c for _, _, c in kernels)
            log(f"[{card}] I t-SNE profile n {n}, 100 iterations: wall {wall_ms:.1f} ms, device "
                f"kernels {dev_ms:.2f} ms ({dev_ms / wall_ms:.1%} busy), {count} kernel "
                f"launches ({count / 100:.1f} an iteration)")
            for key, ms, c in kernels[:5]:
                log(f"  {ms:8.3f} ms  x{c:<4d} {key[:100]}")

        # backup, delete, restore: the class answers as before
        want = [near_text_rows(http(port, "POST", "/v1/graphql",
                                    {"query": gql_near_text([t])})[1]) for t in q_texts[:16]]
        t1 = time.perf_counter()
        st, out = http(port, "POST", "/v1/backups/filesystem", {"id": "i-backup",
                                                                "include": [I_CLASS]})
        meta = app.backup_scheduler.wait("i-backup", timeout=600)
        backup_s = time.perf_counter() - t1
        if st != 200 or meta["status"] != "SUCCESS":
            raise AssertionError(f"I backup: {st} {meta}")
        del snap, store, shard, sample
        torch.cuda.empty_cache()
        http(port, "DELETE", f"/v1/schema/{I_CLASS}")
        t1 = time.perf_counter()
        st, out = http(port, "POST", "/v1/backups/filesystem/i-backup/restore", {})
        meta = app.backup_scheduler.wait("i-backup", restore=True, timeout=600)
        restore_s = time.perf_counter() - t1
        if st != 200 or meta["status"] != "SUCCESS":
            raise AssertionError(f"I restore: {st} {meta}")
        for i, t in enumerate(q_texts[:16]):
            ids, d = near_text_rows(http(port, "POST", "/v1/graphql",
                                         {"query": gql_near_text([t])})[1])
            if ids != want[i][0]:
                raise AssertionError(f"I restored query {i}: {ids} / before {want[i][0]}")
            np.testing.assert_allclose(d, want[i][1], rtol=1e-5)
        log(f"[{card}] I backup-filesystem of {I_N} objects {backup_s:.1f} s; class deleted; "
            f"restore {restore_s:.1f} s; 16 nearText answers equal before and after")
    finally:
        if srv is not None:
            srv.stop()
        if app is not None:
            app.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err}


def graph_workload(dev, card, seed) -> dict:
    """The native graph engine beside the card: one App on the card with
    two classes over the same J_N rows (A's generator, seed + 13, l2), an
    "hnsw" class at Weaviate's documented defaults (maxConnections 64,
    efConstruction 128, ef -1) and an "hnsw_tpu" class; the engine's
    insert rate, a batch of J_B on each class, recall@10 against exact
    distances on the card, a restart that answers the same. -> K1's
    launches on the hnsw_tpu batches and its max abs error there."""
    from weaviate_tpu_torch.index import hnsw
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.server import App

    rng = np.random.default_rng(seed + 13)
    vecs = make_data(J_N, DIM, rng)
    q = (rng.standard_normal((J_B, DIM), dtype=np.float32) * 0.1
         + vecs[rng.integers(0, J_N, J_B)])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_j_")
    app = None

    def put(cls, lo, hi):
        for s in range(lo, hi, J_IMPORT):
            res = app.batch.add_objects([
                {"class": cls, "id": str(uuidlib.UUID(int=i + 1)), "properties": {"n": i},
                 "vector": vecs[i]} for i in range(s, min(s + J_IMPORT, hi))])
            bad = [r.err for r in res if r.err is not None]
            if bad:
                raise AssertionError(f"J import of {cls} at {s}: {bad[0]}")

    def batch(cls, reps):
        idx = app.db.get_index(cls)
        lat = []
        for _ in range(reps):
            t1 = time.perf_counter()
            res = idx.object_vector_search(q, K)
            lat.append(time.perf_counter() - t1)
        ids = np.array([[uuidlib.UUID(r.obj.uuid).int - 1 for r in rows] for rows in res])
        dists = np.array([[r.distance for r in rows] for rows in res], np.float32)
        return float(np.median(lat)), ids, dists

    try:
        app = App(data_path=tmp, device=dev)
        for cls, typ, cfg in ((J_GRAPH, "hnsw", J_HNSW),
                              (J_CARD, "hnsw_tpu", {"distance": "l2-squared"})):
            app.schema.add_class({"class": cls, "vectorIndexType": typ, "vectorIndexConfig": cfg,
                                  "properties": [{"name": "n", "dataType": ["int"]}]})
        engine = app.db.get_index(J_GRAPH).single_local_shard().vector_index
        if not isinstance(engine, hnsw.HnswIndex):
            raise AssertionError(f"J: the hnsw class is served by {type(engine).__name__}")
        engine_s, add_batch = [], engine.add_batch

        def timed_add(ids, v):
            t1 = time.perf_counter()
            add_batch(ids, v)
            engine_s.append(time.perf_counter() - t1)

        engine.add_batch = timed_add
        t0 = time.perf_counter()
        put(J_GRAPH, 0, J_TIMED)
        first = sum(engine_s)
        n = J_N
        while n > J_TIMED and n * first / J_TIMED > J_BUILD_S:
            n //= 2
        log(f"[{card}] J native inserts: the first {J_TIMED} rows in {first:.2f} s of the "
            f"engine's add_batch ({J_TIMED / first:.0f} rows/s); at that rate {J_N} rows take "
            f"{J_N * first / J_TIMED:.1f} s (limit {J_BUILD_S:.0f} s): "
            + (f"{J_N} kept" if n == J_N else f"halved to {n}"))
        put(J_GRAPH, J_TIMED, n)
        graph_s = time.perf_counter() - t0
        insert_s = sum(engine_s)
        t1 = time.perf_counter()
        put(J_CARD, 0, n)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t1
        log(f"[{card}] J import through app.batch in batches of {J_IMPORT}: hnsw {n} rows in "
            f"{graph_s:.1f} s, of which the engine's inserts {insert_s:.1f} s ({n / insert_s:.0f} "
            f"rows/s); hnsw_tpu {card_s:.1f} s ({n / card_s:.0f} rows/s)")

        x = torch.from_numpy(vecs[:n]).to(dev)
        gt = exact_topk(torch.from_numpy(q).to(dev), x, K)
        del x
        card_shard = app.db.get_index(J_CARD).single_local_shard()
        max_err = check_k1_on_shard("J", "the hnsw_tpu class", card_shard, q, dev, seed + 14,
                                    (J_B,))
        threads = hnsw.omp_threads()
        p50_g, ids_g, d_g = batch(J_GRAPH, J_REPS)
        phase("J main path")
        gmin_scan.launches = 0
        p50_c, ids_c, _ = batch(J_CARD, J_REPS)
        launches = gmin_scan.launches
        r_g, r_c = recall_at_k(ids_g, gt), recall_at_k(ids_c, gt)
        log(f"[{card}] J batch of {J_B} through ClassIndex.object_vector_search, k={K}, n={n}: "
            f"hnsw p50 {p50_g * 1e3:.2f} ms (hnsw_search_batch on {threads} OpenMP threads, "
            f"{os.cpu_count()} CPUs), recall@10 {r_g:.4f} (bar {J_GRAPH_BAR}); hnsw_tpu p50 "
            f"{p50_c * 1e3:.2f} ms, recall@10 {r_c:.4f} (bar {J_CARD_BAR}), K1 launches "
            f"{launches} in {J_REPS} batches")
        if r_g < J_GRAPH_BAR or r_c < J_CARD_BAR or launches == 0:
            raise AssertionError(f"J: hnsw recall {r_g:.4f}, hnsw_tpu recall {r_c:.4f}, K1 "
                                 f"launches {launches}")

        # a snapshot, then J_DELTA re-added rows in the delta log only: the
        # engine's files reopened by a fresh engine (a crash's restart)
        # answer as the live one, and so does the App after a clean restart
        engine.flush()
        put(J_GRAPH, 0, J_DELTA)
        engine._log.flush()
        ids_l, d_l = engine.search_by_vectors(q, K)
        crash = os.path.join(tmp, "crash")
        os.makedirs(crash)
        for f in engine.list_files():
            shutil.copy(f, crash)
        t1 = time.perf_counter()
        reopened = hnsw.HnswIndex(engine.config, crash)
        replay_s = time.perf_counter() - t1
        ids_o, d_o = reopened.search_by_vectors(q, K)
        reopened.shutdown()
        if not (np.array_equal(ids_o, ids_l) and np.array_equal(d_o, d_l)):
            raise AssertionError("J: the snapshot plus delta answers differently")
        _, ids_g, d_g = batch(J_GRAPH, 1)
        app.shutdown()
        t1 = time.perf_counter()
        app = App(data_path=tmp, device=dev)
        restart_s = time.perf_counter() - t1
        _, ids_r, d_r = batch(J_GRAPH, 1)
        if not (np.array_equal(ids_r, ids_g) and np.array_equal(d_r, d_g)):
            raise AssertionError("J: the hnsw class answers differently after the restart")
        log(f"J restart: the snapshot plus a delta of {J_DELTA} re-added rows reopened in "
            f"{replay_s:.2f} s and the App restarted in {restart_s:.2f} s; both answer the "
            f"{J_B} queries as before, ids and distances bit for bit")
    finally:
        if app is not None:
            app.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err}


def http_status(port, method, path, body=None, timeout=300):
    """http() that returns an error status instead of raising."""
    import urllib.error
    try:
        return http(port, method, path, body, timeout)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, (json.loads(raw) if raw else None)


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cluster_workload(dev, card, seed) -> dict:
    """A three-node port cluster on the one card: three Apps with
    CLUSTER_HOSTNAME and CLUSTER_JOIN (static peers), each with its own
    data directory, serving REST. L1 scatter-gather over three shards
    (factor 1); L2 one shard at factor 3: consistency levels, a node down,
    read repair after its return, deletes, a backup and restore across
    the cluster. -> K1's launches on L1's main path and its max abs error
    on node-0's shard."""
    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.entities.storobj import StorObj
    from weaviate_tpu_torch.grpcapi import weaviate_pb2 as pb
    from weaviate_tpu_torch.ops import gmin_scan
    from weaviate_tpu_torch.server import App, RestServer
    from weaviate_tpu_torch.server.grpc_server import GrpcServer, SearchClient
    from weaviate_tpu_torch.usecases.replica import ReplicationError

    rng = np.random.default_rng(seed + 17)
    n1, n2 = L1_N, L2_N
    vecs = make_data(n1, DIM, rng)
    q = (rng.standard_normal((L_B, DIM), dtype=np.float32) * 0.1
         + vecs[rng.integers(0, n1, L_B)])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_l_")
    names = [f"node-{i}" for i in range(3)]
    ports = [free_port() for _ in names]

    def config(i):
        return load_config({
            **os.environ, "CLUSTER_HOSTNAME": names[i], "CLUSTER_DATA_BIND_PORT": str(ports[i]),
            "CLUSTER_JOIN": ",".join(f"{names[j]}@127.0.0.1:{ports[j]}" for j in range(3)
                                     if j != i),
            "ENABLE_MODULES": "backup-filesystem",
            "BACKUP_FILESYSTEM_PATH": os.path.join(tmp, "backups")})

    apps, servers = [None] * 3, [None] * 3

    def start(i):
        apps[i] = App(config=config(i), data_path=os.path.join(tmp, names[i]), device=dev)
        servers[i] = RestServer(apps[i], host="127.0.0.1", port=0)
        servers[i].start()

    def stop(i):
        if servers[i] is not None:
            servers[i].stop()
        if apps[i] is not None:
            apps[i].shutdown()
        apps[i] = servers[i] = None

    def obj(cls, i):
        return {"class": cls, "id": str(uuidlib.UUID(int=i + 1)), "properties": {"n": i},
                "vector": vecs[i].tolist()}

    def rest_import(port, cls, lo, hi, cl=None):
        path = "/v1/batch/objects" + (f"?consistency_level={cl}" if cl else "")
        for s in range(lo, hi, L_IMPORT):
            st, res = http(port, "POST", path, {"objects": [
                obj(cls, i) for i in range(s, min(s + L_IMPORT, hi))]})
            if st != 200 or any("errors" in r["result"] for r in res):
                raise AssertionError(f"L import of {cls} at {s}: {st}")

    def get(i, cls, k, cl):
        return http_status(servers[i].port, "GET",
                           f"/v1/objects/{cls}/{uuidlib.UUID(int=k + 1)}"
                           f"?include=vector&consistency_level={cl}")

    gsrv = client = one = None
    try:
        for i in range(3):
            start(i)
        port0 = servers[0].port
        for cls, shards, factor in ((L1, 3, 1), (L2, 1, 3)):
            st, _ = http(port0, "POST", "/v1/schema", {
                "class": cls, "vectorIndexType": "hnsw_tpu",
                "vectorIndexConfig": {"distance": "l2-squared"},
                "shardingConfig": {"desiredCount": shards},
                "replicationConfig": {"factor": factor},
                "properties": [{"name": "n", "dataType": ["int"]}]})
            if st != 200:
                raise AssertionError(f"L POST /v1/schema {cls}: {st}")

        # L1: import through node-0 over REST; the first L_TIMED rows say
        # whether L1 and L2 fit L_IMPORT_S or halve
        t0 = time.perf_counter()
        rest_import(port0, L1, 0, L_TIMED)
        rate = L_TIMED / (time.perf_counter() - t0)
        while n1 > L_TIMED and (n1 + 3 * n2) / rate > L_IMPORT_S:
            n1, n2 = n1 // 2, n2 // 2
        log(f"[{card}] L1 import: the first {L_TIMED} objects at {rate:.0f} objects/s; "
            f"{L1_N} + 3 x {L2_N} replica writes would take {(L1_N + 3 * L2_N) / rate:.1f} s "
            f"(limit {L_IMPORT_S:.0f} s): "
            + ("kept" if n1 == L1_N else f"halved to L1 {n1}, L2 {n2}"))
        rest_import(port0, L1, L_TIMED, n1)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        local = [sum(s.object_count() for s in a.db.get_index(L1).shards.values()) for a in apps]
        if sum(local) != n1 or min(local) == 0:
            raise AssertionError(f"L1 import: {local} objects per node")
        log(f"[{card}] L1 import: {n1} objects through node-0's REST POST /v1/batch/objects in "
            f"batches of {L_IMPORT}: {import_s:.1f} s, {n1 / import_s:.0f} objects/s; per node "
            f"{local}")

        gt = exact_topk(torch.from_numpy(q).to(dev), torch.from_numpy(vecs[:n1]).to(dev), K)
        shard0 = next(iter(apps[0].db.get_index(L1).shards.values()))
        max_err = check_k1_on_shard("L1", "node-0's shard", shard0, q, dev, seed + 18, (L_B,))
        del shard0

        # the main path: one BatchSearch of L_B fans out to node-0's shard
        # and to the two remote shards, each a batch of L_B rows (K1)
        gsrv = GrpcServer(apps[0], host="127.0.0.1", port=0)
        gsrv.start()
        client = SearchClient(f"127.0.0.1:{gsrv.port}")

        def breq(cls):
            return pb.BatchSearchRequest(requests=[
                pb.SearchRequest(class_name=cls, limit=K,
                                 near_vector=pb.NearVectorParams(vector=v.tolist()))
                for v in q])

        def grpc_batches(req, reps):
            lat = []
            for _ in range(reps):
                t1 = time.perf_counter()
                reply = client.batch_search(req, timeout=600)
                lat.append(time.perf_counter() - t1)
            return float(np.median(lat)), grpc_batch_ids(reply)

        req = breq(L1)
        grpc_batches(req, 1)  # warm
        phase("L main path")
        gmin_scan.launches = 0
        p50_grpc, ids = grpc_batches(req, L_REPS)
        launches = gmin_scan.launches
        r_grpc = recall_at_k(ids, gt)
        # the same L_B queries as one /v1/graphql/batch: one query a slot,
        # so each shard sees one row (the chunked scan, by the routing rule)
        body = [{"query": gql_near(v, cls=L1)} for v in q]
        lat = []
        for _ in range(L_GQL_REPS):
            t1 = time.perf_counter()
            st, rep = http(port0, "POST", "/v1/graphql/batch", body)
            lat.append(time.perf_counter() - t1)
        r_gql = recall_at_k(ids_matrix([gql_rows(r, L1) for r in rep]), gt)
        p50_gql = float(np.median(lat))
        log(f"[{card}] L1 scatter-gather over 3 nodes, k={K}, n={n1}: gRPC BatchSearch of "
            f"{L_B} to node-0 p50 {p50_grpc * 1e3:.2f} ms, recall@10 {r_grpc:.4f}, K1 launches "
            f"{launches} in {L_REPS} batches ({launches / L_REPS:.1f} a batch); "
            f"/v1/graphql/batch of {L_B} p50 {p50_gql * 1e3:.2f} ms, recall@10 {r_gql:.4f}")
        if min(r_grpc, r_gql) < L_RECALL_BAR or launches < 3 * L_REPS:
            raise AssertionError(f"L1: recall {r_grpc:.4f} / {r_gql:.4f}, K1 launches "
                                 f"{launches} in {L_REPS} batches")
        client.close()
        gsrv.stop()
        client = gsrv = None

        # L2: one shard on all three nodes, imported at QUORUM
        t1 = time.perf_counter()
        rest_import(port0, L2, 0, n2, cl="QUORUM")
        l2_s = time.perf_counter() - t1
        counts = [next(iter(a.db.get_index(L2).shards.values())).object_count() for a in apps]
        if counts != [n2] * 3:
            raise AssertionError(f"L2 import at QUORUM: {counts} objects per replica")
        sample = [int(k) for k in rng.choice(n2, L_CHECKS, replace=False)]
        for k in sample:
            got = [get(i, L2, k, "ALL") for i in range(3)]
            if any(st != 200 for st, _ in got) or any(g[1] != got[0][1] for g in got[1:]):
                raise AssertionError(f"L2 object {k} at ALL: not equal on every node")
        log(f"[{card}] L2 import: {n2} objects at factor 3, consistency QUORUM, through "
            f"node-0: {l2_s:.1f} s, {n2 / l2_s:.0f} objects/s; {L_CHECKS} GETs at ALL equal on "
            f"every node")

        # node-2 down: QUORUM goes on, ALL is refused
        stop(2)
        for a in apps[:2]:
            a.cluster_node.cluster.mark("node-2", False)
        new = list(range(n2, n2 + L_CHECKS))  # rows L2 does not hold yet
        for k in new:
            st, _ = http_status(port0, "POST", "/v1/objects?consistency_level=QUORUM",
                                obj(L2, k))
            if st != 200:
                raise AssertionError(f"L2 write at QUORUM with node-2 down: {st}")
        gone = sample[0]
        st, _ = http_status(port0, "DELETE",
                            f"/v1/objects/{L2}/{uuidlib.UUID(int=gone + 1)}"
                            "?consistency_level=QUORUM")
        if st != 204:
            raise AssertionError(f"L2 delete at QUORUM with node-2 down: {st}")
        for k in new[:4] + sample[1:5]:
            st, _ = get(1, L2, k, "QUORUM")
            if st != 200:
                raise AssertionError(f"L2 read at QUORUM with node-2 down: {st}")
        late = n2 + L_CHECKS
        try:
            apps[0].db.get_index(L2).put_object(StorObj(
                class_name=L2, uuid=str(uuidlib.UUID(int=late + 1)), properties={"n": late},
                vector=vecs[late]), cl="ALL")
            raise AssertionError("L2 write at ALL with node-2 down: accepted")
        except ReplicationError as e:
            coord = f"ReplicationError: {e}"
        st, rep = http_status(port0, "POST", "/v1/objects?consistency_level=ALL",
                              obj(L2, late))
        if st != L_ALL_REFUSED:
            raise AssertionError(f"L2 REST write at ALL with node-2 down: {st} {rep}")
        log(f"L2 node-2 down: {L_CHECKS} writes, a delete and 8 reads at QUORUM served; a "
            f"write at ALL refused at the coordinator ({coord[:80]}) and over REST with "
            f"{st}")

        # node-2 back on its directory: reads at ALL repair it
        t1 = time.perf_counter()
        start(2)
        for a in apps[:2]:
            a.cluster_node.cluster.mark("node-2", True)
        back_s = time.perf_counter() - t1
        api = [a.cluster_node.api for a in apps]
        shard_name = next(iter(apps[0].db.get_index(L2).shards))
        uuids = [str(uuidlib.UUID(int=k + 1)) for k in new + [gone]]
        stale = sum(a != b for a, b in zip(api[2].digest_many(L2, shard_name, uuids),
                                           api[0].digest_many(L2, shard_name, uuids)))
        for k in new:
            st, _ = get(0, L2, k, "ALL")
            if st != 200:
                raise AssertionError(f"L2 read at ALL after node-2's return: {st}")
        st, _ = get(0, L2, gone, "ALL")
        if st != 404:
            raise AssertionError(f"L2: the deleted object came back at ALL ({st})")
        digests = [a.digest_many(L2, shard_name, uuids) for a in api]
        if digests[1] != digests[0] or digests[2] != digests[0]:
            raise AssertionError("L2: the replicas' digests differ after read repair")
        if any(d["exists"] for d in digests[2][-1:]):
            raise AssertionError("L2: read repair resurrected the deleted object on node-2")
        log(f"L2 node-2 back in {back_s:.2f} s: {stale} of "
            f"{len(uuids)} objects stale on it before, reads at ALL repaired them and the "
            f"three replicas' digests are equal; the deleted object stayed deleted")

        # a backup of L2 across the cluster, restored
        want = [gql_rows(http(port0, "POST", "/v1/graphql", {"query": gql_near(v, cls=L2)})[1],
                         L2) for v in q[:16]]
        t1 = time.perf_counter()
        st, _ = http(port0, "POST", "/v1/backups/filesystem", {"id": "l-backup",
                                                               "include": [L2]})
        meta = apps[0].backup_scheduler.wait("l-backup", timeout=600)
        if st != 200 or meta["status"] != "SUCCESS":
            raise AssertionError(f"L2 backup: {st} {meta}")
        backup_s = time.perf_counter() - t1
        http(port0, "DELETE", f"/v1/schema/{L2}")
        t1 = time.perf_counter()
        st, _ = http(port0, "POST", "/v1/backups/filesystem/l-backup/restore", {})
        meta = apps[0].backup_scheduler.wait("l-backup", restore=True, timeout=600)
        if st != 200 or meta["status"] != "SUCCESS":
            raise AssertionError(f"L2 restore: {st} {meta}")
        restore_s = time.perf_counter() - t1
        for i, v in enumerate(q[:16]):
            ids_v, d_v = gql_rows(http(port0, "POST", "/v1/graphql",
                                       {"query": gql_near(v, cls=L2)})[1], L2)
            if ids_v != want[i][0]:
                raise AssertionError(f"L2 restored query {i}: {ids_v} / before {want[i][0]}")
            np.testing.assert_allclose(d_v, want[i][1], rtol=1e-5)
        counts = [next(iter(a.db.get_index(L2).shards.values())).object_count() for a in apps]
        log(f"[{card}] L2 backup-filesystem across the cluster {backup_s:.1f} s; class "
            f"deleted; restore {restore_s:.1f} s, {counts} objects per replica; 16 answers "
            f"equal before and after")
        for i in range(3):
            stop(i)

        # the same L1 batch on one node holding the same data
        one = App(data_path=os.path.join(tmp, "one"), device=dev)
        one.schema.add_class({"class": L1, "vectorIndexType": "hnsw_tpu",
                              "vectorIndexConfig": {"distance": "l2-squared"},
                              "properties": [{"name": "n", "dataType": ["int"]}]})
        for s in range(0, n1, D_IMPORT):
            res = one.batch.add_objects([{**obj(L1, i), "vector": vecs[i]}
                                         for i in range(s, min(s + D_IMPORT, n1))])
            if any(r.err is not None for r in res):
                raise AssertionError("L one-node import failed")
        gsrv = GrpcServer(one, host="127.0.0.1", port=0)
        gsrv.start()
        client = SearchClient(f"127.0.0.1:{gsrv.port}")
        grpc_batches(req, 1)
        p50_one, ids_one = grpc_batches(req, L_REPS)
        log(f"[{card}] L1 BatchSearch of {L_B}: three nodes p50 {p50_grpc * 1e3:.2f} ms beside "
            f"one node holding the same {n1} rows {p50_one * 1e3:.2f} ms (recall@10 "
            f"{recall_at_k(ids_one, gt):.4f})")
    finally:
        if client is not None:
            client.close()
        if gsrv is not None:
            gsrv.stop()
        for i in range(3):
            try:
                stop(i)
            except Exception as e:  # noqa: BLE001 — teardown reports, the error above wins
                log(f"L teardown of {names[i]}: {type(e).__name__}: {e}")
        if one is not None:
            one.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": max_err}


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
    ap.add_argument("--only", metavar="LIST",
                    help="run only these workloads (a comma-separated subset of "
                         "A,B,A16,C,D,E,F,G,H,I,J,L) and print no result lines")
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

    # 3-6. the workloads
    runs = (("A", headline), ("B", pq_workload), ("A16", headline_bf16), ("C", profiler_phase),
            ("D", shard_workload), ("E", app_workload), ("F", ivf_workload),
            ("G", bm25_workload), ("H", mesh_workload), ("I", module_workload),
            ("J", graph_workload), ("L", cluster_workload))
    WANTED.update(args.only.split(",") if args.only else (key for key, _ in runs))
    res = {}
    try:
        for key, fn in runs:
            if key not in WANTED:
                continue
            t0 = time.perf_counter()
            phase(f"workload {key}")
            res[key] = fn(dev, card, args.seed)
            log(f"workload {key}: {time.perf_counter() - t0:.1f} s; "
                f"total {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(SHARED.pop("B2_dir", ""), ignore_errors=True)
    if args.only:
        faulthandler.cancel_dump_traceback_later()
        log(f"workloads {args.only} done")
        return 0
    k1_f32, pq_rows, a16, layout_rows, d_row, e_row, h, i_row, j_row, l_row = (
        res[key] for key in ("A", "B", "A16", "C", "D", "E", "H", "I", "J", "L"))

    # 6. result lines: K1's launches include D's, E's, H1's, I's, J's and
    # L's (the Shard's, the App's, the mesh's, the module App's, the App
    # beside the graph engine's and the cluster's main paths),
    # K1-bf16's the bf16-store runs' (A-bf16, H2), K2's the mesh's codes
    # tier (H3)
    k1_bf16, k2 = pq_rows[0], pq_rows[1]
    for row, extra in ((k1_f32, d_row), (k1_f32, e_row), (k1_f32, h["k1"]), (k1_f32, i_row),
                       (k1_f32, j_row), (k1_f32, l_row),
                       (k1_bf16, a16), (k1_bf16, h["k1_bf16"]), (k2, h["k2"])):
        row["launches"] += extra["launches"]
        row["max_abs_err"] = max(row["max_abs_err"], extra["max_abs_err"])
    faulthandler.cancel_dump_traceback_later()
    log(card)
    print(json.dumps({"kernels": [k1_f32, *pq_rows, *layout_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
