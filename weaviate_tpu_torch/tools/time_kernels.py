"""Time the port's seven hand-written kernels at their main-path shapes on
seeded random data, one checkout per process, so that two versions of the
kernels can be compared on one card in turns (parent, change, change,
parent):

    python3 weaviate_tpu_torch/tools/time_kernels.py [--checkout DIR]

`--checkout DIR` imports `weaviate_tpu_torch` from DIR, another checkout
of the repository (for example the parent commit unpacked with `git
archive`), instead of from the checkout that holds this file; its kernels
build into DIR/build/kernels. Several kernel libraries built apart are
never loaded into one process (each carries its own CUDA runtime).

Shapes, chip_smoke.py's main-path ones: B 16384 queries, 65536 groups of
16 slices, l2 (alpha -2, a bias of squared norms):
  k1        K1 over an f32 store [16, 65536, 128]
  k1_bf16   K1 over a bf16 store [16, 65536, 768]
  k2        K2 over 8-bit codes [16, 65536, 96], 256 centroids, D 768
  k3        K3 over packed 4-bit codes [16, 65536, 48], 16 centroids, D 768
  k4        K4 over the f32 store of k1 transposed to [16, 128, 65536]
  k5_gc2/4  K5 over the same, gc 2 / 4 groups interleaved at width 128

The data is made on the card from a generator seeded 0. Each kernel: one
warm-up launch, then the mean of REPS launches between two CUDA events.
Prints `name ms` per kernel, then one JSON object with the card and every
kernel's ms as the last line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

B, NCOLS, G = 16384, 65536, 16
REPS = 5


def _ms(fn) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _cases(dev, gen):
    """-> {name: () -> launch} for the seven kernels, their data made on
    the card from gen."""
    from weaviate_tpu_torch.ops import gmin_scan, pq4, pq_gmin
    from weaviate_tpu_torch.tools import profile_gmin

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    q128, q768 = randn(B, 128), randn(B, 768)
    bias = torch.rand((G, NCOLS), generator=gen, device=dev) * 100
    store = randn(G, NCOLS, 128)
    bias128 = (store ** 2).sum(-1)
    store3t = profile_gmin.transpose_store(store)
    s4 = {gc: profile_gmin.interleave(store3t, bias128, gc, 128) for gc in (2, 4)}
    store_bf = randn(G, NCOLS, 768, dtype=torch.bfloat16)
    codes = torch.randint(0, 256, (G, NCOLS, 96), generator=gen, device=dev, dtype=torch.uint8)
    cb = randn(96, 256, 8, dtype=torch.bfloat16)
    packed = torch.randint(0, 256, (G, NCOLS, 48), generator=gen, device=dev, dtype=torch.uint8)
    cb4 = randn(96, 16, 8, dtype=torch.bfloat16)
    return {
        "k1": lambda: gmin_scan.group_min_scores(q128, store, bias128, -2.0),
        "k1_bf16": lambda: gmin_scan.group_min_scores(q768, store_bf, bias, -2.0),
        "k2": lambda: pq_gmin.pq_group_min_scores(q768, codes, bias, cb, -2.0),
        "k3": lambda: pq4.pq4_group_min_scores(q768, packed, bias, cb4, -2.0),
        "k4": lambda: profile_gmin.nt_scores(q128, store3t, bias128, -2.0),
        "k5_gc2": lambda: profile_gmin.c4_scores(q128, *s4[2], -2.0, 128, 2),
        "k5_gc4": lambda: profile_gmin.c4_scores(q128, *s4[4], -2.0, 128, 4),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose weaviate_tpu_torch is timed (default: this one)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_kernels: torch sees no CUDA device", file=sys.stderr)
        return 1
    checkout = str(Path(args.checkout).resolve())
    sys.path.insert(0, checkout)
    import weaviate_tpu_torch
    if not weaviate_tpu_torch.__file__.startswith(checkout):
        raise RuntimeError(f"imported {weaviate_tpu_torch.__file__}, not from {checkout}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    ms = {}
    for name, fn in _cases(dev, torch.Generator(device=dev).manual_seed(0)).items():
        ms[name] = _ms(fn)
        print(f"{name} {ms[name]:.3f}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": checkout, "card": card, "reps": REPS, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
