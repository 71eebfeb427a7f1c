#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference put in
the program's place, computed in the precision below the one the
configuration states (its `control`: bfloat16 below an f32 store, float8
e4m3 below the PQ tier's bf16 rescore), judged by the same comparison as a
run's answers. Its readings are the upper ends the limits in the
configuration's `limits` were set below (PERF.md gives them).

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 [--rehearse]

Prints one JSON line a seed. On the card with a card, on the CPU with
--rehearse at the traffic's rehearsal sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from wbench import gen, reference, spec  # noqa: E402


def search_control(cfg: dict, tr: dict, seed: int, device: str) -> dict:
    """Readings of the control's answers to the queries a run samples."""
    width, sample = int(tr["queries_per_request"]), int(tr["sample_requests"])
    x, q = gen.dataset(cfg["data"], seed, int(cfg["n_objects"]),
                       width * int(tr["pool_requests"]))
    q = q[: width * sample]
    k = int(tr.get("k", 10))
    metric = cfg["class"]["vectorIndexConfig"]["distance"]
    t_ids, t_d = reference.truth(q, x, k, metric, device)
    c_ids, c_d = reference.topk(q, x, k, metric, device,
                                round_rows=reference.CONTROLS[cfg["control"]])
    out = reference.judge(q, x, k, metric, c_ids, c_d, t_ids, t_d)
    out["sampled"] = len(q)
    return out


def import_control(cfg: dict, tr: dict, seed: int) -> dict:
    """The acknowledged vectors read back as the control's precision
    stores them (bfloat16 below the f32 store): how many differ."""
    import torch

    per, n = int(tr["objects_per_request"]), int(tr["readback_get"])
    rng = np.random.default_rng([int(seed) % (1 << 64), 6])
    diff = 0
    for b, i in zip(rng.integers(0, 200, n), rng.integers(0, per, n)):
        want = gen.decimal_rows(gen.import_batch(cfg["data"], seed, int(b), per))[1][i]
        got = reference.CONTROLS[cfg["control"]](torch.from_numpy(want[None, :]))[0].numpy()
        diff += int(not np.array_equal(got, want))
    return {"missing": 0, "vector_diff": diff, "not_found": 0, "checked": n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    cfg, tr = dict(cell.config), dict(cell.traffic)
    if args.rehearse:
        cfg.update(cfg.get("rehearse", {}))
        tr.update(tr.get("rehearse", {}))
    device = "cpu" if args.rehearse else "cuda"
    for seed in (int(s) for s in args.seeds.split(",")):
        if tr["protocol"] == "rest_batch_import":
            r = import_control(cfg, tr, seed)
        else:
            r = search_control(cfg, tr, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": cfg["control"],
                          **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
