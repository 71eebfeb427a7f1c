"""The server under test, started by `run.py` as a child process.

It builds the port's App the way `python -m weaviate_tpu_torch` does
(configuration from the environment; REST and gRPC on free ports, the
data under the given directory), creates the configuration's class,
imports the configuration's objects through `app.batch.add_objects` when
the traffic asks for a filled class, and flushes every shard's memtables:
the state an idle import reaches once PERSISTENCE_FLUSH_IDLE_MEMTABLES_AFTER
has passed. Then it answers the parent on a control channel (stdin and
its original stdout), one JSON line each way:
  stats -> counters the run reads (raw-lane batches, memtable flushes,
           device memory peak, loaded module names)
  stop  -> shuts the servers and the App down, and exits
Everything else the process prints goes to standard error.

Usage (from run.py): python benchmark/launcher.py '<spec json>'
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from wbench import gen, isolation  # noqa: E402

IMPORT_BATCH = 10_000


def _ctl():
    """The control channel: the original stdout; fd 1 goes to stderr."""
    ctl = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return ctl


def _import(app, cfg: dict, seed: int, n: int, class_name: str) -> dict:
    """The configuration's n objects through the batch use case; a
    configuration with `pq_after_rows` imports that many, turns PQ on
    (its vectorIndexConfig.pq), then imports the rest."""
    x, _ = gen.dataset(cfg["data"], seed, n)
    pq_after = int(cfg.get("pq_after_rows") or 0)
    t0 = time.perf_counter()
    timings = {}

    def put(lo, hi):
        for s in range(lo, hi, IMPORT_BATCH):
            e = min(s + IMPORT_BATCH, hi)
            res = app.batch.add_objects([{"class": class_name, "id": gen.object_uuid(i),
                                          "vector": x[i]} for i in range(s, e)])
            bad = [r.err for r in res if r.err is not None]
            if bad:
                raise RuntimeError(f"import: {len(bad)} objects failed: {bad[0]}")

    if pq_after:
        put(0, pq_after)
        timings["import_before_pq_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        app.schema.update_class(class_name, {"vectorIndexConfig": cfg["pq_config"]})
        timings["pq_fit_s"] = time.perf_counter() - t1
        put(pq_after, n)
    else:
        put(0, n)
    timings["import_s"] = time.perf_counter() - t0
    return timings


def _flush(app, class_name: str) -> None:
    for shard in app.db.get_index(class_name).shards.values():
        shard.flush()
        shard.store.flush_memtables()


def _segments_written(app, class_name: str) -> int:
    """LSM segments the class's shards have written (memtable flushes)."""
    return sum(b._seg_counter for shard in app.db.get_index(class_name).shards.values()
               for b in list(shard.store._buckets.values()))


def _faults(name: str) -> None:
    """Break the timed path underneath (the harness's own tests only)."""
    import numpy as np

    if name in ("alter", "drop_half", "short", "repeat", "reverse"):
        from weaviate_tpu_torch.index import gpu

        inner = gpu.GpuVectorIndex._dispatch_search

        def broken(self, snap, vectors, k, allow_list=None):
            fin = inner(self, snap, vectors, k, allow_list)

            def finalize():
                ids, dists = fin()
                ids, dists = np.array(ids), np.array(dists)
                if name == "alter":      # one answer a dispatch names another row
                    ids[0, [0, -1]] = ids[0, [-1, 0]]
                elif name == "short":    # half of each answer left out
                    ids, dists = ids[:, : ids.shape[1] // 2], dists[:, : dists.shape[1] // 2]
                elif name == "repeat":   # the nearest row given k times
                    ids[:, 1:], dists[:, 1:] = ids[:, :1], dists[:, :1]
                elif name == "reverse":  # the top k, farthest first
                    ids, dists = ids[:, ::-1].copy(), dists[:, ::-1].copy()
                else:                    # half of the batch not searched: the first
                    half = len(ids) // 2  # half's answers stand in for the rest
                    if half:
                        ids[half:] = ids[: len(ids) - half]
                        dists[half:] = dists[: len(ids) - half]
                    else:
                        ids[:, 0] += 1
                return ids, dists
            return finalize
        gpu.GpuVectorIndex._dispatch_search = broken
    elif name in ("import_alter", "import_drop_half"):
        from weaviate_tpu_torch.usecases import objects

        inner = objects.BatchManager.add_objects

        def broken_import(self, payloads, cl=None):
            payloads = list(payloads)
            if name == "import_alter":       # every tenth vector changed
                for p in payloads[::10]:
                    v = np.asarray(p["vector"], dtype=np.float32).copy()
                    v[0] += 1e-3
                    p["vector"] = v
                return inner(self, payloads, cl)
            half = len(payloads) // 2         # half stored, all acknowledged
            res = inner(self, payloads[:half], cl)
            return res + [type(res[0])(original=p, obj=res[0].obj) for p in payloads[half:]]
        objects.BatchManager.add_objects = broken_import
    elif name:
        raise ValueError(f"unknown fault {name!r}")


def main() -> int:
    spec = json.loads(sys.argv[1])
    ctl = _ctl()
    t_start = time.perf_counter()
    import torch

    from weaviate_tpu_torch.config import load_config
    from weaviate_tpu_torch.server import App, RestServer
    from weaviate_tpu_torch.server.grpc_server import GrpcServer

    _faults(spec.get("fault") or "")
    cfg = spec["config"]
    device = spec["device"]
    if device == "cpu":
        # the rehearsal: the App's perf window names its backend from the
        # package's default device, which is the card
        from weaviate_tpu_torch import device as port_device
        port_device.DEFAULT_DEVICE = "cpu"
    app = App(config=load_config(), data_path=spec["data_path"], device=device)
    rest = RestServer(app, host="127.0.0.1", port=0)
    grpc_srv = GrpcServer(app, host="127.0.0.1", port=0)
    rest.start()
    grpc_srv.start()
    class_name = cfg["class"]["class"]
    app.schema.add_class(cfg["class"])
    info = {"event": "ready", "pid": os.getpid(), "rest_port": rest.port,
            "grpc_port": grpc_srv.port, "app_s": time.perf_counter() - t_start}
    if spec["preload"]:
        info.update(_import(app, cfg, spec["seed"], spec["n_objects"], class_name))
        t1 = time.perf_counter()
        _flush(app, class_name)
        info["flush_s"] = time.perf_counter() - t1
    if device != "cpu":
        torch.cuda.synchronize()
    ctl.write(json.dumps(info) + "\n")

    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "stats":
            out = {"raw_lane_batches": grpc_srv.servicer.raw_lane_batches,
                   "object_count": app.db.get_index(class_name).object_count(),
                   "segments_written": _segments_written(app, class_name),
                   "forbidden_modules": isolation.loaded()}
            if device != "cpu":
                out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
                out["device_name"] = torch.cuda.get_device_name()
            ctl.write(json.dumps(out, default=str) + "\n")
        elif cmd["cmd"] == "stop":
            grpc_srv.stop()
            rest.stop()
            app.shutdown()
            ctl.write(json.dumps({"event": "stopped"}) + "\n")
            return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
