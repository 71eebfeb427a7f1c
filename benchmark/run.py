#!/usr/bin/env python3
"""One run of one cell of the benchmark of `weaviate_tpu_torch`.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Starts the port's server (`launcher.py`) as a child process on the card,
fills it as the cell's configuration says, warms the cell's own shapes,
offers the cell's traffic for --seconds from this process, and prints one
JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), `device`, with --trace 1 `breakdown`, and last `checks`, each
number the correctness check compared with its limit. The same numbers end
standard error.

Without a card it exits 2 and prints no result. `--rehearse` runs the
whole flow on the CPU at the tiny sizes of the configuration's and the
traffic's `rehearse` entries: a rehearsal of the control flow, whose
result names the CPU and holds no device number.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from wbench import devtrace, gen, hoststat, isolation, load, reference, spec  # noqa: E402
from wbench.server import Server, ServerError, child_env, split_cores  # noqa: E402


# the --trace 1 run's server: every request traced, the ring holding the
# window's; the device trace covers TRACE_SECONDS of the window's second quarter
TRACE_ENV = {"TRACING_ENABLED": "true", "TRACING_RING_SIZE": "65536"}
TRACE_SECONDS = 5.0


def log(msg: str) -> None:
    print(f"wbench: {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started, by the kernel's clock."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_T0 = process_age() - (time.perf_counter() - T0)


def sizes(cell: spec.Cell, rehearse: bool) -> SimpleNamespace:
    """The cell's sizes; --rehearse takes the `rehearse` overrides."""
    cfg, tr = dict(cell.config), dict(cell.traffic)
    if rehearse:
        cfg.update(cfg.get("rehearse", {}))
        tr.update(tr.get("rehearse", {}))
    return SimpleNamespace(cfg=cfg, tr=tr)


class Inputs:
    """What the clients send, made from the seed while the server sets up."""

    def __init__(self, cfg: dict, tr: dict, seed: int):
        self.cfg, self.tr, self.seed = cfg, tr, seed
        self.cls = cfg["class"]["class"]
        self.k = int(tr.get("k", 10))
        proto = tr["protocol"]
        self.x = self.q = self.feed = None
        if proto == "grpc_batch_search":
            from wbench import wire

            width = int(tr["queries_per_request"])
            pool = int(tr["pool_requests"])
            self.x, self.q = gen.dataset(cfg["data"], seed, int(cfg["n_objects"]), width * pool)
            self.bodies = [(wire.batch_search_request(self.cls, self.q[i * width:(i + 1) * width],
                                                      self.k), width) for i in range(pool)]
        elif proto == "rest_batch_import":
            self.centers = gen.centers(cfg["data"], seed)
            self.per = int(tr["objects_per_request"])
            # the bodies, made ahead of the caller by a process of their own
            self.feed = load.ImportFeed({"data": cfg["data"], "seed": seed, "class": self.cls,
                                         "per": self.per, "first": 0})
        else:
            raise ValueError(f"unknown protocol {proto!r}")

    def import_vectors(self, b: int) -> np.ndarray:
        v = gen.import_batch(self.cfg["data"], self.seed, b, self.per, self.centers)
        return gen.decimal_rows(v)[1]

    def query_rows(self, key: int) -> np.ndarray:
        w = int(self.tr["queries_per_request"])
        return self.q[key * w:(key + 1) * w]


def offer(srv: Server, inp: Inputs, seconds: float, keep, acked: dict) -> load.Window:
    """Run the traffic for `seconds`; -> the window's requests."""
    tr = inp.tr
    if tr["protocol"] == "grpc_batch_search":
        return load.grpc_batch_search(f"127.0.0.1:{srv.info['grpc_port']}", inp.bodies,
                                      int(tr["clients"]), seconds, inp.k, keep)
    return load.batch_import(srv.info["rest_port"], inp.feed.next, int(tr["clients"]), seconds,
                             acked)


def start(cell: spec.Cell, sz, seed: int, trace: bool, rehearse: bool, fault: str,
          data_path: str) -> Server:
    env = dict(sz.cfg.get("server_env", {}))
    env.update(sz.tr.get("server_env", {}))
    if trace:
        env.update(TRACE_ENV)
    payload = {"config": sz.cfg, "seed": seed, "device": "cpu" if rehearse else "cuda",
               "data_path": os.path.join(data_path, "data"),
               "preload": bool(sz.tr.get("preload", True)),
               "n_objects": int(sz.cfg["n_objects"]), "fault": fault}
    server_cores, client_cores = split_cores()
    os.sched_setaffinity(0, client_cores)
    return Server(payload, child_env(env), os.path.join(data_path, "server.log"), server_cores)


def capture_trace(srv: Server, at: float, seconds: float, out: dict) -> None:
    """GET /debug/pprof/trace?seconds=N at perf_counter `at`."""
    time.sleep(max(at - time.perf_counter(), 0.0))
    conn = load.Http(srv.info["rest_port"], timeout=seconds + 300)
    try:
        out["t0"] = time.perf_counter()
        st, body = conn.request("GET", f"/debug/pprof/trace?seconds={seconds:g}")
        out["t1"] = out["t0"] + seconds
        text = body.decode()
        if st == 200 and "written to " in text:
            out["path"] = os.path.join(text.splitlines()[0].split(" to ", 1)[1].strip(),
                                       "trace.json")
        else:
            out["error"] = f"HTTP {st}: {text[:300]}"
    finally:
        conn.close()


def readback(srv: Server, inp: Inputs, acked: dict, seed: int) -> dict:
    """The import cell's check: a seeded sample of acknowledged objects
    read back with their vectors, and searched by their own vectors; and
    the class's count against the acknowledged objects."""
    tr = inp.tr
    rng = np.random.default_rng([int(seed) % (1 << 64), 6])
    batches = sorted(acked)
    conn = load.Http(srv.info["rest_port"])
    out = {"missing": 0, "vector_diff": 0, "not_found": 0}
    try:
        q = '{ Aggregate { %s { meta { count } } } }' % inp.cls
        st, data = conn.request("POST", "/v1/graphql", json.dumps({"query": q}).encode())
        count = json.loads(data)["data"]["Aggregate"][inp.cls][0]["meta"]["count"]
        out["missing"] = max(sum(acked.values()) - int(count), 0)
        picks = [(int(b), int(i)) for b, i in zip(rng.choice(batches, int(tr["readback_get"])),
                                                  rng.integers(0, inp.per, int(tr["readback_get"])))]
        for j, (b, i) in enumerate(picks):
            uid = gen.object_uuid(b * inp.per + i)
            want = inp.import_vectors(b)[i]
            st, data = conn.request("GET", f"/v1/objects/{inp.cls}/{uid}?include=vector")
            if st != 200:
                out["missing"] += 1
                continue
            got = np.asarray(json.loads(data).get("vector") or [], dtype=np.float32)
            if got.shape != want.shape or not np.array_equal(got, want):
                out["vector_diff"] += 1
            if j < int(tr["readback_search"]):
                text = gen.decimal_rows(want[None, :])[0][0]
                st, data = conn.request("POST", "/v1/graphql",
                                        load.gql_near_vector(inp.cls, text, 1))
                ids, _ = load.gql_answer(inp.cls, data) if st == 200 else ([], [])
                if ids[:1] != [uid]:
                    out["not_found"] += 1
    finally:
        conn.close()
    out["checked"] = len(picks)
    return out


def judge_search(inp: Inputs, keep, device: str, order_tol: float) -> dict:
    """The sampled answers against the reference, on `device`."""
    qs, ids, dists = [], [], []
    k = inp.k
    for key, answers in (item for item in keep.items if item is not None):
        for qrow, (aid, adist) in zip(inp.query_rows(key), answers):
            idx = [gen.uuid_index(a) for a in aid[:k]]
            idx = [i if 0 <= i < len(inp.x) else -1 for i in idx] + [-1] * (k - len(idx))
            d = list(adist[:k]) + [0.0] * (k - len(adist))
            qs.append(qrow)
            ids.append(idx)
            dists.append(d)
    if not qs:
        return {"bad": 1, "dist_gap": 0.0, "kth_gap": 0.0, "order_gap": 0.0, "recall": 0.0,
                "sampled": 0}
    q = np.stack(qs)
    metric = inp.cfg["class"]["vectorIndexConfig"]["distance"]
    t_ids, t_d = reference.truth(q, inp.x, k, metric, device)
    out = reference.judge(q, inp.x, k, metric, np.asarray(ids), np.asarray(dists), t_ids, t_d,
                          order_tol)
    out["sampled"] = len(q)
    return out


def main(argv=None, fault: str = "") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the CPU rehearsal at tiny sizes (no card, no device numbers)")
    args = ap.parse_args(argv)

    import torch

    cell = spec.load_cell(args.workload)
    if not args.rehearse:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"needs {cell.chips} CUDA device(s); torch sees "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
    if not (spec.ROOT / "weaviate_tpu_torch" / "__init__.py").exists():
        log("the program (weaviate_tpu_torch) is not in this checkout")
        return 2
    sz = sizes(cell, args.rehearse)
    tmp = tempfile.mkdtemp(prefix="wbench-")
    srv = inp = None
    try:
        srv = start(cell, sz, args.seed, bool(args.trace), args.rehearse, fault, tmp)
        inp = Inputs(sz.cfg, sz.tr, args.seed)
        info = srv.wait_ready(1100)
        log(f"server ready: {info}")
        keep = load.Reservoir(int(sz.tr["sample_requests"]), args.seed)
        acked: dict = {}
        warm = load.Reservoir(0, 0)
        feed = inp.feed
        first = None
        if args.trace:
            # a process's first profiler session records no device work:
            # spend it on the warm-up
            first = threading.Thread(target=capture_trace, daemon=True,
                                     args=(srv, time.perf_counter() + 0.2, 0.5, {}))
            first.start()
        offer(srv, inp, float(sz.tr["warmup_s"]), warm, acked)
        if first is not None:
            first.join(300)
        s0 = srv.call("stats")
        io0 = srv.data_bytes()
        cap: dict = {}
        cap_thread = None
        if args.trace:
            cap_s = min(TRACE_SECONDS, args.seconds / 2)
            at = time.perf_counter() + args.seconds / 4
            cap_thread = threading.Thread(target=capture_trace, args=(srv, at, cap_s, cap),
                                          daemon=True)
            cap_thread.start()
        calib_before = hoststat.calib_ms()
        gc.collect()
        gc.freeze()
        gc.disable()  # no collector pauses in the clients during the window
        t_window = time.perf_counter()
        unix_window = time.time()
        setup_s = AGE_AT_T0 + (t_window - T0)
        cpu0 = hoststat.process_cpu_s(srv.proc.pid)
        win = offer(srv, inp, args.seconds, keep, acked)
        host = hoststat.server_cpu(srv.proc.pid, cpu0, win.end - win.start,
                                   sum(r.rows for r in win.reqs if r.ok))
        gc.enable()
        if feed is not None:
            feed.close()
        if cap_thread is not None:
            cap_thread.join(args.seconds + 600)
        io1 = srv.data_bytes()
        s1 = srv.call("stats")
        traces = []
        if args.trace:
            conn = load.Http(info["rest_port"], timeout=300)
            st, body = conn.request("GET", "/debug/traces")
            conn.close()
            t_end_unix = unix_window + args.seconds
            traces = [t for t in json.loads(body).get("traces", [])
                      if unix_window * 1e3 <= t.get("start_unix_ms", 0) <= t_end_unix * 1e3]
        rb = readback(srv, inp, acked, args.seed) if sz.tr["protocol"] == "rest_batch_import" \
            else None
        srv.stop()
        calib = hoststat.calib_ms()
        child_bad = s1.get("forbidden_modules") or []
        dev = None
        if args.trace:
            if "path" not in cap:
                raise ServerError(f"no device trace: {cap.get('error')}")
            dev = devtrace.read(cap["path"])
            if dev is None and not args.rehearse:
                raise ServerError("the device trace holds no work that ran on the card")

        # -- the check, after the program's state is freed
        device = "cpu" if args.rehearse else "cuda"
        limits = sz.cfg["limits"][sz.tr["protocol"]]
        failed = [r for r in win.reqs if not r.ok]
        if rb is None:
            readings = judge_search(inp, keep, device, float(limits["dist_gap"]))
            readings["bad"] += len(failed)
            checks = {n: readings[n] for n in ("bad", "dist_gap", "kth_gap")}
        else:
            readings = dict(rb)
            readings["missing"] += len(failed)
            checks = {n: readings[n] for n in ("missing", "vector_diff", "not_found")}
        correct = all(checks[n] <= limits[n] for n in checks)

        done_in = [r for r in win.reqs if r.ok and r.done <= win.end]
        rows_done = sum(r.rows for r in done_in)
        run = SimpleNamespace(
            cell=cell, config=sz.cfg, traffic=sz.tr, seconds=args.seconds, setup_s=setup_s,
            window=win, rows_done=rows_done, readings=readings, traces=traces, device=dev,
            capture=cap, data_bytes=io1 - io0,
            raw_lane_batches=s1["raw_lane_batches"] - s0["raw_lane_batches"],
            flushes=s1["segments_written"] - s0["segments_written"])
        wanted = cell.per_layer if args.trace else cell.end_to_end
        metrics = {}
        for m in wanted:
            v = spec.metric_reader(m["name"])(run)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {"correct": bool(correct), "attempted": len(win.reqs), "failed": len(failed),
                  "metrics": metrics}
        device_out = {"platform": "cpu" if args.rehearse else "gpu",
                      "kind": "cpu" if args.rehearse else s1.get("device_name"),
                      "count": cell.chips}
        if not args.rehearse:
            device_out["memory_peak_bytes"] = s1.get("memory_peak_bytes")
            device_out["power_limit"] = power_limit()
        if dev is not None:
            device_out["busy_s"] = dev.busy_s
            device_out["window_s"] = dev.window_s
        result["device"] = device_out
        if dev is not None:
            result["breakdown"] = {"device_ops": dev.device_ops, "idle_gaps": dev.idle_gaps}
        result["path"] = path_facts(run, sz.tr, len(win.reqs))
        result["host"] = {**host, "calib_ms_before": calib_before, "calib_ms_after": calib}
        result["setup"] = {k: v for k, v in info.items() if k.endswith("_s")}
        result["checks"] = {n: {"value": checks[n], "limit": limits[n]} for n in checks}
        if failed:
            log(f"{len(failed)} requests failed; the first: {failed[0].error}")
        bad = isolation.loaded()
        if bad or child_bad:
            log(f"loaded: {bad} in this process, {child_bad} in the server: no result")
            return 3
        log(f"path: {result['path']}; recall {readings.get('recall')}; "
            f"sampled {readings.get('sampled', readings.get('checked'))}")
        for n in checks:
            log(f"check {n} = {checks[n]!r} (limit {limits[n]!r})")
        print(json.dumps(result), flush=True)
        return 0
    except (ServerError, OSError, ValueError, KeyError) as e:
        log(f"run failed: {type(e).__name__}: {e}")
        if srv is not None:
            log(f"server log tail:\n{srv.log_tail()}")
        return 1
    finally:
        if inp is not None and inp.feed is not None:
            inp.feed.close()
        if srv is not None:
            srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def path_facts(run, tr: dict, attempted: int) -> dict:
    """Which path the traffic took (the share of BatchSearch requests the
    raw lane answered), the memtable flushes in the window, the rows done
    in each quarter of it, and the share of the window the clients spent
    between a reply and their next request."""
    q = (run.window.end - run.window.start) / 4
    out = {"memtable_flushes": run.flushes,
           "rows_by_quarter": [sum(r.rows for r in run.window.reqs if r.ok and
                                   run.window.start + i * q < r.done <= run.window.start
                                   + (i + 1) * q) for i in range(4)]}
    out["client_share"] = load.client_share(run.window)
    if tr["protocol"] == "grpc_batch_search":
        out["raw_lane_share"] = run.raw_lane_batches / max(attempted, 1)
    return out


if __name__ == "__main__":
    sys.exit(main())
