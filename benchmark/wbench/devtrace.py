"""Reading the device trace that the server's `GET /debug/pprof/trace`
writes (torch.profiler's Chrome trace): when the card was busy, on what,
and what the host was doing while it was idle."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

# torch.profiler's categories of work that ran on the device
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver"}


@dataclass
class DeviceTrace:
    window_s: float                 # from the trace's first event to its last
    busy_s: float                   # union of the device's work intervals
    device_ops: list = field(default_factory=list)   # [[name, seconds]] by time
    idle_gaps: list = field(default_factory=list)    # [[what the host did, seconds]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals: list) -> tuple[float, list]:
    """-> (covered length, merged [start, end] list) of [start, end] pairs."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def read(path: str, top: int = 10) -> Optional[DeviceTrace]:
    """The trace at `path` -> DeviceTrace, or None when it holds no work
    that ran on the device (a CPU server, or a profiler that saw none)."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "ts" in e and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return None
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy_us, merged = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev])
    per: dict = {}
    for e in dev:
        per[e["name"]] = per.get(e["name"], 0.0) + float(e["dur"])
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps: between device intervals, inside the window
    gaps = []
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            gaps.append((e - s, s, e))
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") in HOST_CATS]
    named = []
    for length, s, e in gaps[:top]:
        # what the host did in the gap: the host op that covers most of it,
        # among ops no longer than twice the gap (an op around everything
        # says nothing about the gap), else among all
        overlap: dict = {}
        tight: dict = {}
        for h in host:
            hs, hd = float(h["ts"]), float(h["dur"])
            o = min(hs + hd, e) - max(hs, s)
            if o > 0:
                overlap[h["name"]] = overlap.get(h["name"], 0.0) + o
                if hd <= 2 * length:
                    tight[h["name"]] = tight.get(h["name"], 0.0) + o
        pick = tight or overlap
        what = (max(pick.items(), key=lambda kv: kv[1])[0] if pick
                else "no CUDA call (Python or native host work)")
        named.append([f"host: {what}"[:120], length / 1e6])
    return DeviceTrace(window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6,
                       device_ops=[[n[:120], us / 1e6] for n, us in ops],
                       idle_gaps=named)
