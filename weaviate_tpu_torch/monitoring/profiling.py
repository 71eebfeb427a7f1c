# The port's copy of weaviate_tpu/monitoring/profiling.py, its imports pointed at the port.
"""Runtime profiling endpoints (the reference's pprof surface).

Reference: net/http/pprof is always mounted (adapters/handlers/rest/
configure_api.go:25) and setupGoProfiling (configure_api.go:679) turns on
block/mutex profiling from env flags. The Go runtime ships a sampling
profiler; Python does not — so the CPU profile here is a built-in wall-clock
stack sampler over `sys._current_frames()` (the same technique py-spy uses,
in-process): thread-aware, low overhead at the default 100 Hz, and needs no
instrumentation of the profiled code.

Endpoints (all GET, mounted on the main REST port like the reference):
  /debug/pprof/            index
  /debug/pprof/profile     sample all threads for ?seconds=N (default 5,
                           ?hz=100) -> collapsed-stack text (flamegraph
                           input format: "frame;frame;frame count")
  /debug/pprof/goroutine   one-shot dump of every live thread's stack
  /debug/pprof/heap        tracemalloc top allocation sites (?limit=30);
                           first call arms tracemalloc and reports that
  /debug/pprof/cmdline     process argv
  /debug/pprof/trace       device trace for ?seconds (torch.profiler)

The port's device trace is a `torch.profiler` session in place of the
JAX profiler: CPU and CUDA activities when the App runs on the card, CPU
only for an App on the CPU, written as one Chrome/Perfetto trace. CUDA
activity is recorded for the whole process, whichever thread launched it;
the profiler records CPU ops only of the thread that captures. So the
capture also writes the program's own spans (monitoring/tracing.py) of the
traces that ran in its window into the same trace.json, each on its
serving thread's track, on the profiler's clock: the offset between the
spans' perf_counter_ns and the profiler's timestamps is measured, not
assumed, from `weaviate.clock_sync` ranges the capture thread opens just
after the start and just before the stop. Leaf spans go out as
`user_annotation`, enclosing ones (a request's root, `dispatch`,
`device_search`, `shard.put_batch`) as `program`, and every exported event
is clipped to the profiler's first and last event, so the window the
trace spans is the profiler's own.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import traceback


class StackSampler:
    """Wall-clock sampling profiler over sys._current_frames()."""

    def __init__(self):
        self._lock = threading.Lock()  # one profile run at a time

    def profile(self, seconds: float = 5.0, hz: int = 100) -> str:
        seconds = max(0.05, min(float(seconds), 30.0))
        hz = max(1, min(int(hz), 1000))
        interval = 1.0 / hz
        counts: dict[tuple, int] = {}
        own = threading.get_ident()
        if not self._lock.acquire(timeout=1.0):
            raise RuntimeError("another profile is already running")
        try:
            deadline = time.monotonic() + seconds
            while time.monotonic() < deadline:
                for tid, frame in sys._current_frames().items():
                    if tid == own:
                        continue
                    stack = []
                    f = frame
                    while f is not None and len(stack) < 64:
                        code = f.f_code
                        stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
                        f = f.f_back
                    key = tuple(reversed(stack))
                    counts[key] = counts.get(key, 0) + 1
                time.sleep(interval)
        finally:
            self._lock.release()
        lines = [
            f"{';'.join(stack)} {n}"
            for stack, n in sorted(counts.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines) + ("\n" if lines else "")


def thread_dump() -> str:
    """All live threads with their current stacks (pprof /goroutine twin)."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        t = names.get(tid)
        label = t.name if t else "?"
        daemon = " daemon" if t is not None and t.daemon else ""
        out.append(f"thread {tid} [{label}]{daemon}:")
        out.extend(line.rstrip("\n") for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out) + "\n"


def heap_profile(limit: int = 30) -> str:
    """tracemalloc top allocation sites; arms tracing on first call (the
    price of not paying tracemalloc overhead when nobody is profiling)."""
    import tracemalloc

    limit = max(1, min(int(limit), 200))
    if not tracemalloc.is_tracing():
        tracemalloc.start(16)
        return (
            "tracemalloc armed by this request; allocations are tracked "
            "from now on — call /debug/pprof/heap again after the workload\n"
        )
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:limit]
    total = sum(s.size for s in snap.statistics("filename"))
    out = [f"total tracked: {total / 1024:.1f} KiB; top {len(stats)} by line:"]
    for s in stats:
        out.append(f"  {s.size / 1024:10.1f} KiB  {s.count:8d} blocks  {s.traceback}")
    return "\n".join(out) + "\n"


def cmdline() -> str:
    return "\x00".join(sys.argv) + "\n"


_trace_lock = threading.Lock()


class TraceBusyError(RuntimeError):
    """A device trace is already being captured (maps to HTTP 409)."""


# -- signal/atexit-safe capture teardown --------------------------------------
#
# A profiling session killed mid-capture must still be stopped: a started
# torch.profiler session without its stop leaves CUPTI's activity tracing
# armed until the process dies. The in-function try/finally covers
# exceptions; this covers the exits that skip finally blocks — SIGTERM's
# default handler and interpreter teardown — by stopping any active
# capture from an atexit hook and a chaining SIGTERM handler.

_teardown_state = {"active": False, "atexit_installed": False,
                   "signal_installed": False, "prev_sigterm": None,
                   "profiler": None}
_teardown_lock = threading.Lock()

# teardown hooks run AFTER the capture stop and BEFORE any signal
# re-delivery: the incident flight recorder (monitoring/incidents.py)
# chains its dump here, so a process dying mid-serve leaves a measured
# post-mortem (stop capture -> dump bundle -> re-deliver). Each hook is
# exception-guarded — teardown must never raise.
_teardown_hooks: list = []


def register_teardown_hook(fn) -> None:
    """Add `fn` to the SIGTERM/atexit teardown chain (idempotent per
    function object). Hooks must be safe to call at any time — they run
    with the process dying."""
    with _teardown_lock:
        if fn not in _teardown_hooks:
            _teardown_hooks.append(fn)


def _run_teardown_hooks() -> None:
    with _teardown_lock:
        hooks = list(_teardown_hooks)
    for fn in hooks:
        try:
            fn()
        except Exception:  # noqa: BLE001 — teardown must never raise
            pass


# A profiler session's whole life, from the warm session through the
# capture's stop, against the CUDA timing events of traced dispatches: a
# `cudaEventRecord` while the profiler starts or stops aborted the process
# on the card. `sessions` counts the lives under way, `users` the event
# calls under way; a life begins only once those have drained. Each start
# and stop of a session (`switching`) also waits for the dispatches' device
# work under way (`launching`, see `launching()`) and holds new work off:
# a stop while other threads replayed CUDA graphs hung the process. Those
# two counts sit under a plain lock of their own (`_launch_lock`), which a
# dispatch takes twice on its way in and out when no switch is under way.
_gate = threading.Condition()
_gate_state = {"sessions": 0, "users": 0, "switching": 0, "launching": 0}
_launch_lock = threading.Lock()
_no_switch = threading.Event()  # set while no start or stop is under way
_no_switch.set()
# how long a session, or one start or stop, waits for the calls under way
# (an event call takes microseconds, a dispatch's device work milliseconds)
_GATE_WAIT_S = 5.0
# how long a dispatch waits for a start or stop (the first session of a
# process takes ~10 s to start on the card)
_SWITCH_WAIT_S = 60.0


def hold_off() -> bool:
    """Keep a profiler session from starting until `let_go()`. -> False,
    and nothing held, when one is up already: the caller then skips its
    CUDA timing events."""
    with _gate:
        if _gate_state["sessions"]:
            return False
        _gate_state["users"] += 1
        return True


def let_go() -> None:
    """End a `hold_off()` that returned True."""
    with _gate:
        _gate_state["users"] -= 1
        if not _gate_state["users"]:
            _gate.notify_all()


class _Launching:
    """A dispatch's device work (its upload, its launches or its graph's
    replay, its fetch): never while a profiler session starts or stops.
    Waits for a start or stop under way (at most `_SWITCH_WAIT_S`)."""

    __slots__ = ()

    def __enter__(self):
        deadline = None
        while True:
            with _launch_lock:
                if not _gate_state["switching"] or (
                        deadline is not None and time.monotonic() >= deadline):
                    _gate_state["launching"] += 1
                    return self
            if deadline is None:
                deadline = time.monotonic() + _SWITCH_WAIT_S
            _no_switch.wait(max(deadline - time.monotonic(), 0.0))

    def __exit__(self, *exc):
        with _launch_lock:
            _gate_state["launching"] -= 1
        return False


_LAUNCHING = _Launching()


def launching() -> _Launching:
    """The context a dispatch's device work runs in (`_Launching`)."""
    return _LAUNCHING


@contextlib.contextmanager
def _switching(name: str = ""):
    """One start or stop of a profiler session: after the dispatches'
    device work under way (at most `_GATE_WAIT_S`), and before any more.
    With a `name`, traced as that span under the caller's: the time the
    switch holds new dispatches off."""
    from weaviate_tpu_torch.monitoring import tracing

    with tracing.span(name) if name else contextlib.nullcontext():
        with _launch_lock:
            _gate_state["switching"] += 1
            _no_switch.clear()
        deadline = time.monotonic() + _GATE_WAIT_S
        while _gate_state["launching"] and time.monotonic() < deadline:
            time.sleep(0.0002)
        try:
            yield
        finally:
            with _launch_lock:
                _gate_state["switching"] -= 1
                if not _gate_state["switching"]:
                    _no_switch.set()


def _begin_session() -> None:
    with _gate:
        _gate_state["sessions"] += 1
        _gate.wait_for(lambda: not _gate_state["users"], timeout=_GATE_WAIT_S)


def _end_session() -> None:
    with _gate:
        _gate_state["sessions"] -= 1


def stop_active_trace() -> bool:
    """Stop the active device-trace capture if one is running. Idempotent
    and exception-proof — safe from atexit, a signal handler, or the
    capture's own finally. -> True when a capture was actually stopped."""
    with _teardown_lock:
        if not _teardown_state["active"]:
            return False
        _teardown_state["active"] = False
        prof = _teardown_state["profiler"]
        _teardown_state["profiler"] = None
    try:
        prof.stop()
        return True
    except Exception:  # noqa: BLE001 — teardown must never raise
        return False


def _atexit_teardown() -> None:
    """Normal-exit half of the teardown: stop any active capture, then run
    the chained hooks (a cleanly shut-down App has already unconfigured
    its recorder, so its hook no-ops; an App still live at exit dumps)."""
    stop_active_trace()
    _run_teardown_hooks()


def _sigterm_teardown(signum, frame):
    # stop capture -> dump bundle -> re-deliver: the hooks (the incident
    # recorder's dump) run after the profiler stop so the bundle never
    # races an armed device capture, and before re-delivery so the
    # process's exit status is unchanged
    stop_active_trace()
    _run_teardown_hooks()
    prev = _teardown_state["prev_sigterm"]
    import signal as _signal

    if prev is _signal.SIG_IGN:
        # the process had deliberately ignored SIGTERM before the
        # teardown was installed — honor that: stop the capture, swallow
        # the signal (re-delivering would turn an ignored signal fatal)
        return
    if callable(prev):
        prev(signum, frame)
    else:
        # restore the default disposition and re-deliver, so the process
        # still dies with the SIGTERM exit status the supervisor expects
        _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_trace_teardown() -> bool:
    """Arm the atexit + SIGTERM teardown for device-trace captures. Called
    from App startup (likely the main thread — only the main thread may
    install signal handlers; elsewhere the atexit hook still arms and the
    call reports False for the signal half). Idempotent; the signal half
    latches only on SUCCESS, so a first call off the main thread does not
    forfeit a later main-thread install."""
    import atexit
    import signal as _signal

    with _teardown_lock:
        if _teardown_state["signal_installed"]:
            return True
        if not _teardown_state["atexit_installed"]:
            _teardown_state["atexit_installed"] = True
            atexit.register(_atexit_teardown)
    try:
        prev = _signal.getsignal(_signal.SIGTERM)
        if prev is _sigterm_teardown:  # foreign reinstall of our handler
            prev = None
        _signal.signal(_signal.SIGTERM, _sigterm_teardown)
        with _teardown_lock:
            _teardown_state["prev_sigterm"] = prev
            _teardown_state["signal_installed"] = True
        return True
    except (ValueError, OSError):
        # not the main thread (a REST handler racing App init) — atexit
        # still protects normal exits; a later main-thread call retries
        return False


def _activities(device):
    """torch.profiler activities for an App on `device`: CPU and CUDA on
    the card, CPU only on the CPU."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


# devices a profiler session has run on in this process (see warm)
_warmed: set = set()

CLOCK_MARK = "weaviate.clock_sync"
# ranges a sync point opens. A range's start less the perf_counter_ns read
# just before it is an upper bound of the clocks' offset, loose only when
# the thread was held up between the two, so a sync point reads the
# smallest of its ranges'. (A read inside the range is no use: entering it
# can give up the GIL, and under load every range then waits for it.)
_MARKS = 16


def warm(device) -> None:
    """Run one short profiler session with a device op in it, once per
    process and device, before a capture's own. The profiler's first
    session initialises Kineto, which on the card takes ~10 s when begun
    off the thread that imported torch (a REST handler's): spent here, a
    process's first capture then records the window it was asked for, not
    whatever is left of it."""
    import torch

    key = str(device)
    if key in _warmed:
        return
    prof = torch.profiler.profile(activities=_activities(device))
    with _switching("profiler.warm_start"):
        prof.start()
    try:
        if device is not None and torch.device(device).type == "cuda":
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)
    finally:
        with _switching("profiler.warm_stop"):
            prof.stop()
    _warmed.add(key)


def _clock_marks() -> list[int]:
    """Open `_MARKS` profiler ranges named CLOCK_MARK on this thread; ->
    the perf_counter_ns (the spans' clock) read just before each."""
    import torch

    out = []
    for _ in range(_MARKS):
        out.append(time.perf_counter_ns())
        with torch.profiler.record_function(CLOCK_MARK):
            pass
    return out


def _tracks(spans: list, events: list) -> dict:
    """{a span's thread (native id): the track the profiler gave it}. The
    profiler names a thread by its native id, by the low 32 bits of its
    pthread id, or by an id it kept from an earlier thread of the same
    pthread id; so each thread takes the track whose host events (CUDA
    runtime calls, CPU ops) fall most often inside its leaf spans, one
    thread a track."""
    host = sorted((float(e["ts"]), e.get("tid")) for e in events
                  if e.get("cat") in ("cuda_runtime", "cpu_op") and "ts" in e)
    at = [t for t, _ in host]
    votes: dict = {}
    for e in spans:
        if e["cat"] != "user_annotation":
            continue
        v = votes.setdefault(e["tid"], {})
        for _, tid in host[bisect.bisect_left(at, e["ts"]):
                           bisect.bisect_right(at, e["ts"] + e["dur"])]:
            v[tid] = v.get(tid, 0) + 1
    out: dict = {}
    for n, native, tid in sorted(((n, native, tid) for native, v in votes.items()
                                  for tid, n in v.items()), reverse=True):
        if native not in out and tid not in out.values():
            out[native] = tid
    return out


def _span_events(d: dict, t0_ns: int, offset_us: float, pid, lo: float,
                 hi: float, args: dict, out: list) -> None:
    """The span tree `d` (a /debug/traces root or child; its `start_ms`
    relative to `t0_ns`) as Chrome events on the profiler's clock, clipped
    to [lo, hi]."""
    dur = d.get("duration_ms")
    if dur is not None:
        start = t0_ns / 1e3 + d.get("start_ms", 0.0) * 1e3 + offset_us
        s, e = max(start, lo), min(start + dur * 1e3, hi)
        if e > s:
            ev_args = dict(args)
            if d.get("cpu_ms") is not None:
                ev_args["cpu_ms"] = d["cpu_ms"]
            ev_args.update(d.get("attrs") or {})
            out.append({"ph": "X", "name": d["name"], "pid": pid,
                        "tid": d.get("tid"), "ts": s, "dur": e - s,
                        "cat": "program" if d.get("children") else "user_annotation",
                        "args": ev_args})
    for c in d.get("children", ()):
        _span_events(c, t0_ns, offset_us, pid, lo, hi, args, out)


def export_spans(path: str, marks: list[int], traces: list) -> dict:
    """Measure the clock offset from the trace's CLOCK_MARK ranges and the
    `marks` read just before them (half after the start, half before the
    stop), then write the spans of `traces` (`Tracer.timed()` entries)
    that overlap the profiler's window into the trace at `path`, each on
    its thread's track. -> the clock reading ({offset_us, drift_us}: the
    mean and the difference of the two sync points' offsets), also stored
    in the trace as `weaviateClockSync`; {} when the trace does not hold
    the marks."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    sync = sorted((e for e in events if e.get("name") == CLOCK_MARK
                   and e.get("ph") == "X"), key=lambda e: float(e["ts"]))
    if len(sync) != len(marks) or not marks:
        return {}
    offs = [float(e["ts"]) - m / 1e3 for e, m in zip(sync, marks)]
    half = len(offs) // 2
    first, last = min(offs[:half]), min(offs[half:])
    clock = {"offset_us": (first + last) / 2, "drift_us": last - first}
    timed = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    pid = sync[0].get("pid")
    spans: list = []
    for t0_ns, tr in traces:
        root = dict(tr["root"], name=f"{tr['kind']} {tr['name']}")
        _span_events(root, t0_ns, clock["offset_us"], pid, lo, hi,
                     {"trace_id": tr["trace_id"]}, spans)
    tracks = _tracks(spans, events)
    for e in spans:
        e["tid"] = tracks.get(e["tid"], e["tid"])
    # the spans first: a reader that names a stretch by the event covering
    # most of it, first one winning a tie, then names it by a leaf span
    # rather than by the CUDA call inside that span
    doc["traceEvents"] = spans + events
    doc["weaviateClockSync"] = dict(clock, spans=len(spans))
    with open(path, "w") as f:
        f.write(json.dumps(doc))  # the C encoder: json.dump's is ~6x slower
    return clock


def _merge_spans(path: str, marks: list[int], traces: list) -> bool:
    """`export_spans` in a child process of its own: parsing and writing a
    trace of tens of MB holds the GIL for seconds, which would stall the
    serving threads. This file runs as the child's script (its imports are
    the standard library's). -> whether the merge succeeded."""
    side = path + ".spans.json"
    with open(side, "w") as f:
        f.write(json.dumps({"marks": marks, "traces": traces}))
    try:
        done = subprocess.run([sys.executable, "-I", os.path.abspath(__file__), path, side],
                              stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                              timeout=600)
    except subprocess.TimeoutExpired:
        return False
    finally:
        os.remove(side)
    return done.returncode == 0


def device_trace(data_path: str, seconds: float = 3.0, device=None) -> str:
    """Capture a device trace for ?seconds — the port's twin of pprof's
    execution trace (the reference's /debug/pprof/trace). A torch.profiler
    session records the kernels and copies the card runs during the window
    (CUDA activities when `device` is a CUDA device) and the CPU ops of
    this thread; it writes one Chrome/Perfetto trace, trace.json, under
    <data>/traces/<stamp>/ with the program's spans laid in
    (`export_spans`), and returns its path + file listing (view with
    ui.perfetto.dev or chrome://tracing). From before the warm session to
    after the stop no traced dispatch records a CUDA timing event
    (`hold_off`). One capture at a time — concurrent requests get an
    explicit error, not a corrupt trace."""
    import glob
    import tempfile

    import torch

    from weaviate_tpu_torch.monitoring import tracing

    if not _trace_lock.acquire(blocking=False):
        raise TraceBusyError("a device trace is already being captured")
    try:
        root = os.path.join(data_path, "traces")
        os.makedirs(root, exist_ok=True)
        # mkdtemp: consecutive captures in the same wall-clock second must
        # not merge into one trace directory
        out_dir = tempfile.mkdtemp(
            prefix=time.strftime("%Y%m%d-%H%M%S-"), dir=root)
        # a root of its own (the REST route is untraced): the spans of the
        # session's starts and stops, how long each held the dispatches off
        with tracing.request("profiler", "device_trace"):
            _begin_session()
            try:
                warm(device)
                # arm the emergency teardown BEFORE starting: a SIGTERM landing
                # between start and the finally must still stop the capture
                # (atexit for normal exits; the chaining SIGTERM handler when one
                # could be installed — see install_trace_teardown)
                install_trace_teardown()
                prof = torch.profiler.profile(activities=_activities(device))
                with _teardown_lock:
                    _teardown_state["active"] = True
                    _teardown_state["profiler"] = prof
                with _switching("profiler.start"):
                    t_on = time.perf_counter_ns()
                    prof.start()
                marks: list[int] = []
                try:
                    marks += _clock_marks()
                    time.sleep(max(0.0, min(float(seconds), 60.0)))
                    marks += _clock_marks()
                finally:
                    with _switching("profiler.stop"):
                        stopped = stop_active_trace()
            finally:
                _end_session()
        t_off = time.perf_counter_ns()
        merged = ""
        if stopped:
            path = os.path.join(out_dir, "trace.json")
            prof.export_chrome_trace(path)
            tracer = tracing.get_tracer()
            if tracer is not None:
                # the traces that overlap the capture
                traces = [(t0, tr) for t0, tr in tracer.timed()
                          if t0 <= t_off and t0 + (tr["duration_ms"] or 0.0) * 1e6 >= t_on]
                if not _merge_spans(path, marks, traces):
                    merged = "the program's spans could not be merged into it\n"
        files = sorted(
            os.path.relpath(p, out_dir)
            for p in glob.glob(os.path.join(out_dir, "**"), recursive=True)
            if os.path.isfile(p))
        return (f"device trace written to {out_dir}\n"
                + "".join(f"  {f}\n" for f in files) + merged
                + "view: ui.perfetto.dev or chrome://tracing\n")
    finally:
        _trace_lock.release()


def index() -> str:
    return (
        "/debug/pprof/\n"
        "  profile?seconds=5&hz=100  sampled CPU profile (collapsed stacks)\n"
        "  trace?seconds=3           device trace (torch.profiler: kernels, copies)\n"
        "  goroutine                 all thread stacks\n"
        "  heap?limit=30             tracemalloc top allocation sites\n"
        "  cmdline                   process argv\n"
    )


if __name__ == "__main__":
    # python -I profiling.py TRACE SIDE: merge SIDE's marks and traces into TRACE
    with open(sys.argv[2]) as f:
        side = json.load(f)
    export_spans(sys.argv[1], side["marks"], side["traces"])
