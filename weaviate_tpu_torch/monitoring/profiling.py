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
activity is recorded for the whole process, whichever thread launched it.
"""

from __future__ import annotations

import os
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


def device_trace(data_path: str, seconds: float = 3.0, device=None) -> str:
    """Capture a device trace for ?seconds — the port's twin of pprof's
    execution trace (the reference's /debug/pprof/trace). A torch.profiler
    session records the kernels and copies the card runs during the window
    (CUDA activities when `device` is a CUDA device) and the CPU ops; it
    writes one Chrome/Perfetto trace, trace.json, under
    <data>/traces/<stamp>/ and returns its path + file listing (view with
    ui.perfetto.dev or chrome://tracing). One capture at a time —
    concurrent requests get an explicit error, not a corrupt trace."""
    import glob
    import tempfile

    import torch

    if not _trace_lock.acquire(blocking=False):
        raise TraceBusyError("a device trace is already being captured")
    try:
        root = os.path.join(data_path, "traces")
        os.makedirs(root, exist_ok=True)
        # mkdtemp: consecutive captures in the same wall-clock second must
        # not merge into one trace directory
        out_dir = tempfile.mkdtemp(
            prefix=time.strftime("%Y%m%d-%H%M%S-"), dir=root)
        # arm the emergency teardown BEFORE starting: a SIGTERM landing
        # between start and the finally must still stop the capture
        # (atexit for normal exits; the chaining SIGTERM handler when one
        # could be installed — see install_trace_teardown)
        install_trace_teardown()
        prof = torch.profiler.profile(activities=_activities(device))
        with _teardown_lock:
            _teardown_state["active"] = True
            _teardown_state["profiler"] = prof
        prof.start()
        try:
            time.sleep(max(0.0, min(float(seconds), 60.0)))
        finally:
            stopped = stop_active_trace()
        if stopped:
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        files = sorted(
            os.path.relpath(p, out_dir)
            for p in glob.glob(os.path.join(out_dir, "**"), recursive=True)
            if os.path.isfile(p))
        return (f"device trace written to {out_dir}\n"
                + "".join(f"  {f}\n" for f in files)
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
