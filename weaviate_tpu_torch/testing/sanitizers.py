# The port's copy of weaviate_tpu/testing/sanitizers.py, its imports pointed at the port.
"""graftsan: runtime concurrency sanitizers for the serving plane.

docs/concurrency.md documents a lock hierarchy; graftlint's JGL005/JGL008/
JGL009 check it *lexically*, per file. Neither can see a sync hidden one
call deep at runtime, a lock-order inversion spanning two modules, or a
tick/audit thread that outlives its App. Before the dispatch-engine
refactor (ROADMAP items 2/5) rearranges ~10 concurrent module-global
threads against that hierarchy, this module makes the documented
discipline *witnessed*: a ThreadSanitizer-style runtime checker that
tier-1 runs under in CI (``GRAFTSAN=1``; tests/conftest.py).

Three sanitizers (enable subsets via ``GRAFTSAN=lock,sync,threads``):

  lock-order   Locks the serving modules construct are wrapped by
               ``register_lock(lock, name)`` in an order-witnessing proxy.
               Each blocking acquire records (held -> acquiring) edges into
               a global acquisition-order graph with both stacks; a cycle
               (the AB/BA shape) is a potential-deadlock violation even if
               the schedule never actually deadlocks, and an acquisition
               that *descends* the machine-readable hierarchy table
               (tools/graftsan/lock_hierarchy.json, the runtime twin of
               the docs/concurrency.md table) is a hierarchy violation.
  device-sync  The runtime twin of JGL001/JGL008: the port's device->host
               fetch points (``torch.cuda.synchronize`` and index/gpu.py
               ``_fetch_packed``, the one packed fetch of a dispatch)
               are patched to assert no registered index/shard lock
               (``no_fetch_under`` in the hierarchy table) is held at
               fetch time — catching what lexical analysis misses when
               the sync hides behind a helper function.
  thread-leak  Per-test thread snapshot diffing (tests/conftest.py): a
               test that leaks a non-daemon thread, or a daemon thread of
               a module-global serving plane (coalescer flusher,
               controller tick, audit workers, incident recorder) past
               its App shutdown / unconfigure, fails that test instead of
               surfacing later as a flaky cross-test timeout.

Zero-cost when disabled (the tracing/perf/faults lifecycle idiom): the
module global is ``None``, ``register_lock`` returns its argument after
one comparison (the serving path keeps its raw ``threading`` locks — no
proxy is ever constructed), and no fetch point is patched. Pinned by a
spy test through a real served search (tests/test_sanitizers.py).

Violations are deduplicated by key and checked against the shrink-only
runtime baseline (tools/graftsan/baseline.json): a justified pre-existing
hit (e.g. the mesh index's stop-the-world ``compact`` fetching under its
coarse lock) is recorded, counted, and waived; anything else fails the
test that triggered it and lands in the ``GRAFTSAN_REPORT_FILE`` JSON
report (``python -m tools.graftsan --report`` renders one).

Gating: tests/conftest.py configures from the ``GRAFTSAN`` env var
(parsed by ``parse_graftsan``); ci_check.sh exports ``GRAFTSAN=1`` for
the tier-1 stage. The module imports stdlib only — torch loads
lazily at configure time, so importing the registry costs nothing.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from typing import Optional

# the three sanitizer planes GRAFTSAN can enable
LOCK_ORDER = "lock"
DEVICE_SYNC = "sync"
THREAD_LEAK = "threads"
ALL_SANITIZERS = frozenset({LOCK_ORDER, DEVICE_SYNC, THREAD_LEAK})

_FALSY = frozenset({"", "0", "false", "no", "off"})
_TRUTHY = frozenset({"1", "true", "yes", "on", "all"})

# module-global thread-name prefixes the leak detector watches even though
# they are daemon threads: each belongs to a plane whose App shutdown /
# unconfigure MUST stop it — one leaking past teardown today survives
# silently until an unrelated test flakes on its background work
WATCHED_THREAD_PREFIXES = (
    "query-coalescer",
    "coalescer-dispatch",
    "serving-controller",
    "quality-audit-",
    "incident-recorder",
)

# tools/graftsan/lock_hierarchy.json + baseline.json, anchored at the repo
# root the way graftlint anchors its baseline (never the cwd)
_REPO_ROOT = os.path.realpath(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_HIERARCHY_PATH = os.path.join(
    _REPO_ROOT, "tools", "graftsan", "lock_hierarchy.json")
DEFAULT_BASELINE_PATH = os.path.join(
    _REPO_ROOT, "tools", "graftsan", "baseline.json")


def parse_graftsan(value: Optional[str]) -> frozenset:
    """``GRAFTSAN`` env value -> the set of enabled sanitizers.

    ``""``/``0``/``false`` -> none; ``1``/``true``/``all`` -> all three;
    a comma list (``lock,sync``) -> that subset. An unknown token raises
    ``ValueError`` — a typo'd sanitizer name must not silently run
    *nothing* and report green."""
    v = (value or "").strip().lower()
    if v in _FALSY:
        return frozenset()
    if v in _TRUTHY:
        return ALL_SANITIZERS
    out = set()
    for tok in v.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok not in ALL_SANITIZERS:
            raise ValueError(
                f"unknown GRAFTSAN sanitizer {tok!r} "
                f"(want 0/1 or a comma list of {sorted(ALL_SANITIZERS)})")
        out.add(tok)
    return frozenset(out)


def load_hierarchy(path: Optional[str] = None) -> dict:
    """lock_hierarchy.json -> {name: {level, no_fetch_under}}. Raises on a
    malformed table: a silently-empty hierarchy would witness nothing."""
    with open(path or DEFAULT_HIERARCHY_PATH, encoding="utf-8") as f:
        data = json.load(f)
    locks = data.get("locks")
    if not isinstance(locks, list) or not locks:
        raise ValueError("lock_hierarchy.json must hold a 'locks' list")
    out: dict[str, dict] = {}
    for e in locks:
        name = e.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError(f"lock hierarchy entry without a name: {e!r}")
        if name in out:
            raise ValueError(f"duplicate lock hierarchy entry {name!r}")
        if not isinstance(e.get("level"), int):
            raise ValueError(f"lock {name!r}: 'level' must be an int")
        out[name] = {"level": int(e["level"]),
                     "no_fetch_under": bool(e.get("no_fetch_under", False))}
    return out


def _load_baseline(path: Optional[str]) -> list[dict]:
    p = path or DEFAULT_BASELINE_PATH
    if not os.path.exists(p):
        return []
    with open(p, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", [])
    if not isinstance(entries, list):
        raise ValueError(f"{p}: baseline must hold an 'entries' list")
    return entries


class Violation:
    """One deduplicated sanitizer finding. ``key`` identifies the finding
    class (repeat occurrences bump ``count``); ``stacks`` carries the
    acquisition/fetch stacks of the FIRST occurrence."""

    __slots__ = ("kind", "key", "message", "stacks", "count", "baselined",
                 "justification")

    def __init__(self, kind: str, key: tuple, message: str,
                 stacks: list[str]):
        self.kind = kind
        self.key = key
        self.message = message
        self.stacks = stacks
        self.count = 1
        self.baselined = False
        self.justification: Optional[str] = None

    def render(self) -> str:
        head = f"[{self.kind}] {self.message} (x{self.count})"
        if self.baselined:
            head += f"  [baselined: {self.justification}]"
        return "\n".join([head] + [s.rstrip() for s in self.stacks])

    def as_dict(self) -> dict:
        return {"kind": self.kind, "key": list(self.key),
                "message": self.message, "count": self.count,
                "baselined": self.baselined,
                "justification": self.justification,
                "stacks": self.stacks}


def _grab_stack():
    """The acquisition stack, captured CHEAPLY: frame triples only, no
    source-line lookup (``lookup_lines=False`` defers linecache to
    render time, which only a violation ever reaches). Skips the
    sanitizer's own two frames. Kept fast because EVERY registered-lock
    acquire pays this — the witness must not reorder the races it
    watches more than it has to."""
    f = sys._getframe(2)
    return traceback.StackSummary.extract(
        traceback.walk_stack(f), limit=14, lookup_lines=False)


def _fmt_stack(stack) -> str:
    # captured innermost-first by walk_stack; render outermost-first the
    # way tracebacks read
    return "".join(traceback.format_list(list(reversed(stack))))


class _Held:
    """One entry of a thread's held-lock stack. ``stack`` is an
    unformatted traceback.StackSummary (formatting costs far more than
    extraction and is paid only when a violation reports it)."""

    __slots__ = ("lock", "count", "stack")

    def __init__(self, lock: "_SanLock", stack):
        self.lock = lock
        self.count = 1
        self.stack = stack


class _SanLock:
    """Order-witnessing proxy around a real Lock/RLock. The inner lock
    does the actual synchronization; the proxy only records held-lock
    stacks per thread and feeds the acquisition-order graph. Condition
    compatibility: threading.Condition binds ``acquire``/``release`` (and
    the ``_release_save`` family when present) off the object it is given
    — the proxy defines all of them so a Condition built over a
    registered lock keeps the bookkeeping exact across ``wait()``."""

    __slots__ = ("_inner", "name", "_san")

    def __init__(self, inner, name: str, san: "GraftSan"):
        self._inner = inner
        self.name = name
        self._san = san

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            # witness BEFORE blocking: the order fact exists whether or
            # not this schedule actually deadlocks
            self._san._note_acquiring(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._san._note_acquired(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._san._note_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    # -- threading.Condition integration (wait() releases then reacquires) --

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock: owned iff a non-blocking acquire fails (the stdlib
        # Condition fallback, done here so bookkeeping never sees it)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        if hasattr(self._inner, "_release_save"):
            state = self._inner._release_save()
        else:
            self._inner.release()
            state = None
        self._san._note_release_all(self)
        return state

    def _acquire_restore(self, state) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._san._note_acquiring(self)
        self._san._note_acquired(self)

    def __repr__(self) -> str:
        return f"<graftsan lock {self.name!r} over {self._inner!r}>"


class GraftSan:
    """The sanitizer registry + witness state. One instance is installed
    process-wide via ``configure``; tests may also construct private
    instances and drive them directly (tests/test_sanitizers.py)."""

    def __init__(self, enabled: frozenset = ALL_SANITIZERS,
                 hierarchy: Optional[dict] = None,
                 baseline: Optional[list] = None,
                 hierarchy_path: Optional[str] = None,
                 baseline_path: Optional[str] = None):
        self.enabled = frozenset(enabled)
        self.hierarchy = (hierarchy if hierarchy is not None
                          else load_hierarchy(hierarchy_path))
        self._baseline = (baseline if baseline is not None
                          else _load_baseline(baseline_path))
        self._tls = threading.local()          # .held: list[_Held]
        self._state_lock = threading.Lock()    # graph + violations (leaf:
        # nothing is acquired under it, so it can never join a cycle)
        # (from_name, to_name) -> {"stack_from", "stack_to", "thread"}
        self._edges: dict[tuple, dict] = {}
        self._violations: dict[tuple, Violation] = {}
        self._order: list[Violation] = []      # insertion order, for since()
        self.locks_registered: dict[str, int] = {}
        self.fetch_checks = 0                  # device-sync assertions run

    # -- registration ---------------------------------------------------------

    def wrap_lock(self, lock, name: str):
        # the device-sync sanitizer needs the held-lock bookkeeping the
        # proxy maintains — sync without lock must still proxy, or
        # check_fetch sees an empty held stack and silently reports green
        if not (self.enabled & {LOCK_ORDER, DEVICE_SYNC}):
            return lock
        with self._state_lock:
            self.locks_registered[name] = \
                self.locks_registered.get(name, 0) + 1
        return _SanLock(lock, name, self)

    # -- held-lock bookkeeping ------------------------------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_lock_names(self) -> list[str]:
        return [h.lock.name for h in self._held()]

    def _note_acquiring(self, lock: _SanLock) -> None:
        if LOCK_ORDER not in self.enabled:
            return  # proxied only for the sync sanitizer's held bookkeeping
        held = self._held()
        if not held:
            return  # first lock of this thread: no order fact to record
        if any(h.lock is lock for h in held):
            return  # re-entrant acquire of an RLock: not an ordering edge
        stack_to = _grab_stack()
        top = held[-1]
        self._record_edge(top, lock, stack_to)
        self._check_hierarchy(held, lock, stack_to)

    def _note_acquired(self, lock: _SanLock) -> None:
        held = self._held()
        for h in held:
            if h.lock is lock:
                h.count += 1
                return
        held.append(_Held(lock, _grab_stack()))

    def _note_released(self, lock: _SanLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                held[i].count -= 1
                if held[i].count == 0:
                    del held[i]
                return

    def _note_release_all(self, lock: _SanLock) -> None:
        """Condition.wait released the lock wholesale (RLock recursion
        included) — drop the whole entry."""
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                del held[i]
                return

    # -- the acquisition-order graph -----------------------------------------

    def _record_edge(self, frm: _Held, to: _SanLock, stack_to) -> None:
        """held(frm) -> acquiring(to). A new edge that closes a cycle in
        the graph is the AB/BA potential deadlock; report it with both
        acquisition stacks (this thread's, and the recorded stack of the
        reverse path's first edge)."""
        a, b = frm.lock.name, to.name
        if a == b:
            # two distinct same-name locks (two shards' "db.shard") held
            # together: legal nesting order is undefined but symmetric;
            # the hierarchy check stays silent and a self-edge would make
            # every pair a "cycle", so skip the graph too
            return
        with self._state_lock:
            is_new = (a, b) not in self._edges
            if is_new:
                self._edges[(a, b)] = {
                    "stack_from": frm.stack, "stack_to": stack_to,
                    "thread": threading.current_thread().name}
            if not is_new:
                return
            path = self._find_path(b, a)
        if path is not None:
            rev = self._edges.get((path[0], path[1]))
            rev_stack = _fmt_stack(rev["stack_to"]) if rev \
                else "<unrecorded>"
            cyc = " -> ".join([a, b] + path[1:])
            self._report(
                "lock-order-cycle", ("lock-order-cycle",) + tuple(
                    sorted((a, b))),
                f"lock acquisition cycle {cyc}: thread "
                f"{threading.current_thread().name!r} acquires {b!r} while "
                f"holding {a!r}, but the reverse order is also recorded — "
                "a schedule interleaving the two deadlocks",
                [f"--- this acquisition ({a} held, acquiring {b}):\n"
                 f"{_fmt_stack(stack_to)}",
                 f"--- reverse-order acquisition ({path[0]} held, "
                 f"acquiring {path[1]}, "
                 f"thread {rev['thread'] if rev else '?'}):\n{rev_stack}"])

    def _find_path(self, src: str, dst: str) -> Optional[list[str]]:
        """DFS over edge names: a path src ~> dst (callers hold
        _state_lock). Returns the node list, or None."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for (x, y) in self._edges:
                if x == node and y not in seen:
                    seen.add(y)
                    stack.append((y, path + [y]))
        return None

    def _check_hierarchy(self, held: list, to: _SanLock,
                         stack_to) -> None:
        lvl_to = self.hierarchy.get(to.name, {}).get("level")
        if lvl_to is None:
            return  # unregistered-in-table lock: cycle detection only
        worst = None
        for h in held:
            lvl = self.hierarchy.get(h.lock.name, {}).get("level")
            if lvl is not None and lvl > lvl_to and (
                    worst is None or lvl > worst[0]):
                worst = (lvl, h)
        if worst is None:
            return
        lvl, h = worst
        self._report(
            "hierarchy", ("hierarchy", h.lock.name, to.name),
            f"hierarchy violation: acquiring {to.name!r} (level {lvl_to}) "
            f"while holding {h.lock.name!r} (level {lvl}) — the "
            "lock_hierarchy.json order says the opposite nesting; thread "
            f"{threading.current_thread().name!r}",
            [f"--- holding {h.lock.name}:\n{_fmt_stack(h.stack)}",
             f"--- acquiring {to.name}:\n{_fmt_stack(stack_to)}"])

    # -- device-sync sanitizer ------------------------------------------------

    def check_fetch(self, point: str) -> None:
        """Assert no held registered lock forbids a device->host fetch.
        Called from the patched fetch points with a device value in hand."""
        with self._state_lock:
            self.fetch_checks += 1
        held = self._held()
        # innermost-first: when shard AND index locks are both held the
        # violation keys on the index lock — the most specific owner, and
        # the same key whether the call path entered through the shard or
        # hit the index directly (stable baseline keys)
        for h in reversed(held):
            if self.hierarchy.get(h.lock.name, {}).get("no_fetch_under"):
                site = _site_of(traceback.extract_stack())
                self._report(
                    "sync-under-lock",
                    ("sync-under-lock", h.lock.name, site),
                    f"device->host fetch ({point}) at {site} while holding "
                    f"{h.lock.name!r} — the snapshot plane's contract is "
                    "dispatch under the lock, fetch OUTSIDE it "
                    "(docs/concurrency.md); a helper hid this sync from "
                    "the lexical JGL008 check",
                    [f"--- fetch under {h.lock.name}:\n" + "".join(
                        traceback.format_stack(limit=20)[:-2]),
                     f"--- lock acquired at:\n{_fmt_stack(h.stack)}"])
                return

    # -- thread-leak sanitizer ------------------------------------------------

    @staticmethod
    def thread_snapshot() -> set:
        # Thread OBJECTS, not idents: the OS reuses pthread ids, so a
        # thread that exits mid-test can donate its ident to a freshly
        # leaked one and mask the leak nondeterministically
        return set(threading.enumerate())

    def leaked_threads(self, before: set, grace_s: float = 2.0) -> list:
        """Threads alive now, absent from ``before``, that the leak policy
        flags: any non-daemon thread, or a daemon thread of a watched
        module-global serving plane. Waits up to ``grace_s`` for
        stragglers whose stop was requested but not joined."""
        def suspects() -> list:
            out = []
            for t in threading.enumerate():
                if t in before or not t.is_alive() \
                        or t is threading.current_thread():
                    continue
                if not t.daemon or t.name.startswith(
                        WATCHED_THREAD_PREFIXES):
                    out.append(t)
            return out

        deadline = time.monotonic() + grace_s
        leaked = suspects()
        while leaked and time.monotonic() < deadline:
            for t in leaked:
                t.join(timeout=max(deadline - time.monotonic(), 0.01))
            leaked = suspects()
        for t in leaked:
            # per-instance key (the ident suffix): two tests each leaking
            # a same-named worker are two findings, not one deduped one —
            # a baseline entry may still waive by the ("thread-leak",
            # name) prefix
            self._report(
                "thread-leak", ("thread-leak", t.name, str(t.ident)),
                f"thread {t.name!r} (daemon={t.daemon}) leaked past its "
                "test — a tick/audit/flush thread that outlives its App "
                "shutdown/unconfigure works against freed state until an "
                "unrelated test flakes; use the configure/unconfigure "
                "fixtures (App.shutdown) instead of ad-hoc teardown", [])
        return leaked

    # -- violation store ------------------------------------------------------

    def _report(self, kind: str, key: tuple, message: str,
                stacks: list[str]) -> None:
        with self._state_lock:
            v = self._violations.get(key)
            if v is not None:
                v.count += 1
                return
            v = Violation(kind, key, message, stacks)
            for e in self._baseline:
                ek = tuple(e.get("key", ()))
                # an entry key may be a PREFIX of the violation key: a
                # thread-leak entry waives by name without the per-leak
                # ident suffix
                if e.get("kind") == kind and ek and key[:len(ek)] == ek:
                    v.baselined = True
                    v.justification = e.get(
                        "justification", "TODO: justify or fix")
                    break
            self._violations[key] = v
            self._order.append(v)

    def violations(self, baselined: bool = False) -> list[Violation]:
        with self._state_lock:
            return [v for v in self._order if baselined or not v.baselined]

    def mark(self) -> int:
        """Position in the violation stream; pair with ``since``."""
        with self._state_lock:
            return len(self._order)

    def since(self, mark: int) -> list[Violation]:
        """Unbaselined violations first seen after ``mark`` (repeat
        occurrences of an already-reported key do not re-fire)."""
        with self._state_lock:
            return [v for v in self._order[mark:] if not v.baselined]

    def report(self) -> dict:
        with self._state_lock:
            return {
                "enabled": sorted(self.enabled),
                "locks_registered": dict(self.locks_registered),
                "order_edges": [list(k) for k in sorted(self._edges)],
                "fetch_checks": self.fetch_checks,
                "violations": [v.as_dict() for v in self._order],
            }


def _site_of(frames) -> str:
    """The innermost weaviate_tpu_torch frame below the sanitizer itself — the
    function a violation is attributed to (and baselined by). Falls back
    to the innermost non-library frame (a test's seeded helper) so a
    violation outside the package still names its culprit."""
    fallback = "<unknown>"
    for fr in reversed(frames):
        fn = fr.filename.replace(os.sep, "/")
        if fn.endswith("testing/sanitizers.py"):
            continue
        if "weaviate_tpu" in fn:
            return fr.name
        if fallback == "<unknown>" and "site-packages" not in fn \
                and "/lib/python" not in fn:
            fallback = fr.name
    return fallback


# -- fetch-point patching -----------------------------------------------------

_patched: Optional[dict] = None  # original callables while patched
# set while inside the named _fetch_packed point: a synchronize inside it
# must not report a SECOND violation keyed on the '_fetch_packed' frame —
# one fetch, one violation, keyed on the CALLER's site (stable baseline)
_in_named_fetch = threading.local()


def _install_sync_patches() -> None:
    """Patch the port's device->host fetch points to route through
    ``check_fetch``: the index's one packed fetch
    (``index/gpu._fetch_packed``) and ``torch.cuda.synchronize``. Each
    wrapper reads the LIVE module global (the faults.fire idiom), so a
    cleared sanitizer costs one comparison even while the patches linger
    between configure cycles."""
    global _patched
    if _patched is not None:
        return
    import torch

    from weaviate_tpu_torch.index import gpu as gpu_mod

    orig_sync = torch.cuda.synchronize
    orig_fetch = gpu_mod._fetch_packed

    def synchronize(*args, **kw):
        san = _sanitizer
        if san is not None and DEVICE_SYNC in san.enabled \
                and not getattr(_in_named_fetch, "active", False):
            san.check_fetch("torch.cuda.synchronize")
        return orig_sync(*args, **kw)

    def fetch_packed(packed_dev, shape=None):
        # the named point checks ONCE (keyed on the caller's site) and
        # suppresses the inner patched points for the duration, so one
        # fetch is one violation a single baseline entry can waive
        san = _sanitizer
        if san is not None and DEVICE_SYNC in san.enabled:
            san.check_fetch("index.gpu._fetch_packed")
        _in_named_fetch.active = True
        try:
            return orig_fetch(packed_dev, shape)
        finally:
            _in_named_fetch.active = False

    torch.cuda.synchronize = synchronize
    gpu_mod._fetch_packed = fetch_packed
    _patched = {"sync": orig_sync, "fetch": orig_fetch}


def _remove_sync_patches() -> None:
    global _patched
    if _patched is None:
        return
    import torch

    from weaviate_tpu_torch.index import gpu as gpu_mod

    torch.cuda.synchronize = _patched["sync"]
    gpu_mod._fetch_packed = _patched["fetch"]
    _patched = None


# -- module state + the zero-hop entry points ---------------------------------

_sanitizer: Optional[GraftSan] = None


def configure(san: Optional[GraftSan]) -> Optional[GraftSan]:
    """Install (or clear, with None) the process-wide sanitizer."""
    global _sanitizer
    _sanitizer = san
    if san is not None and DEVICE_SYNC in san.enabled:
        _install_sync_patches()
    return san


def unconfigure(san: GraftSan) -> None:
    """Clear only if still ``san`` (the still-ours discipline every other
    module-global plane honors)."""
    global _sanitizer
    if _sanitizer is san:
        _sanitizer = None
        _remove_sync_patches()


def get_sanitizer() -> Optional[GraftSan]:
    return _sanitizer


def register_lock(lock, name: str):
    """The construction-time shim the serving modules call: wrap ``lock``
    in the order-witnessing proxy when the sanitizer is up, return it
    unchanged otherwise — one comparison, nothing constructed."""
    san = _sanitizer
    if san is None:
        return lock
    return san.wrap_lock(lock, name)
