# The port's copy of weaviate_tpu/testing/faults.py, its imports pointed at the port.
"""Fault-injection harness for the port's serving path.

Robustness claims ("the breaker trips and host fallback serves", "a dead
flush thread can't hang a client") are only real if the failures they
defend against are REPRODUCIBLE. Real device faults — an allocator OOM
mid-dispatch, a failed kernel launch at fetch, a wedged kernel — can't be
summoned in CI, so the serving path carries NAMED INJECTION POINTS and
this module decides, deterministically, what happens at each one.

Injection points (the fault matrix; see docs/robustness.md):

  index.gpu.dispatch       device work enqueue (index/gpu.py
                           _dispatch_search) — device-error-on-dispatch
  index.gpu.finalize       the blocking device->host fetch — slow-kernel
                           stall, device-error-at-fetch
  index.gpu.alloc          store growth (index/gpu.py _ensure_capacity) —
                           allocator OOM on the write path
  db.shard.search          shard read entry (db/shard.py) — pre-dispatch
                           failure
  serving.coalescer.flush  the flush loop (serving/coalescer.py _run) —
                           flush-thread death (a BaseException that
                           escapes the loop's `except Exception` defense)
  serving.coalescer.dispatch  per-lane flush — lane dispatch failure
  serving.coalescer.admit  admission (serving/coalescer.py submit, before
                           any queue state is touched) — the
                           abusive-tenant storm journeys stall/fail
                           requests AT admission to stress the
                           weighted-fair queue under chaos
  serving.controller.tick  the control plane's tick loop (serving/
                           controller.py _run) — `die` kills the
                           controller thread (its finally must revert
                           every actuated knob to its configured
                           default: fail-static), `stall` freezes it
                           (module-read knob leases must lapse to
                           defaults); either way serving never degrades

Actions: ``device_error`` / ``oom`` raise errors that
``robustness.is_device_error`` recognizes (they carry ``device_error =
True``), ``stall`` sleeps, ``die`` raises ``InjectedThreadDeath``
(BaseException — deliberately uncatchable by `except Exception` so it
kills the hosting thread the way a real thread death would), and tests
may pass a callable.

Determinism: a plan fires on an exact firing-count window (``after`` /
``times``), or Bernoulli with probability ``p`` drawn from a
``random.Random(seed)`` owned by the injector — the same seed replays the
same failure schedule, so failure journeys are reproducible in CI.

Zero-cost when disabled (the tracing.py pattern): the module global is
None and ``fire()`` returns after one comparison — no locks, no dict
lookups, nothing allocated on the serving hot path.

Gating: tests call ``configure()`` directly; a running server enables it
via ``FAULT_INJECTION`` (spec string, parsed by ``from_spec``) +
``FAULT_INJECTION_SEED`` — config/config.py, wired in server/app.py.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Union


class FaultError(RuntimeError):
    """Base class for injected failures."""


class InjectedDeviceError(FaultError):
    """Stands in for a failed kernel launch or CUDA call at a dispatch
    boundary. ``device_error`` is the attribute contract
    robustness.is_device_error keys on (ops/_kernels.KernelLaunchError
    carries it too)."""

    device_error = True


class InjectedOOMError(InjectedDeviceError):
    """RESOURCE_EXHAUSTED / allocator-OOM analog."""


class InjectedThreadDeath(BaseException):
    """Deliberately a BaseException: escapes `except Exception` defenses,
    killing the hosting thread — the shape of a real thread death (C
    extension abort, MemoryError mid-handler) that liveness code must
    survive."""


_ACTIONS = ("device_error", "oom", "stall", "die")

Action = Union[str, Callable[[str], None]]


class _Plan:
    __slots__ = ("point", "action", "after", "times", "p", "stall_s", "hits")

    def __init__(self, point: str, action: Action, after: int, times:
                 Optional[int], p: float, stall_s: float):
        self.point = point
        self.action = action
        self.after = max(int(after), 0)
        self.times = times  # None = forever
        self.p = float(p)
        self.stall_s = float(stall_s)
        self.hits = 0  # times this plan actually fired


class FaultInjector:
    """Holds the failure schedule; thread-safe; deterministic per seed."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._plans: list[_Plan] = []
        self._fired: dict[str, int] = {}   # point -> firings observed
        self._injected: dict[str, int] = {}  # point -> faults injected

    def plan(self, point: str, action: Action = "device_error", *,
             times: Optional[int] = 1, after: int = 0, p: float = 1.0,
             stall_s: float = 0.05) -> "FaultInjector":
        """Inject `action` at `point`: skip the first `after` eligible
        firings, then inject on up to `times` of the following ones (None =
        every one), each gated by Bernoulli(p) on the injector's seeded
        rng. Returns self for chaining."""
        if isinstance(action, str) and action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(want one of {_ACTIONS} or a callable)")
        with self._lock:
            self._plans.append(_Plan(point, action, after, times, p, stall_s))
        return self

    def clear(self, point: Optional[str] = None) -> None:
        """Drop plans (all, or one point's) — 'the fault stops happening'."""
        with self._lock:
            self._plans = [pl for pl in self._plans
                           if point is not None and pl.point != point]

    def fired(self, point: str) -> int:
        """Times `point` was reached (injected or not)."""
        with self._lock:
            return self._fired.get(point, 0)

    def injected(self, point: Optional[str] = None) -> int:
        """Faults actually injected (at one point, or in total)."""
        with self._lock:
            if point is not None:
                return self._injected.get(point, 0)
            return sum(self._injected.values())

    def fire(self, point: str) -> None:
        """Decide-and-act for one arrival at `point`. The decision happens
        under the lock (counts + seeded rng draws stay deterministic under
        threads only when the arrival ORDER is deterministic — exact-count
        windows, the CI-friendly mode, are order-independent); the action
        runs outside it (a stall must not serialize unrelated points)."""
        act: Optional[tuple[Action, float]] = None
        with self._lock:
            self._fired[point] = self._fired.get(point, 0) + 1
            for pl in self._plans:
                if pl.point != point:
                    continue
                if pl.after > 0:
                    pl.after -= 1
                    continue
                if pl.times is not None and pl.hits >= pl.times:
                    continue
                if pl.p < 1.0 and self._rng.random() >= pl.p:
                    continue
                pl.hits += 1
                self._injected[point] = self._injected.get(point, 0) + 1
                act = (pl.action, pl.stall_s)
                break
        if act is None:
            return
        action, stall_s = act
        # journal the injection (monitoring/incidents.py): a seeded storm's
        # firings then appear in the incident bundle's journal tail next to
        # the breaker/shed events they caused — the fault matrix becomes
        # legible post-mortem. Burst-coalesced per point; one-comparison
        # no-op when the plane is off; lazy import keeps this module's
        # zero-dependency import contract.
        try:
            from weaviate_tpu_torch.monitoring import incidents

            incidents.emit("fault_injected", scope=point,
                           action=action if isinstance(action, str)
                           else "callable")
        except Exception:  # noqa: BLE001 — injection bookkeeping must not mask the fault
            pass
        if callable(action):
            action(point)
        elif action == "stall":
            time.sleep(stall_s)
        elif action == "oom":
            raise InjectedOOMError(
                f"injected RESOURCE_EXHAUSTED: allocator OOM at {point}")
        elif action == "die":
            raise InjectedThreadDeath(f"injected thread death at {point}")
        else:
            raise InjectedDeviceError(
                f"injected device failure at {point} "
                "(KernelLaunchError analog)")


def from_spec(spec: str, seed: int = 0) -> FaultInjector:
    """Parse the ``FAULT_INJECTION`` config string into an injector.

    Spec: semicolon-separated plans, each
    ``point:action[:key=value...]`` with keys ``times`` (int or ``inf``),
    ``after`` (int), ``p`` (float), ``stall_ms`` (float). Example::

        index.gpu.dispatch:device_error:times=inf:p=0.3;\
        serving.coalescer.flush:die:after=10
    """
    inj = FaultInjector(seed=seed)
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(
                f"invalid FAULT_INJECTION plan {part!r} (want point:action)")
        point, action = fields[0].strip(), fields[1].strip()
        kw: dict = {}
        for f in fields[2:]:
            if "=" not in f:
                raise ValueError(f"invalid FAULT_INJECTION option {f!r}")
            k, v = f.split("=", 1)
            k = k.strip()
            if k == "times":
                kw["times"] = None if v.strip() == "inf" else int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "p":
                kw["p"] = float(v)
            elif k == "stall_ms":
                kw["stall_s"] = float(v) / 1000.0
            else:
                raise ValueError(f"unknown FAULT_INJECTION option {k!r}")
        inj.plan(point, action, **kw)
    return inj


# -- module state + the zero-hop entry point ----------------------------------

_injector: Optional[FaultInjector] = None


def configure(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or clear, with None) the process-wide injector."""
    global _injector
    _injector = injector
    return injector


def unconfigure(injector: FaultInjector) -> None:
    """Clear only if still `injector` (App shutdown must not tear down a
    newer App's harness)."""
    global _injector
    if _injector is injector:
        _injector = None


def get_injector() -> Optional[FaultInjector]:
    return _injector


def fire(point: str) -> None:
    """The per-injection-point hook on the serving path. Disabled => one
    comparison, nothing else."""
    inj = _injector
    if inj is None:
        return
    inj.fire(point)
