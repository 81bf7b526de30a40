"""Fault injection plane: named fault points compiled into the hot
paths as default-off no-ops (counterpart of
``keystone_tpu/loadgen/faults.py``: the injector and its arm/fire
surface).

The port wires the two points its serving path keeps:

- ``engine.dispatch.error`` — ``serving/engine.py`` ``compute_staged``
  raises ``FaultInjected``, failing the whole window;
- ``pipeline.host_prep.stall`` — ``serving/pipeline.py``'s host-prep
  stage sleeps ``delay_ms`` per window, backing pressure up through the
  bounded queues.

Cost contract: an UNARMED injector is a no-op on the hot path — one
attribute read and one falsy check (``fire`` returns before touching any
spec state). A spec can bound its own blast radius: ``count``
(auto-disarm after N fires), ``for_s`` (auto-disarm on a wall clock)
and ``match`` (fire only when the call site's context matches). Every
fire counts on ``keystone_fault_injections_total{point}``.

Not ported yet (they wait for the port's loadgen): ``parse_fault_spec``
and ``arm_from_env``, and the trigger points of the gateway.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

# the wired points: name -> (kind, where/what)
FAULT_POINTS: Dict[str, str] = {
    "pipeline.host_prep.stall": (
        "stall @ serving/pipeline.py host-prep stage — the stage "
        "sleeps delay_ms per window, backing pressure up through the "
        "bounded queues into admission (match: engine=<name>)"
    ),
    "engine.dispatch.error": (
        "error @ serving/engine.py compute_staged — the bucket "
        "dispatch raises, failing the whole window "
        "(match: engine=<name>)"
    ),
}


class FaultInjected(RuntimeError):
    """The typed error an armed error-mode fault point raises. Carries
    the point name so forensics can tell injected faults from real
    ones; to the request plane it is deliberately indistinguishable
    from any other engine failure (that is the experiment)."""

    def __init__(self, point: str, **ctx: Any):
        self.point = point
        self.ctx = ctx
        detail = " ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        super().__init__(
            f"injected fault {point}" + (f" ({detail})" if detail else "")
        )


@dataclasses.dataclass
class FaultSpec:
    """One armed fault point (see module docstring for semantics)."""

    point: str
    count: Optional[int] = None     # max fires; None = until disarmed
    delay_ms: float = 0.0           # stall points sleep this long
    for_s: Optional[float] = None   # auto-disarm this long after arming
    match: Optional[Dict[str, Any]] = None  # ctx filter (subset match)
    armed_t: float = 0.0            # perf_counter at arm time
    fired: int = 0

    def expired(self, now: float) -> bool:
        return (
            self.for_s is not None and now - self.armed_t > self.for_s
        )

    def matches(self, ctx: Optional[Dict[str, Any]]) -> bool:
        if not self.match:
            return True
        if not ctx:
            return False
        return all(ctx.get(k) == v for k, v in self.match.items())

    def status(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"point": self.point, "fired": self.fired}
        if self.count is not None:
            doc["count"] = self.count
        if self.delay_ms:
            doc["delay_ms"] = self.delay_ms
        if self.for_s is not None:
            doc["for_s"] = self.for_s
            doc["remaining_s"] = round(
                max(0.0, self.for_s - (time.perf_counter() - self.armed_t)),
                3,
            )
        if self.match:
            doc["match"] = dict(self.match)
        return doc


class FaultInjector:
    """Process-global registry of armed fault points.

    The hot-path contract lives in ``fire()``: with nothing armed it is
    one attribute read and a falsy return — no lock, no dict lookup, no
    allocation. Everything slower (spec resolution, expiry, match,
    counting) happens in ``_fire_slow`` only while at least one point
    is armed."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        self._specs: Dict[str, FaultSpec] = {}  # guarded-by: _lock
        # total fires per point, kept across disarms
        self._fired: Dict[str, int] = {}  # guarded-by: _lock
        # the hot-path gate: READ unlocked by design (one attribute
        # load per call site); every WRITE goes through _lock
        self.armed = False  # guarded-by: _lock
        self._registry = registry
        self._counter = None  # lazy: first arm touches the registry

    # -- hot path ----------------------------------------------------------

    def fire(
        self, point: str, ctx: Optional[Dict[str, Any]] = None
    ) -> Optional[FaultSpec]:
        """Ask whether ``point`` should fire. Returns the armed spec
        (the call site interprets it — raise or sleep ``delay_ms``) or
        None. The unarmed path is the no-op contract."""
        if not self.armed:
            return None
        return self._fire_slow(point, ctx)

    def _fire_slow(
        self, point: str, ctx: Optional[Dict[str, Any]]
    ) -> Optional[FaultSpec]:
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return None
            if spec.expired(time.perf_counter()):
                self._disarm_locked(point)
                return None
            if not spec.matches(ctx):
                return None
            spec.fired += 1
            self._fired[point] = self._fired.get(point, 0) + 1
            if spec.count is not None and spec.fired >= spec.count:
                self._disarm_locked(point)
            counter = self._counter
        if counter is not None:
            counter.inc((point,))
        logger.info("fault point %s fired (ctx=%s)", point, ctx)
        return spec

    # -- arming ------------------------------------------------------------

    def _ensure_counter(self):
        if self._counter is None:
            if self._registry is None:
                from keystone_tpu_torch.observability.registry import (
                    get_global_registry,
                )

                self._registry = get_global_registry()
            self._counter = self._registry.counter(
                "keystone_fault_injections_total",
                "chaos fault-point fires, by point",
                ("point",),
            )
        return self._counter

    def arm(
        self,
        point: str,
        *,
        count: Optional[int] = None,
        delay_ms: float = 0.0,
        for_s: Optional[float] = None,
        match: Optional[Dict[str, Any]] = None,
    ) -> FaultSpec:
        """Arm one point (re-arming replaces the spec)."""
        if count is not None and count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        if delay_ms < 0:
            raise ValueError(f"delay_ms must be >= 0, got {delay_ms}")
        spec = FaultSpec(
            point=point, count=count, delay_ms=float(delay_ms),
            for_s=for_s, match=dict(match) if match else None,
            armed_t=time.perf_counter(),
        )
        self._ensure_counter()
        with self._lock:
            self._specs[point] = spec
            self.armed = True
        logger.warning("fault point %s ARMED: %s", point, spec.status())
        return spec

    def _disarm_locked(self, point: str) -> bool:
        existed = self._specs.pop(point, None) is not None
        if not self._specs:
            self.armed = False
        return existed

    def disarm(self, point: str) -> bool:
        with self._lock:
            existed = self._disarm_locked(point)
        if existed:
            logger.warning("fault point %s disarmed", point)
        return existed

    def disarm_all(self) -> None:
        with self._lock:
            self._specs.clear()
            self.armed = False

    # -- introspection -----------------------------------------------------

    def status(self) -> Dict[str, Any]:
        with self._lock:
            # expire lazily so the surface never shows a dead spec
            now = time.perf_counter()
            for point in [
                p for p, s in self._specs.items() if s.expired(now)
            ]:
                self._disarm_locked(point)
            return {
                "armed": {
                    p: s.status() for p, s in sorted(self._specs.items())
                },
                "fired_total": dict(sorted(self._fired.items())),
                "points": dict(FAULT_POINTS),
            }

    def fired_count(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)


# -- the process-global injector (what the wired hot paths consult) --------

_INJECTOR = FaultInjector()


def get_injector() -> FaultInjector:
    return _INJECTOR


def armed() -> bool:
    """The hot-path GATE: call sites check this before building a ctx
    dict, so the unarmed path allocates nothing at all —
    ``if faults.armed() and faults.fire(point, {...}):``."""
    return _INJECTOR.armed


def fire(
    point: str, ctx: Optional[Dict[str, Any]] = None
) -> Optional[FaultSpec]:
    """The hot-path check the wired call sites use (delegates — the
    gate logic lives in ``FaultInjector.fire`` alone). Unarmed: one
    attribute read, returns None."""
    return _INJECTOR.fire(point, ctx)


def arm(point: str, **kwargs: Any) -> FaultSpec:
    return _INJECTOR.arm(point, **kwargs)


def disarm(point: str) -> bool:
    return _INJECTOR.disarm(point)


def disarm_all() -> None:
    _INJECTOR.disarm_all()


__all__ = [
    "FAULT_POINTS",
    "FaultInjected",
    "FaultInjector",
    "FaultSpec",
    "arm",
    "armed",
    "disarm",
    "disarm_all",
    "fire",
    "get_injector",
]
