"""Fault injection plane: named fault points compiled into the hot
paths as default-off no-ops (counterpart of
``keystone_tpu/loadgen/faults.py``).

The faults a production serving plane must absorb — a lane dying
mid-window, a stalled host-prep stage, a forced engine swap under peak —
are injected deliberately, at named points, while an experiment asserts
the system's invariants. The points live in the real hot paths
(``gateway/pool.py``, ``serving/engine.py``, ``serving/pipeline.py``,
``gateway/lifecycle.py``), so an experiment exercises exactly the code
traffic exercises.

Cost contract: an UNARMED injector is a no-op on the hot path — one
attribute read and one falsy check (``fire`` returns before touching
any spec state, allocating nothing).

Arming, three ways (all land in the same process-global registry):

- **code** — ``faults.arm("gateway.lane.kill", match={"lane": 0},
  count=8)``;
- **env** — ``KEYSTONE_FAULTS="pipeline.host_prep.stall=delay_ms:50
  gateway.lane.kill=lane:0,count:8"`` parsed by ``arm_from_env()``
  (the gateway's ``main`` calls it at startup);
- **HTTP** — ``POST /chaosz`` on the gateway frontend
  (``gateway/http.py``).

A spec can bound its own blast radius: ``count`` (auto-disarm after N
fires), ``for_s`` (auto-disarm on a wall clock), and ``match`` (fire
only when the call site's context matches, e.g. one lane of a pool).
Every fire counts on ``keystone_fault_injections_total{point}``.

Fault points are *interpreted by their call sites*: an error point
raises ``FaultInjected``, a stall point sleeps ``delay_ms``, and a
**trigger** point (``gateway.swap.force``) invokes callbacks registered
by the component (arming it IS the event). The catalog below is the
contract the ``/chaosz`` route validates against: the JAX package's
points, every one wired (``lifecycle.refit.poison`` in
``lifecycle/refit.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# the wired points: name -> (kind, where/what). /chaosz validates arms
# against this catalog; the injector itself accepts any name so tests
# and future subsystems can add points without touching this module.
FAULT_POINTS: Dict[str, str] = {
    "gateway.lane.kill": (
        "error @ gateway/pool.py Lane.submit — requests routed to the "
        "matched lane raise mid-flight; the pool's retry + health "
        "machinery must absorb it (match: lane=<index>)"
    ),
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
    "otlp.export.blackhole": (
        "drop @ observability/otlp.py — span batches are dropped "
        "instead of POSTed, simulating a dead collector with zero "
        "connect/timeout cost"
    ),
    "router.replica.blackhole": (
        "drop @ fleet/router.py _forward — the fleet router drops "
        "the matched replica's /predict responses after the replica "
        "did the work (a return-path partition); the router's "
        "retry-on-another-replica + replica health machinery must "
        "absorb it (match: replica=<host:port> or index=<registration "
        "order>)"
    ),
    "router.replica.partition": (
        "error @ fleet/router.py _forward — the router<->replica "
        "link is severed BEFORE the forward dials (the matched "
        "replica never sees the request; the request-path complement "
        "of router.replica.blackhole's return-path drop). The "
        "router's retry-on-another-replica + replica health must "
        "absorb it like a connection refusal — the autoscale drill "
        "partitions a replica mid-scale-up and the loadgen verdict "
        "must stay green (match: replica=<host:port> or "
        "index=<registration order>)"
    ),
    "lifecycle.refit.poison": (
        "corrupt @ lifecycle/refit.py RefitAccumulator — one "
        "accumulated feedback chunk's targets are scaled to garbage "
        "BEFORE they fold into the normal equations (the held-out "
        "buffer stays clean), so the next solved candidate is wrong; "
        "the lifecycle's accuracy gate must catch it on the held-out "
        "comparison and auto-roll the candidate back within one "
        "policy tick (match: model=<id>)"
    ),
    "router.trace.drop": (
        "drop @ fleet/router.py _predict — the W3C traceparent "
        "header is stripped off the matched forward, so the replica "
        "never sees the router's trace id and mints its own; serving "
        "must be unaffected and the router's /debugz stitch must "
        "degrade to a partial router-side tree counted on "
        "keystone_trace_stitch_partial_total (match: "
        "replica=<host:port> or index=<registration order>)"
    ),
    "gateway.swap.force": (
        "trigger @ gateway/lifecycle.py — arming forces one live "
        "engine swap (rebucket force=True) on a background thread "
        "(match: gateway=<name>)"
    ),
}

# points whose semantics are "arming IS the event" (no inline call
# site consults them): one-shot per arm, never left armed — a
# lingering trigger spec would pin the hot-path gate True with
# nothing to fire
TRIGGER_POINTS = frozenset({"gateway.swap.force"})


class FaultInjected(RuntimeError):
    """The typed error an armed error-mode fault point raises. Carries
    the point name so forensics can tell injected faults from real
    ones; to the request plane it is deliberately indistinguishable
    from any other lane/engine failure (that is the experiment)."""

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
        # point -> [(fn, ctx)]: components register trigger callbacks
        # (e.g. the gateway's forced-swap); arming the point invokes
        # them on a background thread
        self._triggers: Dict[str, List] = {}  # guarded-by: _lock
        # total fires per point, kept across disarms (the /chaosz
        # "fired" audit; the Prometheus counter is the scrape surface)
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
        (the call site interprets it — raise, sleep ``delay_ms``,
        drop) or None. The unarmed path is the no-op contract."""
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
        """Arm one point (re-arming replaces the spec). Trigger points
        invoke their registered callbacks once, on a daemon thread."""
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
            triggers = list(self._triggers.get(point, ()))
        logger.warning("fault point %s ARMED: %s", point, spec.status())
        to_run = [
            (fn, ctx) for fn, ctx in triggers if spec.matches(ctx)
        ]
        one_shot = bool(triggers) or point in TRIGGER_POINTS
        if one_shot and not to_run:
            # a trigger point with nothing to run (no component
            # registered, or the match excluded every registration):
            # disarm NOW — leaving it armed would pin the hot-path
            # gate forever with nothing to fire
            logger.warning(
                "fault point %s armed but no registered trigger "
                "matched; disarming", point,
            )
            self.disarm(point)
            return spec
        if to_run:

            def run_triggers():
                for fn, ctx in to_run:
                    fired = self._fire_slow(point, ctx)
                    if fired is None:
                        continue  # count/for_s exhausted mid-loop
                    try:
                        fn(fired)
                    except Exception:
                        logger.exception(
                            "fault trigger for %s failed", point
                        )
                # trigger points are one-shot per arm: the event has
                # happened, so the spec auto-disarms — a lingering
                # trigger spec would pin the hot-path gate True (and
                # the injector lock onto every request) forever.
                # Disarm only OUR spec: a re-arm that raced this
                # thread owns the slot now and must not be cancelled.
                with self._lock:
                    if self._specs.get(point) is spec:
                        self._disarm_locked(point)

            threading.Thread(
                target=run_triggers,
                name=f"keystone-chaos-{point}",
                daemon=True,
            ).start()
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

    # -- triggers (component-registered chaos actions) ---------------------

    def register_trigger(
        self,
        point: str,
        fn: Callable[[FaultSpec], None],
        ctx: Optional[Dict[str, Any]] = None,
    ) -> Callable[[], None]:
        """Register ``fn`` to run when ``point`` is armed (subject to
        the spec's ``match`` against ``ctx``). Returns an unregister
        callable — components MUST call it on close, or a retired
        instance keeps receiving chaos."""
        entry = (fn, dict(ctx) if ctx else None)
        with self._lock:
            self._triggers.setdefault(point, []).append(entry)

        def unregister() -> None:
            with self._lock:
                entries = self._triggers.get(point, [])
                if entry in entries:
                    entries.remove(entry)
                if not entries:
                    self._triggers.pop(point, None)

        return unregister

    # -- introspection (the /chaosz surface) -------------------------------

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


# -- env arming ------------------------------------------------------------

_SPEC_KEYS = ("count", "delay_ms", "for_s")


def parse_fault_spec(clause: str) -> Dict[str, Any]:
    """One ``point[=k:v[,k:v...]]`` clause -> arm() kwargs (plus
    ``point``). Keys outside count/delay_ms/for_s become ``match``
    entries; match values parse as int when they look like one."""
    clause = clause.strip()
    if not clause:
        raise ValueError("empty fault clause")
    point, _, argstr = clause.partition("=")
    point = point.strip()
    kwargs: Dict[str, Any] = {"point": point}
    match: Dict[str, Any] = {}
    if argstr.strip():
        for pair in argstr.split(","):
            key, sep, val = pair.partition(":")
            key, val = key.strip(), val.strip()
            if not sep or not key:
                raise ValueError(
                    f"bad fault arg {pair!r} in {clause!r} "
                    "(want key:value)"
                )
            if key == "count":
                kwargs["count"] = int(val)
            elif key == "delay_ms":
                kwargs["delay_ms"] = float(val)
            elif key == "for_s":
                kwargs["for_s"] = float(val)
            else:
                try:
                    match[key] = int(val)
                except ValueError:
                    match[key] = val
    if match:
        kwargs["match"] = match
    return kwargs


def arm_from_env(environ=None) -> List[FaultSpec]:
    """Parse ``KEYSTONE_FAULTS`` (whitespace-separated clauses, see
    ``parse_fault_spec``) and arm each point on the global injector.
    The serving CLIs call this at startup; absent/empty env is a
    no-op."""
    import os

    env = environ if environ is not None else os.environ
    raw = env.get("KEYSTONE_FAULTS", "").strip()
    if not raw:
        return []
    specs = []
    for clause in raw.split():
        kwargs = parse_fault_spec(clause)
        point = kwargs.pop("point")
        specs.append(_INJECTOR.arm(point, **kwargs))
    return specs


__all__ = [
    "FAULT_POINTS",
    "FaultInjected",
    "FaultInjector",
    "FaultSpec",
    "arm",
    "arm_from_env",
    "armed",
    "disarm",
    "disarm_all",
    "fire",
    "get_injector",
    "parse_fault_spec",
]
