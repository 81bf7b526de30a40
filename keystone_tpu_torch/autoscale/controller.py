"""The control loop: scrape the router, decide, converge the fleet
(counterpart of ``keystone_tpu/autoscale/controller.py``).

``RouterScraper`` turns one tick's worth of router surfaces into a
``FleetObservation``:

- ``GET /metrics`` (federated) — the fleet p99 from the merged
  ``keystone_gateway_request_latency_seconds`` ``le`` buckets (the
  TRUE fleet quantile), the offered request rate from the
  router's own ``keystone_router_requests_total`` deltas, and the
  summed replica load gauges;
- ``GET /slz`` — the fleet latency SLO's fast/slow burn rates;
- ``GET /fleetz`` — roster counts (healthy / half-open / unhealthy /
  unreachable) and readiness;
- ``GET /tracez`` + ``GET /debugz?trace_id=`` — PHASE EVIDENCE: a few
  recently-finished ``router.forward`` trace ids are sampled and
  stitched, and their ``phases_ms`` decompositions aggregated into
  per-phase shares. Stitching on the scrape path is deliberate —
  each stitched trace also lands on the
  ``keystone_request_phase_seconds{phase}`` histogram, so the signal
  the policy used is the signal an operator can scrape.

A scrape that fails entirely yields ``None`` (counted); partial
surfaces degrade to absent fields — the policy decides on what's
actually known, never on invented zeros.

``Autoscaler`` runs the tick on a daemon thread: reap dead replicas
(repair precedes policy — a kill -9'd replica is replaced regardless
of cooldowns), observe, decide, act through the supervisor. Every
decision is (1) a structured JSON event on the event sink, (2) an
``autoscale.decision`` span on the tracer, and (3) exported
as ``keystone_autoscale_*`` series.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from keystone_tpu_torch.autoscale.policy import (
    Decision,
    FleetObservation,
    PolicyEngine,
    phase_shares,
)
from keystone_tpu_torch.autoscale.supervisor import Supervisor
from keystone_tpu_torch.observability.prometheus import (
    parse_samples,
    quantile_from_buckets,
)
from keystone_tpu_torch.observability.registry import get_global_registry
from keystone_tpu_torch.observability.tracing import get_tracer

logger = logging.getLogger(__name__)

# the federated latency family the fleet p99 reads (fleet/router.py)
FLEET_LATENCY_FAMILY = "keystone_gateway_request_latency_seconds"

# replica load gauges summed into the fleet load observation
LOAD_FAMILIES = (
    "keystone_gateway_queue_depth",
    "keystone_gateway_inflight",
)

# stitched phase samples per tick: enough traces to smooth one odd
# request, few enough that the scrape stays cheap
PHASE_SAMPLES_PER_TICK = 4


class AutoscaleMetrics:
    """The ``keystone_autoscale_*`` export surface. Registered on the
    router process's registry so the federated ``/metrics`` carries
    the autoscaler's own series next to the fleet's."""

    def __init__(self, registry=None, autoscaler: str = "autoscaler"):
        reg = registry if registry is not None else get_global_registry()
        self.autoscaler = autoscaler
        self._decisions = reg.counter(
            "keystone_autoscale_decisions_total",
            "control-loop decisions by action (hold ticks included "
            "so the loop's liveness is scrape-visible)",
            ("autoscaler", "action"),
        )
        self._vetoes = reg.counter(
            "keystone_autoscale_vetoes_total",
            "scale decisions blocked, by veto reason (cooldowns, "
            "bounds, device_bound, replica_recovering)",
            ("autoscaler", "reason"),
        )
        self._replicas = reg.gauge(
            "keystone_autoscale_replicas",
            "replica count by kind: target (the policy's goal), "
            "running (live handles)",
            ("autoscaler", "kind"),
        )
        self._replaced = reg.counter(
            "keystone_autoscale_replicas_replaced_total",
            "dead replicas detected and replaced by the supervisor "
            "(repair, not scaling)",
            ("autoscaler",),
        )
        self._scrape_errors = reg.counter(
            "keystone_autoscale_scrape_errors_total",
            "control-loop ticks whose router scrape failed entirely",
            ("autoscaler",),
        )

    def record_decision(self, decision: Decision) -> None:
        self._decisions.inc((self.autoscaler, decision.action))
        if decision.action == "hold" and decision.reason in (
            "up_cooldown", "down_cooldown", "at_max_replicas",
            "at_min_replicas", "device_bound", "replica_recovering",
        ):
            self._vetoes.inc((self.autoscaler, decision.reason))

    def set_replicas(self, target: int, running: int) -> None:
        self._replicas.set(float(target), (self.autoscaler, "target"))
        self._replicas.set(float(running), (self.autoscaler, "running"))

    def record_replaced(self, n: int) -> None:
        self._replaced.inc((self.autoscaler,), by=float(n))

    def record_scrape_error(self) -> None:
        self._scrape_errors.inc((self.autoscaler,))

    def decision_count(self, action: str) -> float:
        return self._decisions.get((self.autoscaler, action))


def _scrape_stats(
    metrics_text: str,
) -> tuple:
    """ONE ``parse_samples`` pass over the federated body -> (latency
    buckets ``{le: count}`` collapsed across label sets, cumulative
    router request count, summed replica load). The exposition grows
    with the fleet and the loop ticks sub-second in drills — parsing
    it once per tick instead of per-question matters."""
    bucket_name = f"{FLEET_LATENCY_FAMILY}_bucket"
    buckets: Dict[float, float] = {}
    requests = load = None
    for name, labels, value in parse_samples(metrics_text):
        if name == bucket_name and "le" in labels:
            le = float(labels["le"])  # "+Inf" parses to math.inf
            buckets[le] = buckets.get(le, 0.0) + value
        elif name == "keystone_router_requests_total":
            requests = (requests or 0.0) + value
        elif name in LOAD_FAMILIES:
            load = (load or 0.0) + value
    return buckets, requests, load


def fleet_latency_buckets(metrics_text: str) -> Dict[float, float]:
    """The federated cumulative latency buckets of one ``/metrics``
    body, collapsed across label sets: ``{le: count}``. (The router's
    federation already dropped conflicting bucket layouts, so the
    per-``le`` sum is exact here.)"""
    return _scrape_stats(metrics_text)[0]


def windowed_p99(
    current: Dict[float, float], base: Optional[Dict[float, float]]
) -> Optional[float]:
    """The p99 of traffic BETWEEN two cumulative bucket snapshots —
    the delta of cumulative ``le`` counts is itself a histogram of
    exactly the window's requests, which is what a control loop must
    react to (the lifetime quantile never comes back down after one
    overload episode, so it could never say "scaled enough").

    Per-bucket deltas clamp at zero: a replica deregistering mid-run
    removes its counts from the federation, and a negative delta is
    membership churn, not traffic. None when the window saw no
    requests."""
    if not current:
        return None
    base = base or {}
    delta = [
        (le, max(0.0, count - base.get(le, 0.0)))
        for le, count in sorted(current.items())
    ]
    if not delta or delta[-1][1] <= 0:
        return None
    return quantile_from_buckets(0.99, delta)


def observation_from(
    metrics_text: Optional[str],
    slz_doc: Optional[Dict[str, Any]],
    fleetz_doc: Optional[Dict[str, Any]],
    phase_samples: List[Dict[str, float]],
    *,
    t: float,
    prev_requests: Optional[float] = None,
    prev_t: Optional[float] = None,
    prev_latency_buckets: Optional[Dict[float, float]] = None,
    slo_name_suffix: str = ":fleet_latency",
) -> FleetObservation:
    """Assemble one observation from the raw scraped surfaces — pure
    parsing, unit-testable on canned bodies. Absent surfaces leave
    their fields None/empty. The fleet p99 is WINDOWED against
    ``prev_latency_buckets`` when given (``windowed_p99``); without a
    baseline it is the lifetime quantile (first tick)."""
    obs = FleetObservation(t=t, phase_shares=phase_shares(phase_samples))
    if fleetz_doc:
        counts = fleetz_doc.get("counts") or {}
        obs.replicas_total = sum(counts.values())
        obs.replicas_half_open = counts.get("half-open", 0)
        obs.replicas_unhealthy = counts.get("unhealthy", 0)
        obs.replicas_unreachable = counts.get("unreachable", 0)
        obs.replicas_ready = sum(
            1
            for r in fleetz_doc.get("replicas", ())
            if r.get("ready") and r.get("healthy")
        )
    if metrics_text:
        buckets, requests, load = _scrape_stats(metrics_text)
        obs.metrics_ok = True
        obs.latency_buckets = buckets
        obs.fleet_p99_s = windowed_p99(buckets, prev_latency_buckets)
        obs.load_total = load
        obs.requests_total = requests
        if (
            requests is not None
            and prev_requests is not None
            and prev_t is not None
            and t > prev_t
        ):
            obs.offered_rps = max(
                0.0, (requests - prev_requests) / (t - prev_t)
            )
    if slz_doc:
        for slo in slz_doc.get("slos", ()):
            if str(slo.get("name", "")).endswith(slo_name_suffix):
                burns = slo.get("burn_rate") or {}
                obs.burn_fast = burns.get("fast")
                obs.burn_slow = burns.get("slow")
                break
    return obs


class RouterScraper:
    """One router's surfaces -> ``FleetObservation`` per tick (keeps
    the previous request-counter sample for the offered-rate delta
    and the set of already-stitched trace ids)."""

    def __init__(
        self,
        router_url: str,
        *,
        timeout_s: float = 10.0,
        phase_samples_per_tick: int = PHASE_SAMPLES_PER_TICK,
        p99_window_s: float = 15.0,
    ):
        self.router_url = router_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.phase_samples_per_tick = int(phase_samples_per_tick)
        # the windowed-p99 baseline: fleet_p99_s reflects the traffic
        # of roughly the last p99_window_s, not the process lifetime
        self.p99_window_s = float(p99_window_s)
        self._prev_requests: Optional[float] = None
        self._prev_t: Optional[float] = None
        # (t, cumulative bucket snapshot) history, oldest first
        self._bucket_history: List = []
        # roster membership of the last tick: a deregistered replica
        # REMOVES its counts from the federation, which would zero
        # every clamped delta and blind the windowed p99 for a whole
        # window — membership churn resets the baseline instead
        self._prev_roster: Optional[tuple] = None
        self._stitched: set = set()

    def _get(self, path: str) -> bytes:
        with urllib.request.urlopen(
            self.router_url + path, timeout=self.timeout_s
        ) as resp:
            return resp.read()

    def _get_json(self, path: str) -> Dict[str, Any]:
        return json.loads(self._get(path))

    def _sample_phases(self) -> List[Dict[str, float]]:
        """Recent ``router.forward`` trace ids off ``/tracez``, each
        stitched once via ``/debugz`` — the returned ``phases_ms``
        maps are the policy's phase evidence, and the stitch itself
        populates ``keystone_request_phase_seconds``."""
        try:
            spans = self._get_json("/tracez").get("spans", ())
        except Exception:
            return []
        tids: List[str] = []
        for span in reversed(list(spans)):  # newest last in the ring
            tid = span.get("trace_id")
            if (
                span.get("name") == "router.forward"
                and tid
                and tid not in self._stitched
                and tid not in tids
            ):
                tids.append(tid)
            if len(tids) >= self.phase_samples_per_tick:
                break
        samples = []
        for tid in tids:
            self._stitched.add(tid)
            try:
                doc = self._get_json(f"/debugz?trace_id={tid}")
            except Exception:
                continue
            phases = doc.get("phases_ms")
            if phases:
                samples.append(phases)
        # the stitched-id memory must not grow unbounded on a
        # long-lived autoscaler
        if len(self._stitched) > 4096:
            self._stitched = set(tids)
        return samples

    def observe(self) -> Optional[FleetObservation]:
        """One tick's observation, or None when even ``/fleetz`` was
        unreachable (the router itself is down — nothing to decide
        on)."""
        t = time.monotonic()
        try:
            fleetz = self._get_json("/fleetz")
        except Exception as e:
            logger.warning(
                "autoscale scrape: /fleetz unreachable: %s", e
            )
            return None
        roster = tuple(sorted(
            r.get("url", "") for r in fleetz.get("replicas", ())
        ))
        rebased = False
        if roster != self._prev_roster:
            if self._prev_roster is not None:
                # membership changed: the old cumulative baselines no
                # longer describe the same federation — rebase rather
                # than reading churn as zero traffic
                self._bucket_history = []
                rebased = True
            self._prev_roster = roster
        metrics_text = slz = None
        try:
            metrics_text = self._get("/metrics").decode("utf-8", "replace")
        except Exception:
            logger.debug("autoscale scrape: /metrics failed", exc_info=True)
        try:
            slz = self._get_json("/slz")
        except Exception:
            logger.debug("autoscale scrape: /slz failed", exc_info=True)
        obs = observation_from(
            metrics_text,
            slz,
            fleetz,
            self._sample_phases(),
            t=t,
            prev_requests=self._prev_requests,
            prev_t=self._prev_t,
            prev_latency_buckets=self._p99_baseline(t),
        )
        if rebased:
            # this tick's snapshot is the new baseline, so its window
            # holds no request yet. Without a baseline the p99 would be
            # the lifetime quantile of the remaining replicas: after a
            # scale-down, the overload the fleet has just absorbed
            # (seconds on a drained surge) read as pressure now, one
            # hot tick towards scaling straight back up.
            obs.fleet_p99_s = None
        self._prev_requests = obs.requests_total
        self._prev_t = t
        if obs.latency_buckets:
            self._bucket_history.append((t, dict(obs.latency_buckets)))
            # keep one sample older than the window (the baseline)
            horizon = t - self.p99_window_s
            while (
                len(self._bucket_history) > 2
                and self._bucket_history[1][0] <= horizon
            ):
                self._bucket_history.pop(0)
        return obs

    def _p99_baseline(self, now: float) -> Optional[Dict[float, float]]:
        """The newest bucket snapshot at least ``p99_window_s`` old
        (oldest available when history is younger — a young loop
        windows against what it has)."""
        base = None
        for t, buckets in self._bucket_history:
            if t <= now - self.p99_window_s:
                base = buckets
            else:
                break
        if base is None and self._bucket_history:
            base = self._bucket_history[0][1]
        return base


class Autoscaler:
    """The loop: reap -> observe -> decide -> act, every
    ``interval_s`` on a daemon thread. ``tick()`` is also directly
    callable (tests and the bench drive it synchronously)."""

    def __init__(
        self,
        supervisor: Supervisor,
        scraper: RouterScraper,
        engine: PolicyEngine,
        *,
        interval_s: float = 5.0,
        registry=None,
        name: str = "autoscaler",
        on_event: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        if interval_s <= 0:
            raise ValueError(
                f"interval_s must be > 0, got {interval_s}"
            )
        self.supervisor = supervisor
        self.scraper = scraper
        self.engine = engine
        self.interval_s = float(interval_s)
        self.name = name
        self.metrics = AutoscaleMetrics(
            registry=registry, autoscaler=name
        )
        self._on_event = on_event
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: List[Decision] = []  # newest last, bounded
        self.max_replicas_seen = 0

    def _emit(self, event: str, **fields: Any) -> None:
        doc = {"event": event, "autoscaler": self.name, **fields}
        logger.info("autoscale: %s", json.dumps(doc))
        if self._on_event is not None:
            try:
                self._on_event(doc)
            except Exception:
                logger.exception("autoscale event sink failed")

    def tick(self) -> Optional[Decision]:
        """One control iteration. Returns the decision (None when the
        router was unreachable)."""
        # repair FIRST, outside policy: a dead replica is replaced
        # regardless of streaks and cooldowns — holding the declared
        # target is the supervisor's job, changing it is the policy's
        replaced = self.supervisor.reap()
        if replaced:
            self.metrics.record_replaced(replaced)
            self._emit(
                "replicas_replaced", replaced=replaced,
                target=self.supervisor.target,
            )
        obs = self.scraper.observe()
        target = self.supervisor.target
        running = sum(
            1 for h in self.supervisor.replicas() if h.alive()
        )
        self.max_replicas_seen = max(self.max_replicas_seen, running)
        self.metrics.set_replicas(target, running)
        if obs is None:
            self.metrics.record_scrape_error()
            return None
        tracer = get_tracer()
        span = tracer.start_span(
            "autoscale.decision", autoscaler=self.name
        )
        decision = None
        try:
            decision = self.engine.decide(target, obs)
        finally:
            if decision is not None:
                span.set_attr("action", decision.action)
                span.set_attr("reason", decision.reason)
            tracer.end_span(span)
        self.metrics.record_decision(decision)
        self.decisions.append(decision)
        if len(self.decisions) > 512:
            del self.decisions[: len(self.decisions) - 512]
        if decision.action in ("scale_up", "scale_down"):
            span2 = tracer.start_span(
                f"autoscale.{decision.action}",
                autoscaler=self.name,
                reason=decision.reason,
                target=decision.target,
            )
            try:
                self.supervisor.scale_to(decision.target)
            finally:
                tracer.end_span(span2)
        self._emit(
            "autoscale_decision",
            action=decision.action,
            reason=decision.reason,
            target=decision.target,
            running=running,
            fleet_p99_ms=(
                round(obs.fleet_p99_s * 1e3, 3)
                if obs.fleet_p99_s is not None else None
            ),
            burn_fast=obs.burn_fast,
            offered_rps=(
                round(obs.offered_rps, 2)
                if obs.offered_rps is not None else None
            ),
            dominant_phase=obs.dominant_phase,
            replicas_half_open=obs.replicas_half_open,
        )
        return decision

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:
                    logger.exception(
                        "autoscale %s: tick failed", self.name
                    )

        self._thread = threading.Thread(
            target=loop,
            name=f"keystone-{self.name}-loop",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


__all__ = [
    "Autoscaler",
    "AutoscaleMetrics",
    "FLEET_LATENCY_FAMILY",
    "LOAD_FAMILIES",
    "RouterScraper",
    "fleet_latency_buckets",
    "observation_from",
    "windowed_p99",
]
