"""The autoscale policy: fleet observations in, scaling decisions out
(counterpart of ``keystone_tpu/autoscale/policy.py``; pure Python, as
there).

The control loop's brain, deliberately PURE — no HTTP, no threads, no
clocks of its own. ``PolicyEngine.decide(n, obs)`` consumes one
``FleetObservation`` (what the controller scraped off the router's
``/metrics`` + ``/slz`` + ``/fleetz`` this tick) and the current
replica target, and returns a ``Decision``. All the judgement calls
live here where they are unit-testable with synthetic observations:

- **pressure signals** — a tick is *hot* when the fleet p99 breaches
  the SLO threshold or the fast-window burn rate says the error
  budget is being torched (``up_burn``); *cold* when the burn is back
  under ``down_burn`` AND the p99 sits inside the headroom band
  (``down_p99_headroom`` × threshold). Between the two is the
  hysteresis dead band: neither streak advances, so load flapping at
  the threshold can never oscillate the fleet.
- **phase attribution** — scale-out only helps when requests are
  waiting for CAPACITY. The per-request phase decomposition
  (``keystone_request_phase_seconds``) says where latency
  goes: a ``queue_wait``-dominated fleet gets more replicas; a
  ``device``-dominated one does not (the same requests would just
  queue on more devices' hosts) — the decision is vetoed with reason
  ``device_bound`` instead of burning money on replicas that can't
  help. Absent phase data (tracing off, no traffic) degrades to
  permitting the burn-driven decision, counted as such.
- **hysteresis + cooldowns** — ``up_consecutive`` / ``down_consecutive``
  hot/cold ticks in a row before acting, plus per-direction cooldowns
  after any action. Scale-down is additionally BANNED while any
  replica is half-open or benched unhealthy: a degraded fleet that
  looks over-provisioned is mid-recovery, not idle.
- **measured capacity** (optional) — a ``serve-capacity-plan``
  artifact carries the fitted per-replica request rate; when present
  the scale-up target jumps straight to
  ``ceil(offered_rps / (target_utilization × per_replica_rps))``
  instead of creeping one replica per cooldown window through a big
  step — the policy is measured, not guessed.

Every decision carries its reason and the observation that produced
it, so the controller can log/export/trace it verbatim.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List, Optional

# the phase names whose dominance means "more replicas help": time
# spent waiting for admission/coalescing capacity, not device compute
QUEUE_PHASES = ("queue_wait", "coalesce")

# phase whose dominance means "more replicas will NOT help"
DEVICE_PHASE = "device"


@dataclasses.dataclass
class FleetObservation:
    """One control-loop tick's view of the fleet, as scraped off the
    router (``controller.RouterScraper``). Every field is Optional or
    defaulted because a real scrape degrades: a dead replica, an
    empty fleet, tracing off — the policy must decide on partial
    evidence without inventing values."""

    t: float  # monotonic observation clock (the engine's cooldowns)
    replicas_total: int = 0
    replicas_ready: int = 0
    replicas_half_open: int = 0
    replicas_unhealthy: int = 0
    replicas_unreachable: int = 0
    fleet_p99_s: Optional[float] = None
    burn_fast: Optional[float] = None
    burn_slow: Optional[float] = None
    # did the /metrics scrape SUCCEED this tick? An idle fleet (scrape
    # fine, no traffic) and a blind one (scrape failed) both show
    # p99=None — only the former may ever read as cold
    metrics_ok: bool = False
    offered_rps: Optional[float] = None
    load_total: Optional[float] = None
    requests_total: Optional[float] = None  # cumulative router counter
    # the cumulative federated latency buckets this tick ({le: count};
    # the scraper windows successive snapshots into fleet_p99_s)
    latency_buckets: Dict[float, float] = dataclasses.field(
        default_factory=dict
    )
    # phase -> fraction of decomposed request time spent there, from
    # the stitched traces sampled this tick ({} = no phase evidence)
    phase_shares: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )

    @property
    def dominant_phase(self) -> Optional[str]:
        if not self.phase_shares:
            return None
        return max(self.phase_shares, key=self.phase_shares.get)

    def as_dict(self) -> Dict[str, Any]:
        doc = dataclasses.asdict(self)
        # the raw bucket snapshot is scrape plumbing, not something a
        # decision event should drag along
        doc.pop("latency_buckets", None)
        doc["dominant_phase"] = self.dominant_phase
        return doc


@dataclasses.dataclass
class Decision:
    """One tick's verdict: ``action`` is ``scale_up`` / ``scale_down``
    / ``hold``; ``target`` is the replica count the supervisor should
    converge to (unchanged on hold). ``reason`` explains the action
    OR the veto that blocked one — ``hold`` with reason
    ``device_bound`` is as informative as an action."""

    action: str
    target: int
    reason: str
    hot_streak: int = 0
    cold_streak: int = 0
    observation: Optional[FleetObservation] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "action": self.action,
            "target": self.target,
            "reason": self.reason,
            "hot_streak": self.hot_streak,
            "cold_streak": self.cold_streak,
            "observation": (
                self.observation.as_dict()
                if self.observation is not None
                else None
            ),
        }


@dataclasses.dataclass
class PolicyConfig:
    """The policy's knobs. Defaults are production-flavored (tens of
    seconds); the bench/smoke paths shrink them to single seconds —
    the ARITHMETIC is what's under test, not the wall clock."""

    min_replicas: int = 1
    max_replicas: int = 4
    # the latency objective the policy holds (None = burn-rate only)
    slo_latency_s: Optional[float] = None
    up_burn: float = 1.5
    down_burn: float = 0.5
    up_consecutive: int = 2
    down_consecutive: int = 4
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 60.0
    # scale-down needs the p99 comfortably inside the objective, not
    # just under it — the other half of the hysteresis band
    down_p99_headroom: float = 0.5
    # veto scale-up when the device phase outweighs the queue phases
    # in the decomposition (more replicas can't shorten device time)
    phase_veto: bool = True
    step_up: int = 1
    # measured capacity (serve-capacity-plan artifact); None = react
    # one step at a time
    per_replica_rps: Optional[float] = None
    target_utilization: float = 0.7

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})"
            )
        if self.down_burn >= self.up_burn:
            raise ValueError(
                f"need down_burn ({self.down_burn}) < up_burn "
                f"({self.up_burn}) — the gap IS the hysteresis band"
            )
        if self.up_consecutive < 1 or self.down_consecutive < 1:
            raise ValueError("consecutive tick counts must be >= 1")
        if self.step_up < 1:
            raise ValueError(f"step_up must be >= 1, got {self.step_up}")

    @classmethod
    def from_plan(cls, plan, **overrides) -> "PolicyConfig":
        """Build a config from a ``serve-capacity-plan`` artifact (a
        path or the loaded dict) — the measured-not-guessed path: the
        artifact's fitted ``per_replica_rps`` and derived thresholds
        seed the config, and explicit ``overrides`` win over both."""
        if isinstance(plan, (str, bytes)) or hasattr(plan, "__fspath__"):
            with open(plan, "r", encoding="utf-8") as f:
                plan = json.load(f)
        if not isinstance(plan, dict):
            raise ValueError(
                f"capacity plan must be a dict artifact, got "
                f"{type(plan).__name__}"
            )
        derived = dict(plan.get("policy") or {})
        fit = plan.get("fit") or {}
        if "per_replica_rps" not in derived and fit.get("per_replica_rps"):
            derived["per_replica_rps"] = fit["per_replica_rps"]
        slo = plan.get("slo") or {}
        if "slo_latency_s" not in derived and slo.get("latency_s"):
            derived["slo_latency_s"] = slo["latency_s"]
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(derived) - known
        if unknown:
            raise ValueError(
                f"capacity plan derives unknown policy fields "
                f"{sorted(unknown)} (have {sorted(known)})"
            )
        derived.update(overrides)
        return cls(**derived)


class PolicyEngine:
    """The stateful hysteresis machine over ``PolicyConfig``. One
    instance per control loop; ``decide`` is called once per tick
    from that single loop thread (no internal locking — the
    controller owns the cadence)."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config if config is not None else PolicyConfig()
        self._hot_streak = 0
        self._cold_streak = 0
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None

    # -- signal classification ---------------------------------------------

    def _is_hot(self, obs: FleetObservation) -> bool:
        cfg = self.config
        if (
            cfg.slo_latency_s is not None
            and obs.fleet_p99_s is not None
            and obs.fleet_p99_s > cfg.slo_latency_s
        ):
            return True
        return obs.burn_fast is not None and obs.burn_fast >= cfg.up_burn

    def _is_cold(self, obs: FleetObservation) -> bool:
        cfg = self.config
        if not obs.metrics_ok:
            # a failed scrape is blindness, not idleness: absent
            # evidence must never accumulate into shrinking a fleet
            # that may be under live load
            return False
        if obs.burn_fast is not None and obs.burn_fast > cfg.down_burn:
            return False
        if (
            cfg.slo_latency_s is not None
            and obs.fleet_p99_s is not None
            and obs.fleet_p99_s > cfg.slo_latency_s * cfg.down_p99_headroom
        ):
            return False
        return True

    def _device_bound(self, obs: FleetObservation) -> bool:
        """True when the phase decomposition says device compute, not
        capacity starvation, owns the latency — the scale-up veto. No
        phase evidence = not vetoed (burn/latency evidence stands
        alone, counted by the ``phase`` field of the decision's
        observation)."""
        if not self.config.phase_veto or not obs.phase_shares:
            return False
        device = obs.phase_shares.get(DEVICE_PHASE, 0.0)
        queued = sum(
            obs.phase_shares.get(p, 0.0) for p in QUEUE_PHASES
        )
        return device > queued

    def _desired_for_load(self, obs: FleetObservation, n: int) -> int:
        """The capacity-plan feed-forward: replicas the MEASURED
        per-replica rate says this offered load needs. Falls back to
        one step when the plan or the rate observation is absent."""
        cfg = self.config
        if (
            cfg.per_replica_rps
            and cfg.per_replica_rps > 0
            and obs.offered_rps is not None
        ):
            desired = math.ceil(
                obs.offered_rps
                / (cfg.target_utilization * cfg.per_replica_rps)
            )
            if desired > n + cfg.step_up:
                return desired
        return n + cfg.step_up

    # -- the decision ------------------------------------------------------

    def decide(self, n: int, obs: FleetObservation) -> Decision:
        """One tick: classify the observation, advance the streaks,
        apply vetoes, return the verdict. ``n`` is the CURRENT target
        the supervisor converges to (not the momentary process count
        — a replica mid-startup still counts toward the target)."""
        cfg = self.config
        hot, cold = self._is_hot(obs), self._is_cold(obs)

        def hold(reason: str) -> Decision:
            return Decision(
                "hold", n, reason,
                hot_streak=self._hot_streak,
                cold_streak=self._cold_streak,
                observation=obs,
            )

        if hot:
            self._cold_streak = 0
            self._hot_streak += 1
            if self._hot_streak < cfg.up_consecutive:
                return hold("hot_streak_building")
            if n >= cfg.max_replicas:
                return hold("at_max_replicas")
            if (
                self._last_up_t is not None
                and obs.t - self._last_up_t < cfg.up_cooldown_s
            ):
                return hold("up_cooldown")
            if self._device_bound(obs):
                # more replicas cannot shorten the device phase —
                # the one scale-out veto that outranks a burning SLO
                return hold("device_bound")
            target = min(cfg.max_replicas, self._desired_for_load(obs, n))
            self._last_up_t = obs.t
            self._hot_streak = 0
            return Decision(
                "scale_up", target,
                "slo_pressure" if (
                    cfg.slo_latency_s is not None
                    and obs.fleet_p99_s is not None
                    and obs.fleet_p99_s > cfg.slo_latency_s
                ) else "burn_rate",
                observation=obs,
            )

        self._hot_streak = 0
        if not cold:
            # the dead band between hot and cold: BOTH streaks reset,
            # which is what makes threshold flapping oscillation-proof
            self._cold_streak = 0
            return hold("in_band")

        self._cold_streak += 1
        if self._cold_streak < cfg.down_consecutive:
            return hold("cold_streak_building")
        if n <= cfg.min_replicas:
            return hold("at_min_replicas")
        if (
            self._last_down_t is not None
            and obs.t - self._last_down_t < cfg.down_cooldown_s
        ):
            return hold("down_cooldown")
        if obs.replicas_half_open > 0 or obs.replicas_unhealthy > 0:
            # mid-recovery fleets look idle precisely because a
            # replica is benched; shrinking now would be shooting the
            # survivor — a degraded fleet is banned from scaling down
            return hold("replica_recovering")
        self._last_down_t = obs.t
        self._cold_streak = 0
        return Decision(
            "scale_down", max(cfg.min_replicas, n - 1), "idle",
            observation=obs,
        )


def phase_shares(phase_ms_samples: List[Dict[str, float]]) -> Dict[str, float]:
    """Aggregate per-trace ``phases_ms`` maps (the router's ``/debugz``
    decomposition) into one share-of-total-time map — the policy's
    phase evidence. Empty in, empty out (absent, never zeros)."""
    sums: Dict[str, float] = {}
    for sample in phase_ms_samples:
        for phase, ms in (sample or {}).items():
            if ms is None:
                continue
            sums[phase] = sums.get(phase, 0.0) + float(ms)
    total = sum(sums.values())
    if total <= 0:
        return {}
    return {phase: ms / total for phase, ms in sums.items()}


__all__ = [
    "DEVICE_PHASE",
    "Decision",
    "FleetObservation",
    "PolicyConfig",
    "PolicyEngine",
    "QUEUE_PHASES",
    "phase_shares",
]
