"""PromotionPolicy: the pure candidate → promoted/rolled_back state
machine (counterpart of ``keystone_tpu/lifecycle/policy.py``; pure
Python).

Nothing in here touches engines, threads, or metrics — ``tick`` maps
``(PolicyState, GateInputs) -> (PolicyState, reason)`` and is exactly
as testable as that sounds. The controller (``controller.py``) owns
the side effects (arming the shadow mirror, setting the canary
fraction, swapping engines); this module owns only the DECISIONS:

- ``candidate → shadow``: unconditional — a freshly solved candidate
  always earns mirrored traffic first, never live traffic.
- ``shadow → canary``: enough shadow pairs observed AND the held-out
  accuracy gate says the candidate is at least as good as the
  incumbent.
- ``canary → promoted``: ``promote_after_healthy_ticks`` CONSECUTIVE
  healthy canary ticks (enough canary requests, error rate under the
  ceiling, no SLO burn, accuracy still good). Any marginal tick —
  not bad enough to roll back, not clean enough to count — resets the
  streak but does NOT roll back: that band is the hysteresis that
  stops a candidate from flapping between canary and rollback on
  noisy windows.
- ``→ rolled_back`` (from shadow or canary, immediately): the hard
  gates. Held-out accuracy worse than ``rollback_err_ratio`` × the
  incumbent's (the poisoned-refit drill trips exactly this), shadow
  diff over threshold with enough evidence and NO proven-good
  held-out accuracy (a proven-good candidate is allowed to differ —
  correcting drift is the point of a refit), canary error rate over
  the ceiling with enough evidence, or the serving SLO burning while
  the canary takes live traffic.

``promoted`` and ``rolled_back`` are terminal PER CANDIDATE — the
controller starts a fresh ``PolicyState`` for the next solved version.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

STAGES = ("idle", "candidate", "shadow", "canary", "promoted",
          "rolled_back")


@dataclass(frozen=True)
class GateInputs:
    """One tick's evidence, all pre-aggregated by the controller."""

    shadow_pairs: int = 0
    shadow_max_abs: float = 0.0
    canary_requests: int = 0
    canary_errors: int = 0
    slo_breaching: bool = False
    # held-out MSEs; None until the holdout buffer has samples
    candidate_err: Optional[float] = None
    incumbent_err: Optional[float] = None


@dataclass(frozen=True)
class PromotionConfig:
    # shadow gate
    min_shadow_pairs: int = 32
    max_shadow_diff: float = 0.25
    # canary gate
    min_canary_requests: int = 32
    max_canary_error_rate: float = 0.02
    promote_after_healthy_ticks: int = 2
    # accuracy gates (ratios vs the incumbent's held-out error):
    # <= promote_err_ratio is required to advance/promote;
    # > rollback_err_ratio rolls back immediately; the band between
    # is the hysteresis zone (hold position, reset the streak)
    promote_err_ratio: float = 1.0
    rollback_err_ratio: float = 1.5

    def __post_init__(self):
        if not (0.0 < self.promote_err_ratio
                <= self.rollback_err_ratio):
            raise ValueError(
                "need 0 < promote_err_ratio <= rollback_err_ratio, "
                f"got {self.promote_err_ratio} / "
                f"{self.rollback_err_ratio}"
            )


@dataclass(frozen=True)
class PolicyState:
    stage: str = "candidate"
    healthy_streak: int = 0

    @property
    def terminal(self) -> bool:
        return self.stage in ("promoted", "rolled_back")


def _accuracy(inputs: GateInputs, cfg: PromotionConfig) -> str:
    """'good' | 'bad' | 'marginal' | 'unknown' — the three-way
    accuracy verdict both stages share. 'unknown' (no held-out
    evidence yet) blocks promotion but never rolls back."""
    if inputs.candidate_err is None or inputs.incumbent_err is None:
        return "unknown"
    if inputs.candidate_err > inputs.incumbent_err * \
            max(1e-12, float(cfg.rollback_err_ratio)):
        return "bad"
    if inputs.candidate_err <= inputs.incumbent_err * \
            float(cfg.promote_err_ratio):
        return "good"
    return "marginal"


def tick(
    state: PolicyState,
    inputs: GateInputs,
    cfg: PromotionConfig = PromotionConfig(),
) -> Tuple[PolicyState, str]:
    """One policy decision. Pure: same (state, inputs, cfg) -> same
    (state', reason), no clocks, no side effects."""
    if state.terminal or state.stage == "idle":
        return state, "terminal" if state.terminal else "idle"

    if state.stage == "candidate":
        return PolicyState("shadow"), "shadow_start"

    accuracy = _accuracy(inputs, cfg)

    if state.stage == "shadow":
        if accuracy == "bad":
            return PolicyState("rolled_back"), "accuracy"
        # the shadow-diff gate is the BACKSTOP for candidates without
        # held-out proof: a candidate whose outputs diverge wildly
        # from the incumbent's AND which can't demonstrate good
        # held-out accuracy is suspect. Proven-good candidates are
        # allowed to differ — correcting a stale incumbent's drift is
        # exactly why a refit happens, so output parity with the model
        # being replaced cannot be a hard requirement.
        if (inputs.shadow_pairs >= cfg.min_shadow_pairs
                and inputs.shadow_max_abs > cfg.max_shadow_diff
                and accuracy != "good"):
            return PolicyState("rolled_back"), "shadow_diff"
        if (inputs.shadow_pairs >= cfg.min_shadow_pairs
                and accuracy == "good"):
            return PolicyState("canary"), "canary_start"
        return state, "shadow_wait"

    # canary
    if accuracy == "bad":
        return PolicyState("rolled_back"), "accuracy"
    if inputs.slo_breaching:
        return PolicyState("rolled_back"), "slo_burn"
    if inputs.canary_requests >= cfg.min_canary_requests:
        err_rate = inputs.canary_errors / max(1, inputs.canary_requests)
        if err_rate > cfg.max_canary_error_rate:
            return PolicyState("rolled_back"), "canary_errors"
        if accuracy == "good":
            streak = state.healthy_streak + 1
            if streak >= cfg.promote_after_healthy_ticks:
                return PolicyState("promoted"), "promoted"
            return replace(state, healthy_streak=streak), "canary_healthy"
    # marginal / insufficient evidence: hold position, reset the
    # streak — the hysteresis band (never a rollback)
    return replace(state, healthy_streak=0), "canary_wait"


__all__ = [
    "STAGES",
    "GateInputs",
    "PromotionConfig",
    "PolicyState",
    "tick",
]
