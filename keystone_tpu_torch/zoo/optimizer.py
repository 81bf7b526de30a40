"""The placement optimizer: cost models + histograms -> PlacementPlan
(counterpart of ``keystone_tpu/zoo/optimizer.py``, copied as it is: it
is pure Python).

KeystoneML's planner chooses physical operators for a logical DAG from
cost models; this is the serving-plane analogue. Inputs per model
(one ``ModelProfile``):

- the observed (or expected) request-size histogram — what
  ``serving/autoscale.suggest_buckets`` turns into the padding-minimal
  bucket set;
- the per-bucket cost models the engines extract at warmup
  (``ServingMetrics.cost_models``: modeled FLOPs per bucket program) —
  the demand weight that decides who gets spare lanes;
- ``params_nbytes`` — what one REPLICATED engine must hold per chip
  (``zoo/host.params_nbytes``), checked against the per-chip
  HBM budget for the replicated-vs-mesh-sharded decision.

Everything here is PURE and deterministic: same profiles + same budget
-> byte-identical plan, no torch, no device, no clock. The live side
(``ModelZoo.profiles()``) assembles profiles from running gateways;
``serve-gateway --zoo spec.json --optimize`` plans from the spec's
``expected_sizes`` hints before the first request arrives, and
``/planz`` reports this plan next to each pool's actual shape.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from keystone_tpu_torch.serving.autoscale import (
    predicted_efficiency,
    suggest_buckets,
)

# fraction of the per-chip HBM the planner lets ONE model's replicated
# params claim — headroom for activations, staging buffers, and the
# other co-hosted models
DEFAULT_PARAM_FRACTION = 0.8


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """One model's planning inputs. ``fallback_buckets`` serve when the
    histogram is empty (a cold model has no traffic to plan from)."""

    model_id: str
    histogram: Mapping[int, int] = dataclasses.field(
        default_factory=dict
    )
    cost_models: Mapping[int, Mapping[str, float]] = dataclasses.field(
        default_factory=dict
    )
    params_nbytes: int = 0
    fallback_buckets: Tuple[int, ...] = (8, 32, 128)
    pinned: bool = False


@dataclasses.dataclass(frozen=True)
class ChipBudget:
    """The hardware envelope the plan must fit. ``hbm_bytes`` is one
    chip's usable HBM (``observability/device.chip_hbm_bytes``, or
    ``$KEYSTONE_CHIP_HBM_BYTES``); None disables the sharding decision
    rather than fabricating a limit. ``lane_budget`` caps total lanes
    across the zoo (None = 2 per model, the single-model default)."""

    hbm_bytes: Optional[int] = None
    n_chips: int = 1
    lane_budget: Optional[int] = None
    param_fraction: float = DEFAULT_PARAM_FRACTION


@dataclasses.dataclass(frozen=True)
class ModelPlacement:
    model_id: str
    buckets: Tuple[int, ...]
    lanes: int
    sharded: bool
    params_nbytes: int
    demand_share: float
    predicted_efficiency: Optional[float]
    reason: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": self.model_id,
            "buckets": list(self.buckets),
            "lanes": self.lanes,
            "sharded": self.sharded,
            "params_nbytes": self.params_nbytes,
            "demand_share": round(self.demand_share, 4),
            "predicted_efficiency": (
                round(self.predicted_efficiency, 4)
                if self.predicted_efficiency is not None else None
            ),
            "reason": self.reason,
        }


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    placements: Tuple[ModelPlacement, ...]
    lane_budget: int
    hbm_budget_bytes: Optional[int]

    def placement_for(self, model_id: str) -> Optional[ModelPlacement]:
        for p in self.placements:
            if p.model_id == model_id:
                return p
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "lane_budget": self.lane_budget,
            "hbm_budget_bytes": self.hbm_budget_bytes,
            "placements": [p.to_dict() for p in self.placements],
        }


def _flops_per_row(profile: ModelProfile) -> float:
    """Demand weight from the measured cost models: modeled FLOPs of
    the smallest bucket program divided by its rows. Falls back to 1.0
    (equal weight) when no cost model exists yet — a cold zoo plans on
    histogram mass alone."""
    best = None
    for bucket in sorted(profile.cost_models):
        flops = profile.cost_models[bucket].get("flops")
        if flops and bucket > 0:
            best = float(flops) / float(bucket)
            break
    return best if best is not None else 1.0


def _demand(profile: ModelProfile) -> float:
    """Row-weighted compute demand: histogram rows x modeled FLOPs per
    row. An empty histogram contributes the per-row weight alone, so a
    cold model still claims a share instead of zero."""
    rows = sum(
        int(size) * int(count)
        for size, count in profile.histogram.items()
    )
    return max(rows, 1) * _flops_per_row(profile)


def plan_placement(
    profiles: Sequence[ModelProfile],
    budget: ChipBudget,
    *,
    k: Optional[int] = None,
    max_bucket: Optional[int] = None,
) -> PlacementPlan:
    """The planner. Per model:

    - **buckets**: ``suggest_buckets`` (exact DP) over the histogram,
      capped at ``max_bucket`` (default: the model's largest fallback
      bucket); the fallback list verbatim when no histogram exists;
    - **replicated vs mesh-sharded**: sharded iff the replicated
      params exceed ``param_fraction`` of one chip's HBM AND the
      budget has a model axis to shard over (``n_chips > 1``), a
      decision made from numbers instead of a flag. A sharded
      model gets ONE lane (each lane places its own param copy, so
      extra lanes would multiply HBM, not throughput);
    - **lanes**: the remaining lane budget split over replicated
      models proportional to demand (histogram rows x modeled
      FLOPs/row) by largest remainder — floor 1 per model, ties by
      model id, so the output is deterministic.

    Models are planned in sorted-id order and the result is a pure
    function of (profiles, budget, k, max_bucket)."""
    ordered = sorted(profiles, key=lambda p: p.model_id)
    if len({p.model_id for p in ordered}) != len(ordered):
        raise ValueError("duplicate model ids in profiles")
    lane_budget = (
        int(budget.lane_budget)
        if budget.lane_budget is not None
        else 2 * len(ordered)
    )
    if ordered and lane_budget < len(ordered):
        raise ValueError(
            f"lane budget {lane_budget} cannot give each of "
            f"{len(ordered)} models a lane"
        )
    param_budget = (
        int(budget.hbm_bytes * budget.param_fraction)
        if budget.hbm_bytes is not None else None
    )

    # -- per-model bucket choice + sharding decision -----------------------
    chosen: Dict[str, Dict[str, Any]] = {}
    for prof in ordered:
        cap = max_bucket or (
            max(prof.fallback_buckets)
            if prof.fallback_buckets else None
        )
        if prof.histogram:
            want_k = k if k is not None else max(
                1, len(prof.fallback_buckets)
            )
            buckets = suggest_buckets(
                prof.histogram, want_k, max_bucket=cap
            )
            eff = predicted_efficiency(prof.histogram, buckets)
        else:
            buckets = tuple(prof.fallback_buckets)
            eff = None
        over = (
            param_budget is not None
            and prof.params_nbytes > param_budget
        )
        if over and budget.n_chips > 1:
            sharded = True
            reason = (
                f"params {prof.params_nbytes}B exceed "
                f"{param_budget}B per-chip budget: mesh-sharded over "
                f"{budget.n_chips} chips, one lane"
            )
        elif over:
            sharded = False
            reason = (
                f"params {prof.params_nbytes}B exceed "
                f"{param_budget}B per-chip budget but n_chips=1: "
                "replicated (no model axis to shard over)"
            )
        else:
            sharded = False
            reason = (
                "params fit the per-chip budget: replicated"
                if param_budget is not None
                else "no HBM budget known: replicated"
            )
        chosen[prof.model_id] = {
            "buckets": buckets, "eff": eff,
            "sharded": sharded, "reason": reason,
        }

    # -- lane allocation over the shared budget ----------------------------
    sharded_ids = [
        p.model_id for p in ordered if chosen[p.model_id]["sharded"]
    ]
    replicated = [
        p for p in ordered if not chosen[p.model_id]["sharded"]
    ]
    spare = lane_budget - len(sharded_ids) - len(replicated)
    lanes: Dict[str, int] = {mid: 1 for mid in sharded_ids}
    lanes.update({p.model_id: 1 for p in replicated})
    demands = {p.model_id: _demand(p) for p in ordered}
    total_rep_demand = sum(demands[p.model_id] for p in replicated)
    if spare > 0 and replicated and total_rep_demand > 0:
        shares = [
            (
                p.model_id,
                spare * demands[p.model_id] / total_rep_demand,
            )
            for p in replicated
        ]
        granted = 0
        for mid, share in shares:
            lanes[mid] += int(share)
            granted += int(share)
        # largest remainder, ties broken by id: deterministic
        remainders = sorted(
            shares,
            key=lambda s: (-(s[1] - int(s[1])), s[0]),
        )
        for mid, _ in remainders[: spare - granted]:
            lanes[mid] += 1

    total_demand = sum(demands.values()) or 1.0
    placements = tuple(
        ModelPlacement(
            model_id=p.model_id,
            buckets=chosen[p.model_id]["buckets"],
            lanes=lanes[p.model_id],
            sharded=chosen[p.model_id]["sharded"],
            params_nbytes=int(p.params_nbytes),
            demand_share=demands[p.model_id] / total_demand,
            predicted_efficiency=chosen[p.model_id]["eff"],
            reason=chosen[p.model_id]["reason"],
        )
        for p in ordered
    )
    return PlacementPlan(
        placements=placements,
        lane_budget=lane_budget,
        hbm_budget_bytes=budget.hbm_bytes,
    )


def diff_plans(
    old: Optional[PlacementPlan], new: PlacementPlan
) -> Dict[str, Dict[str, Any]]:
    """What the ``new`` plan would CHANGE relative to ``old`` — the
    ``/driftz`` recommendation payload. Per model whose placement
    differs, each changed field as ``{"from": ..., "to": ...}``; models
    present on one side only diff against None. Pure like the planner:
    an empty dict means the re-plan confirmed the applied placement."""
    old_by = (
        {p.model_id: p for p in old.placements} if old is not None else {}
    )
    new_by = {p.model_id: p for p in new.placements}
    out: Dict[str, Dict[str, Any]] = {}
    for mid in sorted(set(old_by) | set(new_by)):
        a, b = old_by.get(mid), new_by.get(mid)
        if a is None or b is None:
            out[mid] = {
                "placement": {
                    "from": a.to_dict() if a is not None else None,
                    "to": b.to_dict() if b is not None else None,
                }
            }
            continue
        changes: Dict[str, Any] = {}
        for field, fa, fb in (
            ("buckets", list(a.buckets), list(b.buckets)),
            ("lanes", a.lanes, b.lanes),
            ("sharded", a.sharded, b.sharded),
        ):
            if fa != fb:
                changes[field] = {"from": fa, "to": fb}
        if changes:
            out[mid] = changes
    return out


__all__ = [
    "ChipBudget",
    "DEFAULT_PARAM_FRACTION",
    "ModelPlacement",
    "ModelProfile",
    "PlacementPlan",
    "diff_plans",
    "plan_placement",
]
