"""Lifecycle instrumentation (counterpart of
``keystone_tpu/lifecycle/metrics.py``): one handle bundle per MODEL over
the global registry (the ``GatewayMetrics`` shape, ``model``-labeled so
every zoo model's lifecycle stays distinguishable on one scrape).

Families:

- ``keystone_lifecycle_state{model,state}`` — one-hot stage gauge
  (``idle``/``candidate``/``shadow``/``canary``/``promoted``/
  ``rolled_back``): the ``/lifecyclez`` state, scrapeable.
- ``keystone_lifecycle_version{model}`` — newest solved candidate
  version (0 until the first solve).
- ``keystone_lifecycle_refit_samples_total{model}`` /
  ``_refit_chunks_total{model}`` — labeled feedback folded into the
  normal-equations state.
- ``keystone_lifecycle_shadow_pairs_total{model}`` — mirrored
  requests whose primary+shadow outputs were both observed and
  diffed.
- ``keystone_lifecycle_shadow_diff{model,stat}`` — rolling output
  diff between incumbent and candidate (``mean_abs`` / ``max_abs``).
- ``keystone_lifecycle_canary_requests_total{model,outcome}`` —
  live requests routed to the candidate (``ok`` / ``error``; errors
  fall back to the incumbent lanes, so the caller never sees them).
- ``keystone_lifecycle_promotions_total{model}`` /
  ``_rollbacks_total{model,reason}`` — terminal transitions; the
  rollback reason is the policy's gate name (``accuracy`` /
  ``shadow_diff`` / ``canary_errors`` / ``slo_burn`` / ``manual``).
"""

from __future__ import annotations

from typing import Optional

from keystone_tpu_torch.lifecycle.policy import STAGES
from keystone_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_global_registry,
)


class LifecycleMetrics:
    """Pre-resolved metric handles for one model's lifecycle."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        model: str = "default",
    ):
        reg = registry if registry is not None else get_global_registry()
        self.registry = reg
        self.model = model
        self._state = reg.gauge(
            "keystone_lifecycle_state",
            "one-hot lifecycle stage per model",
            ("model", "state"),
        )
        self._version = reg.gauge(
            "keystone_lifecycle_version",
            "newest solved candidate version per model",
            ("model",),
        )
        self._refit_samples = reg.counter(
            "keystone_lifecycle_refit_samples_total",
            "labeled feedback rows folded into the refit state",
            ("model",),
        )
        self._refit_chunks = reg.counter(
            "keystone_lifecycle_refit_chunks_total",
            "feedback chunks accumulated into the normal equations",
            ("model",),
        )
        self._shadow_pairs = reg.counter(
            "keystone_lifecycle_shadow_pairs_total",
            "mirrored requests with both outputs observed and diffed",
            ("model",),
        )
        self._shadow_diff = reg.gauge(
            "keystone_lifecycle_shadow_diff",
            "rolling incumbent-vs-candidate output diff",
            ("model", "stat"),
        )
        self._canary = reg.counter(
            "keystone_lifecycle_canary_requests_total",
            "live requests routed to the candidate engine",
            ("model", "outcome"),
        )
        self._promotions = reg.counter(
            "keystone_lifecycle_promotions_total",
            "candidates promoted to serve all traffic",
            ("model",),
        )
        self._rollbacks = reg.counter(
            "keystone_lifecycle_rollbacks_total",
            "candidates rolled back, by policy gate",
            ("model", "reason"),
        )
        self.set_stage("idle")
        self.set_version(0)

    # -- thin label-bound helpers ------------------------------------------

    def set_stage(self, stage: str) -> None:
        for s in STAGES:
            self._state.set(1.0 if s == stage else 0.0, (self.model, s))

    def set_version(self, version: int) -> None:
        self._version.set(float(version), (self.model,))

    def record_refit_chunk(self, n_samples: int) -> None:
        self._refit_chunks.inc((self.model,))
        self._refit_samples.inc((self.model,), n_samples)

    def record_shadow_pair(
        self, mean_abs: float, max_abs: float
    ) -> None:
        self._shadow_pairs.inc((self.model,))
        self._shadow_diff.set(mean_abs, (self.model, "mean_abs"))
        self._shadow_diff.set(max_abs, (self.model, "max_abs"))

    def record_canary(self, outcome: str) -> None:
        self._canary.inc((self.model, outcome))

    def record_promotion(self) -> None:
        self._promotions.inc((self.model,))

    def record_rollback(self, reason: str) -> None:
        self._rollbacks.inc((self.model, reason))

    # -- test/debug conveniences -------------------------------------------

    def shadow_pair_count(self) -> float:
        return self._shadow_pairs.get((self.model,))

    def canary_count(self, outcome: str) -> float:
        return self._canary.get((self.model, outcome))

    def promotion_count(self) -> float:
        return self._promotions.get((self.model,))

    def rollback_count(self, reason: str) -> float:
        return self._rollbacks.get((self.model, reason))


__all__ = ["LifecycleMetrics"]
