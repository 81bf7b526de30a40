"""Gateway instrumentation: one handle bundle over the global registry
(counterpart of ``keystone_tpu/gateway/metrics.py``, copied as it is).

Every gateway series is a REGISTRY metric (counters / gauges /
histograms in ``observability/registry.py``), not a ``ServingMetrics``
clone: the gateway is control plane, its counters are few and labeled,
and the two latency series use the native-histogram type
(``RegistryHistogram``) precisely because gateway quantiles must
aggregate across replicas and scrapes — ``le`` buckets add, summary
quantiles don't.

Families (all carry a ``gateway`` label so several gateways in one
process stay distinguishable; get-or-create semantics make the handles
shared):

- ``keystone_gateway_requests_total{gateway,status}`` — terminal
  request outcomes: ``ok`` | ``shed`` | ``error``.
- ``keystone_gateway_shed_total{gateway,reason}`` — load-shed detail:
  ``queue_full`` | ``slo_pressure`` | ``deadline`` | ``expired`` |
  ``closed``.
- ``keystone_gateway_retries_total{gateway}`` — lane-failure retries.
- ``keystone_gateway_engine_swaps_total{gateway}`` — live re-buckets.
- ``keystone_gateway_queue_depth{gateway}`` / ``_inflight`` /
  ``_ready`` / ``_slo_pressure`` gauges.
- ``keystone_gateway_queue_wait_seconds`` /
  ``keystone_gateway_request_latency_seconds`` histograms; the latency
  histogram's buckets carry ``trace_id`` OpenMetrics exemplars when the
  request was traced, linking the aggregate to ``/debugz`` forensics.
"""

from __future__ import annotations

from typing import Optional

from keystone_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_global_registry,
)


class GatewayMetrics:
    """Pre-resolved metric handles for one named gateway."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        gateway: str = "gateway",
    ):
        reg = registry if registry is not None else get_global_registry()
        self.registry = reg
        self.gateway = gateway
        self._requests = reg.counter(
            "keystone_gateway_requests_total",
            "terminal request outcomes through the gateway",
            ("gateway", "status"),
        )
        self._shed = reg.counter(
            "keystone_gateway_shed_total",
            "requests rejected by admission control, by reason",
            ("gateway", "reason"),
        )
        self._retries = reg.counter(
            "keystone_gateway_retries_total",
            "requests retried on another lane after a lane failure",
            ("gateway",),
        )
        self._swaps = reg.counter(
            "keystone_gateway_engine_swaps_total",
            "live engine swaps (re-bucket / replacement) completed",
            ("gateway",),
        )
        self._queue_depth = reg.gauge(
            "keystone_gateway_queue_depth",
            "requests admitted but not yet routed to a lane",
            ("gateway",),
        )
        self._inflight = reg.gauge(
            "keystone_gateway_inflight",
            "requests routed to a lane and not yet resolved",
            ("gateway",),
        )
        self._ready = reg.gauge(
            "keystone_gateway_ready",
            "1 while the gateway admits traffic, 0 once draining",
            ("gateway",),
        )
        self._slo_pressure = reg.gauge(
            "keystone_gateway_slo_pressure",
            "admission tightening applied by the SLO burn watchdog "
            "(0 = none, toward 1 = queue bound shrunk)",
            ("gateway",),
        )
        self.queue_wait = reg.histogram(
            "keystone_gateway_queue_wait_seconds",
            "admission-queue wait (admit to lane hand-off)",
            ("gateway",),
        )
        self.request_latency = reg.histogram(
            "keystone_gateway_request_latency_seconds",
            "end-to-end gateway request latency (admit to resolution)",
            ("gateway",),
        )
        self.set_ready(False)
        self.set_queue_depth(0)
        self.set_inflight(0)
        self.set_slo_pressure(0.0)

    @property
    def requests_total(self):
        """The outcome counter handle (the availability SLO reads it)."""
        return self._requests

    # -- thin label-bound helpers (hot path: one tuple + one inc) ----------

    def record_outcome(self, status: str) -> None:
        self._requests.inc((self.gateway, status))

    def record_shed(self, reason: str) -> None:
        self._shed.inc((self.gateway, reason))
        self._requests.inc((self.gateway, "shed"))

    def record_retry(self) -> None:
        self._retries.inc((self.gateway,))

    def record_swap(self) -> None:
        self._swaps.inc((self.gateway,))

    def record_queue_wait(self, seconds: float) -> None:
        self.queue_wait.observe(seconds, (self.gateway,))

    def record_latency(
        self, seconds: float, trace_id: Optional[str] = None
    ) -> None:
        self.request_latency.observe(
            seconds, (self.gateway,), trace_id=trace_id
        )

    def set_slo_pressure(self, pressure: float) -> None:
        self._slo_pressure.set(pressure, (self.gateway,))

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(depth, (self.gateway,))

    def set_inflight(self, n: int) -> None:
        self._inflight.set(n, (self.gateway,))

    def set_ready(self, ready: bool) -> None:
        self._ready.set(1.0 if ready else 0.0, (self.gateway,))

    # -- test/debug conveniences -------------------------------------------

    def shed_count(self, reason: str) -> float:
        return self._shed.get((self.gateway, reason))

    def outcome_count(self, status: str) -> float:
        return self._requests.get((self.gateway, status))

    def retry_count(self) -> float:
        return self._retries.get((self.gateway,))

    def swap_count(self) -> float:
        return self._swaps.get((self.gateway,))
