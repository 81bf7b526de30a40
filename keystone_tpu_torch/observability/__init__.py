"""Observability: one plane for metrics and spans (counterpart of
``keystone_tpu/observability``).

- ``MetricsRegistry`` (registry.py): the process-global catalogue of
  named, labeled counters, gauges, latency summaries and native
  histograms; ``ServingMetrics`` and the gateway publish here, and
  ``prometheus.py`` renders, parses and merges its expositions.
- ``Tracer`` (tracing.py): spans with parent links and a bounded ring of
  recent spans; off by default.
- ``AdminServer`` (admin.py): ``/metrics``, ``/varz``, ``/healthz``,
  ``/tracez``, ``/slz``, ``/debugz`` and ``/profilez`` on a background
  thread — ``python -m keystone_tpu_torch --admin-port N ...``.
- ``Slo``/``SloMonitor`` (slo.py): burn rates over the registry's series;
  ``FlightRecorder`` (flight.py): tail-sampled forensics.
- ``device.py``: the card's table, the device-info gauge and the memory
  sampler.

- ``otlp.py``: OTLP/HTTP span export; ``stitch.py``: the fleet router's
  cross-process trace stitching and phase decomposition.
- ``attribution.py``: the per-model device-cost ledger; ``drift.py``: live
  request-size mixtures scored against the placement plan's (the zoo).
"""

from keystone_tpu_torch.observability.admin import (
    AdminServer,
    build_info,
    start_admin_server,
    stop_admin_server,
)
from keystone_tpu_torch.observability.attribution import (
    AttributionLedger,
    EngineAttribution,
    RowClaimQueue,
    attribution_document,
    attribution_from_samples,
)
from keystone_tpu_torch.observability.device import (
    DeviceMemorySampler,
    device_memory_stats,
    device_table,
    peaks_for,
)
from keystone_tpu_torch.observability.drift import DriftDetector, psi
from keystone_tpu_torch.observability.flight import FlightRecord, FlightRecorder
from keystone_tpu_torch.observability.otlp import OtlpSpanExporter
from keystone_tpu_torch.observability.registry import (
    DEFAULT_HISTOGRAM_BUCKETS,
    Exemplar,
    MetricFamily,
    MetricsRegistry,
    RegistryHistogram,
    Sample,
    get_global_registry,
    reset_global_registry,
)
from keystone_tpu_torch.observability.slo import Slo, SloMonitor
from keystone_tpu_torch.observability.stitch import (
    StitchedTrace,
    TraceStitcher,
    phase_decomposition,
)
from keystone_tpu_torch.observability.tracing import (
    Span,
    TraceContext,
    Tracer,
    disable_tracing,
    enable_tracing,
    format_traceparent,
    get_tracer,
    parse_traceparent,
)

__all__ = [
    "AdminServer",
    "AttributionLedger",
    "DEFAULT_HISTOGRAM_BUCKETS",
    "DeviceMemorySampler",
    "DriftDetector",
    "EngineAttribution",
    "OtlpSpanExporter",
    "RowClaimQueue",
    "StitchedTrace",
    "TraceStitcher",
    "attribution_document",
    "attribution_from_samples",
    "phase_decomposition",
    "psi",
    "Exemplar",
    "FlightRecord",
    "FlightRecorder",
    "MetricFamily",
    "MetricsRegistry",
    "RegistryHistogram",
    "Sample",
    "Slo",
    "SloMonitor",
    "Span",
    "TraceContext",
    "Tracer",
    "build_info",
    "device_memory_stats",
    "device_table",
    "disable_tracing",
    "enable_tracing",
    "format_traceparent",
    "get_global_registry",
    "get_tracer",
    "parse_traceparent",
    "peaks_for",
    "reset_global_registry",
    "start_admin_server",
    "stop_admin_server",
]
