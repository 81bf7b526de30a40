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

The JAX package's span stitching, OTLP export, attribution and drift
modules wait for the fleet and the zoo.
"""

from keystone_tpu_torch.observability.admin import (
    AdminServer,
    build_info,
    start_admin_server,
    stop_admin_server,
)
from keystone_tpu_torch.observability.device import (
    DeviceMemorySampler,
    device_memory_stats,
    device_table,
    peaks_for,
)
from keystone_tpu_torch.observability.flight import FlightRecord, FlightRecorder
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
    "DEFAULT_HISTOGRAM_BUCKETS",
    "DeviceMemorySampler",
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
