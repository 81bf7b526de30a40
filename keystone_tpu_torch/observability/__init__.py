"""Observability: span tracing (``tracing.py``), the metrics registry
(``registry.py``) and its Prometheus rendering (``prometheus.py``), and
the device table (``device.py``)."""
