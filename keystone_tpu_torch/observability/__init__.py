"""Observability: span tracing (``tracing.py``)."""
