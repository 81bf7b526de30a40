"""OTLP/HTTP span export — stdlib only, off by default (counterpart of
``keystone_tpu/observability/otlp.py``, copied as it is: the port's
``Span`` has the JAX package's fields, a 32-hex ``trace_id``, integer
span ids and ``start_s``/``duration_s`` in seconds since the epoch, so
the mapping to hex ids and Unix nanoseconds is the same).

Maps our ``Span`` dataclass onto the OTLP JSON encoding
(``resourceSpans -> scopeSpans -> spans``; see
https://opentelemetry.io/docs/specs/otlp/#otlphttp) and POSTs batches
to a collector's ``/v1/traces`` over ``urllib`` — no SDK, nothing to
install. The exporter is a tracer *sink*: ``install()`` hooks
``Tracer.add_sink``, every finished span lands in a bounded in-memory
queue, and a background daemon thread flushes either when a batch fills
or on a timer. The serving hot path never blocks on the network: a
full queue drops the oldest spans (counted), a dead collector costs one
failed POST per flush interval (counted, logged at debug).

Wiring: ``python -m keystone_tpu_torch --otlp-endpoint http://host:4318 ...``
builds one exporter over the global tracer; libraries construct
``OtlpSpanExporter`` directly. Span identity follows the wire format:
``trace_id`` is already 32 hex chars (see ``tracing.new_trace_id``);
our integer span ids render as 16-hex-char ids.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import urllib.error
import urllib.request
from typing import Any, Deque, Dict, List, Optional, Sequence

from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability.tracing import Span, Tracer, get_tracer

logger = logging.getLogger(__name__)

TRACES_PATH = "/v1/traces"

# a span with no trace context still needs a valid non-zero trace id on
# the wire; OTLP forbids all-zeros, so orphans get a fixed sentinel
_ORPHAN_TRACE_ID = "f" * 32


def format_span_id(span_id: Optional[int]) -> str:
    """An integer span id as the 8-byte hex the OTLP wire expects."""
    return format((span_id or 0) & ((1 << 64) - 1), "016x")


def _attr_value(value: Any) -> Dict[str, Any]:
    # proto3 JSON mapping: int64 serializes as a STRING
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}
    if isinstance(value, float):
        return {"doubleValue": value}
    return {"stringValue": str(value)}


def _attrs(mapping: Dict[str, Any]) -> List[Dict[str, Any]]:
    return [
        {"key": str(k), "value": _attr_value(v)} for k, v in mapping.items()
    ]


def span_to_otlp(span: Span) -> Dict[str, Any]:
    """One finished ``Span`` as an OTLP JSON span object."""
    start_ns = int(span.start_s * 1e9)
    end_ns = start_ns + int(span.duration_s * 1e9)
    out = {
        "traceId": span.trace_id or _ORPHAN_TRACE_ID,
        "spanId": format_span_id(span.span_id),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": _attrs(
            {**span.attrs, "thread.id": span.thread_id}
        ),
    }
    if span.parent_id is not None:
        out["parentSpanId"] = format_span_id(span.parent_id)
    return out


def encode_spans(
    spans: Sequence[Span],
    service_name: str = "keystone-tpu",
    resource_attrs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """A batch of spans as the full OTLP/HTTP JSON request body.
    ``resource_attrs`` stamp the RESOURCE (the process), not the
    spans: the fleet's ``service.name`` + ``replica`` identity is
    what lets an external collector lay N processes' halves of one
    trace out as the same stitched topology the router's ``/debugz``
    renders."""
    return {
        "resourceSpans": [
            {
                "resource": {
                    "attributes": _attrs(
                        {
                            "service.name": service_name,
                            **(resource_attrs or {}),
                        }
                    )
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "keystone_tpu_torch.observability"},
                        "spans": [span_to_otlp(s) for s in spans],
                    }
                ],
            }
        ]
    }


class OtlpSpanExporter:
    """Background-batching OTLP/HTTP exporter over one tracer."""

    def __init__(
        self,
        endpoint: str,
        *,
        service_name: str = "keystone-tpu",
        resource_attrs: Optional[Dict[str, Any]] = None,
        headers: Optional[Dict[str, str]] = None,
        batch_size: int = 256,
        flush_interval_s: float = 2.0,
        queue_capacity: int = 8192,
        timeout_s: float = 5.0,
        registry=None,
    ):
        endpoint = endpoint.rstrip("/")
        if not endpoint.endswith(TRACES_PATH):
            endpoint += TRACES_PATH
        self.endpoint = endpoint
        self.service_name = service_name
        self.resource_attrs = dict(resource_attrs or {})
        self.headers = dict(headers or {})
        self.batch_size = max(1, int(batch_size))
        self.flush_interval_s = float(flush_interval_s)
        self.queue_capacity = max(self.batch_size, int(queue_capacity))
        self.timeout_s = float(timeout_s)
        self._q: Deque[Span] = collections.deque()
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._idle = threading.Event()  # set while the queue is empty
        self._idle.set()
        self._thread: Optional[threading.Thread] = None
        self._tracer: Optional[Tracer] = None
        if registry is None:
            from keystone_tpu_torch.observability.registry import (
                get_global_registry,
            )

            registry = get_global_registry()
        self._spans = registry.counter(
            "keystone_otlp_spans_total",
            "spans handed to the OTLP exporter, by result",
            ("result",),
        )
        self._posts = registry.counter(
            "keystone_otlp_posts_total",
            "OTLP/HTTP export POSTs, by result",
            ("result",),
        )

    # -- intake (the tracer sink) ------------------------------------------

    def submit(self, span: Span) -> None:
        """Enqueue one finished span (never blocks; oldest spans drop
        when the collector cannot keep up)."""
        with self._lock:
            if len(self._q) >= self.queue_capacity:
                self._q.popleft()
                self._spans.inc(("dropped",))
            self._q.append(span)
            self._idle.clear()
            full = len(self._q) >= self.batch_size
        if full:
            self._kick.set()

    def install(self, tracer: Optional[Tracer] = None) -> "OtlpSpanExporter":
        """Hook the tracer's span sink and start the flush thread."""
        self._tracer = tracer if tracer is not None else get_tracer()
        self._tracer.add_sink(self.submit)
        return self.start()

    # -- flush loop --------------------------------------------------------

    def start(self) -> "OtlpSpanExporter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="keystone-otlp-export", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            self._kick.wait(self.flush_interval_s)
            self._kick.clear()
            self._flush_once()
            if self._stop.is_set():
                self._flush_once()  # final drain
                return

    def _flush_once(self) -> None:
        while True:
            with self._lock:
                batch = [
                    self._q.popleft()
                    for _ in range(min(len(self._q), self.batch_size))
                ]
            if not batch:
                # idle only once every popped batch has been POSTed,
                # so flush() returning means the collector has seen
                # everything submitted before the call
                with self._lock:
                    if not self._q:
                        self._idle.set()
                return
            self._post(batch)

    def _post(self, batch: List[Span]) -> None:
        # chaos point: black-hole the collector. Dropping BEFORE the
        # POST (counted under result="blackhole") proves the serving
        # path's telemetry isolation without paying connect/timeout
        # stalls on the flush thread — the experiment's question is
        # "does a dead collector cost traffic anything", and the
        # answer must be visible on /metrics, not in wall time.
        if faults.armed() and faults.fire(
            "otlp.export.blackhole", {"endpoint": self.endpoint}
        ) is not None:
            self._posts.inc(("blackhole",))
            self._spans.inc(("dropped",), by=len(batch))
            return
        body = json.dumps(
            encode_spans(
                batch, self.service_name,
                resource_attrs=self.resource_attrs,
            )
        ).encode("utf-8")
        req = urllib.request.Request(
            self.endpoint,
            data=body,
            headers={"Content-Type": "application/json", **self.headers},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
            self._posts.inc(("ok",))
            self._spans.inc(("exported",), by=len(batch))
        except Exception as e:
            # the collector being down must cost the serving path
            # nothing: count, log quietly, drop the batch
            self._posts.inc(("error",))
            self._spans.inc(("dropped",), by=len(batch))
            logger.debug("OTLP export to %s failed: %s", self.endpoint, e)

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the queue has fully drained (tests; shutdown)."""
        self._kick.set()
        return self._idle.wait(timeout_s)

    def shutdown(self, timeout_s: float = 10.0) -> None:
        """Unhook from the tracer, drain what is queued, stop."""
        if self._tracer is not None:
            self._tracer.remove_sink(self.submit)
            self._tracer = None
        if self._thread is not None:
            self._stop.set()
            self._kick.set()
            self._thread.join(timeout_s)
            self._thread = None

    def __enter__(self) -> "OtlpSpanExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()


__all__ = [
    "OtlpSpanExporter",
    "encode_spans",
    "format_span_id",
    "span_to_otlp",
]
