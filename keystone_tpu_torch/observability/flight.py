"""Tail-sampled flight recorder: full forensics for the requests that
went wrong (counterpart of ``keystone_tpu/observability/flight.py``,
copied as it is).

The tracer's ring holds *recent* spans of *every* request — great for
"what is the process doing", useless for "what happened to THE slow
request from 40 seconds ago" once the ring laps. The flight recorder is
the tail-sampling layer on top: the capture decision happens at request
END (when the latency and outcome are known — that is what makes it
*tail* sampling), and only requests that breached the SLO threshold or
errored get their full span tree + attrs pinned into a separate bounded
ring that ordinary traffic can never evict.

The gateway's admission ``_finish`` hook drives ``maybe_capture``; each
``FlightRecord`` is browsable at ``/debugz`` (JSON) and individually
dumpable as a Chrome trace-event document (``?trace_id=...&format=
chrome``) that loads in chrome://tracing / Perfetto. Histogram
exemplars carry the same ``trace_id``, so a spike on the latency
histogram links straight to its record here.

Disabled is free: a recorder exists only where constructed (the module
keeps a weak set for ``/debugz``), and ``maybe_capture`` on a disabled
recorder is one attribute read.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
import weakref
from typing import Any, Deque, Dict, List, Optional, Tuple

from keystone_tpu_torch.observability.tracing import Span, Tracer, get_tracer

DEFAULT_CAPACITY = 64

# every live recorder, for /debugz (weak: dies with its gateway)
_recorders: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def recorders() -> List["FlightRecorder"]:
    return list(_recorders)


def debugz_status(trace_id: Optional[str] = None) -> Dict:
    """The admin ``/debugz`` document: every record of every live
    recorder (newest first), optionally filtered to one trace. A
    ``trace_id`` query ALSO returns that trace's live spans straight
    from the tracer ring (``"spans"``): ordinary requests are never
    tail-sampled into a flight record, but the fleet router's
    cross-process stitch (``observability/stitch.py``) still needs
    their span tree while the ring holds it — pinned forensics when
    they exist, the ring as the fallback."""
    records: List[FlightRecord] = []
    for rec in recorders():
        records.extend(rec.records())
    records.sort(key=lambda r: r.captured_at, reverse=True)
    doc: Dict[str, Any] = {"recorders": len(recorders())}
    if trace_id is not None:
        records = [r for r in records if r.trace_id == trace_id]
        doc["trace_id"] = trace_id
        doc["spans"] = [
            s.to_dict() for s in get_tracer().spans_for_trace(trace_id)
        ]
    doc["records"] = [r.to_dict() for r in records]
    return doc


def find_record(trace_id: str) -> Optional["FlightRecord"]:
    for rec in recorders():
        found = rec.find(trace_id)
        if found is not None:
            return found
    return None


def debugz_document(
    trace_id: Optional[str], fmt: str = ""
) -> Tuple[int, Dict]:
    """The ``/debugz`` routing, shared by the admin and gateway HTTP
    handlers -> ``(status_code, json_document)``: the record listing by
    default, one record as a Chrome trace with ``fmt == "chrome"``
    (which requires a ``trace_id``)."""
    if fmt == "chrome":
        if not trace_id:
            return 400, {"error": "format=chrome requires trace_id="}
        record = find_record(trace_id)
        if record is None:
            return 404, {"error": f"no flight record for trace {trace_id}"}
        return 200, record.to_chrome_trace()
    return 200, debugz_status(trace_id)


@dataclasses.dataclass
class FlightRecord:
    """One captured request: identity, verdict, and the span tree."""

    trace_id: str
    reason: str  # "slo_breach" | "error" | "drift"
    captured_at: float  # epoch seconds
    duration_s: Optional[float]
    attrs: Dict[str, Any]
    spans: List[Span]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "reason": self.reason,
            "captured_at": self.captured_at,
            "duration_ms": (
                round(self.duration_s * 1e3, 6)
                if self.duration_s is not None
                else None
            ),
            "attrs": dict(self.attrs),
            "spans": [s.to_dict() for s in self.spans],
        }

    def to_chrome_trace(self) -> Dict[str, Any]:
        """This record alone as Chrome trace-event JSON (the same
        object format ``Tracer.to_chrome_trace`` emits) — one request's
        tree, loadable in chrome://tracing / Perfetto."""
        pid = os.getpid()
        events = [
            {
                "name": s.name,
                "ph": "X",
                "ts": s.start_s * 1e6,
                "dur": s.duration_s * 1e6,
                "pid": pid,
                "tid": s.thread_id,
                "args": {
                    **s.attrs,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "trace_id": s.trace_id,
                },
            }
            for s in self.spans
        ]
        events.append(
            {
                "name": f"flight:{self.reason}",
                "ph": "i",  # instant event marking the capture verdict
                "ts": self.captured_at * 1e6,
                "pid": pid,
                "tid": 0,
                "s": "g",
                "args": dict(self.attrs),
            }
        )
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class FlightRecorder:
    """Bounded ring of tail-sampled ``FlightRecord``s."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        *,
        latency_threshold_s: Optional[float] = None,
        tracer: Optional[Tracer] = None,
        enabled: bool = True,
        registry=None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.latency_threshold_s = latency_threshold_s
        self._tracer = tracer
        self._ring: Deque[FlightRecord] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        if registry is None:
            from keystone_tpu_torch.observability.registry import (
                get_global_registry,
            )

            registry = get_global_registry()
        self._captured = registry.counter(
            "keystone_flight_records_total",
            "requests tail-sampled into the flight recorder, by reason",
            ("reason",),
        )
        _recorders.add(self)

    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else get_tracer()

    # -- capture -----------------------------------------------------------

    def maybe_capture(
        self,
        trace_id: Optional[str],
        duration_s: Optional[float] = None,
        error: Optional[BaseException] = None,
        threshold_s: Optional[float] = None,
        **attrs: Any,
    ) -> Optional[FlightRecord]:
        """The tail-sampling decision, called once per finished
        request: capture when it errored or overran the latency
        threshold (per-call override, else the recorder's); drop — for
        free — otherwise."""
        if not self.enabled:
            return None
        if error is not None:
            attrs["error"] = f"{type(error).__name__}: {error}"
            return self.capture(
                trace_id, "error", duration_s=duration_s, **attrs
            )
        threshold = (
            threshold_s if threshold_s is not None
            else self.latency_threshold_s
        )
        if (
            threshold is not None
            and duration_s is not None
            and duration_s > threshold
        ):
            attrs["threshold_ms"] = round(threshold * 1e3, 6)
            return self.capture(
                trace_id, "slo_breach", duration_s=duration_s, **attrs
            )
        return None

    def capture(
        self,
        trace_id: Optional[str],
        reason: str,
        duration_s: Optional[float] = None,
        **attrs: Any,
    ) -> FlightRecord:
        """Pin the trace's full span tree (what the tracer ring still
        holds of it — capture runs at request end, so normally all of
        it) into the forensic ring."""
        spans = (
            self.tracer.spans_for_trace(trace_id) if trace_id else []
        )
        record = FlightRecord(
            trace_id=trace_id or "",
            reason=reason,
            captured_at=time.time(),
            duration_s=duration_s,
            attrs=attrs,
            spans=spans,
        )
        with self._lock:
            self._ring.append(record)
        self._captured.inc((reason,))
        return record

    # -- queries -----------------------------------------------------------

    def records(self, n: Optional[int] = None) -> List[FlightRecord]:
        """Captured records, oldest first."""
        with self._lock:
            records = list(self._ring)
        return records if n is None else records[-n:]

    def find(self, trace_id: str) -> Optional[FlightRecord]:
        with self._lock:
            for record in reversed(self._ring):
                if record.trace_id == trace_id:
                    return record
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecord",
    "FlightRecorder",
    "debugz_document",
    "debugz_status",
    "find_record",
    "recorders",
]
