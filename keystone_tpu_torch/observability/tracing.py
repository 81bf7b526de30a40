"""Span tracing: start/end spans with parent links, a bounded ring of
recent spans, and Chrome trace-event JSON export.

Dapper-style application-level spans for the interpret layer — the JAX
profiler (``utils.profiling.trace``) already covers the XLA/device
substrate, but nothing records *why* the device was asked to do work:
which executor node, which serving dispatch, which coalesced window,
which lane-pipeline stage. Span names in the serving path:
``gateway.admit`` → ``microbatch.coalesce`` → ``serving.dispatch``
(serial lanes) or → ``pipeline.host_prep`` / ``pipeline.upload`` /
``pipeline.compute`` / ``pipeline.deliver`` (staged lanes, one span
per stage per window, each on its own stage thread).
Spans nest via a thread-local stack, so a ``serving.dispatch`` span
started inside a ``microbatch.dispatch`` span carries its parent's id —
``/tracez`` (observability/admin.py) shows the tree, and
``to_chrome_trace()`` exports the ring as Chrome trace-event JSON
(the ``{"traceEvents": [...]}`` object format) loadable in
chrome://tracing or Perfetto.

Disabled is the default and costs one attribute read per ``span()``
call (a shared no-op context manager is returned; nothing is recorded,
no lock is taken). ``enable_tracing()`` flips the process-global
tracer on.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

DEFAULT_CAPACITY = 2048

# span_id -> trace_id entries kept for cross-thread parent pinning (the
# pinned parent has usually FINISHED by the time its child starts — the
# gateway.admit span ends at submit-return, the micro-batch window
# opens later on the dispatcher thread)
TRACE_MAP_CAPACITY = 8192

_ids = itertools.count(1)


def new_trace_id() -> str:
    """A fresh 128-bit trace id as 32 lowercase hex chars (the OTLP /
    W3C trace-context wire width, and the exemplar label value)."""
    return os.urandom(16).hex()


# -- W3C trace context (the cross-process wire format) ----------------------

# https://www.w3.org/TR/trace-context/: version "00" header is
# `00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>`. The fleet
# router emits it on every forwarded /predict; the gateway adopts the
# trace id so one request is ONE trace across processes.
TRACEPARENT_HEADER = "traceparent"

# the RESPONSE header both serving tiers echo the request's trace id
# on (success AND typed shed): one constant, because the gateway, the
# router, and the loadgen client all speak it — a casing drift in one
# tier would silently turn every client-side trace id into None
TRACE_RESPONSE_HEADER = "X-Keystone-Trace"

_HEX = frozenset("0123456789abcdef")


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """A parsed ``traceparent``: the remote caller's trace identity.
    ``parent_span_id`` is the REMOTE process's span id (16 hex chars)
    — it never maps onto this process's integer span ids, so adopters
    take the ``trace_id`` and record the remote parent as an attr."""

    trace_id: str
    parent_span_id: str
    flags: str = "01"


def _is_hex(s: str, width: int) -> bool:
    return len(s) == width and all(c in _HEX for c in s)


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """A ``traceparent`` header value -> ``TraceContext``, or None for
    absent/malformed/all-zero input (the W3C spec says a receiver that
    cannot parse the header MUST restart the trace — minting a fresh
    id, never half-adopting garbage)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, parent_id, flags = parts[0], parts[1], parts[2], parts[3]
    if not _is_hex(version, 2) or version == "ff":
        return None
    if version == "00" and len(parts) != 4:
        # version 00 defines EXACTLY four fields; trailing data makes
        # the header unparseable and the trace restarts (the spec's
        # rule) — only future versions may append fields
        return None
    if not _is_hex(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _is_hex(parent_id, 16) or parent_id == "0" * 16:
        return None
    if not _is_hex(flags, 2):
        return None
    return TraceContext(trace_id=trace_id, parent_span_id=parent_id, flags=flags)


def format_traceparent(trace_id: str, span_id: Optional[int]) -> str:
    """The outbound header for a span in THIS process: our integer
    span ids render as the 8-byte hex field the wire expects (same
    mapping the OTLP exporter uses), sampled flag always set — the
    downstream process decides its own recording, we only carry
    identity."""
    return "00-{}-{:016x}-01".format(
        trace_id, (span_id or 0) & ((1 << 64) - 1)
    )


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    start_s: float  # epoch seconds (time.time clock)
    duration_s: float
    thread_id: int
    attrs: Dict[str, Any]
    trace_id: Optional[str] = None  # shared by every span of one request

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "start_s": self.start_s,
            "duration_ms": round(self.duration_s * 1e3, 6),
            "thread_id": self.thread_id,
            "attrs": dict(self.attrs),
        }


class _ActiveSpan:
    """A span in flight; exposes ``set_attr`` and is the context object
    ``Tracer.span()`` yields."""

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "attrs", "_t0", "_wall",
    )

    def __init__(
        self,
        name: str,
        parent_id: Optional[int],
        attrs: Dict,
        trace_id: Optional[str] = None,
    ):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.trace_id = trace_id if trace_id is not None else new_trace_id()
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._wall = time.time()

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value


class _NullSpan:
    """The shared disabled-path object: every method is a no-op."""

    __slots__ = ()
    span_id = None
    parent_id = None
    trace_id = None

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Bounded in-memory span recorder with thread-local parent links."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.enabled = enabled
        # rebuilt only under _lock: an unguarded rebuild in enable_tracing
        # would race concurrent end_span appenders
        self._ring: Deque[Span] = (
            collections.deque(maxlen=capacity)
        )  # guarded-by: _lock
        self._lock = threading.Lock()
        self._local = threading.local()
        # span_id -> trace_id for recently started spans, so a child
        # pinned to a cross-thread parent_id joins the parent's trace
        # even after the parent finished; bounded FIFO
        self._trace_map: Dict[int, str] = {}  # guarded-by: _lock
        self._trace_order: Deque[int] = (
            collections.deque()
        )  # guarded-by: _lock
        # sinks observe every FINISHED span (the OTLP exporter installs
        # here); empty list = zero per-span overhead beyond the check
        self._sinks: List[Callable[[Span], None]] = []  # guarded-by: _lock

    # -- span lifecycle ----------------------------------------------------

    def _stack(self) -> List[_ActiveSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def start_span(
        self,
        name: str,
        parent_id: Optional[int] = None,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ):
        """Explicit API (use ``span()`` where a ``with`` block fits).
        The new span's parent is this thread's innermost open span,
        unless ``parent_id`` pins it explicitly — the cross-thread case,
        e.g. a micro-batch window on the dispatcher thread parenting
        under the ``gateway.admit`` span of the request that opened it.
        ``trace_id`` ADOPTS a caller-supplied identity (an inbound W3C
        ``traceparent``'s) instead of minting one — the cross-PROCESS
        case; it wins over any inherited/mapped id so a forwarded
        request stays one trace fleet-wide."""
        if not self.enabled:
            return _NULL_SPAN
        stack = self._stack()
        if parent_id is None:
            if stack:
                parent_id = stack[-1].span_id
                if trace_id is None:
                    trace_id = stack[-1].trace_id
        elif trace_id is None:
            # explicit cross-thread parent: join its trace if we still
            # know it (bounded map); else this span roots a new trace
            with self._lock:
                trace_id = self._trace_map.get(parent_id)
        span = _ActiveSpan(name, parent_id, attrs, trace_id=trace_id)
        stack.append(span)
        with self._lock:
            self._trace_map[span.span_id] = span.trace_id
            self._trace_order.append(span.span_id)
            while len(self._trace_order) > TRACE_MAP_CAPACITY:
                self._trace_map.pop(self._trace_order.popleft(), None)
        return span

    def end_span(self, span: _ActiveSpan) -> Optional[Span]:
        if span is _NULL_SPAN:
            return None
        done = Span(
            name=span.name,
            span_id=span.span_id,
            parent_id=span.parent_id,
            start_s=span._wall,
            duration_s=time.perf_counter() - span._t0,
            thread_id=threading.get_ident(),
            attrs=span.attrs,
            trace_id=span.trace_id,
        )
        stack = self._stack()
        if span in stack:  # tolerate out-of-order ends
            stack.remove(span)
        with self._lock:
            self._ring.append(done)
            sinks = list(self._sinks) if self._sinks else None
        if sinks:
            for sink in sinks:
                try:
                    sink(done)
                except Exception:  # a broken exporter must not break
                    pass  # the instrumented hot path
        return done

    # -- sinks (span exporters) --------------------------------------------

    def add_sink(self, fn: Callable[[Span], None]) -> None:
        """``fn`` observes every finished span (called outside the
        instrumented code path's locks; exceptions are swallowed)."""
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    def remove_sink(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            if fn in self._sinks:
                self._sinks.remove(fn)

    @contextlib.contextmanager
    def _span_cm(
        self,
        name: str,
        parent_id: Optional[int],
        trace_id: Optional[str],
        attrs: Dict[str, Any],
    ):
        span = self.start_span(
            name, parent_id=parent_id, trace_id=trace_id, **attrs
        )
        try:
            yield span
        finally:
            self.end_span(span)

    def span(
        self,
        name: str,
        parent_id: Optional[int] = None,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ):
        """``with tracer.span("serving.dispatch", bucket=8):`` — records
        nothing when the tracer is disabled. ``parent_id`` pins the
        parent explicitly (cross-thread chains); ``trace_id`` adopts a
        remote trace identity (cross-process chains)."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span_cm(name, parent_id, trace_id, attrs)

    def current_span(self):
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else _NULL_SPAN

    # -- queries / export --------------------------------------------------

    def recent(self, n: Optional[int] = None) -> List[Span]:
        """Most recent finished spans, oldest first."""
        with self._lock:
            spans = list(self._ring)
        return spans if n is None else spans[-n:]

    def spans_for_trace(self, trace_id: str) -> List[Span]:
        """Every finished span of one trace still in the ring, oldest
        first — the flight recorder's span-tree source."""
        if not trace_id:
            return []
        with self._lock:
            return [s for s in self._ring if s.trace_id == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The ring as Chrome trace-event JSON (object format): one
        complete ``"ph": "X"`` event per span, microsecond timestamps,
        span/parent ids in ``args`` — loads in chrome://tracing and
        Perfetto."""
        pid = os.getpid()
        events = []
        for s in self.recent():
            events.append(
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
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# -- process-global tracer -------------------------------------------------

_global_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled until ``enable_tracing``)."""
    return _global_tracer


def enable_tracing(capacity: Optional[int] = None) -> Tracer:
    if capacity is not None:
        # the ring replacement must be atomic with concurrent end_span
        # appenders (they append under the same lock) — an unguarded
        # rebuild raced writers into the deque being copied and lost
        # their spans (or tripped RuntimeError on mutation-during-copy)
        with _global_tracer._lock:
            if capacity != _global_tracer._ring.maxlen:
                _global_tracer._ring = collections.deque(
                    _global_tracer._ring, maxlen=capacity
                )
    _global_tracer.enabled = True
    return _global_tracer


def disable_tracing() -> None:
    _global_tracer.enabled = False


def tracez_document(
    tracer: Tracer, fmt: str = "", n_raw: Optional[str] = None
) -> Dict[str, Any]:
    """Build the ``/tracez`` response document — shared by the admin
    endpoint and the gateway frontend (the way ``flight.debugz_document``
    backs both ``/debugz`` routes) so the two handlers cannot drift.
    ``fmt="chrome"`` returns the Chrome trace-event export; otherwise the
    recent-span listing, optionally limited to the last ``n_raw`` spans."""
    if fmt == "chrome":
        return tracer.to_chrome_trace()
    n = int(n_raw) if n_raw is not None else None
    return {
        "enabled": tracer.enabled,
        "spans": [s.to_dict() for s in tracer.recent(n)],
    }


__all__ = [
    "DEFAULT_CAPACITY",
    "Span",
    "TRACEPARENT_HEADER",
    "TRACE_RESPONSE_HEADER",
    "TraceContext",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "format_traceparent",
    "get_tracer",
    "new_trace_id",
    "parse_traceparent",
    "tracez_document",
]
