"""Admission control: the gateway's front door (counterpart of
``keystone_tpu/gateway/admission.py``, copied as it is).

Every request passes one policy gate BEFORE it can touch an engine:

- **bounded queue** — at most ``max_pending`` admitted-but-unrouted
  requests; the router hands them to pool lanes only as lane capacity
  frees, so backpressure is explicit instead of an unbounded pile-up
  inside the micro-batchers;
- **load shedding** — a request is rejected IMMEDIATELY with a typed
  ``Overloaded`` error when the queue is full or when the estimated
  wait (pending work over the measured completion rate) already exceeds
  the request's deadline. Shedding the request that cannot make its
  deadline anyway keeps latency flat for the requests that can — the
  alternative is every request's latency collapsing together;
- **deadline propagation** — the deadline travels with the request: if
  it expires while queued (load arrived after admission), the router
  sheds it at hand-off time instead of wasting engine cycles on an
  answer nobody is waiting for;
- **SLO pressure** — the gateway's burn-rate watchdog can *tighten*
  admission (``set_pressure``): while the fast-window burn says the
  latency budget is being torched, the effective queue bound shrinks
  and arrivals beyond it shed with reason ``slo_pressure`` — shedding
  *early*, before the queue saturates, is what arrests the burn.

Instrumented via ``GatewayMetrics``: ``keystone_gateway_shed_total``
by reason, queue-depth/inflight gauges, and the queue-wait native
histogram. Each admission opens a ``gateway.admit`` span whose id and
trace id ride with the request so the micro-batcher's
``microbatch.coalesce`` span — on another thread — parents under it,
completing the admit → coalesce → dispatch chain in ``/tracez``; the
trace id also lands on the latency histogram as an OpenMetrics
exemplar and keys the flight recorder's tail-sampled forensics.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Deque, Optional

from keystone_tpu_torch.gateway.metrics import GatewayMetrics
from keystone_tpu_torch.observability.flight import FlightRecorder
from keystone_tpu_torch.observability.tracing import get_tracer

logger = logging.getLogger(__name__)

# completion-rate estimator: window and the minimum evidence before the
# estimated-wait shed rule activates (a cold gateway never deadline-sheds)
RATE_WINDOW_S = 10.0
MIN_RATE_SAMPLES = 8


class Overloaded(RuntimeError):
    """Typed shed/reject error. ``reason`` is one of:

    - ``queue_full``   — the bounded admission queue is at capacity;
    - ``slo_pressure`` — the SLO burn watchdog tightened admission and
      the queue is past the TIGHTENED bound (early shed);
    - ``deadline``     — estimated wait exceeds the request's deadline;
    - ``expired``      — the deadline passed while the request queued;
    - ``closed``       — the gateway is draining and admits nothing.

    HTTP maps these to 429 (shed), 504 (expired), 503 (closed)."""

    def __init__(
        self,
        reason: str,
        queue_depth: Optional[int] = None,
        est_wait_s: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ):
        self.reason = reason
        self.queue_depth = queue_depth
        self.est_wait_s = est_wait_s
        self.deadline_s = deadline_s
        parts = [f"overloaded ({reason})"]
        if queue_depth is not None:
            parts.append(f"queue_depth={queue_depth}")
        if est_wait_s is not None:
            parts.append(f"est_wait={est_wait_s * 1e3:.1f}ms")
        if deadline_s is not None:
            parts.append(f"deadline={deadline_s * 1e3:.1f}ms")
        super().__init__(" ".join(parts))


def _fail(fut: Future, err: BaseException) -> None:
    """Resolve ``fut`` with ``err``, tolerating a caller cancelling in
    the same instant (InvalidStateError) — the caller stopped waiting,
    nobody needs the error."""
    try:
        fut.set_exception(err)
    except Exception:
        pass


@dataclasses.dataclass
class _Request:
    example: Any
    future: Future
    t_admit: float
    deadline_t: Optional[float]  # absolute perf_counter deadline
    parent_span_id: Optional[int]
    trace_id: Optional[str] = None


class AdmissionController:
    """Bounded-queue admission in front of an ``EnginePool`` (anything
    with ``submit``/``free_capacity``/``total_load``/
    ``add_free_listener`` — tests stub it)."""

    def __init__(
        self,
        pool,
        max_pending: int = 1024,
        default_deadline_ms: Optional[float] = None,
        metrics: Optional[GatewayMetrics] = None,
        name: str = "gateway",
        flight: Optional[FlightRecorder] = None,
        forensic_threshold_s: Optional[float] = None,
    ):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.pool = pool
        self.name = name
        self.max_pending = max_pending
        self.default_deadline_ms = default_deadline_ms
        # SLO-watchdog admission tightening: pressure in [0, 1] shrinks
        # the effective queue bound (0 = none; see set_pressure)
        self._pressure = 0.0
        # tail-sampling forensics: when wired, every finished request's
        # verdict goes through the flight recorder's capture decision
        self.flight = flight
        self.forensic_threshold_s = forensic_threshold_s
        self.metrics = metrics if metrics is not None else GatewayMetrics(
            gateway=name
        )
        self._queue: Deque[_Request] = collections.deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._accepting = True  # guarded-by: _cond
        self._completions: Deque[float] = (
            collections.deque(maxlen=2048)
        )  # guarded-by: _comp_lock
        self._comp_lock = threading.Lock()
        pool.add_free_listener(self._wake)
        self._router = threading.Thread(
            target=self._route_loop, name=f"keystone-{name}-router",
            daemon=True,
        )
        self._router.start()
        self.metrics.set_ready(True)

    # -- client side -------------------------------------------------------

    @property
    def accepting(self) -> bool:
        return self._accepting

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def pressure(self) -> float:
        return self._pressure

    def set_pressure(self, pressure: float) -> None:
        """SLO-watchdog hook: ``pressure`` in [0, 1] shrinks the
        effective queue bound to ``max_pending * (1 - pressure)`` so
        the gateway sheds *before* the queue saturates while the error
        budget is burning. 0 restores normal admission."""
        self._pressure = min(1.0, max(0.0, float(pressure)))

    @property
    def effective_max_pending(self) -> int:
        if self._pressure <= 0.0:
            return self.max_pending
        return max(1, int(self.max_pending * (1.0 - self._pressure)))

    def estimated_wait_s(self) -> Optional[float]:
        """Pending work (queued + in-lane) over the measured completion
        rate; ``None`` until enough completions exist to estimate."""
        now = time.perf_counter()
        with self._comp_lock:
            while (
                self._completions
                and self._completions[0] < now - RATE_WINDOW_S
            ):
                self._completions.popleft()
            n = len(self._completions)
            if n < MIN_RATE_SAMPLES:
                return None
            span = now - self._completions[0]
        rate = n / max(span, 1e-3)
        pending = len(self._queue) + self.pool.total_load()
        return pending / rate

    def submit(
        self,
        example: Any,
        deadline_ms: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> Future:
        """Admit one example or raise ``Overloaded``. The returned
        future resolves with the example's pipeline output (or the
        terminal error after any lane retry). ``trace_id`` adopts a
        remote trace identity (the HTTP frontend's parsed W3C
        ``traceparent``) so the whole admit → coalesce → dispatch
        chain, the latency exemplar, and any flight-recorder capture
        ride the CALLER's trace — one id across the fleet hop."""
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline_s = deadline_ms / 1e3 if deadline_ms is not None else None
        with get_tracer().span(
            "gateway.admit", trace_id=trace_id, gateway=self.name
        ) as span:
            with self._cond:
                if not self._accepting:
                    self.metrics.record_shed("closed")
                    raise Overloaded("closed")
                depth = len(self._queue)
                if depth >= self.max_pending:
                    self.metrics.record_shed("queue_full")
                    raise Overloaded("queue_full", queue_depth=depth)
                if depth >= self.effective_max_pending:
                    # the SLO watchdog tightened admission: the queue
                    # is not FULL, but filling it further while the
                    # latency budget burns only deepens the breach
                    self.metrics.record_shed("slo_pressure")
                    raise Overloaded("slo_pressure", queue_depth=depth)
                if deadline_s is not None:
                    est = self.estimated_wait_s()
                    if est is not None and est > deadline_s:
                        self.metrics.record_shed("deadline")
                        raise Overloaded(
                            "deadline",
                            queue_depth=depth,
                            est_wait_s=est,
                            deadline_s=deadline_s,
                        )
                t = time.perf_counter()
                req = _Request(
                    example=example,
                    future=Future(),
                    t_admit=t,
                    deadline_t=(
                        t + deadline_s if deadline_s is not None else None
                    ),
                    parent_span_id=span.span_id,
                    # the adopted id survives even with tracing off
                    # (null span): the request log / exemplars / the
                    # X-Keystone-Trace echo still correlate with the
                    # router's trace
                    trace_id=getattr(span, "trace_id", None) or trace_id,
                )
                # ride the identity on the future so the HTTP frontend
                # can log a greppable trace_id per request
                req.future.trace_id = req.trace_id
                self._queue.append(req)
                self.metrics.set_queue_depth(len(self._queue))
                self._cond.notify()
        return req.future

    # -- router ------------------------------------------------------------

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify()

    def _route_loop(self) -> None:
        while True:
            with self._cond:
                while (
                    self._accepting
                    and not (self._queue and self.pool.free_capacity() > 0)
                ):
                    # the timeout backstops missed capacity signals
                    # (e.g. a lane flipping healthy on its cool-down)
                    self._cond.wait(0.05)
                if not self._accepting and not self._queue:
                    return  # drained and draining: router done
                if not self._queue:
                    continue
                req = self._queue.popleft()
                self.metrics.set_queue_depth(len(self._queue))
            if req.future.cancelled():
                # caller gave up while queued (e.g. the HTTP frontend
                # shedding a partially-admitted /predict): spend nothing
                continue
            now = time.perf_counter()
            if req.deadline_t is not None and now > req.deadline_t:
                # the deadline died in the queue: shed at hand-off,
                # don't spend engine time on it
                self.metrics.record_shed("expired")
                _fail(
                    req.future,
                    Overloaded(
                        "expired",
                        deadline_s=req.deadline_t - req.t_admit,
                    ),
                )
                continue
            self.metrics.record_queue_wait(now - req.t_admit)
            try:
                lane_fut = self.pool.submit(
                    req.example, parent_span_id=req.parent_span_id
                )
            except Exception as e:
                _fail(req.future, e)
                continue
            self.metrics.set_inflight(self.pool.total_load())
            lane_fut.add_done_callback(
                lambda f, req=req: self._finish(req, f)
            )

    def _finish(self, req: _Request, lane_fut: Future) -> None:
        now = time.perf_counter()
        with self._comp_lock:
            self._completions.append(now)
        self.metrics.set_inflight(self.pool.total_load())
        latency_s = now - req.t_admit
        # the trace id rides onto the histogram as an exemplar: the
        # bucket this latency lands in links straight back to the
        # request's span tree (flight recorder / /debugz)
        self.metrics.record_latency(latency_s, trace_id=req.trace_id)
        lane_index = getattr(lane_fut, "lane_index", None)
        req.future.lane_index = lane_index
        # the measured per-request latency rides with lane/trace id so
        # the HTTP request log reports THIS request's number, not the
        # wait on whichever sibling future was iterated first
        req.future.latency_s = latency_s
        err = lane_fut.exception()
        if err is None:
            self.metrics.record_outcome("ok")
            if not req.future.cancelled():
                req.future.set_result(lane_fut.result())
        else:
            self.metrics.record_outcome("error")
            _fail(req.future, err)
        if self.flight is not None:
            # tail-sampling verdict: only over-threshold or errored
            # requests pin their span tree into the forensic ring
            self.flight.maybe_capture(
                req.trace_id,
                duration_s=latency_s,
                error=err,
                threshold_s=self.forensic_threshold_s,
                gateway=self.name,
                lane=lane_index,
            )

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop admitting (new submits raise ``Overloaded('closed')``),
        let the router drain what was already admitted, then return.
        The pool keeps serving the drained requests; closing it is the
        gateway's job after this returns."""
        with self._cond:
            if not self._accepting:
                return
            self._accepting = False
            self.metrics.set_ready(False)
            self._cond.notify_all()
        self._router.join(timeout)
        if self._router.is_alive():
            logger.warning(
                "admission router still draining after %.1fs", timeout
            )

    def __enter__(self) -> "AdmissionController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
